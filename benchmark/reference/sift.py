"""Plain reference of the front end's SIFT (eager PyTorch, float32).

A frozen copy of the port's ``features/sift.py`` as the benchmark was
defined, itself the port of the JAX package's ``features/sift.py`` (the
reference's VLFeat semantics), with its one import of the program
(``ops/linalg.solve3``) written out here and its profiler spans dropped:
later changes to the program do not change it.  ``extract_sift(images,
opts, tf32=True)`` computes the convolutions in TF32 (operands rounded to
10 mantissa bits, float32 sums), the precision below the float32 the front
end states: the control of the benchmark's comparison.  The copy's own
notes follow.


Port of ``privacy_preserving_sfm_tpu/features/sift.py``, the functional
replacement of the reference's VLFeat path (``src/feature/sift.cc:399-545``):

  * Gaussian pyramid: separable convolutions with zero padding (the
    reference's ``conv_general_dilated`` with explicit padding pads with
    zeros, whatever its ``_blur`` docstring says), octave downsampling by
    strided slice;
  * DoG extrema: 3 x 3 x 3 max pooling of x and of -x (implicit -inf
    padding, as ``reduce_window``), ``top_k`` over |DoG| to a fixed
    per-octave candidate budget;
  * subpixel refinement: two 3D quadratic steps on batched gathers
    (closed-form 3 x 3 solves), peak and edge gates;
  * orientation: 36-bin histograms, smoothed, up to
    ``max_num_orientations`` parabolic peaks;
  * descriptor: 4 x 4 x 8 bins, L2 -> clamp(0.2) -> L2, then the
    reference's L1-root normalization and 512x uint8 quantization
    (``feature.cc:52-77``).

Every function takes a leading batch dimension of images (B, H, W); there
is no per-image loop.  SIFT computes in float32 whatever the input dtype.
Differences from the reference that do not change the semantics:

  * ``top_k`` keeps the lower index first among equal values, as
    the reference's ``top_k`` does (``torch.topk`` promises no order
    there);
  * the gather stage's histograms and descriptors are sums in a fixed
    order (one-hot reductions and one matrix product), not scatter-adds,
    so a CUDA run gives one result every run;
  * TF32 is off inside ``extract_sift`` whatever the caller's flags
    (``full_float32``), and cuDNN runs deterministic.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


def record_function(name):
    return contextlib.nullcontext()


# The control's TF32: with it set, every convolution's operands are
# rounded to TF32 (10 mantissa bits, to nearest) and accumulated in
# float32, as a tensor core computes (cuDNN's own TF32 switch does not
# reach the float32 kernels this copy's deterministic settings select).
_TF32 = [False]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    if not _TF32[0]:
        return x
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _det3(A):
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _adjugate3(A):
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    adj = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e,
                       f * g - d * i, a * i - c * g, c * d - a * f,
                       d * h - e * g, b * g - a * h, a * e - b * d], dim=-1)
    return adj.reshape(A.shape)


class linalg:  # noqa: N801 - the one function of ops/linalg the copy calls
    @staticmethod
    def solve3(A, b, eps=1e-30):
        det = _det3(A)
        e = det.new_full((), eps)
        det = torch.where(det.abs() < eps, torch.where(det < 0, -e, e), det)
        return torch.sum(_adjugate3(A) * b[..., None, :], dim=-1) / det[
            ..., None]


class SiftOptions(NamedTuple):
    """Fields and defaults of the reference's ``SiftOptions``
    (``sift.py:40-102`` there; ``SiftExtractionOptions``, ``sift.h:45-114``).
    """

    max_num_features: int = 8192
    first_octave: int = -1
    num_octaves: int = 4
    octave_resolution: int = 3
    peak_threshold: float = 0.02 / 3.0
    edge_threshold: float = 10.0
    max_num_orientations: int = 2
    candidates_per_octave: int = 2048
    # Halve the candidate budget per octave, down to the minimum below.
    octave_budget_decay: bool = True
    min_candidates_per_octave: int = 256
    sigma0: float = 1.6
    nominal_sigma: float = 0.5
    # "scale" keeps the largest sigmas (ExtractTopScaleFeatures,
    # feature.cc:79-114); "response" the strongest |DoG| peaks.
    selection: str = "scale"
    # DSP-SIFT (sift.cc:677-726): the descriptor averaged over
    # dsp_num_scales extents in [dsp_min_scale, dsp_max_scale] x sigma.
    domain_size_pooling: bool = False
    dsp_min_scale: float = 1.0 / 6.0
    dsp_max_scale: float = 3.0
    dsp_num_scales: int = 10
    # Affine shape adaptation (vl_covdet, sift.cc:575-745).
    estimate_affine_shape: bool = False
    affine_iterations: int = 10
    # "dense": orientation histograms and descriptor bins as channel
    # filters per Gaussian level, sampled at each keypoint; "gather":
    # per-keypoint sampled gradients (needed by affine shape and DSP).
    descriptor_mode: str = "dense"
    # dense_half_res: 2 x 2 average-pool the soft-binned channels before
    # the window filters; dense_bf16: run the channel filters in bf16.
    dense_half_res: bool = True
    dense_bf16: bool = True


class SiftFeatures(NamedTuple):
    keypoints: torch.Tensor  # (B, K, 4): x, y, scale (sigma in px), angle
    descriptors: torch.Tensor  # (B, K, 128) uint8
    valid: torch.Tensor  # (B, K) bool
    scores: torch.Tensor  # (B, K) the selection score


@contextlib.contextmanager
def full_float32(tf32: bool = False):
    """TF32 off for cuDNN convolutions and cuBLAS products, and cuDNN
    deterministic, inside the block; the caller's flags come back after.

    cuDNN allows TF32 by default, and its 10-bit mantissa would move DoG
    extrema, so the front end does not rely on the caller's flags.
    """
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
             matmul.allow_tf32)
    cudnn.allow_tf32 = False
    cudnn.deterministic = True
    cudnn.benchmark = False
    matmul.allow_tf32 = False
    _TF32[0] = tf32
    try:
        yield
    finally:
        _TF32[0] = False
        (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
         matmul.allow_tf32) = saved


def top_k(x: torch.Tensor, k: int):
    """The reference's ``top_k`` on float32 along the last axis: the k
    largest, sorted descending, the lower index first among equal values.

    Each value becomes a unique int64 key (its order-preserving int32
    image above the bits of ``n - 1 - index``), so ``torch.topk`` has no
    ties left to order.  Returns (values, int64 indices).
    """
    n = x.shape[-1]
    bits = x.contiguous().view(torch.int32).long()
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    pos = torch.arange(n - 1, -1, -1, device=x.device)
    _, idx = torch.topk(key * (1 << 32) + pos, k, dim=-1)
    return torch.gather(x, -1, idx), idx


# ---------------------------------------------------------------------------
# Filters.  Taps and sample grids are computed on the host in float32 and
# cached per device, so a CPU and a CUDA run use the same numbers.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=128)
def _taps(kind: str, param: float, device: torch.device) -> torch.Tensor:
    if kind == "gauss":
        radius = max(1, int(math.ceil(3.0 * param)))
        x = torch.arange(-radius, radius + 1, dtype=torch.float32)
        k = torch.exp(-0.5 * (x / param) ** 2)
        k = k / torch.sum(k)
    else:  # unnormalized tent max(0, 1 - |t| / radius)
        r = max(1, int(math.ceil(param)) - 1)
        t = torch.arange(-r, r + 1, dtype=torch.float32)
        k = torch.clamp(1.0 - torch.abs(t) / param, min=0.0)
    return k.to(device)


def _sep_conv(x: torch.Tensor, k: torch.Tensor,
              bf16_between: bool = False) -> torch.Tensor:
    """Horizontal then vertical 1D filter of (N, H, W), zero padded;
    ``bf16_between`` rounds to bfloat16 between the two passes."""
    r = (k.shape[0] - 1) // 2
    x, k = tf32_round(x), tf32_round(k)
    y = F.conv2d(x[:, None], k.view(1, 1, 1, -1), padding=(0, r))
    if bf16_between:
        y = y.to(torch.bfloat16).float()
    y = F.conv2d(tf32_round(y), k.view(1, 1, -1, 1), padding=(r, 0))
    return y[:, 0]


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (B, H, W), zero padded."""
    if sigma < 1e-6:
        return img
    return _sep_conv(img, _taps("gauss", sigma, img.device))


def _upsample2(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[-2:]
    return F.interpolate(img[:, None], size=(2 * h, 2 * w), mode="bilinear",
                         align_corners=False, antialias=True)[:, 0]


def _octave_pyramid(octave_img: torch.Tensor, opts: SiftOptions):
    """Gaussian stack of one octave (B, S+3, H, W) and its DoG (B, S+2, H,
    W)."""
    S = opts.octave_resolution
    levels = [octave_img]
    for s in range(1, S + 3):
        sig_prev = opts.sigma0 * 2.0 ** ((s - 1) / S)
        sig_cur = opts.sigma0 * 2.0 ** (s / S)
        inc = math.sqrt(max(sig_cur ** 2 - sig_prev ** 2, 1e-8))
        levels.append(_blur(levels[-1], inc))
    gauss = torch.stack(levels, dim=1)
    return gauss, gauss[:, 1:] - gauss[:, :-1]


def _octave_budget(opts: SiftOptions, octave_idx: int) -> int:
    if not opts.octave_budget_decay:
        return opts.candidates_per_octave
    return max(opts.candidates_per_octave >> octave_idx,
               min(opts.min_candidates_per_octave,
                   opts.candidates_per_octave))


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------


def _octave_candidates(dog: torch.Tensor, opts: SiftOptions, budget: int):
    """DoG extrema and subpixel refinement of one octave, (B, S+2, H, W).

    Returns (xr, yr, sr, sigma, peak_val, valid), each (B, K), in octave
    coordinates (sr = refined DoG level).
    """
    S = opts.octave_resolution
    B, _, h, w = dog.shape
    center = dog[:, 1:S + 1]
    # A strict extremum equals the 3 x 3 x 3 window's extremum and the
    # 3 x 3 window's on its own level (which drops plateau duplicates).
    wmax = F.max_pool3d(dog[:, None], 3, 1, 1)[:, 0, 1:S + 1]
    wmin = -F.max_pool3d(-dog[:, None], 3, 1, 1)[:, 0, 1:S + 1]
    c4 = center.reshape(B * S, 1, h, w)
    wmax2d = F.max_pool2d(c4, 3, 1, 1).view(B, S, h, w)
    wmin2d = -F.max_pool2d(-c4, 3, 1, 1).view(B, S, h, w)
    is_max = (center >= wmax) & (center == wmax2d)
    is_min = (center <= wmin) & (center == wmin2d)
    strong = torch.abs(center) > 0.8 * opts.peak_threshold
    border = 5
    yy = torch.arange(h, device=dog.device)[:, None]
    xx = torch.arange(w, device=dog.device)[None, :]
    inside = ((yy >= border) & (yy < h - border)
              & (xx >= border) & (xx < w - border))
    cand = (is_max | is_min) & strong & inside
    score = torch.where(cand, torch.abs(center), 0.0).reshape(B, -1)

    K = min(budget, score.shape[1])
    top_scores, top_idx = top_k(score, K)
    valid = top_scores > 0.0
    lev = top_idx // (h * w) + 1
    rem = top_idx % (h * w)
    py = rem // w
    px = rem % w

    dflat = dog.reshape(B, -1)
    d = torch.arange(-1, 2, device=dog.device)
    offsets = ((d[:, None, None] * h + d[None, :, None]) * w
               + d[None, None, :]).reshape(-1)

    def cube(l, y, x):
        """(B, K, 3, 3, 3) DoG neighbourhoods, [dl, dy, dx] + 1 indexed.
        Clamped: only padding candidates (score 0) can reach outside."""
        idx = (((l * h + y) * w + x)[..., None] + offsets).clamp(
            0, dflat.shape[1] - 1)
        return torch.gather(dflat, 1, idx.reshape(B, -1)).view(
            B, -1, 3, 3, 3)

    def hessian2(c):
        v = c[..., 1, 1, 1]
        Dxx = c[..., 1, 1, 2] + c[..., 1, 1, 0] - 2 * v
        Dyy = c[..., 1, 2, 1] + c[..., 1, 0, 1] - 2 * v
        Dxy = 0.25 * (c[..., 1, 2, 2] - c[..., 1, 2, 0] - c[..., 1, 0, 2]
                      + c[..., 1, 0, 0])
        return Dxx, Dyy, Dxy

    def step(c):
        g = 0.5 * torch.stack([c[..., 1, 1, 2] - c[..., 1, 1, 0],
                               c[..., 1, 2, 1] - c[..., 1, 0, 1],
                               c[..., 2, 1, 1] - c[..., 0, 1, 1]], dim=-1)
        v = c[..., 1, 1, 1]
        Dxx, Dyy, Dxy = hessian2(c)
        Dss = c[..., 2, 1, 1] + c[..., 0, 1, 1] - 2 * v
        Dxs = 0.25 * (c[..., 2, 1, 2] - c[..., 2, 1, 0] - c[..., 0, 1, 2]
                      + c[..., 0, 1, 0])
        Dys = 0.25 * (c[..., 2, 2, 1] - c[..., 2, 0, 1] - c[..., 0, 2, 1]
                      + c[..., 0, 0, 1])
        H = torch.stack([torch.stack([Dxx, Dxy, Dxs], -1),
                         torch.stack([Dxy, Dyy, Dys], -1),
                         torch.stack([Dxs, Dys, Dss], -1)], -2)
        off = -linalg.solve3(H, g)
        return g, v, torch.where(torch.isfinite(off), off, 0.0)

    l, y, x = lev, py, px
    g, v, off = step(cube(l, y, x))
    # One re-centering move when the offset leaves the pixel.
    y2 = (y + torch.round(off[..., 1]).long()).clamp(1, h - 2)
    x2 = (x + torch.round(off[..., 0]).long()).clamp(1, w - 2)
    moved = (torch.abs(off[..., 0]) > 0.6) | (torch.abs(off[..., 1]) > 0.6)
    y = torch.where(moved, y2, y)
    x = torch.where(moved, x2, x)
    c = cube(l, y, x)
    g, v, off = step(c)

    o0, o1, o2 = off[..., 0], off[..., 1], off[..., 2]
    peak = v + 0.5 * (g[..., 0] * o0 + g[..., 1] * o1 + g[..., 2] * o2)
    # Edge response on the spatial 2 x 2 Hessian.
    Dxx, Dyy, Dxy = hessian2(c)
    tr = Dxx + Dyy
    det = Dxx * Dyy - Dxy * Dxy
    r = opts.edge_threshold
    edge_ok = (det > 0) & (tr * tr / torch.where(det == 0, 1e-30, det)
                           < (r + 1.0) ** 2 / r)
    good = ((torch.abs(peak) > opts.peak_threshold) & edge_ok
            & (torch.abs(o0) < 1.5) & (torch.abs(o1) < 1.5)
            & (torch.abs(o2) < 1.5))
    xr = x.float() + o0
    yr = y.float() + o1
    sr = l.float() + o2
    sigma = opts.sigma0 * torch.pow(2.0, sr / S)
    return xr, yr, sr, sigma, torch.abs(peak), valid & good


def _orientation_peaks(hists: torch.Tensor, opts: SiftOptions):
    """Smooth (..., 36) histograms and pick up to max_num_orientations
    peaks (local maxima >= 0.8 max, parabolic refinement).

    Returns (theta (..., n_ori), ori_valid (..., n_ori)).
    """
    NB = hists.shape[-1]
    for _ in range(6):  # circular [1, 1, 1] / 3, six times (VLFeat)
        hists = (torch.roll(hists, 1, -1) + hists
                 + torch.roll(hists, -1, -1)) / 3.0
    hmax = torch.amax(hists, dim=-1, keepdim=True)
    left = torch.roll(hists, 1, -1)
    right = torch.roll(hists, -1, -1)
    is_peak = (hists > left) & (hists > right) & (hists >= 0.8 * hmax)
    peak_score = torch.where(is_peak, hists, -1.0)
    top_h, top_b = top_k(peak_score, opts.max_num_orientations)
    lb = torch.gather(left, -1, top_b)
    rb = torch.gather(right, -1, top_b)
    denom = lb - 2 * top_h + rb
    dbin = 0.5 * (lb - rb) / torch.where(torch.abs(denom) < 1e-12, 1e-12,
                                         denom)
    theta = ((top_b.float() + dbin + 0.5) / NB) * 2 * math.pi - math.pi
    return theta, top_h > 0.0


# ---------------------------------------------------------------------------
# Dense descriptor stage
# ---------------------------------------------------------------------------


def _soft_bins(mag, ang, nbins: int, dtype) -> torch.Tensor:
    """(B, H, W) gradients -> (B, nbins, H, W) soft-binned magnitudes.

    Each pixel's magnitude goes to its two neighbouring orientation bins;
    written by two scatters into distinct channels (no sums).  A bin
    position that rounds up to ``nbins`` loses its lower share, as the
    reference's one-hot comparison does.
    """
    binf = (ang * (nbins / (2.0 * math.pi))) % nbins
    b0 = torch.floor(binf)
    fb = binf - b0
    i0 = b0.long()
    out = torch.zeros((mag.shape[0], nbins) + mag.shape[1:], dtype=dtype,
                      device=mag.device)
    out.scatter_(1, i0.clamp(max=nbins - 1)[:, None],
                 torch.where(i0 < nbins, mag * (1.0 - fb), 0.0)
                 .to(dtype)[:, None])
    out.scatter_(1, ((i0 + 1) % nbins)[:, None],
                 (mag * fb).to(dtype)[:, None])
    return out


def _pool2(ch: torch.Tensor) -> torch.Tensor:
    """2 x 2 average of (B, C, H, W), edge-replicated to even sizes; the
    window is summed left to right, top to bottom, in ``ch``'s dtype."""
    h, w = ch.shape[-2:]
    hs, ws = (h + 1) // 2, (w + 1) // 2
    if (2 * hs, 2 * ws) != (h, w):
        ch = F.pad(ch, (0, 2 * ws - w, 0, 2 * hs - h), mode="replicate")
    s = ((ch[..., 0::2, 0::2] + ch[..., 0::2, 1::2]) + ch[..., 1::2, 0::2]
         ) + ch[..., 1::2, 1::2]
    return s * 0.25


def _channel_filter(ch: torch.Tensor, k: torch.Tensor,
                    bf16: bool = False) -> torch.Tensor:
    """Separable filter of a (B, C, H, W) stack, channels as batch.

    ``bf16`` rounds the stack and the taps to bfloat16, filters in float32
    and rounds to bfloat16 between the two passes (the reference's bf16
    operands with float32 accumulation); the result has ``ch``'s dtype.
    """
    x = ch.flatten(0, 1)
    if bf16:
        x = x.to(torch.bfloat16).float()
        k = k.to(torch.bfloat16).float()
    return _sep_conv(x, k, bf16).view(ch.shape).to(ch.dtype)


def _index(v: torch.Tensor) -> torch.Tensor:
    """Integer pixel index of a floored coordinate.  A NaN coordinate
    (from a degenerate affine frame) reads pixel 0 and its NaN weight
    keeps the sample NaN, as the reference's gathers do."""
    return torch.nan_to_num(v, nan=0.0).long()


def _bilinear_flat(flat: torch.Tensor, ch_idx, ys, xs, h: int, w: int):
    """Bilinear samples of a flattened (B, C*H*W) channel stack.

    ch_idx (B, ...) integer channel per sample; ys, xs float (B, ...).
    Returns float32 (B, ...).
    """
    xs = torch.clamp(xs, 0.0, w - 1.001)
    ys = torch.clamp(ys, 0.0, h - 1.001)
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = xs - x0
    fy = ys - y0
    x0, y0 = _index(x0), _index(y0)
    base = ch_idx * (h * w)
    B = flat.shape[0]

    def take(yy, xx):
        idx = (base + yy * w + xx).reshape(B, -1)
        return torch.gather(flat, 1, idx).view(xs.shape)

    return ((1 - fy) * (1 - fx) * take(y0, x0)
            + (1 - fy) * fx * take(y0, x0 + 1)
            + fy * (1 - fx) * take(y0 + 1, x0)
            + fy * fx * take(y0 + 1, x0 + 1))


def _l2_clamp_l2(d: torch.Tensor) -> torch.Tensor:
    """VLFeat post-processing along the last axis: L2 -> clamp 0.2 -> L2."""
    nrm = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True)).clamp_min(1e-12)
    d = torch.clamp(d / nrm, max=0.2)
    return d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True)
                          ).clamp_min(1e-12)


def _gradients(g: torch.Tensor):
    """Central differences with wrap-around, along the last two axes."""
    dx = 0.5 * (torch.roll(g, -1, -1) - torch.roll(g, 1, -1))
    dy = 0.5 * (torch.roll(g, -1, -2) - torch.roll(g, 1, -2))
    return dx, dy


def _expand(n_ori: int, *arrays):
    """Repeat each keypoint's entries once per orientation, (B, K) ->
    (B, K * n_ori)."""
    return [a.repeat_interleave(n_ori, dim=1) for a in arrays]


@functools.lru_cache(maxsize=8)
def _descriptor_grid(device):
    """Bin-center offsets (ci, cj) of the 4 x 4 spatial bins, y-major, and
    their Gaussian window weights, float32."""
    centers = torch.tensor([b - 1.5 for b in range(4)], dtype=torch.float32)
    cj, ci = torch.meshgrid(centers, centers, indexing="ij")
    ci, cj = ci.reshape(-1), cj.reshape(-1)
    gw = torch.exp(-0.5 * (ci * ci + cj * cj) / 2.0 ** 2)
    return ci.to(device), cj.to(device), gw.to(device)


def _dense_stage(gauss, glev, xr, yr, sigma, peak_val, valid,
                 opts: SiftOptions):
    """Dense-filter orientation and descriptor of one octave.

    gauss (B, S+3, H, W); per-candidate (B, K) arrays in octave pixels.
    Returns the per-orientation feature tuple of ``_octave_features``.
    """
    S = opts.octave_resolution
    NB, NBO = 36, 8
    B, _, h, w = gauss.shape
    K = xr.shape[1]
    dev = gauss.device
    glev_c = torch.clamp(glev, 1, S)
    half = opts.dense_half_res
    hs, ws = ((h + 1) // 2, (w + 1) // 2) if half else (h, w)
    ksc = 0.5 if half else 1.0
    # Half-res pixel (i, j) is centred at full-res (2i + 0.5, 2j + 0.5).
    bins_dtype = torch.bfloat16 if (half and opts.dense_bf16) else \
        torch.float32

    def coord(v):
        return (v - 0.5) * 0.5 if half else v

    def channels(mag, ang, nbins):
        ch = _soft_bins(mag, ang, nbins, bins_dtype)
        return _pool2(ch) if half else ch

    hists = torch.zeros((B, K, NB), dtype=torch.float32, device=dev)
    bins = torch.arange(NB, device=dev).expand(B, K, NB)
    desc_levels = []
    for l in range(1, S + 1):
        dx, dy = _gradients(gauss[:, l])
        mag = torch.sqrt(dx * dx + dy * dy)
        ang = torch.atan2(dy, dx)
        sigl = opts.sigma0 * 2.0 ** (l / S)
        # Orientation: the Gaussian-window histogram is a Gaussian filter
        # of the soft-binned magnitudes, sampled at the keypoint.
        ch36 = _channel_filter(channels(mag, ang, NB),
                               _taps("gauss", 1.5 * sigl * ksc, dev),
                               bf16=opts.dense_bf16)
        hist_l = _bilinear_flat(
            ch36.reshape(B, -1), bins,
            coord(yr)[..., None].expand(B, K, NB),
            coord(xr)[..., None].expand(B, K, NB), hs, ws)
        hists = hists + torch.where((glev_c == l)[..., None], hist_l, 0.0)
        del ch36
        # Descriptor: spatial-bin pooling is a tent filter at the bin
        # pitch (3 sigma_l px) of the 8 soft-binned channels.
        desc_levels.append(_channel_filter(
            channels(mag, ang, NBO), _taps("tent", 3.0 * sigl * ksc, dev),
            bf16=opts.dense_bf16))
    dstack = torch.stack(desc_levels, dim=1).reshape(B, -1)
    del desc_levels

    theta, ori_valid = _orientation_peaks(hists, opts)
    n_ori = opts.max_num_orientations
    lev_e, xr_e, yr_e, sig_e, val_e, peak_e = _expand(
        n_ori, glev_c, xr, yr, sigma, valid, peak_val)
    th_e = theta.reshape(B, -1)
    val_e = val_e & ori_valid.reshape(B, -1)
    Ke = th_e.shape[1]

    # 16 rotated bin-centre positions x 8 channels per keypoint.
    ci, cj, gw = _descriptor_grid(dev)
    ct, st = torch.cos(th_e)[..., None], torch.sin(th_e)[..., None]
    delta = (3.0 * sig_e)[..., None]  # bin pitch in octave px
    u = (ct * ci - st * cj) * delta  # (B, Ke, 16)
    v = (st * ci + ct * cj) * delta
    ch_off = ((lev_e - 1) * NBO)[..., None, None] + torch.arange(
        NBO, device=dev)  # (B, Ke, 1, 8)
    shape = (B, Ke, 16, NBO)
    s = _bilinear_flat(dstack, ch_off.expand(shape),
                       coord(yr_e[..., None] + v)[..., None].expand(shape),
                       coord(xr_e[..., None] + u)[..., None].expand(shape),
                       hs, ws)  # absolute-orientation bin masses

    # Rotate the orientation channels by theta (circular linear interp).
    rot = (th_e * (NBO / (2.0 * math.pi))) % NBO
    ob0 = torch.floor(rot)
    fo = (rot - ob0)[..., None, None]
    o_idx = torch.arange(NBO, device=dev) + ob0.long()[..., None]
    s0 = torch.gather(s, 3, (o_idx % NBO)[:, :, None].expand(shape))
    s1 = torch.gather(s, 3, ((o_idx + 1) % NBO)[:, :, None].expand(shape))
    d = (1.0 - fo) * s0 + fo * s1
    d = (d * gw[:, None]).reshape(B, Ke, 128)
    return xr_e, yr_e, sig_e, th_e, _l2_clamp_l2(d), val_e, peak_e


# ---------------------------------------------------------------------------
# Gather descriptor stage (VLFeat-faithful windows; affine shape, DSP)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _sample_grid(n: int, device):
    """(gy, gx) of an n x n grid on [-1, 1]^2, y-major, float32."""
    t = torch.from_numpy(np.linspace(-1.0, 1.0, n).astype(np.float32)
                         ).to(device)
    gy, gx = torch.meshgrid(t, t, indexing="ij")
    return gy.reshape(-1), gx.reshape(-1)


@functools.lru_cache(maxsize=8)
def _descriptor_spatial_weights(device):
    """(256, 16) weights of the 16 x 16 descriptor samples on the 4 x 4
    spatial bins: the Gaussian window times the bilinear share of each of
    the four neighbouring bins, zero outside the grid."""
    NBP = 4
    t = np.linspace(-1.0, 1.0, 16).astype(np.float32)
    dgy, dgx = np.meshgrid(t, t, indexing="ij")
    ux = (dgx.reshape(-1) * np.float32(NBP + 1) / np.float32(2.0))
    uy = (dgy.reshape(-1) * np.float32(NBP + 1) / np.float32(2.0))
    wgt = np.exp(np.float32(-0.5) * (ux * ux + uy * uy)
                 / np.float32((NBP / 2.0) ** 2)).astype(np.float32)
    bx = ux + np.float32((NBP - 1) / 2.0)
    by = uy + np.float32((NBP - 1) / 2.0)
    x0, y0 = np.floor(bx), np.floor(by)
    fx, fy = bx - x0, by - y0
    out = np.zeros((256, NBP * NBP), np.float32)
    for di in (0, 1):
        for dj in (0, 1):
            xi = x0.astype(np.int64) + di
            yi = y0.astype(np.int64) + dj
            ok = (xi >= 0) & (xi < NBP) & (yi >= 0) & (yi < NBP)
            wx = fx if di else 1 - fx
            wy = fy if dj else 1 - fy
            np.add.at(out, (np.arange(256)[ok], (yi * NBP + xi)[ok]),
                      (wgt * wx * wy)[ok])
    return torch.from_numpy(out).to(device)


def _gather_stage(gauss, sr, xr, yr, sigma, peak_val, valid,
                  opts: SiftOptions):
    """Per-keypoint sampled orientation and descriptor of one octave, with
    optional affine shape adaptation and domain-size pooling."""
    B, n_levels, h, w = gauss.shape
    dev = gauss.device
    NB, NBO, n_ori = 36, 8, opts.max_num_orientations
    dxf, dyf = (g.reshape(B, -1) for g in _gradients(gauss))
    glev = torch.clamp(torch.round(sr).long(), 0, n_levels - 1)

    def grad_lookup(level, ys, xs):
        """Bilinear gradient at (ys, xs) (B, K, N) on each keypoint's
        level (B, K)."""
        xs = torch.clamp(xs, 0.0, w - 1.001)
        ys = torch.clamp(ys, 0.0, h - 1.001)
        x0 = torch.floor(xs)
        y0 = torch.floor(ys)
        fx, fy = xs - x0, ys - y0
        x0, y0 = _index(x0), _index(y0)
        off = (level * (h * w))[..., None]

        def take(f, yy, xx):
            return torch.gather(f, 1, (off + yy * w + xx).reshape(B, -1)
                                ).view(xs.shape)

        def bil(f):
            return ((1 - fy) * (1 - fx) * take(f, y0, x0)
                    + (1 - fy) * fx * take(f, y0, x0 + 1)
                    + fy * (1 - fx) * take(f, y0 + 1, x0)
                    + fy * fx * take(f, y0 + 1, x0 + 1))

        return bil(dxf), bil(dyf)

    gy, gx = _sample_grid(12, dev)
    ones, zeros = torch.ones_like(xr), torch.zeros_like(xr)
    A = (ones, zeros, zeros, ones)  # a00, a01, a10, a11 per keypoint

    if opts.estimate_affine_shape:
        wgt_a = torch.exp(-0.5 * (gx * gx + gy * gy) / (0.5 ** 2))
        win = (3.0 * sigma)[..., None]
        xc, yc = xr[..., None], yr[..., None]
        for _ in range(opts.affine_iterations):
            a00, a01, a10, a11 = (a[..., None] for a in A)
            sx = xc + (a00 * gx + a01 * gy) * win
            sy = yc + (a10 * gx + a11 * gy) * win
            gdx, gdy = grad_lookup(glev, sy, sx)
            gu = a00 * gdx + a10 * gdy  # gradient in the warped frame
            gv = a01 * gdx + a11 * gdy
            m00 = torch.sum(wgt_a * gu * gu, -1)
            m01 = torch.sum(wgt_a * gu * gv, -1)
            m11 = torch.sum(wgt_a * gv * gv, -1)
            tr = m00 + m11 + 1e-20
            m00, m01, m11 = m00 / tr, m01 / tr, m11 / tr
            # W = inv(M)^(1/2) of the 2 x 2 SPD matrix in closed form.
            det = torch.clamp(m00 * m11 - m01 * m01, min=1e-12)
            i00, i01, i11 = m11 / det, -m01 / det, m00 / det
            idet = torch.sqrt(torch.clamp(i00 * i11 - i01 * i01, min=1e-12))
            denom = torch.sqrt(torch.clamp(i00 + i11 + 2 * idet, min=1e-12))
            w00 = (i00 + idet) / denom
            w01 = i01 / denom
            w11 = (i11 + idet) / denom
            a00, a01, a10, a11 = A
            n = (a00 * w00 + a01 * w01, a00 * w01 + a01 * w11,
                 a10 * w00 + a11 * w01, a10 * w01 + a11 * w11)
            # Renormalize to unit determinant (shape, no scale).
            d = torch.sqrt(torch.clamp(torch.abs(n[0] * n[3] - n[1] * n[2]),
                                       min=1e-12))
            A = tuple(c / d for c in n)

    # Orientation histograms over a 12 x 12 grid, summed by bin one-hots.
    win = (3.0 * 1.5 * sigma)[..., None]
    a00, a01, a10, a11 = (a[..., None] for a in A)
    sx = xr[..., None] + (a00 * gx + a01 * gy) * win
    sy = yr[..., None] + (a10 * gx + a11 * gy) * win
    gdx, gdy = grad_lookup(glev, sy, sx)
    mag = torch.sqrt(gdx * gdx + gdy * gdy)
    wgt = torch.exp(-0.5 * ((gx * win) ** 2 + (gy * win) ** 2)
                    / ((1.5 * sigma)[..., None]) ** 2)
    ang = torch.atan2(gdy, gdx)
    bin_f = (ang / (2 * math.pi) * NB) % NB
    b0 = torch.floor(bin_f).long() % NB
    fb = bin_f - torch.floor(bin_f)
    ar = torch.arange(NB, device=dev)
    hists = (torch.sum(torch.where(b0[..., None] == ar,
                                   (mag * wgt * (1 - fb))[..., None], 0.0),
                       dim=-2)
             + torch.sum(torch.where(((b0 + 1) % NB)[..., None] == ar,
                                     (mag * wgt * fb)[..., None], 0.0),
                         dim=-2))
    theta, ori_valid = _orientation_peaks(hists, opts)

    lev_e, xr_e, yr_e, sig_e, val_e, peak_e = _expand(
        n_ori, glev, xr, yr, sigma, valid, peak_val)
    A_e = _expand(n_ori, *A)
    th_e = theta.reshape(B, -1)
    val_e = val_e & ori_valid.reshape(B, -1)

    dgy, dgx = _sample_grid(16, dev)
    w_sp = _descriptor_spatial_weights(dev)  # (256, 16)
    ar8 = torch.arange(NBO, device=dev)

    def descriptor(sig):
        """(B, Ke, 128) descriptors at window scale ``sig``."""
        win = (3.0 * sig * (4 + 1) / 2.0)[..., None]
        th = th_e[..., None]
        ct, st = torch.cos(th), torch.sin(th)
        ux_r = (ct * dgx - st * dgy) * win
        uy_r = (st * dgx + ct * dgy) * win
        a00, a01, a10, a11 = (a[..., None] for a in A_e)
        rx = a00 * ux_r + a01 * uy_r
        ry = a10 * ux_r + a11 * uy_r
        gdx, gdy = grad_lookup(lev_e, yr_e[..., None] + ry,
                               xr_e[..., None] + rx)
        mag = torch.sqrt(gdx * gdx + gdy * gdy)
        ang = torch.atan2(gdy, gdx) - th
        ob = (ang / (2 * math.pi) * NBO) % NBO
        o0 = torch.floor(ob).long() % NBO
        fo = ob - torch.floor(ob)
        # (B, Ke, 256, 8): each sample's magnitude on its two orientation
        # bins; then the fixed spatial weights, as one matrix product.
        per_o = (torch.where(o0[..., None] == ar8, (mag * (1 - fo))[..., None],
                             0.0)
                 + torch.where(((o0 + 1) % NBO)[..., None] == ar8,
                               (mag * fo)[..., None], 0.0))
        d = torch.matmul(per_o.transpose(-1, -2), w_sp)  # (B, Ke, 8, 16)
        return _l2_clamp_l2(d.transpose(-1, -2).reshape(d.shape[:2] + (128,)))

    if opts.domain_size_pooling:
        step = (opts.dsp_max_scale - opts.dsp_min_scale) / opts.dsp_num_scales
        descs = torch.stack([
            descriptor(sig_e * (opts.dsp_min_scale + si * step))
            for si in range(opts.dsp_num_scales)]).mean(dim=0)
    else:
        descs = descriptor(sig_e)
    return xr_e, yr_e, sig_e, th_e, descs, val_e, peak_e


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def _octave_features(gauss, dog, octave_idx: int, opts: SiftOptions):
    """Detect, refine and describe the keypoints of one octave; returns
    per-orientation (B, Ke) arrays in octave coordinates."""
    with record_function("sift.candidates"):
        xr, yr, sr, sigma, peak_val, valid = _octave_candidates(
            dog, opts, _octave_budget(opts, octave_idx))
    if (opts.descriptor_mode == "dense" and not opts.estimate_affine_shape
            and not opts.domain_size_pooling):
        with record_function("sift.dense_stage"):
            n_levels = opts.octave_resolution + 3
            glev = torch.clamp(torch.round(sr).long(), 0, n_levels - 1)
            return _dense_stage(gauss, glev, xr, yr, sigma, peak_val, valid,
                                opts)
    with record_function("sift.gather_stage"):
        return _gather_stage(gauss, sr, xr, yr, sigma, peak_val, valid, opts)


def extract_sift(images: torch.Tensor,
                 opts: SiftOptions = SiftOptions(),
                 tf32: bool = False) -> SiftFeatures:
    """SIFT features of a batch of grayscale images (B, H, W) in [0, 1].

    Returns ``SiftFeatures`` with K = max_num_features rows per image;
    keypoint x, y and scale are in input pixels.  When more candidates
    survive the gates, ``opts.selection`` picks which ones stay ("scale":
    the largest sigmas; "response": the strongest |DoG| peaks).
    """
    with full_float32(tf32):
        return _extract_sift(images.float(), opts)


def _extract_sift(images: torch.Tensor, opts: SiftOptions) -> SiftFeatures:
    with record_function("sift.pyramid"):
        base = _upsample2(images) if opts.first_octave < 0 else images
        nominal = opts.nominal_sigma * (2.0 ** (-opts.first_octave))
        base = _blur(base, math.sqrt(max(opts.sigma0 ** 2 - nominal ** 2,
                                         0.01)))
    feats = []
    octave_img = base
    for oi in range(opts.num_octaves):
        scale_mult = 2.0 ** (oi + opts.first_octave)
        with record_function("sift.pyramid"):
            gauss, dog = _octave_pyramid(octave_img, opts)
        x, y, sig, th, desc, val, peak = _octave_features(gauss, dog, oi,
                                                          opts)
        del gauss, dog
        feats.append((x * scale_mult, y * scale_mult, sig * scale_mult, th,
                      desc, val, peak))
        with record_function("sift.pyramid"):
            # Next octave: the level at 2 sigma0, downsampled.
            sig_next = opts.sigma0 * 2.0
            lvl = _blur(octave_img, math.sqrt(max(sig_next ** 2
                                                  - opts.sigma0 ** 2, 1e-6)))
            octave_img = lvl[:, ::2, ::2]

    with record_function("sift.select"):
        xs, ys, sigs, ths, descs, vals, peaks = (
            torch.cat([f[i] for f in feats], dim=1) for i in range(7))
        K = opts.max_num_features
        rank = sigs if opts.selection == "scale" else peaks
        score = torch.where(vals, rank, -1.0)
        if score.shape[1] < K:
            pad = K - score.shape[1]
            score = F.pad(score, (0, pad), value=-1.0)
            xs, ys, sigs, ths = (F.pad(a, (0, pad)) for a in (xs, ys, sigs,
                                                              ths))
            descs = F.pad(descs, (0, 0, 0, pad))
        top_score, top_idx = top_k(score, K)
        keep_valid = top_score > 0.0
        kp = torch.stack([torch.gather(a, 1, top_idx)
                          for a in (xs, ys, sigs, ths)], dim=-1)
        d = torch.gather(descs, 1, top_idx[..., None].expand(-1, -1, 128))
        # L1-root normalize and quantize (feature.cc:52-77).
        l1 = torch.sum(torch.abs(d), dim=-1, keepdim=True)
        d = torch.sqrt(d / torch.clamp(l1, min=1e-12))
        d_u8 = torch.clamp(torch.round(512.0 * d), 0, 255).to(torch.uint8)
        d_u8 = d_u8 * keep_valid[..., None].to(torch.uint8)
    return SiftFeatures(keypoints=kp, descriptors=d_u8, valid=keep_valid,
                        scores=top_score)
