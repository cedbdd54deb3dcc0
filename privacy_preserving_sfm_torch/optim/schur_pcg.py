"""Explicit Schur complement: the reduced camera system and its PCG solve.

Port of ``privacy_preserving_sfm_tpu/optim/schur_pcg.py``.  Two functions
carry the explicit-Schur solvers' heavy work, each with a plain PyTorch
version and a hand-written Hopper kernel (``kernels/``):

* the Schur Gram ``S_corr = V^T V`` (6C, 6C) and ``rhs_corr = V^T gL``
  (6C,), where V (3P, 6C) is the camera expansion of the per-observation
  (3, 6) blocks ``L^T Hcp``.  Two input layouts:
  - ``gram_soa`` takes ``lh_stack`` (18K, P), rows (a*6+i)*K + k, the
    layout of ``ba_soa``.  Plain twin of ``gram_soa_xla``:
    ``gram_soa_plain``.  Kernel: ``kernels/schur_gram.cu`` (replaces the
    TPU kernels ``gram_soa`` and ``gram_soa_blocked``);
  - ``gram_aos`` takes ``LH`` (P, K, 3, 6), the layout of ``ba_dense``.
    Plain twin of ``build_u_matrix`` + the one Gram product of
    ``ba_dense``: ``gram_aos_plain``.  Kernel: the same source with its
    AoS staging (replaces the TPU kernel ``gram_fused``).
* ``pcg_schur``: a fixed number of block-Jacobi PCG steps on the reduced
  camera system S = blockdiag(dHcc) - S_corr, taken as the solvers hold
  it (S_corr, the (C, 6, 6) blocks dHcc and the preconditioner's blocks;
  no dense S or Minv, no padding).  Plain twin: ``pcg_schur_plain``, the
  reference's padded dense system through ``pcg_plain`` (the twin of
  ``pcg_xla``).  Kernel: ``kernels/schur_pcg.cu`` (replaces the TPU kernel
  ``pcg_fused``).  ``pcg`` keeps ``pcg_xla``'s dense contract on the CPU.

``gram_soa``, ``gram_aos`` and ``pcg_schur`` dispatch on the device of
their inputs: tensors on the CPU take the plain version, CUDA tensors
launch the kernel, and anything else raises.  There is no fallback from a
failed kernel.  The reference's ``gram_mode`` and ``PPSFM_PCG`` switches
(TPU kernel against XLA loop) have no counterpart: ``plain=True`` on a
solver is the only way to the plain versions on the card.

``precision="bf16"`` is the Gram's one lower-precision mode (the
reference's ``schur_precision``): V's entries are rounded to bfloat16 and
the products of ``S_corr`` summed in the input precision; ``rhs_corr``
stays unrounded, as in the three TPU kernels (the XLA twin
``gram_soa_xla`` also rounds gL).  A V entry is the sum of a point's slots
that share a camera, so kernel and plain versions sum those slots first
and round the sum, as the reference does.

The kernel reads the camera ids through a ``GramPlan`` (``gram_plan``):
each point's distinct cameras and the camera-sorted observation list.
The ids do not change within a solve, so the solvers build it once and
pass it to every Gram call; with it the launch does no sort and no host
synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from privacy_preserving_sfm_torch.kernels import build as kernels

_LANE = 128
# Column cameras per CTA strip of the Gram kernel's pass 2: eight warp
# strips (6, 6*CB) are held in shared memory (72 KB in either precision).
_GRAM_CAM_BLOCK = {torch.float32: 64, torch.float64: 32}
# Pass 2 splits a camera's observations over up to _MAX_SPLITS CTAs until
# the grid has about _TARGET_CTAS useful CTAs (three resident per SM on
# the H100's 132).
_TARGET_CTAS = 396
_MAX_SPLITS = 8
_PRECISIONS = ("f32", "bf16")
# The plain Gram's V (3P, 6C) in bytes past which it is built and multiplied
# a chunk of points at a time: at the reference's C = 1,000 crossover row
# (P = 200,000) V holds 3.6e9 entries.  Every solve of the smoke's other
# phases stays below it, in one product.
PLAIN_V_BYTES = 2 ** 31


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def padded_dim(num_cams: int) -> int:
    return _round_up(6 * num_cams, _LANE)


def explicit_fits(num_cams: int) -> bool:
    """True when the explicit-Schur path supports the camera count
    (C <= 1024, the reference's DENSE_SCHUR + SPARSE_SCHUR regimes)."""
    return padded_dim(num_cams) <= 6144


def diag_blocks(S: torch.Tensor, num_cams: int) -> torch.Tensor:
    """Extract (C, 6, 6) diagonal blocks from dense S (>=6C, >=6C)."""
    n = 6 * num_cams
    S4 = S[:n, :n].reshape(num_cams, 6, num_cams, 6)
    ar = torch.arange(num_cams, device=S.device)
    return S4[ar, :, ar, :]


def embed_block_diag(blocks: torch.Tensor, n_pad: int) -> torch.Tensor:
    """(C, 6, 6) diagonal blocks -> dense (n_pad, n_pad), identity padding."""
    C = blocks.shape[0]
    n = 6 * C
    out = blocks.new_zeros(n_pad, n_pad)
    ar = torch.arange(C, device=blocks.device)
    out[:n, :n].view(C, 6, C, 6)[ar, :, ar, :] = blocks
    pad = torch.arange(n, n_pad, device=blocks.device)
    out[pad, pad] = 1.0
    return out


def _device_kind(t: torch.Tensor) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise RuntimeError(f"no Schur kernel for device {t.device}")
    return kind


# ---------------------------------------------------------------------------
# Schur Gram
# ---------------------------------------------------------------------------


def _check_precision(precision: str):
    if precision not in _PRECISIONS:
        raise ValueError(f"Gram precision must be one of {_PRECISIONS}, "
                         f"got {precision!r}")


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest even) and cast back to its dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class GramPlan(NamedTuple):
    """What the Gram kernel needs of the camera ids, built once per solve
    by ``gram_plan`` (the ids do not change within a solve).

    ``slot_d`` is in the layout of the camera ids it was built from
    (``layout`` "soa": (K, P); "aos": (P, K)); the rest is layout-free.
    All int32.
    """
    layout: str
    num_cams: int
    slot_d: torch.Tensor   # each slot's distinct-camera index j, -1: none
    dcam: torch.Tensor     # (P, M) distinct cameras, ascending, -1 tail
    count: torch.Tensor    # (P,) distinct cameras of each point
    obs: torch.Tensor      # (P*M,) rows p*M + j by (camera, point); the
    #                        first offsets[C] are the observations
    offsets: torch.Tensor  # (C + 1,) each camera's range of obs


def gram_plan(cam: torch.Tensor, num_cams: int, layout: str) -> GramPlan:
    """The Gram plan of camera ids ``cam`` ((K, P) for "soa", (P, K) for
    "aos"; negative = no camera), in torch ops on cam's device.  The only
    host read is the size M (the most distinct cameras of a point), in the
    span ``schur_pcg.host_read``."""
    if layout not in ("soa", "aos"):
        raise ValueError(f"layout must be 'soa' or 'aos', got {layout!r}")
    cam_pk = (cam.T if layout == "soa" else cam).long()
    P, K = cam_pk.shape
    C = num_cams
    if K * P >= 2 ** 31:
        raise ValueError(f"the Gram kernel indexes slots in int32; "
                         f"K * P = {K * P} is too large")
    dev = cam.device
    valid = cam_pk >= 0
    # Each point's slots sorted by (camera, slot); invalid slots sort
    # last.  The j-th camera group of a point is its j-th distinct camera.
    skey, sk = torch.sort(torch.where(valid, cam_pk, C) * K
                          + torch.arange(K, device=dev), dim=1)
    sc = skey // K
    lead = sc < C
    lead[:, 1:] &= sc[:, 1:] != sc[:, :-1]
    j_sorted = torch.cumsum(lead, 1) - 1
    slot_d = torch.empty_like(sk).scatter_(1, sk, j_sorted)
    slot_d = torch.where(valid, slot_d, -1)
    count = lead.sum(1)
    with record_function("schur_pcg.host_read"):
        M = int(count.max()) if P else 0
    if P * M >= 2 ** 31:
        raise ValueError(f"the Gram kernel indexes rows in int32; "
                         f"P * M = {P * M} is too large")
    dcam = torch.full((P, K + 1), -1, dtype=torch.long, device=dev)
    dcam.scatter_(1, torch.where(lead, j_sorted, K), sc)
    dcam = dcam[:, :M]
    pts = torch.arange(P, device=dev)[:, None]
    keys, obs = torch.sort(torch.where(dcam >= 0, dcam * P + pts, C * P)
                           .reshape(-1))
    offsets = torch.searchsorted(
        keys, torch.arange(C + 1, device=dev) * P)
    if layout == "soa":
        slot_d = slot_d.T
    i32 = torch.int32
    return GramPlan(layout, C, slot_d.to(i32).contiguous(), dcam.to(i32),
                    count.to(i32), obs.to(i32), offsets.to(i32))


def _expand_v(blocks: torch.Tensor, cam: torch.Tensor,
              num_cams: int) -> torch.Tensor:
    """V (3P, 6C) from blocks (P, K, 3, 6): each slot's block is added
    into its camera's columns (repeated cameras of one point add up);
    slots with a negative camera id contribute nothing."""
    P, K = cam.shape
    C = num_cams
    V = blocks.new_zeros(P, 3, C + 1, 6)  # column C takes id -1 slots
    pts = torch.arange(P, device=blocks.device)
    cam = torch.where(cam < 0, C, cam).long()
    for k in range(K):
        V[pts, :, cam[:, k], :] += blocks[:, k]
    return V[:, :, :C, :].reshape(3 * P, 6 * C)


def compact_v_plain(LH: torch.Tensor, gL: torch.Tensor, plan: GramPlan,
                    precision: str = "f32"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the Gram kernel's pass 1 on AoS blocks LH
    (P, K, 3, 6), gL (P, 3): ``Vc`` (P, M, 3, 6), each point's blocks
    summed per distinct camera, in slot order (V's nonzero entries:
    ``Vc[p, j]`` is V's block of point p and camera ``plan.dcam[p, j]``),
    and the rhs terms ``Vc[p, j]^T gL[p]`` (P, M, 6) from the unrounded
    sums.  With ``precision="bf16"`` Vc is then rounded to bfloat16."""
    _check_precision(precision)
    P, K = LH.shape[:2]
    M = plan.dcam.shape[1]
    slot_d = plan.slot_d.T if plan.layout == "soa" else plan.slot_d
    d = torch.where(slot_d < 0, M, slot_d).long()
    Vc = LH.new_zeros(P, M + 1, 3, 6)
    pts = torch.arange(P, device=LH.device)
    for k in range(K):
        Vc[pts, d[:, k]] += LH[:, k]
    Vc = Vc[:, :M]
    rc = torch.einsum("pmai,pa->pmi", Vc, gL)
    if precision == "bf16":
        Vc = _round_bf16(Vc)
    return Vc, rc


def _gram_v(LH, gL, obs_cam, num_cams, precision):
    V = _expand_v(LH, obs_cam, num_cams)
    rhs = V.T @ gL.reshape(-1)
    if precision == "bf16":
        V = _round_bf16(V)
    return V.T @ V, rhs


def gram_aos_plain(LH: torch.Tensor, gL: torch.Tensor, obs_cam: torch.Tensor,
                   num_cams: int, precision: str = "f32"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the AoS Schur Gram.

    Materializes V (3P, 6C) and computes ``S_corr = V^T V`` and
    ``rhs_corr = V^T vec(gL)`` as two matrix products, the twin of the
    reference's ``build_u_matrix`` followed by its one Gram product.  Where
    V would pass ``PLAIN_V_BYTES``, both products are summed over chunks of
    points, each chunk's V at most that size, in ascending point order.
    With ``precision="bf16"`` V's entries are rounded for ``S_corr`` only
    (see the module note).
    """
    _check_precision(precision)
    P = obs_cam.shape[0]
    chunk = max(1, PLAIN_V_BYTES // (18 * max(num_cams, 1)
                                     * LH.element_size()))
    S, rhs = _gram_v(LH[:chunk], gL[:chunk], obs_cam[:chunk], num_cams,
                     precision)
    for p0 in range(chunk, P, chunk):
        S_c, r_c = _gram_v(LH[p0:p0 + chunk], gL[p0:p0 + chunk],
                           obs_cam[p0:p0 + chunk], num_cams, precision)
        S += S_c
        rhs += r_c
    return S, rhs


def gram_soa_plain(lh_stack: torch.Tensor, gL: torch.Tensor,
                   cam_kp: torch.Tensor, num_cams: int,
                   precision: str = "f32"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the SoA Schur Gram (twin of ``gram_soa_xla``):
    ``gram_aos_plain`` on the same blocks in the AoS layout."""
    RK, P = lh_stack.shape
    K = RK // 18
    LH = lh_stack.reshape(3, 6, K, P).permute(3, 2, 0, 1)
    return gram_aos_plain(LH, gL.T, cam_kp.T, num_cams, precision)


def _check_gram_inputs(name, lh, gL, cam, lh_shape, gl_shape, cam_shape,
                       precision):
    _check_precision(precision)
    if lh.dtype not in _GRAM_CAM_BLOCK or gL.dtype != lh.dtype:
        raise TypeError(f"{name} kernel takes float32 or float64 lh/gL of "
                        f"one dtype, got {lh.dtype}/{gL.dtype}")
    if (tuple(lh.shape), tuple(gL.shape), tuple(cam.shape)) != (
            lh_shape, gl_shape, cam_shape):
        raise ValueError(f"{name} shapes: lh {lh_shape}, gL {gl_shape}, cam "
                         f"{cam_shape}; got {tuple(lh.shape)}, "
                         f"{tuple(gL.shape)}, {tuple(cam.shape)}")
    if gL.device != lh.device or cam.device != lh.device:
        raise ValueError(f"{name} inputs must share one device")


def _check_plan(name, plan, layout, cam, num_cams):
    if (plan.layout, plan.num_cams, tuple(plan.slot_d.shape)) != (
            layout, num_cams, tuple(cam.shape)):
        raise ValueError(f"{name} takes a {layout!r} plan of {num_cams} "
                         f"cameras and slots {tuple(cam.shape)}; got "
                         f"{plan.layout!r}, {plan.num_cams}, "
                         f"{tuple(plan.slot_d.shape)}")
    if plan.slot_d.device != cam.device:
        raise ValueError(f"{name} plan must lie on the inputs' device")


def _strip_splits(num_cams: int, cam_block: int) -> int:
    """Splits of each camera's observation list (pass 2's grid z): enough
    CTAs to fill the card where C is small, 1 from about 400 CTAs on."""
    C, CB = num_cams, cam_block
    ctas = sum(min(C, (b + 1) * CB) for b in range(-(-C // CB)))
    return max(1, min(_MAX_SPLITS, -(-_TARGET_CTAS // max(ctas, 1))))


def _gram_cuda(name, launch, lh, gL, cam, num_cams, precision, plan,
               layout):
    if plan is None:
        plan = gram_plan(cam, num_cams, layout)
    else:
        _check_plan(name, plan, layout, cam, num_cams)
    C = num_cams
    n = 6 * C
    P, M = plan.dcam.shape
    cam_block = _GRAM_CAM_BLOCK[lh.dtype]
    splits = _strip_splits(C, cam_block)
    S, rhs = _gram_out(lh, C)
    like = dict(dtype=lh.dtype, device=lh.device)
    Vc = torch.empty(P, M, 24, **like)
    ws = torch.empty((splits, n, n) if splits > 1 else (0,), **like)
    ws_rhs = torch.empty((splits, n) if splits > 1 else (0,), **like)
    launch(lh.contiguous(), gL.contiguous(), plan.slot_d, plan.dcam,
           plan.count, plan.obs, plan.offsets, Vc, ws, ws_rhs, S, rhs,
           cam_block, splits, precision == "bf16")
    return S, rhs


def _gram_out(lh: torch.Tensor, num_cams: int):
    n = 6 * num_cams
    return (torch.empty(n, n, dtype=lh.dtype, device=lh.device),
            torch.empty(n, dtype=lh.dtype, device=lh.device))


def gram_soa(lh_stack: torch.Tensor, gL: torch.Tensor, cam_kp: torch.Tensor,
             num_cams: int, precision: str = "f32",
             plan: Optional[GramPlan] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """S_corr (6C, 6C) and rhs_corr (6C,) in the 6c+i layout.

    lh_stack: (18K, P), rows (a*6+i)*K + k; gL: (3, P); cam_kp: (K, P)
    integer camera ids (negative = no camera).  CPU tensors take
    ``gram_soa_plain``; CUDA tensors launch ``kernels/schur_gram.cu``,
    which takes any C and K (no C <= 1024 / K <= 16 gate).  ``plan`` is
    ``gram_plan(cam_kp, num_cams, "soa")``, built here when not given;
    given, the launch does no host synchronisation.
    """
    if _device_kind(lh_stack) == "cpu":
        if plan is not None:
            _check_plan("gram_soa", plan, "soa", cam_kp, num_cams)
        return gram_soa_plain(lh_stack, gL, cam_kp, num_cams, precision)
    RK, P = lh_stack.shape
    K = RK // 18
    _check_gram_inputs("gram_soa", lh_stack, gL, cam_kp, (18 * K, P), (3, P),
                       (K, P), precision)
    return _gram_cuda("gram_soa", kernels.launch_schur_gram, lh_stack, gL,
                      cam_kp, num_cams, precision, plan, "soa")


def gram_aos(LH: torch.Tensor, gL: torch.Tensor, obs_cam: torch.Tensor,
             num_cams: int, precision: str = "f32",
             plan: Optional[GramPlan] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """S_corr (6C, 6C) and rhs_corr (6C,) in the 6c+i layout.

    LH: (P, K, 3, 6) = L^T Hcp per slot; gL: (P, 3); obs_cam: (P, K)
    integer camera ids (negative = no camera: give padding slots -1).  CPU
    tensors take ``gram_aos_plain``; CUDA tensors launch the AoS staging
    of ``kernels/schur_gram.cu``, for any C and K (the TPU kernel's
    C <= 256, K <= 16 gate does not apply).  ``plan`` is
    ``gram_plan(obs_cam, num_cams, "aos")``, as for ``gram_soa``.
    """
    if _device_kind(LH) == "cpu":
        if plan is not None:
            _check_plan("gram_aos", plan, "aos", obs_cam, num_cams)
        return gram_aos_plain(LH, gL, obs_cam, num_cams, precision)
    P, K = obs_cam.shape
    _check_gram_inputs("gram_aos", LH, gL, obs_cam, (P, K, 3, 6), (P, 3),
                       (P, K), precision)
    return _gram_cuda("gram_aos", kernels.launch_schur_gram_aos, LH, gL,
                      obs_cam, num_cams, precision, plan, "aos")


# ---------------------------------------------------------------------------
# PCG
# ---------------------------------------------------------------------------


def _guard(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v.abs() < 1e-30, v.new_full((), 1e-30), v)


def pcg_plain(S: torch.Tensor, Minv: torch.Tensor, rhs: torch.Tensor,
              iters: int) -> torch.Tensor:
    """Plain version of the PCG (twin of ``pcg_xla``): fixed ``iters``
    steps, no host synchronisation."""
    z = Minv @ rhs
    x = torch.zeros_like(rhs)
    r = rhs
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = S @ p
        pAp = torch.sum(p * Ap)
        alpha = rz / _guard(pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv @ r
        rz_new = torch.sum(r * z)
        beta = rz_new / _guard(rz)
        p = z + beta * p
        rz = rz_new
    return x


def pcg(S: torch.Tensor, Minv: torch.Tensor, rhs: torch.Tensor,
        iters: int) -> torch.Tensor:
    """Solve S x = rhs by ``iters`` steps of PCG with preconditioner Minv.

    S, Minv: (N, N) symmetric; rhs: (N,).  CPU tensors take
    ``pcg_plain``.  There is no kernel for a dense Minv: the solvers'
    preconditioners are block-diagonal, and their systems go to
    ``pcg_schur``, so CUDA tensors raise.
    """
    if _device_kind(S) == "cpu":
        return pcg_plain(S, Minv, rhs, iters)
    raise RuntimeError("pcg has no kernel for a dense Minv: solve "
                       "(blockdiag(dHcc) - S_corr) x = rhs with a "
                       "block-Jacobi preconditioner by pcg_schur")


def pcg_schur_plain(S_corr: torch.Tensor, dHcc: torch.Tensor,
                    minv_blocks: torch.Tensor, rhs: torch.Tensor,
                    iters: int) -> torch.Tensor:
    """Plain version of ``pcg_schur``: the reference's dense system, S and
    Minv identity-padded to ``padded_dim(C)`` with a zero rhs there, solved
    by ``pcg_plain`` and cut back to 6C."""
    C = dHcc.shape[0]
    n, n_pad = 6 * C, padded_dim(C)
    S = embed_block_diag(dHcc, n_pad)
    S[:n, :n] -= S_corr
    Minv = embed_block_diag(minv_blocks, n_pad)
    rhs_p = torch.cat([rhs, rhs.new_zeros(n_pad - n)])
    return pcg_plain(S, Minv, rhs_p, iters)[:n]


def _pcg_schur_cuda(S_corr, dHcc, minv_blocks, rhs, iters, path):
    C = dHcc.shape[0]
    n = 6 * C
    dtype = S_corr.dtype
    if dtype not in (torch.float32, torch.float64) or any(
            t.dtype != dtype for t in (dHcc, minv_blocks, rhs)):
        raise TypeError("pcg_schur kernel takes float32 or float64 inputs "
                        f"of one dtype, got {S_corr.dtype}/{dHcc.dtype}/"
                        f"{minv_blocks.dtype}/{rhs.dtype}")
    if any(t.device != S_corr.device for t in (dHcc, minv_blocks, rhs)):
        raise ValueError("pcg_schur inputs must share one device")
    # The kernel reads S_corr rows with 16-byte loads.
    S_corr = S_corr.contiguous()
    if S_corr.data_ptr() % 16:
        S_corr = S_corr.clone()
    x = torch.empty(n, dtype=dtype, device=S_corr.device)
    blocks = torch.cuda.get_device_properties(
        S_corr.device).multi_processor_count
    # Grid path scratch: z, Ap and two partials a CTA.
    work = torch.empty(2 * n + 2 * blocks, dtype=dtype, device=S_corr.device)
    kernels.launch_schur_pcg(S_corr, dHcc.contiguous(),
                             minv_blocks.contiguous(), rhs.contiguous(), x,
                             work, iters, blocks, path)
    return x


def pcg_schur(S_corr: torch.Tensor, dHcc: torch.Tensor,
              minv_blocks: torch.Tensor, rhs: torch.Tensor, iters: int,
              path: str = "auto") -> torch.Tensor:
    """Solve (blockdiag(dHcc) - S_corr) x = rhs by ``iters`` steps of PCG
    with the block-Jacobi preconditioner ``minv_blocks``.

    S_corr: (6C, 6C) symmetric; dHcc, minv_blocks: (C, 6, 6); rhs: (6C,).
    The reference solves the same system identity-padded to
    ``padded_dim(C)``; on the padding r, z, p and S p stay exactly 0, so the
    kernel works at 6C.  CPU tensors take ``pcg_schur_plain``; CUDA tensors
    launch ``kernels/schur_pcg.cu`` on its ``path``: "cluster" (S_corr held
    in one thread-block cluster's shared memory; raises where it does not
    fit), "grid" (a cooperative grid streaming S_corr), or "auto", the
    cluster path where it fits (float32 C <= 155, float64 C <= 109 on the
    H100), else the grid path: the cluster path was the faster at every C
    where both run (PERF.md, section 6).  The solvers take "auto"; the
    other two let the kernel tests and ``chip_smoke.py`` check and time
    each path at one C.
    """
    if path not in kernels.PCG_PATHS:
        raise ValueError(f"pcg_schur path must be one of "
                         f"{tuple(kernels.PCG_PATHS)}, got {path!r}")
    C = dHcc.shape[0]
    n = 6 * C
    if (tuple(S_corr.shape), tuple(minv_blocks.shape), tuple(rhs.shape),
            tuple(dHcc.shape)) != ((n, n), (C, 6, 6), (n,), (C, 6, 6)):
        raise ValueError("pcg_schur shapes: S_corr (6C, 6C), dHcc and "
                         "minv_blocks (C, 6, 6), rhs (6C,); got "
                         f"{tuple(S_corr.shape)}, {tuple(dHcc.shape)}, "
                         f"{tuple(minv_blocks.shape)}, {tuple(rhs.shape)}")
    if _device_kind(S_corr) == "cpu":
        return pcg_schur_plain(S_corr, dHcc, minv_blocks, rhs, iters)
    return _pcg_schur_cuda(S_corr, dHcc, minv_blocks, rhs, iters, path)
