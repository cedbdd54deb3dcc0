"""Four-view reconstruction bootstrap from privacy-preserving lines (torch).

Port of ``privacy_preserving_sfm_tpu/init/initializer.py``: the two LO-MSAC
stages of the reference initializer (``src/init/initializer.cc:57-215``)
as fixed-budget batched kernels, over a leading batch of S candidate image
sets (the reference vmaps over them):

  1. gravity pre-rotation: aligned lines -> 2D bearings in the horizontal
     plane (``initializer.cc:63-99``),
  2. LO-MSAC over ``FourView2dEstimator`` minimal samples (16 models per
     5-point sample), local optimization = 2D bundle + points polish, 2
     rounds (``initializer.cc:114-124``),
  3. the mean-minimum-triangulation-angle gate over the first three
     cameras (``initializer.cc:154-186``),
  4. the camera lift to 3D with unknown vertical offsets
     (``initializer.cc:45-55``),
  5. LO-MSAC over ``PlanarOffsetEstimator`` (3 random-line tracks solve the
     3 offsets linearly; 3 LO rounds; ``initializer.cc:236-333``).

The random draws (``InitDraws``) are an argument; ``draw_init`` makes
them from a ``torch.Generator`` on the CPU, so a card run and a CPU run
see the same samples.  The minimal models of all hypotheses are solved in
one batch; they are scored against every track in chunks sized to a
temporary-memory budget, and the best of all chunks is the first maximum
in hypothesis order, as in the reference's chunked map.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from privacy_preserving_sfm_torch.init import sfm2d
from privacy_preserving_sfm_torch.ops import lie, linalg
from privacy_preserving_sfm_torch.ops import triangulation as tri_ops
from privacy_preserving_sfm_torch.solvers import ransac

BIG = 1e5  # planar-offset cheirality sentinel (initializer.cc:320)
# Bytes of temporaries a chunk of hypotheses may take, and the numbers a
# chunk body's tensors hold at their peak per entry: ``_score_models`` per
# (set, model, aligned track), ``_score_offsets`` per (set, hypothesis,
# random track).  Both are the float32 peaks on an H100 at the
# line_initializer's shapes (26.01 and 63.58, rounded up); chip_smoke.py
# (phase ``line_init``) measures them again and fails if one exceeds its
# constant.
CHUNK_BYTES = 2 * 2 ** 30
FOURVIEW_NUMBERS = 27
OFFSET_NUMBERS = 64


class InitOptions(NamedTuple):
    """``init::InitOptions`` (``initializer.h:48-57``); the normalized-plane
    threshold of both stages is per candidate set, an argument of
    ``initialize_reconstruction``."""

    min_tri_angle_deg: float = 0.1  # mean-min-tri-angle gate, degrees
    min_num_inliers: int = 6
    num_samples_fourview: int = 1024  # >= RansacLib's 1000 min iterations
    num_samples_offset: int = 1024


class InitDraws(NamedTuple):
    """The initializer's random draws for S sets of B hypotheses."""

    fourview: torch.Tensor  # (S, B, 5) aligned-track samples
    coord_change: torch.Tensor  # (S, B, 3, 2, 2) standard normal
    offset: torch.Tensor  # (S, B, 3) random-line-track samples


class InitResult(NamedTuple):
    poses: torch.Tensor  # (S, 4, 3, 4) world->camera [R | t]
    inlier_ratio: torch.Tensor  # (S,)
    num_inliers: torch.Tensor  # (S,)
    success: torch.Tensor  # (S,)
    cams2d: torch.Tensor  # (S, 4, 2, 3) the 2D model
    points2d: torch.Tensor  # (S, N, 2)


def draw_init(generator: torch.Generator, aligned_valid: torch.Tensor,
              random_valid: torch.Tensor, options: InitOptions) -> InitDraws:
    """Draws for ``initialize_reconstruction`` on the CPU: 5 distinct valid
    aligned tracks and 3 distinct valid random tracks per hypothesis
    (``ransac.draw_samples``), and the coordinate changes."""
    s = aligned_valid.shape[0]
    fourview = ransac.draw_samples(generator, aligned_valid, 5,
                                   options.num_samples_fourview)
    coord = torch.randn((s, options.num_samples_fourview, 3, 2, 2),
                        generator=generator, dtype=torch.float64)
    offset = ransac.draw_samples(generator, random_valid, 3,
                                 options.num_samples_offset)
    return InitDraws(fourview, coord, offset)


def gravity_rotations(gravity: torch.Tensor) -> torch.Tensor:
    """Rotations taking each gravity direction to +y, (..., 3) ->
    (..., 3, 3): ``Rg = FromTwoVectors(g, (0,1,0))`` (``initializer.cc:73``)."""
    up = gravity.new_tensor([0.0, 1.0, 0.0]).expand(gravity.shape)
    return lie.quat_to_rotmat(lie.quat_from_two_vectors(gravity, up))


def aligned_lines_to_bearings(lines: torch.Tensor,
                              Rg: torch.Tensor) -> torch.Tensor:
    """Pre-rotated aligned lines (..., 3) -> 2D unit bearings (..., 2):
    ``l' = Rg l``, bearing (l'_z, -l'_x) on the upper half circle
    (``initializer.cc:82-94``)."""
    lp = torch.sum(Rg * lines[..., None, :], dim=-1)
    x = torch.stack([lp[..., 2], -lp[..., 0]], dim=-1)
    x = torch.where(x[..., 1:2] < 0, -x, x)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-30)


def lift_camera_2d(cams2d: torch.Tensor) -> torch.Tensor:
    """2D pose (..., 2, 3) -> 3D pose (..., 3, 4) with t_y = 0: the 2D x/y
    axes map to 3D x/z, y gets the identity row (``initializer.cc:45-55``)."""
    z = torch.zeros_like(cams2d[..., 0, 0])
    one = torch.ones_like(z)
    c = cams2d
    return torch.stack([
        torch.stack([c[..., 0, 0], z, c[..., 0, 1], c[..., 0, 2]], -1),
        torch.stack([z, one, z, z], -1),
        torch.stack([c[..., 1, 0], z, c[..., 1, 1], c[..., 1, 2]], -1),
    ], dim=-2)


def _chunk(total: int, entries: int, itemsize: int, numbers: int) -> int:
    """Hypotheses per chunk under ``CHUNK_BYTES``, for hypotheses of
    ``entries`` entries of ``numbers`` numbers each."""
    per = max(1, entries * itemsize * numbers)
    return max(1, min(total, CHUNK_BYTES // per))


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (S, N, ...) gathered by idx (S, ...) along N."""
    s, rest = x.shape[0], x.shape[2:]
    flat = idx.reshape(s, -1, *([1] * len(rest))).expand(s, -1, *rest)
    return torch.gather(x, 1, flat).reshape(idx.shape + rest)


def _keep_better(best: ransac.RansacResult,
                 top: ransac.RansacResult) -> ransac.RansacResult:
    """Per set, ``top`` where its score is strictly higher, else ``best``:
    over chunks in hypothesis order this keeps the first maximum."""
    if best is None:
        return top
    better = top.score > best.score
    return ransac.RansacResult(*(
        torch.where(better.reshape(better.shape + (1,) * (t.ndim - 1)), t, u)
        for t, u in zip(top, best)))


# ---------------------------------------------------------------------------
# Stage 1: four-view 2D LO-MSAC
# ---------------------------------------------------------------------------


def _score_models(cams, x_all, thresh, valid_pts, valid_models):
    """MSAC-score 4-view 2D models against every track: each track is
    triangulated from views 1-3, then the max-over-views ratio error.

    cams (S, K, 4, 2, 3) models; x_all (S, 4, N, 2); thresh (S,);
    valid_pts (S, N); valid_models (S, K).  Returns score, num (S, K),
    inlier mask (S, K, N), X (S, K, N, 2).
    """
    x123 = x_all[:, :3].permute(0, 2, 1, 3)[:, None]  # (S, 1, N, 3, 2)
    X = sfm2d.triangulate2d(cams[:, :, None, :3], x123)  # (S, K, N, 2)
    xv = x_all.permute(0, 2, 1, 3)[:, None]  # (S, 1, N, 4, 2)
    err = sfm2d.reproj_error_2d(cams[:, :, None], X, xv)  # (S, K, N)
    err = torch.where(valid_models[..., None], err, sfm2d.BIG2D)
    score, num, inl = ransac.msac_score(err, thresh[:, None, None],
                                        valid_pts[:, None])
    return score, num, inl, X


def estimate_fourview_2d(x_all: torch.Tensor, valid: torch.Tensor,
                         max_error: torch.Tensor, idx: torch.Tensor,
                         coord_change: torch.Tensor):
    """LO-MSAC over 4-view 2D minimal samples.

    x_all (S, 4, N, 2) unit bearings per view; valid (S, N); max_error (S,);
    idx (S, B, 5) samples; coord_change (S, B, 3, 2, 2).  Returns cams
    (S, 4, 2, 3), X (S, N, 2), score (S,), num_inliers (S,), inlier mask
    (S, N).
    """
    s, _, n, _ = x_all.shape
    b = idx.shape[1]
    views = [_take_rows(x_all[:, v], idx) for v in range(4)]  # (S, B, 5, 2)
    models, _, valid_m = sfm2d.fourview_minimal_models(*views, coord_change)
    models = models.reshape(s, b * 16, 4, 2, 3)  # hypothesis-major
    valid_m = valid_m.reshape(s, b * 16)
    chunk = 16 * _chunk(b, s * 16 * n, x_all.element_size(),
                        FOURVIEW_NUMBERS)
    best = None
    for lo in range(0, b * 16, chunk):
        cams = models[:, lo:lo + chunk]
        score, num, inl, _ = _score_models(cams, x_all, max_error, valid,
                                           valid_m[:, lo:lo + chunk])
        best = _keep_better(best, ransac.select_best(cams, score, num, inl))
    cams, score, num, inl = (best.model, best.score, best.num_inliers,
                             best.inlier_mask)

    # Local optimization with final least squares (RansacLib LO-MSAC with
    # final_least_squares_): the 2D bundle on the inliers, kept if the
    # MSAC score improves.  Two rounds.
    x123 = x_all[:, :3].permute(0, 2, 1, 3)  # (S, N, 3, 2)
    ones = torch.ones((s, 1), dtype=torch.bool, device=x_all.device)
    for _ in range(2):
        X0 = sfm2d.triangulate2d(cams[:, None, :3], x123)
        w = (inl & valid).to(x_all.dtype)
        cams_lo, _ = sfm2d.bundle_adjust_2d(cams, x_all, X0, w)
        score2, num2, inl2, _ = _score_models(cams_lo[:, None], x_all,
                                              max_error, valid, ones)
        better = score2[:, 0] > score
        cams = torch.where(better[:, None, None, None], cams_lo, cams)
        score = torch.where(better, score2[:, 0], score)
        num = torch.where(better, num2[:, 0], num)
        inl = torch.where(better[:, None], inl2[:, 0], inl)

    X = sfm2d.triangulate2d(cams[:, None, :3], x123)
    X = sfm2d.optimize_points_2d(cams, x_all, X)
    return cams, X, score, num, inl


def mean_min_tri_angle_2d(cams: torch.Tensor, X: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """Mean over tracks of the smallest pairwise triangulation angle among
    cameras 0-2, degrees (``initializer.cc:154-182``).  cams (S, 4, 2, 3),
    X (S, N, 2), weights (S, N)."""
    centers = -torch.sum(cams[:, :3, :, :2] * cams[:, :3, :, 2:], dim=-2)
    angs = []
    for i in range(3):
        for j in range(i + 1, 3):
            v1 = centers[:, i, None] - X
            v2 = centers[:, j, None] - X
            c = torch.sum(v1 * v2, dim=-1) / (
                torch.linalg.vector_norm(v1, dim=-1)
                * torch.linalg.vector_norm(v2, dim=-1)).clamp_min(1e-30)
            angs.append(torch.arccos(c.clamp(-1.0, 1.0)))
    min_ang = torch.amin(torch.stack(angs, -1), dim=-1)
    w = weights.to(X.dtype)
    mean = torch.sum(min_ang * w, dim=-1) / torch.sum(w, dim=-1).clamp_min(1)
    return mean * 180.0 / torch.pi


# ---------------------------------------------------------------------------
# Stage 2: planar offsets from random lines
# ---------------------------------------------------------------------------


def planar_offset_solve(poses: torch.Tensor, Rg: torch.Tensor,
                        lines_r: torch.Tensor, sample_mask: torch.Tensor):
    """Solve the 3 vertical offsets from sampled random-line tracks.

    poses (S, 4, 3, 4): lifted gravity-aligned cameras (t_y unknown, 0);
    Rg (S, 4, 3, 3); lines_r (S, K, 4, T, 3): sampled random lines per view
    (original camera frame); sample_mask (S, K, T).  Per track and view j
    in 1..3, ``lg = Rg_j l_j``; the constraints of views 1-3 express X
    linearly in the offsets, and view 0 gives one equation per track
    (``initializer.cc:236-258``).  Returns cams (S, K, 4, 3, 4) in the
    original frame.
    """
    lg = torch.einsum("svij,skvtj->skvti", Rg[:, 1:], lines_r[:, :, 1:])
    R = poses[:, 1:, :, :3]  # (S, 3, 3, 3)
    A0 = torch.einsum("skvti,svij->sktvj", lg, R)  # (S, K, T, 3v, 3)
    tx = poses[:, 1:, 0, 3][:, None, :, None]  # (S, 1, 3, 1)
    tz = poses[:, 1:, 2, 3][:, None, :, None]
    diag = lg[..., 1].transpose(-1, -2)  # (S, K, T, 3v)
    last = (lg[..., 0] * tx + lg[..., 2] * tz).transpose(-1, -2)
    z = torch.zeros_like(diag[..., 0])
    B0 = torch.stack([
        torch.stack([diag[..., 0], z, z, last[..., 0]], -1),
        torch.stack([z, diag[..., 1], z, last[..., 1]], -1),
        torch.stack([z, z, diag[..., 2], last[..., 2]], -1),
    ], dim=-2)  # (S, K, T, 3, 4)
    B0p = Rg[:, None, None, 0].transpose(-1, -2) @ (linalg.inv3(A0) @ B0)
    l0 = lines_r[:, :, 0]  # (S, K, T, 3)
    Arow = torch.sum(l0[..., None] * B0p[..., :3], dim=-2)  # (S, K, T, 3)
    brow = -torch.sum(l0 * B0p[..., 3], dim=-1)
    m = sample_mask.to(poses.dtype)
    tau = linalg.lstsq_normal3(Arow * m[..., None], brow * m,
                               reg_scale=1e-14, refine=1)  # (S, K, 3)
    k = tau.shape[1]
    cams_al = poses[:, None].expand(-1, k, -1, -1, -1).clone()
    cams_al[:, :, 1:, 1, 3] = tau
    return Rg[:, None].transpose(-1, -2) @ cams_al  # Rg^T [R | t]


def planar_offset_residuals(cams: torch.Tensor, lines_r: torch.Tensor,
                            X: torch.Tensor) -> torch.Tensor:
    """Max-over-views |l . hnorm(P X)| / ||l[:2]|| with cheirality gating
    (``initializer.cc:311-333``).  cams (..., 4, 3, 4); lines_r
    (..., 4, N, 3); X (..., N, 3) -> (..., N)."""
    xyz = (X[..., None, :, :] @ cams[..., :3].transpose(-1, -2)
           + cams[..., None, :, 3])  # (..., 4, N, 3)
    z = xyz[..., 2]
    p = xyz / torch.where(z.abs() < 1e-30, 1e-30, z)[..., None]
    num = torch.sum(lines_r * p, dim=-1).abs()
    den = torch.linalg.vector_norm(lines_r[..., :2], dim=-1).clamp_min(1e-30)
    bad = torch.any(z < 0, dim=-2)
    return torch.where(bad, BIG, torch.amax(num / den, dim=-2))


def _triangulate_tracks(cams: torch.Tensor,
                        lines_r: torch.Tensor) -> torch.Tensor:
    """4-view linear triangulation of every track: cams (S, K, 4, 3, 4),
    lines_r (S, 4, M, 3) -> (S, K, M, 3)."""
    lv = lines_r.permute(0, 2, 1, 3)[:, None]  # (S, 1, M, 4, 3)
    return tri_ops.triangulate_linear(cams[:, :, None], lv)


def _score_offsets(poses, Rg, lines_r, valid, max_error, idx):
    """Solve and MSAC-score the offset hypotheses of samples idx (S, C, 3)
    against every random-line track; the best per set, as
    ``ransac.select_best`` gives it."""
    s_lines = torch.stack([_take_rows(lines_r[:, v], idx)
                           for v in range(4)], dim=2)  # (S, C, 4, 3, 3)
    cams = planar_offset_solve(poses, Rg, s_lines,
                               torch.ones(idx.shape, dtype=torch.bool,
                                          device=idx.device))
    X = _triangulate_tracks(cams, lines_r)  # (S, C, M, 3)
    err = planar_offset_residuals(cams, lines_r[:, None], X)  # (S, C, M)
    score, num, inl = ransac.msac_score(err, max_error[:, None, None],
                                        valid[:, None])
    return ransac.select_best(cams, score, num, inl)


def estimate_planar_offsets(poses: torch.Tensor, Rg: torch.Tensor,
                            lines_r: torch.Tensor, valid: torch.Tensor,
                            max_error: torch.Tensor, idx: torch.Tensor):
    """LO-MSAC over 3-track offset samples.  poses (S, 4, 3, 4); Rg
    (S, 4, 3, 3); lines_r (S, 4, M, 3); valid (S, M); max_error (S,); idx
    (S, B, 3).  Returns cams (S, 4, 3, 4), num_inliers (S,), inlier mask
    (S, M)."""
    s, _, m, _ = lines_r.shape
    b = idx.shape[1]
    chunk = _chunk(b, s * m, lines_r.element_size(), OFFSET_NUMBERS)
    th = max_error[:, None]
    best = None
    for lo in range(0, b, chunk):
        best = _keep_better(best, _score_offsets(
            poses, Rg, lines_r, valid, max_error, idx[:, lo:lo + chunk]))

    # Iterated non-minimal refits on the inlier set (RansacLib's LO loop;
    # the reference's extra LeastSquares BA is disabled,
    # initializer.cc:450-451).  Three rounds.
    cams, score, num, inl = (best.model, best.score, best.num_inliers,
                             best.inlier_mask)
    for _ in range(3):
        cams_nm = planar_offset_solve(poses, Rg, lines_r[:, None],
                                      (inl & valid)[:, None])  # (S, 1, ...)
        X_nm = _triangulate_tracks(cams_nm, lines_r)
        err_nm = planar_offset_residuals(cams_nm, lines_r[:, None], X_nm)
        score_nm, num_nm, inl_nm = ransac.msac_score(
            err_nm[:, 0], th, valid)
        better = score_nm > score
        cams = torch.where(better[:, None, None, None], cams_nm[:, 0], cams)
        score = torch.where(better, score_nm, score)
        num = torch.where(better, num_nm, num)
        inl = torch.where(better[:, None], inl_nm, inl)
    return cams, num, inl


# ---------------------------------------------------------------------------
# Full bootstrap
# ---------------------------------------------------------------------------


def initialize_reconstruction(aligned_lines: torch.Tensor,
                              aligned_valid: torch.Tensor,
                              random_lines: torch.Tensor,
                              random_valid: torch.Tensor,
                              gravity: torch.Tensor, max_error: torch.Tensor,
                              draws: InitDraws,
                              options: InitOptions = InitOptions()
                              ) -> InitResult:
    """Bootstrap 4 camera poses of each of S candidate sets.

    aligned_lines (S, 4, N, 3) gravity-aligned line tracks (camera frame),
    aligned_valid (S, N); random_lines (S, 4, M, 3), random_valid (S, M);
    gravity (S, 4, 3) per-image gravity (camera frame); max_error (S,) the
    normalized-plane threshold of each set; draws on any device.  Mirrors ``init::initialize_reconstruction``
    (``initializer.cc:57-215``).
    """
    dev, dtype = aligned_lines.device, aligned_lines.dtype
    max_error = max_error.to(device=dev, dtype=dtype)
    Rg = gravity_rotations(gravity)  # (S, 4, 3, 3)
    x_all = aligned_lines_to_bearings(aligned_lines, Rg[:, :, None])

    cams2d, X2d, _, num2d, inl2d = estimate_fourview_2d(
        x_all, aligned_valid, max_error, draws.fourview.to(dev),
        draws.coord_change.to(device=dev, dtype=dtype))
    mean_angle = mean_min_tri_angle_2d(cams2d, X2d, inl2d & aligned_valid)
    stage1_ok = ((num2d >= options.min_num_inliers)
                 & (mean_angle >= options.min_tri_angle_deg))

    cams, num_off, _ = estimate_planar_offsets(
        lift_camera_2d(cams2d), Rg, random_lines, random_valid, max_error,
        draws.offset.to(dev))
    m_valid = torch.sum(random_valid, dim=-1).clamp_min(1)
    return InitResult(poses=cams, inlier_ratio=num_off / m_valid,
                      num_inliers=num_off,
                      success=stage1_ok & (num_off >= options.min_num_inliers),
                      cams2d=cams2d, points2d=X2d)
