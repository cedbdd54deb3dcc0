"""Robust multi-view line triangulation of one track (LORANSAC semantics).

Port of ``privacy_preserving_sfm_tpu/solvers/triangulation.py``, twin of
``TriangulationEstimator`` / ``EstimateTriangulation``
(``src/estimators/triangulation.{h,cc}``):

  * minimal sample: 3 observations (``triangulation.cc:61``),
  * model: DLT on stacked ``l_i^T P_i`` rows (``base/triangulation.cc:41``),
  * per-sample gates: cheirality in every sampled view and a pairwise
    triangulation angle >= min_tri_angle (``triangulation.cc:75-93``),
  * residual: squared angular error (``projection.cc:241-260``),
  * samples: every C(n, 3) triple for n <= 15 (``triangulation.cc:
    128-140``); beyond, a deterministic sample seeded by n
    (``_keyless_combinations``, numpy, so the port tries the reference's
    triples) or, with a generator, uniform random triples,
  * LO: one DLT refit on the best sample's inliers, kept when it scores
    higher.

All triples are evaluated as one batch; invalid observations and triples
are masked, not branched.
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from privacy_preserving_sfm_torch.ops import lines as line_ops
from privacy_preserving_sfm_torch.ops import triangulation as tri_ops
from privacy_preserving_sfm_torch.solvers import ransac

BIG = 1e30
MAX_EXHAUSTIVE_TRACK = 15  # C(15,3) = 455 combinations (reference's cap)
# Without a generator the triples stay exhaustive while the count is cheap;
# C(30,3) = 4060.
MAX_EXHAUSTIVE_COMBOS = 4096


@lru_cache(maxsize=None)
def _combinations3(n: int) -> np.ndarray:
    """All C(n, 3) index triples, shape (C, 3)."""
    return np.asarray(list(itertools.combinations(range(n), 3)),
                      dtype=np.int32)


@lru_cache(maxsize=None)
def _keyless_combinations(n: int, m: int) -> np.ndarray:
    """Deterministic triples covering the full index pool [0, n):
    exhaustive when C(n,3) <= MAX_EXHAUSTIVE_COMBOS, else m distinct-member
    triples from a generator seeded by n."""
    total = n * (n - 1) * (n - 2) // 6
    if total <= MAX_EXHAUSTIVE_COMBOS:
        return _combinations3(n)
    rng = np.random.default_rng(7919 * n + 3)
    combos = np.stack(
        [rng.choice(n, size=3, replace=False) for _ in range(m)], axis=0)
    return combos.astype(np.int32)


class TriangulationResult(NamedTuple):
    point3d: torch.Tensor  # (..., 3)
    num_inliers: torch.Tensor
    inlier_mask: torch.Tensor  # (..., N)
    success: torch.Tensor


def angular_residuals(point3d, proj, lines, camera_params, camera_model: str,
                      width, height):
    """Squared angular error per observation; BIG when gated out.

    point3d (..., 3); proj (..., N, 3, 4); lines (..., N, 3);
    camera_params (..., N, P).
    """
    err = line_ops.line_angular_error(
        lines, point3d[..., None, :], proj, camera_model, camera_params,
        width, height)
    return torch.where(err >= BIG, BIG, err * err)


def sample_gates(X, s_proj, s_centers, min_tri_angle_rad):
    """Cheirality in each sampled view, the largest pairwise triangulation
    angle >= the minimum, and a finite point; X (C, 3), s_proj
    (C, 3, 3, 4), s_centers (C, 3, 3) -> (C,) bool."""
    depth = torch.sum(s_proj[..., 2, :3] * X[:, None, :], dim=-1) \
        + s_proj[..., 2, 3]
    cheiral = torch.all(depth > 0, dim=-1)
    ang01 = tri_ops.triangulation_angle(s_centers[:, 0], s_centers[:, 1], X)
    ang02 = tri_ops.triangulation_angle(s_centers[:, 0], s_centers[:, 2], X)
    ang12 = tri_ops.triangulation_angle(s_centers[:, 1], s_centers[:, 2], X)
    good_angle = torch.maximum(torch.maximum(ang01, ang02),
                               ang12) >= min_tri_angle_rad
    return cheiral & good_angle & torch.all(torch.isfinite(X), dim=-1)


def estimate_triangulation(
    lines: torch.Tensor,
    proj: torch.Tensor,
    centers: torch.Tensor,
    camera_params: torch.Tensor,
    valid: torch.Tensor,
    camera_model: str,
    width,
    height,
    max_angle_error_rad,
    min_tri_angle_rad,
    generator: Optional[torch.Generator] = None,
    num_random_samples: int = 512,
) -> TriangulationResult:
    """Robust triangulation of one track from point-to-line observations.

    lines (N, 3), proj (N, 3, 4), centers (N, 3), camera_params (N, P),
    valid (N,) bool; one camera model for all observations.  With a
    ``generator`` and N > MAX_EXHAUSTIVE_TRACK, uniform random triples
    (drawn on the CPU) replace the deterministic set.
    """
    n = lines.shape[0]
    dev = lines.device
    if n <= MAX_EXHAUSTIVE_TRACK:
        combos = torch.from_numpy(_combinations3(n)).long()
    elif generator is None:
        combos = torch.from_numpy(
            _keyless_combinations(n, num_random_samples)).long()
    else:
        combos = torch.randint(0, n, (num_random_samples, 3),
                               generator=generator)
    combos = combos.to(dev)

    s_valid = torch.all(valid[combos], dim=-1)
    distinct = ((combos[:, 0] != combos[:, 1])
                & (combos[:, 0] != combos[:, 2])
                & (combos[:, 1] != combos[:, 2]))
    s_proj = proj[combos]  # (C, 3, 3, 4)
    X = tri_ops.triangulate_three_lines(s_proj, lines[combos])  # (C, 3)
    s_valid = s_valid & distinct & sample_gates(
        X, s_proj, centers[combos], min_tri_angle_rad)

    res = angular_residuals(X, proj[None], lines[None], camera_params[None],
                            camera_model, width, height)  # (C, N)
    res = torch.where(s_valid[:, None], res, BIG)
    thresh = torch.as_tensor(max_angle_error_rad, dtype=lines.dtype,
                             device=dev) ** 2
    score, num, inl = ransac.inlier_score(res, thresh, valid[None])
    best = ransac.select_best(X, score, num, inl)
    return _lo_refit(best, proj, lines, valid, thresh,
                     lambda Xc: angular_residuals(
                         Xc, proj, lines, camera_params, camera_model,
                         width, height))


def _lo_refit(best: ransac.RansacResult, proj, lines, valid, thresh,
              residuals) -> TriangulationResult:
    """LO refit on the best sample's inliers (``loransac.h:149-192``, one
    refit), kept when its support is strictly higher; success needs >= 3
    inliers."""
    X_lo = tri_ops.triangulate_multiview_lines(proj, lines,
                                               mask=best.inlier_mask)
    res_lo = torch.where(torch.all(torch.isfinite(X_lo)), residuals(X_lo),
                         BIG)
    score_lo, num_lo, inl_lo = ransac.inlier_score(res_lo, thresh, valid)
    use_lo = score_lo > best.score
    num_fin = torch.where(use_lo, num_lo, best.num_inliers)
    return TriangulationResult(
        point3d=torch.where(use_lo, X_lo, best.model), num_inliers=num_fin,
        inlier_mask=torch.where(use_lo, inl_lo, best.inlier_mask),
        success=num_fin >= 3)
