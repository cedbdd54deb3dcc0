"""Multi-view line triangulation kernels (batched torch).

Port of ``privacy_preserving_sfm_tpu/ops/triangulation.py``.  A point X on
every observed line plane satisfies ``l_i^T P_i X_hom = 0`` (reference
``src/base/triangulation.cc:41-57``).  The N-row kernel takes the smallest
eigenvector of the 4x4 Gram of the normalized rows (fixed-sweep Jacobi,
``ops/linalg.symmetric_eig_smallest``) instead of an SVD, with optional
row masking; the 3-row kernel takes the exact null vector as a 4D
generalized cross product.  Both keep whichever of the homogeneous point
and an inhomogeneous least-squares solve (the single-precision rescue) has
the lower residual.
"""

from __future__ import annotations

from typing import Optional

import torch

from privacy_preserving_sfm_torch.ops import linalg


def _constraint_rows(proj: torch.Tensor, lines: torch.Tensor) -> torch.Tensor:
    """Rows ``l^T P`` (..., N, 4) of lines (..., N, 3), proj (..., N, 3, 4)."""
    return torch.sum(lines[..., :, None] * proj, dim=-2)


def _safe_w(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w.abs() < 1e-12,
                       torch.where(w < 0, -1e-12, w.new_tensor(1e-12)), w)


def _pick_lower_residual(X_h, X_l, A, b):
    """Per batch entry, the candidate with the lower ||A X - b||^2 (the
    homogeneous one only when strictly lower); non-finite entries are
    zeroed first."""
    def resid(Xc):
        return torch.sum((torch.sum(A * Xc[..., None, :], dim=-1) - b) ** 2,
                         dim=-1)

    X_h = torch.where(torch.isfinite(X_h), X_h, 0.0)
    X_l = torch.where(torch.isfinite(X_l), X_l, 0.0)
    use_h = resid(X_h) < resid(X_l)
    return torch.where(use_h[..., None], X_h, X_l)


def _rescue_reg(dtype: torch.dtype) -> float:
    return 1e-12 if dtype == torch.float64 else 1e-8


def triangulate_multiview_lines(proj: torch.Tensor, lines: torch.Tensor,
                                mask: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """DLT triangulation from point-to-line constraints.

    proj (..., N, 3, 4), lines (..., N, 3), mask (..., N) bool (masked rows
    contribute nothing) -> (..., 3).  Twin of ``TriangulateMultiViewPoint``
    with the SVD replaced by a 4x4 Gram eigensolve and row masking added.
    """
    rows = _constraint_rows(proj, lines)
    if mask is not None:
        rows = rows * mask[..., None].to(rows.dtype)
    rows = rows / torch.linalg.vector_norm(rows, dim=-1,
                                           keepdim=True).clamp_min(1e-12)
    G = rows.transpose(-1, -2) @ rows
    X = linalg.symmetric_eig_smallest(G)
    X_h = X[..., :3] / _safe_w(X[..., 3])[..., None]
    A = rows[..., :3]
    b = -rows[..., 3]
    X_l = linalg.lstsq_normal3(A, b, reg_scale=_rescue_reg(rows.dtype),
                               refine=1)
    return _pick_lower_residual(X_h, X_l, A, b)


def triangulate_three_lines(proj: torch.Tensor,
                            lines: torch.Tensor) -> torch.Tensor:
    """Minimal-sample DLT: the exact null vector of the 3x4 constraint
    stack (four 3x3 determinants).  proj (..., 3, 3, 4), lines (..., 3, 3)
    -> (..., 3)."""
    rows = _constraint_rows(proj, lines)
    rows = rows / torch.linalg.vector_norm(rows, dim=-1,
                                           keepdim=True).clamp_min(1e-12)
    a, b, c = rows[..., 0, :], rows[..., 1, :], rows[..., 2, :]

    def det3(i, j, k):
        return (a[..., i] * (b[..., j] * c[..., k] - b[..., k] * c[..., j])
                - a[..., j] * (b[..., i] * c[..., k] - b[..., k] * c[..., i])
                + a[..., k] * (b[..., i] * c[..., j] - b[..., j] * c[..., i]))

    n3 = -det3(0, 1, 2)
    X_h = torch.stack([det3(1, 2, 3), -det3(0, 2, 3), det3(0, 1, 3)],
                      dim=-1) / _safe_w(n3)[..., None]
    A = rows[..., :3]
    bb = -rows[..., 3]
    X_l = linalg.lstsq_normal3(A, bb, reg_scale=_rescue_reg(rows.dtype),
                               refine=1)
    return _pick_lower_residual(X_h, X_l, A, bb)


def triangulate_linear(proj: torch.Tensor, lines: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inhomogeneous linear triangulation: least squares of the rows
    ``l^T R | -l^T t`` (the 4-view init's variant,
    ``initializer.cc:219-233``), masked rows zeroed."""
    A = torch.sum(lines[..., :, None] * proj[..., :, :3], dim=-2)
    b = -torch.sum(lines * proj[..., :, 3], dim=-1)
    if mask is not None:
        m = mask.to(A.dtype)
        A = A * m[..., None]
        b = b * m
    return linalg.lstsq_normal3(A, b, reg_scale=1e-14, refine=1)


def triangulation_angle(center1: torch.Tensor, center2: torch.Tensor,
                        points3d: torch.Tensor) -> torch.Tensor:
    """Minimum enclosing angle of the two viewing rays (radians), law of
    cosines form of ``CalculateTriangulationAngle``; min(a, pi - a)."""
    baseline2 = torch.sum((center1 - center2) ** 2, dim=-1)
    ray1_2 = torch.sum((points3d - center1) ** 2, dim=-1)
    ray2_2 = torch.sum((points3d - center2) ** 2, dim=-1)
    denom = 2.0 * torch.sqrt(ray1_2 * ray2_2)
    nom = ray1_2 + ray2_2 - baseline2
    cos = (nom / denom.clamp_min(1e-30)).clamp(-1.0, 1.0)
    angle = torch.arccos(cos).abs()
    angle = torch.where(denom <= 0.0, torch.zeros_like(angle), angle)
    return torch.minimum(angle, torch.pi - angle)
