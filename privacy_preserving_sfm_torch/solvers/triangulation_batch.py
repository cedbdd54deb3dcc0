"""Batched robust line triangulation: many tracks in one call (torch).

Port of ``privacy_preserving_sfm_tpu/solvers/triangulation_batch.py``:
the LORANSAC semantics of ``solvers/triangulation.estimate_triangulation``
(reference ``src/estimators/triangulation.{h,cc}``) over T tracks of N
observation slots, every track trying the same triples.  Large
intermediates keep the (tracks, combos) or (tracks, observations, combos)
axes and split 3- and 4-vectors into component tensors, as the reference
lays them out.  The triple set is exhaustive up to ``max_combos`` and a
deterministic sample (numpy, seeded by N) beyond, so the port tries the
reference's triples.  Every sum is a reduction over a fixed axis.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from privacy_preserving_sfm_torch.ops import cameras as cam_ops
from privacy_preserving_sfm_torch.ops import triangulation as tri_ops
from privacy_preserving_sfm_torch.solvers.triangulation import (
    BIG, TriangulationResult, _combinations3)


@lru_cache(maxsize=None)
def _capped_combinations(n: int, cap: int) -> np.ndarray:
    """C(n,3) triples, exhaustive up to ``cap`` else a deterministic sample
    of ``cap`` sorted triples over the full pool (the reference's
    CombinationSampler with a trial budget, ``triangulation.cc:128-140``)."""
    total = n * (n - 1) * (n - 2) // 6
    if total <= cap:
        return _combinations3(n)
    rng = np.random.default_rng(104729 * n + 11)
    combos = np.stack(
        [rng.choice(n, size=3, replace=False) for _ in range(cap)], axis=0)
    return np.ascontiguousarray(np.sort(combos, axis=1).astype(np.int32))


def _solve3_soa(g, rhs, reg_scale: float):
    """Componentwise regularized symmetric 3x3 solve with one refinement
    pass against the unregularized system.  g: (g00, g01, g02, g11, g12,
    g22); rhs: 3 tensors."""
    g00, g01, g02, g11, g12, g22 = g
    reg = reg_scale * (g00 + g11 + g22) + 1e-30
    r00, r11, r22 = g00 + reg, g11 + reg, g22 + reg

    def solve(b0, b1, b2):
        c00 = r11 * r22 - g12 * g12
        c01 = g02 * g12 - g01 * r22
        c02 = g01 * g12 - g02 * r11
        c11 = r00 * r22 - g02 * g02
        c12 = g01 * g02 - r00 * g12
        c22 = r00 * r11 - g01 * g01
        det = r00 * c00 + g01 * c01 + g02 * c02
        det = torch.where(det.abs() < 1e-30, 1e-30, det)
        return ((c00 * b0 + c01 * b1 + c02 * b2) / det,
                (c01 * b0 + c11 * b1 + c12 * b2) / det,
                (c02 * b0 + c12 * b1 + c22 * b2) / det)

    x0, x1, x2 = solve(*rhs)
    e0 = rhs[0] - (g00 * x0 + g01 * x1 + g02 * x2)
    e1 = rhs[1] - (g01 * x0 + g11 * x1 + g12 * x2)
    e2 = rhs[2] - (g02 * x0 + g12 * x1 + g22 * x2)
    d0, d1, d2 = solve(e0, e1, e2)
    return x0 + d0, x1 + d1, x2 + d2


def _minimal_dlt_soa(rowc: Tuple[torch.Tensor, ...], c0, c1, c2):
    """Triangulate every triple: the 4D cross product and the 3x3 rescue,
    keeping the lower residual.  rowc: 4 tensors (T, N), the normalized
    rows l^T P; c0, c1, c2: (C,) member indices.  Returns (T, C) x3."""
    a = [rowc[k][:, c0] for k in range(4)]
    b = [rowc[k][:, c1] for k in range(4)]
    c = [rowc[k][:, c2] for k in range(4)]

    def det3(i, j, k):
        return (a[i] * (b[j] * c[k] - b[k] * c[j])
                - a[j] * (b[i] * c[k] - b[k] * c[i])
                + a[k] * (b[i] * c[j] - b[j] * c[i]))

    n3 = -det3(0, 1, 2)
    w = torch.where(n3.abs() < 1e-12,
                    torch.where(n3 < 0, -1e-12, n3.new_tensor(1e-12)), n3)
    xh, yh, zh = det3(1, 2, 3) / w, -det3(0, 2, 3) / w, det3(0, 1, 3) / w

    g = (a[0] * a[0] + b[0] * b[0] + c[0] * c[0],
         a[0] * a[1] + b[0] * b[1] + c[0] * c[1],
         a[0] * a[2] + b[0] * b[2] + c[0] * c[2],
         a[1] * a[1] + b[1] * b[1] + c[1] * c[1],
         a[1] * a[2] + b[1] * b[2] + c[1] * c[2],
         a[2] * a[2] + b[2] * b[2] + c[2] * c[2])
    rhs = (-(a[0] * a[3] + b[0] * b[3] + c[0] * c[3]),
           -(a[1] * a[3] + b[1] * b[3] + c[1] * c[3]),
           -(a[2] * a[3] + b[2] * b[3] + c[2] * c[3]))
    reg = 1e-12 if rowc[0].dtype == torch.float64 else 1e-8
    xl, yl, zl = _solve3_soa(g, rhs, reg)

    def resid(x, y, z):
        ra = a[0] * x + a[1] * y + a[2] * z + a[3]
        rb = b[0] * x + b[1] * y + b[2] * z + b[3]
        rc = c[0] * x + c[1] * y + c[2] * z + c[3]
        return ra * ra + rb * rb + rc * rc

    fin_h = torch.isfinite(xh) & torch.isfinite(yh) & torch.isfinite(zh)
    xh, yh, zh = (torch.where(fin_h, v, 0.0) for v in (xh, yh, zh))
    fin_l = torch.isfinite(xl) & torch.isfinite(yl) & torch.isfinite(zl)
    xl, yl, zl = (torch.where(fin_l, v, 0.0) for v in (xl, yl, zl))
    use_h = resid(xh, yh, zh) < resid(xl, yl, zl)
    return (torch.where(use_h, xh, xl), torch.where(use_h, yh, yl),
            torch.where(use_h, zh, zl))


def _residuals_soa(xw, yw, zw, lines, proj, params, camera_model: str,
                   width, height, residual: str):
    """Squared residuals of C candidate points against N observations,
    (T, N, C).  xw/yw/zw (T, C); lines (T, N, 3); proj (T, N, 3, 4);
    params (T, N, P).  ``residual``: "angular" (``projection.cc:241-260``)
    or "pixel" (``projection.cc:162-203``, distort both points)."""
    Xh = torch.stack([xw, yw, zw, torch.ones_like(xw)], dim=1)  # (T, 4, C)
    ray0 = proj[..., 0, :] @ Xh  # (T, N, C)
    ray1 = proj[..., 1, :] @ Xh
    ray2 = proj[..., 2, :] @ Xh
    z = ray2
    z_safe = torch.where(z.abs() < 1e-30, 1e-30, z)
    u = ray0 / z_safe
    v = ray1 / z_safe
    params_b = params[:, :, None, :]  # broadcast over combos

    if residual == "angular":
        lnorm = torch.linalg.vector_norm(lines, dim=-1)
        l0 = (lines[..., 0] / lnorm)[..., None]
        l1 = (lines[..., 1] / lnorm)[..., None]
        l2 = (lines[..., 2] / lnorm)[..., None]
        rnorm = torch.sqrt(ray0 * ray0 + ray1 * ray1 + ray2 * ray2)
        cos = (l0 * ray0 + l1 * ray1 + l2 * ray2).abs() \
            / rnorm.clamp_min(1e-30)
        err = (torch.pi / 2 - torch.arccos(cos.clamp(0.0, 1.0))).abs()
        px, py = cam_ops.world_to_image_uv(camera_model, params_b, u, v)
        in_image = (px >= 0) & (px < width) & (py >= 0) & (py < height)
        return torch.where((z >= 0) & in_image, err * err, BIG)

    l0 = lines[..., 0][..., None]
    l1 = lines[..., 1][..., None]
    l2 = lines[..., 2][..., None]
    alpha = l0 * u + l1 * v + l2
    px, py = cam_ops.world_to_image_uv(camera_model, params_b, u, v)
    qx, qy = cam_ops.world_to_image_uv(camera_model, params_b,
                                       u - alpha * l0, v - alpha * l1)
    err2 = (px - qx) ** 2 + (py - qy) ** 2
    in_image = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    ok = (z >= torch.finfo(xw.dtype).eps) & in_image
    return torch.where(ok, err2, BIG)


def _score(sq, valid, thresh):
    """Inlier count with the residual-sum tiebreak over axis 1 (obs).
    sq (T, N, C), valid (T, N) -> score, num (T, C), inlier (T, N, C)."""
    inl = (sq < thresh) & valid[:, :, None]
    num = torch.sum(inl, dim=1)
    rs = torch.sum(torch.where(inl, sq, 0.0), dim=1)
    return num.to(sq.dtype) - rs / (1.0 + rs), num, inl


def estimate_triangulation_batch(
    lines: torch.Tensor,
    proj: torch.Tensor,
    centers: torch.Tensor,
    camera_params: torch.Tensor,
    valid: torch.Tensor,
    camera_model: str,
    width,
    height,
    max_err,
    min_tri_angle_rad,
    residual: str = "angular",
    max_combos: int = 512,
) -> TriangulationResult:
    """Robust triangulation of T tracks in one call.

    lines (T, N, 3); proj (T, N, 3, 4); centers (T, N, 3); camera_params
    (T, N, P); valid (T, N).  ``max_err``: radians (angular) or pixels
    (pixel).  Returns point3d (T, 3), num_inliers (T,), inlier_mask
    (T, N), success (T,).
    """
    n = valid.shape[1]
    dev = lines.device
    combos = torch.from_numpy(_capped_combinations(n, max_combos)).long()
    c0, c1, c2 = (combos[:, k].to(dev) for k in range(3))

    rows = torch.sum(lines[..., :, None] * proj, dim=-2)  # (T, N, 4)
    rows = rows / torch.linalg.vector_norm(rows, dim=-1,
                                           keepdim=True).clamp_min(1e-12)
    rowc = tuple(rows[..., k] for k in range(4))
    xw, yw, zw = _minimal_dlt_soa(rowc, c0, c1, c2)
    fin = torch.isfinite(xw) & torch.isfinite(yw) & torch.isfinite(zw)

    s_valid = valid[:, c0] & valid[:, c1] & valid[:, c2]
    p2 = tuple(proj[..., 2, k] for k in range(4))  # (T, N) x4

    def depth(ci):
        return (p2[0][:, ci] * xw + p2[1][:, ci] * yw + p2[2][:, ci] * zw
                + p2[3][:, ci])

    cheiral = (depth(c0) > 0) & (depth(c1) > 0) & (depth(c2) > 0)
    cx = tuple(centers[..., k] for k in range(3))
    g0, g1, g2 = (tuple(cx[k][:, ci] for k in range(3))
                  for ci in (c0, c1, c2))

    def tri_angle(ca, cb):
        bl2 = ((ca[0] - cb[0]) ** 2 + (ca[1] - cb[1]) ** 2
               + (ca[2] - cb[2]) ** 2)
        ra2 = (xw - ca[0]) ** 2 + (yw - ca[1]) ** 2 + (zw - ca[2]) ** 2
        rb2 = (xw - cb[0]) ** 2 + (yw - cb[1]) ** 2 + (zw - cb[2]) ** 2
        denom = 2.0 * torch.sqrt(ra2 * rb2)
        cos = ((ra2 + rb2 - bl2) / denom.clamp_min(1e-30)).clamp(-1.0, 1.0)
        ang = torch.arccos(cos).abs()
        ang = torch.where(denom <= 0.0, torch.zeros_like(ang), ang)
        return torch.minimum(ang, torch.pi - ang)

    max_ang = torch.maximum(torch.maximum(tri_angle(g0, g1),
                                          tri_angle(g0, g2)),
                            tri_angle(g1, g2))
    s_valid = s_valid & cheiral & (max_ang >= min_tri_angle_rad) & fin

    sq = _residuals_soa(xw, yw, zw, lines, proj, camera_params,
                        camera_model, width, height, residual)
    sq = torch.where(s_valid[:, None, :], sq, BIG)
    thresh = torch.as_tensor(max_err, dtype=lines.dtype, device=dev) ** 2
    score, num, inl = _score(sq, valid, thresh)

    best = torch.argmax(score, dim=1)[:, None]  # (T, 1)
    xb, yb, zb = (torch.take_along_dim(x, best, dim=1)[:, 0]
                  for x in (xw, yw, zw))
    score_b = torch.take_along_dim(score, best, dim=1)[:, 0]
    num_b = torch.take_along_dim(num, best, dim=1)[:, 0]
    inl_b = torch.take_along_dim(inl, best[:, None, :], dim=2)[..., 0]

    X_lo = tri_ops.triangulate_multiview_lines(proj, lines, mask=inl_b)
    ok_lo = torch.all(torch.isfinite(X_lo), dim=-1)
    sq_lo = _residuals_soa(X_lo[..., 0:1], X_lo[..., 1:2], X_lo[..., 2:3],
                           lines, proj, camera_params, camera_model,
                           width, height, residual)  # (T, N, 1)
    sq_lo = torch.where(ok_lo[:, None, None], sq_lo, BIG)
    score_lo, num_lo, inl_lo = _score(sq_lo, valid, thresh)
    use_lo = score_lo[:, 0] > score_b
    point = torch.where(use_lo[:, None], X_lo,
                        torch.stack([xb, yb, zb], dim=-1))
    num_f = torch.where(use_lo, num_lo[:, 0], num_b)
    inl_f = torch.where(use_lo[:, None], inl_lo[..., 0], inl_b)
    return TriangulationResult(point3d=point, num_inliers=num_f,
                               inlier_mask=inl_f, success=num_f >= 3)
