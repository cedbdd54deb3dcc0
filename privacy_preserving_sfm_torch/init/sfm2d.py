"""2D structure-from-motion solvers for the 4-view initializer (batched torch).

Port of ``privacy_preserving_sfm_tpu/init/sfm2d.py``.  Gravity-aligned
lines, pre-rotated so gravity is the +y axis, become 2D bearings in the
horizontal plane; 2D cameras are 2x3 matrices ``[R(theta) | t]`` acting on
homogeneous 2D points.  The reference's solvers (``src/init/sfm2d.cc``):

  * ``trifocal_minimal``: the 2D trifocal tensor (8 entries, 6-vector
    parametrization) from >= 5 triplets by a Gram null vector
    (``sfm2d.cc:363-381``),
  * ``factorize_trifocal``: tensor -> two camera triples by a quadratic in
    the first camera row and a 7x6 null vector, inside a random change of
    image coordinates (``sfm2d.cc:227-298``); the change's matrices are
    an argument, drawn by the caller,
  * ``metric_upgrade``, ``triangulate2d``, ``abs_pose_2d``
    (``sfm2d.cc:178-213, 321-361``),
  * ``bundle_adjust_2d``: Schur-complement Gauss-Newton on the ratio
    residual ``p0/p1 - x0/x1`` with the reference's gauge (cam0 fixed,
    rotations on the unit circle, ||t1|| = 1) (``sfm2d.cc:118-175``),
    with analytic Jacobians where the reference differentiates
    automatically,
  * ``optimize_points_2d``: points-only polish (``sfm2d.cc:75-116``).

Every function broadcasts over leading batch dimensions.  Cheirality: the
2D "depth" axis is the second coordinate (``sfm2d.cc:308``).
"""

from __future__ import annotations

import torch

from privacy_preserving_sfm_torch.ops import linalg

BIG2D = 1e6  # cheirality sentinel of EvaluateModelOnPoint (sfm2d.cc:309)


def _safe(x: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """x with entries under eps in magnitude replaced by eps."""
    return torch.where(x.abs() < eps, eps, x)


def rot2(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([c, -s, s, c], dim=-1).reshape(theta.shape + (2, 2))


def cam2_apply(cams: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) 2D cameras applied to (..., 2) points -> (..., 2)."""
    return torch.sum(cams[..., :2] * X[..., None, :], dim=-1) + cams[..., 2]


def trifocal_minimal(x1: torch.Tensor, x2: torch.Tensor,
                     x3: torch.Tensor) -> torch.Tensor:
    """2D trifocal tensor from sampled triplets of unit bearings
    (..., S, 2) -> (..., 8), linear index a + 2b + 4c over T_abc with
    sum_abc T_abc x1_a x2_b x3_c = 0; T0 = t1+t3+t4, T1 = -t2-t0+t5
    (``sfm2d.cc:363-381``)."""
    a1, a2 = x1[..., 0], x1[..., 1]
    b1, b2 = x2[..., 0], x2[..., 1]
    c1, c2 = x3[..., 0], x3[..., 1]
    rows = torch.stack([
        a1 * b2 * c1 - a2 * b1 * c1,
        a1 * b1 * c1 + a2 * b2 * c1,
        a1 * b1 * c2 - a2 * b1 * c1,
        a1 * b1 * c1 + a2 * b1 * c2,
        a1 * b1 * c1 + a1 * b2 * c2,
        a2 * b1 * c1 + a2 * b2 * c2,
    ], dim=-1)  # (..., S, 6)
    t = linalg.gram_null_vector(rows)  # (..., 6)
    T0 = t[..., 1] + t[..., 3] + t[..., 4]
    T1 = -t[..., 2] - t[..., 0] + t[..., 5]
    return torch.cat([T0[..., None], T1[..., None], t], dim=-1)


def trifocal_coord_change(T: torch.Tensor, A1, A2, A3) -> torch.Tensor:
    """T'_{a'b'c'} = sum_abc A1[a,a'] A2[b,b'] A3[c,c'] T_abc
    (``sfm2d.cc:215-224``); the A's (..., 2, 2) broadcast with T (..., 8)."""
    T3 = T.reshape(T.shape[:-1] + (2, 2, 2))  # [c][b][a]
    out = torch.einsum("...cC,...bB,...aA,...cba->...CBA", A3, A2, A1, T3)
    return out.reshape(out.shape[:-3] + (8,))


def inv2(A: torch.Tensor) -> torch.Tensor:
    det = _safe(linalg.det2(A))
    inv = torch.stack([A[..., 1, 1], -A[..., 0, 1], -A[..., 1, 0],
                       A[..., 0, 0]], dim=-1).reshape(A.shape)
    return inv / det[..., None, None]


def factorize_trifocal(T: torch.Tensor, A: torch.Tensor):
    """Factorize tensors T (..., 8) into two projective camera triples.

    A (..., 3, 2, 2): the random change of image coordinates of each view
    (standard normal draws; ``sfm2d.cc:227-235``).  Returns (P1, P2, P3)
    each (..., 2, 2, 3) (axis -3: the two roots of the quadratic) and a
    validity mask (..., 2) (complex roots are invalid, ``sfm2d.cc:
    244-246``).
    """
    A1, A2, A3 = A[..., 0, :, :], A[..., 1, :, :], A[..., 2, :, :]
    AT = trifocal_coord_change(T, A1, A2, A3)
    t = [AT[..., i] for i in range(8)]
    alpha = t[2] * t[7] - t[3] * t[6]
    beta = t[1] * t[6] + t[3] * t[4] - t[0] * t[7] - t[2] * t[5]
    gamma = t[0] * t[5] - t[1] * t[4]
    disc = beta * beta - 4.0 * alpha * gamma
    valid_fact = disc >= 0
    sq = torch.sqrt(disc.clamp_min(0.0))
    # Sign choice avoiding cancellation (sfm2d.cc:248-251).
    denom = _safe(torch.where(beta > 0, -beta - sq, -beta + sq))
    r0 = 2.0 * gamma / denom
    r1 = gamma / _safe(alpha * r0)
    aa1 = torch.stack([r0, r1], dim=-1)  # (..., 2)

    # Per root: normalize (a1, 1), the second camera row, a 7x6 null space.
    s = torch.sqrt(1.0 + aa1 * aa1)
    a1 = aa1 / s
    a2 = 1.0 / s
    tb = [AT[..., None, i] for i in range(8)]  # broadcast over the roots
    rho = -(tb[1] * a2 - tb[3] * a1) / _safe(tb[2] * a1 - tb[0] * a2)
    b1 = rho * a1
    b2 = rho * a2
    c1 = -a2
    c2 = a1
    z = torch.zeros_like(a1)
    G = torch.stack([
        torch.stack([z, tb[7] * c2, -tb[0] * c1, z, tb[0] * b1, -tb[7] * a2],
                    -1),
        torch.stack([z, z, -tb[1] * c1, tb[7] * c2, tb[1] * b1, -tb[7] * b2],
                    -1),
        torch.stack([z, -tb[7] * c1, -tb[2] * c1, z, tb[2] * b1, tb[7] * a1],
                    -1),
        torch.stack([z, z, -tb[3] * c1, -tb[7] * c1, tb[3] * b1, tb[7] * b1],
                    -1),
        torch.stack([-tb[7] * c2, z, -tb[4] * c1, z,
                     tb[7] * a2 + tb[4] * b1, z], -1),
        torch.stack([z, z, -tb[5] * c1 - tb[7] * c2, z,
                     tb[7] * b2 + tb[5] * b1, z], -1),
        torch.stack([tb[7] * c1, z, -tb[6] * c1, z,
                     -tb[7] * a1 + tb[6] * b1, z], -1),
    ], dim=-2)  # (..., 2, 7, 6)
    d = linalg.gram_null_vector(G)  # (..., 2, 6)

    one = torch.ones_like(a1)
    P1 = torch.stack([torch.stack([one, z, z], -1),
                      torch.stack([z, one, z], -1)], -2)
    P2 = torch.stack([torch.stack([a1, b1, c1], -1),
                      torch.stack([a2, b2, c2], -1)], -2)
    P3 = torch.stack([torch.stack([d[..., 0], d[..., 2], d[..., 4]], -1),
                      torch.stack([d[..., 1], d[..., 3], d[..., 5]], -1)], -2)

    # Revert the coordinate change (sfm2d.cc:286-295): P_i <- A_i P_i, then
    # the rotation block right-multiplied by A1^{-1} restores P1 = [I | 0].
    A1inv = inv2(A1)[..., None, :, :]
    P2 = A2[..., None, :, :] @ P2
    P3 = A3[..., None, :, :] @ P3
    P2 = torch.cat([P2[..., :2] @ A1inv, P2[..., 2:]], dim=-1)
    P3 = torch.cat([P3[..., :2] @ A1inv, P3[..., 2:]], dim=-1)
    return P1, P2, P3, valid_fact[..., None].expand(aa1.shape)


def metric_upgrade(P2: torch.Tensor, P3: torch.Tensor) -> torch.Tensor:
    """3x3 H (identity with a last-row perturbation) making P2, P3
    calibrated: least squares of 4 equations in 2 unknowns
    (``sfm2d.cc:178-191``)."""
    A = torch.stack([
        torch.stack([P2[..., 0, 2], -P2[..., 1, 2]], -1),
        torch.stack([P2[..., 1, 2], P2[..., 0, 2]], -1),
        torch.stack([P3[..., 0, 2], -P3[..., 1, 2]], -1),
        torch.stack([P3[..., 1, 2], P3[..., 0, 2]], -1),
    ], dim=-2)  # (..., 4, 2)
    b = torch.stack([
        P2[..., 1, 1] - P2[..., 0, 0],
        -P2[..., 0, 1] - P2[..., 1, 0],
        P3[..., 1, 1] - P3[..., 0, 0],
        -P3[..., 0, 1] - P3[..., 1, 0],
    ], dim=-1)  # (..., 4)
    x = linalg.solve2(A.transpose(-1, -2) @ A,
                      torch.sum(A * b[..., None], dim=-2))
    one, z = torch.ones_like(x[..., 0]), torch.zeros_like(x[..., 0])
    return torch.stack([torch.stack([one, z, z], -1),
                        torch.stack([z, one, z], -1),
                        torch.stack([x[..., 0], x[..., 1], one], -1)], -2)


def triangulate2d(cams: torch.Tensor, x: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """Linear 2D triangulation from bearings: cams (..., V, 2, 3), x
    (..., V, 2) -> (..., 2).  Row per view ``x0 P[1,:2] - x1 P[0,:2] |
    x1 P[0,2] - x0 P[1,2]`` (``sfm2d.cc:194-213``), 2x2 normal equations
    with a trace-scaled floor, optional view masking."""
    A = x[..., 0:1] * cams[..., 1, :2] - x[..., 1:2] * cams[..., 0, :2]
    b = x[..., 1] * cams[..., 0, 2] - x[..., 0] * cams[..., 1, 2]
    if mask is not None:
        m = mask.to(A.dtype)
        A = A * m[..., None]
        b = b * m
    AtA = A.transpose(-1, -2) @ A
    Atb = torch.sum(A * b[..., None], dim=-2)
    tr = AtA[..., 0, 0] + AtA[..., 1, 1]
    eye = torch.eye(2, dtype=A.dtype, device=A.device)
    return linalg.solve2(AtA + (1e-14 * tr)[..., None, None] * eye, Atb)


def abs_pose_2d(x: torch.Tensor, X: torch.Tensor, mask=None) -> torch.Tensor:
    """2D absolute pose from bearings x and points X, both (..., S, 2):
    translation eliminated, rotation from a 2-vector Gram null space, sign
    fixed by cheirality of the first sample point (``sfm2d.cc:321-361``).
    Returns (..., 2, 3)."""
    x1, x2 = x[..., 0], x[..., 1]
    X1, X2 = X[..., 0], X[..., 1]
    A = torch.stack([X1 * x2 - X2 * x1, -X1 * x1 - X2 * x2], dim=-1)
    B = torch.stack([x2, -x1], dim=-1)
    if mask is not None:
        m = mask.to(A.dtype)
        A = A * m[..., None]
        B = B * m[..., None]
    BtB = B.transpose(-1, -2) @ B
    BtA = B.transpose(-1, -2) @ A
    C = -(inv2(BtB) @ BtA)
    M = A + B @ C
    ab = linalg.gram_null_vector(M)  # (..., 2), unit norm
    tvec = torch.sum(C * ab[..., None, :], dim=-1)
    P = torch.stack([
        torch.stack([ab[..., 0], -ab[..., 1], tvec[..., 0]], -1),
        torch.stack([ab[..., 1], ab[..., 0], tvec[..., 1]], -1),
    ], dim=-2)
    z1 = cam2_apply(P, X[..., 0, :])[..., 1]
    return torch.where((z1 < 0)[..., None, None], -P, P)


def reproj_error_2d(cams: torch.Tensor, X: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Max-over-views ratio error with cheirality gating: cams
    (..., V, 2, 3), X (..., 2), x (..., V, 2) -> (...,)
    (``FourView2dEstimator::EvaluateModelOnPoint``, ``sfm2d.cc:302-319``)."""
    z = cam2_apply(cams, X[..., None, :])  # (..., V, 2)
    z1 = z[..., 1]
    err = (z[..., 0] / _safe(z1) - x[..., 0] / _safe(x[..., 1])).abs()
    err = torch.amax(err, dim=-1)
    return torch.where(torch.any(z1 < 0, dim=-1), BIG2D, err)


def cosine_error_2d(cams: torch.Tensor, X: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """1 - <x, normalize(P X)> per view (``AbsolutePose2dEstimator``)."""
    z = cam2_apply(cams, X)
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(
        1e-30)
    return 1.0 - torch.sum(x * z, dim=-1)


# ---------------------------------------------------------------------------
# 2D bundle adjustment (Gauss-Newton with Schur elimination of points)
# ---------------------------------------------------------------------------

BA2D_ITERS = 12


def _unpack_cams(camvec: torch.Tensor, cam0: torch.Tensor) -> torch.Tensor:
    """Camera vectors (..., 8) = (theta1..3, phi, t2, t3) -> (..., 4, 2, 3)
    cameras; cam0 (..., 2, 3) fixed, t1 = (cos phi, sin phi)."""
    R = rot2(camvec[..., :3])  # (..., 3, 2, 2)
    phi = camvec[..., 3]
    t1 = torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
    ts = torch.stack([t1, camvec[..., 4:6], camvec[..., 6:8]], dim=-2)
    cams123 = torch.cat([R, ts[..., None]], dim=-1)
    return torch.cat([cam0[..., None, :, :], cams123], dim=-3)


def _ratio_residual(cams: torch.Tensor, X: torch.Tensor, xr: torch.Tensor):
    """Residuals p0/p1 - xr and their derivatives by p: cams (..., 4, 2, 3),
    X (..., N, 2), xr (..., 4, N).  Returns r, dr/dp0, dr/dp1, p, all
    (..., 4, N) (p: (..., 4, N, 2)).  Where |p1| < 1e-30 the reference's
    clamp makes p1 a constant, so dr/dp1 is 0 there."""
    p = cam2_apply(cams[..., :, None, :, :], X[..., None, :, :])
    p0, p1 = p[..., 0], p[..., 1]
    small = p1.abs() < 1e-30
    p1s = torch.where(small, 1e-30, p1)
    r = p0 / p1s - xr
    dr0 = 1.0 / p1s
    dr1 = torch.where(small, 0.0, -p0 / (p1s * p1s))
    return r, dr0, dr1, p


def bundle_adjust_2d(cams: torch.Tensor, x: torch.Tensor, X: torch.Tensor,
                     weights: torch.Tensor, iters: int = BA2D_ITERS):
    """Joint Gauss-Newton over cameras 1-3 and the points with the
    reference's gauge; leading batch dims (...) shared by every argument.

    cams (..., 4, 2, 3) initial cameras (cam 0 held fixed); x (..., 4, N, 2)
    unit bearings; X (..., N, 2) initial points; weights (..., N) (0 masks
    a point out).  Residual p0/p1 - x0/x1 per (view, point)
    (``sfm2d.cc:55-73``), solved by the Schur complement: 2x2 point blocks
    eliminated into the 8-dof camera system, ``linalg.solve_gauss`` on the
    reduced 8x8.
    """
    dtype, dev = cams.dtype, cams.device
    cam0 = cams[..., 0, :, :]
    theta0 = torch.atan2(cams[..., 1:, 1, 0], cams[..., 1:, 0, 0])  # (..., 3)
    t1 = cams[..., 1, :, 2]
    scale = torch.linalg.vector_norm(t1, dim=-1).clamp_min(1e-30)
    t1n = t1 / scale[..., None]
    phi0 = torch.atan2(t1n[..., 1], t1n[..., 0])
    # Rescale so ||t1|| = 1 (HomogeneousVectorParameterization gauge).
    t23_0 = (cams[..., 2:, :, 2] / scale[..., None, None]).flatten(-2)
    camvec = torch.cat([theta0, phi0[..., None], t23_0], dim=-1)
    Xc = X / scale[..., None, None]
    xr = x[..., 0] / _safe(x[..., 1])  # (..., 4, N)
    w = weights.to(dtype)
    eye2 = torch.eye(2, dtype=dtype, device=dev)
    eye8 = torch.eye(8, dtype=dtype, device=dev)

    for _ in range(iters):
        cams_all = _unpack_cams(camvec, cam0)
        r, dr0, dr1, p = _ratio_residual(cams_all, Xc, xr)
        # Jacobians by the cameras (..., 4, N, 8): view v in 1..3 moves
        # with theta_v (dp/dtheta = (-(p1 - ty), p0 - tx)), view 1 with
        # phi, views 2 and 3 with their translations.
        tx = cams_all[..., :, None, 0, 2]
        ty = cams_all[..., :, None, 1, 2]
        d_theta = dr0 * (ty - p[..., 1]) + dr1 * (p[..., 0] - tx)
        phi = camvec[..., 3][..., None, None]
        d_phi = dr0 * -torch.sin(phi) + dr1 * torch.cos(phi)
        zero = torch.zeros_like(r[..., 0, :])
        cols = []
        for v in range(1, 4):  # theta_1..3
            cols.append(torch.stack(
                [d_theta[..., k, :] if k == v else zero for k in range(4)],
                dim=-2))
        cols.append(torch.stack([zero, d_phi[..., 1, :], zero, zero], -2))
        for v in (2, 3):  # t_v
            for dr in (dr0, dr1):
                cols.append(torch.stack(
                    [dr[..., k, :] if k == v else zero for k in range(4)],
                    dim=-2))
        Jc = torch.stack(cols, dim=-1)  # (..., 4, N, 8)
        # Jacobians by the points (..., 4, N, 2): dp/dX = the camera's 2x2.
        M = cams_all[..., :, None, :, :2]  # (..., 4, 1, 2, 2)
        Jp = dr0[..., None] * M[..., 0, :] + dr1[..., None] * M[..., 1, :]

        wn = w[..., None, :]  # (..., 1, N)
        Jc_w = Jc * wn[..., None]
        Hcc = torch.einsum("...vni,...vnj->...ij", Jc_w, Jc)
        Hcp = torch.einsum("...vni,...vnj->...nij", Jc_w, Jp)  # (..., N, 8, 2)
        Hpp = torch.einsum("...vni,...vnj->...nij", Jp * wn[..., None], Jp)
        rw = r * wn
        gc = torch.einsum("...vni,...vn->...i", Jc, rw)
        gp = torch.einsum("...vni,...vn->...ni", Jp, rw)
        lamp = 1e-10 * (Hpp[..., 0, 0] + Hpp[..., 1, 1])[..., None, None]
        Hpp_inv = inv2(Hpp + lamp * eye2 + 1e-20 * eye2)
        HcpHi = Hcp @ Hpp_inv  # (..., N, 8, 2)
        S = Hcc - torch.sum(HcpHi @ Hcp.transpose(-1, -2), dim=-3)
        g = gc - torch.sum(HcpHi @ gp[..., None], dim=-3)[..., 0]
        lamc = 1e-10 * torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)
        dc = linalg.solve_gauss(S + lamc[..., None, None] * eye8, g)
        dc = torch.where(torch.isfinite(dc), dc, 0.0)
        dp = (Hpp_inv @ (gp - (Hcp.transpose(-1, -2)
                               @ dc[..., None, :, None])[..., 0])[..., None]
              )[..., 0]
        dp = torch.where(torch.isfinite(dp), dp, 0.0)
        camvec = camvec - dc
        Xc = Xc - dp * w[..., None]
    return _unpack_cams(camvec, cam0), Xc


def fourview_minimal_models(x1, x2, x3, x4, A: torch.Tensor):
    """Every 4-view model of one minimal sample.

    x1..x4: (..., S, 2) unit bearings of the sampled points (S >= 5); A
    (..., 3, 2, 2) the coordinate change of ``factorize_trifocal``.
    Returns cams (..., 16, 4, 2, 3): the 2 factorizations x 8 sign flips
    (``sfm2d.cc:391-441``), root-major; X_sample (..., 16, S, 2), the
    sample triangulated from views 1-3; valid (..., 16).  The fourth
    camera is ``abs_pose_2d`` on the sample points (``sfm2d.cc:435``).
    """
    T = trifocal_minimal(x1, x2, x3)
    P1, P2, P3, fact_valid = factorize_trifocal(T, A)  # (..., 2, 2, 3)
    H = metric_upgrade(P2, P3)
    P2 = P2 @ H
    P3 = P3 @ H

    def colnorm(P, c):
        return torch.linalg.vector_norm(P[..., :, c], dim=-1).clamp_min(1e-30)

    def scale_t(P, s):
        return torch.cat([P[..., :2], P[..., 2:] / s[..., None, None]], -1)

    P2 = P2 / colnorm(P2, 0)[..., None, None]
    P3 = P3 / colnorm(P3, 0)[..., None, None]
    s = colnorm(P2, 2)
    P2, P3 = scale_t(P2, s), scale_t(P3, s)
    # Base normalization before the flips (sfm2d.cc:417-418).
    t1n = colnorm(P2, 2)
    P3, P2 = scale_t(P3, t1n), scale_t(P2, t1n)

    x123 = torch.stack([x1, x2, x3], dim=-2)  # (..., S, 3, 2)
    cams_all, X_all = [], []
    for flip1 in (1.0, -1.0):
        for flip2 in (1.0, -1.0):
            for flip3 in (1.0, -1.0):
                c2 = P2 * flip2
                c2 = torch.cat([c2[..., :2], c2[..., 2:] * flip1], -1)
                c3 = P3 * flip3
                c3 = torch.cat([c3[..., :2], c3[..., 2:] * flip1], -1)
                cams3 = torch.stack([P1.expand(c2.shape), c2, c3], dim=-3)
                Xs = triangulate2d(cams3[..., None, :, :, :],
                                   x123[..., None, :, :, :])  # (..., 2, S, 2)
                P4 = abs_pose_2d(x4[..., None, :, :], Xs)
                cams_all.append(torch.cat([cams3, P4[..., None, :, :]],
                                          dim=-3))
                X_all.append(Xs)
    cams = torch.stack(cams_all, dim=-4)  # (..., 2, 8, 4, 2, 3)
    X_s = torch.stack(X_all, dim=-3)  # (..., 2, 8, S, 2)
    lead = cams.shape[:-5]
    cams = cams.reshape(lead + (16, 4, 2, 3))
    X_s = X_s.reshape(lead + (16,) + X_s.shape[-2:])
    valid = torch.repeat_interleave(fact_valid, 8, dim=-1)
    return cams, X_s, valid


def optimize_points_2d(cams: torch.Tensor, x: torch.Tensor, X: torch.Tensor,
                       iters: int = 8) -> torch.Tensor:
    """Points-only Gauss-Newton polish with the cameras fixed
    (``sfm2d.cc:75-116``): cams (..., 4, 2, 3), x (..., 4, N, 2), X
    (..., N, 2)."""
    xr = x[..., 0] / _safe(x[..., 1])
    M = cams[..., :, None, :, :2]
    eye2 = torch.eye(2, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        r, dr0, dr1, _ = _ratio_residual(cams, X, xr)
        J = dr0[..., None] * M[..., 0, :] + dr1[..., None] * M[..., 1, :]
        H = torch.einsum("...vni,...vnj->...nij", J, J)
        g = torch.einsum("...vni,...vn->...ni", J, r)
        lam = 1e-10 * (H[..., 0, 0] + H[..., 1, 1])[..., None, None]
        d = (inv2(H + lam * eye2 + 1e-20 * eye2) @ g[..., None])[..., 0]
        X = X - torch.where(torch.isfinite(d), d, 0.0)
    return X
