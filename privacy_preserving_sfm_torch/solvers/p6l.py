"""P6L: absolute camera pose from 6 point-to-line correspondences (torch).

Port of ``privacy_preserving_sfm_tpu/solvers/p6l.py``, the batched minimal
solver of the reference framework (``src/estimators/absolute_pose.cc:
79-162``):

  constraint   l_i^T (R X_i + t) = 0
  split        the first 3 correspondences eliminate t, the other 3 give
               homogeneous constraints on vec(R)
  rotation     Cayley parametrization -> 3Q3 problem -> ``ops/e3q3``
  output       up to 8 poses [R | t] per sample

with the robust wrapper ``estimate_absolute_pose_from_lines``
(``src/estimators/pose.cc:52-94``: RANSAC, no model from an all-aligned
sample, a best model whose inliers are > 90 % aligned rejected) and the
pose refinement (``pose.cc:96-213``: Cauchy loss on the pixel line cost,
points constant) as 20 IRLS Gauss-Newton steps.

Draws: the samples (B, 6) and the singular-B mix (3, 3) are tensors;
``draw_pose`` takes them from a ``torch.Generator`` on the CPU, so a card
run and a CPU run try the same samples, and tests can feed the
reference's own draws to ``estimate_absolute_pose_from_lines_with_draws``.
``estimate_pose_candidates`` scores S candidate line sets of the same
correspondences (the mapper's focal search) in one batch on shared draws.
No correspondence is padded: a call solves exactly its N.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from privacy_preserving_sfm_torch.ops import e3q3, lie, linalg
from privacy_preserving_sfm_torch.ops import lines as line_ops
from privacy_preserving_sfm_torch.solvers import ransac

BIG = 1e30
REFINE_ITERS = 20
# Hypothesis x candidate x correspondence entries scored at once (bounds
# the residual temporaries: about ten numbers an entry).
SCORE_ENTRIES = 1 << 23


def _vec_colmajor(R: torch.Tensor) -> torch.Tensor:
    """Column-major vec(R): r[3a+b] = R[b, a] (Eigen's Map order)."""
    return R.transpose(-1, -2).reshape(R.shape[:-2] + (9,))


def _rotation_to_e3q3(r: torch.Tensor) -> torch.Tensor:
    """Homogeneous constraints r @ vec(R) = 0 (..., 3, 9) -> 3Q3
    coefficients (..., 3, 10): the Cayley substitution R(c) (1 + |c|^2)
    over the monomial basis (``absolute_pose.cc:46-62``)."""
    return torch.stack([
        r[..., 0] - r[..., 4] - r[..., 8],
        2 * (r[..., 1] + r[..., 3]),
        2 * (r[..., 2] + r[..., 6]),
        r[..., 4] - r[..., 0] - r[..., 8],
        2 * (r[..., 5] + r[..., 7]),
        r[..., 8] - r[..., 4] - r[..., 0],
        2 * (r[..., 5] - r[..., 7]),
        2 * (r[..., 6] - r[..., 2]),
        2 * (r[..., 1] - r[..., 3]),
        r[..., 0] + r[..., 4] + r[..., 8],
    ], dim=-1)


def p6l_minimal(lines: torch.Tensor, points: torch.Tensor,
                Amix: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The P6L minimal problem, batched.

    lines (..., 6, 3) normalized 2D lines, points (..., 6, 3), ``Amix``
    (3, 3): the random combination of the rotation constraints added
    where the first three lines are singular (``absolute_pose.cc:
    125-134``).  Returns poses (..., 8, 3, 4) and valid (..., 8)."""
    def kron_rows(ls, Xs):  # rows kron(X^T, l^T): [3a+b] = X_a l_b
        return (Xs[..., :, :, None] * ls[..., :, None, :]).reshape(
            ls.shape[:-2] + (3, 9))

    l_t = lines[..., :3, :]  # the first three eliminate t
    l_r = lines[..., 3:, :]
    tt = kron_rows(l_t, points[..., :3, :])
    Rcoeffs = kron_rows(l_r, points[..., 3:, :])
    B = l_t.transpose(-1, -2)  # columns are lines
    degen = (linalg.det3(B).abs() < 1e-10)[..., None, None]
    tt = torch.where(degen, tt + Amix @ Rcoeffs, tt)
    B = torch.where(degen, B + l_r.transpose(-1, -2) @ Amix.T, B)
    # t = -(B^T)^{-1} tt vec(R): keep tt <- (B^T)^{-1} tt.
    tt = linalg.inv3(B.transpose(-1, -2)) @ tt
    # The remaining three constraints with t substituted.
    Rcoeffs = Rcoeffs - l_r @ tt
    sols, valid = e3q3.solve_e3q3(_rotation_to_e3q3(Rcoeffs))
    R = lie.cayley_to_rotmat(sols)  # (..., 8, 3, 3)
    t = -(_vec_colmajor(R) @ tt.transpose(-1, -2))  # (..., 8, 3)
    poses = torch.cat([R, t[..., None]], dim=-1)
    valid = valid & torch.isfinite(poses).flatten(-2).all(-1)
    return poses, valid


def p6l_residuals(poses: torch.Tensor, lines: torch.Tensor,
                  points: torch.Tensor) -> torch.Tensor:
    """Squared normalized point-to-line residual (l . (P X / z))^2, BIG
    behind the camera (``ComputeSquaredLineReprojectionError``,
    ``estimators/utils.cc:40-89``).  poses (..., 3, 4), lines (..., N, 3)
    broadcasting against the poses' leading axes, points (N, 3) ->
    (..., N)."""
    xyz = poses[..., :3] @ points.T + poses[..., 3:]  # (..., 3, N)
    z = xyz[..., 2, :]
    num = lines[..., 0] * xyz[..., 0, :] + lines[..., 1] * xyz[..., 1, :] \
        + lines[..., 2] * z
    r = num / torch.where(z.abs() < 1e-30, 1e-30, z)
    return torch.where(z > torch.finfo(poses.dtype).eps, r * r, BIG)


class PoseResult(NamedTuple):
    qvec: torch.Tensor  # (4,)
    tvec: torch.Tensor  # (3,)
    num_inliers: torch.Tensor  # ()
    inlier_mask: torch.Tensor  # (N,) bool
    success: torch.Tensor  # () bool


def draw_pose(generator: torch.Generator, num_data: int,
              num_hypotheses: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draws of one hypothesis batch on the CPU: 6 distinct indices of
    ``num_data`` correspondences per hypothesis (``ransac.draw_samples``)
    and the float64 normal (3, 3) mix of ``p6l_minimal``."""
    idx = ransac.draw_samples(
        generator, torch.ones(num_data, dtype=torch.bool), 6, num_hypotheses)
    Amix = torch.randn((3, 3), generator=generator, dtype=torch.float64)
    return idx, Amix


def estimate_absolute_pose_from_lines_with_draws(
        lines: torch.Tensor, aligned: torch.Tensor, points3d: torch.Tensor,
        max_error_normalized: float, idx: torch.Tensor,
        Amix: torch.Tensor) -> PoseResult:
    """RANSAC P6L pose from given draws.

    lines (N, 3) normalized, aligned (N,) bool, points3d (N, 3);
    ``max_error_normalized``: the inlier threshold in the normalized image
    plane (pixels over the focal, ``incremental_mapper.cc:673-674``); idx
    (B, 6) sample indices, Amix (3, 3).  An all-aligned sample gives no
    model (``absolute_pose.cc:95-97``), and a best model whose inliers are
    more than 90 % aligned fails (``pose.cc:69-83``).  The B x 8
    hypotheses are scored in chunks; the first best is kept."""
    r = estimate_pose_candidates_with_draws(
        lines[None], aligned, points3d,
        torch.tensor([max_error_normalized], dtype=lines.dtype), idx, Amix)
    return PoseResult(*(v[0] for v in r))


def estimate_pose_candidates_with_draws(
        lines: torch.Tensor, aligned: torch.Tensor, points3d: torch.Tensor,
        max_error_normalized: torch.Tensor, idx: torch.Tensor,
        Amix: torch.Tensor) -> PoseResult:
    """``estimate_absolute_pose_from_lines_with_draws`` for S candidate
    line sets of the same N correspondences at once, all on the same draws:
    lines (S, N, 3), thresholds ``max_error_normalized`` (S,).  Returns a
    PoseResult with a leading S axis.  The S x B x 8 hypotheses are scored
    in chunks of B of at most ``SCORE_ENTRIES`` hypothesis x
    correspondence entries."""
    dev, dtype = lines.device, lines.dtype
    idx = idx.to(dev)
    S, n = lines.shape[:2]
    B = idx.shape[0]
    poses, pvalid = p6l_minimal(lines[:, idx],
                                points3d[idx].expand(S, B, 6, 3),
                                Amix.to(device=dev, dtype=dtype))
    pvalid = pvalid & ~aligned[idx].all(-1)[:, None]  # (S, B, 8)
    thresh = max_error_normalized.to(device=dev, dtype=dtype) ** 2
    lines_b = lines[:, None, None]  # against (S, b, 8) hypotheses
    chunk = max(1, SCORE_ENTRIES // (8 * S * max(n, 1)))
    rows = torch.arange(S, device=dev)
    best = None
    for b0 in range(0, B, chunk):
        pc, vc = poses[:, b0:b0 + chunk], pvalid[:, b0:b0 + chunk]
        res = torch.where(vc[..., None],
                          p6l_residuals(pc, lines_b, points3d), BIG)
        inlier = res < thresh[:, None, None, None]
        num = inlier.sum(-1)
        rs = torch.where(inlier, res, 0.0).sum(-1)
        score = (num.to(dtype) - rs / (1.0 + rs)).reshape(S, -1)
        k = torch.argmax(score, dim=1)
        cand = (score[rows, k], pc.reshape(S, -1, 3, 4)[rows, k],
                num.reshape(S, -1)[rows, k],
                inlier.reshape(S, -1, n)[rows, k])
        if best is None:
            best = cand
        else:
            better = cand[0] > best[0]  # earlier chunks win ties
            best = tuple(
                torch.where(better.reshape((S,) + (1,) * (c.dim() - 1)),
                            c, b)
                for c, b in zip(cand, best))
    _, model, num_inliers, inlier_mask = best
    num_aligned = (inlier_mask & aligned).sum(-1)
    success = (num_inliers > 0) & (num_aligned <= 0.9 * num_inliers)
    qvec = lie.rotmat_to_quat(model[..., :3])
    tvec = model[..., 3]
    success = success & torch.isfinite(qvec).all(-1) & \
        torch.isfinite(tvec).all(-1)
    return PoseResult(qvec, tvec, num_inliers, inlier_mask, success)


def estimate_absolute_pose_from_lines(
        generator: torch.Generator, lines: torch.Tensor,
        aligned: torch.Tensor, points3d: torch.Tensor,
        max_error_normalized: float,
        num_hypotheses: int = 4096) -> PoseResult:
    """``estimate_absolute_pose_from_lines_with_draws`` with a batch of
    ``num_hypotheses`` draws from ``generator`` (``draw_pose``)."""
    idx, Amix = draw_pose(generator, lines.shape[0], num_hypotheses)
    return estimate_absolute_pose_from_lines_with_draws(
        lines, aligned, points3d, max_error_normalized, idx, Amix)


def estimate_pose_candidates(
        generator: torch.Generator, lines: torch.Tensor,
        aligned: torch.Tensor, points3d: torch.Tensor,
        max_error_normalized: torch.Tensor,
        num_hypotheses: int) -> PoseResult:
    """``estimate_pose_candidates_with_draws`` with one batch of
    ``num_hypotheses`` draws from ``generator`` that every candidate
    shares (the reference maps its estimator over the candidates under
    one key)."""
    idx, Amix = draw_pose(generator, lines.shape[1], num_hypotheses)
    return estimate_pose_candidates_with_draws(
        lines, aligned, points3d, max_error_normalized, idx, Amix)


def _quat_delta(dq: torch.Tensor) -> torch.Tensor:
    """(1, dq / 2) / sqrt(1 + |dq / 2|^2): smooth at dq = 0."""
    half = dq / 2.0
    q = torch.cat([torch.ones_like(half[:1]), half])
    return q / torch.sqrt(1.0 + torch.sum(half * half))


def refine_absolute_pose_from_lines(
        qvec: torch.Tensor, tvec: torch.Tensor, lines: torch.Tensor,
        points3d: torch.Tensor, weights_mask: torch.Tensor,
        camera_model: str, camera_params: torch.Tensor,
        loss_scale: float = 1.0, iters: int = REFINE_ITERS):
    """Refine (qvec, tvec) by ``iters`` damped IRLS Gauss-Newton steps on
    the 2-vector pixel line cost (``cost_functions.h:62-100``) with Cauchy
    weights of scale ``loss_scale``; observations with ``weights_mask`` 0
    (the outliers) are left out.  The update lives in the 6-dof tangent
    space (rotation, translation); the Jacobian comes from
    ``torch.func.jacfwd``."""
    dtype = qvec.dtype
    w_mask = weights_mask.to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=qvec.device)
    zero = torch.zeros(6, dtype=dtype, device=qvec.device)
    q, t = qvec, tvec
    for _ in range(iters):
        def res_qt(params, q=q, t=t):
            r = line_ops.line_ba_residual(
                lines, points3d, lie.quat_multiply(q, _quat_delta(params[:3])),
                t + params[3:], camera_model, camera_params)
            return r, r

        J, r = torch.func.jacfwd(res_qt, has_aux=True)(zero)  # (N, 2, 6)
        sq = torch.sum(r * r, dim=-1)
        w = w_mask / (1.0 + sq / loss_scale ** 2)
        Jw = J * w[:, None, None]
        JtJ = torch.einsum("nri,nrj->ij", Jw, J)
        Jtr = torch.einsum("nri,nr->i", Jw, r)
        lam = 1e-6 * torch.trace(JtJ)
        step = _solve6(JtJ + lam * eye6, Jtr)
        step = torch.where(torch.isfinite(step), step, 0.0)
        q = lie.quat_normalize(lie.quat_multiply(q, _quat_delta(-step[:3])))
        t = t - step[3:]
    return q, t


def _solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """6x6 SPD solve by 3x3 block elimination."""
    A11, A12 = A[:3, :3], A[:3, 3:]
    A21, A22 = A[3:, :3], A[3:, 3:]
    A11i = linalg.inv3(A11)
    S = A22 - A21 @ A11i @ A12
    b1, b2 = b[:3], b[3:]
    x2 = linalg.solve3(S, b2 - A21 @ (A11i @ b1))
    x1 = A11i @ (b1 - A12 @ x2)
    return torch.cat([x1, x2])
