"""Closed-form small-matrix kernels (batched torch).

Port of ``privacy_preserving_sfm_tpu/ops/linalg.py``: explicit cofactor
forms for 2x2 and 3x3 systems, the closed-form Cholesky factor, a
fixed-sweep Jacobi eigensolver for small symmetric matrices, a pivoting
Gauss solve for small dense systems and a regularized normal-equation
least squares, all broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch


def det2(A: torch.Tensor) -> torch.Tensor:
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def det3(A: torch.Tensor) -> torch.Tensor:
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def adjugate3(A: torch.Tensor) -> torch.Tensor:
    """Adjugate (transposed cofactor matrix) of 3x3 A."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    adj = torch.stack(
        [
            e * i - f * h, c * h - b * i, b * f - c * e,
            f * g - d * i, a * i - c * g, c * d - a * f,
            d * h - e * g, b * g - a * h, a * e - b * d,
        ],
        dim=-1,
    )
    return adj.reshape(A.shape)


def _clamp_det(det: torch.Tensor, eps: float) -> torch.Tensor:
    e = det.new_full((), eps)
    return torch.where(det.abs() < eps, torch.where(det < 0, -e, e), det)


def solve2(A: torch.Tensor, b: torch.Tensor, eps: float = 1e-30
           ) -> torch.Tensor:
    """Solve 2x2 systems A x = b by Cramer's rule. (..., 2, 2), (..., 2)."""
    det = _clamp_det(det2(A), eps)
    x0 = (A[..., 1, 1] * b[..., 0] - A[..., 0, 1] * b[..., 1]) / det
    x1 = (A[..., 0, 0] * b[..., 1] - A[..., 1, 0] * b[..., 0]) / det
    return torch.stack([x0, x1], dim=-1)


def solve3(A: torch.Tensor, b: torch.Tensor, eps: float = 1e-30
           ) -> torch.Tensor:
    """Solve 3x3 systems A x = b via the adjugate. (..., 3, 3), (..., 3)."""
    det = _clamp_det(det3(A), eps)
    return torch.sum(adjugate3(A) * b[..., None, :], dim=-1) / det[..., None]


def inv3(A: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    det = _clamp_det(det3(A), eps)
    return adjugate3(A) / det[..., None, None]


def chol3(A: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Closed-form Cholesky of batched SPD 3x3: A = L L^T, L lower.

    Reads only the lower triangle.  Pivots are clamped at ``eps``, so
    singular or padded blocks give finite (meaningless) factors instead of
    NaNs; callers mask them.
    """
    l00 = torch.sqrt(A[..., 0, 0].clamp_min(eps))
    l10 = A[..., 1, 0] / l00
    l20 = A[..., 2, 0] / l00
    l11 = torch.sqrt((A[..., 1, 1] - l10 * l10).clamp_min(eps))
    l21 = (A[..., 2, 1] - l20 * l10) / l11
    l22 = torch.sqrt((A[..., 2, 2] - l20 * l20 - l21 * l21).clamp_min(eps))
    z = torch.zeros_like(l00)
    return torch.stack([
        torch.stack([l00, z, z], -1),
        torch.stack([l10, l11, z], -1),
        torch.stack([l20, l21, l22], -1)], -2)


def solve_spd(A: torch.Tensor, b: torch.Tensor,
              damping: float = 0.0) -> torch.Tensor:
    """Solve small SPD systems (n <= 3) by the closed forms above."""
    n = A.shape[-1]
    if damping:
        A = A + damping * torch.eye(n, dtype=A.dtype, device=A.device)
    if n == 2:
        return solve2(A, b)
    if n == 3:
        return solve3(A, b)
    raise ValueError(f"solve_spd only supports n<=3, got {n}")


_JACOBI_SWEEPS = 10


def symmetric_eig_smallest(G: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., n, n) G.

    A fixed 10 sweeps of cyclic Jacobi over the pairs (p, q), p < q, in
    order, as the reference runs it (so the sign, and the output where the
    sweeps have not converged, are the reference's).  Each rotation
    updates the two columns and then the two rows it touches; the
    reference multiplies by the full rotation matrix, which is the same
    arithmetic plus exact zeros.  Ties in the final diagonal go to the
    first index.
    """
    n = G.shape[-1]
    A = G.clone()
    V = torch.eye(n, dtype=G.dtype, device=G.device).expand(G.shape).clone()
    pairs = [(p, q) for p in range(n) for q in range(p + 1, n)]
    for _ in range(_JACOBI_SWEEPS):
        for p, q in pairs:
            theta = 0.5 * torch.atan2(2.0 * A[..., p, q],
                                      A[..., q, q] - A[..., p, p])
            c = torch.cos(theta)[..., None]
            s = torch.sin(theta)[..., None]
            # A <- J^T A J with J = I except J[p,p] = J[q,q] = c,
            # J[p,q] = s, J[q,p] = -s; V <- V J.
            for M in (A, V):
                mp, mq = M[..., :, p].clone(), M[..., :, q].clone()
                M[..., :, p] = c * mp - s * mq
                M[..., :, q] = s * mp + c * mq
            ap, aq = A[..., p, :].clone(), A[..., q, :].clone()
            A[..., p, :] = c * ap - s * aq
            A[..., q, :] = s * ap + c * aq
    idx = torch.argmin(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1)
    v = torch.take_along_dim(V, idx[..., None, None].expand(
        idx.shape + (n, 1)), dim=-1)[..., 0]
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(
        1e-30)


def gram_null_vector(A: torch.Tensor) -> torch.Tensor:
    """Unit null-space vector of a tall (..., m, n) stack: the smallest
    eigenvector of the Gram of its norm-balanced rows."""
    norm = torch.linalg.vector_norm(A, dim=-1, keepdim=True)
    An = A / norm.clamp_min(1e-30)
    return symmetric_eig_smallest(An.transpose(-1, -2) @ An)


def solve_gauss(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense solve of (..., n, n) A x = (..., n) b with partial pivoting,
    unrolled over the static n (the 8x8 camera system of the 2D init
    bundle).  The pivot is the first row of largest magnitude at or below
    the diagonal; a pivot under 1e-30 in magnitude is clamped."""
    n = A.shape[-1]
    M = torch.cat([A, b[..., :, None]], dim=-1)  # (..., n, n+1)
    ar = torch.arange(n, device=A.device)
    for k in range(n):
        col = M[..., :, k].abs()
        if k > 0:
            col = torch.where(ar < k, -torch.inf, col)
        piv = torch.argmax(col, dim=-1)  # (...,)
        # Swap rows k and piv by a gather.
        idx = ar.expand(M.shape[:-1]).clone()
        idx[..., k] = piv
        idx = torch.where((ar == piv[..., None]) & (ar != k), k, idx)
        M = torch.take_along_dim(M, idx[..., None], dim=-2)
        pv = _clamp_det(M[..., k, k], 1e-30)
        row_k = M[..., k, :] / pv[..., None]
        M = M.clone()
        M[..., k, :] = row_k
        factors = M[..., :, k].clone()
        factors[..., k] = 0.0
        M = M - factors[..., :, None] * row_k[..., None, :]
    return M[..., :, n]


def lstsq_normal3(A: torch.Tensor, b: torch.Tensor, reg_scale: float = 1e-12,
                  refine: int = 1) -> torch.Tensor:
    """Least squares of tall (..., N, 3) systems by the normal equations,
    with a trace-scaled Levenberg floor and ``refine`` rounds of iterative
    refinement."""
    AtA = A.transpose(-1, -2) @ A
    Atb = torch.sum(A * b[..., :, None], dim=-2)
    reg = reg_scale * torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    AtA_r = AtA + (reg[..., None, None] + 1e-30) * eye
    x = solve3(AtA_r, Atb)
    for _ in range(refine):
        r = Atb - torch.sum(AtA * x[..., None, :], dim=-1)
        x = x + solve3(AtA_r, r)
    return x
