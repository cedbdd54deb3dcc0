"""Closed-form 3x3 kernels (batched torch), as BA needs them.

Port of ``privacy_preserving_sfm_tpu/ops/linalg.py:20-83``: explicit
cofactor forms and the closed-form Cholesky factor, broadcast over leading
batch dimensions.
"""

from __future__ import annotations

import torch


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


def inv3(A: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    det = det3(A)
    e = det.new_full((), eps)
    det = torch.where(det.abs() < eps, torch.where(det < 0, -e, e), det)
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
