"""Batched univariate polynomial arithmetic and root finding (torch).

Port of ``privacy_preserving_sfm_tpu/ops/polynomial.py``.  Roots come from
a fixed-iteration Aberth-Ehrlich simultaneous iteration in complex
arithmetic (``torch.complex64`` for float32 coefficients,
``torch.complex128`` for float64), after a root-magnitude rescale, then
Newton polishing of the real parts.  The reference framework extracts the
roots with a companion-matrix eigensolve (``re3q3.h:152-165``); that is a
different algorithm whose roots differ in their low bits, so it is not
used here.  Step counts and finiteness guards are the reference's.

Coefficient convention: ascending order, ``p(x) = sum_k c[..., k] x^k``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

ABERTH_ITERS = 48
POLISH_ITERS = 3


def _complex_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex64 if dtype == torch.float32 else torch.complex128


def polymul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of ascending-coefficient polynomials, batched on leading
    dims: (..., Na), (..., Nb) -> (..., Na + Nb - 1)."""
    na, nb = a.shape[-1], b.shape[-1]
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = torch.zeros(lead + (na + nb - 1,),
                      dtype=torch.result_type(a, b), device=a.device)
    for i in range(na):
        out[..., i:i + nb] += a[..., i:i + 1] * b
    return out


def polyadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of ascending-coefficient polynomials of possibly different
    lengths."""
    n = max(a.shape[-1], b.shape[-1])
    pa = torch.nn.functional.pad(a, (0, n - a.shape[-1]))
    pb = torch.nn.functional.pad(b, (0, n - b.shape[-1]))
    return pa + pb


def polyval(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Horner evaluation: c (..., N), x (...) -> (...); x may be complex."""
    out = torch.zeros_like(x) + c[..., -1]
    for k in range(c.shape[-1] - 2, -1, -1):
        out = out * x + c[..., k]
    return out


def polyder(c: torch.Tensor) -> torch.Tensor:
    """Derivative, ascending coefficients."""
    n = c.shape[-1]
    k = torch.arange(1, n, device=c.device).to(c.dtype)
    return c[..., 1:] * k


def _initial_roots(c: torch.Tensor, degree: int) -> torch.Tensor:
    """Initial Aberth guesses on a circle of radius 1 + max|c_k / c_n|
    (capped at 1e8), at the fixed non-symmetric angles 2 pi k / n + 0.4."""
    cn = c[..., -1:]
    cn_safe = torch.where(cn.abs() < 1e-30, 1e-30, cn)
    ratios = (c[..., :-1] / cn_safe).abs()
    r = 1.0 + torch.amax(ratios, dim=-1, keepdim=True)
    r = torch.clamp(r, max=1e8)
    k = torch.arange(degree, device=c.device).to(c.dtype)
    theta = 2.0 * math.pi * k / degree + 0.4
    return r * torch.polar(torch.ones_like(theta), theta)


def aberth_roots(c: torch.Tensor, iters: int = ABERTH_ITERS) -> torch.Tensor:
    """All complex roots of p(x) = sum c[..., k] x^k, degree N - 1.

    c: (..., N) real with a nonzero leading coefficient (callers guard
    degenerate rows).  Returns (..., N - 1) complex roots after ``iters``
    fixed steps."""
    degree = c.shape[-1] - 1
    cdtype = _complex_dtype(c.dtype)
    cn = c[..., -1:]
    cn_safe = torch.where(cn.abs() < 1e-30, 1e-30, cn)
    cm = c / cn_safe

    # x = s u with s ~ |c0 / cN|^(1/N): the initial circle then sits near
    # the roots even when the coefficients span many orders of magnitude.
    c0 = cm[..., :1].abs()
    s = torch.pow(torch.clamp(c0, min=1e-30), 1.0 / degree)
    s = torch.clamp(s, 1e-6, 1e6)
    k = torch.arange(degree + 1, device=c.device).to(c.dtype)
    cm = cm * torch.pow(s, k)
    cm = cm / torch.clamp(torch.amax(cm.abs(), dim=-1, keepdim=True),
                          min=1e-30)
    z = _initial_roots(cm, degree)  # (..., degree)
    cm = cm.to(cdtype)
    cmb = cm[..., None, :]
    dcmb = polyder(cm)[..., None, :]
    eye = torch.eye(degree, dtype=torch.bool, device=c.device)
    one = torch.ones((), dtype=cdtype, device=c.device)
    zero = torch.zeros((), dtype=cdtype, device=c.device)
    tiny = torch.full((), 1e-30, dtype=cdtype, device=c.device)
    for _ in range(iters):
        p = polyval(cmb, z)
        dp = polyval(dcmb, z)
        dp = torch.where(dp.abs() < 1e-30, tiny, dp)
        newton = p / dp
        # Pairwise repulsion sum_{j != i} 1 / (z_i - z_j).
        diff = z[..., :, None] - z[..., None, :]
        diff = torch.where(eye, one, diff)
        inv = torch.where(eye, zero, 1.0 / diff)
        rep = torch.sum(inv, dim=-1)
        denom = 1.0 - newton * rep
        denom = torch.where(denom.abs() < 1e-30, tiny, denom)
        step = newton / denom
        step = torch.where(torch.isfinite(step), step, zero)
        z = z - step
    return z * s.to(cdtype)


def real_roots(c: torch.Tensor, imag_tol: float = 1e-6,
               polish_iters: int = POLISH_ITERS
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real roots of a real polynomial and their realness mask, both
    (..., degree): the Aberth roots' real parts after ``polish_iters``
    Newton steps on the monic polynomial; a root is real when its
    imaginary part is within ``imag_tol`` of max(|z|, 1)."""
    z = aberth_roots(c)
    x = z.real

    cn = c[..., -1:]
    cn_safe = torch.where(cn.abs() < 1e-30, 1e-30, cn)
    cm = c / cn_safe
    dcm = polyder(cm)
    cmb = cm[..., None, :]
    dcmb = dcm[..., None, :]
    for _ in range(polish_iters):
        p = polyval(cmb, x)
        dp = polyval(dcmb, x)
        dp = torch.where(dp.abs() < 1e-30, 1e-30, dp)
        step = p / dp
        step = torch.where(torch.isfinite(step), step, 0.0)
        x = x - step
    scale = torch.clamp(z.abs(), min=1.0)
    is_real = z.imag.abs() <= imag_tol * scale
    return x, is_real
