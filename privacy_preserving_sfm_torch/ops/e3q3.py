"""Batched 3Q3 solver: three quadrics in three unknowns (up to 8 solutions).

Port of ``privacy_preserving_sfm_tpu/ops/e3q3.py`` (the behaviour of the
reference framework's re3q3, ``lib/re3q3/re3q3/re3q3.h``):

  * pivot: of the three variable permutations, the one whose quadratic
    block (y'^2, z'^2, y'z') has the largest |det| keeps x' univariate;
  * elimination: the three quadrics, linear in (y^2, z^2, yz) given x,
    give a 3x3 polynomial matrix M(x) with M(x) [y, z, 1]^T = 0, and
    det M(x) = 0 is a degree-8 polynomial;
  * roots: ``ops/polynomial.real_roots`` (Aberth-Ehrlich, Newton polish);
  * back-substitution: least squares of M(x) [y, z]^T = -M(x)[:, 2] over
    all three rows;
  * an 8-step damped Newton polish on the quadrics, which also rescues
    float32 roots;
  * optionally, a random affine change of variables on degenerate
    instances (every pivot |det| < 1e-10), ``re3q3.h:39-64``.  Its draws
    (a unit quaternion and a unit vector) are arguments.

The reference computes all three permutations and selects one by the
pivot; here each instance's pivot-permuted coefficients are gathered
first and solved once, the same arithmetic on the same numbers.

Monomial order of the coefficients: ``x^2, xy, xz, y^2, yz, z^2, x, y, z, 1``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from privacy_preserving_sfm_torch.ops import lie, linalg
from privacy_preserving_sfm_torch.ops import polynomial as poly

# Monomial indices.
_X2, _XY, _XZ, _Y2, _YZ, _Z2, _X, _Y, _Z, _1 = range(10)

NEWTON_POLISH_ITERS = 8

# Variable permutations: for pivot k, original_var[perm[k][i]] = new var i.
_PERMS = ((0, 1, 2), (1, 0, 2), (2, 1, 0))

_PAIR = {(0, 0): _X2, (0, 1): _XY, (1, 0): _XY, (0, 2): _XZ, (2, 0): _XZ,
         (1, 1): _Y2, (1, 2): _YZ, (2, 1): _YZ, (2, 2): _Z2}
_LIN = {0: _X, 1: _Y, 2: _Z}


def _perm_source(perm) -> list:
    """Source monomial of each target monomial under ``perm``."""
    src = [0] * 10
    for (i, j), tgt in (((0, 0), _X2), ((0, 1), _XY), ((0, 2), _XZ),
                        ((1, 1), _Y2), ((1, 2), _YZ), ((2, 2), _Z2)):
        src[tgt] = _PAIR[(perm[i], perm[j])]
    for i, tgt in ((0, _X), (1, _Y), (2, _Z)):
        src[tgt] = _LIN[perm[i]]
    src[_1] = _1
    return src


def _permute_coeffs(coeffs: torch.Tensor, perm) -> torch.Tensor:
    """Reorder monomial coefficients under a permutation of (x, y, z)."""
    idx = torch.tensor(_perm_source(perm), device=coeffs.device)
    return coeffs[..., idx]


def _quad_block(c: torch.Tensor) -> torch.Tensor:
    """The (..., 3, 3) block of (y^2, z^2, yz) coefficients."""
    return torch.stack([c[..., _Y2], c[..., _Z2], c[..., _YZ]], dim=-1)


def affine_change_matrix(A: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """B (10, 10) with mu(A w + a) = B mu(w) for the monomial vector mu,
    built from the substitution (counterpart of ``re3q3.h:39-64``)."""
    B = torch.zeros((10, 10), dtype=A.dtype, device=A.device)
    for row, i, j in ((_X2, 0, 0), (_XY, 0, 1), (_XZ, 0, 2),
                      (_Y2, 1, 1), (_YZ, 1, 2), (_Z2, 2, 2)):
        # v_i v_j = sum_kl A_ik A_jl w_k w_l + sum_k (A_ik a_j + A_jk a_i)
        #           w_k + a_i a_j
        for k in range(3):
            for m in range(3):
                B[row, _PAIR[(k, m)]] += A[i, k] * A[j, m]
            B[row, _LIN[k]] += A[i, k] * a[j] + A[j, k] * a[i]
        B[row, _1] += a[i] * a[j]
    for i in range(3):
        for k in range(3):
            B[_LIN[i], _LIN[k]] += A[i, k]
        B[_LIN[i], _1] += a[i]
    B[_1, _1] = 1.0
    return B


def _build_M_polys(P: torch.Tensor):
    """The 3x3 polynomial matrix M(x) from the elimination matrix P
    (..., 3, 7), [y^2; z^2; yz] = P [x^2, xy, xz, x, y, z, 1]^T: nine
    ascending coefficient vectors, row degrees (2, 2, 3), (2, 2, 3),
    (3, 3, 4)."""
    def lin(i, col_x, col_1):
        return torch.stack([P[..., i, col_1], P[..., i, col_x]], dim=-1)

    al = [lin(i, 1, 4) for i in range(3)]
    be = [lin(i, 2, 5) for i in range(3)]
    ga = [torch.stack([P[..., i, 6], P[..., i, 3], P[..., i, 0]], dim=-1)
          for i in range(3)]
    pm, pa = poly.polymul, poly.polyadd

    # Row 1: y*(E3) == z*(E1) re-substituted.
    f1y = pa(pa(pm(al[2], be[2]), ga[2]), -pm(al[1], be[0]))
    f1z = pa(pa(pm(al[2], be[0]), pm(be[2], be[2])),
             pa(-pm(al[0], be[2]), pa(-pm(be[0], be[1]), -ga[0])))
    f1c = pa(pa(pm(al[2], ga[0]), pm(be[2], ga[2])),
             pa(-pm(al[0], ga[2]), -pm(be[0], ga[1])))
    # Row 2: z*(E3) == y*(E2) re-substituted.
    f2y = pa(pa(pm(al[0], al[1]), pm(be[1], al[2])),
             pa(ga[1], pa(-pm(al[2], al[2]), -pm(be[2], al[1]))))
    f2z = pa(pm(al[1], be[0]), pa(-pm(al[2], be[2]), -ga[2]))
    f2c = pa(pa(pm(al[1], ga[0]), pm(be[1], ga[2])),
             pa(-pm(al[2], ga[2]), -pm(be[2], ga[1])))
    # Row 3: E1 * E2 == E3^2 re-substituted.
    u = pa(pm(al[0], al[1]), -pm(al[2], al[2]))
    v = pa(pa(pm(al[0], be[1]), pm(be[0], al[1])),
           -(2.0 * pm(al[2], be[2])))
    w = pa(pm(be[0], be[1]), -pm(be[2], be[2]))
    f3y = pa(pa(pm(u, al[0]), pm(v, al[2])),
             pa(pm(w, al[1]),
                pa(pm(al[0], ga[1]), pa(pm(ga[0], al[1]),
                                        -(2.0 * pm(al[2], ga[2]))))))
    f3z = pa(pa(pm(u, be[0]), pm(v, be[2])),
             pa(pm(w, be[1]),
                pa(pm(be[0], ga[1]), pa(pm(ga[0], be[1]),
                                        -(2.0 * pm(be[2], ga[2]))))))
    f3c = pa(pa(pm(u, ga[0]), pm(v, ga[2])),
             pa(pm(w, ga[1]), pa(pm(ga[0], ga[1]), -pm(ga[2], ga[2]))))
    return (f1y, f1z, f1c), (f2y, f2z, f2c), (f3y, f3z, f3c)


def _det_poly(row1, row2, row3) -> torch.Tensor:
    """The 9 coefficients (degree 8) of det M(x), cofactor expansion."""
    f1y, f1z, f1c = row1
    f2y, f2z, f2c = row2
    f3y, f3z, f3c = row3
    pm, pa = poly.polymul, poly.polyadd
    c = pa(pm(f1y, pa(pm(f2z, f3c), -pm(f2c, f3z))),
           pa(-pm(f1z, pa(pm(f2y, f3c), -pm(f2c, f3y))),
              pm(f1c, pa(pm(f2y, f3z), -pm(f2z, f3y)))))
    if c.shape[-1] < 9:
        c = torch.nn.functional.pad(c, (0, 9 - c.shape[-1]))
    return c[..., :9]


def _eval_rows(rows, x: torch.Tensor):
    """M evaluated at root candidates x (..., R): a 3x3 nested list."""
    return [[poly.polyval(c[..., None, :], x) for c in r] for r in rows]


def _backsub_yz(rows_at_x):
    """Least-squares solve of M [y, z]^T = -M[:, 2] over the three rows."""
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = rows_at_x
    a11 = m00 * m00 + m10 * m10 + m20 * m20
    a12 = m00 * m01 + m10 * m11 + m20 * m21
    a22 = m01 * m01 + m11 * m11 + m21 * m21
    b1 = -(m00 * m02 + m10 * m12 + m20 * m22)
    b2 = -(m01 * m02 + m11 * m12 + m21 * m22)
    det = a11 * a22 - a12 * a12
    det = torch.where(det.abs() < 1e-30, 1e-30, det)
    y = (a22 * b1 - a12 * b2) / det
    z = (a11 * b2 - a12 * b1) / det
    return y, z


def _monomials(s: torch.Tensor) -> torch.Tensor:
    x, y, z = s[..., 0], s[..., 1], s[..., 2]
    return torch.stack([x * x, x * y, x * z, y * y, y * z, z * z,
                        x, y, z, torch.ones_like(x)], dim=-1)


def quadric_residuals(coeffs: torch.Tensor, sols: torch.Tensor
                      ) -> torch.Tensor:
    """The three quadrics at the solutions: (..., 3, 10), (..., R, 3) ->
    (..., R, 3)."""
    mono = _monomials(sols)  # (..., R, 10)
    return torch.sum(coeffs[..., None, :, :] * mono[..., None, :], dim=-1)


def _newton_polish(coeffs: torch.Tensor, sols: torch.Tensor,
                   iters: int = NEWTON_POLISH_ITERS) -> torch.Tensor:
    """Damped Newton on the quadrics: (J^T J + 1e-12 tr(J^T J) I) step =
    J^T r, non-finite steps zeroed."""
    c = coeffs[..., None, :, :]  # (..., 1, 3, 10)
    eye = torch.eye(3, dtype=sols.dtype, device=sols.device)
    s = sols
    for _ in range(iters):
        x, y, z = s[..., 0, None], s[..., 1, None], s[..., 2, None]
        r = quadric_residuals(coeffs, s)  # (..., R, 3)
        J = torch.stack([
            2 * c[..., _X2] * x + c[..., _XY] * y + c[..., _XZ] * z
            + c[..., _X],
            c[..., _XY] * x + 2 * c[..., _Y2] * y + c[..., _YZ] * z
            + c[..., _Y],
            c[..., _XZ] * x + c[..., _YZ] * y + 2 * c[..., _Z2] * z
            + c[..., _Z],
        ], dim=-1)  # (..., R, 3 equations, 3 variables)
        JtJ = torch.sum(J[..., :, :, None] * J[..., :, None, :], dim=-3)
        Jtr = torch.sum(J * r[..., :, None], dim=-2)
        lam = 1e-12 * (JtJ[..., 0, 0] + JtJ[..., 1, 1] + JtJ[..., 2, 2])
        step = linalg.solve3(JtJ + lam[..., None, None] * eye, Jtr)
        step = torch.where(torch.isfinite(step), step, 0.0)
        s = s - step
    return s


def solve_e3q3(coeffs: torch.Tensor,
               draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               imag_tol: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve a batch of 3Q3 systems.

    coeffs: (..., 3, 10).  ``draws``: optional (unit quaternion (4,), unit
    vector (3,)) that enables the random affine change of variables on
    degenerate instances.  Returns sols (..., 8, 3) (garbage where not
    valid) and valid (..., 8)."""
    dev = coeffs.device
    perm_c = torch.stack([_permute_coeffs(coeffs, p) for p in _PERMS])
    dets = linalg.det3(_quad_block(perm_c)).abs()  # (3, ...)
    degenerate = torch.amax(dets, dim=0) < 1e-10
    if draws is not None:
        q, avec = (d.to(device=dev, dtype=coeffs.dtype) for d in draws)
        Arot = lie.quat_to_rotmat(q)
        B = affine_change_matrix(Arot, avec)
        coeffs_tf = torch.einsum("...km,mn->...kn", coeffs, B)
        coeffs = torch.where(degenerate[..., None, None], coeffs_tf, coeffs)
        perm_c = torch.stack([_permute_coeffs(coeffs, p) for p in _PERMS])
        dets = linalg.det3(_quad_block(perm_c)).abs()
    pivot = torch.argmax(dets, dim=0)  # (...), first maximum

    # Solve each instance's pivot permutation once.
    c = torch.take_along_dim(perm_c, pivot[None, ..., None, None], dim=0)[0]
    A = _quad_block(c)
    rhs = torch.stack([c[..., _X2], c[..., _XY], c[..., _XZ], c[..., _X],
                       c[..., _Y], c[..., _Z], c[..., _1]], dim=-1)
    # Singular pivots give garbage here; inv3's determinant floor keeps it
    # finite.
    P = -(linalg.inv3(A) @ rhs)
    rows = _build_M_polys(P)
    detp = _det_poly(*rows)
    scale = torch.amax(detp.abs(), dim=-1, keepdim=True)
    detp_n = detp / torch.clamp(scale, min=1e-30)
    x, valid = poly.real_roots(detp_n, imag_tol=imag_tol)
    y, z = _backsub_yz(_eval_rows(rows, x))
    sol = torch.stack([x, y, z], dim=-1)  # (..., 8, 3) permuted variables
    # Un-permute: original var perm[i] = new var i.
    inv = torch.tensor([[list(p).index(v) for v in range(3)]
                        for p in _PERMS], device=dev)
    sols = torch.take_along_dim(sol, inv[pivot][..., None, :], dim=-1)

    sols = _newton_polish(coeffs, sols)
    if draws is not None:
        sols_tf = sols @ Arot.T + avec
        sols = torch.where(degenerate[..., None, None], sols_tf, sols)
    valid = valid & torch.isfinite(sols).all(dim=-1)
    return sols, valid
