"""Plain reference of the line bundle adjustment with one shared focal
length, in float64 PyTorch.

Imports nothing of the program.  Every image is taken by one
SIMPLE_PINHOLE camera (f, cx, cy) whose principal point is fixed and
whose focal is an unknown beside the poses and points (COLMAP's
``single_camera`` with ``ba_refine_focal_length``).  Each observed line
(a, b, c), ||(a, b)|| = 1, was lifted to the normalized plane under the
start parameters (f0, cx, cy).  Under a focal f the same image line is

    l' = (a f / f0, b f / f0, c) / ||(a f / f0, b f / f0)||

(a focal change is an affinity of the normalized plane; the principal
point does not move, so c keeps its value), and the residual is
``reference.ba``'s pixel residual f s (a', b') with s = l' . (x, y, 1),
f taking the focal's value.  With m = ||(a, b)|| that is
f s = (f (a x + b y) + c f0) / m, so d(f s) / df = (a x + b y) / m.

``normal_equations`` adds the focal's column to ``reference.ba``'s normal
equations of the corrected lines; ``reduced_system`` eliminates the points
and forms the dense (6 C + 1) system of the poses and the focal;
``solve`` runs Levenberg-Marquardt with exact steps (Cholesky) to
convergence.  ``computed_in_tf32`` (``reference.ba``'s) rounds every
product's operands here too.

Departures from the port's solver (``optim/ba_intrinsics``):

* the reduced system is solved exactly (dense Cholesky), where the port
  runs 30 steps of CG preconditioned by its diagonal blocks;
* the Jacobians are analytic, where the port differentiates its residual
  through the corrected line by ``jacfwd``;
* LM runs until the relative decrease falls below 1e-13 twice, where the
  port stops at its gradient tolerance or iteration cap;
* only the focal is refined: the port's principal-point and distortion
  columns are not written here (the configuration fixes them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import ba
from benchmark.reference.ba import tf


class Problem(NamedTuple):
    cam: torch.Tensor       # (O,) int64
    pt: torch.Tensor        # (O,) int64
    lines: torch.Tensor     # (O, 3), lifted under (f0, cx, cy)
    lift: tuple             # (f0, cx, cy)
    dof_mask: torch.Tensor  # (C, 6)
    num_cams: int
    num_points: int


def to_problem(cam, pt, lines, lift, dof_mask, num_cams, num_points,
               dtype=torch.float64) -> Problem:
    return Problem(cam, pt, lines.to(dtype), tuple(float(p) for p in lift),
                   dof_mask.to(dtype), num_cams, num_points)


def corrected(lines: torch.Tensor, f0: float, f: float) -> torch.Tensor:
    """The lines lifted under focal ``f0`` in the normalized plane of
    ``f`` (same principal point), renormalized."""
    a2 = lines[:, 0] * (f / f0)
    b2 = lines[:, 1] * (f / f0)
    norm = torch.sqrt(a2 * a2 + b2 * b2)
    return torch.stack([a2 / norm, b2 / norm, lines[:, 2] / norm], 1)


def at_focal(prob: Problem, f: float) -> ba.Problem:
    """``reference.ba``'s problem of the corrected lines under ``f``."""
    return ba.Problem(prob.cam, prob.pt, corrected(prob.lines, prob.lift[0],
                                                   f),
                      (f,) + prob.lift[1:], prob.dof_mask, prob.num_cams,
                      prob.num_points)


def cost(prob: Problem, q, t, X, f: float) -> torch.Tensor:
    return ba.cost(at_focal(prob, f), q, t, X)


class Normal(NamedTuple):
    pose: ba.Normal        # the pose and point blocks (``reference.ba``)
    Jf: torch.Tensor       # (O,) d(f s) / df
    Hff: torch.Tensor      # 0-d
    gf: torch.Tensor       # 0-d
    Hcf: torch.Tensor      # (C, 6)
    Hpf: torch.Tensor      # (P, 3)


def normal_equations(prob: Problem, q, t, X, f: float) -> Normal:
    n = ba.normal_equations(at_focal(prob, f), q, t, X)
    xc = ba.quat_rotate(q[prob.cam], X[prob.pt]) + t[prob.cam]
    x, y = tf(xc[:, 0] / xc[:, 2]), tf(xc[:, 1] / xc[:, 2])
    l = tf(prob.lines)
    m = torch.sqrt(l[:, 0] * l[:, 0] + l[:, 1] * l[:, 1])
    Jf = tf((l[:, 0] * x + l[:, 1] * y) / m)
    Hcf = torch.zeros(prob.num_cams, 6, dtype=X.dtype, device=X.device)
    Hcf.index_add_(0, prob.cam, n.Jc * Jf[:, None])
    Hpf = torch.zeros(prob.num_points, 3, dtype=X.dtype, device=X.device)
    Hpf.index_add_(0, prob.pt, n.Jp * Jf[:, None])
    return Normal(n, Jf, torch.sum(Jf * Jf), torch.sum(Jf * n.r), Hcf, Hpf)


def reduced_system(prob: Problem, n: Normal, lam: float):
    """S (6C + 1, 6C + 1) and rhs of the damped reduced system of the
    poses (6c + i) and the focal (last), the points eliminated; gauge dofs
    get a unit diagonal and a zero right-hand side.  Also Hpp^-1."""
    p, C = n.pose, prob.num_cams
    Hpp_inv = ba.damped_point_inverse(p.Hpp, lam)
    layout = ba.Problem(prob.cam, prob.pt, prob.lines, prob.lift,
                        prob.dof_mask, C, prob.num_points)
    S_corr, rhs_corr = ba.reduced_correction(layout, p, Hpp_inv)
    # y_p = Hpp_p^-1 Hpf_p: the focal's column through each point.
    y = tf(torch.einsum("pij,pj->pi", tf(Hpp_inv), tf(n.Hpf)))
    cf = torch.zeros(C, 6, dtype=S_corr.dtype, device=S_corr.device)
    cf.index_add_(0, prob.cam, p.Jc * tf(torch.sum(p.Jp * y[prob.pt], 1)
                                         )[:, None])
    k = 6 * C
    Sc = -S_corr
    idx = torch.arange(C, device=Sc.device)
    Sc.view(C, 6, C, 6)[idx, :, idx, :] += ba.damped_cameras(p.Hcc, lam)
    S = torch.zeros(k + 1, k + 1, dtype=Sc.dtype, device=Sc.device)
    S[:k, :k] = Sc
    del Sc
    S[:k, k] = S[k, :k] = (n.Hcf - cf).reshape(-1)
    S[k, k] = n.Hff * (1.0 + lam) + 1e-12 - torch.sum(tf(n.Hpf) * y)
    rhs = torch.cat([p.gc.reshape(-1) - rhs_corr,
                     (n.gf - torch.sum(y * tf(p.gp)))[None]])
    frozen = torch.cat([prob.dof_mask.reshape(-1) == 0,
                        torch.zeros(1, dtype=torch.bool, device=S.device)])
    S[frozen, :] = 0.0
    S[:, frozen] = 0.0
    S[frozen, frozen] = 1.0
    rhs = torch.where(frozen, torch.zeros_like(rhs), rhs)
    return S, rhs, Hpp_inv


def step(prob: Problem, n: Normal, lam: float):
    """The exact damped step (dc (C, 6), df, dp (P, 3)) to be
    subtracted."""
    S, rhs, Hpp_inv = reduced_system(prob, n, lam)
    L, info = torch.linalg.cholesky_ex(S)
    if int(info) == 0:
        d = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    else:  # not positive definite in rounding (the TF32 control): LU
        d = torch.linalg.solve(S, rhs)
    dc, df = d[:-1].reshape(-1, 6), d[-1]
    p = n.pose
    # dp = Hpp^-1 (gp - Hcp^T dc - Hpf df)
    e = torch.zeros_like(p.gp)
    e.index_add_(0, prob.pt, p.Jp * tf(torch.sum(p.Jc * tf(dc)[prob.cam], 1)
                                       + n.Jf * tf(df))[:, None])
    dp = torch.einsum("pij,pj->pi", tf(Hpp_inv), tf(p.gp - e))
    return dc, df, dp


class Solution(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    f: float
    cost: float
    iterations: int


def solve(prob: Problem, q, t, X, f: float, max_iterations: int = 60,
          tolerance: float = 1e-13, lam: float = 1e-4) -> Solution:
    """Levenberg-Marquardt with exact steps until the relative decrease
    falls below ``tolerance`` twice, or no step is accepted at the largest
    damping (``reference.ba.solve``'s schedule)."""
    c = float(cost(prob, q, t, X, f))
    n = normal_equations(prob, q, t, X, f)
    stall = it = 0
    while it < max_iterations and stall < 2 and lam < 1e10:
        dc, df, dp = step(prob, n, lam)
        qn, tn, Xn = ba.apply_step(q, t, X, dc, dp)
        fn = f - float(df)
        cn = float(cost(prob, qn, tn, Xn, fn))
        if cn < c:
            stall = stall + 1 if (c - cn) / c < tolerance else 0
            q, t, X, f, c = qn, tn, Xn, fn, cn
            n = normal_equations(prob, q, t, X, f)
            lam = max(lam / 3.0, 1e-12)
        else:
            lam *= 4.0
            if (c - cn) / c > -tolerance:
                stall += 1
        it += 1
    return Solution(q, t, X, f, c, it)
