"""Plain reference of the mapper's local bundle adjustment, in float64
PyTorch: ``reference.ba`` with frozen points and a robust loss.

Imports nothing of the program.  A local BA holds some cameras fixed (the
images outside the local bundle that observe its points, and the gauge):
their dof mask is zero, as in ``reference.ba``.  It also holds fixed every
point outside the ones the last registration changed: here ``point_mask``
is zero, their Jacobian is zero, so they neither move nor enter the
reduced system (their observations still count in the cost).  The loss is
soft-L1 of scale s on each squared pixel residual z = f^2 s_o^2,
rho(z) = 2 s^2 (sqrt(1 + z / s^2) - 1), and the cost 1/2 sum rho(z); with
``loss_scale`` 0 it is the trivial loss of ``reference.ba``.

The normal equations are the port's iteratively reweighted ones: each
observation's Jacobians and residual are scaled by sqrt(rho'(z)), with
rho'(z) = (1 + z / s^2)^(-1/2), and ``reference.ba``'s blocks, reduced
system and exact step are formed from them (no second-order term of the
loss, as in the port).  ``solve`` runs ``reference.ba.solve``'s LM
schedule to convergence on this cost.  Departures from the port's solver
(``optim/ba_soa``): the exact reduced solve (dense Cholesky) where the
port runs 30 PCG steps, analytic Jacobians, and LM to convergence where
the port stops at its gradient tolerance (10) or 25 iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import ba
from benchmark.reference.ba import tf


class Problem(NamedTuple):
    base: ba.Problem          # observations, lines, camera, dof mask
    point_mask: torch.Tensor  # (P,) 0 = frozen point
    loss_scale: float         # soft-L1 scale in pixels; 0 = trivial loss


def to_problem(cam, pt, lines, params, dof_mask, point_mask, num_cams,
               num_points, loss_scale, dtype=torch.float64) -> Problem:
    return Problem(ba.to_problem(cam, pt, lines, params, dof_mask, num_cams,
                                 num_points, dtype),
                   point_mask.to(dtype), float(loss_scale))


def cost(prob: Problem, q, t, X) -> torch.Tensor:
    if prob.loss_scale == 0:
        return ba.cost(prob.base, q, t, X)
    f = prob.base.params[0]
    s = ba.line_distances(prob.base, q, t, X)
    b = prob.loss_scale ** 2
    return torch.sum(b * (torch.sqrt(1.0 + f * f * s * s / b) - 1.0))


def normal_equations(prob: Problem, q, t, X) -> ba.Normal:
    """``reference.ba``'s normal equations of the reweighted Jacobians and
    residuals, with the frozen points' Jacobians zero."""
    b = prob.base
    n = ba.normal_equations(b, q, t, X)
    if prob.loss_scale == 0:
        sw = torch.ones_like(n.r)
    else:
        sw = (1.0 + n.r * n.r / prob.loss_scale ** 2) ** -0.25
    Jc = tf(n.Jc * sw[:, None])
    Jp = tf(n.Jp * (sw * prob.point_mask[b.pt])[:, None])
    r = tf(n.r * sw)
    Hcc = torch.zeros_like(n.Hcc).index_add_(
        0, b.cam, Jc[:, :, None] * Jc[:, None, :])
    gc = torch.zeros_like(n.gc).index_add_(0, b.cam, Jc * r[:, None])
    Hpp = torch.zeros_like(n.Hpp).index_add_(
        0, b.pt, Jp[:, :, None] * Jp[:, None, :])
    gp = torch.zeros_like(n.gp).index_add_(0, b.pt, Jp * r[:, None])
    return ba.Normal(Hcc, gc, Hpp, gp, Jc, Jp, r)


def solve(prob: Problem, q, t, X, max_iterations: int = 60,
          tolerance: float = 1e-13, lam: float = 1e-4) -> ba.Solution:
    """``reference.ba.solve``'s LM on this cost and these normal
    equations; the frozen points' steps are exactly zero."""
    c = float(cost(prob, q, t, X))
    n = normal_equations(prob, q, t, X)
    stall = it = 0
    while it < max_iterations and stall < 2 and lam < 1e10:
        dc, dp = ba.step(prob.base, n, lam)
        qn, tn, Xn = ba.apply_step(q, t, X, dc, dp)
        cn = float(cost(prob, qn, tn, Xn))
        if cn < c:
            stall = stall + 1 if (c - cn) / c < tolerance else 0
            q, t, X, c = qn, tn, Xn, cn
            n = normal_equations(prob, q, t, X)
            lam = max(lam / 3.0, 1e-12)
        else:
            lam *= 4.0
            if (c - cn) / c > -tolerance:
                stall += 1
        it += 1
    return ba.Solution(q, t, X, c, it)
