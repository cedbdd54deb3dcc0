"""Plain reference of the line bundle adjustment, in float64 PyTorch.

Imports nothing of the program.  The problem: C cameras (unit quaternion
q, translation t, world -> camera), P points X, O observations, each a
normalized image line l = (a, b, c) with a^2 + b^2 = 1 seen by camera c_o
of point p_o, SIMPLE_PINHOLE (f, cx, cy).  With x = (x, y) the projection
of X in the normalized plane, s = a x + b y + c is its distance to the
line, and the pixel residual of the line BA (``cost_functions.h:62-100``:
projection minus its closest point on the line, both through the camera)
is f s (a, b); the cost is 1/2 sum f^2 s^2.  Each camera moves by a
tangent step (d_theta, d_t): q <- q (x) (1, d_theta / 2) / |.|,
t <- t + d_t; each point by d_X.  Gauge dofs are held by a (C, 6) mask.

``computed_in_tf32`` runs the same arithmetic on float32 inputs with
every product's operands rounded to TF32 (10 mantissa bits, to nearest)
and float32 sums, as a tensor core computes: the precision below the
float32 (TF32 off) that the BA configurations state, the control of the
benchmark's comparison.

``normal_equations`` forms, from analytic Jacobians, the camera blocks,
the point blocks and the reduced camera system after the points are
eliminated; ``solve`` runs Levenberg-Marquardt with the exact reduced
solve (dense Cholesky) to convergence.  Every sum runs over the
observations directly; the reduced system's pairs of observations of one
point are summed in chunks, so any size fits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import contextlib

import torch

PAIR_CHUNK = 1 << 22  # observation pairs a chunk of the reduced system
_TF32 = [False]


@contextlib.contextmanager
def computed_in_tf32():
    _TF32[0] = True
    try:
        yield
    finally:
        _TF32[0] = False


def tf(x: torch.Tensor) -> torch.Tensor:
    """A product's operand: rounded to TF32 inside ``computed_in_tf32``
    (float32 inputs), else as it is."""
    if not _TF32[0]:
        return x
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Problem(NamedTuple):
    cam: torch.Tensor     # (O,) int64
    pt: torch.Tensor      # (O,) int64
    lines: torch.Tensor   # (O, 3)
    params: tuple         # (f, cx, cy)
    dof_mask: torch.Tensor  # (C, 6)
    num_cams: int
    num_points: int


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    q, v = tf(q), tf(v)
    w, u = q[..., :1], q[..., 1:]
    uv = tf(torch.linalg.cross(u, v, dim=-1))
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def line_distances(prob: Problem, q, t, X) -> torch.Tensor:
    """s (O,): each projection's signed distance to its line."""
    xc = quat_rotate(q[prob.cam], X[prob.pt]) + t[prob.cam]
    x = tf(xc[:, 0] / xc[:, 2])
    y = tf(xc[:, 1] / xc[:, 2])
    l = tf(prob.lines)
    return l[:, 0] * x + l[:, 1] * y + l[:, 2]


def cost(prob: Problem, q, t, X) -> torch.Tensor:
    f = prob.params[0]
    s = line_distances(prob, q, t, X)
    return 0.5 * f * f * torch.sum(s * s)


def camera_centres(q, t) -> torch.Tensor:
    """-R^T t of each camera."""
    qc = q * q.new_tensor([1.0, -1.0, -1.0, -1.0])
    return -quat_rotate(qc, t)


class Normal(NamedTuple):
    Hcc: torch.Tensor   # (C, 6, 6)
    gc: torch.Tensor    # (C, 6)
    Hpp: torch.Tensor   # (P, 3, 3)
    gp: torch.Tensor    # (P, 3)
    Jc: torch.Tensor    # (O, 6)  f * ds/d(camera), masked
    Jp: torch.Tensor    # (O, 3)  f * ds/dX
    r: torch.Tensor     # (O,)    f * s


def normal_equations(prob: Problem, q, t, X) -> Normal:
    """Gauss-Newton normal equations.  The residual f s (a, b) has unit
    direction (a, b), so J^T J and J^T r are those of the scalar f s."""
    f = prob.params[0]
    Xp = X[prob.pt]
    qo = q[prob.cam]
    RX = quat_rotate(qo, Xp)
    xc = RX + t[prob.cam]
    iz = tf(1.0 / xc[:, 2])
    x, y = tf(xc[:, 0] * iz), tf(xc[:, 1] * iz)
    a, b, c = tf(prob.lines).unbind(1)
    s = a * x + b * y + c
    # ds/dxc, then d xc / d(theta, t, X) = (-R [X]x, I, R).
    dxc = torch.stack([a * iz, b * iz, -(a * x + b * y) * iz], 1)  # (O, 3)
    # xc = R (X + theta x X) + t to first order: ds/dtheta = X x R^T dxc
    # = R^T ((R X) x dxc), ds/dX = R^T dxc.
    qinv = qo * qo.new_tensor([1.0, -1.0, -1.0, -1.0])
    d_rot = quat_rotate(qinv, torch.linalg.cross(RX, dxc, dim=1))
    d_pt = quat_rotate(qinv, dxc)
    Jc = tf(f * torch.cat([d_rot, dxc], 1) * prob.dof_mask[prob.cam])
    Jp = tf(f * d_pt)
    r = tf(f * s)
    C, P = prob.num_cams, prob.num_points
    Hcc = torch.zeros(C, 6, 6, dtype=X.dtype, device=X.device)
    Hcc.index_add_(0, prob.cam, Jc[:, :, None] * Jc[:, None, :])
    gc = torch.zeros(C, 6, dtype=X.dtype, device=X.device)
    gc.index_add_(0, prob.cam, Jc * r[:, None])
    Hpp = torch.zeros(P, 3, 3, dtype=X.dtype, device=X.device)
    Hpp.index_add_(0, prob.pt, Jp[:, :, None] * Jp[:, None, :])
    gp = torch.zeros(P, 3, dtype=X.dtype, device=X.device)
    gp.index_add_(0, prob.pt, Jp * r[:, None])
    return Normal(Hcc, gc, Hpp, gp, Jc, Jp, r)


def _pairs(prob: Problem):
    """Chunks (o1, o2) of every ordered pair of observations of one point
    (each observation with itself included)."""
    order = torch.argsort(prob.pt, stable=True)
    counts = torch.bincount(prob.pt, minlength=prob.num_points)
    offsets = torch.cumsum(counts, 0) - counts
    sq = counts * counts
    ends = torch.cumsum(sq, 0)
    total = int(ends[-1]) if len(ends) else 0
    start = 0
    while start < total:
        stop = min(total, start + PAIR_CHUNK)
        k = torch.arange(start, stop, device=prob.pt.device)
        p = torch.searchsorted(ends, k, right=True)
        within = k - (ends[p] - sq[p])
        m = counts[p]
        o1 = order[offsets[p] + within // m]
        o2 = order[offsets[p] + within % m]
        yield o1, o2
        start = stop


def damped_point_inverse(Hpp: torch.Tensor, lam: float) -> torch.Tensor:
    """(Hpp + lam diag(Hpp) + 1e-12 I)^-1 of each point."""
    D = torch.diag_embed(torch.diagonal(Hpp, dim1=-2, dim2=-1))
    eye = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    return torch.linalg.inv(Hpp + lam * D + 1e-12 * eye)


def reduced_correction(prob: Problem, n: Normal, Hpp_inv: torch.Tensor):
    """S_corr = sum_p Hcp_p Hpp_p^-1 Hcp_p^T as a dense (6C, 6C) matrix in
    the 6c + i layout, and rhs_corr = sum_p Hcp_p Hpp_p^-1 gp_p (6C,)."""
    C = prob.num_cams
    dev, dt = n.Jc.device, n.Jc.dtype
    u = tf(torch.einsum("oij,oj->oi", tf(Hpp_inv)[prob.pt], n.Jp))
    S4 = torch.zeros(C * C, 36, dtype=dt, device=dev)
    for o1, o2 in _pairs(prob):
        w = tf(torch.sum(n.Jp[o1] * u[o2], 1))
        blocks = (n.Jc[o1][:, :, None] * n.Jc[o2][:, None, :]) * w[:, None,
                                                                     None]
        S4.index_add_(0, prob.cam[o1] * C + prob.cam[o2],
                      blocks.reshape(-1, 36))
    S = S4.reshape(C, C, 6, 6).permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    v = tf(torch.sum(u * tf(n.gp)[prob.pt], 1))  # Jp^T Hinv gp
    rhs = torch.zeros(C, 6, dtype=dt, device=dev)
    rhs.index_add_(0, prob.cam, n.Jc * v[:, None])
    return S, rhs.reshape(-1)


def damped_cameras(Hcc: torch.Tensor, lam: float) -> torch.Tensor:
    D = torch.diag_embed(torch.diagonal(Hcc, dim1=-2, dim2=-1))
    eye = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    return Hcc + lam * D + 1e-12 * eye


def reduced_system(prob: Problem, n: Normal, lam: float):
    """S (6C, 6C) and rhs (6C,) of the damped reduced camera system, with
    Hpp_inv; gauge dofs get a unit diagonal and a zero right-hand side."""
    C = prob.num_cams
    Hpp_inv = damped_point_inverse(n.Hpp, lam)
    S_corr, rhs_corr = reduced_correction(prob, n, Hpp_inv)
    S = -S_corr
    blocks = damped_cameras(n.Hcc, lam)
    idx = torch.arange(C, device=S.device)
    S4 = S.view(C, 6, C, 6)
    S4[idx, :, idx, :] += blocks
    rhs = n.gc.reshape(-1) - rhs_corr
    frozen = prob.dof_mask.reshape(-1) == 0
    S[frozen, :] = 0.0
    S[:, frozen] = 0.0
    S[frozen, frozen] = 1.0
    rhs = torch.where(frozen, torch.zeros_like(rhs), rhs)
    return S, rhs, Hpp_inv


def step(prob: Problem, n: Normal, lam: float):
    """The exact damped Gauss-Newton step (dc (C, 6), dp (P, 3)) to be
    subtracted."""
    S, rhs, Hpp_inv = reduced_system(prob, n, lam)
    L, info = torch.linalg.cholesky_ex(S)
    if int(info) == 0:
        dc = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    else:  # not positive definite in rounding (the TF32 control): LU
        dc = torch.linalg.solve(S, rhs)
    dc = dc.reshape(-1, 6)
    # dp = Hpp^-1 (gp - Hcp^T dc)
    e = torch.zeros_like(n.gp)
    e.index_add_(0, prob.pt, n.Jp * tf(torch.sum(
        n.Jc * tf(dc)[prob.cam], 1))[:, None])
    dp = torch.einsum("pij,pj->pi", tf(Hpp_inv), tf(n.gp - e))
    return dc, dp


def apply_step(q, t, X, dc, dp):
    half = -dc[:, :3] / 2.0
    dq = torch.cat([torch.ones_like(half[:, :1]), half], 1)
    dq = dq / torch.linalg.vector_norm(dq, dim=1, keepdim=True)
    q = quat_mul(q, dq)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    return q, t - dc[:, 3:], X - dp


class Solution(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    cost: float
    iterations: int


def solve(prob: Problem, q, t, X, max_iterations: int = 60,
          tolerance: float = 1e-13, lam: float = 1e-4) -> Solution:
    """Levenberg-Marquardt with exact steps until the relative decrease
    falls below ``tolerance`` twice, or no step is accepted at the largest
    damping."""
    c = float(cost(prob, q, t, X))
    n = normal_equations(prob, q, t, X)
    stall = it = 0
    while it < max_iterations and stall < 2 and lam < 1e10:
        dc, dp = step(prob, n, lam)
        qn, tn, Xn = apply_step(q, t, X, dc, dp)
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
    return Solution(q, t, X, c, it)


def model_value(S: torch.Tensor, rhs: torch.Tensor, d: torch.Tensor
                ) -> torch.Tensor:
    """1/2 d^T S d - d^T rhs, the reduced system's quadratic model, whose
    least value -1/2 rhs^T S^-1 rhs its exact solution takes."""
    return 0.5 * d @ (S @ d) - d @ rhs


def to_problem(cam, pt, lines, params, dof_mask, num_cams, num_points,
               dtype: Optional[torch.dtype] = torch.float64) -> Problem:
    return Problem(cam, pt, lines.to(dtype), tuple(float(p) for p in params),
                   dof_mask.to(dtype), num_cams, num_points)
