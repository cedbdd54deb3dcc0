"""Point-to-line bundle adjustment: problem layout, options, flat solver.

Port of ``privacy_preserving_sfm_tpu/optim/ba.py``: the containers and
helpers every solver shares, the LM loop of the flat and dense-block
solvers, and the flat implicit-Schur solver ``bundle_adjust``
(reference ``:229-437``), which the mapper runs on the CPU; its body,
``implicit_schur_lm``, also runs each rank of the point-sharded solver
(``parallel/distributed_ba.py``).

Problem layout:

  cameras  C:  qvecs (C, 4), tvecs (C, 3), camera params (C, Pr) [constant],
               dof mask (C, 6) — 3 rotation-tangent + 3 translation dofs;
               gauge fixing = zeroed mask entries.
  points   P:  points3d (P, 3), point mask (P,) (variable vs constant).
  obs      O:  camera index, point index, line (O, 3), weight (O,).

The solvers reduce per-observation blocks into the C camera (and, here,
the P point) bins with ``_bins`` (the reference's ``segment_sum`` and
one-hot contractions).  It adds each bin's rows in ascending source
position, the order of ``index_add_`` on the CPU, through a ``BinPlan``
that each solve builds once (``bin_plan``: the bin ids do not change
within a solve).  So a float32 solve on the card gives one result, and one
LM iteration count, in every run: ``index_add_`` on CUDA adds with
atomics, in an order that changes from run to run.  The flat and dense
solvers read their options as given, as their references do (``ba_soa``
rounds its options through float32, as its reference does).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap
from torch.profiler import record_function

from privacy_preserving_sfm_torch.ops import lie, linalg, lines as line_ops


class BAProblem(NamedTuple):
    qvecs: torch.Tensor  # (C, 4)
    tvecs: torch.Tensor  # (C, 3)
    cam_params: torch.Tensor  # (C, Pr) intrinsics, constant
    points3d: torch.Tensor  # (P, 3)
    obs_cam: torch.Tensor  # (O,) int64
    obs_point: torch.Tensor  # (O,) int64
    obs_line: torch.Tensor  # (O, 3) normalized lines
    obs_weight: torch.Tensor  # (O,) float, 0 = padding
    cam_dof_mask: torch.Tensor  # (C, 6) float, 0 = frozen dof
    point_mask: torch.Tensor  # (P,) float, 0 = constant point


class BAOptions(NamedTuple):
    max_iterations: int = 50  # ba_global_max_num_iterations default
    loss: str = "trivial"  # trivial | soft_l1 | cauchy
    loss_scale: float = 1.0
    cg_iterations: int = 30
    initial_lambda: float = 1e-4
    min_lambda: float = 1e-10
    max_lambda: float = 1e10
    function_tolerance: float = 1e-8
    # Ceres-style termination on the max-abs gradient entry; 0 disables.
    gradient_tolerance: float = 0.0
    # Give up after this many consecutive rejected steps (each grows
    # lambda 4x: the solve is at a numerical local minimum).
    max_consecutive_rejections: int = 8
    # Dense-block solver only: "explicit" materializes the reduced camera
    # system and solves it with the PCG kernel, "implicit" runs the
    # matrix-free CG, "auto" picks explicit on CUDA when C <= 1024
    # (``ba_dense.uses_explicit``).
    schur_mode: str = "auto"
    # Explicit Schur only: "bf16" rounds the Schur Gram's operands to
    # bfloat16 (sums stay in the problem's precision); "f32" keeps them.
    schur_precision: str = "f32"
    # Intrinsics refinement (reference BundleAdjustmentOptions.refine_*):
    # the mapper then solves with ``ba_intrinsics``.
    refine_focal_length: bool = False
    refine_principal_point: bool = False
    refine_extra_params: bool = False


def _f32(x: float) -> float:
    return float(np.float32(x))


class DynamicBAOptions(NamedTuple):
    """The per-solve knobs of one LM run as plain Python scalars.

    The reference carries them as float32 device scalars (its one compiled
    kernel serves every option set); ``from_options`` rounds them through
    float32 the same way, which keeps the two solvers' LM trajectories
    identical.
    """

    loss: str
    loss_scale: float
    gradient_tolerance: float  # <= 0 disables
    function_tolerance: float
    initial_lambda: float
    max_iterations: int

    @staticmethod
    def from_options(options: BAOptions) -> "DynamicBAOptions":
        if options.loss not in ("trivial", "soft_l1", "cauchy"):
            raise ValueError(f"unknown loss {options.loss}")
        return DynamicBAOptions(
            loss=options.loss,
            loss_scale=_f32(options.loss_scale),
            gradient_tolerance=_f32(options.gradient_tolerance),
            function_tolerance=_f32(options.function_tolerance),
            initial_lambda=_f32(options.initial_lambda),
            max_iterations=int(options.max_iterations))


class BASummary(NamedTuple):
    initial_cost: float
    final_cost: float
    num_iterations: int
    lam: float


def _robust_weight(sq_norm: torch.Tensor, loss: str,
                   scale: float) -> torch.Tensor:
    """IRLS weight rho'(s) for squared residual norm s."""
    if loss == "trivial":
        return torch.ones_like(sq_norm)
    s = sq_norm / (scale * scale)
    if loss == "soft_l1":
        return 1.0 / torch.sqrt(1.0 + s)
    if loss == "cauchy":
        return 1.0 / (1.0 + s)
    raise ValueError(f"unknown loss {loss}")


def _robust_cost(sq_norm: torch.Tensor, loss: str,
                 scale: float) -> torch.Tensor:
    """rho(s): the robustified cost of a squared residual norm."""
    if loss == "trivial":
        return sq_norm
    b = scale * scale
    s = sq_norm / b
    if loss == "soft_l1":
        return 2.0 * b * (torch.sqrt(1.0 + s) - 1.0)
    if loss == "cauchy":
        return b * torch.log1p(s)
    raise ValueError(f"unknown loss {loss}")


def _quat_delta(dq: torch.Tensor) -> torch.Tensor:
    """Smooth quaternion increment (1, dq/2)/sqrt(1+|dq/2|^2), batched."""
    half = dq / 2.0
    w = torch.ones(dq.shape[:-1] + (1,), dtype=dq.dtype, device=dq.device)
    q = torch.cat([w, half], dim=-1)
    return q / torch.sqrt(1.0 + torch.sum(half * half, dim=-1, keepdim=True))


def _apply_step(qvecs, tvecs, points, dc, dp):
    """Apply camera tangent steps (C, 6) and point steps (P, 3)."""
    q_new = lie.quat_normalize(
        lie.quat_multiply(qvecs, _quat_delta(dc[:, :3])))
    return q_new, tvecs + dc[:, 3:], points + dp


def _inv6(A: torch.Tensor) -> torch.Tensor:
    """Blockwise 6x6 inverse via 3x3 Schur complement (closed forms only)."""
    A11 = A[..., :3, :3]
    A12 = A[..., :3, 3:]
    A21 = A[..., 3:, :3]
    A22 = A[..., 3:, 3:]
    A11i = linalg.inv3(A11)
    S = A22 - A21 @ A11i @ A12
    Si = linalg.inv3(S)
    B11 = A11i + A11i @ A12 @ Si @ A21 @ A11i
    B12 = -(A11i @ A12 @ Si)
    B21 = -(Si @ A21 @ A11i)
    top = torch.cat([B11, B12], dim=-1)
    bot = torch.cat([B21, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _sym(A: torch.Tensor) -> torch.Tensor:
    """Mean of A and its transpose: exact for bins from ``_bins``, which
    sums both triangles of symmetric blocks in one order."""
    return 0.5 * (A + A.transpose(-1, -2))


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _check_loss(loss: str):
    if loss not in ("trivial", "soft_l1", "cauchy"):
        raise ValueError(f"unknown loss {loss}")


# ---------------------------------------------------------------------------
# Residuals and Jacobians (all solvers)
# ---------------------------------------------------------------------------


def _residual(dc, dX, q, t, X, par, line, camera_model):
    """Residual (2,) of one observation at the tangent step (dc, dX)."""
    qq = lie.quat_multiply(q, _quat_delta(dc[:3]))
    tt = t + dc[3:]
    return line_ops.line_ba_residual(line, X + dX, qq, tt, camera_model, par)


def _residual_and_jacobians(q, t, X, par, line, camera_model):
    """r (2,), J_camera (2, 6), J_point (2, 3) of one observation."""
    def f(dc, dX):
        r = _residual(dc, dX, q, t, X, par, line, camera_model)
        return r, r

    (Jc, Jp), r = jacfwd(f, argnums=(0, 1), has_aux=True)(
        q.new_zeros(6), q.new_zeros(3))
    return r, Jc, Jp


def residuals_and_jacobians(q_o, t_o, X_o, par_o, line_o, camera_model):
    """Batched over observations: r (N, 2), Jc (N, 2, 6), Jp (N, 2, 3).
    ``torch.profiler`` sees the span ``ba.jacobians`` around the pass."""
    fn = functools.partial(_residual_and_jacobians,
                           camera_model=camera_model)
    with record_function("ba.jacobians"):
        return vmap(fn)(q_o, t_o, X_o, par_o, line_o)


# ---------------------------------------------------------------------------
# LM loop and block-Jacobi CG (flat and dense-block solvers)
# ---------------------------------------------------------------------------


def block_jacobi_cg(matvec, SJ_inv: torch.Tensor, rhs: torch.Tensor,
                    iters: int) -> torch.Tensor:
    """``iters`` steps of CG on S x = rhs (C, 6), preconditioned by the
    inverse diagonal blocks SJ_inv (C, 6, 6); no host synchronisation."""
    def guard(v):
        return torch.where(v.abs() < 1e-30, v.new_full((), 1e-30), v)

    def precond(v):
        return torch.einsum("cij,cj->ci", SJ_inv, v)

    x = torch.zeros_like(rhs)
    r = rhs
    p = precond(rhs)
    rz = torch.sum(r * p)
    for _ in range(iters):
        Ap = matvec(p)
        alpha = rz / guard(torch.sum(p * Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / guard(rz)) * p
        rz = rz_new
    return x


def _identity(x):
    return x


def levenberg_marquardt(problem, options: BAOptions, cost_fn, build_normal,
                        solve_step, intrinsics=None, reduce_max=_identity):
    """The LM loop of the reference's ``ba.bundle_adjust``,
    ``ba_dense.bundle_adjust_dense`` (``ba.py:359-423``) and
    ``ba_intrinsics.bundle_adjust_intrinsics`` (``ba_intrinsics.py:
    296-361``).

    ``cost_fn(q, t, X)`` is the robust cost; ``build_normal(q, t, X)``
    returns the normal equations as a tuple ending in (gc (C, 6),
    gp (P, 3)); ``solve_step(normal, lam)`` returns the descent steps
    (dc (C, 6), dp (P, 3)).  With ``intrinsics`` = (intr (U, Pr), mask
    (U, Pr)) the shared camera intrinsics are a fourth block of variables:
    ``cost_fn`` and ``build_normal`` take them as a fourth argument, the
    normal equations end in (gc, gi (U, Pr), gp) and ``solve_step``
    returns (dc, du (U, Pr), dp).  The normal equations are rebuilt only
    after an accepted step (Ceres keeps the Jacobian across rejected
    ones).  The loop reads the accept flag on the host once per
    iteration.  ``reduce_max`` takes the largest gradient entry of this
    process's variables (a 0-d tensor) to that of the whole problem: the
    identity here, the max over the ranks of a point-sharded solve
    (``parallel/distributed_ba.py``), so that every rank stops at the same
    iteration.  Returns (qvecs, tvecs, points3d[, intrinsics],
    BASummary).
    """
    mask = problem.cam_dof_mask
    pmask = problem.point_mask[:, None]
    x = (problem.qvecs, problem.tvecs, problem.points3d)
    if intrinsics is not None:
        x = x + (intrinsics[0],)
        imask = intrinsics[1]
    cost0 = cost_fn(*x)
    c = cost0
    lam = float(options.initial_lambda)
    it = stall = rej = 0
    rebuild = True
    normal = None
    while (it < options.max_iterations and stall < 2
           and lam < options.max_lambda * 0.99):
        if rebuild:
            normal = build_normal(*x)
        grad_done = False
        if options.gradient_tolerance > 0:
            gc, gp = normal[-2:] if intrinsics is None else normal[-3::2]
            g_max = torch.maximum((gc * mask).abs().max(),
                                  (gp * pmask).abs().max())
            if intrinsics is not None:
                g_max = torch.maximum(g_max, (normal[-2] * imask).abs().max())
            grad_done = bool(reduce_max(g_max) <= options.gradient_tolerance)
        steps = solve_step(normal, lam)
        dc, dp = steps[0], steps[-1]
        x_new = _apply_step(x[0], x[1], x[2], -(dc * mask), -(dp * pmask))
        if intrinsics is not None:
            x_new = x_new + (x[3] - steps[1] * imask,)
        c_new = cost_fn(*x_new)
        accept = bool(c_new < c)
        rel = float((c - c_new) / torch.clamp_min(c, 1e-30))
        if accept:
            x, c = x_new, c_new
            lam = max(lam / 3.0, options.min_lambda)
        else:
            lam = min(lam * 4.0, options.max_lambda)
        if accept and rel < options.function_tolerance:
            stall += 1
        elif accept:
            stall = 0
        if grad_done:
            stall = 2
        rej = 0 if accept else rej + 1
        if rej >= options.max_consecutive_rejections:
            stall = 2
        rebuild = accept
        it += 1
    summary = BASummary(initial_cost=float(cost0), final_cost=float(c),
                        num_iterations=it, lam=lam)
    return x + (summary,)


# ---------------------------------------------------------------------------
# Flat implicit-Schur solver
# ---------------------------------------------------------------------------


def _residuals_and_jacobians(problem: BAProblem, qvecs, tvecs, points,
                             camera_model: str):
    """Per-observation residual (O, 2), J_cam (O, 2, 6), J_pt (O, 2, 3)."""
    oc, op = problem.obs_cam, problem.obs_point
    r, Jc, Jp = residuals_and_jacobians(
        qvecs[oc], tvecs[oc], points[op], problem.cam_params[oc],
        problem.obs_line, camera_model)
    Jc = Jc * problem.cam_dof_mask[oc][:, None, :]  # freeze masked dofs
    Jp = Jp * problem.point_mask[op][:, None, None]
    return r, Jc, Jp


def _cost(problem: BAProblem, qvecs, tvecs, points, camera_model: str,
          loss: str, loss_scale: float) -> torch.Tensor:
    oc, op = problem.obs_cam, problem.obs_point
    r = line_ops.line_ba_residual(
        problem.obs_line, points[op], qvecs[oc], tvecs[oc], camera_model,
        problem.cam_params[oc])
    sq = torch.sum(r * r, dim=-1)
    return 0.5 * torch.sum(_robust_cost(sq, loss, loss_scale)
                           * problem.obs_weight)


class BinPlan(NamedTuple):
    """The order in which ``_bins`` sums rows into bins, built once per
    solve by ``bin_plan``."""
    order: torch.Tensor    # (N,) source positions, by bin, stable
    offsets: torch.Tensor  # (num_bins + 1,) each bin's range of order


def bin_plan(num_bins: int, index: torch.Tensor) -> BinPlan:
    """The plan of bin ids ``index`` (N,) in [0, num_bins), in torch ops on
    index's device, with no host synchronisation."""
    keys, order = torch.sort(index, stable=True)
    offsets = torch.searchsorted(keys, torch.arange(
        num_bins + 1, dtype=keys.dtype, device=keys.device))
    return BinPlan(order, offsets)


def _bins(plan: BinPlan, values: torch.Tensor) -> torch.Tensor:
    """Sum of ``values`` rows (N, ...) into the plan's bins.  Each bin adds
    its rows one after another in ascending source position, on every
    device and in every run: on the CPU, bit for bit what ``index_add_``
    gives (an empty bin is 0).  ``torch.profiler`` sees the span
    ``ba.bins`` around each sum."""
    with record_function("ba.bins"):
        return torch.segment_reduce(values.index_select(0, plan.order),
                                    "sum", offsets=plan.offsets, axis=0)


def damped(H: torch.Tensor, lam: float) -> torch.Tensor:
    """LM damping of (..., d, d) blocks: H + lam diag(H) + 1e-12 I."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + lam * torch.diag_embed(
        torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-12 * eye


def bundle_adjust(problem: BAProblem, camera_model: str,
                  options: BAOptions = BAOptions()):
    """Implicit-Schur LM on the flat problem; returns (qvecs, tvecs,
    points3d, BASummary).  ``torch.profiler`` sees the spans
    ``ba.build_normal`` and ``ba.solve_step``."""
    return implicit_schur_lm(problem, camera_model, options)


def implicit_schur_lm(problem: BAProblem, camera_model: str,
                      options: BAOptions, reduce_sum=_identity,
                      reduce_max=_identity):
    """``bundle_adjust`` on the points and observations of one rank of a
    point-sharded solve: ``reduce_sum`` sums the camera blocks, the
    camera-space CG terms and the cost over the ranks, ``reduce_max`` the
    gradient's max (``levenberg_marquardt``); point blocks stay local.
    With the identity for both, this is ``bundle_adjust``."""
    C = problem.qvecs.shape[0]
    P = problem.points3d.shape[0]
    oc, op = problem.obs_cam, problem.obs_point
    loss, scale = options.loss, options.loss_scale
    _check_loss(loss)
    eye6 = torch.eye(6, dtype=problem.points3d.dtype,
                     device=problem.points3d.device)
    cams, pts = bin_plan(C, oc), bin_plan(P, op)

    def cost_fn(q, t, X):
        return reduce_sum(_cost(problem, q, t, X, camera_model, loss, scale))

    @record_function("ba.build_normal")
    def build_normal(q, t, X):
        r, Jc, Jp = _residuals_and_jacobians(problem, q, t, X, camera_model)
        sq = torch.sum(r * r, dim=-1)
        w = _robust_weight(sq, loss, scale) * problem.obs_weight  # (O,)
        Hcc_o = torch.einsum("ori,orj,o->oij", Jc, Jc, w)
        Hpp_o = torch.einsum("ori,orj,o->oij", Jp, Jp, w)
        Hcp_o = torch.einsum("ori,orj,o->oij", Jc, Jp, w)  # (O, 6, 3)
        gc_o = torch.einsum("ori,or,o->oi", Jc, r, w)
        gp_o = torch.einsum("ori,or,o->oi", Jp, r, w)
        Hcc = _sym(reduce_sum(_bins(cams, Hcc_o)))
        return (Hcc, _sym(_bins(pts, Hpp_o)), Hcp_o,
                reduce_sum(_bins(cams, gc_o)), _bins(pts, gp_o))

    @record_function("ba.solve_step")
    def solve_step(normal, lam):
        Hcc, Hpp, Hcp_o, gc, gp = normal
        dHcc = damped(Hcc, lam)
        Hpp_inv = linalg.inv3(damped(Hpp, lam))  # (P, 3, 3)

        def S_matvec(v):  # v: (C, 6)
            Etv = _bins(pts, torch.einsum("oji,oj->oi", Hcp_o, v[oc]))
            y = torch.einsum("pij,pj->pi", Hpp_inv, Etv)
            Ey = _bins(cams, torch.einsum("oij,oj->oi", Hcp_o, y[op]))
            return torch.einsum("cij,cj->ci", dHcc, v) - reduce_sum(Ey)

        # RHS g_c - E Hpp^-1 g_p and the Schur-Jacobi preconditioner.
        y0 = torch.einsum("pij,pj->pi", Hpp_inv, gp)
        rhs = gc - reduce_sum(
            _bins(cams, torch.einsum("oij,oj->oi", Hcp_o, y0[op])))
        SJ_o = torch.einsum("oij,ojk,olk->oil", Hcp_o, Hpp_inv[op], Hcp_o)
        SJ_inv = _inv6(dHcc - reduce_sum(_bins(cams, SJ_o)) + 1e-12 * eye6)
        dc = _finite_or_zero(block_jacobi_cg(S_matvec, SJ_inv, rhs,
                                             options.cg_iterations))
        # Back-substitution: dp = Hpp^-1 (gp - E^T dc).
        Etdc = _bins(pts, torch.einsum("oji,oj->oi", Hcp_o, dc[oc]))
        dp = torch.einsum("pij,pj->pi", Hpp_inv, gp - Etdc)
        return dc, _finite_or_zero(dp)

    return levenberg_marquardt(problem, options, cost_fn, build_normal,
                               solve_step, reduce_max=reduce_max)
