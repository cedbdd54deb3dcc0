"""Bundle adjustment with variable intrinsics (focal / principal / extra).

Port of ``privacy_preserving_sfm_tpu/optim/ba_intrinsics.py`` (the
reference's camera-subset parametrization,
``src/optim/bundle_adjustment.cc:490-528``): when any of
``refine_focal_length`` / ``refine_principal_point`` /
``refine_extra_params`` is set, the shared camera parameter vectors join
the camera side of the reduced system.

The privacy lift bakes the calibration into the stored lines, so a focal
or principal-point change is applied as the affinity of the normalized
plane under which lifted lines transform projectively,

    l' ~ (a fx'/f0x,  b fy'/f0y,  c - a (cx0 - cx')/f0x - b (cy0 - cy')/f0y),

and the residual is differentiated through the corrected line while the
error metric uses the updated parameters.  Distortion parameters are not
an affinity of the normalized plane: ``refine_extra`` only moves the
metric.  On convergence the caller bakes the correction into the stored
lines (``correct_lines``).

Intrinsics live per unique camera (U of them; image slots share them
through ``cam_of_slot``).  The camera side of the Schur system is the pair
(vc (C, 6) pose tangents, vu (U, Pr) intrinsics tangents), solved by the
implicit-Schur CG with the pose-intrinsics and intrinsics-point coupling
blocks and a block-Jacobi preconditioner on both block types.  Every
``segment_sum`` of the reference is ``ba._bins`` over one of three plans
built once per solve (observations by camera slot, by point, by unique
camera), so a float32 solve on the card gives one result in every run.
No hand kernel: the reference is XLA.  ``torch.profiler`` sees the spans
``ba_intr.build_normal`` and ``ba_intr.solve_step``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap
from torch.profiler import record_function

from privacy_preserving_sfm_torch.ops import cameras as cam_ops
from privacy_preserving_sfm_torch.ops import lie, linalg, lines as line_ops
from privacy_preserving_sfm_torch.optim import ba as ba_mod


class IntrBAProblem(NamedTuple):
    base: ba_mod.BAProblem  # its cam_params are not read (intr_params are)
    cam_of_slot: torch.Tensor  # (C,) int64 image slot -> unique camera
    intr_params: torch.Tensor  # (U, Pr) starting point
    intr_mask: torch.Tensor  # (U, Pr) float, 0 = frozen parameter
    lift_params: torch.Tensor  # (U, Pr) intrinsics the lines were lifted with


def corrected_line(line, lift_par, par, model: str, xp=torch):
    """The lifted line (..., 3), ||(a, b)|| = 1, lifted under ``lift_par``,
    moved to the normalized plane of ``par`` and renormalized (only focal
    and principal changes are representable).  ``xp`` is torch or
    numpy."""
    spec = cam_ops.MODELS[model]
    f0x, f0y, c0x, c0y, _ = cam_ops._split_params(spec, lift_par, xp)
    fx, fy, cx, cy, _ = cam_ops._split_params(spec, par, xp)
    a, b, c = line[..., 0], line[..., 1], line[..., 2]
    a2 = a * fx / f0x
    b2 = b * fy / f0y
    c2 = c - a * (c0x - cx) / f0x - b * (c0y - cy) / f0y
    norm = xp.clip(xp.sqrt(a2 * a2 + b2 * b2), 1e-12, None)
    return xp.stack([a2 / norm, b2 / norm, c2 / norm], axis=-1)


def correct_lines(lines: np.ndarray, lift_par: np.ndarray, par: np.ndarray,
                  model: str) -> np.ndarray:
    """Bake a converged intrinsics correction into stored lines (host)."""
    return np.asarray(corrected_line(np.asarray(lines), np.asarray(lift_par),
                                     np.asarray(par), model, xp=np))


def intr_mask_for_model(model: str, refine_focal: bool, refine_principal: bool,
                        refine_extra: bool) -> np.ndarray:
    """(Pr,) 0/1 mask of the variable parameters of one camera
    (``BundleAdjuster::ParameterizeCameras``'s subsets)."""
    spec = cam_ops.MODELS[model]
    mask = np.zeros(spec.num_params)
    if refine_focal:
        mask[list(spec.focal_idxs)] = 1.0
    if refine_principal:
        mask[list(spec.principal_idxs)] = 1.0
    if refine_extra:
        mask[list(spec.extra_idxs)] = 1.0
    return mask


def _inv_small(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Inverse of (..., n, n) blocks for a small n: ``linalg.solve_gauss``
    against each column of the identity."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Ad = (A + eps * eye).expand((n,) + A.shape)
    cols = eye[:, None, :].expand((n,) + A.shape[:-1])  # column j = e_j
    return linalg.solve_gauss(Ad, cols).movedim(0, -1)


def _residual(dc, dX, dpar, q, t, X, par, par0, line, camera_model):
    qq = lie.quat_multiply(q, ba_mod._quat_delta(dc[:3]))
    pnew = par + dpar
    lcorr = corrected_line(line, par0, pnew, camera_model)
    return line_ops.line_ba_residual(lcorr, X + dX, qq, t + dc[3:],
                                     camera_model, pnew)


def _one(q, t, X, par, par0, line, camera_model):
    def f(dc, dX, dpar):
        r = _residual(dc, dX, dpar, q, t, X, par, par0, line, camera_model)
        return r, r

    (Jc, Jp, Ji), r = jacfwd(f, argnums=(0, 1, 2), has_aux=True)(
        q.new_zeros(6), q.new_zeros(3), torch.zeros_like(par))
    return r, Jc, Jp, Ji


def _residuals_and_jacobians(problem: IntrBAProblem, qvecs, tvecs, points,
                             intr, camera_model: str):
    """r (O, 2), J_cam (O, 2, 6), J_pt (O, 2, 3), J_intr (O, 2, Pr), the
    last differentiated through ``corrected_line``."""
    base = problem.base
    oc, op = base.obs_cam, base.obs_point
    ou = problem.cam_of_slot[oc]
    fn = functools.partial(_one, camera_model=camera_model)
    r, Jc, Jp, Ji = vmap(fn)(qvecs[oc], tvecs[oc], points[op], intr[ou],
                             problem.lift_params[ou], base.obs_line)
    Jc = Jc * base.cam_dof_mask[oc][:, None, :]
    Jp = Jp * base.point_mask[op][:, None, None]
    Ji = Ji * problem.intr_mask[ou][:, None, :]
    return r, Jc, Jp, Ji


def _cost(problem: IntrBAProblem, qvecs, tvecs, points, intr,
          camera_model: str, loss: str, loss_scale: float) -> torch.Tensor:
    base = problem.base
    oc, op = base.obs_cam, base.obs_point
    ou = problem.cam_of_slot[oc]
    lcorr = corrected_line(base.obs_line, problem.lift_params[ou], intr[ou],
                           camera_model)
    r = line_ops.line_ba_residual(lcorr, points[op], qvecs[oc], tvecs[oc],
                                  camera_model, intr[ou])
    sq = torch.sum(r * r, dim=-1)
    return 0.5 * torch.sum(ba_mod._robust_cost(sq, loss, loss_scale)
                           * base.obs_weight)


def bundle_adjust_intrinsics(problem: IntrBAProblem, camera_model: str,
                             options: ba_mod.BAOptions = ba_mod.BAOptions()):
    """LM with variable intrinsics; returns (q, t, X, intr, BASummary)."""
    base = problem.base
    C = base.qvecs.shape[0]
    P = base.points3d.shape[0]
    U, Pr = problem.intr_params.shape
    loss, scale = options.loss, options.loss_scale
    ba_mod._check_loss(loss)
    dtype, dev = base.points3d.dtype, base.points3d.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eyep = torch.eye(Pr, dtype=dtype, device=dev)
    oc, op = base.obs_cam, base.obs_point
    ou = problem.cam_of_slot[oc]
    cams, pts, units = (ba_mod.bin_plan(C, oc), ba_mod.bin_plan(P, op),
                        ba_mod.bin_plan(U, ou))
    bins, sym = ba_mod._bins, ba_mod._sym

    def cost_fn(q, t, X, intr):
        return _cost(problem, q, t, X, intr, camera_model, loss, scale)

    @record_function("ba_intr.build_normal")
    def build_normal(q, t, X, intr):
        r, Jc, Jp, Ji = _residuals_and_jacobians(problem, q, t, X, intr,
                                                 camera_model)
        sq = torch.sum(r * r, dim=-1)
        w = ba_mod._robust_weight(sq, loss, scale) * base.obs_weight

        def outer(A, B):
            return torch.einsum("ori,orj,o->oij", A, B, w)

        def grad(A):
            return torch.einsum("ori,or,o->oi", A, r, w)

        return (sym(bins(cams, outer(Jc, Jc))), sym(bins(units, outer(Ji, Ji))),
                sym(bins(pts, outer(Jp, Jp))), outer(Jc, Ji), outer(Jc, Jp),
                outer(Ji, Jp), bins(cams, grad(Jc)), bins(units, grad(Ji)),
                bins(pts, grad(Jp)))

    @record_function("ba_intr.solve_step")
    def solve_step(normal, lam):
        Hcc, Hii, Hpp, Hci_o, Hcp_o, Hip_o, gc, gi, gp = normal
        dHcc = ba_mod.damped(Hcc, lam)
        dHii = ba_mod.damped(Hii, lam)
        Hpp_inv = linalg.inv3(ba_mod.damped(Hpp, lam))

        def mv(A, v):  # (N, i, j) x (N, j) -> (N, i)
            return torch.einsum("nij,nj->ni", A, v)

        def mvt(A, v):  # (N, j, i) x (N, j) -> (N, i)
            return torch.einsum("nji,nj->ni", A, v)

        def S_matvec(vc, vu):
            # The camera side's own blocks and their pose-intrinsics
            # coupling.
            Bc = mv(dHcc, vc) + bins(cams, mv(Hci_o, vu[ou]))
            Bu = mv(dHii, vu) + bins(units, mvt(Hci_o, vc[oc]))
            # Point elimination: E^T v, y = Hpp^-1 E^T v, E y.
            y = mv(Hpp_inv, bins(pts, mvt(Hcp_o, vc[oc])
                                 + mvt(Hip_o, vu[ou])))
            return (Bc - bins(cams, mv(Hcp_o, y[op])),
                    Bu - bins(units, mv(Hip_o, y[op])))

        y0 = mv(Hpp_inv, gp)
        rhs = (gc - bins(cams, mv(Hcp_o, y0[op])),
               gi - bins(units, mv(Hip_o, y0[op])))

        def schur_diag(H, E_o, plan):
            return H - bins(plan, torch.einsum("oij,ojk,olk->oil", E_o,
                                               Hpp_inv[op], E_o))

        SJc_inv = ba_mod._inv6(schur_diag(dHcc, Hcp_o, cams) + 1e-12 * eye6)
        SJu_inv = _inv_small(schur_diag(dHii, Hip_o, units) + 1e-12 * eyep)

        def precond(v):
            return mv(SJc_inv, v[0]), mv(SJu_inv, v[1])

        def dot(a, b):
            return torch.sum(a[0] * b[0]) + torch.sum(a[1] * b[1])

        def guard(v):
            return torch.where(v.abs() < 1e-30, v.new_full((), 1e-30), v)

        x = (torch.zeros_like(rhs[0]), torch.zeros_like(rhs[1]))
        rr = rhs
        p = precond(rhs)
        rz = dot(rhs, p)
        for _ in range(options.cg_iterations):
            Ap = S_matvec(*p)
            alpha = rz / guard(dot(p, Ap))
            x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
            rr = (rr[0] - alpha * Ap[0], rr[1] - alpha * Ap[1])
            z = precond(rr)
            rz_new = dot(rr, z)
            beta = rz_new / guard(rz)
            p = (z[0] + beta * p[0], z[1] + beta * p[1])
            rz = rz_new
        dc, du = (ba_mod._finite_or_zero(v) for v in x)
        # Back-substitution: dp = Hpp^-1 (gp - E^T (dc, du)).
        Etd = bins(pts, mvt(Hcp_o, dc[oc]) + mvt(Hip_o, du[ou]))
        dp = mv(Hpp_inv, gp - Etd)
        return dc, du, ba_mod._finite_or_zero(dp)

    return ba_mod.levenberg_marquardt(
        base, options, cost_fn, build_normal, solve_step,
        intrinsics=(problem.intr_params, problem.intr_mask))
