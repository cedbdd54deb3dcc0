"""Explicit-Schur Levenberg-Marquardt bundle adjustment (torch).

Port of ``privacy_preserving_sfm_tpu/optim/ba_soa.py:134-432``, the solver
the mapper runs for every BA with C <= 1024 cameras on an accelerator.
Same LM damping, accept/reject, gradient and rejection stops, and gauge
masks as the reference; per LM iteration:

1. one residual + Jacobian pass at the trial point (``torch.func.jacfwd``
   under ``torch.func.vmap`` over the observations), giving its robust
   cost and its normal equations: per-point Hpp (P, 3, 3), gp (P, 3),
   per-observation Hcp (K, P, 6, 3), per-camera Hcc (C, 6, 6), gc (C, 6);
2. points eliminated in closed form: with L = chol(Hpp_damped^-1), the
   blocks LH = L^T Hcp go to the Schur Gram ``schur_pcg.gram_soa``, which
   returns S_corr = V^T V and rhs_corr (in ``options.schur_precision``;
   padding slots reach it with camera id -1, so its kernel skips them;
   its plan of the camera ids, ``schur_pcg.gram_plan``, is built once per
   solve);
3. the reduced camera system S = blockdiag(dHcc) - S_corr is solved by
   ``schur_pcg.pcg_schur`` with the block-Jacobi preconditioner, from
   S_corr and the (C, 6, 6) blocks as they are (no dense S or Minv is
   built), and the point steps are back-substituted.

Layout: observations are indexed flat as k*P + p (slot-major), so every
per-observation tensor reshapes to (K, P, ...) and point-side sums run
over the K axis.  The reference's TPU layout tricks (one-hot MXU gathers,
optimization barriers, tuples of (K, P) component arrays) are replaced by
``index_select``-style gathers and the camera bins of ``ba._bins``, summed
in a fixed order from a plan built once per solve.

The LM loop is a Python loop that reads the accept flag and the relative
decrease once per iteration (and the gradient norm, when a gradient
tolerance is set), and the initial and final costs for the summary.
``torch.profiler`` sees the spans ``ba_soa.build_normal``,
``ba_soa.solve_step``, ``ba_soa.gram`` and ``ba_soa.pcg``; inside the
first, ``ba.jacobians`` (the residual and Jacobian pass) and ``ba.bins``
(each camera bin sum); ``ba_soa.host_read`` around each of those reads of
the device, ``schur_pcg.host_read`` around the Gram plan's, and
``ba_soa.rejected_step`` once per rejected step.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from privacy_preserving_sfm_torch.optim import ba as ba_mod
from privacy_preserving_sfm_torch.optim import ba_dense, schur_pcg


def _chol3_comps(a11, a21, a31, a22, a32, a33):
    """Closed-form lower Cholesky of symmetric 3x3 from components."""
    l11 = torch.sqrt(a11.clamp_min(1e-30))
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = torch.sqrt((a22 - l21 * l21).clamp_min(1e-30))
    l32 = (a32 - l31 * l21) / l22
    l33 = torch.sqrt((a33 - l31 * l31 - l32 * l32).clamp_min(1e-30))
    return l11, l21, l31, l22, l32, l33


def _inv3_comps(a11, a21, a31, a22, a32, a33):
    """Closed-form inverse of symmetric 3x3 from components (adjugate)."""
    c11 = a22 * a33 - a32 * a32
    c21 = a32 * a31 - a21 * a33
    c31 = a21 * a32 - a22 * a31
    c22 = a11 * a33 - a31 * a31
    c32 = a21 * a31 - a11 * a32
    c33 = a11 * a22 - a21 * a21
    det = a11 * c11 + a21 * c21 + a31 * c31
    d = 1.0 / torch.where(det.abs() < 1e-30, det.new_full((), 1e-30), det)
    return c11 * d, c21 * d, c31 * d, c22 * d, c32 * d, c33 * d


def _sym3_matvec(m, x0, x1, x2):
    """(m11,m21,m31,m22,m32,m33) @ (x0,x1,x2) componentwise."""
    m11, m21, m31, m22, m32, m33 = m
    return (m11 * x0 + m21 * x1 + m31 * x2,
            m21 * x0 + m22 * x1 + m32 * x2,
            m31 * x0 + m32 * x1 + m33 * x2)


def _host_read(cast, t: torch.Tensor):
    """``cast(t)`` of a device scalar: the read waits for the device."""
    with record_function("ba_soa.host_read"):
        return cast(t)


def bundle_adjust_soa(problem: ba_dense.DenseBAProblem, camera_model: str,
                      options: ba_mod.BAOptions = ba_mod.BAOptions(),
                      *, plain: bool = False):
    """Explicit-Schur LM on a dense per-point problem.

    Returns (qvecs, tvecs, points3d, BASummary).  Requires
    ``schur_pcg.explicit_fits(C)``.  ``plain=True`` runs the Gram and the
    PCG through their plain PyTorch versions whatever the device (a
    reference run on the card); by default they dispatch on the device.
    """
    C = problem.qvecs.shape[0]
    P, K = problem.obs_cam.shape
    dtype = problem.points3d.dtype
    dev = problem.points3d.device
    dyn = ba_mod.DynamicBAOptions.from_options(options)
    gram = schur_pcg.gram_soa_plain if plain else schur_pcg.gram_soa
    pcg = schur_pcg.pcg_schur_plain if plain else schur_pcg.pcg_schur
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    n = 6 * C

    # ---- static observation-side tensors (once per solve) ----
    oc_kp = problem.obs_cam.T.contiguous()  # (K, P)
    # The Gram kernel skips negative camera ids: padding slots get -1.
    cam_kp32 = torch.where(problem.obs_weight.T > 0, oc_kp, -1).to(
        torch.int32)
    # The Gram kernel's plan of these ids, built once for the solve.
    gram_kw = {} if plain else {
        "plan": schur_pcg.gram_plan(cam_kp32, C, "soa")}
    oc = oc_kp.reshape(-1)  # (K*P,), index k*P + p
    cams = ba_mod.bin_plan(C, oc)  # the camera bins' summation order
    w_o = problem.obs_weight.T.reshape(-1).to(dtype)
    line_o = problem.obs_line.transpose(0, 1).reshape(-1, 3)
    par_o = problem.cam_params[oc]
    dof_o = problem.cam_dof_mask[oc]  # (K*P, 6)
    pmask = problem.point_mask.to(dtype)  # (P,)
    pmask_o = pmask.repeat(K)

    @record_function("ba_soa.build_normal")
    def build_normal(q, t, X):
        """Robust cost and normal equations at (q, t, X)."""
        r, Jc, Jp = ba_mod.residuals_and_jacobians(
            q[oc], t[oc], X.repeat(K, 1), par_o, line_o, camera_model)
        Jc = Jc * dof_o[:, None, :]  # freeze masked dofs
        Jp = Jp * pmask_o[:, None, None]  # and constant points
        sq = r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1]
        cost = 0.5 * torch.sum(
            ba_mod._robust_cost(sq, dyn.loss, dyn.loss_scale) * w_o)
        w = ba_mod._robust_weight(sq, dyn.loss, dyn.loss_scale) * w_o
        # Point side, reduced over K.
        hpp = ((Jp[:, :, :, None] * Jp[:, :, None, :]).sum(1)
               * w[:, None, None]).reshape(K, P, 3, 3).sum(0)
        gp = ((Jp * r[:, :, None]).sum(1)
              * w[:, None]).reshape(K, P, 3).sum(0)
        # Cross blocks (K, P, 6, 3).
        hcp = ((Jc[:, :, :, None] * Jp[:, :, None, :]).sum(1)
               * w[:, None, None]).reshape(K, P, 6, 3)
        # Camera side, summed into the C bins.
        hcc_o = (Jc[:, :, :, None] * Jc[:, :, None, :]).sum(1) \
            * w[:, None, None]
        gc_o = (Jc * r[:, :, None]).sum(1) * w[:, None]
        Hcc = ba_mod._sym(ba_mod._bins(cams, hcc_o))
        gc = ba_mod._bins(cams, gc_o)
        return cost, (hpp, gp, hcp, Hcc, gc)

    @record_function("ba_soa.solve_step")
    def solve_step(normal, lam):
        hpp, gp, hcp, Hcc, gc = normal
        dHcc = ba_mod.damped(Hcc, lam)
        d11 = hpp[:, 0, 0] * (1.0 + lam) + 1e-12
        d22 = hpp[:, 1, 1] * (1.0 + lam) + 1e-12
        d33 = hpp[:, 2, 2] * (1.0 + lam) + 1e-12
        hinv = _inv3_comps(d11, hpp[:, 0, 1], hpp[:, 0, 2], d22,
                           hpp[:, 1, 2], d33)  # (P,) x 6
        l11, l21, l31, l22, l32, l33 = (
            c[:, None] for c in _chol3_comps(*hinv))  # (P, 1) each

        # LH[a][i] = (L^T Hcp)[a, i] = sum_b L[b, a] hcp[i][b]; L lower.
        h0, h1, h2 = hcp[..., 0], hcp[..., 1], hcp[..., 2]  # (K, P, 6)
        lh = torch.stack([l11 * h0 + l21 * h1 + l31 * h2,
                          l22 * h1 + l32 * h2,
                          l33 * h2])  # (3, K, P, 6)
        lh_stack = lh.permute(0, 3, 1, 2).reshape(18 * K, P)
        g0, g1, g2 = gp[:, 0], gp[:, 1], gp[:, 2]
        gL = torch.stack([l11[:, 0] * g0 + l21[:, 0] * g1 + l31[:, 0] * g2,
                          l22[:, 0] * g1 + l32[:, 0] * g2,
                          l33[:, 0] * g2])  # (3, P)

        with record_function("ba_soa.gram"):
            S_corr, rhs_corr = gram(lh_stack, gL, cam_kp32, C,
                                    options.schur_precision, **gram_kw)
        rhs = gc.reshape(n) - rhs_corr
        SJ = dHcc - schur_pcg.diag_blocks(S_corr, C)
        SJ_inv = ba_mod._inv6(SJ + 1e-12 * eye6)
        with record_function("ba_soa.pcg"):
            dcf = pcg(S_corr, dHcc, SJ_inv, rhs, options.cg_iterations)
        dc = ba_mod._finite_or_zero(dcf.reshape(C, 6))

        # Back-substitution: dp = Hpp_inv (gp - E^T dc).
        dcg = dc[oc_kp]  # (K, P, 6)
        et = (hcp * dcg[..., None]).sum(2).sum(0)  # (P, 3)
        dp = torch.stack(_sym3_matvec(hinv, g0 - et[:, 0], g1 - et[:, 1],
                                      g2 - et[:, 2]), dim=-1)
        return dc, ba_mod._finite_or_zero(dp)

    q, t, X = problem.qvecs, problem.tvecs, problem.points3d
    cost0, normal = build_normal(q, t, X)
    c = cost0
    lam = dyn.initial_lambda
    it = stall = rej = 0
    while (it < dyn.max_iterations and stall < 2
           and lam < options.max_lambda * 0.99):
        grad_done = False
        if dyn.gradient_tolerance > 0:
            gc_m = normal[4] * problem.cam_dof_mask
            gp_m = normal[1] * pmask[:, None]
            g_max = torch.maximum(gc_m.abs().max(), gp_m.abs().max())
            grad_done = _host_read(bool, g_max <= dyn.gradient_tolerance)
        dc, dp = solve_step(normal, lam)
        q_new, t_new, X_new = ba_mod._apply_step(
            q, t, X, -(dc * problem.cam_dof_mask), -(dp * pmask[:, None]))
        # Trial cost and normal equations from one pass: kept on accept
        # (the next linearization), dropped on reject.
        c_new, normal_new = build_normal(q_new, t_new, X_new)
        accept = _host_read(bool, c_new < c)
        rel = _host_read(float, (c - c_new) / torch.clamp_min(c, 1e-30))
        if accept:
            q, t, X, c, normal = q_new, t_new, X_new, c_new, normal_new
            lam = max(lam / 3.0, options.min_lambda)
        else:
            with record_function("ba_soa.rejected_step"):
                lam = min(lam * 4.0, options.max_lambda)
        if accept and rel < dyn.function_tolerance:
            stall += 1
        elif accept:
            stall = 0
        if grad_done:
            stall = 2
        rej = 0 if accept else rej + 1
        if rej >= options.max_consecutive_rejections:
            stall = 2
        it += 1
    summary = ba_mod.BASummary(initial_cost=_host_read(float, cost0),
                               final_cost=_host_read(float, c),
                               num_iterations=it, lam=lam)
    return q, t, X, summary
