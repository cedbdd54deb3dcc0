"""Dense-block bundle adjustment: observations laid out per point.

Port of ``privacy_preserving_sfm_tpu/optim/ba_dense.py``.  Observations
are laid out densely per point,

  cam_idx (P, K), lines (P, K, 3), weight (P, K)   with K = max track len,

so point-side reductions are sums over the K axis, and only the reductions
into the C camera bins remain (``ba._bins``, in a fixed order from a plan
built once per solve, so a float32 solve gives one result every run; the
plan keeps only the observed slots, so padding reaches no camera bin).
``bundle_adjust_dense`` is the LM solver of ``optim/ba.py`` on this
layout, with two ways to solve the reduced camera system:

* **explicit** — with L = chol(Hpp_damped^-1), the per-slot blocks
  LH = L^T Hcp (P, K, 3, 6) go to the AoS Schur Gram
  ``schur_pcg.gram_aos`` (``kernels/schur_gram.cu`` on CUDA, with its
  plan of the camera ids built once per solve), and S = blockdiag(dHcc)
  - S_corr, as S_corr and the (C, 6, 6) blocks, to the PCG
  ``schur_pcg.pcg_schur`` (``kernels/schur_pcg.cu`` on CUDA);
* **implicit** — the matrix-free block-Jacobi CG of ``ba.py``, whose
  matvec never forms S: the scalable path for C > 1024, where the mapper
  runs it automatically.

``plain=True`` runs the Gram and the PCG through their plain versions
whatever the device (a reference run on the card).  ``torch.profiler``
sees the spans ``ba_dense.build_normal``, ``ba_dense.solve_step``,
``ba_dense.gram`` and ``ba_dense.pcg`` (explicit), ``ba_dense.cg``
(implicit).

Differences from the reference, none semantic:
  * K is the longest track, not a rung of the reference's K ladder (that
    ladder bounds XLA compile keys; padded slots carry weight 0);
  * the per-camera gather tables (``cam_gather``) and the three
    ``cam_reduce`` strategies (one-hot matmul, gather, two layouts) are
    TPU layout choices; the camera bins are summed by ``ba._bins``;
  * padding slots reach the Gram with camera id -1, so its kernel skips
    them, and the camera bins' plan leaves them out (the reference sums
    their zero blocks);
  * ``gram_mode`` and ``PPSFM_PCG`` (TPU kernel against XLA loop) have no
    counterpart: on CUDA the kernels always run, ``plain=True`` aside.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from privacy_preserving_sfm_torch.ops import linalg, lines as line_ops
from privacy_preserving_sfm_torch.optim import ba as ba_mod
from privacy_preserving_sfm_torch.optim import schur_pcg


class DenseBAProblem(NamedTuple):
    qvecs: torch.Tensor  # (C, 4)
    tvecs: torch.Tensor  # (C, 3)
    cam_params: torch.Tensor  # (C, Pr)
    points3d: torch.Tensor  # (P, 3)
    obs_cam: torch.Tensor  # (P, K) int64
    obs_line: torch.Tensor  # (P, K, 3)
    obs_weight: torch.Tensor  # (P, K) float, 0 = padding
    cam_dof_mask: torch.Tensor  # (C, 6)
    point_mask: torch.Tensor  # (P,)


def _host_read(t: torch.Tensor) -> np.ndarray:
    """A problem tensor copied to the host: the copy waits for the device."""
    with record_function("ba_dense.host_read"):
        return t.cpu().numpy()


@record_function("ba_dense.from_flat_problem")
def from_flat_problem(problem: ba_mod.BAProblem) -> DenseBAProblem:
    """Convert a flat BAProblem to dense per-point blocks (host-side numpy).

    Padding slots get camera 0, line (1, 0, 0) and weight 0, as in the
    reference.  ``torch.profiler`` sees the span
    ``ba_dense.from_flat_problem`` around the call and one
    ``ba_dense.host_read`` around each of its four reads of the device.
    """
    obs_point, obs_cam, obs_line, obs_weight = (_host_read(t) for t in (
        problem.obs_point, problem.obs_cam, problem.obs_line,
        problem.obs_weight))
    P = problem.points3d.shape[0]

    valid = obs_weight > 0
    counts = np.bincount(obs_point[valid], minlength=P)
    K = int(max(1, counts.max())) if P else 1

    # Per-point slots: stable sort by point, position within group.
    vidx = np.nonzero(valid)[0]
    vp = obs_point[vidx]
    order = np.argsort(vp, kind="stable")
    vidx, vp = vidx[order], vp[order]
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    kslot = np.arange(len(vidx)) - start[vp]

    cam_idx = np.zeros((P, K), np.int64)
    lines = np.zeros((P, K, 3))
    lines[..., 0] = 1.0
    weight = np.zeros((P, K))
    cam_idx[vp, kslot] = obs_cam[vidx]
    lines[vp, kslot] = obs_line[vidx]
    weight[vp, kslot] = obs_weight[vidx]

    def like(a, ref):
        return torch.as_tensor(a, dtype=ref.dtype, device=ref.device)

    return DenseBAProblem(
        qvecs=problem.qvecs, tvecs=problem.tvecs,
        cam_params=problem.cam_params, points3d=problem.points3d,
        obs_cam=torch.as_tensor(cam_idx, device=problem.obs_cam.device),
        obs_line=like(lines, problem.obs_line),
        obs_weight=like(weight, problem.obs_weight),
        cam_dof_mask=problem.cam_dof_mask, point_mask=problem.point_mask)


def uses_explicit(schur_mode: str, device_type: str, num_cams: int) -> bool:
    """Whether the dense solver materializes the reduced camera system
    (reference ``ba_dense.py:235-244``): always for "explicit", on CUDA
    for "auto" when ``schur_pcg.explicit_fits(C)``, otherwise never."""
    if schur_mode == "explicit":
        return True
    if schur_mode == "auto":
        return device_type == "cuda" and schur_pcg.explicit_fits(num_cams)
    return False


def _residuals_and_jacobians(problem: DenseBAProblem, qvecs, tvecs, points,
                             camera_model: str):
    """(P, K, 2) residuals; J_cam (P, K, 2, 6); J_pt (P, K, 2, 3)."""
    oc = problem.obs_cam.reshape(-1)
    P, K = problem.obs_cam.shape
    X_o = points[:, None, :].expand(P, K, 3).reshape(-1, 3)
    r, Jc, Jp = ba_mod.residuals_and_jacobians(
        qvecs[oc], tvecs[oc], X_o, problem.cam_params[oc],
        problem.obs_line.reshape(-1, 3), camera_model)
    Jc = Jc * problem.cam_dof_mask[oc][:, None, :]
    Jp = Jp * problem.point_mask.repeat_interleave(K)[:, None, None]
    return r.reshape(P, K, 2), Jc.reshape(P, K, 2, 6), Jp.reshape(P, K, 2, 3)


def _cost(problem: DenseBAProblem, qvecs, tvecs, points, camera_model,
          loss, loss_scale):
    oc = problem.obs_cam
    r = line_ops.line_ba_residual(
        problem.obs_line, points[:, None, :].expand(oc.shape + (3,)),
        qvecs[oc], tvecs[oc], camera_model, problem.cam_params[oc])
    sq = torch.sum(r * r, dim=-1)
    return 0.5 * torch.sum(ba_mod._robust_cost(sq, loss, loss_scale)
                           * problem.obs_weight)


def bundle_adjust_dense(problem: DenseBAProblem, camera_model: str,
                        options: ba_mod.BAOptions = ba_mod.BAOptions(),
                        *, plain: bool = False):
    """LM with per-point dense blocks (semantics of ``ba.bundle_adjust``);
    returns (qvecs, tvecs, points3d, BASummary).

    ``options.schur_mode`` picks the explicit or implicit solve
    (``uses_explicit``); ``options.schur_precision`` applies to the
    explicit Gram.
    """
    C = problem.qvecs.shape[0]
    P, K = problem.obs_cam.shape
    dev = problem.points3d.device
    loss, scale = options.loss, options.loss_scale
    ba_mod._check_loss(loss)
    explicit = uses_explicit(options.schur_mode, dev.type, C)
    gram = schur_pcg.gram_aos_plain if plain else schur_pcg.gram_aos
    pcg = schur_pcg.pcg_schur_plain if plain else schur_pcg.pcg_schur
    eye6 = torch.eye(6, dtype=problem.points3d.dtype, device=dev)
    n = 6 * C
    oc = problem.obs_cam  # (P, K)
    observed = problem.obs_weight > 0  # (P, K); the rest is padding
    # The camera bins' summation order, of the observed slots only.
    cams = ba_mod.bin_plan(C, oc.reshape(-1), keep=observed.reshape(-1))
    # The Gram kernel skips negative camera ids: padding slots get -1.
    cam_gram = torch.where(observed, oc, -1).to(torch.int32)
    # The Gram kernel's plan of these ids, built once for the solve.
    gram_kw = {"plan": schur_pcg.gram_plan(cam_gram, C, "aos")} \
        if explicit and not plain else {}

    def cam_bins(values):
        """(P, K, ...) per-slot values -> (C, ...) camera bins."""
        return ba_mod._bins(cams, values.reshape((P * K,)
                                                 + values.shape[2:]))

    def cost_fn(q, t, X):
        return _cost(problem, q, t, X, camera_model, loss, scale)

    @record_function("ba_dense.build_normal")
    def build_normal(q, t, X):
        r, Jc, Jp = _residuals_and_jacobians(problem, q, t, X, camera_model)
        sq = torch.sum(r * r, dim=-1)
        w = ba_mod._robust_weight(sq, loss, scale) * problem.obs_weight
        Hpp = torch.einsum("pkri,pkrj,pk->pij", Jp, Jp, w)
        Hcp_o = torch.einsum("pkri,pkrj,pk->pkij", Jc, Jp, w)  # (P,K,6,3)
        gp = torch.einsum("pkri,pkr,pk->pi", Jp, r, w)
        Hcc = cam_bins(torch.einsum("pkri,pkrj,pk->pkij", Jc, Jc, w))
        gc = cam_bins(torch.einsum("pkri,pkr,pk->pki", Jc, r, w))
        return ba_mod._sym(Hcc), Hpp, Hcp_o, gc, gp

    def solve_explicit(dHcc, Hpp_inv, Hcp_o, gc, gp):
        """S = dHcc - V^T V with V = L^T U (Hpp_inv = L L^T); the rhs
        correction V^T (L^T gp) comes out of the same Gram."""
        with record_function("ba_dense.gram"):
            L = linalg.chol3(Hpp_inv)  # (P, 3, 3) lower
            gL = torch.einsum("pba,pb->pa", L, gp)
            LH = torch.einsum("pba,pkib->pkai", L, Hcp_o)  # (P, K, 3, 6)
            S_corr, rhs_corr = gram(LH, gL, cam_gram, C,
                                    options.schur_precision, **gram_kw)
        rhs = gc.reshape(n) - rhs_corr
        SJ_inv = ba_mod._inv6(dHcc - schur_pcg.diag_blocks(S_corr, C)
                              + 1e-12 * eye6)
        with record_function("ba_dense.pcg"):
            dcf = pcg(S_corr, dHcc, SJ_inv, rhs, options.cg_iterations)
        return dcf.reshape(C, 6)

    def solve_implicit(dHcc, Hpp_inv, Hcp_o, gc, gp):
        """Matrix-free CG: S v = dHcc v - E Hpp^-1 E^T v."""
        def cam_side(y):  # E y: (P, 3) -> (C, 6)
            return cam_bins(torch.einsum("pkij,pj->pki", Hcp_o, y))

        def S_matvec(v):
            Etv = torch.einsum("pkji,pkj->pi", Hcp_o, v[oc])
            y = torch.einsum("pij,pj->pi", Hpp_inv, Etv)
            return torch.einsum("cij,cj->ci", dHcc, v) - cam_side(y)

        rhs = gc - cam_side(torch.einsum("pij,pj->pi", Hpp_inv, gp))
        SJ_o = torch.einsum("pkij,pjl,pkml->pkim", Hcp_o, Hpp_inv, Hcp_o)
        SJ_inv = ba_mod._inv6(dHcc - cam_bins(SJ_o) + 1e-12 * eye6)
        with record_function("ba_dense.cg"):
            return ba_mod.block_jacobi_cg(S_matvec, SJ_inv, rhs,
                                          options.cg_iterations)

    @record_function("ba_dense.solve_step")
    def solve_step(normal, lam):
        Hcc, Hpp, Hcp_o, gc, gp = normal
        dHcc = ba_mod.damped(Hcc, lam)
        Hpp_inv = linalg.inv3(ba_mod.damped(Hpp, lam))  # (P, 3, 3)
        solve = solve_explicit if explicit else solve_implicit
        dc = ba_mod._finite_or_zero(solve(dHcc, Hpp_inv, Hcp_o, gc, gp))
        # Back-substitution: dp = Hpp^-1 (gp - E^T dc).
        Etdc = torch.einsum("pkji,pkj->pi", Hcp_o, dc[oc])
        dp = torch.einsum("pij,pj->pi", Hpp_inv, gp - Etdc)
        return dc, ba_mod._finite_or_zero(dp)

    return ba_mod.levenberg_marquardt(problem, options, cost_fn,
                                      build_normal, solve_step)
