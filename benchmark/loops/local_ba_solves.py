"""Closed loop of the mapper's local bundle adjustments, with one client.

A local BA refines the poses of the local bundle (the image just
registered and the images sharing most points with it) and the points the
registration changed; the other images that observe those points join as
frozen cameras, and every other point the bundle observes stays fixed
(``IncrementalMapper.adjust_local_bundle``).  Set-up makes a scene of the
mix's ``scene`` shape with the configuration's camera and noise on the
device (``gen/ba_scene``), picks from the scene seed the ``free_images``
of the local bundle among its cameras (the last of them with its pose
fixed and the one before it its x translation, the local BA's gauge) and
the ``frozen_point_share`` of points held fixed, and solves once to warm
every shape.  Each timed unit takes the next of a pool of ``start_pool``
seeded perturbations of the poses and points, in an order drawn from
``--seed``, and solves it down the mapper's route on the card:
``choose_ba_route`` -> ``ba_dense.from_flat_problem`` ->
``ba_soa.bundle_adjust_soa``, with the mix's ``ControllerOptions``'
``local_ba_options()`` (soft-L1 loss) in float32.

The check is ``ba_solves``' five numbers against the float64 plain
reference ``reference/ba_local.py``, which freezes the same cameras and
points and minimizes the same robust cost: the kept window solve and a
solve of a second scene from ``--seed``, each number the larger of the
two; ``point_gap`` is the median over the free points (the frozen ones
do not move on either side).  The controls are ``ba_solves``': the
reference computed in TF32, and the program with its bfloat16 Schur Gram.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from benchmark.core.base import sub_seed
from benchmark.gen import ba_scene
from benchmark.loops import ba_solves
from benchmark.reference import ba as ref
from benchmark.reference import ba_local as lref


class Loop(ba_solves.Loop):
    def __init__(self, config, mix, seed, device):
        from privacy_preserving_sfm_torch.sfm import controller

        super().__init__(config, mix, seed, device)
        self.opts = controller.ControllerOptions(
            **mix.get("controller", {})).local_ba_options()

    def _prepare(self, scene_seed: int) -> SimpleNamespace:
        m = self.mix
        s = ba_scene.make_scene(dict(self.config, **m["scene"]), scene_seed,
                                self.device)
        C, P, O = s.qvecs.shape[0], s.points.shape[0], s.obs_cam.shape[0]
        rng = np.random.default_rng(sub_seed(scene_seed, 7))
        bundle = rng.permutation(C)[:int(m["free_images"])]
        dof = np.zeros((C, 6))
        dof[bundle[:-1]] = 1.0
        if len(bundle) > 1:
            dof[bundle[-2], 3] = 0.0
        pmask = np.ones(P)
        pmask[rng.permutation(P)[:round(float(m["frozen_point_share"])
                                        * P)]] = 0.0
        f32 = dict(dtype=self.dtype, device=self.device)
        return SimpleNamespace(
            scene=s, C=C, P=P, O=O,
            cam_params=torch.tensor(ba_scene.PARAMS, **f32).expand(
                C, 3).contiguous(),
            obs_line=s.lines.to(self.dtype),
            obs_weight=torch.ones(O, **f32),
            dof_mask=torch.tensor(dof, **f32),
            point_mask=torch.tensor(pmask, **f32))

    def _problem(self, sc, dtype=torch.float64):
        s = sc.scene
        return lref.to_problem(s.obs_cam, s.obs_pt, sc.obs_line,
                               ba_scene.PARAMS, sc.dof_mask, sc.point_mask,
                               sc.C, sc.P, self.opts.loss_scale
                               if self.opts.loss == "soft_l1" else 0.0,
                               dtype)

    def first_iteration(self, sc, start_seed: int, precision: str):
        """``ba_solves``' first-iteration Gram and PCG, on the Gram inputs
        formed from the local reference's reweighted normal equations."""
        from privacy_preserving_sfm_torch.optim import schur_pcg

        lprob = self._problem(sc)
        prob = lprob.base
        q0, t0, X0 = (a.double() for a in self.start(sc, start_seed))
        n = lref.normal_equations(lprob, q0, t0, X0)
        lam, C, P = self._lam0(), sc.C, sc.P
        L = torch.linalg.cholesky(ref.damped_point_inverse(n.Hpp, lam))
        Lt = L.transpose(1, 2)
        u = torch.einsum("oab,ob->oa", Lt[prob.pt], n.Jp)  # (O, 3)
        order = torch.argsort(prob.pt, stable=True)
        counts = torch.bincount(prob.pt, minlength=P)
        first = torch.cumsum(counts, 0) - counts
        k = torch.empty_like(order)
        k[order] = torch.arange(order.numel(), device=order.device) \
            - first[prob.pt[order]]
        K = int(counts.max())
        lh = torch.zeros(3, 6, K, P, dtype=torch.float64, device=self.device)
        lh[:, :, k, prob.pt] = (u[:, :, None] * n.Jc[:, None, :]).permute(
            1, 2, 0)
        cam_kp = torch.full((K, P), -1, dtype=torch.int32,
                            device=self.device)
        cam_kp[k, prob.pt] = prob.cam.to(torch.int32)
        gL = torch.einsum("pab,pb->ap", Lt, n.gp)
        f32 = self.dtype
        S_corr, rhs_corr = schur_pcg.gram_soa(
            lh.reshape(18 * K, P).to(f32).contiguous(),
            gL.to(f32).contiguous(), cam_kp, C, precision,
            plan=schur_pcg.gram_plan(cam_kp, C, "soa"))
        dHcc = ref.damped_cameras(n.Hcc, lam).to(f32)
        idx = torch.arange(C, device=self.device)
        SJ = dHcc - S_corr.view(C, 6, C, 6)[idx, :, idx, :]
        eye6 = torch.eye(6, dtype=f32, device=self.device)
        SJ_inv = torch.linalg.inv(SJ + 1e-12 * eye6)
        rhs = n.gc.reshape(-1).to(f32) - rhs_corr
        step = schur_pcg.pcg_schur(S_corr, dHcc, SJ_inv, rhs,
                                   self.opts.cg_iterations)
        return S_corr, rhs_corr, step

    def judge(self, sc, start_seed: int, first, q, t, X, summary=None,
              explore: bool = False) -> Dict[str, float]:
        """``ba_solves.Loop.judge``'s numbers against the local
        reference."""
        lprob = self._problem(sc)
        prob = lprob.base
        q0, t0, X0 = (a.double() for a in self.start(sc, start_seed))
        out = {}
        lam0 = self._lam0()
        n0 = lref.normal_equations(lprob, q0, t0, X0)
        S_ref, rhs_ref = ref.reduced_correction(
            prob, n0, ref.damped_point_inverse(n0.Hpp, lam0))
        S_p, rhs_p, step = (a.double() for a in first)
        out["gram_rel_err"] = max(
            float(torch.linalg.norm(S_p - S_ref) / torch.linalg.norm(S_ref)),
            float(torch.linalg.norm(rhs_p - rhs_ref)
                  / torch.linalg.norm(rhs_ref)))
        S, rhs, _ = ref.reduced_system(prob, n0, lam0)
        L = torch.linalg.cholesky(S)
        best = -0.5 * float(rhs @ torch.cholesky_solve(rhs[:, None], L)[:, 0])
        got = float(ref.model_value(S, rhs, step.reshape(-1)))
        out["pcg_shortfall"] = 1.0 - got / best
        sol = lref.solve(lprob, q0, t0, X0)
        qp, tp, Xp = (torch.as_tensor(a, device=self.device).double()
                      for a in (q, t, X))
        c_p = float(lref.cost(lprob, qp, tp, Xp))
        free = lprob.point_mask > 0
        out["cost_gap"] = (c_p - sol.cost) / sol.cost
        out["centre_gap"] = float(torch.linalg.vector_norm(
            ref.camera_centres(qp, tp) - ref.camera_centres(sol.q, sol.t),
            dim=1).max())
        out["point_gap"] = float(torch.linalg.vector_norm(
            Xp[free] - sol.X[free], dim=1).median())
        if explore:
            out["ref_iterations"] = sol.iterations
            if summary is not None:
                out["iterations"] = summary.num_iterations
                out["reported_cost_err"] = abs(summary.final_cost
                                               - c_p) / c_p
        return {key: (v if np.isfinite(v) else float("inf"))
                for key, v in out.items()}

    def controls(self, explore: bool = False) -> Dict[str, Dict[str, float]]:
        """``ba_solves``' controls against the local reference:
        ``tf32_reference`` and ``bf16_gram``."""
        sc2, s2 = self._second()
        starts = {"window": (self.main, self._start_seed(self.kept["i"])),
                  "scene2": (sc2, s2)}
        tf32, bf16 = {}, {}
        bf16_opts = self.opts._replace(schur_precision="bf16")
        for name, (sc, s0) in starts.items():
            lprob = self._problem(sc, torch.float32)
            q0, t0, X0 = self.start(sc, s0)
            lam0 = self._lam0()
            with ref.computed_in_tf32():
                n0 = lref.normal_equations(lprob, q0, t0, X0)
                S_corr, rhs_corr = ref.reduced_correction(
                    lprob.base, n0, ref.damped_point_inverse(n0.Hpp, lam0))
                dc, _ = ref.step(lprob.base, n0, lam0)
                sol = lref.solve(lprob, q0, t0, X0)
            tf32[name] = self.judge(sc, s0, (S_corr, rhs_corr, dc), sol.q,
                                    sol.t, sol.X, None, explore)
            bf16[name] = self._judge_program(
                sc, s0, self.solve(sc, s0, bf16_opts), explore, "bf16")
        return {"tf32_reference": self._worst(tf32, explore),
                "bf16_gram": self._worst(bf16, explore)}
