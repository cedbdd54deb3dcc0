"""Closed loop of global bundle adjustments with one client.

Set-up makes the configuration's scene on the device (``gen/ba_scene``)
and solves once to warm every shape.  Each timed unit takes the next of a
pool of ``start_pool`` seeded perturbations of the scene's poses and
points, in an order drawn from ``--seed``, and solves it down
the route the mapper's ``_run_ba`` takes for a global BA:
``choose_ba_route`` -> ``ba_dense.from_flat_problem`` ->
``ba_soa.bundle_adjust_soa``, with the mix's ``BAOptions`` in float32 and
``adjust_global_bundle``'s gauge; the solved poses and points come back to
the host as ``_write_back`` reads them.  ``assemble_ba`` and the write
into a ``Reconstruction`` stay outside.

The timed scene and its pool come from the mix's ``scene_seed``, the same
for every ``--seed``: the LM iterations a solve takes depend on its data,
and runs of different scenes differed far more than runs of one
(PERF.md), so every seed gets the same set of solves, in its own order.

The check judges two solves against the float64 plain reference of
``reference/ba.py``: one solve of the window, drawn from the seed
(reservoir sampling, so only its result is kept), and, after the window,
one solve down the same route of a second scene of the same
configuration made from ``--seed`` itself.  For each, from its start:

* ``gram_rel_err``: the program's Schur Gram (``schur_pcg.gram_soa``, in
  the solve's precision, on the Gram inputs of the first LM iteration,
  which the benchmark forms from the reference's float64 normal equations
  and rounds to float32), S_corr and rhs_corr relative to the reference's;
* ``pcg_shortfall``: the program's PCG (``schur_pcg.pcg_schur``) on that
  Gram's reduced system, as the share of the reference system's least
  quadratic-model value (exact solve) that its step falls short of;
* ``centre_gap``, ``point_gap``: the solved state against the reference
  LM's converged one from the same start: the largest camera-centre
  distance and the median point distance (scene units);
* ``cost_gap``: the solved state's cost above the reference's, relative.

Each number compared is the larger of the two solves'; the limits file
names the numbers compared (PERF.md gives their readings).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.core.base import LoopBase, sub_seed
from benchmark.gen import ba_scene
from benchmark.reference import ba as ref

NUMBERS = ("gram_rel_err", "pcg_shortfall", "cost_gap", "centre_gap",
           "point_gap")


class Loop(LoopBase):
    def __init__(self, config, mix, seed, device):
        super().__init__(config, mix, seed, device)
        from privacy_preserving_sfm_torch.optim import ba as ba_mod

        self.opts = ba_mod.BAOptions(**mix.get("ba_options", {}))
        self.dtype = torch.float32
        self.scene_seed = int(mix["scene_seed"])
        with record_function("bench.make_scene"):
            self.main = self._prepare(sub_seed(self.scene_seed, 0))
        pool = int(mix["start_pool"])
        self.order = np.random.default_rng(sub_seed(seed, 5)).permutation(
            pool)
        self.C, self.P, self.O = self.main.C, self.main.P, self.main.O
        # The sampled solve's result: reservoir of one, drawn from the seed.
        self.pick = np.random.default_rng(sub_seed(seed, 2))
        self.kept: Optional[dict] = None
        self.solves = 0
        # The device type the route is chosen for: the run's, except in
        # the CPU tests, which take the card's route on plain kernels.
        self.route_device = device.type

    def _prepare(self, scene_seed: int) -> SimpleNamespace:
        """A scene of the configuration and the tensors a solve of it
        hands the program besides its start."""
        s = ba_scene.make_scene(self.config, scene_seed, self.device)
        C, P, O = s.qvecs.shape[0], s.points.shape[0], s.obs_cam.shape[0]
        f32 = dict(dtype=self.dtype, device=self.device)
        return SimpleNamespace(
            scene=s, C=C, P=P, O=O,
            cam_params=torch.tensor(ba_scene.PARAMS, **f32).expand(
                C, 3).contiguous(),
            obs_line=s.lines.to(self.dtype),
            obs_weight=torch.ones(O, **f32),
            dof_mask=ba_scene.gauge_mask(
                C, self.device, *ba_scene.gauge_pair(s)).to(self.dtype),
            point_mask=torch.ones(P, **f32))

    def _start_seed(self, i: int) -> int:
        """The start of window solve ``i``: the pool's member at position
        ``i`` of the seed's order (``i`` = -1: the warm-up solve's, outside
        the pool)."""
        key = (1, int(self.order[i % len(self.order)])) if i >= 0 else (4,)
        return sub_seed(self.scene_seed, *key)

    def start(self, sc: SimpleNamespace, start_seed: int):
        """A start of scene ``sc`` in the program's dtype."""
        q, t, X = ba_scene.perturbed_start(sc.scene, start_seed)
        return q.to(self.dtype), t.to(self.dtype), X.to(self.dtype)

    def solve(self, sc: SimpleNamespace, start_seed: int, opts=None):
        from privacy_preserving_sfm_torch.optim import ba as ba_mod
        from privacy_preserving_sfm_torch.optim import ba_dense, ba_soa
        from privacy_preserving_sfm_torch.sfm import incremental_mapper

        q0, t0, X0 = self.start(sc, start_seed)
        problem = ba_mod.BAProblem(
            qvecs=q0, tvecs=t0, cam_params=sc.cam_params, points3d=X0,
            obs_cam=sc.scene.obs_cam, obs_point=sc.scene.obs_pt,
            obs_line=sc.obs_line, obs_weight=sc.obs_weight,
            cam_dof_mask=sc.dof_mask, point_mask=sc.point_mask)
        route = incremental_mapper.choose_ba_route(
            self.route_device, sc.C, self.opts.schur_mode)
        if route.solver != "soa":
            raise RuntimeError(f"route {route} is not the SoA solver")
        with record_function("bench.from_flat_problem"):
            dense = ba_dense.from_flat_problem(problem)
        with record_function("bench.bundle_adjust_soa"):
            q, t, X, summary = ba_soa.bundle_adjust_soa(
                dense, "SIMPLE_PINHOLE", opts or self.opts)
        with record_function("bench.write_back_copy"):
            q, t, X = (a.cpu().numpy().astype(np.float64) for a in (q, t, X))
        return q, t, X, summary

    def warm(self):
        self.solve(self.main, self._start_seed(-1))

    def unit(self) -> dict:
        i = self.solves
        self.solves += 1
        keep = self.pick.random() < 1.0 / (i + 1)
        q, t, X, summary = self.solve(self.main, self._start_seed(i))
        finite = bool(np.isfinite(q).all() and np.isfinite(t).all()
                      and np.isfinite(X).all())
        if keep:
            self.kept = dict(i=i, q=q, t=t, X=X, summary=summary)
        return {"obs": self.O, "iters": summary.num_iterations,
                "failed": not finite}

    def info(self) -> dict:
        return {"C": self.C, "P": self.P, "O": self.O,
                "K": int(self.main.scene.lengths.max()),
                "track_lengths": self.main.scene.lengths,
                "itemsize": 4, "cg_iterations": self.opts.cg_iterations}

    def _problem(self, sc, dtype=torch.float64):
        s = sc.scene
        return ref.to_problem(s.obs_cam, s.obs_pt, sc.obs_line,
                              ba_scene.PARAMS, sc.dof_mask, sc.C, sc.P,
                              dtype)

    def _lam0(self) -> float:
        return float(np.float32(self.opts.initial_lambda))

    def first_iteration(self, sc, start_seed: int, precision: str):
        """The program's Schur Gram and PCG at the first LM iteration of a
        solve from ``start_seed``, through their public entries in the
        solve's dtype: the Gram inputs (L^T Hcp of each observation in the
        (K, P) slot layout, L^T gp, the slots' cameras), the damped camera
        blocks and the preconditioner are formed here from the
        reference's float64 normal equations and rounded to float32.
        Returns (S_corr, rhs_corr, step)."""
        from privacy_preserving_sfm_torch.optim import schur_pcg

        prob = self._problem(sc)
        q0, t0, X0 = (a.double() for a in self.start(sc, start_seed))
        n = ref.normal_equations(prob, q0, t0, X0)
        lam, C, P = self._lam0(), sc.C, sc.P
        L = torch.linalg.cholesky(ref.damped_point_inverse(n.Hpp, lam))
        Lt = L.transpose(1, 2)
        u = torch.einsum("oab,ob->oa", Lt[prob.pt], n.Jp)  # (O, 3)
        # Each observation's slot k: its rank among its point's.
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
        lh_stack = lh.reshape(18 * K, P).to(f32).contiguous()
        del lh, u
        S_corr, rhs_corr = schur_pcg.gram_soa(
            lh_stack, gL.to(f32).contiguous(), cam_kp, C, precision,
            plan=schur_pcg.gram_plan(cam_kp, C, "soa"))
        del lh_stack
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
        """The numbers of a solve of scene ``sc`` from ``start_seed`` as one
        side gave them: the first LM iteration's Gram output and step
        ``first`` = (S_corr, rhs_corr, step), and the solved state
        (q, t, X); the float64 reference works each out again from the
        start."""
        prob = self._problem(sc)
        q0, t0, X0 = (a.double() for a in self.start(sc, start_seed))
        out = {}
        lam0 = self._lam0()
        n0 = ref.normal_equations(prob, q0, t0, X0)
        S_ref, rhs_ref = ref.reduced_correction(
            prob, n0, ref.damped_point_inverse(n0.Hpp, lam0))
        S_p, rhs_p, step = (a.double() for a in first)
        out["gram_rel_err"] = max(
            float(torch.linalg.norm(S_p - S_ref) / torch.linalg.norm(S_ref)),
            float(torch.linalg.norm(rhs_p - rhs_ref)
                  / torch.linalg.norm(rhs_ref)))
        del S_p, rhs_p, S_ref, rhs_ref
        S, rhs, _ = ref.reduced_system(prob, n0, lam0)
        L = torch.linalg.cholesky(S)
        best = -0.5 * float(rhs @ torch.cholesky_solve(rhs[:, None], L)[:, 0])
        got = float(ref.model_value(S, rhs, step.reshape(-1)))
        out["pcg_shortfall"] = 1.0 - got / best
        del S, rhs, L, n0
        sol = ref.solve(prob, q0, t0, X0)
        qp, tp, Xp = (torch.as_tensor(a, device=self.device).double()
                      for a in (q, t, X))
        c_p = float(ref.cost(prob, qp, tp, Xp))
        out["cost_gap"] = (c_p - sol.cost) / sol.cost
        out["centre_gap"] = float(torch.linalg.vector_norm(
            ref.camera_centres(qp, tp) - ref.camera_centres(sol.q, sol.t),
            dim=1).max())
        out["point_gap"] = float(torch.linalg.vector_norm(
            Xp - sol.X, dim=1).median())
        if explore:
            out["ref_iterations"] = sol.iterations
            if summary is not None:
                out["iterations"] = summary.num_iterations
                out["reported_cost_err"] = abs(summary.final_cost
                                               - c_p) / c_p
        return {key: (v if np.isfinite(v) else float("inf"))
                for key, v in out.items()}

    def _second(self):
        """The second scene, made from ``--seed``, and its start."""
        return self._prepare(sub_seed(self.seed, 0)), sub_seed(self.seed, 6)

    def _judge_program(self, sc, start_seed, solved, explore, precision):
        q, t, X, summary = solved
        first = self.first_iteration(sc, start_seed, precision)
        return self.judge(sc, start_seed, first, q, t, X, summary, explore)

    @staticmethod
    def _worst(parts: Dict[str, Dict[str, float]], explore: bool
               ) -> Dict[str, float]:
        out = {k: max(p[k] for p in parts.values()) for k in NUMBERS}
        if explore:
            for name, p in parts.items():
                out.update({f"{name}.{k}": v for k, v in p.items()})
        return out

    def readings(self, explore: bool = False) -> Dict[str, float]:
        """The numbers of the kept window solve and of the second scene's
        solve, each the larger of the two; those the cell's limits file
        names are compared."""
        k = self.kept
        parts = {"window": self._judge_program(
            self.main, self._start_seed(k["i"]),
            (k["q"], k["t"], k["X"], k["summary"]), explore,
            self.opts.schur_precision)}
        sc, s0 = self._second()
        parts["scene2"] = self._judge_program(
            sc, s0, self.solve(sc, s0), explore, self.opts.schur_precision)
        return self._worst(parts, explore)

    def controls(self, explore: bool = False) -> Dict[str, Dict[str, float]]:
        """The controls, each judged as the program is, on the kept window
        solve's start and on the second scene's: ``tf32_reference``, the
        reference computed in TF32 (``reference.ba.computed_in_tf32``) in
        the program's place; ``bf16_gram``, the program with its own
        bfloat16 Schur Gram switched on (``schur_precision="bf16"``)."""
        sc2, s2 = self._second()
        starts = {"window": (self.main, self._start_seed(self.kept["i"])),
                  "scene2": (sc2, s2)}
        tf32, bf16 = {}, {}
        bf16_opts = self.opts._replace(schur_precision="bf16")
        for name, (sc, s0) in starts.items():
            prob = self._problem(sc, torch.float32)
            q0, t0, X0 = self.start(sc, s0)
            lam0 = self._lam0()
            with ref.computed_in_tf32():
                n0 = ref.normal_equations(prob, q0, t0, X0)
                S_corr, rhs_corr = ref.reduced_correction(
                    prob, n0, ref.damped_point_inverse(n0.Hpp, lam0))
                dc, _ = ref.step(prob, n0, lam0)
                del n0
                sol = ref.solve(prob, q0, t0, X0)
            tf32[name] = self.judge(sc, s0, (S_corr, rhs_corr, dc), sol.q,
                                    sol.t, sol.X, None, explore)
            del S_corr, rhs_corr, dc, sol
            bf16[name] = self._judge_program(
                sc, s0, self.solve(sc, s0, bf16_opts), explore, "bf16")
        return {"tf32_reference": self._worst(tf32, explore),
                "bf16_gram": self._worst(bf16, explore)}
