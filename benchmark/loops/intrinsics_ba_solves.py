"""Closed loop of global bundle adjustments that refine one shared focal,
with one client.

The deployment is a video from one camera whose focal is unknown (COLMAP's
``single_camera`` with ``ba_refine_focal_length``): every image slot
shares one SIMPLE_PINHOLE camera (U = 1) whose focal the BA refines
beside the poses and points; the principal point stays fixed.  Set-up
makes the configuration's scene on the device (``gen/ba_scene``) and
solves once to warm every shape.  Each timed unit takes the next of a
pool of ``start_pool`` seeded starts of the scene, in an order drawn from
``--seed``: the poses and points perturbed as ``ba_solves`` perturbs
them, a start focal drawn within the mix's ``focal_spread`` of the true
one (``gen/shared_camera``), and the observed lines as lifted under that
start focal.  It solves down the route the mapper's ``_run_ba`` takes
once a ``refine_*`` option is set: ``ba_intrinsics.from_flat_problem`` ->
``ba_intrinsics.bundle_adjust_intrinsics``, with the mix's
``ControllerOptions``' ``global_ba_options()`` in float32 and
``adjust_global_bundle``'s gauge; the solved poses, points and camera
come back to the host as the mapper reads them.

The check judges the kept window solve and a solve of a second scene of
the configuration made from ``--seed`` against the float64 plain
reference ``reference/ba_intrinsics.py`` run to convergence from the same
start:

* ``focal_gap``: the solved focal against the reference's, relative;
* ``cost_gap``: the solved state's float64 cost above the reference's,
  relative;
* ``centre_gap``, ``point_gap``: the largest camera-centre distance and
  the median point distance (scene units).

Each number compared is the larger of the two solves'.  The control is
the reference computed in TF32 (``reference.ba.computed_in_tf32``) in the
program's place.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.core.base import sub_seed
from benchmark.gen import ba_scene, shared_camera
from benchmark.loops import ba_solves
from benchmark.reference import ba as ref
from benchmark.reference import ba_intrinsics as iref
from privacy_preserving_sfm_torch.optim import ba as ba_mod
from privacy_preserving_sfm_torch.optim import ba_intrinsics as ba_intr
from privacy_preserving_sfm_torch.optim.ba_intrinsics import \
    from_flat_problem
from privacy_preserving_sfm_torch.sfm import controller

NUMBERS = ("focal_gap", "cost_gap", "centre_gap", "point_gap")
MODEL = "SIMPLE_PINHOLE"


class Loop(ba_solves.Loop):
    def __init__(self, config, mix, seed, device):
        super().__init__(config, mix, seed, device)
        self.opts = controller.ControllerOptions(
            **mix["controller"]).global_ba_options()

    def _prepare(self, scene_seed: int) -> SimpleNamespace:
        s = ba_scene.make_scene(self.config, scene_seed, self.device)
        C, P, O = s.qvecs.shape[0], s.points.shape[0], s.obs_cam.shape[0]
        f32 = dict(dtype=self.dtype, device=self.device)
        return SimpleNamespace(
            scene=s, C=C, P=P, O=O,
            cam_of_slot=torch.zeros(C, dtype=torch.int64,
                                    device=self.device),
            obs_weight=torch.ones(O, **f32),
            dof_mask=ba_scene.gauge_mask(
                C, self.device, *ba_scene.gauge_pair(s)).to(self.dtype),
            point_mask=torch.ones(P, **f32))

    def start(self, sc: SimpleNamespace, start_seed: int):
        """A start of scene ``sc`` in float64: poses, points, the start
        camera (f0, cx, cy) and the lines as lifted under it."""
        q, t, X = ba_scene.perturbed_start(sc.scene, start_seed)
        f_true, cx, cy = ba_scene.PARAMS
        f0 = shared_camera.start_focal(sub_seed(start_seed, 1), f_true,
                                       float(self.mix["focal_spread"]))
        lines = shared_camera.lifted_lines(sc.scene.lines, f_true, f0)
        return q, t, X, (f0, cx, cy), lines

    def solve(self, sc: SimpleNamespace, start_seed: int, opts=None):
        q0, t0, X0, cam0, lines = self.start(sc, start_seed)
        intr = torch.tensor([cam0], dtype=self.dtype, device=self.device)
        problem = ba_mod.BAProblem(
            qvecs=q0.to(self.dtype), tvecs=t0.to(self.dtype),
            cam_params=intr.expand(sc.C, 3), points3d=X0.to(self.dtype),
            obs_cam=sc.scene.obs_cam, obs_point=sc.scene.obs_pt,
            obs_line=lines.to(self.dtype), obs_weight=sc.obs_weight,
            cam_dof_mask=sc.dof_mask, point_mask=sc.point_mask)
        opts = opts or self.opts
        iprob = from_flat_problem(problem, MODEL, sc.cam_of_slot, intr,
                                  opts)
        with record_function("bench.bundle_adjust_intrinsics"):
            q, t, X, cam, summary = ba_intr.bundle_adjust_intrinsics(
                iprob, MODEL, opts)
        with record_function("bench.write_back_copy"):
            q, t, X, cam = (a.cpu().numpy().astype(np.float64)
                            for a in (q, t, X, cam))
        return q, t, X, cam, summary

    def unit(self) -> dict:
        i = self.solves
        self.solves += 1
        keep = self.pick.random() < 1.0 / (i + 1)
        q, t, X, cam, summary = self.solve(self.main, self._start_seed(i))
        finite = bool(np.isfinite(q).all() and np.isfinite(t).all()
                      and np.isfinite(X).all() and np.isfinite(cam).all())
        if keep:
            self.kept = dict(i=i, solved=(q, t, X, cam), summary=summary)
        return {"obs": self.O, "iters": summary.num_iterations,
                "failed": not finite}

    def _problem(self, sc, start, dtype=torch.float64):
        s = sc.scene
        _, _, _, cam0, lines = start
        return iref.to_problem(s.obs_cam, s.obs_pt, lines, cam0,
                               sc.dof_mask, sc.C, sc.P, dtype)

    def judge(self, sc, start_seed: int, solved, summary=None,
              explore: bool = False) -> Dict[str, float]:
        """The numbers of a solve of scene ``sc`` from ``start_seed``, the
        solved (q, t, X, camera) as one side gave them, against the
        float64 reference's converged solve from the same start."""
        start = self.start(sc, start_seed)
        prob = self._problem(sc, start)
        q0, t0, X0, cam0, _ = start
        sol = iref.solve(prob, q0, t0, X0, cam0[0])
        q, t, X, cam = solved
        qp, tp, Xp = (torch.as_tensor(a, device=self.device).double()
                      for a in (q, t, X))
        fp = float(np.asarray(cam).reshape(-1)[0])
        c_p = float(iref.cost(prob, qp, tp, Xp, fp))
        out = {
            "focal_gap": abs(fp - sol.f) / sol.f,
            "cost_gap": (c_p - sol.cost) / sol.cost,
            "centre_gap": float(torch.linalg.vector_norm(
                ref.camera_centres(qp, tp) - ref.camera_centres(sol.q,
                                                                sol.t),
                dim=1).max()),
            "point_gap": float(torch.linalg.vector_norm(
                Xp - sol.X, dim=1).median())}
        if explore:
            out.update(ref_iterations=sol.iterations, ref_focal=sol.f,
                       focal=fp, start_focal=cam0[0])
            if summary is not None:
                out["iterations"] = summary.num_iterations
        return {k: (v if np.isfinite(v) else float("inf"))
                for k, v in out.items()}

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
        solve, each the larger of the two."""
        k = self.kept
        parts = {"window": self.judge(self.main, self._start_seed(k["i"]),
                                      k["solved"], k["summary"], explore)}
        sc, s0 = self._second()
        *solved, summary = self.solve(sc, s0)
        parts["scene2"] = self.judge(sc, s0, solved, summary, explore)
        return self._worst(parts, explore)

    def controls(self, explore: bool = False) -> Dict[str, Dict[str, float]]:
        """``tf32_reference``: the reference computed in TF32 from float32
        inputs (``reference.ba.computed_in_tf32``) in the program's place,
        judged as the program is, on the kept window solve's start and on
        the second scene's."""
        sc2, s2 = self._second()
        starts = {"window": (self.main, self._start_seed(self.kept["i"])),
                  "scene2": (sc2, s2)}
        tf32 = {}
        for name, (sc, s0) in starts.items():
            start = self.start(sc, s0)
            q0, t0, X0, cam0, _ = start
            prob = self._problem(sc, start, torch.float32)
            with ref.computed_in_tf32():
                sol = iref.solve(prob, q0.float(), t0.float(), X0.float(),
                                 cam0[0])
            tf32[name] = self.judge(
                sc, s0, (sol.q, sol.t, sol.X, [sol.f]), None, explore)
        return {"tf32_reference": self._worst(tf32, explore)}
