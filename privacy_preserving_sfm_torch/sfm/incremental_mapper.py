"""Incremental mapper: global bundle adjustment.

Port of the parts of ``privacy_preserving_sfm_tpu/sfm/incremental_mapper.py``
that ``bundle_adjuster`` runs: ``begin_reconstruction`` (the model only),
``adjust_global_bundle``
(gauge fix + Normalize, reference ``incremental_mapper.cc:893-939``) and
``_run_ba`` over the three solvers (``choose_ba_route``): the
explicit-Schur SoA solver, the dense-block solver (explicit or implicit
Schur) and the flat solver.

The solve runs on the mapper's ``device`` in its ``dtype``.  Unlike the
reference, the problem is not padded to bucketed shapes: those ladders
bound XLA compile keys, and padded slots carry zero weight.  So the
route's camera count is the true one, where the reference reads its
bucketed count.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from privacy_preserving_sfm_torch.models.reconstruction import Reconstruction
from privacy_preserving_sfm_torch.optim import ba as ba_mod
from privacy_preserving_sfm_torch.optim import ba_dense, ba_soa, schur_pcg

# Observations kept per point (semantics of the reference mapper: a
# deterministic stride subset of longer tracks).
MAX_OBS_PER_POINT = 128


class BARoute(NamedTuple):
    solver: str  # "soa" | "dense" | "flat"
    explicit: bool  # dense only: explicit Schur (else implicit CG)


def choose_ba_route(device_type: str, num_cams: int, schur_mode: str,
                    ba_path: str = "", schur_override: str = "") -> BARoute:
    """The BA solver ``_run_ba`` takes (reference
    ``incremental_mapper.py:980-993`` with ``ba_dense.py:235-244``).

    ``ba_path`` and ``schur_override`` are the values of the environment
    variables ``PPSFM_BA_PATH`` (flat | dense | soa) and
    ``PPSFM_SCHUR_MODE`` (auto | implicit | explicit), "" when unset; the
    override replaces ``schur_mode``.  With neither set: the flat solver on
    the CPU; on CUDA the SoA solver when C <= 1024 and the Schur mode
    allows it, else the dense solver, implicit past 1024 cameras.
    """
    if schur_override:
        schur_mode = schur_override
    on_accel = device_type == "cuda"
    if ba_path == "soa" or (ba_path == "" and on_accel
                            and schur_pcg.explicit_fits(num_cams)
                            and schur_mode in ("auto", "explicit")):
        return BARoute("soa", False)
    if ba_path == "dense" or (ba_path != "flat" and on_accel):
        return BARoute("dense", ba_dense.uses_explicit(
            schur_mode, device_type, num_cams))
    return BARoute("flat", False)


class BAAssembly(NamedTuple):
    problem: ba_mod.BAProblem
    camera_model: str
    cam_list: List[int]  # image id of each camera slot
    point_index: Dict[int, int]  # point3d id -> point slot
    dof_mask: np.ndarray  # (C, 6)
    num_obs: int


class IncrementalMapper:
    def __init__(self, device: torch.device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.rec: Reconstruction | None = None
        self.phase_times: Dict[str, float] = {}
        self.last_summary: ba_mod.BASummary | None = None
        self.last_route: BARoute | None = None

    # -- lifecycle -------------------------------------------------------

    def begin_reconstruction(self, rec: Reconstruction):
        """``BeginReconstruction`` (``incremental_mapper.cc:102-122``): the
        model this mapper adjusts.  The registration bookkeeping and the
        triangulator come with the mapper loop (ROADMAP.md Queue 1 #7)."""
        if self.rec is not None:
            raise RuntimeError("this mapper already holds a reconstruction")
        self.rec = rec

    # -- bundle adjustment ------------------------------------------------

    def adjust_global_bundle(self, ba_options: ba_mod.BAOptions) -> bool:
        reg = list(self.rec.reg_image_ids)
        if len(reg) < 2:
            raise ValueError("global bundle adjustment needs >= 2 images")
        self.rec.filter_observations_with_negative_depth()
        const_pose = {reg[0]}
        const_tvec_x = {reg[1]}
        ok, _ = self._run_ba(reg, const_pose, const_tvec_x, ba_options)
        self.rec.normalize()
        return ok

    def _run_ba(self, config_images: Sequence[int], const_pose: Set[int],
                const_tvec_x: Set[int],
                ba_options: ba_mod.BAOptions) -> Tuple[bool, int]:
        """Assemble the BA problem of ``config_images`` and solve it on the
        route of ``choose_ba_route``, recorded in ``last_route``."""
        t_start = time.perf_counter()
        if (ba_options.refine_focal_length
                or ba_options.refine_principal_point
                or ba_options.refine_extra_params):
            raise NotImplementedError(
                "intrinsics refinement (optim/ba_intrinsics) is not ported "
                "yet: ROADMAP.md Queue 1 #8")
        asm = self.assemble_ba(config_images, const_pose, const_tvec_x)
        if asm is None:
            return False, 0
        route = choose_ba_route(
            self.device.type, len(asm.cam_list), ba_options.schur_mode,
            os.environ.get("PPSFM_BA_PATH", ""),
            os.environ.get("PPSFM_SCHUR_MODE", ""))
        if route.solver == "flat":
            t_assembled = time.perf_counter()
            q, t, X, summary = ba_mod.bundle_adjust(
                asm.problem, asm.camera_model, ba_options)
        else:
            dense = ba_dense.from_flat_problem(asm.problem)
            t_assembled = time.perf_counter()
            if route.solver == "soa":
                q, t, X, summary = ba_soa.bundle_adjust_soa(
                    dense, asm.camera_model, ba_options)
            else:
                q, t, X, summary = ba_dense.bundle_adjust_dense(
                    dense, asm.camera_model, ba_options._replace(
                        schur_mode="explicit" if route.explicit
                        else "implicit"))
        q, t, X = (a.cpu().numpy().astype(np.float64) for a in (q, t, X))
        t_solved = time.perf_counter()
        for k, v in (("ba_assemble", t_assembled - t_start),
                     ("ba_solve", t_solved - t_assembled)):
            self.phase_times[k] = self.phase_times.get(k, 0.0) + v
        self.last_summary = summary
        self.last_route = route
        if not (np.isfinite(q).all() and np.isfinite(t).all()
                and np.isfinite(X).all()):
            return False, asm.num_obs
        rec = self.rec
        for i, iid in enumerate(asm.cam_list):
            if asm.dof_mask[i].any():
                rec.images[iid].qvec = q[i]
                rec.images[iid].tvec = t[i]
        for pid, slot in asm.point_index.items():
            rec.points3d[pid].xyz = X[slot]
        return True, asm.num_obs

    def assemble_ba(self, config_images: Sequence[int], const_pose: Set[int],
                    const_tvec_x: Set[int]) -> Optional[BAAssembly]:
        """The flat BA problem over ``config_images`` and every point they
        observe, on the mapper's device in its dtype; None when there is
        too little to adjust."""
        rec = self.rec
        obs: List[Tuple[int, int, int]] = []  # (image_id, line_idx, pid)
        point_ids: List[int] = []
        point_index: Dict[int, int] = {}
        for iid in config_images:
            img = rec.images[iid]
            for li in np.nonzero(img.point3d_ids >= 0)[0]:
                pid = int(img.point3d_ids[li])
                if pid not in point_index:
                    point_index[pid] = len(point_ids)
                    point_ids.append(pid)
                obs.append((iid, int(li), pid))
        if len(obs) < 6 or len(point_ids) == 0:
            return None
        obs = _cap_track_length(obs)

        cam_list = list(config_images)
        C = len(cam_list)
        cam_index = {iid: i for i, iid in enumerate(cam_list)}
        camera0 = rec.cameras[rec.images[cam_list[0]].camera_id]
        qvecs = np.zeros((C, 4))
        tvecs = np.zeros((C, 3))
        cam_params = np.zeros((C, len(camera0.params)))
        dof_mask = np.ones((C, 6))
        for i, iid in enumerate(cam_list):
            img = rec.images[iid]
            qvecs[i] = img.qvec
            tvecs[i] = img.tvec
            cam_params[i] = rec.cameras[img.camera_id].params
            if iid in const_pose:
                dof_mask[i] = 0.0
            elif iid in const_tvec_x:
                dof_mask[i, 3] = 0.0
        points3d = np.stack([rec.points3d[pid].xyz for pid in point_ids])
        obs_cam = np.array([cam_index[o[0]] for o in obs], np.int64)
        obs_point = np.array([point_index[o[2]] for o in obs], np.int64)
        obs_line = np.stack([rec.images[iid].lines[li]
                             for iid, li, _ in obs])

        def f(a):
            return torch.tensor(a, dtype=self.dtype, device=self.device)

        problem = ba_mod.BAProblem(
            qvecs=f(qvecs), tvecs=f(tvecs), cam_params=f(cam_params),
            points3d=f(points3d),
            obs_cam=torch.tensor(obs_cam, device=self.device),
            obs_point=torch.tensor(obs_point, device=self.device),
            obs_line=f(obs_line), obs_weight=f(np.ones(len(obs))),
            cam_dof_mask=f(dof_mask), point_mask=f(np.ones(len(point_ids))))
        return BAAssembly(problem, camera0.model, cam_list, point_index,
                          dof_mask, len(obs))


def _cap_track_length(obs: List[Tuple[int, int, int]]):
    """Keep at most MAX_OBS_PER_POINT observations per point: a
    deterministic stride subset that keeps each long track's first
    observation and spans the rest (reference ``_run_ba``)."""
    cnt: Dict[int, int] = {}
    for _, _, pid in obs:
        cnt[pid] = cnt.get(pid, 0) + 1
    cap = MAX_OBS_PER_POINT
    if not cnt or max(cnt.values()) <= cap:
        return obs
    keep: List[Tuple[int, int, int]] = []
    seen: Dict[int, int] = {}
    for o in obs:
        pid = o[2]
        n = cnt[pid]
        i = seen.get(pid, 0)
        seen[pid] = i + 1
        if n <= cap or i * cap // n != (i - 1) * cap // n or i == 0:
            keep.append(o)
    return keep
