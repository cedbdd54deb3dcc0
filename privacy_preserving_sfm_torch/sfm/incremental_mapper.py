"""Incremental mapper: the 4-view initialization and global bundle
adjustment.

Port of the parts of ``privacy_preserving_sfm_tpu/sfm/incremental_mapper.py``
that ``line_initializer`` and ``bundle_adjuster`` run:

  * ``MapperOptions``, ``begin_reconstruction`` / ``end_reconstruction``
    with the register and deregister events
    (``incremental_mapper.cc:102-135``);
  * ``register_initial_line_images`` (``incremental_mapper.cc:192-567``):
    4-view aligned and random tracks around <= 10 seed images (native or
    Python graph), >= 20 of each per image set, ranked by aligned tracks;
    up to 10 candidate sets through the 4-view initializer in one batched
    call; the best inlier ratio registered and triangulated;
  * ``adjust_global_bundle`` (gauge fix + Normalize,
    ``incremental_mapper.cc:893-939``) and ``_run_ba`` over the three
    solvers (``choose_ba_route``).

Device work runs on the mapper's ``device`` in its ``dtype``.  Unlike the
reference, nothing is padded to bucketed shapes (those ladders bound XLA
compile keys): the BA problem has its true camera count, so the route
reads the true count where the reference reads its bucketed count, and
the initializer solves the true candidate sets at the largest set's track
count, where the reference repeats the last set up to 10 and pads tracks
to a x4 grid.  The initializer's draws come from a ``torch.Generator``
seeded from ``MapperOptions.seed`` (``init/initializer.draw_init``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from privacy_preserving_sfm_torch.init import initializer as init_mod
from privacy_preserving_sfm_torch.models.database_cache import DatabaseCache
from privacy_preserving_sfm_torch.models.reconstruction import Reconstruction
from privacy_preserving_sfm_torch.ops import lie_np
from privacy_preserving_sfm_torch.optim import ba as ba_mod
from privacy_preserving_sfm_torch.optim import ba_dense, ba_soa, schur_pcg
from privacy_preserving_sfm_torch.sfm.incremental_triangulator import (
    IncrementalTriangulator, TriangulatorOptions,
)

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


@dataclasses.dataclass
class MapperOptions:
    """The fields of ``IncrementalMapper::Options``
    (``incremental_mapper.h:50-113``) that the 4-view initialization reads;
    the registration, filtering and local-BA fields come with the mapper
    loop."""

    init_min_num_inliers: int = 20
    init_max_error: float = 5.0  # px
    init_min_tri_angle: float = 2.0  # degrees
    init_num_samples: int = 1024
    seed: int = 0


# Tracks a candidate image set needs, of each kind (aligned and random).
MIN_INIT_TRACKS = 20
MAX_INIT_SETS = 10


class InitSets(NamedTuple):
    """The candidate image sets of the initializer and their tracks, in
    the order the reference passes them to its init kernel (no padding
    sets); tracks are padded to the largest set's count with invalid
    (1, 0, 0) lines."""

    keys: List[Tuple[int, int, int, int]]  # sorted image ids of each set
    aligned: np.ndarray  # (S, 4, N, 3)
    aligned_valid: np.ndarray  # (S, N)
    random: np.ndarray  # (S, 4, M, 3)
    random_valid: np.ndarray  # (S, M)
    gravity: np.ndarray  # (S, 4, 3)
    max_error: np.ndarray  # (S,) normalized-plane threshold


class BAAssembly(NamedTuple):
    problem: ba_mod.BAProblem
    camera_model: str
    cam_list: List[int]  # image id of each camera slot
    point_index: Dict[int, int]  # point3d id -> point slot
    dof_mask: np.ndarray  # (C, 6)
    num_obs: int


class IncrementalMapper:
    def __init__(self, device: torch.device, dtype: torch.dtype,
                 database_cache: Optional[DatabaseCache] = None):
        self.device = torch.device(device)
        self.dtype = dtype
        self.cache = database_cache
        self.rec: Reconstruction | None = None
        self.triangulator: IncrementalTriangulator | None = None
        self.phase_times: Dict[str, float] = {}
        self.last_summary: ba_mod.BASummary | None = None
        self.last_route: BARoute | None = None
        self.num_reg_trials: Dict[int, int] = {}
        self.filtered_images: Set[int] = set()
        self.existing_image_ids: Set[int] = set()
        self.num_reg_images_per_camera: Dict[int, int] = {}
        # Cross-model bookkeeping (persists over begin/end_reconstruction;
        # ``incremental_mapper.cc:95-135,1160-1191``): how often each image
        # has been registered across all models of this mapper.
        self.num_registrations: Dict[int, int] = {}
        self.num_total_reg_images = 0
        self.num_shared_reg_images = 0
        self._rng = np.random.default_rng(0)

    def _tick(self, name: str, t0: float) -> float:
        """Add the time since ``t0`` (device-synced) to ``phase_times``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.phase_times[name] = self.phase_times.get(name, 0.0) + (now - t0)
        return now

    # -- lifecycle -------------------------------------------------------

    def begin_reconstruction(self, rec: Reconstruction):
        """``BeginReconstruction`` (``incremental_mapper.cc:102-122``):
        per-model state reset, a triangulator over the database cache's
        graph where the mapper has one, and register events for the
        model's registered images."""
        if self.rec is not None:
            raise RuntimeError("this mapper already holds a reconstruction")
        self.rec = rec
        if self.cache is not None:
            self.triangulator = IncrementalTriangulator(
                rec, self.cache.view, device=self.device, dtype=self.dtype)
        self.num_shared_reg_images = 0
        self.num_reg_images_per_camera = {}
        self.existing_image_ids = set(rec.reg_image_ids)
        self.filtered_images = set()
        self.num_reg_trials = {}
        for iid in rec.reg_image_ids:
            self._register_image_event(iid)

    def end_reconstruction(self, discard: bool):
        """``EndReconstruction`` (``incremental_mapper.cc:124-135``)."""
        if self.rec is None:
            raise RuntimeError("this mapper holds no reconstruction")
        if discard:
            for iid in list(self.rec.reg_image_ids):
                self._deregister_image_event(iid)
        self.rec = None
        self.triangulator = None

    def _register_image_event(self, image_id: int):
        cam_id = self.rec.images[image_id].camera_id
        self.num_reg_images_per_camera[cam_id] = \
            self.num_reg_images_per_camera.get(cam_id, 0) + 1
        n = self.num_registrations.get(image_id, 0) + 1
        self.num_registrations[image_id] = n
        if n == 1:
            self.num_total_reg_images += 1
        else:
            self.num_shared_reg_images += 1

    def _deregister_image_event(self, image_id: int):
        cam_id = self.rec.images[image_id].camera_id
        self.num_reg_images_per_camera[cam_id] = \
            self.num_reg_images_per_camera.get(cam_id, 1) - 1
        n = self.num_registrations.get(image_id, 1) - 1
        self.num_registrations[image_id] = n
        if n == 0:
            self.num_total_reg_images -= 1
        else:
            self.num_shared_reg_images -= 1

    # -- initialization --------------------------------------------------

    def register_initial_line_images(self, options: MapperOptions,
                                     aligned_cache: DatabaseCache) -> bool:
        """Bootstrap 4 poses (``incremental_mapper.cc:192-567``): assemble
        the candidate sets, solve them all in one batched initializer call,
        register the set with the best inlier ratio and triangulate it.
        Phase times (``phase_times``, device-synced) and profiler spans:
        ``init_assemble`` / ``init.assemble``, ``init_solve`` /
        ``init.solve``, ``init_triangulate`` / ``init.triangulate``."""
        span = torch.profiler.record_function
        t0 = time.perf_counter()
        self._rng = np.random.default_rng(options.seed)
        with span("init.assemble"):
            sets = self.assemble_init_sets(options, aligned_cache)
        t0 = self._tick("init_assemble", t0)
        if sets is None:
            return False
        with span("init.solve"):
            res = self.solve_init_sets(sets, options)
            success = res.success.cpu().numpy()
            ratios = np.where(success, res.inlier_ratio.cpu().numpy(), -1.0)
            poses = res.poses.cpu().numpy()
            num_inliers = res.num_inliers.cpu().numpy()
        t0 = self._tick("init_solve", t0)
        best = int(np.argmax(ratios))
        if ratios[best] <= 0.0 or \
                int(num_inliers[best]) < options.init_min_num_inliers:
            return False
        with span("init.triangulate"):
            self.register_initial_poses(sets.keys[best], poses[best])
        self._tick("init_triangulate", t0)
        return True

    def assemble_init_sets(self, options: MapperOptions,
                           aligned_cache: DatabaseCache
                           ) -> Optional[InitSets]:
        """The candidate image sets and their 4-view tracks: every feature
        of <= 10 seed images (drawn from ``self._rng``, preferring images
        no earlier model registered) with >= 3 same-kind correspondences
        gives C(n, 3) candidate tracks on 4 distinct images; sets with
        >= 20 aligned and >= 20 random tracks are ranked by aligned tracks
        (a stable sort) and the first 10 kept.  None when there is none."""
        graph = aligned_cache.graph
        image_ids = sorted(aligned_cache.images.keys())
        if len(image_ids) < 4:
            return None
        unseen = [iid for iid in image_ids
                  if self.num_registrations.get(iid, 0) == 0]
        seed_pool = unseen if len(unseen) >= 4 else image_ids
        num_check = min(10, len(seed_pool))
        check_ids = self._rng.choice(seed_pool, num_check, replace=False)

        all_aligned: Dict[Tuple, Set[Tuple]] = {}
        all_unaligned: Dict[Tuple, Set[Tuple]] = {}
        if hasattr(graph, "assemble_four_view_tracks"):
            # Native C++ fast path (native/graph.cpp).
            flags = {iid: np.ascontiguousarray(
                aligned_cache.images[iid].aligned, np.uint8)
                for iid in image_ids}
            for want, container in ((True, all_aligned),
                                    (False, all_unaligned)):
                got = graph.assemble_four_view_tracks(
                    list(check_ids), image_ids, flags, want)
                for key, feats in got.items():
                    container[key] = {tuple(int(v) for v in row)
                                      for row in feats}
            check_ids = []  # skip the Python enumeration below

        for image_id in check_ids:
            img = aligned_cache.images[image_id]
            for line_idx in range(img.num_lines):
                is_aligned = bool(img.aligned[line_idx])
                corrs = [
                    (iid, li) for iid, li in
                    graph.find_correspondences(image_id, line_idx)
                    if bool(aligned_cache.images[iid].aligned[li])
                    == is_aligned
                ]
                if len(corrs) < 3:
                    continue
                container = all_aligned if is_aligned else all_unaligned
                n = len(corrs)
                for i in range(n):
                    for j in range(i + 1, n):
                        for k in range(j + 1, n):
                            cand = sorted(
                                {(image_id, line_idx), corrs[i], corrs[j],
                                 corrs[k]})
                            if len({c[0] for c in cand}) != 4:
                                continue
                            key = tuple(c[0] for c in cand)
                            feats = tuple(c[1] for c in cand)
                            container.setdefault(key, set()).add(feats)

        candidates = []
        for key, atracks in all_aligned.items():
            utracks = all_unaligned.get(key, set())
            if len(atracks) >= MIN_INIT_TRACKS and \
                    len(utracks) >= MIN_INIT_TRACKS:
                candidates.append((key, len(atracks), len(utracks)))
        if not candidates:
            return None
        # Rank by aligned-track count only (unaligned weight = 0.0).
        candidates.sort(key=lambda c: -c[1])
        cand = candidates[:MAX_INIT_SETS]

        S = len(cand)
        na = max(c[1] for c in cand)
        nu = max(c[2] for c in cand)
        al = np.zeros((S, 4, na, 3))
        al[..., 0] = 1.0
        un = np.zeros((S, 4, nu, 3))
        un[..., 0] = 1.0
        av = np.zeros((S, na), bool)
        uv = np.zeros((S, nu), bool)
        gravity = np.zeros((S, 4, 3))
        max_error = np.zeros(S)
        for b, (key, _, _) in enumerate(cand):
            for tracks, lines, valid in (
                    (sorted(all_aligned[key]), al, av),
                    (sorted(all_unaligned[key]), un, uv)):
                feats = np.asarray(tracks, np.int64)  # (T, 4)
                for v in range(4):
                    lines[b, v, :len(tracks)] = \
                        aligned_cache.images[key[v]].lines[feats[:, v]]
                valid[b, :len(tracks)] = True
            gravity[b] = np.stack(
                [aligned_cache.images[k].gravity for k in key])
            max_error[b] = min(
                aligned_cache.cameras[aligned_cache.images[k].camera_id]
                .image_to_world_threshold(options.init_max_error)
                for k in key)
        return InitSets([c[0] for c in cand], al, av, un, uv, gravity,
                        max_error)

    def solve_init_sets(self, sets: InitSets, options: MapperOptions
                        ) -> init_mod.InitResult:
        """Every candidate set through the 4-view initializer in one
        batched call on the mapper's device and dtype, with draws from a
        generator seeded from ``options.seed``."""
        opts = init_mod.InitOptions(
            min_tri_angle_deg=options.init_min_tri_angle,
            min_num_inliers=options.init_min_num_inliers,
            num_samples_fourview=options.init_num_samples,
            num_samples_offset=options.init_num_samples)
        av = torch.from_numpy(sets.aligned_valid)
        uv = torch.from_numpy(sets.random_valid)
        draws = init_mod.draw_init(
            torch.Generator().manual_seed(options.seed), av, uv, opts)

        def f(a):
            return torch.from_numpy(a).to(device=self.device,
                                          dtype=self.dtype)

        return init_mod.initialize_reconstruction(
            f(sets.aligned), av.to(self.device), f(sets.random),
            uv.to(self.device), f(sets.gravity), f(sets.max_error), draws,
            opts)

    def register_initial_poses(self, image_ids: Sequence[int],
                               poses: np.ndarray):
        """Register the 4 images with their (4, 3, 4) world->camera poses
        and triangulate them: every image, then complete and merge all
        tracks (``incremental_mapper.py:316-330`` of the reference)."""
        for v, image_id in enumerate(image_ids):
            img = self.rec.images[image_id]
            img.qvec = lie_np.rotmat_to_quat(poses[v, :, :3])
            img.tvec = np.array(poses[v, :, 3], dtype=np.float64)
            self.rec.register_image(image_id)
            self._register_image_event(image_id)
        tri_options = TriangulatorOptions()
        for image_id in list(self.rec.reg_image_ids):
            self.triangulate_image(tri_options, image_id)
        self.complete_tracks(tri_options)
        self.merge_tracks(tri_options)

    # -- triangulation wrappers -----------------------------------------

    def triangulate_image(self, tri_options: TriangulatorOptions,
                          image_id: int) -> int:
        return self.triangulator.triangulate_image(tri_options, image_id)

    def complete_tracks(self, tri_options: TriangulatorOptions) -> int:
        return self.triangulator.complete_all_tracks(tri_options)

    def merge_tracks(self, tri_options: TriangulatorOptions) -> int:
        return self.triangulator.merge_all_tracks(tri_options)

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
