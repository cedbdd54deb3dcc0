"""Incremental mapper: the 4-view initialization, registration, local
and global bundle adjustment, filtering.

Port of ``privacy_preserving_sfm_tpu/sfm/incremental_mapper.py`` (host
code over ``src/sfm/incremental_mapper.{h,cc}``):

  * ``MapperOptions``, ``begin_reconstruction`` / ``end_reconstruction``
    with the register and deregister events
    (``incremental_mapper.cc:102-135``);
  * ``register_initial_line_images`` (``:192-567``): 4-view aligned and
    random tracks around <= 10 seed images, >= 20 of each per image set,
    ranked by aligned tracks; up to 10 candidate sets through the 4-view
    initializer in one batched call; the best inlier ratio registered and
    triangulated;
  * ``find_next_images`` (``:139-191``): visible-points ratio, fresh
    images before previously failed or filtered ones;
  * ``register_next_image`` (``:570-759``): 2D-3D correspondences through
    the CSR view, P6L RANSAC in up to three hypothesis batches with the
    adaptive trial bound, IRLS refinement, the inlier tracks continued;
    at the first registration of a camera without a prior focal, with
    ``abs_pose_refine_focal_length``, the focal search (``:668-714``,
    reformulated for lifted lines by the reference package);
  * ``find_local_bundle`` / ``adjust_local_bundle`` (``:781-888,
    993-1160``): the 8-step relaxing (triangulation angle, overlap)
    schedule, gauge fixing, variable points (error < 0 or track <= 15)
    with the images that observe them frozen, then merge, complete and
    filter;
  * ``adjust_global_bundle`` (gauge fix + Normalize, ``:893-939``) and
    ``_run_ba`` over the three solvers (``choose_ba_route``), or, with a
    ``refine_*`` option, the variable-intrinsics solver
    (``optim/ba_intrinsics``), whose correction is baked into the camera
    params and every line of the camera;
  * ``filter_images`` / ``filter_points``.

Device work runs on the mapper's ``device`` in its ``dtype``.  Unlike the
reference, nothing is padded to bucketed shapes (those ladders bound XLA
compile keys): the BA problem has its true camera count, so the route
reads the true count where the reference reads its bucketed count; the
pose estimator solves the true N correspondences; the initializer solves
the true candidate sets at the largest set's track count.  Draws come
from ``torch.Generator`` objects on the CPU: the initializer's seeded
from ``MapperOptions.seed`` (``init/initializer.draw_init``), each P6L
hypothesis batch's from a seed drawn from the mapper's ``_rng``
(``solvers/p6l.draw_pose``), so a card run and a CPU run try the same
samples.

Phase times (``phase_times``, device-synced) and ``torch.profiler``
spans: ``init_*`` / ``init.*``, ``register`` / ``mapper.register``,
``triangulate`` / ``mapper.triangulate``, ``local_ba`` /
``mapper.local_ba``, ``global_ba`` / ``mapper.global_ba``, ``filter`` /
``mapper.filter``; ``ba_assemble`` and ``ba_solve`` split every BA.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from privacy_preserving_sfm_torch.init import initializer as init_mod
from privacy_preserving_sfm_torch.models.database_cache import DatabaseCache
from privacy_preserving_sfm_torch.models.reconstruction import Reconstruction
from privacy_preserving_sfm_torch.ops import cameras as cam_ops
from privacy_preserving_sfm_torch.ops import lie_np, lines_np
from privacy_preserving_sfm_torch.optim import ba as ba_mod
from privacy_preserving_sfm_torch.optim import ba_intrinsics as ba_intr
from privacy_preserving_sfm_torch.optim import ba_dense, ba_soa, schur_pcg
from privacy_preserving_sfm_torch.sfm.incremental_triangulator import (
    IncrementalTriangulator, TriangulatorOptions,
)
from privacy_preserving_sfm_torch.solvers import p6l, ransac

# Observations kept per point (semantics of the reference mapper: a
# deterministic stride subset of longer tracks).
MAX_OBS_PER_POINT = 128
# Trial cap of the registration's adaptive stop (``ransac.h:158-176`` at
# conf 0.99999, ``incremental_mapper.cc:679-681``).
MAX_POSE_TRIALS = 10000
# Variable points of a local BA: modified tracks up to this length.
LOCAL_BA_MAX_TRACK = 15
# Registered images below which ``filter_images`` keeps every image.
FILTER_IMAGES_MIN_REG = 20

class BARoute(NamedTuple):
    solver: str  # "soa" | "dense" | "flat" | "intrinsics"
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
    """``IncrementalMapper::Options`` (``incremental_mapper.h:50-113``)."""

    init_min_num_inliers: int = 20
    init_max_error: float = 5.0  # px
    init_min_tri_angle: float = 2.0  # degrees
    abs_pose_max_error: float = 12.0  # px
    abs_pose_min_num_inliers: int = 30
    abs_pose_min_inlier_ratio: float = 0.25
    filter_max_reproj_error: float = 4.0  # px
    filter_min_tri_angle: float = 1.5  # degrees
    max_reg_trials: int = 3
    local_ba_num_images: int = 6
    local_ba_min_tri_angle: float = 6.0  # degrees
    min_focal_length_ratio: float = 0.1
    max_focal_length_ratio: float = 10.0
    max_extra_param: float = 1.0
    # Focal search at the first registration of a camera without a prior
    # focal (``_focal_search``).
    abs_pose_refine_focal_length: bool = False
    num_focal_length_samples: int = 30
    fix_existing_images: bool = False
    num_hypotheses: int = 4096  # P6L RANSAC batch (ref: 100..10000 trials)
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
    dof_mask: np.ndarray  # (C, 6); 0 on frozen cameras
    point_mask: np.ndarray  # (P,); 0 on frozen points
    obs: List[Tuple[int, int, int]]  # (image id, line, point3d id)


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
        # (image id, focal before, focal after, inliers) of every focal
        # search that moved a focal.
        self.focal_searches: List[Tuple[int, float, float, int]] = []
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
            self.triangulator.triangulate_image(tri_options, image_id)
        self.triangulator.complete_all_tracks(tri_options)
        self.triangulator.merge_all_tracks(tri_options)

    @contextlib.contextmanager
    def _phase(self, name: str):
        """Span ``mapper.<name>`` and device-synced phase time ``name``."""
        t0 = time.perf_counter()
        with torch.profiler.record_function("mapper." + name):
            try:
                yield
            finally:
                self._tick(name, t0)

    # -- next-image selection -------------------------------------------

    def _registered_dense(self, ok=None) -> np.ndarray:
        """Per dense view image: registered (and passing ``ok``)."""
        view = self.cache.view
        out = np.zeros(len(view.image_ids), bool)
        for d, iid in enumerate(view.image_ids):
            img = self.rec.images.get(iid)
            out[d] = img is not None and img.registered and (
                ok is None or ok(img))
        return out

    def _visible_stats_all(self) -> Dict[int, Tuple[int, int]]:
        """(lines with a registered, triangulated correspondence, lines
        with any correspondence) for every unregistered image of the view,
        one flat gather over the CSR view."""
        view = self.cache.view
        reg = self._registered_dense()
        tri = view.concat_per_image(
            lambda iid: self.rec.images[iid].point3d_ids >= 0
            if iid in self.rec.images
            else np.zeros(view.num_lines[view.dense[iid]], bool))
        out: Dict[int, Tuple[int, int]] = {}
        for iid, img in self.rec.images.items():
            if img.registered or iid not in view.dense:
                continue
            s, e = view.corr_range(iid)
            vis = reg[view.corr_img_dense[s:e]] & tri[view.corr_flat[s:e]]
            per_line = view.per_line_counts(iid, vis)
            out[iid] = (int(np.count_nonzero(per_line)),
                        view.num_obs_per_image[iid])
        return out

    def find_next_images(self, options: MapperOptions) -> List[int]:
        """Unregistered images with >= ``abs_pose_min_num_inliers`` visible
        points and fewer than ``max_reg_trials`` trials, by visible-points
        ratio: first those never tried nor filtered, then the rest."""
        ranked, other = [], []
        stats = self._visible_stats_all()
        for iid, img in self.rec.images.items():
            if img.registered:
                continue
            num_vis, num_obs = stats.get(iid, (0, 0))
            if num_vis < options.abs_pose_min_num_inliers:
                continue
            trials = self.num_reg_trials.get(iid, 0)
            if trials >= options.max_reg_trials:
                continue
            rank = num_vis / max(num_obs, 1)
            if iid not in self.filtered_images and trials == 0:
                ranked.append((iid, rank))
            else:
                other.append((iid, rank))
        ranked.sort(key=lambda x: -x[1])
        other.sort(key=lambda x: -x[1])
        return [i for i, _ in ranked] + [i for i, _ in other]

    # -- registration ----------------------------------------------------

    def correspondences_2d3d(self, options: MapperOptions,
                             image_id: int) -> np.ndarray:
        """(M, 2) unique (line index, point3d id) pairs of the image through
        its direct correspondences in registered images whose cameras are
        not bogus (``incremental_mapper.cc:631-637``), sorted."""
        view = self.cache.view
        if image_id not in view.dense:
            return np.zeros((0, 2), np.int64)

        def cam_ok(other) -> bool:
            c = self.rec.cameras[other.camera_id]
            return not cam_ops.has_bogus_params(
                c.model, c.params, c.width, c.height,
                options.min_focal_length_ratio,
                options.max_focal_length_ratio, options.max_extra_param)

        reg = self._registered_dense(cam_ok)
        pid_flat = view.concat_per_image(
            lambda iid: self.rec.images[iid].point3d_ids
            if iid in self.rec.images
            else np.full(view.num_lines[view.dense[iid]], -1, np.int64))
        s, e = view.corr_range(image_id)
        pids = pid_flat[view.corr_flat[s:e]]
        ok = reg[view.corr_img_dense[s:e]] & (pids >= 0)
        pairs = np.stack([view.line_of_corr[s:e][ok], pids[ok]], axis=1)
        return np.unique(pairs, axis=0) if len(pairs) else pairs

    def register_next_image(self, options: MapperOptions,
                            image_id: int) -> bool:
        """Register one image by P6L RANSAC on its 2D-3D correspondences
        and the IRLS refinement, then continue its inlier tracks
        (``incremental_mapper.cc:570-759``).  Hypothesis batches of
        (max(256, nh / 4), nh, nh) stop once ``num_trials_needed`` (capped
        at 10,000) is met.  With ``abs_pose_refine_focal_length``, the first
        registration of a camera without a prior focal searches the focal
        first (``_focal_search``)."""
        with self._phase("register"):
            return self._register_next_image(options, image_id)

    def _register_next_image(self, options: MapperOptions,
                             image_id: int) -> bool:
        img = self.rec.images[image_id]
        cam = self.rec.cameras[img.camera_id]
        if img.registered:
            raise ValueError(f"image {image_id} is already registered")
        self.num_reg_trials[image_id] = \
            self.num_reg_trials.get(image_id, 0) + 1
        corrs = self.correspondences_2d3d(options, image_id)
        n = len(corrs)
        if n < max(options.abs_pose_min_num_inliers, 6):
            return False
        if (options.abs_pose_refine_focal_length
                and not cam.prior_focal_length
                and not any(o.registered and o.camera_id == cam.camera_id
                            for o in self.rec.images.values())):
            self._focal_search(options, image_id, corrs)

        def f(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=self.device, dtype=self.dtype)

        lines = f(img.lines[corrs[:, 0]])
        aligned = torch.from_numpy(img.aligned[corrs[:, 0]]).to(self.device)
        points = f(np.stack([self.rec.points3d[int(p)].xyz
                             for p in corrs[:, 1]]))
        thresh = cam.image_to_world_threshold(options.abs_pose_max_error)
        schedule = (max(256, options.num_hypotheses // 4),
                    options.num_hypotheses, options.num_hypotheses)
        res = None
        best_inliers = 0
        total_trials = 0
        for nh in schedule:
            gen = torch.Generator().manual_seed(
                int(self._rng.integers(0, 2 ** 31)))
            r = p6l.estimate_absolute_pose_from_lines(
                gen, lines, aligned, points, thresh, nh)
            total_trials += nh
            num = int(r.num_inliers)
            if bool(r.success) and (res is None or num > best_inliers):
                res, best_inliers = r, num
            if res is not None:
                needed = ransac.num_trials_needed(best_inliers, n, 6)
                if total_trials >= min(needed, MAX_POSE_TRIALS):
                    break
        if res is None or best_inliers < options.abs_pose_min_num_inliers:
            return False

        q1, t1 = p6l.refine_absolute_pose_from_lines(
            res.qvec, res.tvec, lines, points, res.inlier_mask, cam.model,
            f(cam.params))
        q1 = q1.cpu().numpy().astype(np.float64)
        t1 = t1.cpu().numpy().astype(np.float64)
        if not (np.isfinite(q1).all() and np.isfinite(t1).all()):
            return False
        img.qvec = q1
        img.tvec = t1
        self.rec.register_image(image_id)
        self._register_image_event(image_id)

        # Continue the inlier tracks.
        inlier_mask = res.inlier_mask.cpu().numpy()
        for (line_idx, pid), inl in zip(corrs.tolist(), inlier_mask):
            if inl and img.point3d_ids[line_idx] < 0 \
                    and pid in self.rec.points3d:
                self.rec.add_observation(pid, image_id, line_idx)
                self.triangulator.modified_point3d_ids.add(pid)
        return True

    def _focal_search(self, options: MapperOptions, image_id: int,
                      corrs: np.ndarray) -> None:
        """Pick the focal factor with the best P6L RANSAC support
        (reference ``incremental_mapper.py:553-629``, after
        ``incremental_mapper.cc:668-714``): ``num_focal_length_samples``
        geometric factors s within the focal-ratio band act on the lifted
        lines as (a, b, c / s) with thresholds ``abs_pose_max_error /
        (s f0)``, all scored in one batch of max(256, num_hypotheses / 4)
        hypotheses on shared draws.  The first best factor, when it has
        ``abs_pose_min_num_inliers`` inliers and is not 1, is baked into
        the camera and the lines of every image of the camera."""
        img = self.rec.images[image_id]
        cam = self.rec.cameras[img.camera_id]
        S = options.num_focal_length_samples
        f0 = cam.mean_focal_length()
        max_dim = max(cam.width, cam.height)
        lo = options.min_focal_length_ratio * max_dim / f0
        hi = options.max_focal_length_ratio * max_dim / f0
        scales = np.geomspace(max(lo, 0.05), min(hi, 20.0), S)
        cand = np.repeat(img.lines[corrs[:, 0]][None], S, axis=0)
        cand[:, :, 2] /= scales[:, None]

        def f(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=self.device, dtype=self.dtype)

        gen = torch.Generator().manual_seed(
            int(self._rng.integers(0, 2 ** 31)))
        res = p6l.estimate_pose_candidates(
            gen, f(cand),
            torch.from_numpy(img.aligned[corrs[:, 0]]).to(self.device),
            f(np.stack([self.rec.points3d[int(p)].xyz for p in corrs[:, 1]])),
            f(options.abs_pose_max_error / (scales * f0)),
            max(256, options.num_hypotheses // 4))
        inl = np.where(res.success.cpu().numpy(),
                       res.num_inliers.cpu().numpy(), -1)
        best = int(np.argmax(inl))
        if inl[best] < options.abs_pose_min_num_inliers:
            return  # keep the heuristic focal; registration decides
        s_best = float(scales[best])
        if abs(s_best - 1.0) < 1e-6:
            return
        new = np.asarray(cam.params, float).copy()
        for fi in cam_ops.MODELS[cam.model].focal_idxs:
            new[fi] *= s_best
        self._bake_intrinsics(cam.camera_id, new)
        self.focal_searches.append((image_id, f0, f0 * s_best,
                                    int(inl[best])))
        print(f"  => Focal search: {f0:.1f} -> {f0 * s_best:.1f} "
              f"({inl[best]} inliers)")

    def _bake_intrinsics(self, camera_id: int, params: np.ndarray) -> None:
        """Set the camera's params and move the lines of every image of
        the camera to their normalized plane (``ba_intrinsics.
        correct_lines``), then drop the triangulator's line table."""
        cam = self.rec.cameras[camera_id]
        old = np.asarray(cam.params, float)
        for img in self.rec.images.values():
            if img.camera_id == camera_id and len(img.lines):
                img.lines = ba_intr.correct_lines(img.lines, old, params,
                                                  cam.model)
        cam.params = np.asarray(params, float)
        self.triangulator.lines_changed()

    # -- triangulation wrappers -----------------------------------------

    def triangulate_image(self, tri_options: TriangulatorOptions,
                          image_id: int) -> int:
        with self._phase("triangulate"):
            return self.triangulator.triangulate_image(tri_options,
                                                       image_id)

    def complete_tracks(self, tri_options: TriangulatorOptions) -> int:
        with self._phase("triangulate"):
            return self.triangulator.complete_all_tracks(tri_options)

    def merge_tracks(self, tri_options: TriangulatorOptions) -> int:
        with self._phase("triangulate"):
            return self.triangulator.merge_all_tracks(tri_options)

    # -- bundle adjustment ------------------------------------------------

    def find_local_bundle(self, options: MapperOptions,
                          image_id: int) -> List[int]:
        """Up to ``local_ba_num_images - 1`` images sharing the most points
        with ``image_id``, under the 8-step relaxing (triangulation angle,
        overlap) schedule with the 75th-percentile angle of the shared
        points (``incremental_mapper.cc:993-1160``)."""
        img = self.rec.images[image_id]
        shared: Dict[int, int] = {}
        pids = [int(p) for p in img.point3d_ids if p >= 0]
        for pid in pids:
            for iid, _ in self.rec.points3d[pid].track:
                if iid != image_id:
                    shared[iid] = shared.get(iid, 0) + 1
        overlapping = sorted(shared.items(), key=lambda kv: -kv[1])
        num_eff = min(options.local_ba_num_images - 1, len(overlapping))
        if len(overlapping) == num_eff:
            return [iid for iid, _ in overlapping]

        min_tri = np.deg2rad(options.local_ba_min_tri_angle)
        num_points = img.num_points3d()
        schedule = [(min_tri / 1.0, 0.6 * num_points),
                    (min_tri / 1.5, 0.6 * num_points),
                    (min_tri / 2.0, 0.5 * num_points),
                    (min_tri / 2.5, 0.4 * num_points),
                    (min_tri / 3.0, 0.3 * num_points),
                    (min_tri / 4.0, 0.2 * num_points),
                    (min_tri / 5.0, 0.1 * num_points),
                    (min_tri / 6.0, 0.1 * num_points)]
        center = img.projection_center()
        shared_xyz = np.stack([self.rec.points3d[pid].xyz for pid in pids]) \
            if pids else np.zeros((0, 3))
        local: List[int] = []
        used: Set[int] = set()
        tri_angles: Dict[int, float] = {}
        for ang_th, overlap_th in schedule:
            for iid, count in overlapping:
                if count < overlap_th:
                    break
                if iid in used:
                    continue
                if iid not in tri_angles:
                    angs = lines_np.triangulation_angle(
                        center, self.rec.images[iid].projection_center(),
                        shared_xyz)
                    tri_angles[iid] = float(np.percentile(angs, 75)) \
                        if len(angs) else 0.0
                if tri_angles[iid] >= ang_th:
                    local.append(iid)
                    used.add(iid)
                    if len(local) >= num_eff:
                        break
            if len(local) >= num_eff:
                break
        if len(local) < num_eff:
            for iid, _ in overlapping:
                if iid not in used:
                    local.append(iid)
                    used.add(iid)
                    if len(local) >= num_eff:
                        break
        return local

    def adjust_local_bundle(self, options: MapperOptions,
                            ba_options: ba_mod.BAOptions,
                            tri_options: TriangulatorOptions,
                            image_id: int,
                            point3d_ids: Set[int]) -> Dict[str, int]:
        """Local BA around ``image_id`` (``incremental_mapper.cc:
        781-888``): the local bundle's poses, with the last image's pose
        fixed and the second to last's x translation (or, with one bundle
        image, that image's pose and ``image_id``'s x translation); the
        modified points with error < 0 or track <= 15 variable, every
        other image observing them frozen.  Then merge and complete the
        variable points, complete the image, and filter the points of the
        bundle's images and ``point3d_ids``.  Returns the counts of
        merged, completed, filtered and adjusted observations."""
        report = {"merged": 0, "completed": 0, "filtered": 0,
                  "adjusted": 0}
        local_bundle = self.find_local_bundle(options, image_id)
        if local_bundle:
            with self._phase("local_ba"):
                config_images = [image_id] + local_bundle
                if len(local_bundle) == 1:
                    const_pose = {local_bundle[0]}
                    const_tvec_x = {image_id}
                else:
                    const_pose = {local_bundle[-1]}
                    const_tvec_x = {local_bundle[-2]}
                variable_points = {
                    pid for pid in point3d_ids
                    if pid in self.rec.points3d and (
                        self.rec.points3d[pid].error < 0
                        or len(self.rec.points3d[pid].track)
                        <= LOCAL_BA_MAX_TRACK)}
                _, report["adjusted"] = self._run_ba(
                    config_images, const_pose, const_tvec_x,
                    variable_points, ba_options)
                report["merged"] = self.triangulator.merge_tracks(
                    tri_options, variable_points)
                report["completed"] = self.triangulator.complete_tracks(
                    tri_options, variable_points)
                report["completed"] += self.triangulator.complete_image(
                    tri_options, image_id)
        with self._phase("filter"):
            filter_pids: Set[int] = set()
            for iid in [image_id] + local_bundle:
                img = self.rec.images.get(iid)
                if img is not None:
                    filter_pids.update(int(p) for p in img.point3d_ids
                                       if p >= 0)
            filter_pids.update(p for p in point3d_ids
                               if p in self.rec.points3d)
            report["filtered"] = self.rec.filter_points3d(
                options.filter_max_reproj_error,
                options.filter_min_tri_angle, filter_pids)
        return report

    def adjust_global_bundle(self, options: MapperOptions,
                             ba_options: ba_mod.BAOptions) -> bool:
        """Global BA with the first image's pose and the second's x
        translation fixed, then Normalize (``incremental_mapper.cc:
        893-939``)."""
        reg = list(self.rec.reg_image_ids)
        if len(reg) < 2:
            raise ValueError("global bundle adjustment needs >= 2 images")
        with self._phase("global_ba"):
            self.rec.filter_observations_with_negative_depth()
            ok, _ = self._run_ba(reg, {reg[0]}, {reg[1]}, None, ba_options)
            self.rec.normalize()
        return ok

    def _run_ba(self, config_images: Sequence[int], const_pose: Set[int],
                const_tvec_x: Set[int], variable_points: Optional[Set[int]],
                ba_options: ba_mod.BAOptions) -> Tuple[bool, int]:
        """Assemble the BA problem (``assemble_ba``) and solve it on the
        route of ``choose_ba_route``, recorded in ``last_route``; write
        back the cameras with free dofs and the points with
        ``point_mask`` > 0.  With any ``refine_*`` option set the problem
        goes to ``_run_ba_intrinsics`` instead.  Where ``PPSFM_BA_LOG``
        names a file, one line per solve, of either route, is appended to
        it (as the reference's ``_run_ba`` does for its routes): route, C,
        P, K (0 on the flat and intrinsics routes), O, seconds from the
        assembled problem to the written-back result, LM iterations,
        observations.  Returns (solved, observations)."""
        t_start = time.perf_counter()
        asm = self.assemble_ba(config_images, const_pose, const_tvec_x,
                               variable_points)
        if asm is None:
            return False, 0
        if (ba_options.refine_focal_length
                or ba_options.refine_principal_point
                or ba_options.refine_extra_params):
            return self._run_ba_intrinsics(asm, ba_options, t_start)
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
        self.last_route = route
        out = self._write_back(asm, q, t, X, summary, t_start, t_assembled)
        self._log_ba(asm, summary, t_assembled,
                     0 if route.solver == "flat" else dense.obs_cam.shape[1])
        return out

    def _log_ba(self, asm: BAAssembly, summary, t_assembled: float,
                K: int):
        """Append the solve's line to the file ``PPSFM_BA_LOG`` names."""
        ba_log = os.environ.get("PPSFM_BA_LOG")
        if ba_log:
            with open(ba_log, "a") as f:
                f.write(f"{self.last_route.solver} C={len(asm.cam_list)} "
                        f"P={asm.problem.points3d.shape[0]} K={K} "
                        f"O={asm.problem.obs_cam.shape[0]} "
                        f"solve_s={time.perf_counter() - t_assembled:.3f} "
                        f"iters={int(summary.num_iterations)} "
                        f"nobs={len(asm.obs)}\n")

    def _write_back(self, asm: BAAssembly, q, t, X, summary, t_start: float,
                    t_assembled: float, finite: bool = True
                    ) -> Tuple[bool, int]:
        """Record a solve's times and summary, and write back its free
        cameras and variable points when they (and, with ``finite``
        False, the rest of the solve) are finite."""
        q, t, X = (a.cpu().numpy().astype(np.float64) for a in (q, t, X))
        t_solved = time.perf_counter()
        for k, v in (("ba_assemble", t_assembled - t_start),
                     ("ba_solve", t_solved - t_assembled)):
            self.phase_times[k] = self.phase_times.get(k, 0.0) + v
        self.last_summary = summary
        num_obs = len(asm.obs)
        if not (finite and np.isfinite(q).all() and np.isfinite(t).all()
                and np.isfinite(X).all()):
            return False, num_obs
        rec = self.rec
        for i, iid in enumerate(asm.cam_list):
            if asm.dof_mask[i].any():
                rec.images[iid].qvec = q[i]
                rec.images[iid].tvec = t[i]
        for pid, slot in asm.point_index.items():
            if asm.point_mask[slot] > 0:
                rec.points3d[pid].xyz = X[slot]
        return True, num_obs

    def _run_ba_intrinsics(self, asm: BAAssembly,
                           ba_options: ba_mod.BAOptions,
                           t_start: float) -> Tuple[bool, int]:
        """The variable-intrinsics solve (``optim/ba_intrinsics``,
        reference ``incremental_mapper.py:1093-1166``): one unique camera
        per camera id, in slot order, with the ``refine_*`` subsets
        variable (``ba_intrinsics.from_flat_problem``); on a finite result
        the free poses and variable points are written back and, for each
        refined camera whose params moved, the correction is baked into
        its params and the lines of every image of the camera.
        ``last_route`` is ("intrinsics", False)."""
        rec = self.rec
        cam_ids: List[int] = []  # unique camera ids, slot order
        cam_of_slot = np.zeros(len(asm.cam_list), np.int64)
        for i, iid in enumerate(asm.cam_list):
            cid = rec.images[iid].camera_id
            if cid not in cam_ids:
                cam_ids.append(cid)
            cam_of_slot[i] = cam_ids.index(cid)
        intr = np.stack([rec.cameras[cid].params for cid in cam_ids])
        refined = ba_intr.intr_mask_for_model(
            asm.camera_model, ba_options.refine_focal_length,
            ba_options.refine_principal_point,
            ba_options.refine_extra_params).any()
        problem = ba_intr.from_flat_problem(
            asm.problem, asm.camera_model, cam_of_slot, intr, ba_options)
        t_assembled = time.perf_counter()
        q, t, X, intr_new, summary = ba_intr.bundle_adjust_intrinsics(
            problem, asm.camera_model, ba_options)
        self.last_route = BARoute("intrinsics", False)
        intr_new = intr_new.cpu().numpy().astype(np.float64)
        ok, num_obs = self._write_back(asm, q, t, X, summary, t_start,
                                       t_assembled,
                                       bool(np.isfinite(intr_new).all()))
        self._log_ba(asm, summary, t_assembled, 0)
        if not ok:
            return ok, num_obs
        for u, cid in enumerate(cam_ids):
            if refined and \
                    not np.allclose(rec.cameras[cid].params, intr_new[u]):
                self._bake_intrinsics(cid, intr_new[u])
        return True, num_obs

    def assemble_ba(self, config_images: Sequence[int], const_pose: Set[int],
                    const_tvec_x: Set[int],
                    variable_points: Optional[Set[int]] = None
                    ) -> Optional[BAAssembly]:
        """The flat BA problem on the mapper's device in its dtype: every
        observation of the points ``config_images`` observe, and, for a
        local BA (``variable_points`` given), every observation of the
        variable points from the other images, which join as frozen
        cameras; points outside ``variable_points`` are frozen
        (``incremental_mapper.cc:857-867, 921-942``).  Frozen poses:
        ``const_pose``; frozen x translation: ``const_tvec_x``.  None when
        there is too little to adjust."""
        rec = self.rec
        config_set = set(config_images)
        obs: List[Tuple[int, int, int]] = []  # (image_id, line_idx, pid)
        point_ids: List[int] = []
        point_index: Dict[int, int] = {}

        def point_slot(pid: int):
            if pid not in point_index:
                point_index[pid] = len(point_ids)
                point_ids.append(pid)

        for iid in config_images:
            img = rec.images[iid]
            for li in np.nonzero(img.point3d_ids >= 0)[0]:
                pid = int(img.point3d_ids[li])
                point_slot(pid)
                obs.append((iid, int(li), pid))
        extra_images: List[int] = []
        if variable_points is not None:
            for pid in variable_points:
                if pid not in rec.points3d:
                    continue
                point_slot(pid)
                for iid, li in rec.points3d[pid].track:
                    if iid not in config_set:
                        if iid not in extra_images:
                            extra_images.append(iid)
                        obs.append((iid, li, pid))
        if len(obs) < 6 or len(point_ids) == 0:
            return None
        obs = _cap_track_length(obs)

        cam_list = list(config_images) + extra_images
        C = len(cam_list)
        cam_index = {iid: i for i, iid in enumerate(cam_list)}
        camera0 = rec.cameras[rec.images[cam_list[0]].camera_id]
        qvecs = np.zeros((C, 4))
        tvecs = np.zeros((C, 3))
        cam_params = np.zeros((C, len(camera0.params)))
        dof_mask = np.ones((C, 6))
        extra = set(extra_images)
        for i, iid in enumerate(cam_list):
            img = rec.images[iid]
            qvecs[i] = img.qvec
            tvecs[i] = img.tvec
            cam_params[i] = rec.cameras[img.camera_id].params
            if iid in const_pose or iid in extra:
                dof_mask[i] = 0.0
            elif iid in const_tvec_x:
                dof_mask[i, 3] = 0.0
        points3d = np.stack([rec.points3d[pid].xyz for pid in point_ids])
        point_mask = np.ones(len(point_ids))
        if variable_points is not None:
            for pid, slot in point_index.items():
                if pid not in variable_points:
                    point_mask[slot] = 0.0
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
            cam_dof_mask=f(dof_mask), point_mask=f(point_mask))
        return BAAssembly(problem, camera0.model, cam_list, point_index,
                          dof_mask, point_mask, obs)

    # -- filtering -------------------------------------------------------

    def filter_images(self, options: MapperOptions) -> int:
        """Deregister images with no points or bogus cameras, once 20 or
        more are registered (``incremental_mapper.cc:1173-1186``)."""
        if self.rec.num_registered() < FILTER_IMAGES_MIN_REG:
            return 0
        with self._phase("filter"):
            filtered = self.rec.filter_images(
                options.min_focal_length_ratio,
                options.max_focal_length_ratio, options.max_extra_param)
            for iid in filtered:
                self._deregister_image_event(iid)
            self.filtered_images.update(filtered)
        return len(filtered)

    def filter_points(self, options: MapperOptions) -> int:
        with self._phase("filter"):
            return self.rec.filter_points3d(options.filter_max_reproj_error,
                                            options.filter_min_tri_angle)


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
