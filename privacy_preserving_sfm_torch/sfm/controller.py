"""Incremental mapping controller: the outer reconstruction loop.

Port of ``privacy_preserving_sfm_tpu/sfm/controller.py`` (host code over
``src/controllers/incremental_mapper.{h,cc}``):

  * ``run``: the initialization relaxation loop (halve
    init_min_num_inliers, then halve init_min_tri_angle, twice)
    (``:285-314``);
  * ``reconstruct``: init -> global BA -> the register / triangulate /
    local-BA loop with ratio-triggered global refinement, one rescue
    refinement, the model-overlap bound and multiple models
    (``:382-591``);
  * ``iterative_local_refinement``: <= ba_local_max_refinements rounds,
    soft-L1 loss on the first round only (``:72-100``);
  * ``iterative_global_refinement``: complete + merge, then <= 5 rounds of
    (global BA, complete + merge, filter) until the changed-observation
    fraction drops below 0.0005 (``:102-124``).

The mapper runs on the controller's ``device`` in its ``dtype``.  The
reference's periodic drop of compiled executables
(``_maybe_trim_device_caches``) has no counterpart here.  Defaults: ``controllers/incremental_mapper.h:
44-120``.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from privacy_preserving_sfm_torch.models.database import Database
from privacy_preserving_sfm_torch.models.database_cache import DatabaseCache
from privacy_preserving_sfm_torch.models.reconstruction import Reconstruction
from privacy_preserving_sfm_torch.optim import ba as ba_mod
from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
    IncrementalMapper, MapperOptions,
)
from privacy_preserving_sfm_torch.sfm.incremental_triangulator import (
    TriangulatorOptions,
)
from privacy_preserving_sfm_torch.utils.timer import PhaseProfiler

# Registered images below which both BAs run twice the iterations at a
# tenth of the tolerances (``controllers/incremental_mapper.cc:55-66``).
SMALL_MODEL_IMAGES = 10


@dataclasses.dataclass
class ControllerOptions:
    """``IncrementalMapperOptions`` (``controllers/incremental_mapper.h``)."""

    min_num_matches: int = 15
    multiple_models: bool = True
    max_num_models: int = 50
    max_model_overlap: int = 20
    min_model_size: int = 10
    init_num_trials: int = 200
    ba_local_num_images: int = 6
    ba_local_max_num_iterations: int = 25
    ba_global_images_ratio: float = 1.1
    ba_global_points_ratio: float = 1.1
    ba_global_images_freq: int = 500
    ba_global_points_freq: int = 250000
    ba_global_max_num_iterations: int = 50
    ba_local_max_refinements: int = 2
    ba_local_max_refinement_change: float = 0.001
    ba_global_max_refinements: int = 5
    ba_global_max_refinement_change: float = 0.0005
    # Intrinsics refinement (controllers/incremental_mapper.h:79-83), all
    # off: the lift bakes the calibration into the lines.  Setting one
    # sends every BA to optim/ba_intrinsics, and the focal one turns on
    # the mapper's focal search (``run``).
    ba_refine_focal_length: bool = False
    ba_refine_principal_point: bool = False
    ba_refine_extra_params: bool = False
    snapshot_path: str = ""
    snapshot_images_freq: int = 0
    mapper: MapperOptions = dataclasses.field(default_factory=MapperOptions)
    triangulation: TriangulatorOptions = dataclasses.field(
        default_factory=TriangulatorOptions)
    verbose: bool = True

    def local_ba_options(self) -> ba_mod.BAOptions:
        # function_tolerance 0 and gradient_tolerance 10: the reference's
        # local-BA termination (controllers/incremental_mapper.cc:199-203).
        return ba_mod.BAOptions(
            max_iterations=self.ba_local_max_num_iterations,
            loss="soft_l1", loss_scale=1.0,
            function_tolerance=0.0, gradient_tolerance=10.0,
            refine_focal_length=self.ba_refine_focal_length,
            refine_principal_point=self.ba_refine_principal_point,
            refine_extra_params=self.ba_refine_extra_params)

    def global_ba_options(self) -> ba_mod.BAOptions:
        return ba_mod.BAOptions(
            max_iterations=self.ba_global_max_num_iterations,
            loss="trivial",
            function_tolerance=0.0, gradient_tolerance=1.0,
            refine_focal_length=self.ba_refine_focal_length,
            refine_principal_point=self.ba_refine_principal_point,
            refine_extra_params=self.ba_refine_extra_params)


def _strict_for_small_models(ba_options: ba_mod.BAOptions,
                             mapper: IncrementalMapper) -> ba_mod.BAOptions:
    """Below 10 registered images: 2x iterations, tolerances / 10
    (``controllers/incremental_mapper.cc:55-66``)."""
    if mapper.rec.num_registered() >= SMALL_MODEL_IMAGES:
        return ba_options
    return ba_options._replace(
        max_iterations=ba_options.max_iterations * 2,
        function_tolerance=ba_options.function_tolerance / 10,
        gradient_tolerance=ba_options.gradient_tolerance / 10)


class IncrementalMapperController:
    """Drives reconstructions from a database (or prebuilt caches) on
    ``device`` in ``dtype``."""

    def __init__(self, options: ControllerOptions,
                 database_path: Optional[str] = None,
                 database_cache: Optional[DatabaseCache] = None,
                 aligned_cache: Optional[DatabaseCache] = None,
                 input_reconstruction: Optional[Reconstruction] = None, *,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        self.options = options
        self.database_path = database_path
        self.database_cache = database_cache
        self.aligned_cache = aligned_cache
        self.device = torch.device(device)
        self.dtype = dtype
        self.reconstructions: List[Reconstruction] = []
        # Resume (mapper --input_path, ppsfm.cc:392-399): a model whose
        # poses and points seed the first reconstruction attempt.
        self.input_reconstruction = input_reconstruction
        self.profiler = PhaseProfiler()
        self._snapshot_prev_num = 0

    def _log(self, msg: str):
        if self.options.verbose:
            print(msg, flush=True)

    def load_database(self) -> bool:
        """The full cache and the aligned cache (``LoadDatabase``,
        ``:316-380``): the aligned cache keeps the images that have
        aligned lines (hence gravity), loaded with min_num_matches 4."""
        if self.database_cache is not None:
            return len(self.database_cache.images) > 0
        with Database(self.database_path) as db:
            self.database_cache = DatabaseCache.load(
                db, self.options.min_num_matches)
            aligned_names = {
                img.name for img in self.database_cache.images.values()
                if img.aligned.any()}
            self.aligned_cache = DatabaseCache.load(
                db, 4, image_names=aligned_names)
        return len(self.database_cache.images) > 0

    def run(self) -> List[Reconstruction]:
        if not self.load_database():
            self._log("WARNING: no images with matches found")
            return []
        # The reference's Mapper() factory: focal refinement at
        # registration follows the BA flag (incremental_mapper.cc:176).
        if self.options.ba_refine_focal_length:
            self.options.mapper.abs_pose_refine_focal_length = True
        init_options = copy.deepcopy(self.options.mapper)
        self.reconstruct(init_options)
        for _ in range(2):
            if self.reconstructions:
                break
            self._log("=> Relaxing the initialization constraints.")
            init_options.init_min_num_inliers //= 2
            self.reconstruct(init_options)
            if self.reconstructions:
                break
            self._log("=> Relaxing the initialization constraints.")
            init_options.init_min_tri_angle /= 2
            self.reconstruct(init_options)
        return self.reconstructions

    # -- refinement loops ------------------------------------------------

    def iterative_local_refinement(self, mapper: IncrementalMapper,
                                   image_id: int):
        ba_options = _strict_for_small_models(
            self.options.local_ba_options(), mapper)
        for _ in range(self.options.ba_local_max_refinements):
            report = mapper.adjust_local_bundle(
                self.options.mapper, ba_options, self.options.triangulation,
                image_id, set(mapper.triangulator.modified_point3d_ids))
            # The denominator is the bundle's observations
            # (controllers/incremental_mapper.cc:86-90).
            num_adjusted = max(1, report["adjusted"])
            changed = (report["merged"] + report["completed"]
                       + report["filtered"]) / num_adjusted
            if changed < self.options.ba_local_max_refinement_change:
                break
            # Robust loss on the first refinement round only.
            ba_options = ba_options._replace(loss="trivial")
        mapper.triangulator.modified_point3d_ids.clear()
        self._fold_mapper_phases(mapper, "local_refine")

    def _fold_mapper_phases(self, mapper: IncrementalMapper, prefix: str):
        """Fold the mapper's and the triangulator's phase times into the
        profile as ``prefix/name`` and reset them."""
        for k, v in list(mapper.phase_times.items()) \
                + list(mapper.triangulator.phase_times.items()):
            self.profiler.totals[f"{prefix}/{k}"] += v
            self.profiler.counts[f"{prefix}/{k}"] += 1
        mapper.phase_times.clear()
        mapper.triangulator.phase_times.clear()

    def iterative_global_refinement(self, mapper: IncrementalMapper):
        self._fold_mapper_phases(mapper, "other")
        self._complete_and_merge(mapper)
        try:
            for _ in range(self.options.ba_global_max_refinements):
                num_obs = max(1, mapper.rec.num_observations())
                mapper.adjust_global_bundle(
                    self.options.mapper, _strict_for_small_models(
                        self.options.global_ba_options(), mapper))
                changed = self._complete_and_merge(mapper)
                changed += mapper.filter_points(self.options.mapper)
                if changed / num_obs < \
                        self.options.ba_global_max_refinement_change:
                    break
            mapper.filter_images(self.options.mapper)
        finally:
            self._fold_mapper_phases(mapper, "global_refine")

    def _complete_and_merge(self, mapper: IncrementalMapper) -> int:
        n = mapper.complete_tracks(self.options.triangulation)
        n += mapper.merge_tracks(self.options.triangulation)
        return n

    def _seed_from_input(self, rec: Reconstruction,
                         input_rec: Reconstruction):
        """Copy poses, registrations and points from a resumed model."""
        for iid, img_in in input_rec.images.items():
            if iid in rec.images and img_in.registered:
                img = rec.images[iid]
                img.qvec = np.array(img_in.qvec)
                img.tvec = np.array(img_in.tvec)
                rec.register_image(iid)
        for pt in input_rec.points3d.values():
            track = [(iid, li) for iid, li in pt.track
                     if iid in rec.images
                     and li < rec.images[iid].num_lines
                     and rec.images[iid].point3d_ids[li] < 0]
            if len(track) >= 2:
                rec.add_point3d(pt.xyz, track)

    def _maybe_snapshot(self, rec: Reconstruction):
        """Timestamped model snapshots every snapshot_images_freq
        registrations (controllers/incremental_mapper.cc:126-140)."""
        if self.options.snapshot_images_freq <= 0 or \
                not self.options.snapshot_path:
            return
        n = rec.num_registered()
        if n >= self._snapshot_prev_num + self.options.snapshot_images_freq:
            self._snapshot_prev_num = n
            path = os.path.join(self.options.snapshot_path,
                                str(int(time.time() * 1000)))
            rec.write_text(path)
            self._log(f"  => Snapshot written to {path}")

    # -- main reconstruction loop ---------------------------------------

    def _global_refinement_due(self, rec, prev_num_reg,
                               prev_num_points) -> bool:
        o = self.options
        n_reg, n_pts = rec.num_registered(), len(rec.points3d)
        return (n_reg >= o.ba_global_images_ratio * prev_num_reg
                or n_reg >= o.ba_global_images_freq + prev_num_reg
                or n_pts >= o.ba_global_points_ratio * prev_num_points
                or n_pts >= o.ba_global_points_freq + prev_num_points)

    def reconstruct(self, init_mapper_options: MapperOptions):
        # One mapper across all model attempts: its cross-model
        # registration counts drive the max_model_overlap bound and the
        # all-images-covered stop (controllers/incremental_mapper.cc:
        # 388-390, 536-540, 585-589).
        mapper = IncrementalMapper(self.device, self.dtype,
                                   self.database_cache)
        for num_trials in range(self.options.init_num_trials):
            rec = self.database_cache.to_reconstruction()
            # Fresh mutable image state per attempt.
            for img in rec.images.values():
                img.registered = False
                img.point3d_ids = np.full(img.num_lines, -1, np.int64)
            rec.reg_image_ids = []
            if num_trials == 0 and self.input_reconstruction is not None:
                self._seed_from_input(rec, self.input_reconstruction)
            mapper.begin_reconstruction(rec)
            init_mapper_options.seed = (init_mapper_options.seed or 0) \
                + num_trials

            with self.profiler.phase("init"):
                init_ok = (rec.num_registered() > 0
                           or mapper.register_initial_line_images(
                               init_mapper_options, self.aligned_cache))
            if not init_ok:
                self._log("  => Initialization failed.")
                mapper.end_reconstruction(discard=True)
                break

            self._log(f"  => Initialized with images "
                      f"{rec.reg_image_ids} ({len(rec.points3d)} points)")
            mapper.adjust_global_bundle(
                self.options.mapper, _strict_for_small_models(
                    self.options.global_ba_options(), mapper))
            mapper.filter_points(self.options.mapper)
            mapper.filter_images(self.options.mapper)
            self._fold_mapper_phases(mapper, "init")

            if rec.num_registered() == 0 or len(rec.points3d) == 0:
                mapper.end_reconstruction(discard=True)
                continue

            ba_prev_num_reg = rec.num_registered()
            ba_prev_num_points = len(rec.points3d)
            reg_next_success = True
            prev_reg_next_success = True
            while reg_next_success:
                reg_next_success = False
                next_images = mapper.find_next_images(self.options.mapper)
                if not next_images:
                    break
                for reg_trial, next_image_id in enumerate(next_images):
                    self._log(f"Registering image #{next_image_id} "
                              f"({rec.num_registered() + 1})")
                    with self.profiler.phase("register"):
                        reg_next_success = mapper.register_next_image(
                            self.options.mapper, next_image_id)
                    self._fold_mapper_phases(mapper, "register")
                    if reg_next_success:
                        with self.profiler.phase("triangulate"):
                            mapper.triangulate_image(
                                self.options.triangulation, next_image_id)
                        self._fold_mapper_phases(mapper, "triangulate")
                        with self.profiler.phase("local_refine"):
                            self.iterative_local_refinement(mapper,
                                                            next_image_id)
                        self._maybe_snapshot(rec)
                        if self._global_refinement_due(
                                rec, ba_prev_num_reg, ba_prev_num_points):
                            with self.profiler.phase("global_refine"):
                                self.iterative_global_refinement(mapper)
                            ba_prev_num_reg = rec.num_registered()
                            ba_prev_num_points = len(rec.points3d)
                        break
                    self._log("  => Could not register, trying another.")
                    if (reg_trial >= 30 and rec.num_registered()
                            < self.options.min_model_size):
                        break

                # Bound this model's overlap with earlier models
                # (controllers/incremental_mapper.cc:536-540).
                if mapper.num_shared_reg_images >= \
                        self.options.max_model_overlap:
                    break
                # One global refinement as a rescue before giving up.
                if not reg_next_success and prev_reg_next_success:
                    reg_next_success = True
                    prev_reg_next_success = False
                    with self.profiler.phase("global_refine"):
                        self.iterative_global_refinement(mapper)
                else:
                    prev_reg_next_success = reg_next_success

            # A final global refinement unless the last BA was global.
            if (rec.num_registered() >= 2
                    and rec.num_registered() != ba_prev_num_reg
                    and len(rec.points3d) != ba_prev_num_points):
                with self.profiler.phase("global_refine"):
                    self.iterative_global_refinement(mapper)

            min_model_size = min(len(self.database_cache.images),
                                 self.options.min_model_size)
            discard = (self.options.multiple_models
                       and rec.num_registered() < min_model_size) \
                or rec.num_registered() == 0
            mapper.end_reconstruction(discard)
            if not discard:
                self.reconstructions.append(rec)
            if (not self.options.multiple_models
                    or len(self.reconstructions) >= self.options.max_num_models
                    or mapper.num_total_reg_images
                    >= len(self.database_cache.images) - 1):
                break
        return self.reconstructions
