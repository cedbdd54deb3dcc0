"""Configuration tree: dataclass options + .ini project files + presets.

Copy of ``privacy_preserving_sfm_tpu/utils/config.py`` over the port's
own ``SiftOptions``, ``ControllerOptions``, ``MapperOptions`` and
``TriangulatorOptions``; it writes and reads the same ``project.ini``.
Twin of ``src/util/option_manager.{h,cc}`` (boost::program_options): one
root object aggregating every module's options, save/load as .ini project
files (section per module), and the quality/data preset transforms
(``option_manager.cc:79-129``).
"""

from __future__ import annotations

import configparser
import dataclasses
import math

from privacy_preserving_sfm_torch.features.sift import SiftOptions
from privacy_preserving_sfm_torch.sfm.controller import ControllerOptions


@dataclasses.dataclass
class ExtractionOptions:
    """Pipeline-level extraction settings (``sift.h:45-114`` +
    ``extraction.cc``)."""

    max_image_size: int = 3200
    aligned_line_ratio: float = 0.5
    sift: SiftOptions = dataclasses.field(default_factory=SiftOptions)


@dataclasses.dataclass
class MatchingOptions:
    """``SiftMatchingOptions`` (``sift.h:117-144``) + scheduler settings."""

    max_ratio: float = 0.8
    max_distance: float = 0.7
    cross_check: bool = True
    max_num_matches: int = 32768
    min_num_matches: int = 15  # pairs below this are zeroed
    block_size: int = 50  # exhaustive scheduler
    overlap: int = 10  # sequential scheduler
    quadratic_overlap: bool = True


@dataclasses.dataclass
class AllOptions:
    database_path: str = ""
    image_path: str = ""
    extraction: ExtractionOptions = dataclasses.field(
        default_factory=ExtractionOptions)
    matching: MatchingOptions = dataclasses.field(
        default_factory=MatchingOptions)
    controller: ControllerOptions = dataclasses.field(
        default_factory=ControllerOptions)

    # -- quality presets (option_manager.cc:79-129) ----------------------

    def modify_for_individual_data(self):
        self.controller.mapper.min_focal_length_ratio = 0.1
        self.controller.mapper.max_focal_length_ratio = 10
        self.controller.mapper.max_extra_param = math.inf

    def modify_for_video_data(self):
        self.controller.mapper.init_min_tri_angle /= 2
        self.controller.ba_global_images_ratio = 1.4
        self.controller.ba_global_points_ratio = 1.4
        self.controller.mapper.min_focal_length_ratio = 0.1
        self.controller.mapper.max_focal_length_ratio = 10
        self.controller.mapper.max_extra_param = math.inf

    def modify_for_low_quality(self):
        self.extraction.max_image_size = 1000
        c = self.controller
        c.ba_local_max_num_iterations //= 2
        c.ba_global_max_num_iterations //= 2
        c.ba_global_images_ratio *= 1.2
        c.ba_global_points_ratio *= 1.2
        c.ba_global_max_refinements = 2

    def modify_for_medium_quality(self):
        self.extraction.max_image_size = 1600
        c = self.controller
        c.ba_local_max_num_iterations = int(c.ba_local_max_num_iterations / 1.5)
        c.ba_global_max_num_iterations = int(
            c.ba_global_max_num_iterations / 1.5)
        c.ba_global_images_ratio *= 1.1
        c.ba_global_points_ratio *= 1.1
        c.ba_global_max_refinements = 2

    def modify_for_high_quality(self):
        self.extraction.max_image_size = 2400
        c = self.controller
        c.ba_local_max_num_iterations = 30
        c.ba_local_max_refinements = 3
        c.ba_global_max_num_iterations = 75

    def modify_for_extreme_quality(self):
        c = self.controller
        c.ba_local_max_num_iterations = 40
        c.ba_local_max_refinements = 3
        c.ba_global_max_num_iterations = 100

    def apply_quality_preset(self, quality: str):
        quality = quality.lower()
        if quality == "low":
            self.modify_for_low_quality()
        elif quality == "medium":
            self.modify_for_medium_quality()
        elif quality == "high":
            self.modify_for_high_quality()
        elif quality == "extreme":
            self.modify_for_extreme_quality()
        else:
            raise ValueError(f"unknown quality preset {quality}")

    # -- project .ini save/load ------------------------------------------

    _SECTIONS = {
        "Extraction": ("extraction",
                       ["max_image_size", "aligned_line_ratio"]),
        "Matching": ("matching",
                     ["max_ratio", "max_distance", "cross_check",
                      "max_num_matches", "min_num_matches", "block_size",
                      "overlap", "quadratic_overlap"]),
        "Mapper": ("controller",
                   ["min_num_matches", "multiple_models", "max_num_models",
                    "max_model_overlap", "min_model_size", "init_num_trials",
                    "ba_local_num_images", "ba_local_max_num_iterations",
                    "ba_global_images_ratio", "ba_global_points_ratio",
                    "ba_global_images_freq", "ba_global_points_freq",
                    "ba_global_max_num_iterations",
                    "ba_local_max_refinements",
                    "ba_local_max_refinement_change",
                    "ba_global_max_refinements",
                    "ba_global_max_refinement_change"]),
    }

    def save(self, path: str):
        cp = configparser.ConfigParser()
        cp["Project"] = {"database_path": self.database_path,
                         "image_path": self.image_path}
        for section, (attr, fields) in self._SECTIONS.items():
            obj = getattr(self, attr)
            cp[section] = {f: str(getattr(obj, f)) for f in fields}
        with open(path, "w") as f:
            cp.write(f)

    @classmethod
    def load(cls, path: str) -> "AllOptions":
        cp = configparser.ConfigParser()
        cp.read(path)
        opts = cls()
        if "Project" in cp:
            opts.database_path = cp["Project"].get("database_path", "")
            opts.image_path = cp["Project"].get("image_path", "")
        for section, (attr, fields) in cls._SECTIONS.items():
            if section not in cp:
                continue
            obj = getattr(opts, attr)
            for f in fields:
                if f not in cp[section]:
                    continue
                cur = getattr(obj, f)
                raw = cp[section][f]
                if isinstance(cur, bool):
                    setattr(obj, f, raw.lower() in ("1", "true", "yes"))
                elif isinstance(cur, int):
                    setattr(obj, f, int(float(raw)))
                elif isinstance(cur, float):
                    setattr(obj, f, float(raw))
                else:
                    setattr(obj, f, raw)
        return opts
