"""The port's mapper controller on the scenes of
``tests/test_e2e_synthetic.py``, the ``mapper --input_path`` resume and
the ``project.ini`` the port writes.

The three scenes (clean; 1 px of noise with 15 % wrong matches; two
disjoint scenes in one database) and the uncalibrated one (lines lifted
with a 12 %-wrong focal, ``ba_refine_focal_length``) go through the
port's controller on the CPU in float32, the CLI's precision, with that
test's options and against that test's own bars.  The resume (what ``mapper --input_path`` does)
seeds a second run with the clean scene's model read back from text.
The ``project.ini`` files (``project_generator``, every preset) are
byte-compared with the reference package's ``AllOptions.save``.
"""

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.exe import ppsfm as tcli
from privacy_preserving_sfm_torch.models.reconstruction import Reconstruction
from privacy_preserving_sfm_torch.sfm.controller import (
    ControllerOptions, IncrementalMapperController,
)
from privacy_preserving_sfm_torch.sfm.incremental_mapper import MapperOptions
from privacy_preserving_sfm_torch.utils.config import AllOptions
from privacy_preserving_sfm_tpu.utils import config as jconfig

from test_e2e_synthetic import ate_rmse, build_synthetic_db

torch.set_num_threads(2)

# tests/test_e2e_synthetic.py's FAST options.
FAST = dict(min_model_size=4, verbose=False)
FAST_MAPPER = dict(num_hypotheses=512, init_num_samples=256,
                   abs_pose_min_num_inliers=15)


def run_controller(path):
    options = ControllerOptions(mapper=MapperOptions(**FAST_MAPPER), **FAST)
    ctrl = IncrementalMapperController(options, database_path=path,
                                       device="cpu", dtype=torch.float32)
    return ctrl, ctrl.run()


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clean") / "scene.db")
    gt = build_synthetic_db(path, np.random.default_rng(0))
    return path, gt, run_controller(path)


def test_clean_scene(clean):
    _, (qs, ts, _, image_ids), (ctrl, recs) = clean
    rec = max(recs, key=lambda r: r.num_registered())
    assert rec.num_registered() >= 7, rec.num_registered()
    assert len(rec.points3d) >= 40
    assert ate_rmse(rec, qs, ts, image_ids) < 0.05
    assert rec.compute_mean_reprojection_error() < 1.0
    totals = ctrl.profiler.totals
    for name in ("init", "register", "triangulate", "local_refine",
                 "global_refine", "local_refine/local_ba",
                 "global_refine/global_ba", "register/register"):
        assert totals[name] > 0, name


def test_resume_from_a_written_model(clean, tmp_path):
    """``mapper --input_path``: the model read back seeds the first
    attempt, which then needs no initialization."""
    path, (qs, ts, _, image_ids), (_, recs) = clean
    rec0 = max(recs, key=lambda r: r.num_registered())
    rec0.write_text(str(tmp_path / "model"))
    options = ControllerOptions(mapper=MapperOptions(**FAST_MAPPER), **FAST)
    ctrl = IncrementalMapperController(
        options, database_path=path,
        input_reconstruction=Reconstruction.read_text(str(tmp_path /
                                                          "model")),
        device="cpu", dtype=torch.float32)
    recs = ctrl.run()
    assert len(recs) == 1 and "init/init_solve" not in ctrl.profiler.totals
    rec = recs[0]
    assert rec.num_registered() >= rec0.num_registered()
    assert len(rec.points3d) >= 0.9 * len(rec0.points3d)
    assert ate_rmse(rec, qs, ts, image_ids) < 0.05


def test_noisy_scene_with_outliers(tmp_path):
    path = str(tmp_path / "noisy.db")
    qs, ts, _, image_ids = build_synthetic_db(
        path, np.random.default_rng(3), pixel_noise=1.0, outlier_frac=0.15)
    _, recs = run_controller(path)
    rec = max(recs, key=lambda r: r.num_registered())
    assert rec.num_registered() >= 6, rec.num_registered()
    assert ate_rmse(rec, qs, ts, image_ids) < 0.35
    assert rec.compute_mean_reprojection_error() < 2.5


def test_two_disjoint_scenes_give_two_models(tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "two.db")
    build_synthetic_db(path, rng, prefix="a")
    build_synthetic_db(path, rng, prefix="b", center=(40.0, 0.0, 0.0))
    _, recs = run_controller(path)
    assert len(recs) == 2, len(recs)
    reg_sets = [{rec.images[iid].name for iid in rec.reg_image_ids}
                for rec in recs]
    assert not (reg_sets[0] & reg_sets[1])
    assert {n[0] for n in reg_sets[0]} != {n[0] for n in reg_sets[1]}
    assert all(len(s) >= 6 for s in reg_sets), reg_sets


def test_uncalibrated_scene_refines_the_focal(tmp_path):
    """``test_e2e_synthetic.py``'s TestUncalibrated through the port: lines
    lifted with a 12 %-wrong focal (560 for a true 500), the controller
    with ``ba_refine_focal_length`` (every BA on ``ba_intrinsics``, the
    focal search armed), at that test's bars."""
    path = str(tmp_path / "uncal.db")
    qs, ts, _, image_ids = build_synthetic_db(
        path, np.random.default_rng(7), lift_focal=560.0)
    options = ControllerOptions(mapper=MapperOptions(**FAST_MAPPER),
                                ba_refine_focal_length=True, **FAST)
    ctrl = IncrementalMapperController(options, database_path=path,
                                       device="cpu", dtype=torch.float32)
    recs = ctrl.run()
    assert recs and options.mapper.abs_pose_refine_focal_length
    rec = max(recs, key=lambda r: r.num_registered())
    assert rec.num_registered() >= 6, rec.num_registered()
    assert ate_rmse(rec, qs, ts, image_ids) < 0.10
    cam = next(iter(rec.cameras.values()))
    assert abs(cam.params[0] - 500.0) < 15.0, cam.params


@pytest.mark.parametrize("quality", ["", "low", "medium", "high",
                                     "extreme"])
def test_project_ini_bytes_equal_the_reference(tmp_path, quality):
    ours, theirs = tmp_path / "port.ini", tmp_path / "reference.ini"
    argv = ["project_generator", "--database_path", "d.db", "--image_path",
            "imgs", "--output_path", str(ours)]
    tcli.main(argv + (["--quality", quality] if quality else []))
    ref = jconfig.AllOptions(database_path="d.db", image_path="imgs")
    if quality:
        ref.apply_quality_preset(quality)
    ref.save(str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    loaded = AllOptions.load(str(ours))
    for attr, fields in AllOptions._SECTIONS.values():
        for f in fields:
            assert getattr(getattr(loaded, attr), f) == \
                getattr(getattr(ref, attr), f), f
