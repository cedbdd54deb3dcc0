"""The port's controller on the gravity-noise scenes of
``tests/test_robustness.py``.

Each scene is the reference test's, built with its builder and seed, and
run through the port's ``IncrementalMapperController`` on the CPU in
float64, as the reference tests run under x64, with
``tests/test_e2e_synthetic.py``'s FAST options.  The gates are the
reference tests' own, set from the measured 10-seed distribution
(``reports/robustness_margins_r4.json``): at 0.5 and 1 degree of gravity
error at least 7 of 8 images and ATE below 1e-5; at 2 degrees no crash
and no model of 6 or more images with ATE of 1 or more.  The degenerate
scenes are in ``tests/test_torch_robustness_scenes.py``.
"""

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.sfm.controller import (
    ControllerOptions, IncrementalMapperController,
)
from privacy_preserving_sfm_torch.sfm.incremental_mapper import MapperOptions

from test_e2e_synthetic import ate_rmse, build_synthetic_db
from test_robustness import _perturb_gravity

torch.set_num_threads(2)

# tests/test_e2e_synthetic.py's FAST options.
FAST_MAPPER = dict(num_hypotheses=512, init_num_samples=256,
                   abs_pose_min_num_inliers=15)


def run_controller(path):
    options = ControllerOptions(mapper=MapperOptions(**FAST_MAPPER),
                                min_model_size=4, verbose=False)
    return IncrementalMapperController(
        options, database_path=path, device="cpu",
        dtype=torch.float64).run()


@pytest.mark.parametrize("noise_deg,ate_gate", [(0.5, 1e-5), (1.0, 1e-5)])
def test_gravity_noise_sweep(tmp_path, noise_deg, ate_gate):
    rng = np.random.default_rng(11)
    path = str(tmp_path / f"g{noise_deg}.db")
    qs, ts, pts, image_ids = build_synthetic_db(path, rng)
    _perturb_gravity(path, rng, noise_deg)
    recs = run_controller(path)
    assert recs, "no reconstruction produced"
    rec = max(recs, key=lambda r: r.num_registered())
    assert rec.num_registered() >= 7, (
        f"only {rec.num_registered()}/8 at {noise_deg} deg")
    err = ate_rmse(rec, qs, ts, image_ids)
    assert err < ate_gate, f"ATE {err} at {noise_deg} deg"


def test_gravity_noise_2deg_degrades_gracefully(tmp_path):
    rng = np.random.default_rng(12)
    path = str(tmp_path / "g2.db")
    qs, ts, pts, image_ids = build_synthetic_db(path, rng)
    _perturb_gravity(path, rng, 2.0)
    for rec in run_controller(path):  # must not raise
        if rec.num_registered() >= 6:
            err = ate_rmse(rec, qs, ts, image_ids)
            assert err < 1.0, f"accepted model with ATE {err}"
