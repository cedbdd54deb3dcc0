"""The focal search inside the port's controller.

A camera without a prior focal is searched at its first registration
(``IncrementalMapper._focal_search``); with one camera for all images the
initializer registers that camera and no search runs in the loop.  Here
every image has a camera of its own: ``tests/test_e2e_synthetic.py``'s
uncalibrated scene (8 images, lines lifted with a focal of 560 for a true
500, 12 % off, seed 7) with each image moved to its own prior-less
camera.  The port's controller with ``ba_refine_focal_length`` on the CPU
in float64 must search once for each camera registered after the
initializer, bring every registered camera's focal within 3 % of the
truth, and do no worse than the reference package's controller on the
same database: at least its registered count, focal errors within twice
its largest.  The reference run takes about 90 s on a CPU, so its numbers
are kept here beside a digest of the database they were measured on; the
test fails if the scene no longer gives that database, and
``python tests/torch_focal_bar.py`` measures both again.
"""

import hashlib
import sqlite3

import numpy as np
import torch

from privacy_preserving_sfm_torch.sfm.controller import (
    ControllerOptions, IncrementalMapperController,
)
from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
    IncrementalMapper, MapperOptions,
)
from privacy_preserving_sfm_tpu.models.database import Database

from test_e2e_synthetic import ate_rmse, build_synthetic_db

torch.set_num_threads(2)

TRUE_FOCAL, LIFT_FOCAL, SEED, NUM_IMAGES = 500.0, 560.0, 7, 8
# The reference controller on this database (tests/torch_focal_bar.py, on
# a CPU): 8 of 8 registered, searches at images 8, 7, 2 and 1, largest
# relative focal error 7.355282358503245e-07, ATE 2.09e-07; the database's
# database_digest.
REFERENCE_DB_DIGEST = (
    "98cc0f0738e4ae288c8fb31b8a661c5c9d8ab96e173d7ce256f73a8977ba9c1d")
REFERENCE_REGISTERED = 8
REFERENCE_FOCAL_ERROR = 7.355282358503245e-07
FOCAL_BAR = 0.03


def per_camera_scene(path):
    """The uncalibrated scene with one prior-less camera an image.
    Returns build_synthetic_db's (qs, ts, pts, image_ids)."""
    scene = build_synthetic_db(path, np.random.default_rng(SEED),
                               num_images=NUM_IMAGES, lift_focal=LIFT_FOCAL)
    image_ids = scene[3]
    with Database(path) as db:
        cams = [db.write_camera("SIMPLE_PINHOLE", 640, 480,
                                np.array([LIFT_FOCAL, 320.0, 240.0]),
                                prior_focal=False) for _ in image_ids]
    conn = sqlite3.connect(path)
    for iid, cam in zip(image_ids, cams):
        conn.execute("UPDATE images SET camera_id=? WHERE image_id=?;",
                     (int(cam), int(iid)))
    conn.commit()
    conn.close()
    return scene


def database_digest(path):
    """SHA-256 of every row of every table, in table-name and row order."""
    digest = hashlib.sha256()
    conn = sqlite3.connect(path)
    for (table,) in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' AND name NOT "
            "LIKE 'sqlite_%' ORDER BY name"):
        digest.update(table.encode())
        for row in conn.execute(f"SELECT * FROM {table} ORDER BY rowid"):
            digest.update(repr(row).encode())
    conn.close()
    return digest.hexdigest()


def test_focal_search_runs_once_per_camera_registered_after_init(
        tmp_path, monkeypatch):
    path = str(tmp_path / "cameras.db")
    qs, ts, _, image_ids = per_camera_scene(path)
    assert database_digest(path) == REFERENCE_DB_DIGEST, (
        "the scene's database changed: measure the reference again with "
        "tests/torch_focal_bar.py")
    searched = []
    search = IncrementalMapper._focal_search

    def counted(self, options, image_id, corrs):
        searched.append(image_id)
        return search(self, options, image_id, corrs)

    monkeypatch.setattr(IncrementalMapper, "_focal_search", counted)
    options = ControllerOptions(
        mapper=MapperOptions(num_hypotheses=512, init_num_samples=256,
                             abs_pose_min_num_inliers=15),
        min_model_size=4, verbose=False, ba_refine_focal_length=True)
    ctrl = IncrementalMapperController(options, database_path=path,
                                       device="cpu", dtype=torch.float64)
    recs = ctrl.run()
    assert recs
    rec = max(recs, key=lambda r: r.num_registered())
    cameras = {rec.images[iid].camera_id for iid in rec.reg_image_ids}
    assert len(cameras) == rec.num_registered() >= 3
    after_init = [iid for iid in rec.reg_image_ids
                  if rec.images[iid].camera_id
                  in {rec.images[s].camera_id for s in searched}]
    assert sorted(searched) == sorted(after_init)
    assert len(searched) == rec.num_registered() - 4  # init registers 4
    assert rec.num_registered() >= REFERENCE_REGISTERED
    errors = [abs(rec.cameras[cam].params[0] - TRUE_FOCAL) / TRUE_FOCAL
              for cam in cameras]
    assert max(errors) <= FOCAL_BAR
    assert max(errors) <= 2 * REFERENCE_FOCAL_ERROR, errors
    assert ate_rmse(rec, qs, ts, image_ids) < 0.10
