"""The port's controller on the degenerate scenes of
``tests/test_robustness.py``: near-pure rotation and a plane.

Each database is the reference test's, written here by the same code
from the same seed, drawing the same numbers in the same order, and run
through the port's controller on the CPU in float64 as the gravity-noise
scenes are (``tests/test_torch_robustness.py``).  The gates are the
reference tests' own (``reports/robustness_margins_r4.json``): a
rotation-only capture gives no model of 90 points or more; a planar scene
registers at least 6 of 8 images within ATE 0.05.
"""

import numpy as np
import torch

import jax.numpy as jnp

from privacy_preserving_sfm_tpu.models.database import Database
from privacy_preserving_sfm_tpu.ops import lie

from test_e2e_synthetic import ate_rmse, build_synthetic_db
from test_torch_robustness import run_controller

torch.set_num_threads(2)


def write_posed_scene(path, rng, pts, poses, prefix):
    """The reference tests' hand-built database: ``pts`` seen by cameras
    at ``poses`` (quaternion, translation), each point lifted to a line
    along gravity (half of them, drawn first) or a random direction, and
    every pair of cameras matched on the points both see.  Returns the
    image ids."""
    num_points = len(pts)
    aligned = rng.uniform(size=num_points) < 0.5
    with Database(path) as db:
        cam_id = db.write_camera("SIMPLE_PINHOLE", 640, 480,
                                 np.array([500.0, 320.0, 240.0]))
        image_ids, visible = [], []
        for i, pose in enumerate(poses):
            q, t = pose(i)
            iid = db.write_image(f"{prefix}{i:03d}.png", cam_id)
            image_ids.append(iid)
            R = np.asarray(lie.quat_to_rotmat(jnp.asarray(q)))
            Xc = pts @ R.T + t
            uv = Xc[:, :2] / Xc[:, 2:3]
            pix = uv * 500.0 + np.array([320.0, 240.0])
            visible.append((Xc[:, 2] > 0.2) & (pix[:, 0] >= 0)
                           & (pix[:, 0] < 640) & (pix[:, 1] >= 0)
                           & (pix[:, 1] < 480))
            g = R @ np.array([0.0, 1.0, 0.0])
            hom = np.concatenate([uv, np.ones((num_points, 1))], axis=1)
            dirs = np.where(aligned[:, None],
                            np.broadcast_to(g, (num_points, 3)),
                            rng.standard_normal((num_points, 3)))
            lines = np.cross(dirs, hom)
            lines /= np.linalg.norm(lines[:, :2], axis=-1, keepdims=True)
            db.write_lines(iid, lines, aligned)
            db.write_gravity(iid, g)
        for a in range(len(poses)):
            for b in range(a + 1, len(poses)):
                both = np.nonzero(visible[a] & visible[b])[0]
                m = np.stack([both, both], axis=1).astype(np.uint32)
                db.write_matches(image_ids[a], image_ids[b], m)
    return image_ids


def test_near_pure_rotation_fails_clean(tmp_path):
    rng = np.random.default_rng(13)
    # The reference test draws a first scene from the stream, then writes
    # the rotation-only one.
    build_synthetic_db(str(tmp_path / "rot.db"), rng, num_images=6)
    pts = rng.uniform(-1.5, 1.5, (120, 3))
    pts[:, 2] = np.abs(pts[:, 2]) + 3.0

    def pose(i):
        yaw = -0.25 + 0.5 * i / 5
        return (np.array([np.cos(yaw / 2), 0, np.sin(yaw / 2), 0]),
                rng.normal(0, 1e-5, 3))  # shared centre up to 1e-5

    path = str(tmp_path / "rot2.db")
    write_posed_scene(path, rng, pts, [pose] * 6, "rot")
    for rec in run_controller(path):  # must not raise
        assert len(rec.points3d) < 90, (
            f"pure rotation produced {len(rec.points3d)} points")


def test_planar_scene_reconstructs(tmp_path):
    rng = np.random.default_rng(14)
    pts = rng.uniform(-1.5, 1.5, (120, 3))
    pts[:, 2] = 4.0  # exact plane
    qs, ts = [], []

    def pose(i):
        yaw = -0.35 + 0.7 * i / 7
        q = np.array([np.cos(yaw / 2), 0, np.sin(yaw / 2), 0])
        t = np.array([-1.0 + 2.0 * i / 7, rng.uniform(-0.1, 0.1),
                      rng.uniform(-0.2, 0.2)])
        qs.append(q)
        ts.append(t)
        return q, t

    path = str(tmp_path / "plane.db")
    image_ids = write_posed_scene(path, rng, pts, [pose] * 8, "pl")
    recs = run_controller(path)
    assert recs, "planar scene must reconstruct"
    rec = max(recs, key=lambda r: r.num_registered())
    assert rec.num_registered() >= 6
    err = ate_rmse(rec, np.stack(qs), np.stack(ts), image_ids)
    assert err < 0.05, f"ATE {err}"
