"""Port parity: ``tools/evaluate.py`` (which reads models with the JAX
package) against the port's ``privacy_preserving_sfm_torch.tools.
evaluate`` (numpy only).

On random poses (a similarity transform of the truth plus noise, with
missing images, fewer than three common images and no alignment), on the
model a small port run writes (the mapper's controller on the CPU on a
seeded line database) against its ``gt_poses.txt`` and against another model, every
key of the port's report equals the tool's to 1e-12 (relative), and the
two CLIs write the same JSON.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.sfm.controller import (
    ControllerOptions, IncrementalMapperController,
)
from privacy_preserving_sfm_torch.sfm.incremental_mapper import MapperOptions
from privacy_preserving_sfm_torch.tools import evaluate as port
from privacy_preserving_sfm_torch.utils.synthetic import (
    synthetic_line_database,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import evaluate as ref  # noqa: E402  (the repository's tools/)

torch.set_num_threads(2)


def same(a, b, tol=1e-12):
    """Equal reports: the same keys, floats to ``tol`` relative."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            same(a[k], b[k], tol)
    elif isinstance(a, float) and isinstance(b, float):
        if math.isinf(a) or a == b:
            assert a == b
        else:
            assert abs(a - b) <= tol * max(abs(a), abs(b)), (a, b)
    else:
        assert a == b and type(a) is type(b)


def _random_poses(rng, n):
    out = {}
    for i in range(n):
        q = rng.standard_normal(4)
        out[f"img{i:03d}.png"] = (port.quat_to_R(q), rng.normal(0, 3, 3))
    return out


def _transformed(rng, poses, noise):
    """The poses in another frame (world' = s R world + t), perturbed."""
    s = rng.uniform(0.2, 5.0)
    Ra = port.quat_to_R(rng.standard_normal(4))
    ta = rng.normal(0, 10, 3)
    out = {}
    for name, (R, t) in poses.items():
        dR = port.quat_to_R(np.r_[1.0, rng.normal(0, noise, 3)])
        R2 = dR @ R @ Ra.T
        out[name] = (R2, s * t - R2 @ ta + rng.normal(0, noise, 3))
    return out


@pytest.mark.parametrize("n, drop, align", [
    (12, 0, True), (12, 3, True), (12, 0, False), (4, 2, True),
    (3, 0, True), (5, 5, True)])
def test_evaluate_matches_the_tool_on_random_poses(n, drop, align):
    rng = np.random.default_rng(n + 10 * drop + align)
    truth = _random_poses(rng, n)
    est = _transformed(rng, truth, 1e-3)
    for name in list(est)[:drop]:
        del est[name]
    got = port.evaluate(est, truth, align=align)
    want = ref.evaluate(est, truth, align=align)
    same(got, want)
    assert got["num_registered"] == n - drop
    if align and n - drop >= 3:
        assert got["ate_rmse"] < 0.05 and got["mean_rot_deg"] < 0.5


def test_helpers_match_the_tool():
    rng = np.random.default_rng(1)
    for _ in range(20):
        q = rng.standard_normal(4)
        np.testing.assert_array_equal(port.quat_to_R(q), ref.quat_to_R(q))
        R = port.quat_to_R(q)
        assert port.axis_angle_deg(R) == ref.axis_angle_deg(R)
    src = rng.standard_normal((9, 3))
    dst = 2.5 * src @ port.quat_to_R(rng.standard_normal(4)).T + 1.0
    for a, b in zip(port.similarity_align(src, dst),
                    ref.similarity_align(src, dst)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A port run: the mapper's controller on the CPU (the fast options
    of ``test_torch_controller.py``) on a seeded line database, its model
    written as text, its truth as ``gt_poses.txt``."""
    root = tmp_path_factory.mktemp("evaluate")
    db = str(root / "t.db")
    qs, ts, _, _ = synthetic_line_database(db, 8, 400, seed=3)
    with open(root / "gt_poses.txt", "w") as f:
        f.write("# name qw qx qy qz tx ty tz\n")
        for i, (q, t) in enumerate(zip(qs, ts)):
            f.write(f"img{i:03d}.png "
                    + " ".join(repr(float(v)) for v in [*q, *t]) + "\n")
    options = ControllerOptions(
        mapper=MapperOptions(num_hypotheses=512, init_num_samples=256,
                             abs_pose_min_num_inliers=15),
        min_model_size=4, verbose=False)
    recs = IncrementalMapperController(options, database_path=db,
                                       device="cpu",
                                       dtype=torch.float32).run()
    model = str(root / "sparse" / "0")
    max(recs, key=lambda r: r.num_registered()).write_text(model)
    return root, model


def test_report_on_a_port_run_matches_the_tool(run):
    root, model = run
    gt = str(root / "gt_poses.txt")
    got = port.report(model, gt=gt)
    rec, est = ref.read_model_poses(model)
    want = ref.evaluate(est, ref.read_gt_poses(gt))
    want["mean_reproj_error_px"] = rec.compute_mean_reprojection_error()
    want["mean_track_length"] = rec.compute_mean_track_length()
    want["num_points3d"] = len(rec.points3d)
    same(got, want)
    assert got["num_registered"] >= 6 and got["ate_rmse"] < 0.05
    # Against the model itself, in one frame: zero error.
    self_ref = port.report(model, ref_model=model, align=False)
    assert self_ref["mean_rot_deg"] < 1e-6 and self_ref["mean_pos_err"] \
        < 1e-9


@pytest.mark.parametrize("args", [["--gt", "GT"],
                                  ["--gt", "GT", "--no-align"],
                                  ["--ref-model", "MODEL"]])
def test_cli_json_matches_the_tool(run, args):
    root, model = run
    args = [a.replace("GT", str(root / "gt_poses.txt")).replace(
        "MODEL", model) for a in args]
    jsons = []
    port_cli = "privacy_preserving_sfm_torch.tools.evaluate"
    for who, cmd in (("port", [sys.executable, "-m", port_cli]),
                     ("tool", [sys.executable,
                               os.path.join(REPO, "tools", "evaluate.py")])):
        path = str(root / f"{who}.json")
        out = subprocess.run(cmd + [model, *args, "--json", path], cwd=REPO,
                             env=dict(os.environ, PYTHONPATH=REPO,
                                      JAX_PLATFORMS="cpu"),
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        brief = json.loads(out.stdout)
        full = json.load(open(path))
        assert brief == {k: v for k, v in full.items() if k != "per_image"}
        jsons.append(full)
    same(*jsons)


def test_cli_needs_a_reference(run):
    _, model = run
    with pytest.raises(SystemExit):
        port.main([model])
