"""The port's ``line_initializer`` CLI end to end on a rendered dataset.

Eight 480 x 360 views of the box scene (``utils.synthetic.render_dataset``)
go through the port's ``feature_extractor`` (2,048 features) and
``exhaustive_matcher`` on the CPU; ``line_initializer --device cpu``
registers 4 images whose poses, up to gauge, are within twice the errors
the reference CLI reaches on a database the port wrote from the same
rendering (0.15696 degrees of rotation and 0.66643 of translation
direction, measured with ``tests/torch_init_bar.py`` on a CPU), floored
at 0.25 and 1 degree.  Asking for CUDA without a device is an error.

The ``cuda`` case runs the CLI twice on the card (byte-identical models)
and once on the CPU (the same image set).  This file imports no JAX, so it
runs with ``--noconftest`` where JAX is not installed.
"""

import os

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.exe import ppsfm as tcli
from privacy_preserving_sfm_torch.models.reconstruction import Reconstruction
from privacy_preserving_sfm_torch.utils.synthetic import (
    gauge_align_errors, read_gt_poses, render_dataset,
)

torch.set_num_threads(2)

# Rotation and translation-direction errors (degrees) of the reference CLI
# on this dataset, and the bar: twice them, floored at 0.25 and 1.
REFERENCE_ERRORS = (0.15696, 0.66643)
BAR = (max(2 * REFERENCE_ERRORS[0], 0.25), max(2 * REFERENCE_ERRORS[1], 1.0))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("init_cli")
    images = str(root / "images")
    render_dataset(images, 8, 480, 360, seed=0, scene="box")
    db = str(root / "t.db")
    tcli.main(["feature_extractor", "--database_path", db, "--image_path",
               images, "--device", "cpu", "--max_num_features", "2048"])
    tcli.main(["exhaustive_matcher", "--database_path", db, "--device",
               "cpu"])
    return root, db, read_gt_poses(os.path.join(images, "gt_poses.txt"))


def run(dataset, out, device):
    root, db, gt = dataset
    out = str(root / out)
    tcli.main(["line_initializer", "--database_path", db, "--output_path",
               out, "--device", device])
    rec = Reconstruction.read_text(out)
    names = [rec.images[i].name for i in rec.reg_image_ids]
    poses = np.stack([rec.images[i].projection_matrix()
                      for i in rec.reg_image_ids])
    rot, dirn = gauge_align_errors(np.stack([gt[n][0] for n in names]),
                                   np.stack([gt[n][1] for n in names]),
                                   poses)
    return out, rec, names, np.degrees(rot), np.degrees(dirn)


def model_bytes(path):
    out = {}
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def test_cli_on_the_cpu_meets_the_ground_truth_bar(dataset, capsys):
    _, rec, names, rot, dirn = run(dataset, "cpu", "cpu")
    text = capsys.readouterr().out
    assert "graph=native device=cpu" in text and "init_solve=" in text
    assert len(names) == 4 and len(rec.points3d) >= 300
    assert all(len(p.track) >= 2 for p in rec.points3d.values())
    assert rot <= BAR[0] and dirn <= BAR[1], (rot, dirn)


def test_cuda_device_without_gpu_is_an_error(dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = dataset[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["line_initializer", "--database_path", dataset[1],
                   "--output_path", str(root / "never"), "--device",
                   "cuda"])
    assert not (root / "never").exists()


@pytest.mark.cuda
def test_card_runs_are_byte_identical_and_register_the_cpu_set(dataset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = run(dataset, "card_a", "cuda")
    b = run(dataset, "card_b", "cuda")
    assert model_bytes(a[0]) == model_bytes(b[0])
    cpu = run(dataset, "cpu_ref", "cpu")
    assert a[2] == cpu[2]
    assert a[3] <= BAR[0] and a[4] <= BAR[1], (a[3], a[4])
