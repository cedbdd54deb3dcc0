"""The port's ``automatic_reconstructor``, ``mapper``, ``image_filterer``
and ``project_generator`` CLIs end to end on a rendered dataset.

Eight 480 x 360 views of the box scene (``utils.synthetic.render_dataset``)
go through ``automatic_reconstructor --device cpu`` (the port's extractor,
matcher and mapper in one process, quality "high"): every image registers
in one model whose poses, up to gauge, are within twice the errors the
reference CLI's ``mapper`` reaches on the same database (measured with
``tests/torch_mapper_bar.py mapper --images 8 --width 480 --height 360``
on a CPU), floored at 0.25 and 1 degree.  ``mapper --input_path`` resumes
from that model, ``image_filterer`` filters it, ``project_generator``
writes a project file.  Asking for CUDA without a device is an error.

The ``cuda`` case runs ``mapper`` twice on the card on the same database
(byte-identical models, every image registered, within the bar).  This
file imports no JAX, so it runs with ``--noconftest`` where JAX is not
installed.
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

NUM_IMAGES = 8
# Rotation and translation-direction errors (degrees) of the reference
# CLI's mapper on this database, and the bar: twice them, floored at 0.25
# and 1.
REFERENCE_ERRORS = (0.08808, 0.16775)
BAR = (max(2 * REFERENCE_ERRORS[0], 0.25), max(2 * REFERENCE_ERRORS[1], 1.0))


@pytest.fixture(scope="module")
def auto(tmp_path_factory):
    root = tmp_path_factory.mktemp("mapper_cli")
    images = str(root / "images")
    render_dataset(images, NUM_IMAGES, 480, 360, seed=0, scene="box")
    ws = str(root / "ws")
    ctrl = tcli.main(["automatic_reconstructor", "--workspace_path", ws,
                      "--image_path", images, "--device", "cpu"])
    return root, ws, ctrl, read_gt_poses(os.path.join(images,
                                                      "gt_poses.txt"))


def errors(model_dir, gt):
    rec = Reconstruction.read_text(model_dir)
    ids = sorted(rec.reg_image_ids, key=lambda i: rec.images[i].name)
    names = [rec.images[i].name for i in ids]
    poses = np.stack([rec.images[i].projection_matrix() for i in ids])
    rot, dirn = gauge_align_errors(np.stack([gt[n][0] for n in names]),
                                   np.stack([gt[n][1] for n in names]),
                                   poses)
    return rec, names, np.degrees(rot), np.degrees(dirn)


def model_bytes(path):
    out = {}
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def test_automatic_reconstructor_meets_the_reference_bar(auto):
    root, ws, ctrl, gt = auto
    assert ctrl.device.type == "cpu"
    assert os.path.exists(os.path.join(ws, "database.db"))
    assert sorted(os.listdir(os.path.join(ws, "sparse"))) == ["0"]
    model = os.path.join(ws, "sparse", "0")
    rec, names, rot, dirn = errors(model, gt)
    assert len(names) == NUM_IMAGES and len(rec.points3d) >= 300
    assert rot <= BAR[0] and dirn <= BAR[1], (rot, dirn)
    assert rec.compute_mean_reprojection_error() < 1.0
    assert os.path.exists(os.path.join(model, "project.ini"))


def test_mapper_resumes_from_the_model(auto, capsys):
    root, ws, _, gt = auto
    model = os.path.join(ws, "sparse", "0")
    capsys.readouterr()
    ctrl = tcli.main(["mapper", "--database_path",
                      os.path.join(ws, "database.db"), "--input_path", model,
                      "--output_path", str(root / "resumed"), "--device",
                      "cpu"])
    text = capsys.readouterr().out
    assert f"resuming from {model} ({NUM_IMAGES} images)" in text
    assert "images registered/s" in text
    assert "init/init_solve" not in ctrl.profiler.totals
    rec, names, rot, dirn = errors(str(root / "resumed" / "0"), gt)
    assert len(names) == NUM_IMAGES
    assert rot <= BAR[0] and dirn <= BAR[1], (rot, dirn)


def test_image_filterer_and_project_generator(auto, capsys):
    root, ws, _, _ = auto
    model = os.path.join(ws, "sparse", "0")
    before = Reconstruction.read_text(model)
    filtered = tcli.main(["image_filterer", "--input_path", model,
                          "--output_path", str(root / "filtered"),
                          "--max_reproj_error", "0.05",
                          "--min_tri_angle", "1.5"])
    after = Reconstruction.read_text(str(root / "filtered"))
    assert after.num_registered() == NUM_IMAGES - len(filtered)
    assert 0 < len(after.points3d) < len(before.points3d)
    assert f"Filtered {len(filtered)} of {NUM_IMAGES} images" in \
        capsys.readouterr().out
    opts = tcli.main(["project_generator", "--output_path",
                      str(root / "p.ini"), "--quality", "low"])
    assert opts.extraction.max_image_size == 1000
    assert "max_image_size = 1000" in (root / "p.ini").read_text()


@pytest.mark.parametrize("command", ["mapper", "automatic_reconstructor"])
def test_cuda_device_without_gpu_is_an_error(auto, monkeypatch, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, ws, _, _ = auto
    never = str(root / "never")
    if command == "mapper":
        argv = ["mapper", "--database_path", os.path.join(ws, "database.db"),
                "--output_path", never]
    else:
        argv = ["automatic_reconstructor", "--workspace_path", never,
                "--image_path", str(root / "images")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv + ["--device", "cuda"])
    assert not os.path.exists(never)


@pytest.mark.cuda
def test_card_runs_are_byte_identical_and_meet_the_bar(auto):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root, ws, _, gt = auto
    outs = []
    for k in range(2):
        out = str(root / f"card{k}")
        tcli.main(["mapper", "--database_path",
                   os.path.join(ws, "database.db"), "--output_path", out,
                   "--device", "cuda"])
        outs.append(os.path.join(out, "0"))
        rec, names, rot, dirn = errors(outs[-1], gt)
        assert len(names) == NUM_IMAGES
        assert rot <= BAR[0] and dirn <= BAR[1], (rot, dirn)
    assert model_bytes(outs[0]) == model_bytes(outs[1])
