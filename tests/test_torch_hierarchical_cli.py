"""The port's ``hierarchical_mapper`` CLI end to end.

A seeded 12-image mapper database (``utils.synthetic.
synthetic_line_database``) goes through ``hierarchical_mapper --device
cpu`` with blocks of 8 sharing 4 (two blocks): one model with every image
registered, close to the generator's poses.  Asking for CUDA without a
device is an error.  The ``cuda`` case runs it twice on the card, with
one and with two worker processes (byte-identical models).  This file
imports no JAX, so it runs with ``--noconftest`` where JAX is not
installed.
"""

import os

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.exe import ppsfm as tcli
from privacy_preserving_sfm_torch.models.reconstruction import Reconstruction
from privacy_preserving_sfm_torch.utils.synthetic import (
    gauge_align_errors, synthetic_line_database,
)

torch.set_num_threads(2)

NUM_IMAGES = 12


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("hier_cli")
    path = str(root / "scene.db")
    qs, ts, _, ids = synthetic_line_database(path, NUM_IMAGES, 400, seed=4)
    return root, path, qs, ts, ids


def run(path, out, device, workers=1):
    return tcli.main(["hierarchical_mapper", "--database_path", path,
                      "--output_path", out, "--block_size", "8",
                      "--overlap", "4", "--num_workers", str(workers),
                      "--device", device])


def check_model(model_dir, qs, ts, ids):
    rec = Reconstruction.read_text(model_dir)
    assert sorted(rec.reg_image_ids) == sorted(ids)
    poses = np.stack([rec.images[i].projection_matrix() for i in ids])
    rot, dirn = gauge_align_errors(qs, ts, poses)
    assert np.degrees(rot) < 0.25 and np.degrees(dirn) < 1.0, (rot, dirn)
    assert rec.compute_mean_reprojection_error() < 1.0
    return rec


def model_bytes(path):
    out = {}
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def test_hierarchical_mapper_writes_a_model(scene, capsys):
    root, path, qs, ts, ids = scene
    stats = run(path, str(root / "cpu"), "cpu")
    text = capsys.readouterr().out
    assert "2 blocks" in text and "images registered/s" in text
    assert stats["blocks"] == stats["merged"] == 2
    check_model(str(root / "cpu" / "0"), qs, ts, ids)


def test_cuda_device_without_gpu_is_an_error(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, path, *_ = scene
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(path, str(root / "never"), "cuda")
    assert not os.path.exists(str(root / "never"))


@pytest.mark.cuda
def test_card_runs_are_byte_identical(scene):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root, path, qs, ts, ids = scene
    outs = []
    for workers in (1, 2):
        out = str(root / f"card{workers}")
        stats = run(path, out, "cuda", workers)
        assert [s["device"] for s in stats["snapshots"]] == ["cuda"] * 2
        outs.append(os.path.join(out, "0"))
        check_model(outs[-1], qs, ts, ids)
    assert model_bytes(outs[0]) == model_bytes(outs[1])
