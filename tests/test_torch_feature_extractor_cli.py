"""Port parity for the whole front-end slice: the ``feature_extractor`` CLI.

A seeded rendered dataset (``utils.synthetic.render_dataset``: three
240 x 320 views of a textured plane, one without a gravity sidecar, one
with a GPS sidecar) goes through the port's CLI on the CPU and through the
reference CLI, both shrinking the images to ``--max_image_size 200``.
The port writes a row set for every image with gravity: uint8
descriptors, unit lines through the keypoints, exactly floor(0.5 n)
aligned flags whose lines contain gravity, and the gravity; a rerun with
the same seed writes the same bytes; and its descriptors match the
reference CLI's (the line directions are random draws, whose streams
differ by design).
"""

import os
import shutil
import sqlite3

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.exe import ppsfm as tcli
from privacy_preserving_sfm_torch.models.database import Database
from privacy_preserving_sfm_torch.utils import png
from privacy_preserving_sfm_torch.utils.synthetic import render_dataset

torch.set_num_threads(2)

FLAGS = ["--max_num_features", "512", "--batch_size", "2",
         "--max_image_size", "200"]
TABLES = ("cameras", "images", "descriptors", "line_features",
          "gravity_directions")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("extract") / "images"
    render_dataset(str(path), 3, 320, 240, seed=2, scene="plane")
    os.remove(path / "img002.png.gravity.txt")
    with open(path / "img000.png.gps.txt", "w") as f:
        f.write("47.37 8.54 408.0\n")
    return path


def _extract(dataset, db, *extra, device="cpu"):
    return tcli.main(["feature_extractor", "--database_path", str(db),
                      "--image_path", str(dataset), "--device", device]
                     + FLAGS + list(extra))


@pytest.fixture(scope="module")
def port_db(dataset, tmp_path_factory):
    db = tmp_path_factory.mktemp("port") / "t.db"
    _extract(dataset, db)
    return db


def _rows(path):
    con = sqlite3.connect(str(path))
    try:
        return {t: con.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
                for t in TABLES}
    finally:
        con.close()


def check_rows(db_path, names):
    """Every named image has rows that keep the front end's invariants."""
    with Database(str(db_path)) as db:
        images = db.read_images()
        assert sorted(v["name"] for v in images.values()) == names
        for iid in images:
            desc = db.read_descriptors(iid)
            lines, aligned = db.read_lines(iid)
            g = db.read_gravity(iid)
            n = len(desc)
            assert desc.dtype == np.uint8 and desc.shape == (n, 128)
            assert n >= 50 and lines.shape == (n, 3)
            assert aligned.sum() == n // 2  # floor(0.5 n)
            # As stored (float32): unit normal, gravity on aligned lines.
            raw = np.frombuffer(db.conn.execute(
                "SELECT data FROM line_features WHERE image_id = ?",
                (iid,)).fetchone()[0], np.float32).reshape(n, 4)
            assert np.abs(np.linalg.norm(raw[:, :2], axis=1) - 1).max() \
                <= 1e-6
            assert np.abs(raw[aligned, :3] @ g).max() <= 1e-5
            np.testing.assert_array_equal(raw[:, 3] > 0, aligned)
            assert np.linalg.norm(desc.astype(float), axis=1).min() > 300
    return images


def test_rows_for_every_image_with_gravity(dataset, port_db, capsys):
    images = check_rows(port_db, ["img000.png", "img001.png"])
    with Database(str(port_db)) as db:
        cams = db.read_cameras()
        (cam,) = cams.values()
        assert cam["model"] == "SIMPLE_PINHOLE"
        assert (cam["width"], cam["height"]) == (320, 240)
        np.testing.assert_allclose(cam["params"], [200.0, 160.0, 120.0])
        assert cam["prior_focal_length"]
        prior = db.conn.execute(
            "SELECT name, prior_tx, prior_ty, prior_tz FROM images").fetchall()
    assert dict((r[0], r[1:]) for r in prior) == {
        "img000.png": (47.37, 8.54, 408.0),
        "img001.png": (None, None, None)}
    assert len(images) == 2


def test_rerun_with_the_same_seed_writes_the_same_bytes(dataset, port_db,
                                                        tmp_path):
    again = tmp_path / "again.db"
    _extract(dataset, again)
    assert _rows(again) == _rows(port_db)
    other = tmp_path / "seed1.db"
    _extract(dataset, other, "--seed", "1")
    a, b = _rows(port_db), _rows(other)
    assert a["descriptors"] == b["descriptors"]
    assert a["line_features"] != b["line_features"]  # other random lines


def test_rerun_skips_images_with_rows(dataset, port_db, tmp_path, capsys):
    db = tmp_path / "skip.db"
    shutil.copy(port_db, db)
    capsys.readouterr()
    _extract(dataset, db)
    out = capsys.readouterr().out
    assert "features" not in out and "img002.png: no .gravity.txt" in out
    a, b = _rows(db), _rows(port_db)
    # As in the reference CLI, a run writes its camera rows anew.
    assert len(a.pop("cameras")) == 2 * len(b.pop("cameras"))
    assert a == b


def test_mask_sidecar_drops_features(dataset, port_db, tmp_path):
    masked = tmp_path / "masked"
    shutil.copytree(dataset, masked)
    mask = np.zeros((240, 320), np.uint8)
    mask[:, :160] = 255
    png.write_png_gray(str(masked / "img001.png.mask.png"), mask)
    db = tmp_path / "m.db"
    _extract(masked, db)
    with Database(str(db)) as dm, Database(str(port_db)) as dp:
        ids_m = {v["name"]: k for k, v in dm.read_images().items()}
        ids_p = {v["name"]: k for k, v in dp.read_images().items()}
        n_m = dm.count_descriptors(ids_m["img001.png"])
        n_p = dp.count_descriptors(ids_p["img001.png"])
        assert 0 < n_m < 0.8 * n_p
        assert dm.read_descriptors(ids_m["img000.png"]).tobytes() == \
            dp.read_descriptors(ids_p["img000.png"]).tobytes()


def test_descriptors_match_the_reference_cli(dataset, port_db, tmp_path):
    """The reference CLI on the same images: per image, row counts within
    10 %, and 90 % of the port's descriptors have a reference descriptor
    within 2 quanta (L-infinity)."""
    pytest.importorskip("jax")
    from privacy_preserving_sfm_tpu.exe import ppsfm as jcli

    jdb = tmp_path / "j.db"
    jcli.main(["feature_extractor", "--database_path", str(jdb),
               "--image_path", str(dataset)] + FLAGS)
    with Database(str(jdb)) as dj, Database(str(port_db)) as dt:
        jd = {v["name"]: dj.read_descriptors(k)
              for k, v in dj.read_images().items()}
        td = {v["name"]: dt.read_descriptors(k)
              for k, v in dt.read_images().items()}
    assert sorted(jd) == sorted(td) == ["img000.png", "img001.png"]
    for name in jd:
        a, b = td[name].astype(np.int16), jd[name].astype(np.int16)
        assert abs(len(a) - len(b)) <= 0.1 * len(b)
        near = np.array([np.abs(b - row).max(1).min() for row in a])
        assert (near <= 2).mean() >= 0.9, (name, (near <= 2).mean())
    check_rows(jdb, ["img000.png", "img001.png"])


def test_cuda_device_without_gpu_is_an_error(dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _extract(dataset, tmp_path / "c.db", device="cuda")
    assert not (tmp_path / "c.db").exists()


@pytest.mark.cuda
def test_cli_on_the_card_writes_rows_and_the_same_bytes_again(dataset,
                                                              tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dbs = [tmp_path / "a.db", tmp_path / "b.db"]
    for db in dbs:
        _extract(dataset, db, device="cuda")
    check_rows(dbs[0], ["img000.png", "img001.png"])
    assert _rows(dbs[0]) == _rows(dbs[1])
