"""Port parity for the whole matcher slice: schedulers and the CLI.

One seeded synthetic matching database (10 images x 200 descriptors,
known correspondences, overlap decaying with image distance so that some
pairs fall under ``min_num_matches``) is copied once per package.  The
reference and the port each match their copy on the CPU; the stored
match blobs must be byte-identical, in resident and in block mode, and
through each matcher subcommand.
"""

import inspect
import shutil
import sqlite3

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_tpu.exe import ppsfm as jcli
from privacy_preserving_sfm_tpu.features import schedulers as js
from privacy_preserving_sfm_tpu.models.database import Database as JDatabase
from privacy_preserving_sfm_torch.exe import ppsfm as tcli
from privacy_preserving_sfm_torch.features import schedulers as ts
from privacy_preserving_sfm_torch.models.database import Database as TDatabase
from privacy_preserving_sfm_torch.utils.synthetic import (
    match_quality, synthetic_matching_database,
)

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def scene_db(tmp_path_factory):
    path = tmp_path_factory.mktemp("match") / "scene.db"
    scene = synthetic_matching_database(str(path), 10, 200, seed=3,
                                        window=150, shift=30)
    return path, scene


def _copy(scene_db, tmp_path, name):
    dst = tmp_path / name
    shutil.copy(scene_db[0], dst)
    return dst


def _blobs(path):
    con = sqlite3.connect(str(path))
    try:
        return dict((r[0], r[1:]) for r in con.execute(
            "SELECT pair_id, rows, cols, data FROM matches ORDER BY pair_id"))
    finally:
        con.close()


@pytest.mark.parametrize("mode", ["resident", "block"])
def test_match_pair_list_blobs_equal_reference(scene_db, tmp_path, mode):
    resident = None if mode == "resident" else 8
    pj, pt = _copy(scene_db, tmp_path, "j.db"), _copy(scene_db, tmp_path,
                                                      "t.db")
    ids = scene_db[1].image_ids
    pairs = ts.exhaustive_pairs(ids)
    with JDatabase(str(pj)) as db:
        nj = js.match_pair_list(db, ids, pairs, max_resident_images=resident)
    with TDatabase(str(pt)) as db:
        nt = ts.match_pair_list(db, ids, pairs, max_resident_images=resident,
                                device=CPU)
        precision, recall, _ = match_quality(db, scene_db[1])
    assert nj == nt and 0 < nt < len(pairs)  # some pairs are zeroed
    assert _blobs(pt) == _blobs(pj)
    assert len(_blobs(pt)) == len(pairs)
    assert precision > 0.99 and recall > 0.9


def test_block_mode_equals_resident_mode(scene_db, tmp_path):
    ids = scene_db[1].image_ids
    pairs = ts.sequential_pairs(ids, overlap=3)
    out = []
    for name, resident in (("r.db", None), ("b.db", 3)):
        path = _copy(scene_db, tmp_path, name)
        with TDatabase(str(path)) as db:
            ts.match_pair_list(db, ids, pairs, min_num_matches=5,
                               max_resident_images=resident, device=CPU,
                               chunk=7)
        out.append(_blobs(path))
    assert out[0] == out[1] and len(out[0]) == len(pairs)


@pytest.mark.parametrize("kind", ["exhaustive", "sequential", "spatial",
                                  "transitive"])
def test_pair_generators_equal_reference(scene_db, tmp_path, kind):
    ids = list(reversed(scene_db[1].image_ids))
    if kind == "exhaustive":
        args = (ids, 4)
    elif kind == "sequential":
        args = (ids, 3)
    elif kind == "spatial":
        rng = np.random.default_rng(0)
        pos = {i: rng.uniform(0, 50, 3) for i in ids[:-1]}
        args = (ids, pos, 4, 30.0)
    else:
        path = _copy(scene_db, tmp_path, "tr.db")
        with TDatabase(str(path)) as db:
            ts.match_pair_list(db, ids, ts.sequential_pairs(ids, 1),
                               device=CPU)
        with TDatabase(str(path)) as tdb, JDatabase(str(path)) as jdb:
            got, ref = ts.transitive_pairs(tdb), js.transitive_pairs(jdb)
        assert got == ref and len(got) > 0
        return
    got = getattr(ts, f"{kind}_pairs")(*args)
    assert got == getattr(js, f"{kind}_pairs")(*args) and len(got) > 0


def _pair_list(tmp_path, scene, raw):
    names = {iid: f"im{k:04d}.png" for k, iid in enumerate(scene.image_ids)}
    path = tmp_path / "pairs.txt"
    with open(path, "w") as f:
        for (a, b), m in list(scene.true_matches.items())[::3]:
            f.write(f"{names[b]} {names[a]}\n")
            if raw:
                for i, j in m[:5]:
                    f.write(f"{j} {i}\n")
                f.write("\n")
        f.write("missing.png im0000.png\n\n" if raw else "x.png im0000.png\n")
    return str(path)


@pytest.mark.parametrize("cmd", ["exhaustive_matcher", "sequential_matcher",
                                 "spatial_matcher", "transitive_matcher",
                                 "matches_importer pairs",
                                 "matches_importer raw"])
def test_cli_writes_reference_match_tables(scene_db, tmp_path, cmd, capsys):
    name, *match_type = cmd.split()
    pj, pt = _copy(scene_db, tmp_path, "j.db"), _copy(scene_db, tmp_path,
                                                      "t.db")
    args = [name]
    if name == "sequential_matcher":
        args += ["--overlap", "2"]
    if name == "transitive_matcher":  # closes a sequential chain
        for path, match, Db in ((pj, js, JDatabase), (pt, ts, TDatabase)):
            with Db(str(path)) as db:
                ids = sorted(db.read_images())
                kw = {"device": CPU} if match is ts else {}
                match.match_pair_list(db, ids, ts.sequential_pairs(ids, 1),
                                      **kw)
    if match_type:
        args += ["--match_list_path",
                 _pair_list(tmp_path, scene_db[1], match_type[0] == "raw"),
                 "--match_type", match_type[0]]
    jcli.main(args + ["--database_path", str(pj)])
    tcli.main(args + ["--database_path", str(pt), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("=> ") == 2
    ref = _blobs(pj)
    assert _blobs(pt) == ref and len(ref) > 0


def test_database_creator(tmp_path):
    tcli.main(["database_creator", "--database_path",
               str(tmp_path / "new.db")])
    with JDatabase(str(tmp_path / "new.db")) as db:
        assert db.read_images() == {} and db.read_all_matches() == {}


@pytest.mark.parametrize("cmd", ["exhaustive_matcher", "spatial_matcher"])
def test_cuda_device_without_gpu_is_an_error(scene_db, tmp_path,
                                             monkeypatch, cmd):
    path = _copy(scene_db, tmp_path, "c.db")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([cmd, "--database_path", str(path), "--device", "cuda"])
    assert _blobs(path) == {}


def test_match_pair_list_runs_on_the_card_by_default():
    """An entry point runs on the card unless the caller asks for the CPU,
    as the CLI's ``--device`` does."""
    default = inspect.signature(ts.match_pair_list).parameters["device"]
    assert default.default == torch.device("cuda")
