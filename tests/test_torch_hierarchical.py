"""Port parity: the hierarchical mapper (``sfm/hierarchical.py``) against
the JAX package.

``partition_sequential`` and ``umeyama`` equal the reference's;
``merge_into`` on the same snapshots (one model in two gauges, and a
block of it) builds the same model in either package; the restricted
``DatabaseCache.load`` keeps the database's image ids, on which the merge
keys its tracks; ``hierarchical_map`` on ``tests/test_hierarchical.py``'s
two-block database meets that test's bars on the CPU; one and two worker
processes write byte-identical models; every block job gets the device
asked for with its index, and a snapshot from another device or index
raises.
"""

import os

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.models import database as tdb
from privacy_preserving_sfm_torch.models import database_cache as tcache
from privacy_preserving_sfm_torch.sfm import hierarchical as thier
from privacy_preserving_sfm_torch.sfm.controller import (
    ControllerOptions, IncrementalMapperController,
)
from privacy_preserving_sfm_torch.sfm.incremental_mapper import MapperOptions
from privacy_preserving_sfm_tpu.models import database as jdb
from privacy_preserving_sfm_tpu.models import database_cache as jcache
from privacy_preserving_sfm_tpu.sfm import hierarchical as jhier

from test_e2e_synthetic import ate_rmse, build_synthetic_db

torch.set_num_threads(2)

# tests/test_e2e_synthetic.py's FAST options.
FAST = ControllerOptions(mapper=MapperOptions(
    num_hypotheses=512, init_num_samples=256, abs_pose_min_num_inliers=15),
    min_model_size=4, verbose=False)


@pytest.mark.parametrize("n,block,overlap", [(23, 10, 3), (16, 8, 3),
                                             (16, 10, 4), (5, 8, 3),
                                             (30, 30, 5), (12, 4, 1)])
def test_partition_sequential_equals_the_reference(n, block, overlap):
    names = [f"i{k:02d}" for k in range(n)][::-1]
    assert thier.partition_sequential(names, block, overlap) == \
        jhier.partition_sequential(names, block, overlap)


def test_partition_rejects_overlap_not_below_block():
    for mod in (thier, jhier):
        with pytest.raises(ValueError):
            mod.partition_sequential(["a", "b", "c", "d"], 3, 3)


@pytest.mark.parametrize("seed,reflect", [(0, False), (1, True), (2, False)])
def test_umeyama_equals_the_reference(seed, reflect):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((12, 3))
    dst = 1.7 * src @ np.linalg.qr(rng.standard_normal((3, 3)))[0].T \
        + rng.standard_normal(3) + rng.normal(0, 0.01, (12, 3))
    if reflect:
        dst[:, 2] *= -1
    want = jhier.umeyama(src, dst)
    got = thier.umeyama(src, dst)
    assert abs(got[0] - want[0]) < 1e-12
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def merge_scene(tmp_path_factory):
    """An 8-image model from the port's controller and its snapshots: as
    it is, in a rotated, scaled and shifted gauge, and the last 5 images'
    part of the second."""
    path = str(tmp_path_factory.mktemp("merge") / "scene.db")
    build_synthetic_db(path, np.random.default_rng(5), num_images=8,
                       num_points=100)
    recs = IncrementalMapperController(FAST, database_path=path,
                                       device="cpu",
                                       dtype=torch.float32).run()
    rec = max(recs, key=lambda r: r.num_registered())
    snap_a = thier.snapshot_model(rec)
    ang = 0.4
    R = np.array([[1.0, 0, 0], [0, np.cos(ang), -np.sin(ang)],
                  [0, np.sin(ang), np.cos(ang)]])
    rec.transform(1.7, R, np.array([3.0, -1.0, 2.0]))
    snap_b = thier.snapshot_model(rec)
    last = sorted(snap_b["poses"])[-5:]
    snap_c = {"poses": {i: snap_b["poses"][i] for i in last},
              "points": [(xyz, [o for o in track if o[0] in last])
                         for xyz, track in snap_b["points"]]}
    return path, rec.num_registered(), (snap_a, snap_b, snap_c)


def empty_model(cache_mod, db_mod, path):
    with db_mod.Database(path) as db:
        merged = cache_mod.DatabaseCache.load(db, 15).to_reconstruction()
    for img in merged.images.values():
        img.registered = False
        img.point3d_ids = np.full(img.num_lines, -1, np.int64)
    merged.reg_image_ids = []
    return merged


def model_state(rec):
    return (sorted(rec.reg_image_ids),
            {iid: (rec.images[iid].qvec, rec.images[iid].tvec)
             for iid in rec.reg_image_ids},
            {pid: (p.xyz, sorted(p.track)) for pid, p in rec.points3d.items()})


@pytest.mark.parametrize("order", [(0, 1), (0, 2), (2, 0)])
def test_merge_into_builds_the_reference_model(merge_scene, order):
    """Two snapshots merged one after the other into an empty model, by
    each package: the same registered images, poses to 1e-12, points and
    tracks (``test_merge_into_anchors_and_tracks``' two gauges, and a
    block of five images after or before the whole)."""
    path, num_reg, snaps = merge_scene
    tm = empty_model(tcache, tdb, path)
    jm = empty_model(jcache, jdb, path)
    for k in order:
        assert thier.merge_into(tm, snaps[k]) == \
            jhier.merge_into(jm, snaps[k]) is True
    treg, tposes, tpts = model_state(tm)
    jreg, jposes, jpts = model_state(jm)
    assert treg == jreg and len(treg) == num_reg
    for iid in treg:
        for g, w in zip(tposes[iid], jposes[iid]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    assert tpts.keys() == jpts.keys() and len(tpts) > 30
    for pid, (xyz, track) in tpts.items():
        np.testing.assert_allclose(xyz, jpts[pid][0], rtol=0, atol=1e-12)
        assert track == jpts[pid][1]
    if order == (0, 1):  # the same model from another gauge adds nothing
        fresh = empty_model(tcache, tdb, path)
        thier.merge_into(fresh, snaps[0])
        assert len(fresh.points3d) == len(tm.points3d)
    for pid, pt in tm.points3d.items():
        for iid, li in pt.track:
            assert tm.images[iid].point3d_ids[li] == pid


def test_merge_needs_min_common_anchors(merge_scene):
    path, _, (snap_a, _, snap_c) = merge_scene
    first = sorted(snap_a["poses"])[:2]
    few = {"poses": {i: snap_a["poses"][i] for i in first}, "points": []}
    tm = empty_model(tcache, tdb, path)
    assert thier.merge_into(tm, few)
    assert not thier.merge_into(tm, snap_c, min_common=3)
    assert sorted(tm.reg_image_ids) == first


def test_restricted_cache_keeps_the_database_ids(tmp_path):
    path = str(tmp_path / "scene.db")
    build_synthetic_db(path, np.random.default_rng(2), num_images=8,
                       num_points=100)
    with tdb.Database(path) as db:
        ids = {v["name"]: k for k, v in db.read_images().items()}
        names = sorted(ids)[3:7]
        cache = tcache.DatabaseCache.load(db, 15, image_names=set(names))
    assert sorted(cache.images) == sorted(ids[n] for n in names)
    assert all(cache.images[ids[n]].name == n for n in names)
    with jdb.Database(path) as db:
        jc = jcache.DatabaseCache.load(db, 15, image_names=set(names))
    assert sorted(jc.images) == sorted(cache.images)
    assert min(cache.images) > 1  # not renumbered from the first


@pytest.fixture(scope="module")
def two_blocks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("two_blocks") / "scene.db")
    qs, ts, _, image_ids = build_synthetic_db(
        path, np.random.default_rng(3), num_images=16, num_points=200,
        drop_prob=0.08)
    return path, qs, ts, image_ids


def test_hierarchical_two_blocks_meets_the_reference_bars(two_blocks):
    """``tests/test_hierarchical.py::test_hierarchical_two_blocks``'s
    database and bars, on the port."""
    path, qs, ts, image_ids = two_blocks
    stats = {}
    rec = thier.hierarchical_map(
        path, thier.HierarchicalOptions(block_size=10, overlap=4,
                                        controller=FAST),
        device="cpu", verbose=False, stats=stats)
    assert rec is not None
    assert rec.num_registered() >= 15, rec.num_registered()
    assert ate_rmse(rec, qs, ts, image_ids) < 0.05
    assert rec.compute_mean_reprojection_error() < 1.0
    assert stats["blocks"] == stats["reconstructed"] == stats["merged"] == 2
    assert [s["device"] for s in stats["snapshots"]] == ["cpu", "cpu"]
    assert stats["refined_points"] > 0 and stats["merged_points"] > 0


def test_one_and_two_workers_write_the_same_model(tmp_path, monkeypatch):
    """``num_workers`` 2 (spawned processes, each capped at this process's
    torch threads) gives the bytes ``num_workers`` 1 gives."""
    path = str(tmp_path / "scene.db")
    qs, ts, _, image_ids = build_synthetic_db(
        path, np.random.default_rng(7), num_images=12, num_points=150)
    monkeypatch.setenv("PPSFM_WORKER_THREADS", str(torch.get_num_threads()))
    texts = []
    for workers in (1, 2):
        rec = thier.hierarchical_map(
            path, thier.HierarchicalOptions(block_size=8, overlap=4,
                                            num_workers=workers,
                                            controller=FAST),
            device="cpu", verbose=False)
        assert rec.num_registered() >= 11
        assert ate_rmse(rec, qs, ts, image_ids) < 0.05
        out = str(tmp_path / f"w{workers}")
        rec.write_text(out)
        texts.append({n: open(os.path.join(out, n), "rb").read()
                      for n in ("cameras.txt", "images.txt",
                                "points3D.txt")})
    assert texts[0] == texts[1]


def test_a_snapshot_from_another_device_raises(two_blocks, monkeypatch):
    path = two_blocks[0]
    work = thier._block_worker

    def elsewhere(args):
        snap = work(args)
        snap["device"] = "cuda"
        return snap

    monkeypatch.setattr(thier, "_block_worker", elsewhere)
    with pytest.raises(RuntimeError, match="ran on cuda, not cpu"):
        thier.hierarchical_map(
            path, thier.HierarchicalOptions(block_size=10, overlap=4,
                                            controller=FAST),
            device="cpu", verbose=False)


def test_every_block_job_gets_the_device_index(two_blocks, monkeypatch):
    """Asked for ``cuda:1``, every block job gets ``"cuda:1"``, not the
    device type (which would run the blocks on the current card)."""
    seen = []

    def recorder(args):
        seen.append(args[3])
        return None

    monkeypatch.setattr(thier, "_block_worker", recorder)
    assert thier.hierarchical_map(
        two_blocks[0], thier.HierarchicalOptions(block_size=10, overlap=4,
                                                 controller=FAST),
        device="cuda:1", verbose=False) is None
    assert seen == ["cuda:1", "cuda:1"]


def test_a_snapshot_from_another_device_index_raises(two_blocks,
                                                     monkeypatch):
    def on_card_0(args):
        return {"poses": {}, "points": [], "device": "cuda:0",
                "seconds": 0.0, "profile": {}, "launches": {}}

    monkeypatch.setattr(thier, "_block_worker", on_card_0)
    with pytest.raises(RuntimeError, match="ran on cuda:0, not cuda:1"):
        thier.hierarchical_map(
            two_blocks[0], thier.HierarchicalOptions(
                block_size=10, overlap=4, controller=FAST),
            device="cuda:1", verbose=False)
