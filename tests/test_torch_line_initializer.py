"""Port parity for the ``line_initializer`` slice as a whole: the mapper's
init path against the reference mapper, in float64.

On one seeded mapper database (``utils.synthetic.synthetic_line_database``,
8 images) the reference ``IncrementalMapper.register_initial_line_images``
runs with its init kernel wrapped (in this test, not in the package) so
that its inputs and result are captured:

  * the candidate sets and track arrays the port assembles equal the ones
    the reference passes to its kernel, with the native and with the
    Python graph (the reference pads to 10 sets and a x4 track grid; the
    port does not, so its arrays equal the reference's unpadded part);
  * fed the reference's own draws, the port's initializer solves the
    reference's kernel inputs to its poses (1e-8), inlier counts and
    success, set by set;
  * with the reference's 4 poses injected, the port's triangulation
    (Create/Continue, Complete, Merge) gives the same tracks, point ids
    and xyz to 1e-8.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_init import reference_draws

from privacy_preserving_sfm_tpu.models import database as jdb
from privacy_preserving_sfm_tpu.models import database_cache as jdc
from privacy_preserving_sfm_tpu.models import native_graph as jng
from privacy_preserving_sfm_tpu.sfm import incremental_mapper as jm
from privacy_preserving_sfm_torch.init import initializer as ti
from privacy_preserving_sfm_torch.models import database as tdb
from privacy_preserving_sfm_torch.models import database_cache as tdc
from privacy_preserving_sfm_torch.models import native_graph as tng
from privacy_preserving_sfm_torch.sfm import incremental_mapper as tm
from privacy_preserving_sfm_torch.utils.synthetic import (
    synthetic_line_database,
)

torch.set_num_threads(2)

NUM_SAMPLES = 256  # init hypotheses, both packages


@pytest.fixture(scope="module")
def db_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("init") / "s.db")
    synthetic_line_database(path, 8, 120, seed=0)
    return path


def reference_mapper(db_path, monkeypatch, graph, solve):
    """The reference mapper over ``db_path`` with ``graph`` ("native" or
    "python"); its init kernel's arguments and result are captured, and
    the kernel runs only when ``solve``.  Returns (mapper, capture)."""
    if graph == "python":
        monkeypatch.setattr(jng, "available", lambda: False)
    with jdb.Database(db_path) as db:
        cache = jdc.DatabaseCache.load(db, min_num_matches=4)
    assert isinstance(cache.graph, jng.NativeCorrespondenceGraph) \
        == (graph == "native")
    mapper = jm.IncrementalMapper(cache)
    mapper.begin_reconstruction(cache.to_reconstruction())
    captured = {}
    real = jm.IncrementalMapper._init_kernel_batch

    def wrapped(self, nb, na, nu, num_samples, chunk=128):
        run = real(self, nb, na, nu, num_samples, chunk) if solve else None

        def call(key, *args):
            captured["args"] = [np.array(a) for a in args]
            if run is None:  # no set succeeds: the mapper stops here
                return jm.init_mod.InitResult(
                    poses=np.zeros((nb, 4, 3, 4)),
                    inlier_ratio=np.zeros(nb), num_inliers=np.zeros(nb),
                    success=np.zeros(nb, bool), cams2d=None, points2d=None)
            res = run(key, *args)
            captured["result"] = res
            return res
        return call

    monkeypatch.setattr(jm.IncrementalMapper, "_init_kernel_batch", wrapped)
    opts = jm.MapperOptions(init_num_samples=NUM_SAMPLES)
    ok = mapper.register_initial_line_images(opts, cache)
    return mapper, captured, ok


def port_mapper(db_path, monkeypatch, graph):
    if graph == "python":
        monkeypatch.setattr(tng, "available", lambda: False)
    with tdb.Database(db_path) as db:
        cache = tdc.DatabaseCache.load(db, min_num_matches=4)
    assert cache.graph_kind == graph
    mapper = tm.IncrementalMapper("cpu", torch.float64, cache)
    mapper.begin_reconstruction(cache.to_reconstruction())
    return mapper, cache


@pytest.mark.parametrize("graph", ["native", "python"])
def test_init_sets_match_reference_kernel_inputs(db_path, monkeypatch,
                                                 graph):
    _, cap, ok = reference_mapper(db_path, monkeypatch, graph, solve=False)
    assert not ok
    al, av, un, uv, grav, max_err, min_tri, min_inl = cap["args"]
    mapper, cache = port_mapper(db_path, monkeypatch, graph)
    mapper._rng = np.random.default_rng(0)  # MapperOptions().seed
    sets = mapper.assemble_init_sets(tm.MapperOptions(), cache)
    s, n, m = len(sets.keys), sets.aligned.shape[2], sets.random.shape[2]
    assert 1 <= s <= 10 and len(al) == 10
    np.testing.assert_array_equal(sets.aligned, al[:s, :, :n])
    np.testing.assert_array_equal(sets.aligned_valid, av[:s, :n])
    np.testing.assert_array_equal(sets.random, un[:s, :, :m])
    np.testing.assert_array_equal(sets.random_valid, uv[:s, :m])
    np.testing.assert_array_equal(sets.gravity, grav[:s])
    np.testing.assert_array_equal(sets.max_error, max_err[:s])
    assert not av[:, n:].any() and not uv[:, m:].any()
    for b in range(s, 10):  # the reference repeats the last set
        np.testing.assert_array_equal(al[b], al[s - 1])
    assert (float(min_tri), int(min_inl)) == (2.0, 20)
    for key, g in zip(sets.keys, sets.gravity):
        np.testing.assert_array_equal(
            g, np.stack([cache.images[k].gravity for k in key]))


@pytest.fixture(scope="module")
def reference_init(db_path):
    """The reference mapper's whole init on the database (native graph,
    x64), its captured kernel result and its model."""
    mp = pytest.MonkeyPatch()
    try:
        mapper, cap, ok = reference_mapper(db_path, mp, "native", solve=True)
    finally:
        mp.undo()
    assert ok
    return mapper, cap


def test_triangulation_with_reference_poses_matches(db_path, monkeypatch,
                                                     reference_init):
    ref_mapper, cap = reference_init
    res = cap["result"]
    ratios = np.where(np.asarray(res.success),
                      np.asarray(res.inlier_ratio), -1.0)
    best = int(np.argmax(ratios))
    ref = ref_mapper.rec
    mapper, _ = port_mapper(db_path, monkeypatch, "native")
    mapper.register_initial_poses(ref.reg_image_ids,
                                  np.asarray(res.poses)[best])
    rec = mapper.rec
    assert rec.reg_image_ids == ref.reg_image_ids
    for iid in ref.reg_image_ids:
        np.testing.assert_array_equal(rec.images[iid].qvec,
                                      ref.images[iid].qvec)
        np.testing.assert_array_equal(rec.images[iid].point3d_ids,
                                      ref.images[iid].point3d_ids)
    assert len(ref.points3d) >= 40
    assert sorted(rec.points3d) == sorted(ref.points3d)
    for pid, p in ref.points3d.items():
        assert rec.points3d[pid].track == p.track
        np.testing.assert_allclose(rec.points3d[pid].xyz, p.xyz, rtol=1e-8,
                                   atol=1e-8)


def test_initializer_solves_the_reference_sets(reference_init):
    """Every candidate set of the reference's kernel call, with the
    reference's draws (its vmap gives every set the same key)."""
    _, cap = reference_init
    al, av, un, uv, grav, max_err, min_tri, min_inl = cap["args"]
    ref = cap["result"]
    key = jax.random.PRNGKey(0)  # MapperOptions().seed
    per_set = [reference_draws(key, av[b], uv[b], NUM_SAMPLES)
               for b in range(len(al))]
    draws = ti.InitDraws(*(torch.cat(d) for d in zip(*per_set)))
    opts = ti.InitOptions(min_tri_angle_deg=float(min_tri),
                          min_num_inliers=int(min_inl),
                          num_samples_fourview=NUM_SAMPLES,
                          num_samples_offset=NUM_SAMPLES)
    res = ti.initialize_reconstruction(
        *(torch.from_numpy(a) for a in (al, av, un, uv, grav, max_err)),
        draws, opts)
    assert np.asarray(ref.success).any()
    np.testing.assert_array_equal(res.success.numpy(),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(res.num_inliers.numpy(),
                                  np.asarray(ref.num_inliers))
    np.testing.assert_allclose(res.poses.numpy(), np.asarray(ref.poses),
                               rtol=1e-8, atol=1e-8)
