"""Port parity for the mapper's host models: ``models/correspondence_graph``,
``graph_view``, ``native_graph`` and ``database_cache``.

One seeded mapper database (``utils.synthetic.synthetic_line_database``)
is loaded by the reference's ``DatabaseCache`` and the port's: the
cameras, images, lines, gravity, every feature's correspondences (direct
and transitive), the two-view flags and the CSR view are equal.  The
port's native graph is built from ``native/graph.cpp`` into its own build
directory and agrees with its Python graph, 4-view track assembly
included (as ``tests/test_native_graph.py`` holds the reference's).
"""

import os

import numpy as np
import pytest

from privacy_preserving_sfm_tpu.models import database as jdb
from privacy_preserving_sfm_tpu.models import database_cache as jdc
from privacy_preserving_sfm_torch.models import correspondence_graph as tcg
from privacy_preserving_sfm_torch.models import database as tdb
from privacy_preserving_sfm_torch.models import database_cache as tdc
from privacy_preserving_sfm_torch.models import native_graph as tng
from privacy_preserving_sfm_torch.utils.synthetic import (
    synthetic_line_database,
)


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("graph") / "g.db")
    synthetic_line_database(path, 6, 60, seed=3)
    with jdb.Database(path) as db:
        ref = jdc.DatabaseCache.load(db, min_num_matches=4)
    with tdb.Database(path) as db:
        port = tdc.DatabaseCache.load(db, min_num_matches=4)
    return ref, port


def test_native_graph_builds_into_the_port(caches):
    _, port = caches
    assert tng.available() and port.graph_kind == "native"
    assert os.path.dirname(tng._build()) == tng.BUILD_DIR
    assert tng.BUILD_DIR.endswith(os.path.join(
        "privacy_preserving_sfm_torch", "kernels", "_build"))


def test_cache_contents_match_reference(caches):
    ref, port = caches
    assert sorted(ref.cameras) == sorted(port.cameras)
    for cid, c in ref.cameras.items():
        p = port.cameras[cid]
        assert (p.model, p.width, p.height) == (c.model, c.width, c.height)
        np.testing.assert_array_equal(p.params, c.params)
    assert sorted(ref.images) == sorted(port.images)
    for iid, img in ref.images.items():
        p = port.images[iid]
        assert (p.name, p.camera_id) == (img.name, img.camera_id)
        np.testing.assert_array_equal(p.lines, img.lines)
        np.testing.assert_array_equal(p.aligned, img.aligned)
        np.testing.assert_array_equal(p.gravity, img.gravity)


def test_graph_queries_match_reference(caches):
    ref, port = caches
    assert port.graph.image_pairs() == ref.graph.image_pairs()
    assert port.graph.image_ids() == ref.graph.image_ids()
    for iid, img in ref.images.items():
        for li in range(img.num_lines):
            assert port.graph.find_correspondences(iid, li) \
                == ref.graph.find_correspondences(iid, li)
            assert sorted(port.graph.find_transitive_correspondences(
                iid, li, 3)) == sorted(
                ref.graph.find_transitive_correspondences(iid, li, 3))
            assert port.graph.is_two_view_observation(iid, li) \
                == ref.graph.is_two_view_observation(iid, li)


def test_graph_view_matches_reference(caches):
    ref, port = caches
    a, b = ref.view, port.view
    assert a.image_ids == b.image_ids and a.dense == b.dense
    for name in ("num_lines", "feat_offset", "row_offsets", "corr_flat",
                 "corr_img_dense", "corr_line", "degree", "line_of_corr",
                 "image_id_arr"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    assert a.num_obs_per_image == b.num_obs_per_image
    for iid in a.image_ids:
        np.testing.assert_array_equal(b.two_view_flags(iid),
                                      a.two_view_flags(iid))


def _graphs(rng, num_images, num_lines, pair_prob, k_range):
    py = tcg.CorrespondenceGraph()
    nat = tng.NativeCorrespondenceGraph()
    for a in range(1, num_images + 1):
        for b in range(a + 1, num_images + 1):
            if rng.uniform() > pair_prob:
                continue
            k = int(rng.integers(*k_range))
            m = np.stack([rng.choice(num_lines, k, replace=False),
                          rng.choice(num_lines, k, replace=False)],
                         1).astype(np.uint32)
            py.add_matches(a, b, m)
            nat.add_matches(a, b, m)
    py.finalize()
    nat.finalize()
    return py, nat


def _python_tracks(graph, seeds, aligned, want, cap=None):
    """The mapper's Python enumeration; ``cap`` applies native's stride
    subsample of a feature's correspondences."""
    out = {}
    for image_id in seeds:
        for li in range(len(aligned[image_id])):
            if bool(aligned[image_id][li]) != want:
                continue
            corrs = [c for c in graph.find_correspondences(image_id, li)
                     if bool(aligned[c[0]][c[1]]) == want]
            if cap is not None and len(corrs) > cap:
                stride = len(corrs) / cap
                corrs = [corrs[int(s * stride)] for s in range(cap)]
            n = len(corrs)
            for i in range(n):
                for j in range(i + 1, n):
                    for k in range(j + 1, n):
                        cand = sorted({(image_id, li), corrs[i], corrs[j],
                                       corrs[k]})
                        if len({c[0] for c in cand}) != 4:
                            continue
                        out.setdefault(tuple(c[0] for c in cand), set()).add(
                            tuple(c[1] for c in cand))
    return out


@pytest.mark.parametrize("fanout", ["under_cap", "over_cap"])
def test_native_track_assembly_matches_python(fanout):
    """Native 4-view track assembly against the Python enumeration: equal
    under 16 correspondences a feature; over it, native keeps an even
    stride of 16 of them (the Python graph keeps all)."""
    rng = np.random.default_rng(3)
    if fanout == "under_cap":
        py, nat = _graphs(rng, 6, 30, 0.9, (5, 25))
        n_img, n_lines, cap = 6, 30, None
    else:
        py, nat = _graphs(rng, 24, 12, 1.0, (10, 12))
        n_img, n_lines, cap = 24, 12, 16
    aligned = {i: (rng.uniform(size=n_lines) < 0.5).astype(np.uint8)
               for i in range(1, n_img + 1)}
    ids = list(range(1, n_img + 1))
    seeds = [1, 2, 3]
    for want in (True, False):
        got = nat.assemble_four_view_tracks(seeds, ids, aligned, want)
        got = {k: {tuple(int(v) for v in row) for row in rows}
               for k, rows in got.items()}
        assert got == _python_tracks(py, seeds, aligned, want, cap)
        if cap:
            full = _python_tracks(py, seeds, aligned, want)
            assert all(got[k] <= full[k] for k in got)
