"""Port parity for the matcher's core: the top-2 search and the gates.

The same seeded numpy descriptors (SIFT convention, with exact
duplicates, ties in both directions and padding masks) go through the
reference functions on the CPU and through the port's plain version (the
CPU branch of ``features/matching_kernels.py``).  The top-2 tables must be
exactly equal, padding included, against the reference's XLA branch; the
match tables exactly equal and the distances within 1e-6 against the
reference's ``match_many_pairs``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_match_cases import CASES, case

from privacy_preserving_sfm_tpu.features import matching as jm
from privacy_preserving_sfm_tpu.features import matching_kernels as jmk
from privacy_preserving_sfm_tpu.models.database import Database as JDatabase
from privacy_preserving_sfm_torch.features import matching as tm
from privacy_preserving_sfm_torch.features import matching_kernels as tmk
from privacy_preserving_sfm_torch.kernels import build as kernels
from privacy_preserving_sfm_torch.models.database import Database as TDatabase
from privacy_preserving_sfm_torch.utils.synthetic import sift_like

torch.set_num_threads(2)

NEG = -1e9


def _inputs(seed, b, n1, n2):
    """Descriptors (B, N1/N2, 128) uint8 and validity masks, with an exact
    duplicate making ties along a row (columns 40 and N2 - 1 both equal to
    row 7) and along a column (rows 7 and N1 - 1 both equal to column
    40), padding in pair 1 on both sides, and in pair 2 (when B > 2) a
    single valid candidate per row."""
    rng = np.random.default_rng(seed)
    d1 = sift_like(rng.dirichlet(np.full(128, 0.2), (b, n1)))
    d2 = sift_like(rng.dirichlet(np.full(128, 0.2), (b, n2)))
    d2[0, 40] = d2[0, n2 - 1] = d1[0, 7]
    d1[0, n1 - 1] = d1[0, 7]
    v1 = np.ones((b, n1), bool)
    v2 = np.ones((b, n2), bool)
    v1[1, (2 * n1) // 3:] = False
    v2[1, n2 // 2:] = False
    if b > 2:
        v2[2, 1:] = False
    return d1, d2, v1, v2


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


SHAPES = [(3, 384, 512), (2, 300, 200)]


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
@pytest.mark.parametrize("b,n1,n2", SHAPES)
def test_top2_matches_reference_xla_branch(b, n1, n2, entry):
    d1, d2, v1, v2 = _inputs(b + n1, b, n1, n2)
    ref = jm._top2_both_batched(*map(jnp.asarray, (d1, d2, v1, v2)))
    fn = (tm._top2_both_batched_plain if entry == "plain"
          else tmk.top2_scores_bidir)
    got = fn(*_torch(d1, d2, v1, v2))
    for name, r, g in zip(("bd12", "sd12", "idx12", "bd21", "sd21",
                           "idx21"), ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)
    bd12, sd12, idx12 = got[:3]
    assert idx12[0, 7] == 40 and bd12[0, 7] == sd12[0, 7]  # row tie
    assert got[5][0, 40] == 7 and got[3][0, 40] == got[4][0, 40]  # column
    rows_out = ~torch.from_numpy(v1[1])
    assert (bd12[1][rows_out] == NEG).all() and (idx12[1][rows_out] == 0).all()
    if b > 2:  # one valid candidate: second is the masked value
        assert (sd12[2] == NEG).all() and (idx12[2] == 0).all()


@pytest.mark.parametrize("mode", ["bidir", "rows"])
def test_top2_matches_reference_tpu_kernel_interpret(mode):
    """Against the TPU kernels run in interpret mode.  Those kernels fold
    validity into a -2^26 bias and return biased values for padded
    entries, so idx and best are compared on valid rows and columns only,
    and second only where at least two candidates are valid."""
    b, n1, n2 = 3, 384, 512
    d1, d2, v1, v2 = _inputs(5, b, n1, n2)
    if mode == "rows":
        v1[:] = True  # the row-only kernel takes no row mask
        ref = jmk.top2_scores(jnp.asarray(d1), jnp.asarray(d2),
                              jnp.asarray(v2), interpret=True)
        got = tmk.top2_scores(*_torch(d1, d2, v2))
        checks = [(ref, got, v1, v2)]
    else:
        ref = jmk.top2_scores_bidir(*map(jnp.asarray, (d1, d2, v1, v2)),
                                    interpret=True)
        got = tmk.top2_scores_bidir(*_torch(d1, d2, v1, v2))
        checks = [(ref[:3], got[:3], v1, v2), (ref[3:], got[3:], v2, v1)]
    for r, g, own, other in checks:
        n_cand = other.sum(1, keepdims=True)
        rows = own & (n_cand >= 1)
        two = own & (n_cand >= 2)
        r = [np.asarray(x) for x in r]
        g = [x.numpy() for x in g]
        np.testing.assert_array_equal(g[2][rows], r[2][rows])
        np.testing.assert_array_equal(g[0][rows], r[0][rows])
        np.testing.assert_array_equal(g[1][two], r[1][two])
        assert rows.sum() > 0 and two.sum() > 0


def _check_against_interpret(checks):
    """Compares tables where the TPU kernel defines them: idx and best on
    valid rows with a valid candidate, second where two are valid."""
    compared = 0
    for r, g, own, other in checks:
        n_cand = other.sum(1, keepdims=True)
        rows = own & (n_cand >= 1)
        two = own & (n_cand >= 2)
        r = [np.asarray(x) for x in r]
        g = [x.numpy() for x in g]
        np.testing.assert_array_equal(g[2][rows], r[2][rows])
        np.testing.assert_array_equal(g[0][rows], r[0][rows])
        np.testing.assert_array_equal(g[1][two], r[1][two])
        compared += int(two.sum())
    assert compared > 0


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("mode", ["bidir", "rows"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_top2_edges_match_reference(name, mode, transpose):
    """The kernel design's edges (largest dots, ties across 128-wide
    tiles, ragged and small N, masked rows and columns, B = 1), each way
    round: the port against the TPU kernel in interpret mode and,
    everywhere, against the reference's XLA branch."""
    d1, d2, v1, v2 = case(name, transpose)
    if mode == "rows":
        v1 = np.ones_like(v1)
        ref = jmk.top2_scores(jnp.asarray(d1), jnp.asarray(d2),
                              jnp.asarray(v2), interpret=True)
        got = tmk.top2_scores(*_torch(d1, d2, v2))
        checks = [(ref, got, v1, v2)]
    else:
        ref = jmk.top2_scores_bidir(*map(jnp.asarray, (d1, d2, v1, v2)),
                                    interpret=True)
        got = tmk.top2_scores_bidir(*_torch(d1, d2, v1, v2))
        checks = [(ref[:3], got[:3], v1, v2), (ref[3:], got[3:], v2, v1)]
    _check_against_interpret(checks)
    xla = jm._top2_both_batched(*map(jnp.asarray, (d1, d2, v1, v2)))
    for r, g in zip(xla, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# A plain-Python model of match_top2.cu's packed keys: key = (dot + start)
# * 256 + r, start 0 for a valid column and MASKED for a masked one or one
# past N, r = 254 - (position in the 128-wide tile), and r = CARRIED for a
# best carried from an earlier tile.
MASKED = -(1 << 23)
CARRIED = 255
NEG_I = -1000000000


def _merge(a, o):
    """The kernel's merge of two (best, second, idx) tops of disjoint
    index ranges: the larger best wins, the smaller index on a tie."""
    b, s, i = a
    ob, os_, oi = o
    other = (ob > b) | ((ob == b) & (oi < i))
    return (np.where(other, ob, b),
            np.where(other, np.maximum(b, os_), np.maximum(s, ob)),
            np.where(other, oi, i))


def _packed_rows(d1, d2, v1, v2, rng):
    """The rows' top-2 as match_top2.cu computes it: per thread of the
    four that share a row (lane ``t`` holds columns ``j * 8 + t * 2 + c``
    of a tile), the packed-key update over the thread's columns of each
    tile in an arbitrary order and the carry at each tile's end; then the
    threads' merge, in a random order."""
    cols = kernels.MATCH_COLS
    b, n1, _ = d1.shape
    n2 = d2.shape[1]
    ntiles = -(-n2 // cols)
    width = ntiles * cols
    dots = np.zeros((b, n1, width), np.int64)
    dots[:, :, :n2] = np.einsum("bik,bjk->bij", d1.astype(np.int64),
                                d2.astype(np.int64))
    start = np.full((b, width), MASKED, np.int64)
    start[:, :n2] = np.where(v2, 0, MASKED)
    pos = np.arange(width) % cols
    keys = (dots + start[:, None, :]) * 256 + (254 - pos)
    assert keys.max() < 2 ** 31 and keys.min() >= -2 ** 31
    keys = keys.astype(np.int32)
    owner = (pos[:cols] % 8) // 2
    threads = []
    for o in range(4):
        best = np.full((b, n1), np.iinfo(np.int32).min, np.int32)
        sec = best.copy()
        idx = np.zeros((b, n1), np.int32)
        for jt in range(ntiles):
            for j in rng.permutation(np.flatnonzero(owner == o)):
                k = keys[:, :, jt * cols + j]
                sec = np.maximum(sec, np.minimum(best, k))
                best = np.maximum(best, k)
            r = best & CARRIED
            idx = np.where(r != CARRIED, jt * cols + 254 - r, idx)
            best = best | CARRIED
        threads.append((np.where(best >= 0, best >> 8, NEG_I),
                        np.where(sec >= 0, sec >> 8, NEG_I),
                        np.where(best >= 0, idx, 0)))
    order = rng.permutation(4)
    top = threads[order[0]]
    for o in order[1:]:
        top = _merge(top, threads[o])
    top = tuple(np.where(v1, x, fill)
                for x, fill in zip(top, (NEG_I, NEG_I, 0)))
    return (top[0].astype(np.float32), top[1].astype(np.float32),
            top[2].astype(np.int32))


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_key_model_matches_plain(name, seed):
    """The packed keys, the masked sentinel and the carry across tiles
    give the plain version's six tables exactly, whatever the order in
    which a thread walks its columns and the four threads of a row
    merge (drawn from ``seed``)."""
    d1, d2, v1, v2 = case(name)
    rng = np.random.default_rng(seed)
    got = (_packed_rows(d1, d2, v1, v2, rng)
           + _packed_rows(d2, d1, v2, v1, rng))
    ref = tm._top2_both_batched_plain(*_torch(d1, d2, v1, v2))
    for name_, r, g in zip(("bd12", "sd12", "idx12", "bd21", "sd21",
                            "idx21"), ref, got):
        np.testing.assert_array_equal(g, r.numpy(), err_msg=name_)
    if name == "all_top":  # the top of the key range: 255^2 * 128
        assert got[0][0, 3] == 255 ** 2 * 128 and got[2][0, 3] == 10
        assert (got[2][1] == 0).all() and (got[1][1] == got[0][1]).all()
    if name == "tile_ties":  # the earlier side of each tile boundary wins
        assert (got[2][0, 5], got[2][0, 6]) == (127, 255)
        assert (got[5][0, 50], got[5][0, 60]) == (127, 255)


@pytest.mark.parametrize("cross_check", [True, False])
@pytest.mark.parametrize("n", [512, 300])
def test_match_many_pairs_matches_reference(n, cross_check):
    rng = np.random.default_rng(7)
    scene = rng.dirichlet(np.full(128, 0.2), n)
    lam = rng.uniform(0.05, 0.45, (4, n, 1))
    mixed = (1 - lam) * scene + lam * rng.dirichlet(np.full(128, 0.2),
                                                    (4, n))
    desc = sift_like(mixed)
    desc[1, 10] = desc[1, 11]  # duplicate candidates: ratio test rejects
    valid = np.ones((4, n), bool)
    valid[2, n // 3:] = False
    valid[3] = False
    pairs = np.array([[0, 1], [1, 2], [2, 0], [0, 3], [3, 1]], np.int32)
    ref = jm.match_many_pairs(jnp.asarray(desc), jnp.asarray(valid),
                              jnp.asarray(pairs), cross_check=cross_check)
    got = tm.match_many_pairs(torch.from_numpy(desc),
                              torch.from_numpy(valid),
                              torch.from_numpy(pairs).long(),
                              cross_check=cross_check)
    np.testing.assert_array_equal(got.matches.numpy(),
                                  np.asarray(ref.matches))
    np.testing.assert_array_equal(got.num_matches.numpy(),
                                  np.asarray(ref.num_matches))
    np.testing.assert_allclose(got.best_dist.numpy(),
                               np.asarray(ref.best_dist), rtol=0, atol=1e-6)
    assert int(got.num_matches[0]) > n // 2  # most true matches survive
    assert int(got.num_matches[3]) == 0  # no valid candidates


def test_match_descriptors_matches_reference():
    rng = np.random.default_rng(8)
    d1 = sift_like(rng.dirichlet(np.full(128, 0.2), 256))
    d2 = np.concatenate([d1[:100], sift_like(
        rng.dirichlet(np.full(128, 0.2), 156))])
    ref = jm.match_descriptors(jnp.asarray(d1), jnp.asarray(d2))
    got = tm.match_descriptors(torch.from_numpy(d1), torch.from_numpy(d2))
    np.testing.assert_array_equal(got.matches.numpy(),
                                  np.asarray(ref.matches))
    assert int(got.num_matches) == int(ref.num_matches) == 100


@pytest.mark.parametrize("n1,n2", [(256, 300), (1, 77), (130, 1)])
def test_descriptor_distances_matches_reference(n1, n2):
    """The angular distance matrix, float32 to 1e-6: the dots are exact
    integers in both packages, so only the two arccos implementations
    differ.  Duplicated descriptors give the distances near 0, and a
    zero descriptor the distance pi/2."""
    rng = np.random.default_rng(n1 + n2)
    d1 = sift_like(rng.dirichlet(np.full(128, 0.2), n1))
    d2 = sift_like(rng.dirichlet(np.full(128, 0.2), n2))
    k = min(n1, n2, 40)
    d2[:k] = d1[:k]
    d1[-1] = 0
    want = np.asarray(jm.descriptor_distances(jnp.asarray(d1),
                                              jnp.asarray(d2)))
    got = tm.descriptor_distances(torch.from_numpy(d1), torch.from_numpy(d2))
    assert got.dtype == torch.float32 and got.shape == (n1, n2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bad", ["device", "dtype", "shape", "mask"])
def test_match_kernel_wrapper_rejects_bad_inputs(bad):
    d1 = torch.zeros(1, 8, 128, dtype=torch.uint8)
    d2 = torch.zeros(1, 9, 128, dtype=torch.uint8)
    v1 = torch.ones(1, 8, dtype=torch.bool)
    v2 = torch.ones(1, 9, dtype=torch.bool)
    if bad == "device":
        d1, d2, v1, v2 = (t.to("meta") for t in (d1, d2, v1, v2))
        err = RuntimeError
    elif bad == "dtype":
        d1, err = d1.float(), TypeError
    elif bad == "shape":
        d2, err = d2[0], ValueError
    else:
        v2, err = v2[:, :4], ValueError
    with pytest.raises(err):
        tmk.top2_scores_bidir(d1, d2, v1, v2)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_database_reads_identically_in_both_packages(tmp_path, writer):
    rng = np.random.default_rng(9)
    path = str(tmp_path / "x.db")
    W, R = (TDatabase, JDatabase) if writer == "port" else (JDatabase,
                                                             TDatabase)
    desc = rng.integers(0, 256, (50, 128)).astype(np.uint8)
    lines = rng.standard_normal((50, 3)) * 3.0
    aligned = rng.random(50) < 0.5
    matches = rng.integers(0, 50, (20, 2)).astype(np.uint32)
    with W(path) as db:
        cam = db.write_camera("OPENCV", 640, 480, np.arange(8.0) + 1.0,
                              prior_focal=True)
        a = db.write_image("b.png", cam, prior_t=(47.0, 8.0, 400.0))
        b = db.write_image("a.png", cam)
        db.write_descriptors(a, desc)
        db.write_lines(a, lines, aligned)
        db.write_gravity(a, np.array([0.0, 1.0, 0.1]))
        db.write_matches(b, a, matches)  # image_id1 > image_id2: swapped
        db.write_matches(a, b + 5, matches[:0])
    dbs = [W(path), R(path)]
    try:
        for db in dbs:
            cams = db.read_cameras()
            assert cams[cam]["model"] == "OPENCV" and \
                cams[cam]["prior_focal_length"]
            np.testing.assert_array_equal(cams[cam]["params"],
                                          np.arange(8.0) + 1.0)
            assert db.read_images() == {a: {"name": "b.png", "camera_id": cam},
                                        b: {"name": "a.png", "camera_id": cam}}
            np.testing.assert_array_equal(db.read_descriptors(a), desc)
            assert db.count_descriptors(a) == 50
            got_lines, got_aligned = db.read_lines(a)
            ref_lines, ref_aligned = dbs[0].read_lines(a)
            np.testing.assert_array_equal(got_lines, ref_lines)
            np.testing.assert_array_equal(got_aligned, aligned)
            np.testing.assert_allclose(
                np.linalg.norm(got_lines[:, :2], axis=1), 1.0, atol=1e-12)
            np.testing.assert_array_equal(db.read_gravity(a),
                                          [0.0, 1.0, 0.1])
            np.testing.assert_array_equal(db.read_matches(b, a), matches)
            np.testing.assert_array_equal(db.read_matches(a, b),
                                          matches[:, ::-1])
            assert db.exists_matches(a, b + 5)
            assert list(db.read_all_matches()) == [(a, b)]
    finally:
        for db in dbs:
            db.close()
