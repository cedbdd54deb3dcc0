"""Port parity: the sharded BA and the sharded matcher (``parallel/``)
against the JAX package.

``shard_problem``'s arrays and ``meta`` equal the reference's for 1, 2, 4
and 8 shards, and so do the pair lists. A gloo world of 4 CPU ranks
(``tests/torch_dist_worker.py``) solves ``tests/test_ba.py``'s problem (6
cameras, 60 points, as ``tests/test_parallel.py``) and one with line noise;
it agrees with the reference's ``bundle_adjust_sharded`` on a 4-device mesh
to 1e-6 in poses and points and 1e-8 relative in cost (float64), with equal
iteration counts on the noisy problem (the zero-noise one reaches cost <
1e-12, as the reference test asks), and every rank returns the same cameras
and summary. A world of one rank gives the bits of ``ba.bundle_adjust``.
The sharded matcher (the plain top-2 on the CPU) equals the unsharded one
on ``tests/test_parallel.py``'s inputs and on an uneven pair count padded
with [0, 0] pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_worker import BA_FIELDS, start_world, wait_world

from privacy_preserving_sfm_torch.optim import ba as tba
from privacy_preserving_sfm_torch.parallel import distributed_ba as tdba
from privacy_preserving_sfm_torch.parallel import sharded_matching as tsm
from privacy_preserving_sfm_tpu.parallel import distributed_ba as jdba
from privacy_preserving_sfm_tpu.parallel import sharded_matching as jsm

from test_ba import make_ba_problem

torch.set_num_threads(2)
WORLD = 4


def problems():
    """name -> the reference's BAProblem: ``tests/test_parallel.py``'s
    zero-noise problem and one with line noise."""
    clean = make_ba_problem(np.random.default_rng(0), num_cams=6,
                            num_points=60)[0]
    noisy = make_ba_problem(np.random.default_rng(4), num_cams=6,
                            num_points=60)[0]
    rng = np.random.default_rng(5)
    lines = np.asarray(noisy.obs_line) + rng.normal(0, 2e-3, (360, 3))
    lines /= np.linalg.norm(lines[:, :2], axis=-1, keepdims=True)
    return {"clean": clean, "noisy": noisy._replace(
        obs_line=jnp.asarray(lines))}


def with_padding(problem):
    """``problem`` with zero-weight observations (which the shards drop)
    and a point that only they observe."""
    weight = np.ones(360)
    weight[[17, 100, 101]] = 0.0
    obs_point = np.asarray(problem.obs_point).copy()
    obs_point[[100, 101]] = 59
    weight[obs_point == 59] = 0.0
    return problem._replace(obs_weight=jnp.asarray(weight),
                            obs_point=jnp.asarray(obs_point))


def to_torch(problem):
    return tba.BAProblem(*(torch.tensor(np.asarray(x)) for x in problem))


def match_inputs():
    """``tests/test_parallel.py:46``'s descriptors and pairs, and an
    uneven list of 11 pairs padded to 12 as the reference pads."""
    rng = np.random.default_rng(2)
    d = rng.dirichlet(np.ones(128), (4, 32))
    desc = np.clip(np.round(512 * np.sqrt(d)), 0, 255).astype(np.uint8)
    desc[1] = desc[0]
    desc[3] = desc[2]
    pairs = np.asarray([[0, 1], [2, 3], [0, 2], [1, 3],
                        [0, 3], [1, 2], [0, 1], [2, 3]], np.int32)
    uneven = np.concatenate([rng.integers(0, 4, (11, 2)),
                             np.zeros((1, 2))]).astype(np.int32)
    return desc, np.ones((4, 32), bool), pairs, uneven


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["clean", "noisy", "padded"])
def test_shard_problem_equals_the_reference(name, n_shards):
    problem = (with_padding(problems()["noisy"]) if name == "padded"
               else problems()[name])
    want, wmeta = jdba.shard_problem(problem, n_shards)
    got, gmeta = tdba.shard_problem(to_torch(problem), n_shards)
    for f, g, w in zip(BA_FIELDS, got, want):
        assert g.shape == w.shape, f
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
    assert gmeta.keys() == wmeta.keys()
    for k in ("points_per_shard", "obs_per_shard"):
        assert gmeta[k] == wmeta[k]
    for k in ("point_shard", "point_slot"):
        assert gmeta[k].dtype == wmeta[k].dtype
        np.testing.assert_array_equal(gmeta[k], wmeta[k])


@pytest.mark.parametrize("n,block", [(10, 4), (45, 50), (23, 7), (1, 50),
                                     (64, 16)])
def test_exhaustive_pair_list_equals_the_reference(n, block):
    got = tsm.exhaustive_pair_list(n, block_size=block)
    want = jsm.exhaustive_pair_list(n, block_size=block)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,overlap,quad", [(20, 3, True), (20, 3, False),
                                            (50, 10, True), (5, 10, True)])
def test_sequential_pair_list_equals_the_reference(n, overlap, quad):
    got = tsm.sequential_pair_list(n, overlap, quad)
    want = jsm.sequential_pair_list(n, overlap, quad)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def reference_solves():
    """The reference's sharded solve on a 4-device mesh (float64)."""
    assert len(jax.devices()) >= WORLD, "conftest should provide 8 devices"
    mesh = jdba.make_mesh(WORLD)
    out = {}
    for name, problem in problems().items():
        sharded, meta = jdba.shard_problem(problem, WORLD)
        q, t, X, s = jdba.bundle_adjust_sharded(sharded, mesh,
                                                "SIMPLE_PINHOLE")
        out[name] = (np.asarray(q), np.asarray(t), np.asarray(X),
                     float(s.final_cost), int(s.num_iterations))
    return out


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    """A world of 4 ranks and a world of 1 (each one set of processes, run
    side by side), their outputs by world size and rank, and the
    reference's solves, computed while the worlds run."""
    work = tmp_path_factory.mktemp("dist")
    inputs = {}
    for name, p in problems().items():
        for f, x in zip(BA_FIELDS, p):
            inputs[f"{name}.{f}"] = np.asarray(x)
    desc, valid, pairs, uneven = match_inputs()
    inputs.update(desc=desc, valid=valid, pairs=pairs.astype(np.int64),
                  pairs_uneven=uneven.astype(np.int64))
    started = {}
    for n in (WORLD, 1):
        d = work / f"w{n}"
        d.mkdir()
        np.savez(d / "inputs.npz", **inputs)
        started[n] = (d, start_world(n, "solve", str(d)))
    reference = reference_solves()
    worlds = {}
    for n, (d, world) in started.items():
        wait_world(world)
        worlds[n] = [dict(np.load(d / f"solve_{r}.npz")) for r in range(n)]
    return worlds, reference


@pytest.fixture(scope="module")
def worlds(solves):
    return solves[0]


@pytest.mark.parametrize("name", ["clean", "noisy"])
def test_four_rank_solve_matches_the_reference(solves, name):
    worlds, reference = solves
    ranks = worlds[WORLD]
    first = ranks[0]
    for r in ranks[1:]:  # cameras and summary the same on every rank
        for k in ("q", "t", "summary", "X_all", "calls"):
            np.testing.assert_array_equal(r[f"{name}.{k}"],
                                          first[f"{name}.{k}"])
    q, t, X, cost, iters = reference[name]
    np.testing.assert_allclose(first[f"{name}.q"], q, rtol=0, atol=1e-6)
    np.testing.assert_allclose(first[f"{name}.t"], t, rtol=0, atol=1e-6)
    np.testing.assert_allclose(first[f"{name}.X_all"], X, rtol=0, atol=1e-6)
    local = np.concatenate([r[f"{name}.X"] for r in ranks])
    np.testing.assert_array_equal(local, first[f"{name}.X_all"])
    initial, final, got_iters, _ = first[f"{name}.summary"]
    if name == "clean":
        # At zero noise the stop is decided by round-off near a cost of
        # 1e-25: the reference's own count for this problem changes with
        # its number of devices, so counts are held on the noisy one.
        assert final < 1e-12 and cost < 1e-12, (final, cost)
    else:
        assert int(got_iters) == iters
        assert abs(final - cost) <= 1e-8 * cost, (final, cost)
    # Per LM iteration: the cost, the max, the camera blocks, gradient,
    # right-hand side and Schur-Jacobi blocks, one sum a CG step (30);
    # plus the first cost.
    assert 0 < int(first[f"{name}.calls"]) <= 1 + got_iters * (2 + 4 + 30)


def test_make_mesh_takes_the_first_ranks(worlds):
    for rank, out in enumerate(worlds[WORLD]):
        assert ("sub" in out) == (rank < 2)
    np.testing.assert_array_equal(worlds[WORLD][0]["sub"], [2, 2])


@pytest.mark.parametrize("name", ["clean", "noisy"])
def test_one_rank_world_is_bit_equal_to_bundle_adjust(worlds, name):
    (only,) = worlds[1]
    for k in ("q", "t", "summary"):
        np.testing.assert_array_equal(only[f"{name}.{k}"],
                                      only[f"{name}.ref_{k}"])
    np.testing.assert_array_equal(only[f"{name}.X"], only[f"{name}.ref_X"])


@pytest.mark.parametrize("n", [WORLD, 1])
@pytest.mark.parametrize("key", ["pairs", "pairs_uneven"])
def test_sharded_matcher_equals_the_unsharded_one(worlds, n, key):
    B = 8 if key == "pairs" else 12
    for rank, out in enumerate(worlds[n]):
        for f in ("matches", "num_matches", "best_dist"):
            np.testing.assert_array_equal(out[f"{key}.{f}"],
                                          out[f"{key}.full_{f}"])
            per = B // n
            np.testing.assert_array_equal(
                out[f"{key}.local_{f}"],
                out[f"{key}.full_{f}"][rank * per:(rank + 1) * per])
    m = worlds[n][0]["pairs.matches"]
    assert (m[0] == np.arange(32)).all() and (m[1] == np.arange(32)).all()


def test_levenberg_marquardt_reads_the_reduced_gradient():
    """The gradient test reads ``reduce_max``'s value: a reduction that
    returns 0 stops the solve after one iteration, and the identity keeps
    ``bundle_adjust``'s bits."""
    problem = to_torch(problems()["noisy"])
    opts = tba.BAOptions(gradient_tolerance=1e-6, max_iterations=6)
    want = tba.bundle_adjust(problem, "SIMPLE_PINHOLE", opts)
    same = tba.implicit_schur_lm(problem, "SIMPLE_PINHOLE", opts)
    for a, b in zip(want[:3], same[:3]):
        assert torch.equal(a, b)
    assert want[3] == same[3] and want[3].num_iterations > 1
    seen = []

    def zero(g):
        seen.append(g)
        return torch.zeros_like(g)

    stopped = tba.implicit_schur_lm(problem, "SIMPLE_PINHOLE", opts,
                                    reduce_max=zero)
    assert stopped[3].num_iterations == 1
    assert len(seen) == 1 and seen[0].shape == () and float(seen[0]) > 1e-6


def test_no_world_raises():
    desc, valid, pairs, _ = match_inputs()
    with pytest.raises(RuntimeError, match="not initialized"):
        tsm.match_pairs_sharded(torch.from_numpy(desc),
                                torch.from_numpy(valid),
                                torch.from_numpy(pairs))
    with pytest.raises(RuntimeError, match="not initialized"):
        tdba.make_mesh()
