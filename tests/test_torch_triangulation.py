"""Port parity for robust line triangulation: ``solvers/triangulation.py``
and ``solvers/triangulation_batch.py``, on
``tests/test_triangulation_estimator.py``'s cases.

The same seeded tracks go through the reference (float64) and the port on
the CPU in float64: the same triples are tried (the deterministic triple
sets are equal arrays), so the same best triple wins, with equal inlier
masks and counts and the point to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_triangulation_estimator import make_track

from privacy_preserving_sfm_tpu.solvers import triangulation as jte
from privacy_preserving_sfm_tpu.solvers import triangulation_batch as jtb
from privacy_preserving_sfm_torch.solvers import triangulation as tte
from privacy_preserving_sfm_torch.solvers import triangulation_batch as ttb

torch.set_num_threads(2)

CAM = ("SIMPLE_PINHOLE", 640, 480)
PARAMS = np.array([500.0, 320.0, 240.0])
# The reference estimators compiled once a shape (eager dispatch of their
# many small ops costs more than the compile).
J_EST = jax.jit(jte.estimate_triangulation, static_argnums=(5, 6, 7))
J_BATCH = jax.jit(jtb.estimate_triangulation_batch, static_argnums=(5, 6, 7),
                  static_argnames=("residual",))


def t(a):
    return torch.from_numpy(np.array(a))


def same_result(port, ref, tol=1e-9):
    np.testing.assert_array_equal(port.success.numpy(),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(port.num_inliers.numpy(),
                                  np.asarray(ref.num_inliers))
    np.testing.assert_array_equal(port.inlier_mask.numpy(),
                                  np.asarray(ref.inlier_mask))
    np.testing.assert_allclose(port.point3d.numpy(), np.asarray(ref.point3d),
                               rtol=tol, atol=tol)


def corrupt(rng, lines, idx):
    lines = np.array(lines)
    bad = rng.standard_normal((len(idx), 3))
    lines[idx] = bad / np.linalg.norm(bad[:, :2], axis=-1, keepdims=True)
    return lines


def cases():
    """(name, lines, projs, centers, valid, max_angle_deg) per case."""
    out = []
    rng = np.random.default_rng(0)
    _, lines, projs, centers = make_track(rng, n_obs=8)
    out.append(("clean", lines, projs, centers, np.ones(8, bool), 2.0))
    rng = np.random.default_rng(1)
    _, lines, projs, centers = make_track(rng, n_obs=10)
    out.append(("outliers", corrupt(rng, lines, [1, 4, 7]), projs, centers,
                np.ones(10, bool), 2.0))
    rng = np.random.default_rng(2)
    _, lines, projs, centers = make_track(rng, n_obs=5)
    pad = rng.standard_normal((3, 3))
    pad /= np.linalg.norm(pad[:, :2], axis=-1, keepdims=True)
    out.append(("padding", np.concatenate([lines, pad]),
                np.concatenate([projs, np.tile(np.eye(3, 4), (3, 1, 1))]),
                np.concatenate([centers, np.zeros((3, 3))]),
                np.array([True] * 5 + [False] * 3), 2.0))
    rng = np.random.default_rng(7)
    _, lines, projs, centers = make_track(rng, n_obs=24)
    lines = lines.copy()
    for i in range(18):
        hom = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), 1.0])
        line = np.cross(rng.standard_normal(3), hom)
        lines[i] = line / np.linalg.norm(line[:2])
    out.append(("long24", lines, projs, centers, np.ones(24, bool), 0.5))
    return out


CASES = cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_estimate_triangulation_matches_reference(case):
    _, lines, projs, centers, valid, max_deg = case
    n = len(lines)
    params = np.broadcast_to(PARAMS, (n, 3))
    args = (lines, projs, centers, params, valid)
    ref = J_EST(*(jnp.asarray(a) for a in args), *CAM, np.deg2rad(max_deg),
                np.deg2rad(1.5))
    got = tte.estimate_triangulation(
        *(t(a) for a in args), *CAM, max_angle_error_rad=np.deg2rad(max_deg),
        min_tri_angle_rad=np.deg2rad(1.5))
    assert bool(got.success)
    same_result(got, ref)


def test_triple_sets_are_the_reference_arrays():
    for n in (3, 9, 15, 24):
        np.testing.assert_array_equal(tte._combinations3(n),
                                      jte._combinations3(n))
    for n, m in ((24, 512), (64, 2048)):
        np.testing.assert_array_equal(tte._keyless_combinations(n, m),
                                      jte._keyless_combinations(n, m))
    for n, cap in ((9, 512), (24, 512), (40, 300)):
        np.testing.assert_array_equal(ttb._capped_combinations(n, cap),
                                      jtb._capped_combinations(n, cap))


def test_generator_samples_a_long_track():
    """With a generator, a 40-observation track takes uniform random
    triples (drawn on the CPU) and still finds its point."""
    rng = np.random.default_rng(3)
    point, lines, projs, centers = make_track(rng, n_obs=40)
    lines = corrupt(rng, lines, list(range(0, 40, 5)))
    params = np.broadcast_to(PARAMS, (40, 3))
    res = tte.estimate_triangulation(
        t(lines), t(projs), t(centers), t(params), torch.ones(40, dtype=bool),
        *CAM, np.deg2rad(2.0), np.deg2rad(1.5),
        generator=torch.Generator().manual_seed(0))
    assert bool(res.success) and int(res.num_inliers) >= 25
    np.testing.assert_allclose(res.point3d.numpy(), point, atol=1e-6)


def _batch(rng, n_tracks, n_obs):
    tracks = [make_track(rng, n_obs=n_obs) for _ in range(n_tracks)]
    lines = np.stack([tr[1] for tr in tracks])
    projs = np.stack([tr[2] for tr in tracks])
    centers = np.stack([tr[3] for tr in tracks])
    params = np.broadcast_to(PARAMS, (n_tracks, n_obs, 3))
    return tracks, lines, projs, centers, params


@pytest.mark.parametrize("residual,max_err", [
    ("angular", np.deg2rad(2.0)), ("pixel", 4.0)])
def test_batch_estimator_matches_reference(residual, max_err):
    """``TestEstimateTriangulationBatch``'s tracks: corrupted observations
    and a track with padding slots, both residuals."""
    rng = np.random.default_rng(11)
    tracks, lines, projs, centers, params = _batch(rng, 12, 9)
    for k in (2, 5, 9):
        lines[k] = corrupt(rng, lines[k], [1, 6])
    valid = np.ones((12, 9), bool)
    valid[3, 6:] = False
    args = (lines, projs, centers, params, valid)
    ref = J_BATCH(*(jnp.asarray(a) for a in args), *CAM, max_err,
                  np.deg2rad(1.5), residual=residual)
    got = ttb.estimate_triangulation_batch(
        *(t(a) for a in args), *CAM, max_err, np.deg2rad(1.5),
        residual=residual)
    same_result(got, ref)
    assert got.success.all()
    np.testing.assert_allclose(got.point3d.numpy(),
                               np.stack([tr[0] for tr in tracks]), atol=1e-4)


@pytest.mark.parametrize("residual,max_err", [
    ("angular", np.deg2rad(2.0)), ("pixel", 4.0)])
def test_batch_estimator_long_pools_match_reference(residual, max_err):
    """Pools at the largest bucket (24 observations, C(24, 3) capped to
    512 triples), as the triangulator's Create and CompleteImage calls
    pass them: corrupted observations and padding slots."""
    rng = np.random.default_rng(13)
    tracks, lines, projs, centers, params = _batch(rng, 5, 24)
    for k in range(5):
        lines[k] = corrupt(rng, lines[k], [0, 3 + k, 11])
    valid = np.ones((5, 24), bool)
    valid[1, 18:] = False
    valid[4, 10:] = False
    args = (lines, projs, centers, params, valid)
    ref = J_BATCH(*(jnp.asarray(a) for a in args), *CAM, max_err,
                  np.deg2rad(1.5), residual=residual)
    got = ttb.estimate_triangulation_batch(
        *(t(a) for a in args), *CAM, max_err, np.deg2rad(1.5),
        residual=residual)
    same_result(got, ref)
    assert got.success.all()
