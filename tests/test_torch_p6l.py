"""The port's P6L stack against the reference package, float64 on the CPU.

Polynomial roots, the 3Q3 solver, the P6L minimal solver, the RANSAC pose
estimator given the reference's own ``jax.random`` draws, its two
degeneracy guards, the IRLS refinement and the adaptive trial bound go
through ``privacy_preserving_sfm_tpu`` and ``privacy_preserving_sfm_torch``
on the same numpy inputs.  The scenes are ``tests/test_p6l.py``'s and
``tests/test_e3q3.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.ops import e3q3 as te3q3
from privacy_preserving_sfm_torch.ops import lie as tlie
from privacy_preserving_sfm_torch.ops import polynomial as tpoly
from privacy_preserving_sfm_torch.solvers import p6l as tp6l
from privacy_preserving_sfm_torch.solvers import ransac as transac
from privacy_preserving_sfm_tpu.ops import e3q3 as je3q3
from privacy_preserving_sfm_tpu.ops import polynomial as jpoly
from privacy_preserving_sfm_tpu.solvers import p6l as jp6l
from privacy_preserving_sfm_tpu.solvers import ransac as jransac

from test_e3q3 import random_quadric_system
from test_p6l import make_pose_scene

torch.set_num_threads(2)

# One compile per shape for the reference (its eager ops compile one by
# one); every estimator case uses N = 100 correspondences and 256
# hypotheses, every 3Q3 batch 16 systems.
N, NH = 100, 256
j_estimate = jax.jit(jp6l.estimate_absolute_pose_from_lines,
                     static_argnames=("num_hypotheses",))
j_solve_e3q3 = jax.jit(je3q3.solve_e3q3)
j_p6l_minimal = jax.jit(jp6l.p6l_minimal)


def t64(a):
    return torch.from_numpy(np.array(a, np.float64))


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


# -- polynomials ------------------------------------------------------------

def test_polynomial_ops_match():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((4, 3)), rng.standard_normal((4, 5))
    close(tpoly.polymul(t64(a), t64(b)), jpoly.polymul(a, b), 1e-12)
    close(tpoly.polyadd(t64(a), t64(b)), jpoly.polyadd(a, b), 1e-12)
    c, x = rng.standard_normal((4, 9)), rng.standard_normal(4)
    close(tpoly.polyval(t64(c), t64(x)), jpoly.polyval(c, x), 1e-12)
    close(tpoly.polyder(t64(c)), jpoly.polyder(c), 1e-12)
    close(tpoly._initial_roots(t64(c), 8), jpoly._initial_roots(c, 8), 1e-12)


ROOT_CASES = {
    "known": np.poly([1.0, 2.0, 3.0, -4.0, 0.5, -0.25, 7.0, -1.5])[::-1],
    "complex_pairs": np.poly([1j, -1j, 2.0, -3.0]).real[::-1],
    "batch": np.stack([np.poly(r)[::-1] for r in
                       np.random.default_rng(1).uniform(-2, 2, (16, 8))]),
}


@pytest.mark.parametrize("case", sorted(ROOT_CASES))
def test_aberth_and_real_roots_match(case):
    c = np.atleast_2d(ROOT_CASES[case]).copy()
    jz, (jx, jreal) = jax.jit(
        lambda c: (jpoly.aberth_roots(c), jpoly.real_roots(c)))(
            jnp.asarray(c))
    close(tpoly.aberth_roots(t64(c)), jz, 1e-10)
    x, real = tpoly.real_roots(t64(c))
    np.testing.assert_array_equal(real.numpy(), np.asarray(jreal))
    close(x, jx, 1e-10)


# -- 3Q3 --------------------------------------------------------------------

def assert_same_solutions(port, ref, tol):
    sols, valid = port
    jsols, jvalid = ref
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    v = np.asarray(jvalid)
    close(sols.numpy()[v], np.asarray(jsols)[v], tol)


@pytest.mark.parametrize("seed", [2, 3])
def test_solve_e3q3_matches_on_random_systems(seed):
    coeffs, _ = random_quadric_system(np.random.default_rng(seed), (16,))
    assert_same_solutions(te3q3.solve_e3q3(t64(coeffs)),
                          j_solve_e3q3(jnp.asarray(coeffs)), 1e-8)


def test_solve_e3q3_degenerate_uses_the_reference_affine_draws():
    # test_e3q3.py's degenerate case: every pivot block is singular.
    rng = np.random.default_rng(4)
    coeffs = np.zeros((16, 3, 10))
    coeffs[:, 0, 0] = rng.standard_normal(16)
    coeffs[:, 1, 3] = rng.standard_normal(16)
    coeffs[:, 2, 5] = rng.standard_normal(16)
    coeffs[..., 6:9] = rng.standard_normal((16, 3, 3))
    sol = rng.standard_normal((16, 3))
    x, y, z = sol[..., 0], sol[..., 1], sol[..., 2]
    mono = np.stack([x * x, x * y, x * z, y * y, y * z, z * z, x, y, z,
                     np.ones_like(x)], axis=-1)
    coeffs[..., 9] -= np.einsum("...km,...m->...k", coeffs, mono)
    key = jax.random.PRNGKey(0)
    kq, kt = jax.random.split(key)
    q = np.asarray(jax.random.normal(kq, (4,), jnp.float64))
    a = np.asarray(jax.random.normal(kt, (3,), jnp.float64))
    draws = (t64(q / np.linalg.norm(q)), t64(a / np.linalg.norm(a)))
    port = te3q3.solve_e3q3(t64(coeffs), draws)
    assert_same_solutions(port, j_solve_e3q3(jnp.asarray(coeffs), key=key),
                          1e-8)
    d = np.linalg.norm(port[0].numpy() - sol[:, None], axis=-1)
    assert np.where(port[1].numpy(), d, np.inf).min(-1).max() < 1e-5


def test_cayley_to_rotmat_matches():
    from privacy_preserving_sfm_tpu.ops import lie as jlie

    c = np.random.default_rng(5).standard_normal((6, 3))
    close(tlie.cayley_to_rotmat(t64(c)), jlie.cayley_to_rotmat(c), 1e-14)


# -- P6L --------------------------------------------------------------------

def scenes(seed, count, n, aligned_ratio=0.3):
    rng = np.random.default_rng(seed)
    return [make_pose_scene(rng, n=n, aligned_ratio=aligned_ratio)
            for _ in range(count)]


@pytest.mark.parametrize("singular", [False, True])
def test_p6l_minimal_matches_with_fixed_mix(singular):
    batch = scenes(1, 16, 6)
    ls = np.stack([s[3] for s in batch])
    pts = np.stack([s[2] for s in batch])
    if singular:
        # The first three lines of every sample dependent: the mix path.
        ls[:, 2] = ls[:, 0] + ls[:, 1]
    key = jax.random.PRNGKey(3)
    amix = np.asarray(jax.random.normal(key, (3, 3), jnp.float64))
    poses, valid = tp6l.p6l_minimal(t64(ls), t64(pts), t64(amix))
    jposes, jvalid = j_p6l_minimal(jnp.asarray(ls), jnp.asarray(pts),
                                   key=key)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    v = np.asarray(jvalid)
    assert v.any()
    close(poses.numpy()[v], np.asarray(jposes)[v], 1e-8)


def reference_estimate(key, ls, aligned, pts, thresh):
    res = j_estimate(key, jnp.asarray(ls), jnp.asarray(aligned),
                     jnp.asarray(pts), jnp.ones(N, bool), thresh,
                     num_hypotheses=NH)
    k_sample, k_solve = jax.random.split(key)
    idx = np.asarray(jransac.draw_samples(k_sample, N, jnp.ones(N, bool), 6,
                                          NH))
    amix = np.asarray(jax.random.normal(k_solve, (3, 3), jnp.float64))
    return res, torch.from_numpy(idx.astype(np.int64)), t64(amix)


def assert_same_pose(port, ref):
    assert bool(port.success) == bool(ref.success)
    assert int(port.num_inliers) == int(ref.num_inliers)
    np.testing.assert_array_equal(port.inlier_mask.numpy(),
                                  np.asarray(ref.inlier_mask))
    if bool(ref.success):
        close(port.qvec, ref.qvec, 1e-8)
        close(port.tvec, ref.tvec, 1e-8)


@pytest.mark.parametrize("outliers", [0, 25])
def test_estimate_pose_matches_given_the_reference_draws(outliers):
    rng = np.random.default_rng(3)
    q, t, pts, ls, aligned = make_pose_scene(rng, n=N)
    if outliers:
        out = rng.choice(N, outliers, replace=False)
        bad = rng.standard_normal((outliers, 3))
        ls[out] = bad / np.linalg.norm(bad[:, :2], axis=-1, keepdims=True)
    ref, idx, amix = reference_estimate(jax.random.PRNGKey(outliers), ls,
                                        aligned, pts, 1e-4)
    port = tp6l.estimate_absolute_pose_from_lines_with_draws(
        t64(ls), torch.from_numpy(aligned), t64(pts), 1e-4, idx, amix)
    assert bool(ref.success)
    assert_same_pose(port, ref)


def test_estimate_pose_scores_in_chunks_like_one_batch(monkeypatch):
    rng = np.random.default_rng(8)
    q, t, pts, ls, aligned = make_pose_scene(rng, n=N)
    ls[:25] = rng.standard_normal((25, 3))
    ls[:25] /= np.linalg.norm(ls[:25, :2], axis=-1, keepdims=True)
    ref, idx, amix = reference_estimate(jax.random.PRNGKey(9), ls, aligned,
                                        pts, 1e-4)
    monkeypatch.setattr(tp6l, "SCORE_ENTRIES", 8 * N * 7)  # 7 a chunk
    port = tp6l.estimate_absolute_pose_from_lines_with_draws(
        t64(ls), torch.from_numpy(aligned), t64(pts), 1e-4, idx, amix)
    assert_same_pose(port, ref)


@pytest.mark.parametrize("aligned_ratio", [1.0, 0.95])
def test_aligned_guards_match(aligned_ratio):
    """All-aligned samples give no model; a model whose inliers are more
    than 90 % aligned is rejected (``pose.cc:69-83``)."""
    rng = np.random.default_rng(5)
    q, t, pts, ls, aligned = make_pose_scene(rng, n=N,
                                             aligned_ratio=aligned_ratio)
    if aligned_ratio == 1.0:
        aligned = np.ones(N, bool)
    else:
        aligned[:6] = False
        aligned[6:] = True  # 94 % aligned
    ref, idx, amix = reference_estimate(jax.random.PRNGKey(0), ls, aligned,
                                        pts, 1e-4)
    port = tp6l.estimate_absolute_pose_from_lines_with_draws(
        t64(ls), torch.from_numpy(aligned), t64(pts), 1e-4, idx, amix)
    assert not bool(port.success) and not bool(ref.success)
    assert_same_pose(port, ref)
    if aligned_ratio != 1.0:
        assert int(port.num_inliers) >= 90  # a model, refused as aligned


def test_draw_pose_is_reproducible_and_distinct():
    a = tp6l.draw_pose(torch.Generator().manual_seed(7), 40, 64)
    b = tp6l.draw_pose(torch.Generator().manual_seed(7), 40, 64)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    idx = a[0].numpy()
    assert idx.shape == (64, 6) and idx.min() >= 0 and idx.max() < 40
    assert all(len(set(r)) == 6 for r in idx)


@pytest.mark.parametrize("seed,noise_outliers", [(6, False), (7, True)])
def test_refinement_matches(seed, noise_outliers):
    from privacy_preserving_sfm_tpu.ops import lie as jlie

    rng = np.random.default_rng(seed)
    q, t, pts, ls, aligned = make_pose_scene(rng, n=120)
    mask = np.ones(120)
    if noise_outliers:
        bad_idx = rng.choice(120, 20, replace=False)
        bad = rng.standard_normal((20, 3))
        ls[bad_idx] = bad / np.linalg.norm(bad[:, :2], axis=-1,
                                           keepdims=True)
        mask[bad_idx[:10]] = 0.0
    dq = np.array([1.0, *rng.normal(0, 0.01, 3)])
    q0 = np.asarray(jlie.quat_multiply(q, dq / np.linalg.norm(dq)))
    t0 = t + rng.normal(0, 0.05, 3)
    params = np.array([500.0, 320.0, 240.0])
    jq, jt = jp6l.refine_absolute_pose_from_lines(
        jnp.asarray(q0), jnp.asarray(t0), jnp.asarray(ls), jnp.asarray(pts),
        jnp.asarray(mask), "SIMPLE_PINHOLE", jnp.asarray(params))
    pq, pt = tp6l.refine_absolute_pose_from_lines(
        t64(q0), t64(t0), t64(ls), t64(pts), t64(mask), "SIMPLE_PINHOLE",
        t64(params))
    close(pq, jq, 1e-8)
    close(pt, jt, 1e-8)


def test_solve6_matches():
    rng = np.random.default_rng(11)
    M = rng.standard_normal((6, 6))
    A = M @ M.T + 6 * np.eye(6)
    b = rng.standard_normal(6)
    close(tp6l._solve6(t64(A), t64(b)), jp6l._solve6(A, b), 1e-12)


@pytest.mark.parametrize("num_inliers,num_valid,sample_size", [
    (0, 100, 6), (30, 100, 6), (95, 100, 6), (100, 100, 6), (7, 9, 3),
    (1, 1000, 6), (400, 401, 4)])
def test_num_trials_needed_matches_exactly(num_inliers, num_valid,
                                           sample_size):
    assert transac.num_trials_needed(num_inliers, num_valid, sample_size) \
        == float(jransac.num_trials_needed(num_inliers, num_valid,
                                           sample_size))
