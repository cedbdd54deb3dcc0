"""Port parity: PROSAC sampling and the subset prescreen
(``solvers/ransac.py``) against the JAX package.

``prosac_prefix_sizes`` equals the reference's element for element; fed
the reference's own Gumbel draws, ``progressive_samples`` picks the
reference's indices; with its own generator, ``draw_samples_progressive``
has ``tests/test_ransac_samplers.py``'s three properties; and
``subset_prescreen`` returns the reference's indices where most scores
tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.solvers import ransac as tr
from privacy_preserving_sfm_tpu.solvers import ransac as jr


@pytest.mark.parametrize("n,m,b", [(100, 6, 4096), (7, 6, 50), (64, 4, 512),
                                   (2000, 3, 3000), (30, 2, 1),
                                   (500, 8, 20000)])
def test_prosac_prefix_sizes_equal_the_reference(n, m, b):
    got = tr.prosac_prefix_sizes(n, m, b)
    want = jr.prosac_prefix_sizes(n, m, b)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,n,m,b,n_valid,ties", [
    (0, 200, 6, 2048, 200, False), (1, 64, 4, 512, 20, False),
    (2, 50, 6, 300, 37, True), (3, 90, 3, 700, 5, True)])
def test_progressive_samples_on_the_reference_noise(seed, n, m, b, n_valid,
                                                    ties):
    rng = np.random.default_rng(seed)
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True
    rank = rng.uniform(0.0, 1.0, n).astype(np.float32)
    if ties:  # many equal qualities: the stable order decides
        rank = np.round(rank * 4).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jr.draw_samples_progressive(
        key, n, jnp.asarray(valid), m, b, jnp.asarray(rank)))
    noise = np.asarray(jax.random.gumbel(key, (b, n)))
    got = tr.progressive_samples(torch.tensor(noise),
                                 torch.from_numpy(valid), m,
                                 torch.from_numpy(rank))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_progressive_sampling_prefers_top_ranked():
    gen = torch.Generator().manual_seed(0)
    N, B, m = 200, 2048, 6
    rank = torch.arange(N, dtype=torch.float32)
    idx = tr.draw_samples_progressive(gen, N, torch.ones(N, dtype=bool), m,
                                      B, rank).numpy()
    for b in (0, B // 2, B - 1):
        assert len(set(idx[b].tolist())) == m
    assert idx.min() >= 0 and idx.max() < N
    assert idx[:64].max() <= 6 + 64 + 1, idx[:64].max()
    assert idx[:64].mean() < idx[-512:].mean()
    assert idx[-512:].max() > 80


def test_progressive_sampling_respects_validity():
    gen = torch.Generator().manual_seed(1)
    N = 64
    valid = torch.zeros(N, dtype=bool)
    valid[:20] = True
    idx = tr.draw_samples_progressive(gen, N, valid, 4, 512,
                                      torch.arange(N, dtype=torch.float32))
    assert int(idx.max()) < 20


def test_progressive_sampling_repeats_with_the_seed():
    rank = torch.arange(40, dtype=torch.float32)
    a, b = (tr.draw_samples_progressive(torch.Generator().manual_seed(5), 40,
                                        torch.ones(40, dtype=bool), 4, 100,
                                        rank) for _ in range(2))
    assert torch.equal(a, b)


def test_subset_prescreen_keeps_good_hypothesis():
    rng = np.random.default_rng(0)
    B, n_sub = 256, 32
    res = rng.uniform(1.0, 10.0, (B, n_sub))
    res[137] = rng.uniform(0.0, 0.05, n_sub)
    keep = tr.subset_prescreen(torch.from_numpy(res), 0.1,
                               torch.ones(n_sub, dtype=bool), keep=16)
    assert 137 in keep.tolist()


@pytest.mark.parametrize("seed,B,n_sub,keep", [(0, 256, 32, 16),
                                               (1, 1000, 8, 100),
                                               (2, 64, 4, 64),
                                               (3, 300, 16, 37)])
def test_subset_prescreen_equals_the_reference_on_ties(seed, B, n_sub, keep):
    """Residuals from three exact values (0, 1/8, 4), so the counts and
    residual sums, and so the scores, tie across most hypotheses."""
    rng = np.random.default_rng(seed)
    res = rng.choice([0.0, 0.125, 4.0], (B, n_sub), p=[0.12, 0.03, 0.85])
    res[rng.uniform(size=B) < 0.3] = 4.0  # a block with no inlier at all
    valid = rng.uniform(size=n_sub) < 0.9
    want = np.asarray(jr.subset_prescreen(jnp.asarray(res), 0.5,
                                          jnp.asarray(valid), keep))
    got = tr.subset_prescreen(torch.from_numpy(res), 0.5,
                              torch.from_numpy(valid), keep)
    score = np.asarray(jr.inlier_score(jnp.asarray(res), 0.5,
                                       jnp.asarray(valid))[0])
    _, counts = np.unique(score, return_counts=True)
    assert counts[counts > 1].sum() > B // 2  # ties are the rule here
    np.testing.assert_array_equal(got.numpy(), want)
