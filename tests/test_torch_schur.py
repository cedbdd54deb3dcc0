"""Port parity: the plain Schur Gram and PCG against the JAX package.

``gram_soa_plain`` is held against ``gram_soa_xla`` (float64, rtol 1e-10)
and against the reference's Pallas kernels in interpret mode (float32,
the tolerance of ``tests/test_ba_soa.py``), at the toy shapes those tests
use, plus one K = 32 case the Pallas kernels cannot take.  ``pcg_plain``
and ``pcg_schur``'s plain twin (the solvers' block contract at n = 6C) are
held against ``pcg_xla`` and the interpret-mode ``pcg_fused`` on the
reference's padded dense system.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from privacy_preserving_sfm_tpu.optim import schur_pcg as jsp
from privacy_preserving_sfm_torch.optim import schur_pcg as tsp

torch.set_num_threads(2)


def _gram_inputs(seed, K, P, C):
    rng = np.random.default_rng(seed)
    lh = rng.standard_normal((18 * K, P))
    gl = rng.standard_normal((3, P))
    cam = rng.integers(0, C, (K, P)).astype(np.int32)
    return lh, gl, cam


def _torch_gram(lh, gl, cam, C):
    S, r = tsp.gram_soa(torch.tensor(lh), torch.tensor(gl),
                        torch.tensor(cam), C)
    return S.numpy(), r.numpy()


@pytest.mark.parametrize("K,P,C", [(4, 37, 9), (4, 140, 320),
                                   (4, 150, 520), (32, 60, 12)])
def test_gram_plain_matches_xla(K, P, C):
    lh, gl, cam = _gram_inputs(7, K, P, C)
    S_x, r_x = jsp.gram_soa_xla(jnp.asarray(lh), jnp.asarray(gl),
                                jnp.asarray(cam), C)
    S_t, r_t = _torch_gram(lh, gl, cam, C)
    assert S_t.shape == (6 * C, 6 * C) and r_t.shape == (6 * C,)
    np.testing.assert_allclose(S_t, np.asarray(S_x), rtol=1e-10,
                               atol=1e-10 * np.abs(S_t).max())
    np.testing.assert_allclose(r_t, np.asarray(r_x), rtol=1e-10,
                               atol=1e-10 * np.abs(r_t).max())
    np.testing.assert_array_equal(S_t, S_t.T)


@pytest.mark.parametrize("K,P,C,kernel", [(4, 37, 9, "gram_soa"),
                                          (4, 140, 320, "gram_soa"),
                                          (4, 150, 520, "gram_soa_blocked")])
def test_gram_plain_matches_pallas_interpret(K, P, C, kernel):
    lh, gl, cam = _gram_inputs(11, K, P, C)
    lh32, gl32 = lh.astype(np.float32), gl.astype(np.float32)
    S_k, r_k = getattr(jsp, kernel)(jnp.asarray(lh32), jnp.asarray(gl32),
                                    jnp.asarray(cam), C, interpret=True)
    S_t, r_t = _torch_gram(lh32.astype(np.float64), gl32.astype(np.float64),
                           cam, C)
    np.testing.assert_allclose(S_t, np.asarray(S_k), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r_t, np.asarray(r_k), rtol=1e-4, atol=1e-4)


def test_gram_plain_repeated_camera_and_negative_ids():
    """Slots of one point that repeat a camera add up in V, and id -1
    slots contribute nothing (the reference's one-hot semantics)."""
    K, P, C = 3, 5, 4
    lh, gl, cam = _gram_inputs(3, K, P, C)
    cam[1] = cam[0]
    S_x, r_x = jsp.gram_soa_xla(jnp.asarray(lh), jnp.asarray(gl),
                                jnp.asarray(cam), C)
    S_t, r_t = _torch_gram(lh, gl, cam, C)
    np.testing.assert_allclose(S_t, np.asarray(S_x), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(r_t, np.asarray(r_x), rtol=1e-10, atol=1e-12)
    cam[2, 0] = -1
    S_x, r_x = jsp.gram_soa_xla(jnp.asarray(lh), jnp.asarray(gl),
                                jnp.asarray(cam), C)
    S_t, r_t = _torch_gram(lh, gl, cam, C)
    np.testing.assert_allclose(S_t, np.asarray(S_x), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(r_t, np.asarray(r_x), rtol=1e-10, atol=1e-12)


def _spd(n, rng):
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


@pytest.mark.parametrize("n,iters", [(64, 200), (256, 25)])
def test_pcg_plain_matches_xla(n, iters):
    rng = np.random.default_rng(0)
    S = _spd(n, rng)
    rhs = rng.standard_normal(n)
    Minv = np.diag(1.0 / np.diag(S))
    x_x = jsp.pcg_xla(jnp.asarray(S), jnp.asarray(Minv), jnp.asarray(rhs),
                      iters)
    x_t = tsp.pcg(torch.tensor(S), torch.tensor(Minv), torch.tensor(rhs),
                  iters).numpy()
    np.testing.assert_allclose(x_t, np.asarray(x_x), rtol=1e-10,
                               atol=1e-10 * np.abs(x_t).max())


def test_pcg_plain_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    n = 256
    S = _spd(n, rng).astype(np.float32)
    rhs = rng.standard_normal(n).astype(np.float32)
    Minv = np.diag(1.0 / np.diag(S)).astype(np.float32)
    x_k = jsp.pcg_fused(jnp.asarray(S), jnp.asarray(Minv), jnp.asarray(rhs),
                        iters=25, interpret=True)
    x_t = tsp.pcg_plain(*(torch.tensor(a) for a in (S, Minv, rhs)), 25)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_k), rtol=1e-4,
                               atol=1e-5)


def test_pcg_plain_guards_zero_rhs():
    """rz = pAp = 0 hits the 1e-30 guards: x stays 0, never NaN."""
    S = torch.eye(128, dtype=torch.float64)
    x = tsp.pcg(S, S, torch.zeros(128, dtype=torch.float64), 5)
    assert torch.equal(x, torch.zeros(128, dtype=torch.float64))
    x_x = jsp.pcg_xla(jnp.eye(128), jnp.eye(128), jnp.zeros(128), 5)
    np.testing.assert_array_equal(np.asarray(x_x), x.numpy())


def _schur_system(C, seed):
    """The solvers' form of a reduced camera system S = blockdiag(dHcc) -
    S_corr from a Gram G of random blocks: S_corr = -G and dHcc damping
    blocks, so S = G + damping is SPD; the block-Jacobi preconditioner
    inv(dHcc - diag_blocks(S_corr)) as the solvers build it; a rhs."""
    lh, gl, cam = _gram_inputs(seed, 4, 12 * C, C)
    G, _ = _torch_gram(lh, gl, cam, C)
    rng = np.random.default_rng(seed)
    d = np.diagonal(G).reshape(C, 6)
    dHcc = np.zeros((C, 6, 6))
    dHcc[:, np.arange(6), np.arange(6)] = 0.1 * d + 1e-3 * d.max()
    S_corr = -G
    SJ = dHcc + G.reshape(C, 6, C, 6)[np.arange(C), :, np.arange(C), :]
    return S_corr, dHcc, np.linalg.inv(SJ), rng.standard_normal(6 * C)


def _reference_dense(S_corr, dHcc, minv, rhs):
    """The reference's padded dense system (``ba_soa.py:354-357``)."""
    C = dHcc.shape[0]
    n, n_pad = 6 * C, jsp.padded_dim(C)
    S = jsp.embed_block_diag(jnp.asarray(dHcc), n_pad, pad_value=1.0)
    S = S - jnp.pad(jnp.asarray(S_corr), ((0, n_pad - n), (0, n_pad - n)))
    Minv = jsp.embed_block_diag(jnp.asarray(minv), n_pad, pad_value=1.0)
    return S, Minv, jnp.pad(jnp.asarray(rhs), (0, n_pad - n))


@pytest.mark.parametrize("C", [9, 40])
def test_pcg_schur_plain_matches_xla(C):
    """The block contract at 6C against ``pcg_xla`` on the reference's
    padded dense system, float64."""
    S_corr, dHcc, minv, rhs = _schur_system(C, C)
    x_x = jsp.pcg_xla(*_reference_dense(S_corr, dHcc, minv, rhs), 30)
    x_t = tsp.pcg_schur(*(torch.tensor(a) for a in (S_corr, dHcc, minv,
                                                     rhs)), 30)
    assert x_t.shape == (6 * C,)
    x_x = np.asarray(x_x)
    assert not x_x[6 * C:].any()  # the padding stays exactly 0
    np.testing.assert_allclose(x_t.numpy(), x_x[:6 * C], rtol=1e-10,
                               atol=1e-10 * np.abs(x_t.numpy()).max())


@pytest.mark.parametrize("C", [9, 40])
def test_pcg_schur_plain_matches_pallas_interpret(C):
    S_corr, dHcc, minv, rhs = (a.astype(np.float32)
                               for a in _schur_system(C, C + 1))
    x_k = jsp.pcg_fused(*_reference_dense(S_corr, dHcc, minv, rhs), iters=25,
                        interpret=True)
    x_t = tsp.pcg_schur_plain(*(torch.tensor(a) for a in (S_corr, dHcc, minv,
                                                           rhs)), 25)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_k)[:6 * C],
                               rtol=1e-4, atol=1e-5)


def test_pcg_schur_guards_zero_rhs():
    """rz = pAp = 0 hits the 1e-30 guards: x stays 0, never NaN, as in
    ``pcg_xla``."""
    C = 5
    eye = torch.eye(6, dtype=torch.float64).repeat(C, 1, 1)
    S_corr = torch.zeros(6 * C, 6 * C, dtype=torch.float64)
    x = tsp.pcg_schur(S_corr, eye, eye, torch.zeros(6 * C,
                                                    dtype=torch.float64), 5)
    assert torch.equal(x, torch.zeros(6 * C, dtype=torch.float64))
    x_x = jsp.pcg_xla(*_reference_dense(S_corr.numpy(), eye.numpy(),
                                        eye.numpy(), np.zeros(6 * C)), 5)
    np.testing.assert_array_equal(np.asarray(x_x)[:6 * C], x.numpy())


def test_pcg_schur_checks_its_arguments():
    S_corr, dHcc, minv, rhs = (torch.tensor(a) for a in _schur_system(3, 0))
    with pytest.raises(ValueError, match="path"):
        tsp.pcg_schur(S_corr, dHcc, minv, rhs, 5, path="fast")
    with pytest.raises(ValueError, match="shapes"):
        tsp.pcg_schur(S_corr, dHcc, minv, rhs[:-6], 5)


def test_sizes_and_diag_blocks():
    for C in (1, 5, 21, 22, 100, 512, 1024, 1025):
        assert tsp.padded_dim(C) == jsp.padded_dim(C)
        assert tsp.explicit_fits(C) == jsp.explicit_fits(C)
    rng = np.random.default_rng(2)
    S = rng.standard_normal((128, 128))
    np.testing.assert_array_equal(
        tsp.diag_blocks(torch.tensor(S), 5).numpy(),
        np.asarray(jsp.diag_blocks(jnp.asarray(S), 5)))


def test_dispatch_refuses_other_devices():
    """No silent fallback: a device with no kernel raises."""
    meta = dict(device="meta", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no Schur kernel"):
        tsp.gram_soa(torch.empty(18, 4, **meta), torch.empty(3, 4, **meta),
                     torch.zeros(1, 4, dtype=torch.int32, device="meta"), 2)
    with pytest.raises(RuntimeError, match="no Schur kernel"):
        tsp.pcg(torch.empty(8, 8, **meta), torch.empty(8, 8, **meta),
                torch.empty(8, **meta), 3)
    with pytest.raises(RuntimeError, match="no Schur kernel"):
        tsp.pcg_schur(torch.empty(12, 12, **meta),
                      torch.empty(2, 6, 6, **meta),
                      torch.empty(2, 6, 6, **meta), torch.empty(12, **meta),
                      3)
