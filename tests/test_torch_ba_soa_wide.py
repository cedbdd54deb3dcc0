"""Port parity: the explicit-Schur LM solver past 512 cameras.

The reference sends every BA with 512 < C <= 1024 cameras to the SoA
solver with its blocked Gram (``gram_soa_blocked``), which its own tests
hold equal to the XLA Gram (``tests/test_ba_soa.py``).  Here the port's
``bundle_adjust_soa`` is held against the reference's
(``gram_mode="xla"``) at C = 520, the blocked test's camera count, in
float64 (``test_torch_ba_soa._both``): one LM step and several, poses and
points to 1e-8, costs to 1e-9 relative.

The port's plain Gram builds V (3P, 6C) a chunk of points at a time once
V would pass a byte budget (at C = 1,000 and P = 200,000 it would hold
3.6e9 entries).  Chunked, it is held against ``gram_soa_xla`` to
1e-10 of the largest entry; below the budget it is bit-equal to the one
product V^T V.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from privacy_preserving_sfm_tpu.optim import ba as jba
from privacy_preserving_sfm_tpu.optim import schur_pcg as jsp
from privacy_preserving_sfm_torch.optim import ba as tba
from privacy_preserving_sfm_torch.optim import schur_pcg as tsp

from test_torch_ba_soa import _both, _make_fields

torch.set_num_threads(2)

WIDE = dict(num_cams=520, num_points=1300, obs_per_point=4)


@pytest.mark.parametrize("steps,meas_noise", [(1, 0.0), (4, 1e-2)])
def test_lm_steps_past_512_cameras_match_reference(steps, meas_noise):
    fields = _make_fields(np.random.default_rng(16), meas_noise=meas_noise,
                          **WIDE)
    (qj, tj, Xj, sj), (qt, tt, Xt, st) = _both(
        fields,
        jba.BAOptions(max_iterations=steps, cg_iterations=20,
                      function_tolerance=0.0, gram_mode="xla"),
        tba.BAOptions(max_iterations=steps, cg_iterations=20,
                      function_tolerance=0.0))
    assert st.num_iterations == int(sj.num_iterations) == steps
    np.testing.assert_allclose(st.initial_cost, float(sj.initial_cost),
                               rtol=1e-9)
    np.testing.assert_allclose(st.final_cost, float(sj.final_cost),
                               rtol=1e-9)
    assert st.final_cost < st.initial_cost
    for a, b in ((qt, qj), (tt, tj), (Xt, Xj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8)


def _gram_inputs(seed, K, P, C):
    """SoA Gram inputs with repeated cameras in a point and some slots at
    camera -1 (padding)."""
    rng = np.random.default_rng(seed)
    lh = rng.standard_normal((18 * K, P))
    gl = rng.standard_normal((3, P))
    cam = rng.integers(0, C, (K, P))
    cam[rng.random((K, P)) < 0.1] = -1
    return lh, gl, cam.astype(np.int32)


def _v_bytes(P, C, itemsize=8):
    return 18 * P * C * itemsize


@pytest.mark.parametrize("K,P,C,chunk", [(4, 150, 520, 16), (6, 301, 600, 7),
                                         (4, 150, 520, 149)])
def test_chunked_plain_gram_matches_xla(K, P, C, chunk, monkeypatch):
    lh, gl, cam = _gram_inputs(K * P, K, P, C)
    S_x, r_x = (np.asarray(a) for a in jsp.gram_soa_xla(
        jnp.asarray(lh), jnp.asarray(gl), jnp.asarray(cam), C))
    monkeypatch.setattr(tsp, "PLAIN_V_BYTES", _v_bytes(chunk, C))
    S_t, r_t = tsp.gram_soa_plain(torch.tensor(lh), torch.tensor(gl),
                                  torch.tensor(cam), C)
    assert np.abs(S_t.numpy() - S_x).max() <= 1e-10 * np.abs(S_x).max()
    assert np.abs(r_t.numpy() - r_x).max() <= 1e-10 * np.abs(r_x).max()


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_plain_gram_below_its_budget_is_one_product(precision, monkeypatch):
    K, P, C = 4, 150, 520
    lh, gl, cam = (torch.tensor(a) for a in _gram_inputs(5, K, P, C))
    LH = lh.reshape(3, 6, K, P).permute(3, 2, 0, 1)
    V = tsp._expand_v(LH, cam.T, C)
    rhs = V.T @ gl.T.reshape(-1)
    if precision == "bf16":
        V = tsp._round_bf16(V)
    S = V.T @ V
    assert _v_bytes(P, C) <= tsp.PLAIN_V_BYTES
    for budget in (tsp.PLAIN_V_BYTES, _v_bytes(P, C)):
        monkeypatch.setattr(tsp, "PLAIN_V_BYTES", budget)
        S_t, r_t = tsp.gram_soa_plain(lh, gl, cam, C, precision)
        assert torch.equal(S_t, S) and torch.equal(r_t, rhs)
    # One point past the budget: chunked, no longer the one product's
    # rounding, within float64 summation error of it.
    monkeypatch.setattr(tsp, "PLAIN_V_BYTES", _v_bytes(P - 1, C))
    S_c, r_c = tsp.gram_soa_plain(lh, gl, cam, C, precision)
    assert float((S_c - S).abs().max()) <= 1e-12 * float(S.abs().max())
    assert float((r_c - rhs).abs().max()) <= 1e-12 * float(rhs.abs().max())
