"""Port parity: the dense-block BA solver and its AoS Schur Gram.

The same inputs, made with numpy from a seed, go through the JAX package
and the port.  ``gram_aos_plain`` is held against the reference's
``build_u_matrix`` + Gram product (float64, 1e-10 of max|S|), against its
``gram_fused`` TPU kernel in interpret mode (float32, the tolerances of
``tests/test_schur_explicit.py``) and, in bf16 mode, against the
interpret-mode kernel's bf16 mode (1e-5 of max|S|; distinct cameras per
point here, repeated ones in ``tests/test_torch_gram_plan.py``).
``bundle_adjust_dense`` in both Schur modes is held against the
reference's (``gram_mode="xla"``) as ``tests/test_torch_ba_soa.py`` holds
the SoA solver: one LM step to float64 rounding, 12 steps to the same
iteration count and final cost to rtol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from privacy_preserving_sfm_tpu.ops import linalg as jlinalg
from privacy_preserving_sfm_tpu.optim import ba as jba
from privacy_preserving_sfm_tpu.optim import ba_dense as jbd
from privacy_preserving_sfm_tpu.optim import schur_pcg as jsp
from privacy_preserving_sfm_torch.ops import linalg as tlinalg
from privacy_preserving_sfm_torch.optim import ba as tba
from privacy_preserving_sfm_torch.optim import ba_dense as tbd
from privacy_preserving_sfm_torch.optim import ba_soa as tsoa
from privacy_preserving_sfm_torch.optim import convert
from privacy_preserving_sfm_torch.optim import schur_pcg as tsp

from test_torch_ba_soa import MODEL, _make_fields

torch.set_num_threads(2)


def _aos_inputs(seed, P, K, C, distinct=False):
    """Hcp (P, K, 6, 3), cams (P, K), SPD Hpp_inv (P, 3, 3), gp (P, 3)."""
    rng = np.random.default_rng(seed)
    Hcp = rng.standard_normal((P, K, 6, 3))
    if distinct:
        cams = np.stack([rng.permutation(C)[:K] for _ in range(P)])
    else:
        cams = rng.integers(0, C, (P, K))
    A = rng.standard_normal((P, 3, 3))
    Hpp_inv = A @ A.transpose(0, 2, 1) + 3 * np.eye(3)
    gp = rng.standard_normal((P, 3))
    return Hcp, cams.astype(np.int32), Hpp_inv, gp


def _reference_gram(Hcp, cams, Hpp_inv, gp, C):
    """(LH, gL, S, rhs) of the reference's U-matrix path."""
    n = 6 * C
    L = jlinalg.chol3(jnp.asarray(Hpp_inv))
    U = jsp.build_u_matrix(jnp.asarray(Hcp), jnp.asarray(cams), C)
    V = jnp.einsum("pba,pbn->pan", L, U).reshape(-1, n)
    gL = jnp.einsum("pba,pb->pa", L, jnp.asarray(gp))
    LH = jnp.einsum("pba,pkib->pkai", L, jnp.asarray(Hcp))
    return (np.asarray(LH), np.asarray(gL), np.asarray(V.T @ V),
            np.asarray(V.T @ gL.reshape(-1)))


def test_chol3_matches_reference():
    _, _, A, _ = _aos_inputs(0, 50, 1, 1)
    A[0] = 0.0  # clamped pivots stay finite
    np.testing.assert_allclose(tlinalg.chol3(torch.tensor(A)).numpy(),
                               np.asarray(jlinalg.chol3(jnp.asarray(A))),
                               rtol=1e-14, atol=1e-300)


def test_gram_aos_plain_matches_u_matrix_path():
    """float64, with repeated cameras within a point and -1 slots (the
    reference's one-hot gives them zero columns)."""
    P, K, C = 120, 5, 9
    Hcp, cams, Hpp_inv, gp = _aos_inputs(4, P, K, C)
    cams[:, 1] = cams[:, 0]
    cams[::4, -1] = -1
    LH, gL, S_ref, r_ref = _reference_gram(Hcp, cams, Hpp_inv, gp, C)
    S, r = tsp.gram_aos(torch.tensor(LH), torch.tensor(gL),
                        torch.tensor(cams), C)
    assert S.shape == (6 * C, 6 * C) and r.shape == (6 * C,)
    np.testing.assert_allclose(S.numpy(), S_ref, rtol=0,
                               atol=1e-10 * np.abs(S_ref).max())
    np.testing.assert_allclose(r.numpy(), r_ref, rtol=0,
                               atol=1e-10 * np.abs(r_ref).max())
    np.testing.assert_array_equal(S.numpy(), S.numpy().T)


@pytest.mark.parametrize("P,K,C", [(700, 8, 23), (300, 6, 150)])
def test_gram_aos_plain_matches_fused_interpret(P, K, C):
    Hcp, cams, Hpp_inv, gp = _aos_inputs(6, P, K, C)
    LH, gL, _, _ = _reference_gram(Hcp, cams, Hpp_inv, gp, C)
    LH32, gL32 = LH.astype(np.float32), gL.astype(np.float32)
    S_k, r_k = jsp.gram_fused(jnp.asarray(LH32), jnp.asarray(gL32),
                              jnp.asarray(cams), C, interpret=True)
    S_t, r_t = tsp.gram_aos_plain(torch.tensor(LH32), torch.tensor(gL32),
                                  torch.tensor(cams), C)
    S_k, r_k = np.asarray(S_k), np.asarray(r_k)
    np.testing.assert_allclose(S_t.numpy(), S_k, rtol=2e-5,
                               atol=2e-3 * np.abs(S_k).max())
    np.testing.assert_allclose(r_t.numpy(), r_k, rtol=2e-5,
                               atol=2e-3 * np.abs(r_k).max())


@pytest.mark.parametrize("layout", ["aos", "soa"])
def test_gram_bf16_matches_fused_interpret(layout):
    P, K, C = 400, 6, 23
    Hcp, cams, Hpp_inv, gp = _aos_inputs(9, P, K, C, distinct=True)
    LH, gL, _, _ = _reference_gram(Hcp, cams, Hpp_inv, gp, C)
    LH32, gL32 = LH.astype(np.float32), gL.astype(np.float32)
    S_k, r_k = jsp.gram_fused(jnp.asarray(LH32), jnp.asarray(gL32),
                              jnp.asarray(cams), C, precision="bf16",
                              interpret=True)
    S_k, r_k = np.asarray(S_k), np.asarray(r_k)
    LH_t, gL_t, cam_t = (torch.tensor(a) for a in (LH32, gL32, cams))
    if layout == "aos":
        S_t, r_t = tsp.gram_aos(LH_t, gL_t, cam_t, C, "bf16")
    else:
        lh_stack = LH_t.permute(2, 3, 1, 0).reshape(18 * K, P)
        S_t, r_t = tsp.gram_soa(lh_stack, gL_t.T, cam_t.T, C, "bf16")
    np.testing.assert_allclose(S_t.numpy(), S_k, rtol=0,
                               atol=1e-5 * np.abs(S_k).max())
    np.testing.assert_allclose(r_t.numpy(), r_k, rtol=0,
                               atol=1e-5 * np.abs(r_k).max())
    # The rounding is real: f32 operands give another S.
    S_f32, r_f32 = tsp.gram_aos(LH_t, gL_t, cam_t, C)
    assert np.abs(S_f32.numpy() - S_k).max() > 1e-4 * np.abs(S_k).max()
    np.testing.assert_array_equal(r_f32.numpy(), r_t.numpy())


def test_gram_rejects_unknown_precision():
    LH = torch.zeros(4, 2, 3, 6)
    with pytest.raises(ValueError, match="precision"):
        tsp.gram_aos(LH, torch.zeros(4, 3), torch.zeros(4, 2, dtype=int), 3,
                     "fp8")


def _dense_pair(fields):
    jflat = jba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()})
    jdense = jbd.from_flat_problem(jflat, k_bucket=4)
    tdense = convert.dense_problem_from_numpy(
        {k: np.asarray(v) for k, v in jdense._asdict().items()},
        "cpu", torch.float64)
    return jdense, tdense


def _both(fields, mode, **kw):
    jdense, tdense = _dense_pair(fields)
    jopts = jba.BAOptions(schur_mode=mode, gram_mode="xla", **kw)
    j = jax.jit(lambda p: jbd.bundle_adjust_dense(p, MODEL, jopts))(jdense)
    t = tbd.bundle_adjust_dense(tdense, MODEL,
                                tba.BAOptions(schur_mode=mode, **kw))
    return j, t


@pytest.mark.parametrize("mode", ["explicit", "implicit"])
@pytest.mark.parametrize("loss", ["trivial", "cauchy"])
def test_one_lm_step_matches_reference(mode, loss):
    fields = _make_fields(np.random.default_rng(3))
    (qj, tj, Xj, sj), (qt, tt, Xt, st) = _both(
        fields, mode, max_iterations=1, cg_iterations=20, loss=loss,
        function_tolerance=0.0)
    assert st.num_iterations == int(sj.num_iterations) == 1
    np.testing.assert_allclose(st.initial_cost, float(sj.initial_cost),
                               rtol=1e-9)
    np.testing.assert_allclose(st.final_cost, float(sj.final_cost),
                               rtol=1e-9)
    assert st.final_cost < st.initial_cost
    for a, b in ((qt, qj), (tt, tj), (Xt, Xj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8)


@pytest.mark.parametrize("mode", ["explicit", "implicit"])
@pytest.mark.parametrize("loss", ["trivial", "cauchy"])
def test_twelve_lm_steps_match_reference(mode, loss):
    fields = _make_fields(np.random.default_rng(8), meas_noise=1e-3)
    (_, _, _, sj), (_, _, _, st) = _both(
        fields, mode, max_iterations=12, cg_iterations=20, loss=loss)
    assert st.num_iterations == int(sj.num_iterations)
    np.testing.assert_allclose(st.final_cost, float(sj.final_cost),
                               rtol=1e-6)
    np.testing.assert_allclose(st.lam, float(sj.lam), rtol=1e-6)
    assert st.final_cost < 0.5 * st.initial_cost


def test_bf16_explicit_solve_converges():
    """``schur_precision`` reaches the dense solver's Gram: the bf16 run
    takes other steps than the f32 one and still converges (to within
    1e-2 of the f32 cost in 12 steps: S keeps about three digits)."""
    fields = _make_fields(np.random.default_rng(8), meas_noise=1e-3)
    _, tdense = _dense_pair(fields)
    kw = dict(schur_mode="explicit", max_iterations=12, cg_iterations=20)
    *p32, s32 = tbd.bundle_adjust_dense(tdense, MODEL, tba.BAOptions(**kw))
    *p16, s16 = tbd.bundle_adjust_dense(
        tdense, MODEL, tba.BAOptions(schur_precision="bf16", **kw))
    assert not torch.equal(p32[2], p16[2])
    assert s16.final_cost < 0.5 * s16.initial_cost
    np.testing.assert_allclose(s16.final_cost, s32.final_cost, rtol=1e-2)


def _ragged_fields():
    """Tracks of 2..6 observations: the dense layout pads short tracks
    with camera 0 and weight 0."""
    rng = np.random.default_rng(12)
    fields = _make_fields(rng, num_points=60, obs_per_point=6,
                          meas_noise=1e-3)
    keep = np.ones(len(fields["obs_cam"]), bool)
    lens = rng.integers(2, 7, 60)
    for p, n in enumerate(lens):
        keep[p * 6 + n:(p + 1) * 6] = False
    for k in ("obs_cam", "obs_point", "obs_line", "obs_weight"):
        fields[k] = fields[k][keep]
    return fields


@pytest.mark.parametrize("solver", ["soa", "dense"])
def test_padding_slots_reach_the_gram_as_minus_one(solver, monkeypatch):
    """Weight-0 slots go to the Gram with camera -1; with camera 0 there
    instead, S_corr and rhs_corr are exactly the same."""
    fields = _ragged_fields()
    dense = tbd.from_flat_problem(
        convert.ba_problem_from_numpy(fields, "cpu", torch.float64))
    pad = (dense.obs_weight == 0).numpy()
    assert pad.any() and (dense.obs_cam.numpy()[pad] == 0).all()
    name = "gram_soa" if solver == "soa" else "gram_aos"
    real = getattr(tsp, name)
    calls = []

    def spy(lh, gL, cam, C, precision="f32", plan=None):
        calls.append((lh, gL, cam.clone(), C))
        return real(lh, gL, cam, C, precision, plan=plan)

    monkeypatch.setattr(tsp, name, spy)
    opts = tba.BAOptions(max_iterations=2, schur_mode="explicit")
    if solver == "soa":
        tsoa.bundle_adjust_soa(dense, MODEL, opts)
    else:
        tbd.bundle_adjust_dense(dense, MODEL, opts)
    assert calls
    for lh, gL, cam, C in calls:
        cam_pk = cam.T if solver == "soa" else cam
        np.testing.assert_array_equal(cam_pk.numpy() < 0, pad)
        zero_cam = torch.where(cam < 0, 0, cam)
        S, r = real(lh, gL, cam, C)
        S0, r0 = real(lh, gL, zero_cam, C)
        assert torch.equal(S, S0) and torch.equal(r, r0)


@pytest.mark.parametrize("mode,device,C,explicit", [
    ("explicit", "cpu", 5, True), ("auto", "cpu", 5, False),
    ("implicit", "cuda", 5, False), ("auto", "cuda", 1024, True),
    ("auto", "cuda", 1025, False), ("explicit", "cuda", 1100, True)])
def test_uses_explicit_matches_reference_gate(mode, device, C, explicit):
    """``ba_dense.py:235-244``: explicit always when asked; "auto" only
    on an accelerator when ``explicit_fits(C)``."""
    assert tbd.uses_explicit(mode, device, C) is explicit
    assert jsp.explicit_fits(C) == tsp.explicit_fits(C)
