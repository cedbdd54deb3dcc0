"""Port parity: torch ops against the JAX package on the same inputs.

Quaternion ops, the 11-model ``world_to_image`` (torch and its numpy
twin), ``line_ba_residual`` and its Jacobians (``torch.func.jacfwd``
against ``jax.jacfwd``), all in float64 at atol 1e-10.
"""

import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

import jax
import jax.numpy as jnp

from privacy_preserving_sfm_tpu.ops import cameras as jcam
from privacy_preserving_sfm_tpu.ops import lie as jlie
from privacy_preserving_sfm_tpu.ops import lines as jlines
from privacy_preserving_sfm_tpu.ops import linalg as jlinalg
from privacy_preserving_sfm_tpu.optim import ba as jba
from privacy_preserving_sfm_torch.ops import cameras as tcam
from privacy_preserving_sfm_torch.ops import lie as tlie
from privacy_preserving_sfm_torch.ops import lie_np as tlie_np
from privacy_preserving_sfm_torch.ops import lines as tlines
from privacy_preserving_sfm_torch.ops import lines_np as tlines_np
from privacy_preserving_sfm_torch.ops import linalg as tlinalg
from privacy_preserving_sfm_torch.optim import ba as tba

torch.set_num_threads(2)

ATOL = 1e-10

# Realistic parameters per model: focal ~500 px, principal point at the
# image centre, small distortion terms.
_EXTRA = {
    "SIMPLE_PINHOLE": [], "PINHOLE": [],
    "SIMPLE_RADIAL": [0.05], "RADIAL": [0.05, -0.01],
    "OPENCV": [0.05, -0.01, 0.001, -0.002],
    "OPENCV_FISHEYE": [0.05, -0.01, 0.002, -0.001],
    "FULL_OPENCV": [0.05, -0.01, 0.001, -0.002, 0.003, 0.01, -0.005,
                    0.002],
    "FOV": [0.9],
    "SIMPLE_RADIAL_FISHEYE": [0.05], "RADIAL_FISHEYE": [0.05, -0.01],
    "THIN_PRISM_FISHEYE": [0.05, -0.01, 0.001, -0.002, 0.003, 0.001,
                           0.002, -0.001],
}


def _params(model):
    spec = tcam.MODELS[model]
    focal = [500.0] if len(spec.focal_idxs) == 1 else [500.0, 480.0]
    p = np.asarray(focal + [320.0, 240.0] + _EXTRA[model])
    assert len(p) == spec.num_params
    return p


def _quats(rng, n):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_model_registry_matches():
    assert set(tcam.MODELS) == set(jcam.MODELS)
    for name, spec in tcam.MODELS.items():
        js = jcam.MODELS[name]
        assert (spec.model_id, spec.num_params, spec.focal_idxs,
                spec.principal_idxs, spec.extra_idxs, spec.fisheye_pre,
                spec.fov_style) == (js.model_id, js.num_params,
                                    js.focal_idxs, js.principal_idxs,
                                    js.extra_idxs, js.fisheye_pre,
                                    js.fov_style)
        assert tcam.MODEL_BY_ID[spec.model_id].name == name


def test_quat_normalize():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((16, 4))
    want = np.asarray(jlie.quat_normalize(jnp.asarray(q)))
    got = tlie.quat_normalize(torch.tensor(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_quat_multiply_and_rotate():
    rng = np.random.default_rng(1)
    q1, q2 = _quats(rng, 16), _quats(rng, 16)
    v = rng.standard_normal((16, 3))
    np.testing.assert_allclose(
        tlie.quat_multiply(torch.tensor(q1), torch.tensor(q2)).numpy(),
        np.asarray(jlie.quat_multiply(jnp.asarray(q1), jnp.asarray(q2))),
        rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        tlie.quat_rotate(torch.tensor(q1), torch.tensor(v)).numpy(),
        np.asarray(jlie.quat_rotate(jnp.asarray(q1), jnp.asarray(v))),
        rtol=0, atol=ATOL)


def test_lie_np_roundtrip_matches_jax():
    rng = np.random.default_rng(2)
    for q in _quats(rng, 8):
        R = tlie_np.quat_to_rotmat(q)
        np.testing.assert_allclose(
            R, np.asarray(jlie.quat_to_rotmat(jnp.asarray(q))), atol=ATOL)
        q_back = tlie_np.rotmat_to_quat(R)
        np.testing.assert_allclose(q_back, q if q[0] >= 0 else -q,
                                   atol=ATOL)


def test_inv3_and_inv6():
    rng = np.random.default_rng(3)
    A3 = rng.standard_normal((10, 3, 3)) + 3 * np.eye(3)
    np.testing.assert_allclose(
        tlinalg.inv3(torch.tensor(A3)).numpy(),
        np.asarray(jlinalg.inv3(jnp.asarray(A3))), rtol=0, atol=ATOL)
    B = rng.standard_normal((10, 6, 6))
    A6 = B @ B.transpose(0, 2, 1) + 6 * np.eye(6)
    np.testing.assert_allclose(
        tba._inv6(torch.tensor(A6)).numpy(),
        np.asarray(jba._inv6(jnp.asarray(A6))), rtol=0, atol=ATOL)


def test_quat_delta_and_apply_step():
    rng = np.random.default_rng(4)
    q, t, X = _quats(rng, 5), rng.standard_normal((5, 3)), \
        rng.standard_normal((7, 3))
    dc, dp = 0.1 * rng.standard_normal((5, 6)), rng.standard_normal((7, 3))
    want = jba._apply_step(*(jnp.asarray(a) for a in (q, t, X, dc, dp)))
    got = tba._apply_step(*(torch.tensor(a) for a in (q, t, X, dc, dp)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("model", sorted(tcam.MODELS))
def test_world_to_image(model):
    rng = np.random.default_rng(5)
    uv = rng.uniform(-0.5, 0.5, (64, 2))
    uv[0] = 0.0  # the r = 0 branch of the fisheye models
    params = _params(model)
    want = np.asarray(jcam.world_to_image(model, jnp.asarray(params),
                                          jnp.asarray(uv)))
    got = tcam.world_to_image(model, torch.tensor(params),
                              torch.tensor(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    got_np = tlines_np.world_to_image(model, params, uv)
    np.testing.assert_allclose(got_np, want, rtol=0, atol=ATOL)


def _observations(rng, n, model):
    q = _quats(rng, n) * 0.1 + np.array([1.0, 0, 0, 0])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.uniform(-0.5, 0.5, (n, 3))
    X = rng.uniform(-1, 1, (n, 3)) + np.array([0, 0, 6.0])
    lines = rng.standard_normal((n, 3))
    lines /= np.linalg.norm(lines[:, :2], axis=-1, keepdims=True)
    par = np.tile(_params(model), (n, 1))
    return q, t, X, lines, par


def _jax_res(dc, dX, q, t, X, par, line, model):
    qq = jlie.quat_multiply(q, jba._quat_delta(dc[:3]))
    return jlines.line_ba_residual(line, X + dX, qq, t + dc[3:], model, par)


def _torch_res(dc, dX, q, t, X, par, line, model):
    qq = tlie.quat_multiply(q, tba._quat_delta(dc[:3]))
    return tlines.line_ba_residual(line, X + dX, qq, t + dc[3:], model, par)


@pytest.mark.parametrize("model", sorted(tcam.MODELS))
def test_line_ba_residual_and_jacobians(model):
    rng = np.random.default_rng(6)
    n = 32
    q, t, X, lines, par = _observations(rng, n, model)
    z6, z3 = np.zeros((n, 6)), np.zeros((n, 3))
    ins = (z6, z3, q, t, X, par, lines)

    want_r = np.asarray(jlines.line_ba_residual(
        *(jnp.asarray(a) for a in (lines, X, q, t)), model,
        jnp.asarray(par)))
    got_r = tlines.line_ba_residual(
        *(torch.tensor(a) for a in (lines, X, q, t)), model,
        torch.tensor(par)).numpy()
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=ATOL)

    jac_j = jax.jit(jax.vmap(jax.jacfwd(
        lambda *a: _jax_res(*a, model), argnums=(0, 1))))
    Jc_j, Jp_j = jac_j(*(jnp.asarray(a) for a in ins))
    Jc_t, Jp_t = vmap(jacfwd(
        lambda *a: _torch_res(*a, model), argnums=(0, 1)))(
        *(torch.tensor(a) for a in ins))
    np.testing.assert_allclose(Jc_t.numpy(), np.asarray(Jc_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(Jp_t.numpy(), np.asarray(Jp_j), rtol=0,
                               atol=ATOL)


def _poses(rng, n):
    """n unnormalized quaternions (norms 0.5-2) and translations."""
    q = _quats(rng, n) * rng.uniform(0.5, 2.0, (n, 1))
    return q, rng.standard_normal((n, 3)) * 3.0


@pytest.mark.parametrize("fn,nargs", [
    ("quat_conjugate", 1), ("pose_compose", 2), ("pose_inverse", 2),
    ("projection_center", 2), ("pose_relative", 4)])
def test_pose_functions_match_jax(fn, nargs):
    """Seeded float64 poses (unnormalized quaternions) through the JAX
    function and the port's, to 1e-12."""
    rng = np.random.default_rng(len(fn))
    q1, t1 = _poses(rng, 32)
    q2, t2 = _poses(rng, 32)
    args = (q1, t1, q2, t2)[:nargs]
    want = getattr(jlie, fn)(*(jnp.asarray(a) for a in args))
    got = getattr(tlie, fn)(*(torch.tensor(a) for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


def test_rotmat_angular_distance_matches_jax():
    """Random rotation pairs (angles well inside (0, pi), where acos is
    well conditioned) and batched shapes, float64 to 1e-12."""
    rng = np.random.default_rng(9)
    R1 = np.stack([tlie_np.quat_to_rotmat(q)
                   for q in _quats(rng, 24)]).reshape(4, 6, 3, 3)
    R2 = np.stack([tlie_np.quat_to_rotmat(q)
                   for q in _quats(rng, 24)]).reshape(4, 6, 3, 3)
    want = np.asarray(jlie.rotmat_angular_distance(jnp.asarray(R1),
                                                   jnp.asarray(R2)))
    got = tlie.rotmat_angular_distance(torch.tensor(R1),
                                       torch.tensor(R2)).numpy()
    assert got.shape == (4, 6)
    assert 0.05 < want.min() and want.max() < np.pi - 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
