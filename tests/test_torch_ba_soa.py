"""Port parity: the explicit-Schur LM solver against the JAX package.

The same float64 problem, built with numpy from a seed, goes through the
reference ``bundle_adjust_soa`` (``gram_mode="xla"``: its XLA Gram and
PCG) and the port's, whose Gram and PCG take their plain versions on the
CPU.  One LM step agrees to float64 rounding (costs rtol 1e-9, q, t, X
atol 1e-8); 12 steps on a problem with measurement noise take the same
iteration count and agree on the final cost to rtol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from privacy_preserving_sfm_tpu.optim import ba as jba
from privacy_preserving_sfm_tpu.optim import ba_dense as jbd
from privacy_preserving_sfm_tpu.optim import ba_soa as jsoa
from privacy_preserving_sfm_torch.ops import lie_np
from privacy_preserving_sfm_torch.optim import ba as tba
from privacy_preserving_sfm_torch.optim import ba_dense as tbd
from privacy_preserving_sfm_torch.optim import ba_soa as tsoa
from privacy_preserving_sfm_torch.optim import convert

torch.set_num_threads(2)

MODEL = "SIMPLE_PINHOLE"


def _make_fields(rng, num_cams=6, num_points=80, obs_per_point=4,
                 noise=1e-2, meas_noise=0.0):
    """Numpy fields of a flat BAProblem (the layout of test_ba_soa.py)."""
    pts = rng.uniform(-2, 2, (num_points, 3))
    pts[:, 2] += 8.0
    qs = np.zeros((num_cams, 4))
    ts = np.zeros((num_cams, 3))
    for c in range(num_cams):
        yaw = rng.uniform(-0.4, 0.4)
        qs[c] = [np.cos(yaw / 2), 0, np.sin(yaw / 2), 0]
        ts[c] = [rng.uniform(-2, 2), rng.uniform(-0.3, 0.3),
                 rng.uniform(-0.5, 0.5)]
    obs_cam = np.stack([rng.permutation(num_cams)[:obs_per_point]
                        for _ in range(num_points)]).reshape(-1)
    obs_point = np.repeat(np.arange(num_points), obs_per_point)
    Rm = np.stack([lie_np.quat_to_rotmat(q) for q in qs])
    Xc = np.einsum("oij,oj->oi", Rm[obs_cam], pts[obs_point]) + ts[obs_cam]
    uv = Xc[:, :2] / np.maximum(Xc[:, 2:], 0.5)
    uv = uv + rng.normal(0, meas_noise, uv.shape)
    hom = np.concatenate([uv, np.ones((len(uv), 1))], 1)
    lines = np.cross(rng.standard_normal((len(uv), 3)), hom)
    lines /= np.linalg.norm(lines[:, :2], axis=-1, keepdims=True)
    mask = np.ones((num_cams, 6))
    mask[0] = 0.0
    mask[1, 3] = 0.0
    return dict(
        qvecs=qs + rng.normal(0, noise * 0.1, qs.shape),
        tvecs=ts + rng.normal(0, noise, ts.shape),
        cam_params=np.tile([500.0, 320.0, 240.0], (num_cams, 1)),
        points3d=pts + rng.normal(0, noise, pts.shape),
        obs_cam=obs_cam.astype(np.int32),
        obs_point=obs_point.astype(np.int32),
        obs_line=lines, obs_weight=np.ones(len(obs_cam)),
        cam_dof_mask=mask, point_mask=np.ones(num_points))


def _both(fields, jopts, topts):
    """Run the reference and the port on the same problem."""
    jflat = jba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()})
    jdense = jbd.from_flat_problem(jflat, k_bucket=4)
    j = jax.jit(lambda p: jsoa.bundle_adjust_soa(p, MODEL, jopts))(jdense)
    tdense = convert.dense_problem_from_numpy(
        {k: np.asarray(v) for k, v in jdense._asdict().items()},
        "cpu", torch.float64)
    t = tsoa.bundle_adjust_soa(tdense, MODEL, topts)
    return j, t


@pytest.mark.parametrize("loss", ["trivial", "cauchy"])
def test_one_lm_step_matches_reference(loss):
    fields = _make_fields(np.random.default_rng(3))
    (qj, tj, Xj, sj), (qt, tt, Xt, st) = _both(
        fields,
        jba.BAOptions(max_iterations=1, cg_iterations=20, loss=loss,
                      function_tolerance=0.0, gram_mode="xla"),
        tba.BAOptions(max_iterations=1, cg_iterations=20, loss=loss,
                      function_tolerance=0.0))
    assert st.num_iterations == int(sj.num_iterations) == 1
    np.testing.assert_allclose(st.initial_cost, float(sj.initial_cost),
                               rtol=1e-9)
    np.testing.assert_allclose(st.final_cost, float(sj.final_cost),
                               rtol=1e-9)
    assert st.final_cost < st.initial_cost
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0, atol=1e-8)


@pytest.mark.parametrize("loss", ["trivial", "cauchy"])
def test_twelve_lm_steps_match_reference(loss):
    fields = _make_fields(np.random.default_rng(8), meas_noise=1e-3)
    (_, _, _, sj), (_, _, _, st) = _both(
        fields,
        jba.BAOptions(max_iterations=12, cg_iterations=20, loss=loss,
                      gram_mode="xla"),
        tba.BAOptions(max_iterations=12, cg_iterations=20, loss=loss))
    assert st.num_iterations == int(sj.num_iterations)
    np.testing.assert_allclose(st.final_cost, float(sj.final_cost),
                               rtol=1e-6)
    np.testing.assert_allclose(st.lam, float(sj.lam), rtol=1e-6)
    assert st.final_cost < 0.5 * st.initial_cost


def test_gradient_tolerance_stop_matches_reference():
    fields = _make_fields(np.random.default_rng(9), meas_noise=1e-3)
    (_, _, _, sj), (_, _, _, st) = _both(
        fields,
        jba.BAOptions(max_iterations=30, gradient_tolerance=1.0,
                      gram_mode="xla"),
        tba.BAOptions(max_iterations=30, gradient_tolerance=1.0))
    assert st.num_iterations == int(sj.num_iterations) < 30
    np.testing.assert_allclose(st.final_cost, float(sj.final_cost),
                               rtol=1e-6)


def test_soa_respects_gauge_mask():
    fields = _make_fields(np.random.default_rng(5))
    dense = tbd.from_flat_problem(
        convert.ba_problem_from_numpy(fields, "cpu", torch.float64))
    q, t, X, s = tsoa.bundle_adjust_soa(dense, MODEL,
                                        tba.BAOptions(max_iterations=5))
    assert s.final_cost < s.initial_cost
    # _apply_step renormalizes every quaternion; the held camera's
    # rotation and translation must be unchanged, as must tvec x of cam 1.
    q0 = fields["qvecs"][0]
    np.testing.assert_allclose(q[0].numpy(), q0 / np.linalg.norm(q0),
                               atol=1e-12)
    np.testing.assert_allclose(t[0].numpy(), fields["tvecs"][0], atol=1e-12)
    np.testing.assert_allclose(float(t[1, 0]), fields["tvecs"][1, 0],
                               atol=1e-12)
    assert abs(float(t[1, 1]) - fields["tvecs"][1, 1]) > 0


def test_convert_round_trips_reference_problem():
    fields = _make_fields(np.random.default_rng(6))
    jflat = jba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()})
    jdense = jbd.from_flat_problem(jflat, k_bucket=4)
    for jp, conv in ((jflat, convert.ba_problem_from_numpy),
                     (jdense, convert.dense_problem_from_numpy)):
        np_fields = {k: np.asarray(v) for k, v in jp._asdict().items()}
        tp = conv(np_fields, "cpu", torch.float64)
        for name in tp._fields:
            v = getattr(tp, name)
            assert v.device.type == "cpu"
            if name in ("obs_cam", "obs_point"):
                assert v.dtype == torch.int64
            else:
                assert v.dtype == torch.float64
            np.testing.assert_array_equal(v.numpy(), np_fields[name])


def test_from_flat_problem_matches_reference():
    """The port packs the same per-point slots; it only drops the
    reference's K padding (which carries weight 0)."""
    fields = _make_fields(np.random.default_rng(7))
    fields["obs_weight"][::7] = 0.0  # padding observations are skipped
    jdense = jbd.from_flat_problem(
        jba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()}),
        k_bucket=4)
    tdense = tbd.from_flat_problem(
        convert.ba_problem_from_numpy(fields, "cpu", torch.float64))
    K = tdense.obs_cam.shape[1]
    assert K == 4
    np.testing.assert_array_equal(tdense.obs_cam.numpy(),
                                  np.asarray(jdense.obs_cam)[:, :K])
    np.testing.assert_array_equal(tdense.obs_line.numpy(),
                                  np.asarray(jdense.obs_line)[:, :K])
    np.testing.assert_array_equal(tdense.obs_weight.numpy(),
                                  np.asarray(jdense.obs_weight)[:, :K])
    assert not np.asarray(jdense.obs_weight)[:, K:].any()
