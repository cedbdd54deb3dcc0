"""Port parity under a distorted camera (OPENCV), and the distorted path
end to end.

The card's BA route (``ba_soa.bundle_adjust_soa``, and
``ba_dense.bundle_adjust_dense`` explicit and implicit) on problems
whose camera is OPENCV ``[f, f, cx, cy, -0.16, 0.035, 1e-3, -5e-4]``,
the distortion ``tools/synth_dataset.py`` renders (tens of pixels at the
image corners): the same float64 problem, built with numpy from a seed,
goes through the JAX package (``gram_mode="xla"``) and the port (plain
Gram and PCG on the CPU).

* Residuals and Jacobians of every observation agree to 1e-10.
* One LM step agrees to float64 rounding (costs rtol 1e-9; q, t, X atol
  1e-8, the bars of ``test_torch_ba_soa.py``).
* The converged cost agrees to 1e-3 relative, on a problem whose optimum
  sits at the measurement-noise floor (``tests/test_ba_soa.py:166-199``).

On the card (``cuda``): the SoA solve with the kernels against its plain
twin in float64, and two float32 solves bit-equal.  The distorted path
end to end is ``test_torch_distorted_e2e.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.ops import lie_np
from privacy_preserving_sfm_torch.optim import ba as tba
from privacy_preserving_sfm_torch.optim import ba_dense as tbd
from privacy_preserving_sfm_torch.optim import ba_soa as tsoa
from privacy_preserving_sfm_torch.optim import convert

torch.set_num_threads(2)

MODEL = "OPENCV"
PARAMS = [500.0, 500.0, 320.0, 240.0, -0.16, 0.035, 1e-3, -5e-4]
SOLVERS = ["soa", "explicit", "implicit"]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's BA modules, imported here so that the ``cuda``
    test collects where JAX is not installed (``--noconftest``)."""
    import jax
    import jax.numpy as jnp

    from privacy_preserving_sfm_tpu.optim import ba, ba_dense, ba_soa

    return SimpleNamespace(jax=jax, jnp=jnp, ba=ba, dense=ba_dense,
                           soa=ba_soa)


def _fields(seed, num_cams=6, num_points=80, obs_per_point=4, noise=1e-2,
            meas_noise=0.0):
    """Numpy fields of a flat problem: ``test_torch_ba_soa.py``'s layout
    with points twice as wide in x, so that they reach the distorted rim
    (normalized radius up to ~0.7), and the OPENCV camera.  Lines pass
    through the noisy normalized projections."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (num_points, 3)) * np.array([2.0, 1.0, 1.0])
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
        cam_params=np.tile(PARAMS, (num_cams, 1)),
        points3d=pts + rng.normal(0, noise, pts.shape),
        obs_cam=obs_cam.astype(np.int32),
        obs_point=obs_point.astype(np.int32),
        obs_line=lines, obs_weight=np.ones(len(obs_cam)),
        cam_dof_mask=mask, point_mask=np.ones(num_points))


def _dense_pair(ref, fields):
    jflat = ref.ba.BAProblem(**{k: ref.jnp.asarray(v)
                                for k, v in fields.items()})
    jdense = ref.dense.from_flat_problem(jflat, k_bucket=4)
    tdense = convert.dense_problem_from_numpy(
        {k: np.asarray(v) for k, v in jdense._asdict().items()},
        "cpu", torch.float64)
    return jdense, tdense


def _both(ref, fields, solver, **kw):
    """The reference's and the port's solve of one problem on ``solver``."""
    jdense, tdense = _dense_pair(ref, fields)
    mode = "explicit" if solver == "soa" else solver
    jopts = ref.ba.BAOptions(schur_mode=mode, gram_mode="xla", **kw)
    topts = tba.BAOptions(schur_mode=mode, **kw)
    if solver == "soa":
        j = ref.jax.jit(lambda p: ref.soa.bundle_adjust_soa(
            p, MODEL, jopts))(jdense)
        t = tsoa.bundle_adjust_soa(tdense, MODEL, topts)
    else:
        j = ref.jax.jit(lambda p: ref.dense.bundle_adjust_dense(
            p, MODEL, jopts))(jdense)
        t = tbd.bundle_adjust_dense(tdense, MODEL, topts)
    return j, t


def test_the_problem_carries_real_distortion(ref):
    """The distortion moves the residuals by pixels, not by round-off."""
    fields = _fields(3)
    _, tdense = _dense_pair(ref, fields)
    args = (tdense, tdense.qvecs, tdense.tvecs, tdense.points3d)
    r, _, _ = tbd._residuals_and_jacobians(*args, MODEL)
    pinhole = tdense._replace(cam_params=tdense.cam_params[:, [0, 2, 3]])
    r0, _, _ = tbd._residuals_and_jacobians(
        pinhole, *args[1:], "SIMPLE_PINHOLE")
    assert float((r - r0).abs().max()) > 1.0


@pytest.mark.parametrize("layout", ["soa", "dense"])
def test_residuals_and_jacobians_match_reference(ref, layout):
    fields = _fields(3)
    jdense, tdense = _dense_pair(ref, fields)
    jax, jnp = ref.jax, ref.jnp
    q, t, X = (jnp.asarray(fields[k]) for k in ("qvecs", "tvecs",
                                                  "points3d"))
    r_t, jc_t, jp_t = tbd._residuals_and_jacobians(
        tdense, tdense.qvecs, tdense.tvecs, tdense.points3d, MODEL)
    if layout == "dense":
        r_j, jc_j, jp_j = (np.asarray(a) for a in jax.jit(
            lambda p, q, t, X: ref.dense._residuals_and_jacobians(
                p, q, t, X, MODEL))(jdense, q, t, X))
    else:
        oc = jdense.obs_cam.T  # (K, P)
        cam = tuple(a[oc] for a in (*q.T, *t.T, *jdense.cam_params.T))
        Xc = tuple(jnp.broadcast_to(x, oc.shape) for x in X.T)
        lc = tuple(jdense.obs_line[..., i].T for i in range(3))
        r1, r2, jc, jp = jax.jit(
            lambda c, x, l: ref.soa._soa_residuals_and_jacobians(
                c, x, l, MODEL))(cam, Xc, lc)
        # (K, P) components -> the dense layout (P, K, 2, ...).
        r_j = np.stack([np.asarray(r1).T, np.asarray(r2).T], -1)
        jc_j = np.stack([np.stack([np.asarray(a).T for a in jc[:6]], -1),
                         np.stack([np.asarray(a).T for a in jc[6:]], -1)],
                        2)
        jp_j = np.stack([np.stack([np.asarray(a).T for a in jp[:3]], -1),
                         np.stack([np.asarray(a).T for a in jp[3:]], -1)],
                        2)
        # The SoA components are unmasked; the port's dense ones masked.
        dof = np.asarray(jdense.cam_dof_mask)[np.asarray(jdense.obs_cam)]
        jc_j = jc_j * dof[:, :, None, :]
        jp_j = jp_j * np.asarray(jdense.point_mask)[:, None, None, None]
    for a, b in ((r_t, r_j), (jc_t, jc_j), (jp_t, jp_j)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-10)


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("loss", ["trivial", "cauchy"])
def test_one_lm_step_matches_reference(ref, solver, loss):
    (qj, tj, Xj, sj), (qt, tt, Xt, st) = _both(
        ref, _fields(3), solver, max_iterations=1, cg_iterations=20, loss=loss,
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


@pytest.mark.parametrize("solver", SOLVERS)
def test_converged_cost_matches_reference(ref, solver):
    (_, _, _, sj), (_, _, _, st) = _both(
        ref, _fields(8, meas_noise=1e-3), solver, max_iterations=40,
        cg_iterations=40, function_tolerance=1e-10)
    assert st.final_cost < 0.5 * st.initial_cost
    np.testing.assert_allclose(st.final_cost, float(sj.final_cost),
                               rtol=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_soa_kernels_under_opencv_match_plain_and_repeat(cuda):
    """The SoA solve with ``schur_gram.cu`` and ``schur_pcg.cu`` against
    its plain twin (float64), and two float32 solves bit-equal."""
    fields = _fields(4, num_cams=12, num_points=300, obs_per_point=5,
                     meas_noise=1e-3)
    flat = convert.ba_problem_from_numpy(fields, cuda, torch.float64)
    dense = tbd.from_flat_problem(flat)
    opts = tba.BAOptions(max_iterations=3, cg_iterations=20)
    ref = tsoa.bundle_adjust_soa(dense, MODEL, opts, plain=True)
    got = tsoa.bundle_adjust_soa(dense, MODEL, opts)
    assert got[3].num_iterations == ref[3].num_iterations
    np.testing.assert_allclose(got[3].final_cost, ref[3].final_cost,
                               rtol=1e-9)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=0, atol=1e-8)
    dense32 = tbd.from_flat_problem(
        convert.ba_problem_from_numpy(fields, cuda, torch.float32))
    opts = tba.BAOptions(max_iterations=20)
    (*a, sa), (*b, sb) = (tsoa.bundle_adjust_soa(dense32, MODEL, opts)
                          for _ in range(2))
    assert sa.num_iterations == sb.num_iterations > 1
    assert sa.final_cost == sb.final_cost < sa.initial_cost
    for u, v in zip(a, b):
        assert torch.equal(u, v)
