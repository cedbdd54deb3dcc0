"""Port parity: the variable-intrinsics BA against the JAX package.

The four problems of ``tests/test_ba_intrinsics.py`` (a shared focal
lifted 12 % wrong, the intrinsics fully masked, a principal point lifted
6 px wrong, and the ``correct_lines`` round trip), built with numpy from
its seeds, go through ``privacy_preserving_sfm_tpu.optim.ba_intrinsics``
and the port's, in float64 on the CPU: the line correction to 1e-12, the
mask equal, residuals and the three Jacobians to 1e-10, one LM step (one
normal build and one ``solve_step``) to 1e-8 (the intrinsics, in pixels,
to 1e-10 relative), and the solve's poses and points to 1e-6 and
intrinsics to 1e-8 relative, with equal iteration counts.  A problem
with two unique cameras over the slots checks the sharing.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.optim import ba as tba
from privacy_preserving_sfm_torch.optim import ba_intrinsics as tbi
from privacy_preserving_sfm_torch.optim import convert
from privacy_preserving_sfm_tpu.optim import ba as jba
from privacy_preserving_sfm_tpu.optim import ba_intrinsics as jbi

from test_ba import make_ba_problem
from test_ba_intrinsics import _mislift, _wrap

torch.set_num_threads(2)

MODEL = "SIMPLE_PINHOLE"

# name -> (seed, make_ba_problem kwargs, _mislift kwargs, _wrap kwargs,
# max_iterations), as tests/test_ba_intrinsics.py builds them.
CASES = {
    "shared_focal": (0, dict(num_cams=8, num_points=120, perturb=0.01),
                     dict(f_true=500.0, f_lift=560.0),
                     dict(lift_focal=560.0), 200),
    "fully_masked": (1, {}, None,
                     dict(mask_flags=(False, False, False)), 50),
    "principal_shift": (2, dict(num_cams=8, num_points=120, perturb=0.005),
                        dict(c_shift=(6.0, -4.0)),
                        dict(mask_flags=(False, True, False)), 200),
    "two_cameras": (0, dict(num_cams=8, num_points=120, perturb=0.01),
                    dict(f_true=500.0, f_lift=560.0),
                    dict(lift_focal=560.0, num_unique=2), 200),
}


# The solves stop on the gradient, as the mapper's BAs do: these problems
# have no noise, so the function-tolerance stop would fall where the cost
# is ~1e-25 and rounding decides it.
GRADIENT_TOLERANCE = 1e-4


@functools.lru_cache(maxsize=None)
def problems(name):
    """The reference's IntrBAProblem and the port's, the same numbers."""
    seed, make_kw, mislift_kw, wrap_kw, _ = CASES[name]
    problem, *_ = make_ba_problem(np.random.default_rng(seed), **make_kw)
    if mislift_kw is not None:
        problem = _mislift(problem, **mislift_kw)
    jp = _wrap(problem, MODEL, **wrap_kw)
    base = convert.ba_problem_from_numpy(
        {k: np.asarray(v) for k, v in jp.base._asdict().items()}, "cpu",
        torch.float64)

    def f(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64)

    tp = tbi.IntrBAProblem(
        base=base,
        cam_of_slot=torch.tensor(np.asarray(jp.cam_of_slot), dtype=torch.int64),
        intr_params=f(jp.intr_params), intr_mask=f(jp.intr_mask),
        lift_params=f(jp.lift_params))
    return jp, tp


@functools.lru_cache(maxsize=None)
def solves(name, max_iterations, gradient_tolerance=0.0):
    jp, tp = problems(name)
    opts = dict(max_iterations=max_iterations,
                gradient_tolerance=gradient_tolerance)
    j = jax.jit(lambda p: jbi.bundle_adjust_intrinsics(
        p, MODEL, jba.BAOptions(**opts)))(jp)
    t = tbi.bundle_adjust_intrinsics(tp, MODEL, tba.BAOptions(**opts))
    return j, t


def test_corrected_line_and_correct_lines_match():
    rng = np.random.default_rng(11)
    lines = rng.standard_normal((200, 3))
    lines /= np.linalg.norm(lines[:, :2], axis=-1, keepdims=True)
    for model, lp, par in (
            ("SIMPLE_PINHOLE", [550.0, 320.0, 240.0], [500.0, 314.0, 244.0]),
            ("PINHOLE", [550.0, 560.0, 320.0, 240.0],
             [505.0, 495.0, 318.0, 243.0]),
            ("SIMPLE_RADIAL", [550.0, 320.0, 240.0, 0.0],
             [500.0, 316.0, 238.0, 0.01])):
        lp, par = np.asarray(lp), np.asarray(par)
        want = np.asarray(jbi.correct_lines(lines, lp, par, model))
        np.testing.assert_allclose(tbi.correct_lines(lines, lp, par, model),
                                   want, rtol=0, atol=1e-12)
        got = tbi.corrected_line(torch.tensor(lines), torch.tensor(lp),
                                 torch.tensor(par), model)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_correct_lines_round_trip_fits_the_scene():
    """tests/test_ba_intrinsics.py's round trip through the port: lines
    lifted with f = 550, corrected to the true 500, fit the true scene."""
    rng = np.random.default_rng(3)
    problem, qs, ts, pts = make_ba_problem(rng)
    problem = _mislift(problem, f_true=500.0, f_lift=550.0)
    lift = np.array([550.0, 320.0, 240.0])
    fixed = np.array([500.0, 320.0, 240.0])
    corrected = tbi.correct_lines(np.asarray(problem.obs_line), lift, fixed,
                                  MODEL)
    np.testing.assert_allclose(
        corrected, jbi.correct_lines(np.asarray(problem.obs_line), lift,
                                     fixed, MODEL), rtol=0, atol=1e-12)
    fields = {k: np.asarray(v) for k, v in problem._asdict().items()}
    fields.update(obs_line=corrected, qvecs=qs, tvecs=ts, points3d=pts,
                  cam_params=np.tile(fixed, (len(qs), 1)))
    base = convert.ba_problem_from_numpy(fields, "cpu", torch.float64)
    c = tba._cost(base, base.qvecs, base.tvecs, base.points3d, MODEL,
                  "trivial", 1.0)
    assert float(c) < 1e-12


@pytest.mark.parametrize("flags", [(True, False, False), (False, True, False),
                                   (False, False, True), (True, True, True),
                                   (False, False, False)])
@pytest.mark.parametrize("model", ["SIMPLE_PINHOLE", "PINHOLE",
                                   "SIMPLE_RADIAL", "OPENCV"])
def test_intr_mask_equals_the_reference(model, flags):
    np.testing.assert_array_equal(tbi.intr_mask_for_model(model, *flags),
                                  jbi.intr_mask_for_model(model, *flags))


@pytest.mark.parametrize("name", sorted(CASES))
def test_residuals_and_jacobians_match(name):
    jp, tp = problems(name)
    # At a point away from the lift: intrinsics moved, so the corrected
    # line's derivative is not the identity's.
    rng = np.random.default_rng(5)
    intr = np.asarray(jp.intr_params) * (1 + rng.normal(0, 0.02,
                                                        jp.intr_params.shape))
    b = jp.base
    want = jbi._residuals_and_jacobians(jp, b.qvecs, b.tvecs, b.points3d,
                                        jnp.asarray(intr), MODEL)
    tb = tp.base
    got = tbi._residuals_and_jacobians(tp, tb.qvecs, tb.tvecs, tb.points3d,
                                       torch.tensor(intr), MODEL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-10)
    assert float(np.abs(np.asarray(want[3])).max()) > 0 or \
        not np.asarray(jp.intr_mask).any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_lm_step_matches(name):
    (jq, jt, jX, ji, js), (tq, tt, tX, ti, ts) = solves(name, 1)
    assert ts.num_iterations == int(js.num_iterations) == 1
    np.testing.assert_allclose(ts.initial_cost, float(js.initial_cost),
                               rtol=1e-9)
    np.testing.assert_allclose(ts.final_cost, float(js.final_cost),
                               rtol=1e-8)
    assert ts.final_cost < ts.initial_cost
    for g, w in ((tq, jq), (tt, jt), (tX, jX)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-8)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-10,
                               atol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_matches(name):
    (jq, jt, jX, ji, js), (tq, tt, tX, ti, ts) = solves(
        name, CASES[name][4], GRADIENT_TOLERANCE)
    assert ts.num_iterations == int(js.num_iterations) > 1
    for g, w in ((tq, jq), (tt, jt), (tX, jX)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-8,
                               atol=0)
    mask = np.asarray(problems(name)[0].intr_mask)
    start = np.asarray(problems(name)[0].intr_params)
    np.testing.assert_array_equal(ti.numpy()[mask == 0], start[mask == 0])
    if name == "shared_focal":
        assert ts.final_cost < 1e-8
        np.testing.assert_allclose(float(ti[0, 0]), 500.0, rtol=1e-2)
    if name == "principal_shift":
        np.testing.assert_allclose(ti[0, 1:].numpy(), [314.0, 244.0],
                                   atol=0.2)
