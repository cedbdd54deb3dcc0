"""The port's shared-camera BA against the benchmark's plain references.

A video from one camera of unknown focal: C = 8 image slots share one
SIMPLE_PINHOLE camera (U = 1), the focal started 2 % off and the lines
lifted under it (``benchmark/gen/shared_camera``).  On the CPU in float64
the port's ``bundle_adjust_intrinsics``, reached through
``ba_intrinsics.from_flat_problem`` as the mapper reaches it, is held to
``benchmark/reference/ba_intrinsics.py``: one LM step, then the solved
focal, cost, poses and points.  ``from_flat_problem`` gives the tensors
the mapper built inline before it, to the bit.  The local-BA reference
``benchmark/reference/ba_local.py`` with nothing frozen and the trivial
loss is ``benchmark/reference/ba.py``, to the bit; with frozen points
their steps are exactly zero, and its soft-L1 normal equations are the
port's reweighted ones.
"""

import numpy as np
import pytest
import torch

from benchmark.gen import ba_scene, shared_camera
from benchmark.reference import ba as ref
from benchmark.reference import ba_intrinsics as iref
from benchmark.reference import ba_local as lref
from privacy_preserving_sfm_torch.optim import ba as tba
from privacy_preserving_sfm_torch.optim import ba_intrinsics as tbi

torch.set_num_threads(2)

CPU = torch.device("cpu")
MODEL = "SIMPLE_PINHOLE"
SCENE = dict(num_cameras=8, num_points=120, obs_per_point=5,
             meas_noise=2e-4)


def _start(seed=5):
    s = ba_scene.make_scene(SCENE, seed, CPU)
    q0, t0, X0 = ba_scene.perturbed_start(s, seed + 1)
    f_true, cx, cy = ba_scene.PARAMS
    f0 = f_true * 1.02
    lines = shared_camera.lifted_lines(s.lines, f_true, f0)
    C, P = s.qvecs.shape[0], s.points.shape[0]
    mask = ba_scene.gauge_mask(C, CPU, *ba_scene.gauge_pair(s)).double()
    return s, (q0, t0, X0), (f0, cx, cy), lines, mask, C, P


def _port(opts, seed=5):
    s, (q0, t0, X0), cam0, lines, mask, C, P = _start(seed)
    base = tba.BAProblem(
        qvecs=q0, tvecs=t0, cam_params=torch.tensor([cam0]).expand(C, 3),
        points3d=X0, obs_cam=s.obs_cam, obs_point=s.obs_pt, obs_line=lines,
        obs_weight=torch.ones(len(lines), dtype=torch.float64),
        cam_dof_mask=mask, point_mask=torch.ones(P, dtype=torch.float64))
    problem = tbi.from_flat_problem(base, MODEL, np.zeros(C, np.int64),
                                    np.array([cam0]), opts)
    return tbi.bundle_adjust_intrinsics(problem, MODEL, opts)


def _reference(seed=5):
    s, (q0, t0, X0), cam0, lines, mask, C, P = _start(seed)
    prob = iref.to_problem(s.obs_cam, s.obs_pt, lines, cam0, mask, C, P)
    return prob, (q0, t0, X0, cam0[0])


def test_one_lm_step_is_the_references_exact_step():
    """The first LM step at the initial damping (accepted: the cost
    falls).  The port's CG runs 100 steps on the 49 unknowns, so it
    reaches the exact solve to rounding; the Jacobians are ``jacfwd``
    against analytic ones: 1e-7 relative, far below the step itself."""
    opts = tba.BAOptions(max_iterations=1, cg_iterations=100,
                         refine_focal_length=True)
    q, t, X, cam, summary = _port(opts)
    assert summary.num_iterations == 1
    assert summary.final_cost < summary.initial_cost
    prob, (q0, t0, X0, f0) = _reference()
    n = iref.normal_equations(prob, q0, t0, X0, f0)
    dc, df, dp = iref.step(prob, n, float(opts.initial_lambda))
    qr, tr, Xr = ref.apply_step(q0, t0, X0, dc, dp)
    assert abs(float(cam[0, 0]) - (f0 - float(df))) < 1e-7 * abs(float(df))
    assert torch.equal(cam[0, 1:], torch.tensor([320.0, 240.0],
                                                dtype=torch.float64))
    assert torch.allclose(X, Xr, rtol=0, atol=1e-7 * float(dp.abs().max()))
    assert torch.allclose(t, tr, rtol=0, atol=1e-7 * float(dc.abs().max()))
    assert torch.allclose(q * torch.sign(q[:, :1]), qr * torch.sign(qr[:, :1]),
                          rtol=0, atol=1e-7 * float(dc.abs().max()))


def test_solved_focal_cost_poses_and_points_match_the_reference():
    """Both solves converge from the same start to the same minimum: the
    port's float64 LM with its CG at 100 steps and no gradient stop, the
    reference's with exact steps.  Focal to 1e-8 relative, cost to 1e-9
    relative, poses and points to 1e-6 scene units (the minimum's
    flat directions are held by the gauge; what is left is LM's stop)."""
    opts = tba.BAOptions(max_iterations=100, cg_iterations=100,
                         function_tolerance=1e-14,
                         refine_focal_length=True)
    q, t, X, cam, summary = _port(opts)
    prob, (q0, t0, X0, f0) = _reference()
    sol = iref.solve(prob, q0, t0, X0, f0)
    f = float(cam[0, 0])
    assert abs(f - f0) > 5.0  # the focal moved back from 2 % off
    assert abs(f - sol.f) < 1e-8 * sol.f
    assert abs(f - ba_scene.PARAMS[0]) < 0.01 * ba_scene.PARAMS[0]
    c = float(iref.cost(prob, q, t, X, f))
    assert abs(c - sol.cost) < 1e-9 * sol.cost
    assert abs(summary.final_cost - c) < 1e-9 * c
    assert torch.allclose(ref.camera_centres(q, t),
                          ref.camera_centres(sol.q, sol.t), rtol=0,
                          atol=1e-6)
    assert torch.allclose(X, sol.X, rtol=0, atol=1e-6)


def test_reference_focal_jacobian_against_autodiff():
    """d(f s) / df of the reference against autodiff of f s through its
    corrected lines, and its residual against that f s."""
    prob, (q0, t0, X0, f0) = _reference()

    def fs(f):
        return f * ref.line_distances(iref.at_focal(prob, f), q0, t0, X0)

    f = torch.tensor(f0 * 0.99, dtype=torch.float64)
    n = iref.normal_equations(prob, q0, t0, X0, float(f))
    assert torch.allclose(n.Jf, torch.func.jacfwd(fs)(f), rtol=1e-9,
                          atol=1e-12)
    assert torch.allclose(n.pose.r, fs(f), rtol=1e-12, atol=1e-12)


def test_from_flat_problem_is_the_mappers_inline_problem():
    """The tensors ``_run_ba_intrinsics`` built inline before the entry
    existed (its parent's code, written out here), to the bit: float32
    and float64, focal only and every subset."""
    s, (q0, t0, X0), cam0, lines, mask, C, P = _start()
    for dtype in (torch.float32, torch.float64):
        for flags in ((True, False, False), (True, True, True)):
            opts = tba.BAOptions(refine_focal_length=flags[0],
                                 refine_principal_point=flags[1],
                                 refine_extra_params=flags[2])
            base = tba.BAProblem(
                qvecs=q0.to(dtype), tvecs=t0.to(dtype),
                cam_params=torch.tensor([cam0], dtype=dtype).expand(C, 3),
                points3d=X0.to(dtype), obs_cam=s.obs_cam,
                obs_point=s.obs_pt, obs_line=lines.to(dtype),
                obs_weight=torch.ones(len(lines), dtype=dtype),
                cam_dof_mask=mask.to(dtype),
                point_mask=torch.ones(P, dtype=dtype))
            cam_of_slot = np.zeros(C, np.int64)
            intr = np.stack([np.array(cam0)])
            intr_mask = np.tile(tbi.intr_mask_for_model(MODEL, *flags),
                                (1, 1))

            def f(a):
                return torch.tensor(a, dtype=dtype, device=CPU)

            want = tbi.IntrBAProblem(
                base=base, cam_of_slot=torch.tensor(cam_of_slot, device=CPU),
                intr_params=f(intr), intr_mask=f(intr_mask),
                lift_params=f(intr))
            got = tbi.from_flat_problem(base, MODEL, cam_of_slot, intr, opts)
            assert got.base is base
            for name in ("cam_of_slot", "intr_params", "intr_mask",
                         "lift_params"):
                a, b = getattr(got, name), getattr(want, name)
                assert a.dtype == b.dtype and torch.equal(a, b), name


def _local(frozen_share, scale, seed=9):
    s = ba_scene.make_scene(SCENE, seed, CPU)
    C, P = s.qvecs.shape[0], s.points.shape[0]
    mask = ba_scene.gauge_mask(C, CPU, *ba_scene.gauge_pair(s))
    pmask = torch.ones(P, dtype=torch.float64)
    pmask[torch.randperm(P, generator=torch.Generator().manual_seed(seed))[
        :round(frozen_share * P)]] = 0.0
    lprob = lref.to_problem(s.obs_cam, s.obs_pt, s.lines, ba_scene.PARAMS,
                            mask, pmask, C, P, scale)
    return lprob, ba_scene.perturbed_start(s, seed + 1)


def test_local_reference_with_nothing_frozen_is_the_global_reference():
    lprob, (q0, t0, X0) = _local(0.0, 0.0)
    want = ref.solve(lprob.base, q0, t0, X0)
    got = lref.solve(lprob, q0, t0, X0)
    assert got.iterations == want.iterations > 2
    assert got.cost == want.cost
    for a, b in ((got.q, want.q), (got.t, want.t), (got.X, want.X)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scale", [0.0, 1.0])
def test_local_reference_holds_frozen_points_and_lowers_its_cost(scale):
    lprob, (q0, t0, X0) = _local(0.44, scale)
    frozen = lprob.point_mask == 0
    sol = lref.solve(lprob, q0, t0, X0)
    assert torch.equal(sol.X[frozen], X0[frozen])
    assert not torch.equal(sol.X[~frozen], X0[~frozen])
    assert sol.cost < 0.5 * float(lref.cost(lprob, q0, t0, X0))


def test_local_reference_normal_equations_are_the_ports_reweighted_ones():
    """Soft-L1 of scale 1 with 44 % of the points frozen: the camera block
    and gradient of the reference's reweighted normal equations against
    the port's flat solver's ``build_normal`` pieces, recomputed here
    from the port's robust weight (float64, to 1e-9 relative)."""
    lprob, (q0, t0, X0) = _local(0.44, 1.0)
    n = lref.normal_equations(lprob, q0, t0, X0)
    b = lprob.base
    raw = ref.normal_equations(b, q0, t0, X0)
    w = tba._robust_weight(raw.r * raw.r, "soft_l1", 1.0)
    Hcc = torch.zeros_like(raw.Hcc).index_add_(
        0, b.cam, raw.Jc[:, :, None] * raw.Jc[:, None, :] * w[:, None, None])
    gp = torch.zeros_like(raw.gp).index_add_(
        0, b.pt, raw.Jp * (raw.r * w * lprob.point_mask[b.pt])[:, None])
    assert torch.allclose(n.Hcc, Hcc, rtol=1e-9, atol=0)
    assert torch.allclose(n.gp, gp, rtol=1e-9, atol=1e-12)
    assert not n.gp[lprob.point_mask == 0].any()
    c = float(lref.cost(lprob, q0, t0, X0))
    want = 0.5 * float(torch.sum(tba._robust_cost(raw.r * raw.r, "soft_l1",
                                                   1.0)))
    assert abs(c - want) < 1e-12 * want
