"""The plain references agree with the port's plain paths at tiny sizes on
the CPU (float64 for the bundle adjustment, exact for SIFT, the lift and
the matcher)."""

import numpy as np
import pytest
import torch

from benchmark.core.base import frame_seed
from benchmark.gen import ba_scene, box_frames
from benchmark.reference import ba as ref
from benchmark.reference import frontend as ref_fe
from benchmark.reference import sift as ref_sift

CPU = torch.device("cpu")
BA = dict(num_cameras=10, num_points=300, obs_per_point=5, meas_noise=2e-4)


def _problem(scene, dtype=torch.float64):
    C, P = scene.qvecs.shape[0], scene.points.shape[0]
    return ref.to_problem(scene.obs_cam, scene.obs_pt, scene.lines,
                          ba_scene.PARAMS, ba_scene.gauge_mask(C, CPU), C, P,
                          dtype)


def test_jacobians_against_autodiff():
    s = ba_scene.make_scene(BA, 1, CPU)
    prob = _problem(s)
    q, t, X = ba_scene.perturbed_start(s, 2)
    n = ref.normal_equations(prob, q, t, X)
    f = ba_scene.PARAMS[0]
    o = torch.arange(0, prob.cam.shape[0], 97)

    def resid(dc, dX, k):
        c, p = prob.cam[k], prob.pt[k]
        qq, tt, XX = ref.apply_step(q[c:c + 1], t[c:c + 1], X[p:p + 1],
                                    -dc[None], -dX[None])
        sub = prob._replace(cam=torch.zeros(1, dtype=torch.long),
                            pt=torch.zeros(1, dtype=torch.long),
                            lines=prob.lines[k:k + 1])
        return f * ref.line_distances(sub, qq, tt, XX)[0]

    for k in o.tolist():
        Jc, Jp = torch.func.jacfwd(resid, argnums=(0, 1))(
            torch.zeros(6, dtype=torch.float64),
            torch.zeros(3, dtype=torch.float64), k)
        mask = prob.dof_mask[prob.cam[k]]
        assert torch.allclose(n.Jc[k], Jc * mask, atol=1e-8, rtol=1e-6)
        assert torch.allclose(n.Jp[k], Jp, atol=1e-8, rtol=1e-6)


def test_ba_against_the_ports_plain_solver_float64():
    from privacy_preserving_sfm_torch.optim import ba as ba_mod
    from privacy_preserving_sfm_torch.optim import ba_dense, ba_soa

    s = ba_scene.make_scene(BA, 3, CPU)
    prob = _problem(s)
    q0, t0, X0 = ba_scene.perturbed_start(s, 4)
    C, P, O = 10, 300, s.obs_cam.shape[0]
    problem = ba_mod.BAProblem(
        qvecs=q0, tvecs=t0,
        cam_params=torch.tensor(ba_scene.PARAMS, dtype=torch.float64)
        .expand(C, 3), points3d=X0, obs_cam=s.obs_cam, obs_point=s.obs_pt,
        obs_line=s.lines, obs_weight=torch.ones(O, dtype=torch.float64),
        cam_dof_mask=prob.dof_mask, point_mask=torch.ones(
            P, dtype=torch.float64))
    q, t, X, summary = ba_soa.bundle_adjust_soa(
        ba_dense.from_flat_problem(problem), "SIMPLE_PINHOLE",
        ba_mod.BAOptions(max_iterations=100, cg_iterations=200))
    sol = ref.solve(prob, q0, t0, X0)
    c = float(ref.cost(prob, q, t, X))
    assert c == pytest.approx(sol.cost, rel=1e-7)
    assert summary.initial_cost == pytest.approx(
        float(ref.cost(prob, q0, t0, X0)), rel=1e-12)


def test_reduced_system_against_the_ports_plain_gram():
    from privacy_preserving_sfm_torch.optim import schur_pcg

    s = ba_scene.make_scene(BA, 5, CPU)
    prob = _problem(s)
    q, t, X = ba_scene.perturbed_start(s, 6)
    n = ref.normal_equations(prob, q, t, X)
    Hinv = ref.damped_point_inverse(n.Hpp, 1e-4)
    S, rhs = ref.reduced_correction(prob, n, Hinv)
    # The port's plain Gram on V = L^T Hcp blocks of the same system.
    C, P, K = 10, 300, 5
    L = torch.linalg.cholesky(Hinv)  # (P, 3, 3), L L^T = Hinv
    order = torch.argsort(prob.pt * C + prob.cam)
    hcp = (n.Jc[:, :, None] * n.Jp[:, None, :])[order].reshape(P, K, 6, 3)
    cams = prob.cam[order].reshape(P, K)
    lh = torch.einsum("pba,pkib->pkai", L, hcp)  # (P, K, 3, 6)
    gL = torch.einsum("pba,pb->pa", L, n.gp)
    S_p, rhs_p = schur_pcg.gram_aos_plain(lh, gL, cams, C)
    assert torch.allclose(S_p, S, rtol=1e-9, atol=1e-9 * float(S.abs().max()))
    assert torch.allclose(rhs_p, rhs, rtol=1e-9,
                          atol=1e-9 * float(rhs.abs().max()))



@pytest.mark.parametrize("workload", ["collection1000.global_ba",
                                      "sequence300.global_ba"])
def test_program_first_iteration_against_the_reference(workload):
    """The check's Gram and PCG inputs in the (K, P) slot layout: the
    program's public Gram and PCG on them agree with the float64
    reference (the Gram's float32 rounding alone), and its bfloat16 Gram
    reads far above that."""
    from benchmark.core import spec as spec_mod
    from benchmark.tests.tiny import tiny_cell

    cell = tiny_cell(workload)
    loop = spec_mod.loop_class(cell.mix["kind"])(
        cell.config, cell.mix, 2 ** 34 + 9, CPU)
    s0 = loop._start_seed(0)
    q, t, X = (a.double().numpy() for a in loop.start(loop.main, s0))
    got = {p: loop.judge(loop.main, s0,
                         loop.first_iteration(loop.main, s0, p), q, t, X)
           for p in ("f32", "bf16")}
    assert got["f32"]["gram_rel_err"] < 1e-6, got
    assert got["f32"]["pcg_shortfall"] < 1e-8, got
    assert got["bf16"]["gram_rel_err"] > 1e-4, got

FR = dict(num_frames=4, width=128, height=96, f=80.0, box_texture=64,
          camera_model="SIMPLE_PINHOLE")


def test_sift_and_lift_match_the_port():
    from privacy_preserving_sfm_torch.features import extraction, sift

    fr = box_frames.make_frames(FR, 9, CPU)
    opts = sift.SiftOptions(max_num_features=256)
    seeds = [frame_seed(123, i) for i in range(4)]
    got = extraction.extract_and_lift_batch(
        fr.images, "SIMPLE_PINHOLE", fr.params, fr.gravity,
        [torch.Generator().manual_seed(s) for s in seeds], opts)
    levels = torch.arange(256, dtype=torch.float32) / 255.0
    feats = ref_sift.extract_sift(levels[fr.images.long()],
                                  ref_sift.SiftOptions(max_num_features=256))
    assert torch.equal(feats.valid, got.valid)
    assert torch.equal(feats.descriptors, got.descriptors)
    lines, aligned = ref_fe.lift(feats.keypoints, feats.valid, fr.params,
                                 fr.gravity, seeds)
    assert torch.equal(aligned, got.aligned)
    v = got.valid
    assert torch.allclose(lines[v], got.lines[v], atol=1e-6)


def test_matcher_matches_the_port():
    from privacy_preserving_sfm_torch.features import matching

    rng = np.random.default_rng(0)
    hist = rng.dirichlet(np.full(128, 0.2), (5, 200))
    hist[1, :100] = 0.8 * hist[0, :100] + 0.2 * hist[1, :100]  # matches
    hist[2, :50] = 0.8 * hist[1, 50:100] + 0.2 * hist[2, :50]
    desc = torch.as_tensor(np.clip(np.round(512 * np.sqrt(hist)), 0, 255)
                           .astype(np.uint8))
    valid = torch.as_tensor(rng.random((5, 200)) < 0.9)
    pairs = torch.tensor([[0, 1], [1, 2], [0, 2], [3, 4]])
    got = matching.match_many_pairs(desc, valid, pairs, plain=True).matches
    want = ref_fe.match(desc[pairs[:, 0]], desc[pairs[:, 1]],
                        valid[pairs[:, 0]], valid[pairs[:, 1]])
    assert torch.equal(got.long(), want)
    assert (want >= 0).sum() > 100
