"""Port parity for the 4-view initializer: ``init/sfm2d.py`` and
``init/initializer.py`` against the reference package, in float64.

Given the reference's own random draws (its ``jax.random`` samples and
coordinate changes, recomputed from its keys), every 2D solver agrees to
1e-8, and the whole initializer (and its two LO-MSAC stages on their own)
returns the reference's poses to 1e-8 with equal inlier counts and
success.  With the port's own draws (``initializer.draw_init``), the three
scenes of ``tests/test_init.py`` meet that file's bars (1e-5, 1e-3, 0.05
up to gauge).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_init import gauge_align_errors, make_scene

from privacy_preserving_sfm_tpu.init import initializer as ji
from privacy_preserving_sfm_tpu.init import sfm2d as js
from privacy_preserving_sfm_tpu.solvers import ransac as jr
from privacy_preserving_sfm_torch.init import initializer as ti
from privacy_preserving_sfm_torch.init import sfm2d as ts
from privacy_preserving_sfm_torch.solvers import ransac as tr

torch.set_num_threads(2)

TOL = 1e-8


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


def close_inliers(points2d, ref):
    """2D points of tracks within the stage-1 threshold to 1e-8; the rest
    (outliers, some near infinity) to 1e-6 relative."""
    p, r = points2d.numpy(), np.asarray(ref.points2d)
    cams = np.asarray(ref.cams2d)
    z = np.einsum("vij,nj->vni", cams[:, :, :2], r) + cams[:, None, :, 2]
    near = np.all((z[..., 1] > 0) & (np.abs(r) < 1e3).all(-1), axis=0)
    assert near.sum() >= 60
    np.testing.assert_allclose(p[near], r[near], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(p, r, rtol=1e-6)


def t(a):
    return torch.from_numpy(np.array(a, np.float64))


def coord_change(key):
    """The (3, 2, 2) coordinate change ``factorize_trifocal`` draws."""
    return jnp.stack([jax.random.normal(k, (2, 2), jnp.float64)
                      for k in jax.random.split(key, 3)])


def reference_draws(key, aligned_valid, random_valid, num_samples):
    """The reference initializer's draws under ``key``, as InitDraws (S=1)."""
    k1, k2 = jax.random.split(key)
    k_s, k_f = jax.random.split(k1)
    idx = jr.draw_samples(k_s, aligned_valid.shape[0], aligned_valid, 5,
                          num_samples)
    A = jax.vmap(coord_change)(jax.random.split(k_f, num_samples))
    idx2 = jr.draw_samples(k2, random_valid.shape[0], random_valid, 3,
                           num_samples)
    return ti.InitDraws(*(torch.from_numpy(np.array(a))[None]
                          for a in (idx, A, idx2)))


def outlier_scene():
    """``tests/test_init.py::test_with_outliers``'s scene (10 % outliers)."""
    rng = np.random.default_rng(4)
    qs, ts_, pts, al, rl, grav = make_scene(rng, num_points=80)
    n_out = 8
    for i in range(4):
        out = rng.choice(80, n_out, replace=False)
        x_wrong = rng.uniform(-0.5, 0.5, (n_out, 3))
        x_wrong[:, 2] = 1.0
        ba = np.cross(np.broadcast_to(grav[i], (n_out, 3)), x_wrong)
        al[i, out] = ba / np.linalg.norm(ba[:, :2], axis=-1, keepdims=True)
        out_r = rng.choice(80, n_out, replace=False)
        br = np.cross(rng.standard_normal((n_out, 3)), x_wrong)
        rl[i, out_r] = br / np.linalg.norm(br[:, :2], axis=-1, keepdims=True)
    return qs, ts_, al, rl, grav


@pytest.fixture(scope="module")
def reference_run():
    """One reference initializer call on the outlier scene, and its draws."""
    qs, ts_, al, rl, grav = outlier_scene()
    key = jax.random.PRNGKey(1)
    valid = jnp.ones(80, bool)
    B = 256
    opts = ji.InitOptions(num_samples_fourview=B, num_samples_offset=B)
    res = ji.initialize_reconstruction(
        key, jnp.asarray(al), valid, jnp.asarray(rl), valid,
        jnp.asarray(grav), opts)
    draws = reference_draws(key, valid, valid, B)
    return dict(al=al, rl=rl, grav=grav, res=res, draws=draws,
                opts=ti.InitOptions(num_samples_fourview=B,
                                    num_samples_offset=B),
                max_error=opts.max_error)


def port_inputs(run):
    ones = torch.ones((1, 80), dtype=torch.bool)
    return (t(run["al"])[None], ones, t(run["rl"])[None], ones,
            t(run["grav"])[None], t([run["max_error"]]))


def test_initializer_matches_reference_on_its_draws(reference_run):
    run = reference_run
    res = ti.initialize_reconstruction(*port_inputs(run), run["draws"],
                                       run["opts"])
    ref = run["res"]
    assert bool(res.success[0]) == bool(ref.success) is True
    assert int(res.num_inliers[0]) == int(ref.num_inliers)
    close(res.inlier_ratio[0], ref.inlier_ratio)
    close(res.cams2d[0], ref.cams2d)
    close_inliers(res.points2d[0], ref)
    close(res.poses[0], ref.poses)


def test_stages_match_reference_on_its_draws(reference_run):
    """Each LO-MSAC stage alone, fed the reference's inputs."""
    run = reference_run
    ref = run["res"]
    al, _, rl, ones, grav, me = port_inputs(run)
    Rg = ti.gravity_rotations(grav)
    close(Rg[0], ji.gravity_rotations(jnp.asarray(run["grav"])))
    x_all = ti.aligned_lines_to_bearings(al, Rg[:, :, None])
    cams, X, _, num, _ = ti.estimate_fourview_2d(
        x_all, ones, me, run["draws"].fourview, run["draws"].coord_change)
    close(cams[0], ref.cams2d)
    close_inliers(X[0], ref)
    lifted = ti.lift_camera_2d(t(ref.cams2d)[None])
    close(lifted[0], ji.lift_camera_2d(ref.cams2d))
    poses, num_off, _ = ti.estimate_planar_offsets(
        lifted, Rg, rl, ones, me, run["draws"].offset)
    close(poses[0], ref.poses)
    assert int(num_off[0]) == int(ref.num_inliers)


def _cams_2d(rng, n_pts=8):
    """3-4 exact 2D views of points in front (bearing observations)."""
    thetas = rng.uniform(-0.5, 0.5, 4)
    thetas[0] = 0.0
    trans = rng.uniform(-1, 1, (4, 2))
    trans[0] = 0.0
    trans[1] /= np.linalg.norm(trans[1])
    X = rng.uniform(-2, 2, (n_pts, 2)) + np.array([0, 6.0])
    cams, xs = [], []
    for i in range(4):
        c, s = np.cos(thetas[i]), np.sin(thetas[i])
        Rm = np.array([[c, -s], [s, c]])
        cams.append(np.concatenate([Rm, trans[i][:, None]], axis=1))
        z = X @ Rm.T + trans[i]
        xs.append(z / np.linalg.norm(z, axis=-1, keepdims=True))
    return np.stack(cams), np.stack(xs), X


def test_sfm2d_solvers_match_reference():
    rng = np.random.default_rng(0)
    cams, x, X = _cams_2d(rng)
    x = x + rng.normal(0, 1e-3, x.shape)  # off the exact solutions
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    jx = [jnp.asarray(x[i]) for i in range(4)]
    T = js.trifocal_minimal(*jx[:3])
    close(ts.trifocal_minimal(*(t(x[i]) for i in range(3))), T)
    key = jax.random.PRNGKey(3)
    P_ref = js.factorize_trifocal(T, key)
    P = ts.factorize_trifocal(t(T), t(coord_change(key)))
    for a, b in zip(P, P_ref):
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            close(a, b)
    close(ts.metric_upgrade(t(P_ref[1]), t(P_ref[2])),
          js.metric_upgrade(P_ref[1], P_ref[2]))
    mask = np.array([True, True, False, True])
    x_v = np.moveaxis(x, 0, 1)  # (N, 4, 2)
    close(ts.triangulate2d(t(cams), t(x_v), torch.from_numpy(mask)),
          js.triangulate2d(jnp.asarray(cams), jnp.asarray(x_v),
                           jnp.asarray(mask)))
    pmask = np.ones(len(X), bool)
    pmask[2] = False
    close(ts.abs_pose_2d(t(x[3]), t(X), torch.from_numpy(pmask)),
          js.abs_pose_2d(jx[3], jnp.asarray(X), jnp.asarray(pmask)))
    close(ts.reproj_error_2d(t(cams), t(X), t(x_v)),
          js.reproj_error_2d(jnp.asarray(cams), jnp.asarray(X),
                             jnp.asarray(x_v)))
    close(ts.cosine_error_2d(t(cams[1]), t(X), t(x[1])),
          js.cosine_error_2d(jnp.asarray(cams[1]), jnp.asarray(X), jx[1]))
    ref = js.fourview_minimal_models(*(j[:5] for j in jx), key)
    got = ts.fourview_minimal_models(*(t(x[i][:5]) for i in range(4)),
                                     t(coord_change(key)))
    for a, b in zip(got[:2], ref[:2]):
        close(a, b)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_bundle_adjust_and_points_polish_match_reference():
    """``tests/test_init.py::test_bundle_adjust_2d_converges``'s problem:
    perturbed cameras and points, the 2D bundle, then the polish."""
    rng = np.random.default_rng(2)
    cams_gt, x, X = _cams_2d(rng, n_pts=30)
    cams0 = cams_gt.copy()
    for i in range(1, 4):
        th = np.arctan2(cams_gt[i, 1, 0], cams_gt[i, 0, 0])
        th += rng.normal(0, 0.01)
        cams0[i, :, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th),
                                                      np.cos(th)]]
        cams0[i, :, 2] += rng.normal(0, 0.01, 2)
    X0 = X + rng.normal(0, 0.02, X.shape)
    w = np.ones(30)
    w[4] = 0.0
    ref_c, ref_X = js.bundle_adjust_2d(jnp.asarray(cams0), jnp.asarray(x),
                                       jnp.asarray(X0), jnp.asarray(w))
    got_c, got_X = ts.bundle_adjust_2d(t(cams0), t(x), t(X0), t(w))
    close(got_c, ref_c)
    close(got_X, ref_X)
    np.testing.assert_allclose(got_c[1:].numpy(), cams_gt[1:], atol=1e-6)
    close(ts.optimize_points_2d(t(ref_c), t(x), t(X0)),
          js.optimize_points_2d(ref_c, jnp.asarray(x), jnp.asarray(X0)))


def test_draw_samples_are_distinct_valid_and_seeded():
    valid = torch.zeros((2, 40), dtype=torch.bool)
    valid[0, ::3] = True
    valid[1, :7] = True
    a = tr.draw_samples(torch.Generator().manual_seed(5), valid, 5, 3000)
    b = tr.draw_samples(torch.Generator().manual_seed(5), valid, 5, 3000)
    assert a.shape == (2, 3000, 5) and torch.equal(a, b)
    for s in range(2):
        rows = a[s].sort(dim=-1).values
        assert (rows[:, 1:] > rows[:, :-1]).all()  # distinct in a sample
        assert valid[s][a[s]].all()
        counts = torch.bincount(a[s].flatten(), minlength=40)[valid[s]]
        expect = 3000 * 5 / int(valid[s].sum())
        assert (counts - expect).abs().max() < 0.15 * expect  # uniform
    with pytest.raises(ValueError):
        tr.draw_samples(torch.Generator(), valid[:, :2], 5, 4)


def test_ransac_helpers_match_reference():
    """The scores and the selection of ``solvers/ransac.py`` (the first
    maximum on ties)."""
    rng = np.random.default_rng(6)
    res = rng.uniform(0, 2, (12, 9))
    res[3] = res[7]  # a tie
    valid = rng.uniform(size=9) < 0.8
    for a, b in zip(tr.inlier_score(t(res), 1.0, torch.from_numpy(valid)),
                    jr.inlier_score(jnp.asarray(res), 1.0,
                                    jnp.asarray(valid))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    got = tr.msac_score(t(res), 1.0, torch.from_numpy(valid))
    ref = jr.msac_score(jnp.asarray(res), 1.0, jnp.asarray(valid))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    best = tr.select_best(t(res), *got)
    ref_best = jr.select_best(jnp.asarray(res), *ref)
    assert int(best.best_index) == int(ref_best.best_index)
    np.testing.assert_array_equal(best.inlier_mask.numpy(),
                                  np.asarray(ref_best.inlier_mask))


def test_msac_score_lets_no_nan_hypothesis_win():
    """A hypothesis with non-finite residuals (float32 overflow in a
    minimal solve, as on the card in a 300-view block's init) scores as
    all outliers: the finite best is kept, where the reference's
    ``minimum`` makes the NaN score and its argmax picks it.  Finite
    hypotheses keep the reference's scores."""
    rng = np.random.default_rng(8)
    res = rng.uniform(0, 2, (6, 9))
    res[0] = np.nan
    res[4, 2] = np.inf
    valid = torch.ones(9, dtype=torch.bool)
    score, num, inl = tr.msac_score(t(res), 1.0, valid)
    assert torch.isfinite(score).all()
    assert float(score[0]) == -9.0 and int(num[0]) == 0
    ref = jr.msac_score(jnp.asarray(res), 1.0, jnp.ones(9, bool))
    np.testing.assert_allclose(score[1:].numpy(), np.asarray(ref[0])[1:],
                               rtol=1e-12)
    np.testing.assert_array_equal(num.numpy(), np.asarray(ref[1]))
    best = tr.select_best(t(res), score, num, inl)
    assert int(best.best_index) == int(np.argmax(np.asarray(ref[0])[1:])) + 1
    assert int(jr.select_best(jnp.asarray(res), *ref).best_index) == 0


def test_offset_stage_keeps_its_inliers_past_a_nan_hypothesis(
        reference_run, monkeypatch):
    """The offset stage of the outlier scene, with one minimal hypothesis
    made NaN: the set keeps the inliers it finds without it (before the
    NaN-safe score it found none, as blocks of Hier300 did on the card)."""
    run = reference_run
    ref = run["res"]
    _, _, rl, ones, grav, me = port_inputs(run)
    Rg = ti.gravity_rotations(grav)
    lifted = ti.lift_camera_2d(t(ref.cams2d)[None])
    idx = run["draws"].offset
    _, num, _ = ti.estimate_planar_offsets(lifted, Rg, rl, ones, me, idx)
    solve = ti.planar_offset_solve

    def one_nan(poses, Rg, lines_r, sample_mask):
        cams = solve(poses, Rg, lines_r, sample_mask)
        if cams.shape[1] == idx.shape[1]:  # the minimal hypotheses
            cams[0, 5] = float("nan")
        return cams

    monkeypatch.setattr(ti, "planar_offset_solve", one_nan)
    _, num_nan, _ = ti.estimate_planar_offsets(lifted, Rg, rl, ones, me,
                                               idx)
    assert int(num_nan[0]) == int(num[0]) == int(ref.num_inliers) > 0


@pytest.mark.parametrize("case", ["exact", "outliers", "gravity_noise"])
def test_port_draws_meet_reference_bars(case):
    """``tests/test_init.py``'s three scenes and bars, the port's draws
    from one fixed seed, as that file fixes one key.  (On the gravity-noise
    scene a draw misses the 0.05 bar about 3 times in 10, with the
    reference's draws as with the port's: 7 of 24 keys, 7 of 20 seeds.)"""
    if case == "exact":
        rng = np.random.default_rng(3)
        qs, ts_, _, al, rl, grav = make_scene(rng)
        B, me, bar = 256, 0.005, 1e-5
    elif case == "outliers":
        qs, ts_, al, rl, grav = outlier_scene()
        B, me, bar = 512, 0.005, 1e-3
    else:
        rng = np.random.default_rng(5)
        qs, ts_, _, al, rl, grav = make_scene(rng, num_points=80,
                                              gravity_noise_deg=1.0)
        B, me, bar = 512, 0.02, 0.05
    n = al.shape[1]
    ones = torch.ones((1, n), dtype=torch.bool)
    opts = ti.InitOptions(num_samples_fourview=B, num_samples_offset=B)
    draws = ti.draw_init(torch.Generator().manual_seed(2), ones, ones, opts)
    res = ti.initialize_reconstruction(
        t(al)[None], ones, t(rl)[None], ones, t(grav)[None], t([me]), draws,
        opts)
    assert bool(res.success[0])
    rot_err, t_err = gauge_align_errors(qs, ts_, res.poses[0].numpy())
    assert rot_err < bar and t_err < bar, (rot_err, t_err)
