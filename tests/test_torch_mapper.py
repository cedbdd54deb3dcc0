"""The port's mapper steps against the reference package, float64 on the CPU.

One seeded model is held by both packages: a synthetic mapper database
(``utils.synthetic.synthetic_line_database``, 8 images, 400 points) loaded
by each package's ``DatabaseCache``, five images registered at perturbed
true poses with every projecting point triangulated at a perturbed true
position (features lost to the generator's drop carry random lines: the
outliers), a sixth registered with no points, two left to register.  On
it: the point and image filters delete the same things,
``find_next_images`` gives the same order, ``find_local_bundle`` the same
list, the local-BA assembly the same observations and dof and point masks
as the reference's (read from its ``PPSFM_BA_DUMP``, before padding), one
local BA on the SoA route agrees with the reference's
``bundle_adjust_soa`` to 1e-8, and ``register_next_image`` given the
reference's ``jax.random`` draws gives the same pose to 1e-8 and the same
continued tracks.  The uncalibrated path: a camera without a prior focal
searched at its first registration on the reference's draws (same
factors, inlier counts, winner and baked lines), ``_run_ba_intrinsics``
(same params, poses and lines to 1e-8), and after a bake the
triangulator and registration read the new lines and params.
"""

import copy
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.models import database as tdb
from privacy_preserving_sfm_torch.models import database_cache as tcache
from privacy_preserving_sfm_torch.ops import lie_np
from privacy_preserving_sfm_torch.optim import ba as tba
from privacy_preserving_sfm_torch.optim import ba_intrinsics as tbi
from privacy_preserving_sfm_torch.optim import ba_soa as tsoa
from privacy_preserving_sfm_torch.optim import convert
from privacy_preserving_sfm_torch.sfm import incremental_mapper as tmap
from privacy_preserving_sfm_torch.solvers import p6l as tp6l
from privacy_preserving_sfm_torch.utils.synthetic import (
    synthetic_line_database,
)
from privacy_preserving_sfm_tpu.models import database as jdb
from privacy_preserving_sfm_tpu.models import database_cache as jcache
from privacy_preserving_sfm_tpu.optim import ba as jba
from privacy_preserving_sfm_tpu.optim import ba_dense as jbd
from privacy_preserving_sfm_tpu.optim import ba_soa as jsoa
from privacy_preserving_sfm_tpu.sfm import incremental_mapper as jmap
from privacy_preserving_sfm_tpu.solvers import p6l as jp6l
from privacy_preserving_sfm_tpu.solvers import ransac as jransac

torch.set_num_threads(2)

MODEL = "SIMPLE_PINHOLE"
NUM_REG = 5  # registered with points; image NUM_REG is registered, empty


def populate(rec, qs, ts, pts, ids, rng):
    """Register and triangulate the model, the same numbers for either
    package's Reconstruction (their APIs agree)."""
    pose_noise = rng.normal(0, 0.0005, (NUM_REG, 7))
    point_noise = rng.normal(0, 0.003, pts.shape)
    for i in range(NUM_REG + 1):
        img = rec.images[ids[i]]
        if i < NUM_REG:
            q = qs[i] + pose_noise[i, :4]
            img.qvec = q / np.linalg.norm(q)
            img.tvec = ts[i] + pose_noise[i, 4:]
        else:
            img.qvec, img.tvec = qs[i].copy(), ts[i].copy()
        rec.register_image(ids[i])
    for j, X in enumerate(pts):
        track = []
        for i in range(NUM_REG):
            Xc = lie_np.quat_to_rotmat(qs[i]) @ X + ts[i]
            u, v = 500 * Xc[:2] / Xc[2] + (320, 240)
            if Xc[2] > 0.2 and 0 <= u < 640 and 0 <= v < 480:
                track.append((ids[i], j))
        if len(track) >= 2:
            rec.add_point3d(X + point_noise[j], track)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mapper") / "m.db")
    return path, synthetic_line_database(path, 8, 400, seed=3)


def models(scene):
    """The model in both packages, each on a cache of its own, with their
    mappers."""
    path, (qs, ts, pts, ids) = scene
    with jdb.Database(path) as db:
        jc = jcache.DatabaseCache.load(db, 15)
    with tdb.Database(path) as db:
        tc = tcache.DatabaseCache.load(db, 15)
    jrec, trec = jc.to_reconstruction(), tc.to_reconstruction()
    populate(jrec, qs, ts, pts, ids, np.random.default_rng(5))
    populate(trec, qs, ts, pts, ids, np.random.default_rng(5))
    jm = jmap.IncrementalMapper(jc)
    jm.begin_reconstruction(jrec)
    tm = tmap.IncrementalMapper("cpu", torch.float64, tc)
    tm.begin_reconstruction(trec)
    return jm, tm, ids


def points_of(rec):
    return {pid: (p.xyz.tolist(), sorted(p.track), p.error)
            for pid, p in rec.points3d.items()}


@pytest.fixture(scope="module")
def pair(scene):
    return models(scene)


def test_point_and_image_filters_delete_the_same(scene):
    jm, tm, ids = models(scene)
    jrec, trec = jm.rec, tm.rec
    before = len(trec.points3d)
    obs = [(iid, li) for p in trec.points3d.values() for iid, li in p.track]
    for iid, li in obs[:20]:
        np.testing.assert_allclose(
            trec._squared_line_reproj_error(
                trec.images[iid], li, trec.points3d[trec.images[iid]
                                                     .point3d_ids[li]].xyz),
            jrec._squared_line_reproj_error(
                jrec.images[iid], li, jrec.points3d[jrec.images[iid]
                                                     .point3d_ids[li]].xyz),
            rtol=1e-12)
    n = trec.filter_points3d(4.0, 1.5)
    assert n == jrec.filter_points3d(4.0, 1.5) and n > 0
    assert points_of(trec) == points_of(jrec)
    assert 0 < len(trec.points3d) < before
    # Small-angle filter alone, at a threshold that bites.
    ids_now = set(trec.points3d)
    n = trec.filter_points3d_small_tri_angle(10.0, ids_now)
    assert n == jrec.filter_points3d_small_tri_angle(10.0, ids_now)
    assert 0 < n < len(ids_now)
    assert points_of(trec) == points_of(jrec)
    filtered = trec.filter_images()
    assert filtered == jrec.filter_images() == [ids[NUM_REG]]
    assert trec.reg_image_ids == jrec.reg_image_ids


def test_mapper_filters_and_next_images_match(pair):
    jm, tm, ids = pair
    jopts, topts = jmap.MapperOptions(), tmap.MapperOptions()
    order = tm.find_next_images(topts)
    assert order == jm.find_next_images(jopts) and len(order) == 2
    # Fewer than 20 registered: filter_images keeps every image.
    assert tm.filter_images(topts) == jm.filter_images(jopts) == 0
    assert tm.filter_points(topts) == jm.filter_points(jopts)
    assert points_of(tm.rec) == points_of(jm.rec)
    assert tm.phase_times["filter"] > 0


@pytest.mark.parametrize("num_images", [3, 6])
def test_find_local_bundle_matches(pair, num_images):
    jm, tm, ids = pair
    for iid in ids[:NUM_REG]:
        got = tm.find_local_bundle(
            tmap.MapperOptions(local_ba_num_images=num_images), iid)
        assert got == jm.find_local_bundle(
            jmap.MapperOptions(local_ba_num_images=num_images), iid)
        assert len(got) == min(num_images - 1, NUM_REG - 1)


def local_config(mapper, options, ids):
    """A local BA around ``ids[0]``: its 3-image bundle, the gauge, and
    two thirds of its points variable."""
    bundle = mapper.find_local_bundle(options(local_ba_num_images=3), ids[0])
    config = [ids[0]] + bundle
    variable = {int(p) for p in mapper.rec.images[ids[0]].point3d_ids
                if p >= 0 and p % 3 != 0}
    return config, {bundle[-1]}, {bundle[-2]}, variable


def test_local_ba_assembly_matches_the_reference(scene, monkeypatch,
                                                 tmp_path):
    jm, tm, ids = models(scene)
    config, const_pose, const_tvec_x, variable = local_config(
        tm, tmap.MapperOptions, ids)
    assert local_config(jm, jmap.MapperOptions, ids) == (
        config, const_pose, const_tvec_x, variable)
    asm = tm.assemble_ba(config, const_pose, const_tvec_x, variable)
    monkeypatch.setenv("PPSFM_BA_DUMP", str(tmp_path / "dump"))
    jm._run_ba(config, const_pose, const_tvec_x, variable,
               jba.BAOptions(max_iterations=1))
    d = np.load(glob.glob(str(tmp_path / "dump*.npz"))[0])
    C, P, O = len(asm.cam_list), len(asm.point_index), len(asm.obs)
    w = d["obs_weight"] > 0
    assert int(w.sum()) == O and w[:O].all()
    p = asm.problem
    np.testing.assert_array_equal(p.obs_cam.numpy(), d["obs_cam"][:O])
    np.testing.assert_array_equal(p.obs_point.numpy(), d["obs_point"][:O])
    np.testing.assert_array_equal(p.obs_line.numpy(), d["obs_line"][:O])
    np.testing.assert_array_equal(asm.dof_mask, d["dof_mask"][:C])
    assert not d["dof_mask"][C:].any()
    np.testing.assert_array_equal(asm.point_mask, d["point_mask"][:P])
    assert not d["point_mask"][P:].any()
    np.testing.assert_array_equal(p.qvecs.numpy(), d["qvecs"][:C])
    np.testing.assert_array_equal(p.points3d.numpy(), d["points3d"][:P])
    # Frozen extra cameras (images outside the bundle that observe the
    # variable points) and frozen points are both present.
    assert C > len(config) and not asm.dof_mask[len(config):].any()
    assert 0 < asm.point_mask.sum() < P


def test_one_local_ba_matches_the_reference_soa_solver(scene):
    jm, tm, ids = models(scene)
    tm.rec.filter_points3d(4.0, 1.5)  # as the mapper does before a BA
    config, const_pose, const_tvec_x, variable = local_config(
        tm, tmap.MapperOptions, ids)
    asm = tm.assemble_ba(config, const_pose, const_tvec_x, variable)
    fields = {k: v.numpy() for k, v in asm.problem._asdict().items()}
    opts = tba.BAOptions(max_iterations=50, loss="soft_l1",
                         function_tolerance=0.0, gradient_tolerance=1.0)
    jopts = jba.BAOptions(max_iterations=50, loss="soft_l1",
                          function_tolerance=0.0, gradient_tolerance=1.0,
                          gram_mode="xla")
    jdense = jbd.from_flat_problem(
        jba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()}),
        k_bucket=4)
    jq, jt, jX, js = jax.jit(
        lambda pr: jsoa.bundle_adjust_soa(pr, MODEL, jopts))(jdense)
    tdense = convert.dense_problem_from_numpy(
        {k: np.asarray(v) for k, v in jdense._asdict().items()}, "cpu",
        torch.float64)
    q, t, X, s = tsoa.bundle_adjust_soa(tdense, MODEL, opts)
    assert s.num_iterations == int(js.num_iterations) > 1
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=1e-8)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=1e-8)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-8)
    # Frozen cameras and points did not move.
    frozen_c = ~asm.dof_mask.any(1)
    np.testing.assert_array_equal(q.numpy()[frozen_c],
                                  fields["qvecs"][frozen_c])
    P = len(asm.point_index)
    frozen_p = np.nonzero(asm.point_mask == 0)[0]
    np.testing.assert_array_equal(X.numpy()[:P][frozen_p],
                                  fields["points3d"][frozen_p])


def test_run_ba_writes_back_only_free_cameras_and_variable_points(
        scene, monkeypatch):
    jm, tm, ids = models(scene)
    config, const_pose, const_tvec_x, variable = local_config(
        tm, tmap.MapperOptions, ids)
    solve = tba.bundle_adjust

    def shifted(problem, model, options):  # every output moved by 1
        q, t, X, s = solve(problem, model, options)
        return q + 1.0, t + 1.0, X + 1.0, s

    monkeypatch.setattr(tba, "bundle_adjust", shifted)
    before = copy.deepcopy(tm.rec)
    ok, num_obs = tm._run_ba(config, const_pose, const_tvec_x, variable,
                             tba.BAOptions(max_iterations=2))
    assert ok and num_obs > 0 and tm.last_route.solver == "flat"
    moved_cams = {iid for iid, img in tm.rec.images.items()
                  if not np.array_equal(img.tvec, before.images[iid].tvec)}
    assert moved_cams == set(config) - const_pose
    moved_pts = {pid for pid, pt in tm.rec.points3d.items()
                 if not np.array_equal(pt.xyz, before.points3d[pid].xyz)}
    assert moved_pts == variable


def reference_draws(monkeypatch):
    """Make the port's registration draw what the reference draws: the
    batch seed taken from the mapper's ``_rng`` keys ``jax.random``."""
    def estimate(gen, lines, aligned, points, thresh, nh):
        key = jax.random.PRNGKey(gen.initial_seed())
        k_sample, k_solve = jax.random.split(key)
        n = lines.shape[0]
        n_pad = jmap._bucket(n, 256, growth=4)
        valid = np.zeros(n_pad, bool)
        valid[:n] = True
        idx = jransac.draw_samples(k_sample, n_pad, jnp.asarray(valid), 6, nh)
        amix = jax.random.normal(k_solve, (3, 3), jnp.float64)
        return tp6l.estimate_absolute_pose_from_lines_with_draws(
            lines, aligned, points, thresh,
            torch.from_numpy(np.asarray(idx).astype(np.int64)),
            torch.from_numpy(np.array(amix)))

    monkeypatch.setattr(tp6l, "estimate_absolute_pose_from_lines", estimate)


def test_register_next_image_matches_with_the_reference_draws(scene,
                                                              monkeypatch):
    jm, tm, ids = models(scene)
    reference_draws(monkeypatch)
    jopts = jmap.MapperOptions(num_hypotheses=256)
    topts = tmap.MapperOptions(num_hypotheses=256)
    for mapper in (jm, tm):
        mapper.rec.filter_points3d(4.0, 1.5)
    image_id = tm.find_next_images(topts)[0]
    assert jm.register_next_image(jopts, image_id)
    assert tm.register_next_image(topts, image_id)
    jimg, timg = jm.rec.images[image_id], tm.rec.images[image_id]
    np.testing.assert_allclose(timg.qvec, jimg.qvec, rtol=0, atol=1e-8)
    np.testing.assert_allclose(timg.tvec, jimg.tvec, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(timg.point3d_ids, jimg.point3d_ids)
    assert (timg.point3d_ids >= 0).sum() >= 30
    assert points_of(tm.rec).keys() == points_of(jm.rec).keys()
    assert all(sorted(tm.rec.points3d[p].track)
               == sorted(jm.rec.points3d[p].track) for p in tm.rec.points3d)
    assert tm.triangulator.modified_point3d_ids == \
        jm.triangulator.modified_point3d_ids
    assert tm.num_reg_trials == jm.num_reg_trials == {image_id: 1}
    assert tm.phase_times["register"] > 0


def mislift(mapper, image_ids, camera_id, focal, prior):
    """Give ``image_ids`` the camera ``camera_id`` at ``focal`` (prior
    focal flag ``prior``) with their lines as a lift at that focal gives
    them: moved from the true f = 500's normalized plane by
    ``correct_lines``.  The same numbers in either package."""
    rec = mapper.rec
    old = rec.cameras[rec.images[image_ids[0]].camera_id]
    true = np.array([500.0, 320.0, 240.0])
    lifted = np.array([focal, 320.0, 240.0])
    rec.add_camera(type(old)(camera_id=camera_id, model=old.model,
                             width=old.width, height=old.height,
                             params=lifted.copy(), prior_focal_length=prior))
    for iid in image_ids:
        img = rec.images[iid]
        img.camera_id = camera_id
        img.lines = tbi.correct_lines(img.lines, true, lifted, MODEL)


def reference_candidate_draws(monkeypatch, record):
    """The port's focal search on the reference's draws (one batch under
    the key its seed makes, as ``reference_draws``), its result kept in
    ``record``."""
    def estimate(gen, lines, aligned, points, thresh, nh):
        key = jax.random.PRNGKey(gen.initial_seed())
        k_sample, k_solve = jax.random.split(key)
        n = lines.shape[1]
        n_pad = jmap._bucket(n, 256, growth=4)
        valid = np.zeros(n_pad, bool)
        valid[:n] = True
        idx = jransac.draw_samples(k_sample, n_pad, jnp.asarray(valid), 6, nh)
        amix = jax.random.normal(k_solve, (3, 3), jnp.float64)
        out = tp6l.estimate_pose_candidates_with_draws(
            lines, aligned, points, thresh,
            torch.from_numpy(np.asarray(idx).astype(np.int64)),
            torch.from_numpy(np.array(amix)))
        record.update(thresh=thresh.numpy(), result=out)
        return out

    monkeypatch.setattr(tp6l, "estimate_pose_candidates", estimate)


def record_reference_focal_kernel(jm, n, options, record):
    """Put in the reference mapper's kernel cache, under the key its
    ``_focal_search`` looks up, its own vmapped estimator (the same code)
    with its outputs kept in ``record``."""
    S = options.num_focal_length_samples
    nh = max(256, options.num_hypotheses // 4)

    def run(k, ls, al, p, v, th):
        return jax.vmap(lambda line, t: jp6l.estimate_absolute_pose_from_lines(
            k, line, al, p, v, t, num_hypotheses=nh))(ls, th)

    kernel = jax.jit(run)

    def keep(*args):
        out = kernel(*args)
        record.update(thresh=np.asarray(args[5]), result=out)
        return out

    jm._jit_pose[("focal", S, jmap._bucket(n, 256, growth=4), nh)] = keep


def test_focal_search_matches_with_the_reference_draws(scene, monkeypatch):
    """The two unregistered images on a camera of their own, no prior
    focal and lines lifted at f = 560 (true 500); the first registered
    with ``abs_pose_refine_focal_length`` by both packages on the
    reference's draws: the focal search runs with the same factors
    (thresholds), gives the same inlier count for every candidate and the
    same winner, bakes the same params and the same lines into both
    images, and the registration that follows gives the same pose."""
    jm, tm, ids = models(scene)
    reference_draws(monkeypatch)
    got, want = {}, {}
    reference_candidate_draws(monkeypatch, got)
    for mapper in (jm, tm):
        mapper.rec.filter_points3d(4.0, 1.5)
        mislift(mapper, [ids[6], ids[7]], 99, 560.0, prior=False)
    jopts = jmap.MapperOptions(num_hypotheses=256,
                               abs_pose_refine_focal_length=True)
    topts = tmap.MapperOptions(num_hypotheses=256,
                               abs_pose_refine_focal_length=True)
    corrs = tm.correspondences_2d3d(topts, ids[6])
    record_reference_focal_kernel(jm, len(corrs), jopts, want)
    assert jm.register_next_image(jopts, ids[6])
    assert tm.register_next_image(topts, ids[6])
    np.testing.assert_allclose(got["thresh"], want["thresh"], rtol=1e-12)
    assert len(got["thresh"]) == topts.num_focal_length_samples
    jr, tr = want["result"], got["result"]
    inl = np.where(tr.success.numpy(), tr.num_inliers.numpy(), -1)
    np.testing.assert_array_equal(
        inl, np.where(np.asarray(jr.success), np.asarray(jr.num_inliers), -1))
    best = int(np.argmax(inl))
    assert inl[best] >= topts.abs_pose_min_num_inliers
    jcam, tcam = jm.rec.cameras[99], tm.rec.cameras[99]
    np.testing.assert_allclose(tcam.params, jcam.params, rtol=1e-14)
    assert tm.focal_searches == [(ids[6], 560.0, tcam.params[0],
                                  int(inl[best]))]
    assert tcam.params[0] != 560.0 and tcam.params[1:].tolist() == [320, 240]
    for iid in ids[6:8]:  # every image of the camera is baked
        np.testing.assert_allclose(tm.rec.images[iid].lines,
                                   jm.rec.images[iid].lines, rtol=0,
                                   atol=1e-10)
    jimg, timg = jm.rec.images[ids[6]], tm.rec.images[ids[6]]
    np.testing.assert_allclose(timg.qvec, jimg.qvec, rtol=0, atol=1e-8)
    np.testing.assert_allclose(timg.tvec, jimg.tvec, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(timg.point3d_ids, jimg.point3d_ids)
    # A camera with a registered image is not searched again.
    got.clear()
    tm.register_next_image(topts, ids[7])
    assert "thresh" not in got and len(tm.focal_searches) == 1


def intrinsics_config(mapper, ids):
    """The shared camera mis-set to f = 520 with every line lifted there,
    and a local BA around ``ids[0]`` (``local_config``)."""
    mapper.rec.filter_points3d(4.0, 1.5)
    mislift(mapper, list(mapper.rec.images), 98, 520.0, prior=False)
    return local_config(mapper, tmap.MapperOptions, ids)


BA_INTR = dict(max_iterations=50, loss="soft_l1", function_tolerance=0.0,
               gradient_tolerance=1.0, refine_focal_length=True)


def test_run_ba_intrinsics_matches_the_reference(scene):
    jm, tm, ids = models(scene)
    config = intrinsics_config(tm, ids)
    assert intrinsics_config(jm, ids) == config
    lines_before = {iid: img.lines.copy()
                    for iid, img in tm.rec.images.items()}
    ok, num_obs = tm._run_ba(*config, tba.BAOptions(**BA_INTR))
    assert jm._run_ba(*config, jba.BAOptions(**BA_INTR)) == (True, num_obs)
    assert ok and tm.last_route == tmap.BARoute("intrinsics", False)
    assert tm.last_summary.num_iterations > 1
    jcam, tcam = jm.rec.cameras[98], tm.rec.cameras[98]
    np.testing.assert_allclose(tcam.params, jcam.params, rtol=1e-11)
    assert abs(tcam.params[0] - 520.0) > 1.0  # the focal moved
    assert tcam.params[1:].tolist() == [320.0, 240.0]
    for iid, timg in tm.rec.images.items():
        jimg = jm.rec.images[iid]
        np.testing.assert_allclose(timg.qvec, jimg.qvec, rtol=0, atol=1e-8)
        np.testing.assert_allclose(timg.tvec, jimg.tvec, rtol=0, atol=1e-8)
        np.testing.assert_allclose(timg.lines, jimg.lines, rtol=0,
                                   atol=1e-8)
        # Every image of the camera was baked, registered or not.
        assert not np.allclose(timg.lines, lines_before[iid])
    for pid, pt in tm.rec.points3d.items():
        np.testing.assert_allclose(pt.xyz, jm.rec.points3d[pid].xyz,
                                   rtol=0, atol=1e-8)


def test_triangulator_and_registration_read_baked_lines(scene, monkeypatch):
    """After a bake, the triangulator's line and param tables (built
    before it) and the next registration's lines and threshold are the new
    ones."""
    _, tm, ids = models(scene)
    config = intrinsics_config(tm, ids)
    tm.triangulator._flat_tables()  # cached before the bake
    assert tm._run_ba(*config, tba.BAOptions(**BA_INTR))[0]
    cam = tm.rec.cameras[98]
    view = tm.cache.view
    lines, _, _, params = tm.triangulator._flat_tables()
    np.testing.assert_array_equal(lines, np.concatenate(
        [tm.rec.images[iid].lines for iid in view.image_ids]))
    reg = [d for d, iid in enumerate(view.image_ids)
           if tm.rec.images[iid].registered]
    np.testing.assert_array_equal(params[reg], np.tile(cam.params,
                                                       (len(reg), 1)))
    seen = {}
    solve = tp6l.estimate_absolute_pose_from_lines

    def spy(gen, lines, aligned, points, thresh, nh):
        seen.setdefault("lines", lines.numpy().copy())
        seen.setdefault("thresh", thresh)
        return solve(gen, lines, aligned, points, thresh, nh)

    monkeypatch.setattr(tp6l, "estimate_absolute_pose_from_lines", spy)
    options = tmap.MapperOptions(num_hypotheses=256)
    image_id = tm.find_next_images(options)[0]
    corrs = tm.correspondences_2d3d(options, image_id)
    tm.register_next_image(options, image_id)
    np.testing.assert_array_equal(
        seen["lines"], tm.rec.images[image_id].lines[corrs[:, 0]])
    assert seen["thresh"] == options.abs_pose_max_error / cam.params[0]
