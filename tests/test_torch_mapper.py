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
continued tracks.
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


def test_focal_search_is_not_ported(pair):
    jm, tm, ids = pair
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        tm.register_next_image(
            tmap.MapperOptions(abs_pose_refine_focal_length=True), ids[6])
