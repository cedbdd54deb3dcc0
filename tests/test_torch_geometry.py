"""Port parity for the init slice's geometry: ``ops/linalg``, ``ops/lie``,
``ops/lines`` and ``ops/lines_np``, the camera threshold and the model's
merge and deregistration, and ``ops/triangulation``.

The same seeded numpy inputs go through the reference function (float64,
``tests/conftest.py`` enables x64) and the port's on the CPU in float64;
they agree to 1e-10 relative (Gram null vectors up to sign).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from privacy_preserving_sfm_tpu.models import reconstruction as jrec
from privacy_preserving_sfm_tpu.ops import cameras as jcam
from privacy_preserving_sfm_tpu.ops import lie as jlie
from privacy_preserving_sfm_tpu.ops import linalg as jla
from privacy_preserving_sfm_tpu.ops import lines as jlines
from privacy_preserving_sfm_tpu.ops import lines_np as jlnp
from privacy_preserving_sfm_tpu.ops import triangulation as jtri
from privacy_preserving_sfm_torch.models import reconstruction as trec
from privacy_preserving_sfm_torch.ops import cameras as tcam
from privacy_preserving_sfm_torch.ops import lie as tlie
from privacy_preserving_sfm_torch.ops import linalg as tla
from privacy_preserving_sfm_torch.ops import lines as tlines
from privacy_preserving_sfm_torch.ops import lines_np as tlnp
from privacy_preserving_sfm_torch.ops import triangulation as ttri

torch.set_num_threads(2)

RTOL, ATOL = 1e-10, 1e-12


def close(port, ref, rtol=RTOL, atol=ATOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


def up_to_sign(port, ref):
    """Unit vectors (..., n) equal up to a per-vector sign."""
    port, ref = port.numpy(), np.asarray(ref)
    sign = np.where(np.sum(port * ref, axis=-1, keepdims=True) < 0, -1, 1)
    close(port * sign, ref)


def t(a):
    return torch.from_numpy(np.array(a, np.float64))


def spd(rng, batch, n):
    A = rng.standard_normal(batch + (n + 3, n))
    return np.einsum("...ki,...kj->...ij", A, A)


def random_quats(rng, n):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def scene(rng, n_views=6, n_pts=16):
    """Cameras around points in front of them, lines through projections."""
    q = random_quats(rng, n_views) * np.array([1, 0.1, 0.1, 0.1])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tv = rng.uniform(-1, 1, (n_views, 3))
    proj = np.asarray(jlie.pose_compose(jnp.asarray(q), jnp.asarray(tv)))
    X = rng.uniform(-1, 1, (n_pts, 3)) + np.array([0, 0, 6.0])
    xyz = np.einsum("vij,pj->pvi", proj[:, :, :3], X) + proj[:, :, 3]
    hom = xyz / xyz[..., 2:3]
    lines = np.cross(rng.standard_normal((n_pts, n_views, 3)), hom)
    lines /= np.linalg.norm(lines[..., :2], axis=-1, keepdims=True)
    return q, tv, proj, X, lines


# -- ops/linalg -------------------------------------------------------------


def test_det2_solve2_solve_spd():
    rng = np.random.default_rng(0)
    A2 = spd(rng, (7,), 2)
    A3 = spd(rng, (7,), 3)
    b2 = rng.standard_normal((7, 2))
    b3 = rng.standard_normal((7, 3))
    close(tla.det2(t(A2)), jla.det2(jnp.asarray(A2)))
    close(tla.solve2(t(A2), t(b2)), jla.solve2(jnp.asarray(A2),
                                                jnp.asarray(b2)))
    for A, b in ((A2, b2), (A3, b3)):
        close(tla.solve_spd(t(A), t(b), damping=0.3),
              jla.solve_spd(jnp.asarray(A), jnp.asarray(b), damping=0.3))
    with pytest.raises(ValueError):
        tla.solve_spd(t(spd(rng, (), 4)), t(np.ones(4)))


@pytest.mark.parametrize("n", [2, 4, 6])
def test_symmetric_eig_smallest(n):
    """The sweeps are the reference's, so the eigenvector comes out with
    the reference's sign, not only up to it."""
    rng = np.random.default_rng(n)
    G = spd(rng, (9,), n)
    close(tla.symmetric_eig_smallest(t(G)),
          jla.symmetric_eig_smallest(jnp.asarray(G)))


def test_symmetric_eig_smallest_repeated_eigenvalue():
    """A double smallest eigenvalue: any unit vector of its eigenspace is
    right; the port returns one, as the reference does."""
    rng = np.random.default_rng(1)
    Q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    G = Q @ np.diag([0.5, 0.5, 1.0, 2.0, 3.0, 4.0]) @ Q.T
    v = tla.symmetric_eig_smallest(t(G)).numpy()
    w = np.asarray(jla.symmetric_eig_smallest(jnp.asarray(G)))
    for u in (v, w):
        np.testing.assert_allclose(G @ u, 0.5 * u, atol=1e-10)


@pytest.mark.parametrize("shape", [(5, 6), (7, 6), (3, 2)])
def test_gram_null_vector(shape):
    rng = np.random.default_rng(sum(shape))
    A = rng.standard_normal((4,) + shape)
    up_to_sign(tla.gram_null_vector(t(A)),
               jla.gram_null_vector(jnp.asarray(A)))


@pytest.mark.parametrize("n", [3, 8])
def test_solve_gauss(n):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((5, n, n))
    A[0, :, 0] = 0.0  # a zero first column: the pivot clamp
    b = rng.standard_normal((5, n))
    close(tla.solve_gauss(t(A), t(b)),
          jla.solve_gauss(jnp.asarray(A), jnp.asarray(b)), rtol=1e-9)


def test_lstsq_normal3():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((6, 10, 3))
    b = rng.standard_normal((6, 10))
    for reg, refine in ((1e-12, 1), (1e-8, 2)):
        close(tla.lstsq_normal3(t(A), t(b), reg, refine),
              jla.lstsq_normal3(jnp.asarray(A), jnp.asarray(b), reg, refine))


# -- ops/lie ----------------------------------------------------------------


def test_quaternion_functions():
    rng = np.random.default_rng(3)
    q1, q2 = random_quats(rng, 8), random_quats(rng, 8)
    v = rng.standard_normal((8, 3))
    J = {k: jnp.asarray(a) for k, a in (("q1", q1), ("q2", q2), ("v", v))}
    close(tlie.quat_to_rotmat(t(q1)), jlie.quat_to_rotmat(J["q1"]))
    close(tlie.quat_multiply(t(q1), t(q2)),
          jlie.quat_multiply(J["q1"], J["q2"]))
    close(tlie.quat_rotate(t(q1), t(v)), jlie.quat_rotate(J["q1"], J["v"]))
    R = np.asarray(jlie.quat_to_rotmat(J["q1"]))
    # Every Shepperd branch: rotations by pi about each axis.
    R = np.concatenate([R, np.stack([np.diag(d) for d in (
        [1, -1, -1], [-1, 1, -1], [-1, -1, 1])])])
    close(tlie.rotmat_to_quat(t(R)), jlie.rotmat_to_quat(jnp.asarray(R)))


def test_quat_from_two_vectors():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((6, 3))
    b = rng.standard_normal((6, 3))
    b[0] = -a[0]  # antiparallel
    a[1], b[1] = [1.0, 0, 0], [-1.0, 0, 0]  # antiparallel along x
    close(tlie.quat_from_two_vectors(t(a), t(b)),
          jlie.quat_from_two_vectors(jnp.asarray(a), jnp.asarray(b)))


# -- ops/lines, ops/lines_np, the camera threshold ------------------------


@pytest.mark.parametrize("model,params", [
    ("SIMPLE_PINHOLE", [500.0, 320.0, 240.0]),
    ("OPENCV", [480.0, 510.0, 320.0, 240.0, 0.05, -0.01, 0.001, -0.002])])
def test_line_errors(model, params):
    rng = np.random.default_rng(5)
    _, _, proj, X, lines = scene(rng)
    X = X.copy()
    X[0, 2] = -6.0  # behind every camera: BIG
    pts = X[:, None, :]
    par = np.asarray(params)
    close(tlines.project_points(t(proj), t(pts))[0],
          jlines.project_points(jnp.asarray(proj), jnp.asarray(pts))[0])
    for tf, jf, nf, jnf in (
            (tlines.squared_line_reprojection_error,
             jlines.squared_line_reprojection_error,
             tlnp.squared_line_reprojection_error,
             jlnp.squared_line_reprojection_error),
            (tlines.line_angular_error, jlines.line_angular_error,
             tlnp.line_angular_error, jlnp.line_angular_error)):
        ref = np.asarray(jf(jnp.asarray(lines), jnp.asarray(pts),
                            jnp.asarray(proj), model, jnp.asarray(par),
                            640, 480))
        assert (ref >= 1e30).any() and (ref < 1e30).any()
        close(tf(t(lines), t(pts), t(proj), model, t(par), 640, 480), ref)
        close(nf(lines, pts, proj, model, par, 640, 480),
              jnf(lines, pts, proj, model, par, 640, 480))


def test_triangulation_angle_and_threshold():
    rng = np.random.default_rng(6)
    c1, c2, X = (rng.standard_normal((9, 3)) for _ in range(3))
    c2[0] = c1[0]  # zero baseline
    X[1] = c1[1]  # a point on a center
    close(ttri.triangulation_angle(t(c1), t(c2), t(X)),
          jtri.triangulation_angle(jnp.asarray(c1), jnp.asarray(c2),
                                   jnp.asarray(X)))
    close(tlnp.triangulation_angle(c1, c2, X),
          jlnp.triangulation_angle(c1, c2, X))
    par = np.array([480.0, 510.0, 320.0, 240.0])
    close(tcam.image_to_world_threshold("PINHOLE", t(par), 5.0),
          jcam.image_to_world_threshold("PINHOLE", jnp.asarray(par), 5.0))
    cams = [m.Camera(1, "PINHOLE", 640, 480, par) for m in (trec, jrec)]
    assert cams[0].mean_focal_length() == cams[1].mean_focal_length()
    assert cams[0].image_to_world_threshold(4.0) \
        == cams[1].image_to_world_threshold(4.0)


# -- ops/triangulation ------------------------------------------------------


def test_triangulation_kernels():
    rng = np.random.default_rng(7)
    _, _, proj, X, lines = scene(rng)
    projs = np.broadcast_to(proj, (len(X),) + proj.shape)
    mask = rng.uniform(size=lines.shape[:2]) < 0.7
    mask[:, :3] = True
    close(ttri.triangulate_multiview_lines(t(projs), t(lines),
                                           torch.from_numpy(mask)),
          jtri.triangulate_multiview_lines(jnp.asarray(projs),
                                           jnp.asarray(lines),
                                           jnp.asarray(mask)), rtol=1e-9)
    close(ttri.triangulate_multiview_lines(t(projs), t(lines)),
          jtri.triangulate_multiview_lines(jnp.asarray(projs),
                                           jnp.asarray(lines)), rtol=1e-9)
    close(ttri.triangulate_three_lines(t(projs[:, :3]), t(lines[:, :3])),
          jtri.triangulate_three_lines(jnp.asarray(projs[:, :3]),
                                       jnp.asarray(lines[:, :3])))
    close(ttri.triangulate_linear(t(projs), t(lines), torch.from_numpy(mask)),
          jtri.triangulate_linear(jnp.asarray(projs), jnp.asarray(lines),
                                  jnp.asarray(mask)))
    np.testing.assert_allclose(
        ttri.triangulate_three_lines(t(projs[:, :3]), t(lines[:, :3])),
        X, atol=1e-8)


# -- models/reconstruction --------------------------------------------------


def _model(mod, rng):
    rec = mod.Reconstruction()
    rec.add_camera(mod.Camera(1, "SIMPLE_PINHOLE", 640, 480,
                              np.array([500.0, 320.0, 240.0])))
    for iid in range(1, 4):
        img = mod.Image(image_id=iid, name=f"i{iid}", camera_id=1,
                        lines=rng.standard_normal((6, 3)),
                        aligned=np.zeros(6, bool))
        rec.add_image(img)
        rec.register_image(iid)
    rec.add_point3d(rng.standard_normal(3), [(1, 0), (2, 0), (3, 0)])
    rec.add_point3d(rng.standard_normal(3), [(1, 1), (2, 1)])
    rec.add_point3d(rng.standard_normal(3), [(2, 2), (3, 2)])
    return rec


def test_merge_and_deregister_match_reference():
    recs = [_model(m, np.random.default_rng(8)) for m in (trec, jrec)]
    for rec in recs:
        rec.merge_points3d(1, 3)
        rec.deregister_image(3)
    a, b = recs
    assert a.reg_image_ids == b.reg_image_ids == [1, 2]
    assert sorted(a.points3d) == sorted(b.points3d)
    for pid in a.points3d:
        assert a.points3d[pid].track == b.points3d[pid].track
        close(a.points3d[pid].xyz, b.points3d[pid].xyz)
    for iid in a.images:
        np.testing.assert_array_equal(a.images[iid].point3d_ids,
                                      b.images[iid].point3d_ids)
