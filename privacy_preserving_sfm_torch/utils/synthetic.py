"""Seeded synthetic data for tests and the chip smoke run.

Four writers, numpy only, so both the reference package and the port can
read what they write: ``synthetic_model`` (a line-BA model, text format),
``synthetic_matching_database`` (a matcher database with known
correspondences, SQLite), ``synthetic_line_database`` (a mapper database of
lifted lines, gravity and true matches, SQLite) and ``render_dataset``
(rendered images with gravity and calibration sidecars, the two scene
kinds of ``tools/synth_dataset.py``); and ``gauge_align_errors``, which
holds estimated poses against the truth up to gauge.

``synthetic_model`` builds a reconstruction in the layout of the line
bundle-adjustment benchmark (``bench.py:28-81``): cameras spread along a
baseline with small yaws, points in front of them, each point observed by
``obs_per_point`` distinct cameras in which it projects inside the image.
Every observation stores a random line through the projected point, with
``meas_noise`` of Gaussian noise in the normalized plane; poses and
points then get the start perturbations of the benchmark.  Numpy only, so
both the reference package and the port can read the model it writes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from privacy_preserving_sfm_torch.models.database import Database

from privacy_preserving_sfm_torch.models.reconstruction import (
    Camera, Image, Reconstruction,
)
from privacy_preserving_sfm_torch.ops import lie_np
from privacy_preserving_sfm_torch.utils import png


# SIMPLE_PINHOLE (f, cx, cy), image size, and the benchmark's start
# perturbations of quaternions, translations and points.
PARAMS = (500.0, 320.0, 240.0)
WIDTH, HEIGHT = 640, 480
Q_NOISE, T_NOISE, X_NOISE = 1e-3, 1e-2, 1e-2
# Projections keep this many pixels from the image border, so the
# perturbed model's observations stay inside the image.
MARGIN = 10.0
# Candidate points x cameras per visibility block of ``synthetic_model``.
VIS_BLOCK = 1 << 22


def synthetic_model(num_images: int, num_points: int, obs_per_point: int,
                    seed: int, meas_noise: float = 2e-4,
                    track_lengths: Optional[Sequence[int]] = None
                    ) -> Reconstruction:
    """A registered SIMPLE_PINHOLE model with perturbed poses and points:
    each point seen by ``obs_per_point`` cameras, or by
    ``track_lengths[p]`` cameras where those are given (one a point)."""
    rng = np.random.default_rng(seed)
    lengths = ([obs_per_point] * num_points if track_lengths is None
               else [int(k) for k in track_lengths])
    if len(lengths) != num_points:
        raise ValueError(f"{len(lengths)} track lengths for {num_points} "
                         "points")
    least = min(lengths, default=0)
    f, cx, cy = PARAMS
    width, height, margin = WIDTH, HEIGHT, MARGIN
    qs = np.zeros((num_images, 4))
    ts = np.zeros((num_images, 3))
    for c in range(num_images):
        yaw = rng.uniform(-0.2, 0.2)
        qs[c] = [np.cos(yaw / 2), 0, np.sin(yaw / 2), 0]
        ts[c] = [rng.uniform(-2, 2), rng.uniform(-0.3, 0.3),
                 rng.uniform(-0.5, 0.5)]
    R = np.stack([lie_np.quat_to_rotmat(q) for q in qs])

    def visible(X):
        Xc = np.einsum("cij,mj->mci", R, X) + ts[None]
        z = Xc[..., 2]
        px = f * Xc[..., 0] / z + cx
        py = f * Xc[..., 1] / z + cy
        return ((z > 0.5) & (px > margin) & (px < width - margin)
                & (py > margin) & (py < height - margin))

    # Visibility is computed for blocks of candidates, so the (candidates,
    # cameras, 3) temporaries stay near VIS_BLOCK elements at any size.
    rows = max(1, VIS_BLOCK // num_images)
    pts, tracks = [], []
    while len(pts) < num_points:
        X = np.stack([rng.uniform(-3, 3, 4 * num_points),
                      rng.uniform(-2, 2, 4 * num_points),
                      rng.uniform(9, 15, 4 * num_points)], axis=1)
        for lo in range(0, len(X), rows):
            if len(pts) == num_points:
                break
            vis = visible(X[lo:lo + rows])
            seen = vis.sum(1)
            for m in np.nonzero(seen >= least)[0]:
                if len(pts) == num_points:
                    break
                need = lengths[len(pts)]
                if seen[m] < need:
                    continue
                cams = rng.choice(np.nonzero(vis[m])[0], need,
                                  replace=False)
                pts.append(X[lo + m])
                tracks.append(np.sort(cams))
    pts = np.asarray(pts).reshape(-1, 3)

    # One observation a (point, camera) of the tracks, in track order; each
    # draws 2 numbers of noise and 3 for the line's direction.
    obs_p = np.repeat(np.arange(num_points), [len(c) for c in tracks])
    obs_c = np.concatenate(tracks or [np.zeros(0, int)]).astype(int)
    draws = rng.standard_normal((len(obs_p), 5))
    # matmul, not einsum: its sums round as one observation's ``R @ x`` and
    # ``x.dot(x)`` do, so batching leaves every line as it would be alone.
    xc = np.matmul(R[obs_c], pts[obs_p][:, :, None])[:, :, 0] + ts[obs_c]
    uv = xc[:, :2] / xc[:, 2:] + meas_noise * draws[:, :2]
    line = np.cross(draws[:, 2:], np.concatenate(
        [uv, np.ones((len(uv), 1))], axis=1))
    ab = line[:, None, :2]
    line /= np.sqrt(np.matmul(ab, ab.transpose(0, 2, 1)))[:, 0]
    by_image = np.argsort(obs_c, kind="stable")
    per_image_lines = np.split(line[by_image], np.cumsum(
        np.bincount(obs_c, minlength=num_images))[:-1])

    rec = Reconstruction()
    rec.add_camera(Camera(camera_id=1, model="SIMPLE_PINHOLE", width=width,
                          height=height, params=np.asarray(PARAMS)))
    for c in range(num_images):
        lines = per_image_lines[c]
        q = qs[c] + rng.normal(0, Q_NOISE, 4)
        rec.add_image(Image(
            image_id=c + 1, name=f"image{c + 1:05d}.png", camera_id=1,
            qvec=q / np.linalg.norm(q),
            tvec=ts[c] + rng.normal(0, T_NOISE, 3),
            lines=lines, aligned=np.zeros(len(lines), bool)))
        rec.register_image(c + 1)
    slot = [0] * num_images
    for p, cams in enumerate(tracks):
        track = []
        for c in cams:
            track.append((int(c) + 1, slot[c]))
            slot[c] += 1
        rec.add_point3d(pts[p] + rng.normal(0, X_NOISE, 3), track)
    return rec


def line_error_sum(rec: Reconstruction) -> float:
    """Sum of squared pixel point-to-line errors over all observations."""
    pts = list(rec.points3d.values())
    obs = np.asarray([o for pt in pts for o in pt.track],
                     np.int64).reshape(-1, 2)
    xyz = np.repeat(np.asarray([pt.xyz for pt in pts]).reshape(-1, 3),
                    [len(pt.track) for pt in pts], axis=0)
    errs = rec.batch_squared_line_errors(obs[:, 0], obs[:, 1], xyz)
    return float(np.sum(errs))


@dataclasses.dataclass
class MatchingScene:
    """What ``synthetic_matching_database`` wrote: image ids in name order,
    and for each pair (a, b) with a < b that shares scene points, the true
    correspondences as (K, 2) feature indices (in a, in b), sorted."""

    image_ids: List[int]
    true_matches: Dict[Tuple[int, int], np.ndarray]


def sift_like(p: np.ndarray) -> np.ndarray:
    """SIFT's uint8 convention for L1-normalized histograms p:
    round(512 * sqrt(p)), so |d| = 512 and d1 . d2 / 512^2 is the cosine
    (``features/sift.py:854-855`` of the reference package)."""
    return np.clip(np.round(512.0 * np.sqrt(p)), 0, 255).astype(np.uint8)


def synthetic_matching_database(path: str, num_images: int,
                                num_features: int, seed: int,
                                window: int = 0, shift: int = 0
                                ) -> MatchingScene:
    """Write a matcher database of ``num_images`` images with
    ``num_features`` descriptors each, and return its true correspondences.

    Scene points are Dirichlet(0.2) histograms on the 128-simplex, which
    puts unrelated descriptors about 1.16 rad apart (few closer than 0.9),
    beyond the matcher's 0.7 rad gate.  Image k sees the
    ``window`` scene points starting at k * ``shift`` (defaults 3/4 of
    the features and window // 12), so overlap decays with image distance
    and pairs more than window / shift apart share nothing and fall under
    ``min_num_matches``; the rest of its features are distractors.  Each
    view of a point mixes in a fresh histogram with a weight drawn from
    U(0.05, 0.45) (recall falls steeply above 0.45), and each image's
    features are shuffled.  Images carry GPS priors (lat, lon, alt) about
    11 m apart along a line, for the spatial matcher.
    """
    rng = np.random.default_rng(seed)
    window = window or (3 * num_features) // 4
    shift = shift or max(1, window // 12)
    conc = np.full(128, 0.2)
    scene = rng.dirichlet(conc, (num_images - 1) * shift + window)
    inverse = []  # per image: feature index of each of its content rows
    with Database(path) as db:
        cam = db.write_camera("SIMPLE_PINHOLE", 640, 480,
                              np.array([500.0, 320.0, 240.0]))
        ids = []
        for k in range(num_images):
            iid = db.write_image(f"im{k:04d}.png", cam,
                                 prior_t=(47.0 + 1e-4 * k, 8.5, 400.0))
            ids.append(iid)
            lam = rng.uniform(0.05, 0.45, (window, 1))
            seen = scene[k * shift:k * shift + window]
            content = np.concatenate([
                (1.0 - lam) * seen + lam * rng.dirichlet(conc, window),
                rng.dirichlet(conc, num_features - window)])
            order = rng.permutation(num_features)
            inv = np.empty(num_features, np.int64)
            inv[order] = np.arange(num_features)
            inverse.append(inv)
            db.write_descriptors(iid, sift_like(content[order]))
    true = {}
    for i in range(num_images):
        for j in range(i + 1, num_images):
            shared = np.arange(j * shift, i * shift + window)
            if len(shared) == 0:
                continue
            m = np.stack([inverse[i][shared - i * shift],
                          inverse[j][shared - j * shift]], 1)
            a, b = ids[i], ids[j]
            if a > b:
                a, b, m = b, a, m[:, ::-1]
            true[(a, b)] = m[np.argsort(m[:, 0])]
    return MatchingScene(image_ids=ids, true_matches=true)


def match_quality(db: Database, scene: MatchingScene
                  ) -> Tuple[float, float, int]:
    """(precision, recall, number of stored matches) of the database's
    match tables against the scene's true correspondences, over all
    pairs."""
    stored = correct = 0
    for (a, b), m in db.read_all_matches().items():
        stored += len(m)
        t = scene.true_matches.get((a, b))
        if t is not None and len(m):
            key = t[:, 0].astype(np.int64) << 32 | t[:, 1]
            got = m[:, 0].astype(np.int64) << 32 | m[:, 1]
            correct += int(np.isin(got, key).sum())
    total = sum(len(t) for t in scene.true_matches.values())
    return (correct / stored if stored else 0.0,
            correct / total if total else 0.0, stored)


# ---------------------------------------------------------------------------
# Rendered image datasets
# ---------------------------------------------------------------------------

# Facets of the "box" scene (``tools/synth_dataset.py:51-60``): (origin O,
# edge A, edge B), world points X(u, v) = O + u A + v B, (u, v) in
# [-1, 1]^2.  A back wall, a tilted floor, a slanted side wall and a
# floating billboard: no single homography explains any image pair.
BOX_FACETS = (
    (np.array([0.0, 0.0, 6.5]),
     np.array([3.2, 0.0, 0.7]), np.array([0.0, 2.4, 0.5])),
    (np.array([0.0, 1.6, 4.6]),
     np.array([2.8, 0.12, 0.0]), np.array([0.0, 0.55, 2.2])),
    (np.array([-2.4, 0.0, 4.8]),
     np.array([0.9, 0.05, 1.6]), np.array([0.1, 1.9, 0.0])),
    (np.array([1.5, -0.5, 4.1]),
     np.array([0.9, 0.0, 0.35]), np.array([0.0, 0.8, 0.2])),
)
# The textured plane X(u, v) = (u, v, z0 + ax u + ay v), (u, v) in [-S, S]^2.
PLANE = dict(plane_S=3.0, plane_z0=5.0, plane_ax=0.5, plane_ay=0.35)


def _cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of a cubic resize (Keys, a = -0.75, pixel
    centres aligned, edges replicated), as OpenCV's INTER_CUBIC."""
    a = -0.75
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    out = np.zeros((n_out, n_in))
    for k in range(-1, 3):
        d = np.abs(t - k)
        w = np.where(d <= 1, ((a + 2) * d - (a + 3)) * d * d + 1,
                     np.where(d < 2, ((a * d - 5 * a) * d + 8 * a) * d - 4 * a,
                              0.0))
        np.add.at(out, (np.arange(n_out), np.clip(i0 + k, 0, n_in - 1)), w)
    return out


def _resize_cubic(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape
    return _cubic_matrix(h, size) @ img @ _cubic_matrix(w, size).T


def make_texture(rng: np.random.Generator, size: int) -> np.ndarray:
    """High-contrast smooth random texture (size, size) uint8: a random
    grid at 1/8 of the size plus half of one at 1/32, cubic-upsampled."""
    tex = _resize_cubic(rng.uniform(0, 1, (size // 8, size // 8)), size)
    tex += 0.5 * _resize_cubic(rng.uniform(0, 1, (size // 32, size // 32)),
                               size)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return (tex * 255).astype(np.uint8)


def _bilinear(tex: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Bilinear samples of ``tex`` at float pixel coords, edges replicated."""
    h, w = tex.shape
    x = np.clip(x, 0, w - 1)
    y = np.clip(y, 0, h - 1)
    x0 = np.minimum(np.floor(x).astype(np.int64), w - 2)
    y0 = np.minimum(np.floor(y).astype(np.int64), h - 2)
    fx, fy = x - x0, y - y0
    t = tex.astype(np.float32)
    return ((t[y0, x0] * (1 - fx) + t[y0, x0 + 1] * fx) * (1 - fy)
            + (t[y0 + 1, x0] * (1 - fx) + t[y0 + 1, x0 + 1] * fx) * fy)


def _to_u8(v: np.ndarray) -> np.ndarray:
    return np.clip(np.round(v), 0, 255).astype(np.uint8)


def _pixel_grid(width: int, height: int) -> np.ndarray:
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    return np.stack([xs, ys, np.ones_like(xs)])  # (3, H, W)


def plane_homography(meta: dict, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Texture pixel -> image pixel homography of a plane view
    (``tools/frontend_eval.py:32-41``): H = K (R M + t e3^T) T."""
    f, w, h = meta["f"], meta["width"], meta["height"]
    S, z0 = meta["plane_S"], meta["plane_z0"]
    tex = meta["tex_size"]
    M = np.array([[1.0, 0, 0], [0, 1.0, 0],
                  [meta["plane_ax"], meta["plane_ay"], z0]])
    T = np.array([[2 * S / tex, 0, -S], [0, 2 * S / tex, -S], [0, 0, 1.0]])
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    return K @ (R @ M + t[:, None] @ np.array([[0.0, 0.0, 1.0]])) @ T


def _render_plane(H: np.ndarray, tex: np.ndarray, width: int, height: int):
    """Warp the texture into the image through H (texture -> image),
    edges replicated (``cv2.warpPerspective`` with BORDER_REPLICATE)."""
    uvw = np.einsum("ij,jhw->ihw", np.linalg.inv(H), _pixel_grid(width,
                                                                  height))
    return _to_u8(_bilinear(tex, uvw[0] / uvw[2], uvw[1] / uvw[2]))


def _render_box(K, R, t, textures, width: int, height: int):
    """Composite the BOX_FACETS by nearest positive depth on a featureless
    background (``tools/synth_dataset.py:84-116``)."""
    pix = _pixel_grid(width, height)
    img = np.full((height, width), 96, np.uint8)
    zbuf = np.full((height, width), np.inf)
    for (O, A, B), tex in zip(BOX_FACETS, textures):
        ts = tex.shape[0]
        Hm = K @ np.column_stack([R @ A, R @ B, R @ O + t])
        uvw = np.tensordot(np.linalg.inv(Hm), pix, axes=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            u = uvw[0] / uvw[2]
            v = uvw[1] / uvw[2]
        depth = (R[2] @ O + t[2]) + u * (R[2] @ A) + v * (R[2] @ B)
        win = ((np.abs(u) <= 1) & (np.abs(v) <= 1) & (depth > 0.1)
               & (depth < zbuf))
        img[win] = _to_u8(_bilinear(tex, (u[win] + 1) * 0.5 * (ts - 1),
                                    (v[win] + 1) * 0.5 * (ts - 1)))
        zbuf[win] = depth[win]
    return img


def _quat_multiply(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def render_dataset(outdir: str, num_images: int, width: int = 640,
                   height: int = 480, f: float = 0.0, seed: int = 0,
                   scene: str = "plane") -> dict:
    """Render a seeded multi-view dataset of ``scene`` ("plane" or "box")
    with a SIMPLE_PINHOLE camera (f defaults to 0.625 x width, the
    field of view of ``tools/synth_dataset.py``'s 400 px at 640 px).

    Writes, in the reference's dataset layout (``image_reader.cc:206-247``),
    ``img%03d.png`` (8-bit grayscale, ``utils/png.py``) with its
    ``.gravity.txt`` and ``.camera_model.txt``; ``gt_poses.txt`` (name, qw
    qx qy qz, tx ty tz, world -> camera); and ``meta.json``, from which
    ``plane_homography`` rebuilds each plane view's homography.  Cameras
    sit on an arc aimed at the scene centre, as in
    ``tools/synth_dataset.py``; textures are cubic-upsampled random grids
    and views are bilinear warps, so the images differ from that tool's
    (OpenCV) renders in detail, not in kind.  Returns the metadata with
    ``poses`` {name: (R, t)}.
    """
    import json
    import os

    f = f or 0.625 * width
    rng = np.random.default_rng(seed)
    os.makedirs(outdir, exist_ok=True)
    # Texture sizes of tools/synth_dataset.py at 640 px, scaled with width.
    tex_size = int(round(1600 * width / 640))
    if scene == "plane":
        tex = make_texture(rng, tex_size)
    elif scene == "box":
        box_tex = [make_texture(rng, tex_size // 2) for _ in BOX_FACETS]
    else:
        raise ValueError(f"unknown scene {scene!r}")
    meta = dict(f=f, width=width, height=height, scene=scene,
                camera="SIMPLE_PINHOLE",
                camera_params=[f, width / 2, height / 2],
                tex_size=tex_size, **PLANE)
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])
    z0, spread = PLANE["plane_z0"], 10.0
    poses, gt_lines = {}, []
    for i in range(num_images):
        frac = i / max(1, num_images - 1)
        C = np.array([spread * (frac - 0.5),
                      rng.uniform(-0.15, 0.15), rng.uniform(-0.3, 0.3)])
        yaw = np.arctan2(C[0], z0)  # aim the optical axis at (0, 0, z0)
        q_yaw = np.array([np.cos(yaw / 2), 0, np.sin(yaw / 2), 0])
        ax = rng.standard_normal(3) * 0.03
        ang = np.linalg.norm(ax) + 1e-12
        q_tilt = np.concatenate([[np.cos(ang / 2)],
                                 np.sin(ang / 2) * ax / ang])
        q = _quat_multiply(q_tilt, q_yaw)
        R = lie_np.quat_to_rotmat(q)
        t = -R @ C
        name = f"img{i:03d}.png"
        if scene == "box":
            img = _render_box(K, R, t, box_tex, width, height)
        else:
            img = _render_plane(plane_homography(meta, R, t), tex, width,
                                height)
        path = os.path.join(outdir, name)
        png.write_png_gray(path, img)
        g = R @ np.array([0.0, 1.0, 0.0])
        with open(path + ".gravity.txt", "w") as fo:
            fo.write(" ".join(repr(float(v)) for v in g) + "\n")
        with open(path + ".camera_model.txt", "w") as fo:
            fo.write("SIMPLE_PINHOLE, " + ", ".join(
                repr(float(p)) for p in meta["camera_params"]) + "\n")
        poses[name] = (R, t)
        gt_lines.append(f"{name} " + " ".join(repr(float(v)) for v in q)
                        + " " + " ".join(repr(float(v)) for v in t))
    with open(os.path.join(outdir, "gt_poses.txt"), "w") as fo:
        fo.write("# name qw qx qy qz tx ty tz\n" + "\n".join(gt_lines)
                 + "\n")
    with open(os.path.join(outdir, "meta.json"), "w") as fo:
        json.dump(meta, fo)
    return dict(meta, poses=poses)


def synthetic_line_database(path: str, num_images: int = 8,
                            num_points: int = 120, seed: int = 0,
                            aligned_ratio: float = 0.5,
                            drop_prob: float = 0.1):
    """A mapper database from a seeded scene: ``num_images`` cameras on an
    arc looking at a point cloud (SIMPLE_PINHOLE f = 500, 640 x 480), every
    visible point lifted to a line through its exact projection (aligned:
    through gravity, for a per-point ``aligned_ratio`` share; else a
    random direction), gravity per image, and every co-visible pair
    matched (feature j of every image is point j).  Numpy twin of
    ``tests/test_e2e_synthetic.py:build_synthetic_db`` at its defaults.
    Returns (qs (V, 4), ts (V, 3), points (P, 3), image ids)."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for i in range(num_images):
        yaw = -0.35 + 0.7 * i / max(1, num_images - 1)
        q_yaw = np.array([np.cos(yaw / 2), 0, np.sin(yaw / 2), 0])
        ax = rng.standard_normal(3) * 0.05
        ang = np.linalg.norm(ax) + 1e-12
        q_tilt = np.concatenate([[np.cos(ang / 2)],
                                 np.sin(ang / 2) * ax / ang])
        q = _quat_multiply(q_tilt, q_yaw)
        t = np.array([-1.0 + 2.0 * i / max(1, num_images - 1),
                      rng.uniform(-0.1, 0.1), rng.uniform(-0.2, 0.2)])
        qs.append(q)
        ts.append(t)
    qs, ts = np.stack(qs), np.stack(ts)
    pts = rng.uniform(-1.5, 1.5, (num_points, 3))
    pts[:, 2] = np.abs(pts[:, 2]) + 3.0
    aligned = rng.uniform(size=num_points) < aligned_ratio
    f, cx, cy = 500.0, 320.0, 240.0
    with Database(path) as db:
        cam_id = db.write_camera("SIMPLE_PINHOLE", 640, 480,
                                 np.array([f, cx, cy]), prior_focal=True)
        image_ids, visible = [], []
        for i in range(num_images):
            iid = db.write_image(f"img{i:03d}.png", cam_id)
            image_ids.append(iid)
            R = lie_np.quat_to_rotmat(qs[i])
            Xc = pts @ R.T + ts[i]
            uv = Xc[:, :2] / Xc[:, 2:3]
            pix = uv * f + np.array([cx, cy])
            vis = ((Xc[:, 2] > 0.2) & (pix[:, 0] >= 0) & (pix[:, 0] < 640)
                   & (pix[:, 1] >= 0) & (pix[:, 1] < 480)
                   & (rng.uniform(size=num_points) > drop_prob))
            visible.append(vis)
            g = R @ np.array([0.0, 1.0, 0.0])
            hom = np.concatenate([uv, np.ones((num_points, 1))], axis=1)
            dirs = np.where(aligned[:, None],
                            np.broadcast_to(g, (num_points, 3)),
                            rng.standard_normal((num_points, 3)))
            lines = np.cross(dirs, hom)
            lines /= np.linalg.norm(lines[:, :2], axis=-1, keepdims=True)
            # Invisible features keep random lines but never match.
            lines[~vis] = rng.standard_normal((int((~vis).sum()), 3))
            lines[~vis] /= np.linalg.norm(lines[~vis, :2], axis=-1,
                                          keepdims=True)
            db.write_lines(iid, lines, aligned)
            db.write_gravity(iid, g)
        for a in range(num_images):
            for b in range(a + 1, num_images):
                both = np.nonzero(visible[a] & visible[b])[0]
                db.write_matches(image_ids[a], image_ids[b],
                                 np.stack([both, both], 1).astype(np.uint32))
    return qs, ts, pts, image_ids


def read_gt_poses(path: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """``render_dataset``'s ``gt_poses.txt``: {name: (qvec, tvec)},
    world -> camera."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            v = np.asarray([float(p) for p in parts[1:8]])
            out[parts[0]] = (v[:4], v[4:])
    return out


def gauge_align_errors(gt_qs, gt_ts, poses) -> Tuple[float, float]:
    """Pose errors of V >= 2 estimated (V, 3, 4) world->camera poses
    against the true (qvec, tvec) up to gauge, as ``tests/test_init.py``
    aligns them (the reference's ``initializer_test.cc:372-381``): every
    pose relative to camera 0.  Returns the largest rotation error and the
    largest angle between estimated and true relative translation
    directions (cameras 1 to V - 1), both in radians."""
    R = [lie_np.quat_to_rotmat(q) for q in gt_qs]
    P = np.asarray(poses, np.float64)
    R0, t0 = P[0, :, :3], P[0, :, 3]
    rot_err, dir_err = [], []
    for i in range(1, len(P)):
        Rg = R[i] @ R[0].T
        tg = gt_ts[i] - Rg @ gt_ts[0]
        Re = P[i, :, :3] @ R0.T
        te = P[i, :, 3] - Re @ t0
        dR = Re @ Rg.T
        rot_err.append(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        cos = te @ tg / max(np.linalg.norm(te) * np.linalg.norm(tg), 1e-300)
        dir_err.append(np.arccos(np.clip(cos, -1, 1)))
    return float(max(rot_err)), float(max(dir_err))
