"""Seeded synthetic data for tests and the chip smoke run.

Two builders, numpy only, so both the reference package and the port can
read what they write: ``synthetic_model`` (a line-BA model, text format)
and ``synthetic_matching_database`` (a matcher database with known
correspondences, SQLite).

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
from typing import Dict, List, Tuple

import numpy as np

from privacy_preserving_sfm_torch.models.database import Database

from privacy_preserving_sfm_torch.models.reconstruction import (
    Camera, Image, Reconstruction,
)
from privacy_preserving_sfm_torch.ops import lie_np


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
                    seed: int, meas_noise: float = 2e-4) -> Reconstruction:
    """A registered SIMPLE_PINHOLE model with perturbed poses and points."""
    rng = np.random.default_rng(seed)
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
            for m in np.nonzero(vis.sum(1) >= obs_per_point)[0]:
                if len(pts) == num_points:
                    break
                cams = rng.choice(np.nonzero(vis[m])[0], obs_per_point,
                                  replace=False)
                pts.append(X[lo + m])
                tracks.append(np.sort(cams))
    pts = np.asarray(pts)

    per_image_lines = [[] for _ in range(num_images)]
    per_image_pid = [[] for _ in range(num_images)]
    for p, cams in enumerate(tracks):
        for c in cams:
            xc = R[c] @ pts[p] + ts[c]
            uv = xc[:2] / xc[2] + rng.normal(0, meas_noise, 2)
            line = np.cross(rng.standard_normal(3), np.append(uv, 1.0))
            per_image_lines[c].append(line / np.linalg.norm(line[:2]))
            per_image_pid[c].append(p)

    rec = Reconstruction()
    rec.add_camera(Camera(camera_id=1, model="SIMPLE_PINHOLE", width=width,
                          height=height, params=np.asarray(PARAMS)))
    for c in range(num_images):
        lines = np.asarray(per_image_lines[c]).reshape(-1, 3)
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
    obs_img, obs_li, xyz = [], [], []
    for pt in rec.points3d.values():
        for iid, li in pt.track:
            obs_img.append(iid)
            obs_li.append(li)
            xyz.append(pt.xyz)
    errs = rec.batch_squared_line_errors(np.asarray(obs_img),
                                         np.asarray(obs_li),
                                         np.asarray(xyz).reshape(-1, 3))
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
