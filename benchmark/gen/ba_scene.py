"""A line bundle-adjustment scene made on the device from a seed.

The distributions of the port's ``utils/synthetic.synthetic_model`` (the
layout of ``bench.py``'s line BA): C cameras spread along a baseline with
small yaws, points uniform in a box in front of them, each point seen by
its track length of distinct cameras chosen uniformly among those in which
it projects inside the image (10 px from the border), each observation a
random line through its projection with ``meas_noise`` of Gaussian noise
in the normalized plane, and per solve a start perturbation of the poses
(quaternion 1e-3, translation 1e-2) and points (1e-2).  The draws come
from a ``torch.Generator`` on the device in a few large calls, so the same
seed gives the same scene, but not the numpy original's bits.

Track lengths: every point ``obs_per_point``, or, with ``track_lengths``
= "ba300_model", the set that ``chip_smoke.ba300_model`` draws (a fiftieth
of the points at the longest track, the rest uniform from 4 to twice the
mean less 3; its numpy stream at seed 300), put in an order drawn from
the seed: every seed gets the same sizes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PARAMS = (500.0, 320.0, 240.0)  # SIMPLE_PINHOLE f, cx, cy
WIDTH, HEIGHT, MARGIN = 640, 480, 10.0
Q_NOISE, T_NOISE, X_NOISE = 1e-3, 1e-2, 1e-2
# Candidate points x cameras per visibility block.
VIS_BLOCK = 1 << 25


class Scene(NamedTuple):
    qvecs: torch.Tensor    # (C, 4) float64, true poses (world -> camera)
    tvecs: torch.Tensor    # (C, 3)
    points: torch.Tensor   # (P, 3) true points
    obs_cam: torch.Tensor  # (O,) int64, observations by camera, then point
    obs_pt: torch.Tensor   # (O,) int64
    lines: torch.Tensor    # (O, 3) float64, ||(a, b)|| = 1
    lengths: np.ndarray    # (P,) track lengths


def ba300_lengths(num_points: int, longest: int, num_obs: int) -> np.ndarray:
    """The track lengths of ``chip_smoke.ba300_model`` (numpy, seed 300),
    in its order."""
    n_long = max(1, num_points // 50)
    mean = (num_obs - n_long * longest) / (num_points - n_long)
    rng = np.random.default_rng(300)
    rest = rng.integers(4, max(5, int(round(2 * mean)) - 3),
                        num_points - n_long)
    lengths = np.concatenate([np.full(n_long, longest),
                              np.minimum(rest, longest)])
    return rng.permutation(lengths)


def track_lengths(cfg: dict) -> np.ndarray:
    P = int(cfg["num_points"])
    if cfg.get("track_lengths") == "ba300_model":
        return ba300_lengths(P, int(cfg["longest_track"]),
                             int(cfg["num_observations"]))
    return np.full(P, int(cfg["obs_per_point"]), np.int64)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
        2 * (x * z + w * y),
        2 * (x * y + w * z), w * w - x * x + y * y - z * z,
        2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x),
        w * w - x * x - y * y + z * z], -1).reshape(q.shape[:-1] + (3, 3))


def make_scene(cfg: dict, seed: int, device: torch.device) -> Scene:
    C = int(cfg["num_cameras"])
    lengths_set = track_lengths(cfg)
    P = len(lengths_set)
    g = torch.Generator(device=device).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device)

    def uni(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, **f64)

    # Every seed takes the same set of track lengths, in its own order.
    perm = torch.randperm(P, generator=g, device=device).cpu().numpy()
    lengths = lengths_set[perm]
    yaw = uni(-0.2, 0.2, C)
    z = torch.zeros_like(yaw)
    q = torch.stack([torch.cos(yaw / 2), z, torch.sin(yaw / 2), z], 1)
    t = torch.stack([uni(-2, 2, C), uni(-0.3, 0.3, C), uni(-0.5, 0.5, C)], 1)
    R = quat_to_rotmat(q)
    f, cx, cy = PARAMS
    kmax = int(lengths.max())
    rows = max(1, VIS_BLOCK // C)

    pts, cams = [], []
    n = 0
    while n < P:
        M = min(rows, 2 * (P - n) + 1024)
        X = torch.stack([uni(-3, 3, M), uni(-2, 2, M), uni(9, 15, M)], 1)
        Xc = torch.einsum("cij,mj->mci", R, X) + t[None]
        zc = Xc[..., 2]
        px = f * Xc[..., 0] / zc + cx
        py = f * Xc[..., 1] / zc + cy
        vis = ((zc > 0.5) & (px > MARGIN) & (px < WIDTH - MARGIN)
               & (py > MARGIN) & (py < HEIGHT - MARGIN))
        keys = torch.rand(M, C, generator=g, **f64)
        keys = torch.where(vis, keys, -1.0)
        top, idx = torch.topk(keys, kmax, dim=1)
        seen = vis.sum(1).cpu().numpy()
        # Candidates in order take the next track length they can hold.
        if (lengths == kmax).all():
            take = np.nonzero(seen >= kmax)[0][:P - n].tolist()
            need = [kmax] * len(take)
        else:
            take, need = [], []
            for m in range(M):
                if n + len(take) == P:
                    break
                k = lengths[n + len(take)]
                if seen[m] >= k:
                    take.append(m)
                    need.append(k)
        if take:
            sel = torch.as_tensor(take, device=device)
            k_t = torch.as_tensor(need, device=device)
            chosen = torch.where(
                torch.arange(kmax, device=device)[None] < k_t[:, None],
                idx[sel], C)
            pts.append(X[sel])
            cams.append(torch.sort(chosen, dim=1).values)
            n += len(take)
    points = torch.cat(pts)
    cam_tab = torch.cat(cams)  # (P, kmax), C = no camera
    ok = cam_tab < C
    obs_pt = torch.arange(P, device=device)[:, None].expand(-1, kmax)[ok]
    obs_cam = cam_tab[ok]
    order = torch.argsort(obs_cam * P + obs_pt)
    obs_cam, obs_pt = obs_cam[order], obs_pt[order]

    O = obs_cam.shape[0]
    draws = torch.randn(O, 5, generator=g, **f64)
    xc = torch.einsum("oij,oj->oi", R[obs_cam], points[obs_pt]) + t[obs_cam]
    uv = xc[:, :2] / xc[:, 2:] + float(cfg["meas_noise"]) * draws[:, :2]
    line = torch.linalg.cross(draws[:, 2:], torch.cat(
        [uv, torch.ones_like(uv[:, :1])], 1), dim=1)
    line = line / torch.linalg.vector_norm(line[:, :2], dim=1, keepdim=True)
    return Scene(q, t, points, obs_cam, obs_pt, line, lengths)


def perturbed_start(scene: Scene, seed: int):
    """The start of one solve: the true poses and points with the start
    perturbations drawn from ``seed`` on the scene's device (float64)."""
    dev = scene.points.device
    g = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    C, P = scene.qvecs.shape[0], scene.points.shape[0]
    q = scene.qvecs + Q_NOISE * torch.randn(C, 4, generator=g, **f64)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    t = scene.tvecs + T_NOISE * torch.randn(C, 3, generator=g, **f64)
    X = scene.points + X_NOISE * torch.randn(P, 3, generator=g, **f64)
    return q, t, X


def gauge_pair(scene: Scene):
    """The first two registered images of the mapper, an initial pair of
    wide baseline: the cameras at the two ends of the track (least and
    greatest centre x)."""
    R = quat_to_rotmat(scene.qvecs)
    centres = -torch.einsum("cji,cj->ci", R, scene.tvecs)
    return int(torch.argmin(centres[:, 0])), int(torch.argmax(centres[:, 0]))


def gauge_mask(num_cams: int, device, first: int = 0,
               second: int = 1) -> torch.Tensor:
    """``adjust_global_bundle``'s gauge: the first image's pose fixed, and
    the second's x translation (dof 3 of rotation 0-2, translation 3-5)."""
    m = torch.ones(num_cams, 6, device=device)
    m[first] = 0.0
    if num_cams > 1:
        m[second, 3] = 0.0
    return m

