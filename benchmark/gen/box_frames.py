"""The box scene's video frames, rendered on the device from a seed.

The distributions of the port's ``tools/synth_dataset.make_dataset(...,
scene="box")`` (the reference's 300-view box evaluation): four textured
facets (``BOX_FACETS``) on a grey (96) background, textures of 800 px made
as a random grid at 1/8 of the size plus half of one at 1/32, upsampled by
Keys' cubic (a = -0.75, edges replicated), scaled to uint8; cameras on a
10-unit track aimed at (0, 0, 5), the centre jittered by U(+-0.15) and
U(+-0.3), tilted by a rotation of N(0, 0.03^2) per axis; SIMPLE_PINHOLE
(f, w / 2, h / 2); each facet sampled bilinearly (float32, zero outside)
where it is the nearest positive depth; gravity R (0, 1, 0).  The draws
come from a ``torch.Generator`` on the device: a seed gives the same
frames every run, but not the numpy original's bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BOX_FACETS = (
    ((0.0, 0.0, 6.5), (3.2, 0.0, 0.7), (0.0, 2.4, 0.5)),
    ((0.0, 1.6, 4.6), (2.8, 0.12, 0.0), (0.0, 0.55, 2.2)),
    ((-2.4, 0.0, 4.8), (0.9, 0.05, 1.6), (0.1, 1.9, 0.0)),
    ((1.5, -0.5, 4.1), (0.9, 0.0, 0.35), (0.0, 0.8, 0.2)),
)
PLANE_Z0, SPREAD = 5.0, 10.0
VIEWS_PER_CALL = 20


class Frames(NamedTuple):
    images: torch.Tensor   # (N, H, W) uint8
    gravity: torch.Tensor  # (N, 3) float32
    params: torch.Tensor   # (N, 3) float32, SIMPLE_PINHOLE f, cx, cy
    R: torch.Tensor        # (N, 3, 3) float64, world -> camera
    t: torch.Tensor        # (N, 3) float64


def cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
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


def make_texture(g: torch.Generator, size: int, device) -> torch.Tensor:
    """(size, size) float32 texture of uint8 levels."""
    def up(n):
        grid = torch.rand(n, n, generator=g, device=device)
        A = torch.as_tensor(cubic_matrix(n, size), dtype=torch.float32,
                            device=device)
        return A @ grid @ A.T

    tex = up(size // 8) + 0.5 * up(size // 32)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return torch.floor(tex * 255.0)


def _quat_mul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def _rotmat(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
        2 * (x * z + w * y),
        2 * (x * y + w * z), w * w - x * x + y * y - z * z,
        2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x),
        w * w - x * x - y * y + z * z], -1).reshape(q.shape[:-1] + (3, 3))


def camera_path(g: torch.Generator, n: int, device):
    """R (n, 3, 3), t (n, 3), float64: the views' world -> camera poses."""
    f64 = dict(dtype=torch.float64, device=device)
    frac = torch.arange(n, **f64) / max(1, n - 1)
    cy = 0.3 * torch.rand(n, generator=g, **f64) - 0.15
    cz = 0.6 * torch.rand(n, generator=g, **f64) - 0.3
    C = torch.stack([SPREAD * (frac - 0.5), cy, cz], 1)
    yaw = torch.atan2(C[:, 0], torch.full_like(frac, PLANE_Z0))
    zero = torch.zeros_like(yaw)
    q_yaw = torch.stack([torch.cos(yaw / 2), zero, torch.sin(yaw / 2), zero],
                        1)
    ax = 0.03 * torch.randn(n, 3, generator=g, **f64)
    ang = torch.linalg.vector_norm(ax, dim=1, keepdim=True) + 1e-12
    q_tilt = torch.cat([torch.cos(ang / 2), torch.sin(ang / 2) * ax / ang], 1)
    R = _rotmat(_quat_mul(q_tilt, q_yaw))
    t = -torch.einsum("nij,nj->ni", R, C)
    return R, t


def _bilinear_zero(tex: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear samples (float32 weights and sums) of ``tex`` at (x, y);
    taps outside the texture read 0."""
    h, w = tex.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = tex[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return torch.where(inside, v, 0.0)

    return ((tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx) * (1 - fy)
            + (tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx) * fy)


def render(R, t, textures, f: float, width: int, height: int):
    """(n, H, W) uint8 views of the box through SIMPLE_PINHOLE f."""
    dev = R.device
    n = R.shape[0]
    K = torch.tensor([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]],
                     dtype=torch.float64, device=dev)
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float64,
                                         device=dev),
                            torch.arange(width, dtype=torch.float64,
                                         device=dev), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
    img = torch.full((n, height * width), 96.0, device=dev)
    zbuf = torch.full((n, height * width), float("inf"),
                      dtype=torch.float64, device=dev)
    for (O, A, B), tex in zip(BOX_FACETS, textures):
        O, A, B = (torch.tensor(v, dtype=torch.float64, device=dev)
                   for v in (O, A, B))
        ts = tex.shape[0]
        Hm = K @ torch.stack([R @ A, R @ B, R @ O + t], -1)  # (n, 3, 3)
        uvw = torch.linalg.inv(Hm) @ pix
        u, v = uvw[:, 0] / uvw[:, 2], uvw[:, 1] / uvw[:, 2]
        r2 = R[:, 2]
        depth = ((r2 @ O + t[:, 2])[:, None] + u * (r2 @ A)[:, None]
                 + v * (r2 @ B)[:, None])
        win = ((u.abs() <= 1) & (v.abs() <= 1) & (depth > 0.1)
               & (depth < zbuf))
        su = ((u.clamp(-1, 1) + 1) * 0.5 * (ts - 1)).float()
        sv = ((v.clamp(-1, 1) + 1) * 0.5 * (ts - 1)).float()
        val = torch.clamp(torch.round(_bilinear_zero(tex, su, sv)), 0, 255)
        img = torch.where(win, val, img)
        zbuf = torch.where(win, depth, zbuf)
    return img.reshape(n, height, width).to(torch.uint8)


def make_frames(cfg: dict, seed: int, device) -> Frames:
    n = int(cfg["num_frames"])
    width, height, f = int(cfg["width"]), int(cfg["height"]), float(cfg["f"])
    g = torch.Generator(device=device).manual_seed(seed)
    textures = [make_texture(g, int(cfg["box_texture"]), device)
                for _ in BOX_FACETS]
    R, t = camera_path(g, n, device)
    images = torch.cat([render(R[i:i + VIEWS_PER_CALL],
                               t[i:i + VIEWS_PER_CALL], textures, f, width,
                               height)
                        for i in range(0, n, VIEWS_PER_CALL)])
    gravity = (R @ torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64,
                                device=device)).float()
    params = torch.tensor([f, width / 2, height / 2], dtype=torch.float32,
                          device=device).expand(n, 3).contiguous()
    return Frames(images, gravity, params, R, t)
