"""Seeded multi-view datasets with gravity and calibration, the port's
``tools/synth_dataset.py`` (numpy and torch; no OpenCV).

    python -m privacy_preserving_sfm_torch.tools.synth_dataset OUTDIR \\
        [num_images] [plane|box] [SIMPLE_PINHOLE|OPENCV] [degrade]

``make_dataset`` takes the tool's arguments and defaults and draws the
tool's random stream in its order (the 1,600 px plane texture, the four
800 px box textures, then each view's centre and tilt, then the view's
degradation), so a seed gives the tool's poses, gravity, calibration and
metadata files, in its text formats.  The quaternion product and the
rotation are computed in float32, as the tool computes them (its
``lie.quat_multiply`` and ``lie.quat_to_rotmat`` calls, in float32 when
it runs as a script).  The pixels follow OpenCV's arithmetic where the tool calls
it:

* texture upsampling as ``cv2.resize(INTER_CUBIC)`` (Keys a = -0.75,
  edges replicated);
* facet sampling as ``cv2.remap(INTER_LINEAR)`` and the plane view as
  ``cv2.warpPerspective(INTER_LINEAR, BORDER_REPLICATE)`` do in OpenCV
  5: bilinear weights and sums in float32, rounded to the nearest level;
* the degradation's defocus as ``cv2.GaussianBlur`` on float32 (kernel
  size from sigma, reflect-101 border), then the tool's vignetting, gain,
  gamma and sensor noise in its order.

OpenCV's SIMD sums are not reproduced bit for bit, so a few pixels
differ by a grey level (``tests/test_torch_synth_dataset.py``
states the measured agreement).  With ``OPENCV`` the box scene is rendered
through the camera's distortion: each output pixel is undistorted with
the port's ``ops/cameras.image_to_world`` in float64 on the CPU.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from privacy_preserving_sfm_torch.ops import cameras as cam_ops
from privacy_preserving_sfm_torch.utils import png
from privacy_preserving_sfm_torch.utils.synthetic import (
    BOX_FACETS, PLANE, _pixel_grid, _quat_multiply, _resize_cubic,
)


def _make_texture(rng: np.random.Generator, tex_size: int) -> np.ndarray:
    """The tool's ``_make_texture``: a random grid at 1/8 of the size plus
    half of one at 1/32, cubic-upsampled in float32, scaled to uint8."""
    def up(n):
        grid = rng.uniform(0, 1, (n, n)).astype(np.float32)
        return _resize_cubic(grid, tex_size).astype(np.float32)

    tex = up(tex_size // 8)
    tex += 0.5 * up(tex_size // 32)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return (tex * 255).astype(np.uint8)


def _undistorted_pix_map(width: int, height: int, model: str,
                         params) -> np.ndarray:
    """(3, H, W) map: distorted output pixel -> homogeneous undistorted
    pinhole pixel, through ``image_to_world`` (view-independent)."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    pts = torch.from_numpy(np.stack([xs.ravel(), ys.ravel()], 1))
    xn = cam_ops.image_to_world(
        model, torch.as_tensor(params, dtype=torch.float64), pts).numpy()
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    pu = np.stack([xn[:, 0] * fx + cx, xn[:, 1] * fy + cy,
                   np.ones(len(xn))], 1)
    return np.ascontiguousarray(pu.T.reshape(3, height, width))


def _bilinear_u8(tex: np.ndarray, x: np.ndarray, y: np.ndarray,
                 replicate: bool) -> np.ndarray:
    """Bilinear uint8 samples of ``tex`` at float32 coordinates, weights
    and sums in float32, rounded to the nearest level; taps outside the
    texture read the nearest edge pixel (``replicate``) or 0
    (BORDER_CONSTANT).  OpenCV 5's ``remap`` and ``warpPerspective``
    interpolate so at INTER_LINEAR (OpenCV 4 rounded coordinates to
    1/32 px and weights to 15-bit fixed point)."""
    h, w = tex.shape
    # Far-outside coordinates give the same taps as the nearest of these.
    x = np.clip(np.nan_to_num(x.astype(np.float32)), -2, w + 1)
    y = np.clip(np.nan_to_num(y.astype(np.float32)), -2, h + 1)
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    t = tex.astype(np.float32)

    def tap(yy, xx):
        v = t[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        if replicate:
            return v
        return np.where((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h), v,
                        np.float32(0))

    v = ((tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx) * (1 - fy)
         + (tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx) * fy)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def _warp_perspective(tex: np.ndarray, H: np.ndarray, width: int,
                      height: int) -> np.ndarray:
    """``cv2.warpPerspective(tex, H, (width, height), INTER_LINEAR,
    BORDER_REPLICATE)``: each output pixel maps through H^-1 (float64)."""
    M = np.linalg.inv(H)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    W = M[2, 0] * xs + M[2, 1] * ys + M[2, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        x = (M[0, 0] * xs + M[0, 1] * ys + M[0, 2]) / W
        y = (M[1, 0] * xs + M[1, 1] * ys + M[1, 2]) / W
    return _bilinear_u8(tex, x, y, replicate=True)


def _render_box_view(K, R, t, textures, width: int, height: int,
                     pix=None) -> np.ndarray:
    """Composite the BOX_FACETS by nearest positive depth on a featureless
    background.  ``pix``: (3, H, W) homogeneous pinhole pixel of each
    output pixel (the undistorted map for a distorted camera; the pixel
    grid when None)."""
    if pix is None:
        pix = _pixel_grid(width, height)
    img = np.full((height, width), 96, np.uint8)
    zbuf = np.full((height, width), np.inf)
    for (O, A, B), tex in zip(BOX_FACETS, textures):
        ts = tex.shape[0]
        Hm = K @ np.column_stack([R @ A, R @ B, R @ O + t])
        uvw = np.einsum("ij,jhw->ihw", np.linalg.inv(Hm), pix)
        with np.errstate(divide="ignore", invalid="ignore"):
            u = uvw[0] / uvw[2]
            v = uvw[1] / uvw[2]
        depth = (R[2] @ O + t[2]) + u * (R[2] @ A) + v * (R[2] @ B)
        win = ((np.abs(u) <= 1) & (np.abs(v) <= 1) & (depth > 0.1)
               & (depth < zbuf))
        # cv2.remap(tex, map_x, map_y, INTER_LINEAR) at the facet's pixels.
        img[win] = _bilinear_u8(
            tex, ((u[win] + 1) * 0.5 * (ts - 1)).astype(np.float32),
            ((v[win] + 1) * 0.5 * (ts - 1)).astype(np.float32),
            replicate=False)
        zbuf[win] = depth[win]
    return img


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` on float32: kernel size
    cvRound(8 sigma + 1) | 1, float32 taps, separable, reflect-101."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    k = (k / k.sum()).astype(np.float32)
    r = n // 2
    h, w = img.shape
    p = np.pad(img, ((0, 0), (r, r)), mode="reflect")
    rows = k[r] * p[:, r:r + w]
    for j in range(1, r + 1):
        rows = rows + k[r + j] * (p[:, r - j:r - j + w]
                                  + p[:, r + j:r + j + w])
    p = np.pad(rows, ((r, r), (0, 0)), mode="reflect")
    out = k[r] * p[r:r + h]
    for j in range(1, r + 1):
        out = out + k[r + j] * (p[r - j:r - j + h] + p[r + j:r + j + h])
    return out.astype(np.float32)


def _degrade(img: np.ndarray, rng: np.random.Generator,
             level: float) -> np.ndarray:
    """The tool's photometric degradation (defocus sigma ~ U[0, 0.8
    level] px, vignetting up to 25 % level at the corners, gain and gamma
    jitter, sensor noise of 4 level grey levels); level 1 is a plausible
    consumer camera."""
    h, w = img.shape[:2]
    out = img.astype(np.float32) / 255.0
    sig = rng.uniform(0.0, 0.8 * level)
    if sig > 0.05:
        out = _gaussian_blur(out, sig)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = (((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2) / 2
    out = out * (1.0 - 0.25 * level * r2)
    gain = rng.uniform(1.0 / (1 + 0.5 * level), 1 + 0.5 * level)
    gamma = rng.uniform(1.0 / (1 + 0.3 * level), 1 + 0.3 * level)
    out = np.clip(gain * np.clip(out, 0, 1) ** gamma, 0, 1)
    out = out + rng.standard_normal(out.shape).astype(np.float32) \
        * (4.0 * level / 255.0)
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)


def _quat_to_rotmat32(q: np.ndarray) -> np.ndarray:
    """The reference's ``lie.quat_to_rotmat`` (no normalization), float32."""
    w, x, y, z = q.astype(np.float32)
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return np.array([[ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)],
                     [2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)],
                     [2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz]],
                    np.float32)


def make_dataset(outdir: str, num_images: int = 8, width=640, height=480,
                 f=400.0, seed=0, scene: str = "plane",
                 camera: str = "SIMPLE_PINHOLE", degrade: float = 0.0):
    """Render ``num_images`` views of ``scene`` ("plane" or "box") into
    ``outdir``: ``img%03d.png`` with ``.gravity.txt`` and
    ``.camera_model.txt`` sidecars, ``gt_poses.txt`` (``# name qw qx qy
    qz tx ty tz``, world -> camera) and ``meta.json``.  ``camera``
    "OPENCV" (box only) renders through barrel and tangential distortion;
    ``degrade`` > 0 applies ``_degrade`` at that level.  Returns
    ``outdir``."""
    if camera == "SIMPLE_PINHOLE":
        cam_params = [f, width / 2, height / 2]
    elif camera == "OPENCV":
        cam_params = [f, f, width / 2, height / 2,
                      -0.16, 0.035, 1e-3, -5e-4]
        if scene != "box":
            raise SystemExit("OPENCV rendering implemented for scene=box")
    else:
        raise SystemExit(f"unsupported camera {camera}")
    dist_pix = _undistorted_pix_map(width, height, camera, cam_params) \
        if camera != "SIMPLE_PINHOLE" else None

    rng = np.random.default_rng(seed)
    os.makedirs(outdir, exist_ok=True)
    tex_size = 1600
    tex = _make_texture(rng, tex_size)
    box_textures = [_make_texture(rng, 800) for _ in BOX_FACETS] \
        if scene == "box" else None

    S, z0 = PLANE["plane_S"], PLANE["plane_z0"]
    ax_c, ay_c = PLANE["plane_ax"], PLANE["plane_ay"]
    M = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [ax_c, ay_c, z0]])
    T = np.array([[2 * S / tex_size, 0, -S], [0, 2 * S / tex_size, -S],
                  [0, 0, 1.0]])
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])
    spread = 10.0
    gt_lines = []
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
        q = _quat_multiply(q_tilt.astype(np.float32),
                           q_yaw.astype(np.float32))
        R = _quat_to_rotmat32(q)
        t = -R @ C
        if scene == "box":
            img = _render_box_view(K, R, t, box_textures, width, height,
                                   pix=dist_pix)
        else:
            H = K @ (R @ M + t[:, None]
                     @ np.array([[0.0, 0.0, 1.0]])) @ T
            img = _warp_perspective(tex, H, width, height)
        if degrade > 0:
            img = _degrade(img, rng, degrade)
        name = f"img{i:03d}.png"
        png.write_png_gray(os.path.join(outdir, name), img)
        g = R @ np.array([0.0, 1.0, 0.0])
        with open(os.path.join(outdir, name + ".gravity.txt"), "w") as fo:
            fo.write(f"{g[0]} {g[1]} {g[2]}\n")
        with open(os.path.join(outdir, name + ".camera_model.txt"),
                  "w") as fo:
            fo.write(camera + ", "
                     + ", ".join(str(p) for p in cam_params) + "\n")
        gt_lines.append(
            f"{name} " + " ".join(repr(float(v)) for v in q) + " "
            + " ".join(repr(float(v)) for v in t))

    with open(os.path.join(outdir, "gt_poses.txt"), "w") as fo:
        fo.write("# name qw qx qy qz tx ty tz\n")
        fo.write("\n".join(gt_lines) + "\n")
    with open(os.path.join(outdir, "meta.json"), "w") as fo:
        json.dump({"f": f, "width": width, "height": height,
                   "scene": scene, "camera": camera,
                   "camera_params": list(map(float, cam_params)),
                   "plane_S": S, "plane_z0": z0,
                   "plane_ax": ax_c, "plane_ay": ay_c,
                   "degrade": degrade,
                   "tex_size": tex_size}, fo)
    return outdir


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else "ppsfm_synth"
    n = int(argv[1]) if len(argv) > 1 else 8
    kind = argv[2] if len(argv) > 2 else "plane"
    cam = argv[3] if len(argv) > 3 else "SIMPLE_PINHOLE"
    deg = float(argv[4]) if len(argv) > 4 else 0.0
    make_dataset(out, n, scene=kind, camera=cam, degrade=deg)
    print(f"wrote {n} {kind}/{cam} images to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
