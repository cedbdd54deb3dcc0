"""Device-free numpy mirrors of the point-to-line error kernels.

Host code (triangulator Merge/Complete/Continue, filtering, evaluation)
scores small, data-dependent sets of observations; these numpy twins
evaluate the exact ``src/base/projection.cc:162-260`` errors on host,
batched over arbitrary observation sets.  It shares the camera-model forward code with the torch
kernels (``ops/cameras.world_to_image`` with ``xp=numpy``).
"""

from __future__ import annotations

import numpy as np

from privacy_preserving_sfm_torch.ops import cameras as cam_ops

BIG = 1e30


def world_to_image(model: str, params: np.ndarray, uv: np.ndarray):
    return cam_ops.world_to_image(model, params, uv, xp=np)


def squared_line_reprojection_error(
        lines: np.ndarray, points3d: np.ndarray, proj: np.ndarray,
        camera_model: str, camera_params: np.ndarray,
        width, height) -> np.ndarray:
    """Squared *pixel* point-to-line reprojection error.

    All leading dims broadcast; returns BIG sentinels for behind-camera /
    out-of-image observations (``projection.cc:162-203``).
    """
    lines = np.asarray(lines, float)
    points3d = np.asarray(points3d, float)
    proj = np.asarray(proj, float)
    camera_params = np.asarray(camera_params, float)

    xyz = np.einsum("...ij,...j->...i", proj[..., :, :3], points3d) \
        + proj[..., :, 3]
    z = xyz[..., 2]
    z_safe = np.where(np.abs(z) < 1e-30, 1e-30, z)
    xy = xyz[..., :2] / z_safe[..., None]

    alpha = lines[..., 0] * xy[..., 0] + lines[..., 1] * xy[..., 1] \
        + lines[..., 2]
    line_pt = xy - alpha[..., None] * lines[..., :2]

    im_proj = world_to_image(camera_model, camera_params, xy)
    im_line = world_to_image(camera_model, camera_params, line_pt)
    err = np.sum((im_proj - im_line) ** 2, axis=-1)

    in_image = ((im_proj[..., 0] >= 0) & (im_proj[..., 0] < width)
                & (im_proj[..., 1] >= 0) & (im_proj[..., 1] < height))
    valid = (z >= np.finfo(points3d.dtype).eps) & in_image
    return np.where(valid, err, BIG)


def line_angular_error(
        lines: np.ndarray, points3d: np.ndarray, proj: np.ndarray,
        camera_model: str, camera_params: np.ndarray,
        width, height) -> np.ndarray:
    """|pi/2 - angle(line normal, viewing ray)| with cheirality and image
    gating (``projection.cc:241-260``)."""
    lines = np.asarray(lines, float)
    points3d = np.asarray(points3d, float)
    proj = np.asarray(proj, float)
    camera_params = np.asarray(camera_params, float)

    line_n = lines / np.linalg.norm(lines, axis=-1, keepdims=True)
    ray = np.einsum("...ij,...j->...i", proj[..., :, :3], points3d) \
        + proj[..., :, 3]
    ray_n = ray / np.maximum(
        np.linalg.norm(ray, axis=-1, keepdims=True), 1e-30)
    cosang = np.abs(np.sum(line_n * ray_n, axis=-1))
    err = np.abs(np.pi / 2 - np.arccos(np.clip(cosang, 0.0, 1.0)))

    z = ray[..., 2]
    xy = ray[..., :2] / np.where(np.abs(z) < 1e-30, 1e-30, z)[..., None]
    im = world_to_image(camera_model, camera_params, xy)
    in_image = ((im[..., 0] >= 0) & (im[..., 0] < width)
                & (im[..., 1] >= 0) & (im[..., 1] < height))
    valid = (z >= 0) & in_image
    return np.where(valid, err, BIG)


def triangulation_angle(center1: np.ndarray, center2: np.ndarray,
                        points3d: np.ndarray) -> np.ndarray:
    """Minimum enclosing angle of the two viewing rays, min(a, pi - a)
    (``triangulation.cc:59-82``, law of cosines)."""
    center1 = np.asarray(center1, float)
    center2 = np.asarray(center2, float)
    points3d = np.asarray(points3d, float)
    baseline2 = np.sum((center1 - center2) ** 2, axis=-1)
    ray1_2 = np.sum((points3d - center1) ** 2, axis=-1)
    ray2_2 = np.sum((points3d - center2) ** 2, axis=-1)
    denom = 2.0 * np.sqrt(ray1_2 * ray2_2)
    nom = ray1_2 + ray2_2 - baseline2
    cos = np.clip(nom / np.maximum(denom, 1e-30), -1.0, 1.0)
    angle = np.abs(np.arccos(cos))
    angle = np.where(denom <= 0.0, np.zeros_like(angle), angle)
    return np.minimum(angle, np.pi - angle)
