"""Device-free numpy mirror of the squared point-to-line error.

Host code (filtering, evaluation) scores small, data-dependent sets of
observations; this numpy twin evaluates the exact
``src/base/projection.cc:162-203`` error on host, batched over arbitrary
observation sets.  It shares the camera-model forward code with the torch
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
