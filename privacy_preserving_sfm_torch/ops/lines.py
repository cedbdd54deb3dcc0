"""Feature-line lifting and point-to-line residual kernels (torch).

Port of ``privacy_preserving_sfm_tpu/ops/lines.py``.  The
privacy-preserving representation stores, per keypoint, a 2D line through
the normalized image point, normalized so that ``||l[:2]|| = 1`` and
``l . p_hom`` is a signed point-to-line distance: ``l = g x x_hat`` for a
gravity-aligned line, ``l = r x x_hat`` for a random direction ``r``
(reference ``src/feature/extraction.cc:437-504``).  BA cost: reference
``src/base/cost_functions.h:62-100``; errors ``src/base/projection.cc:
162-260``, with the reference's early-return sentinels as ``BIG``.
"""

from __future__ import annotations

import torch

from privacy_preserving_sfm_torch.ops import cameras as cam_ops
from privacy_preserving_sfm_torch.ops import lie

# Sentinel matching the reference's numeric_limits<double>::max() gating.
BIG = 1e30


def normalize_lines(lines: torch.Tensor) -> torch.Tensor:
    """Normalize homogeneous 2D lines so ||(a, b)|| = 1. (..., 3)->(..., 3).

    Mirrors ``extraction.cc:499-503`` and the DB read path
    ``database.cc:55-74``.
    """
    n = torch.sqrt(torch.sum(lines[..., :2] * lines[..., :2], dim=-1,
                             keepdim=True))
    return lines / torch.clamp(n, min=1e-12)


def lift_with_directions(normalized_points: torch.Tensor,
                         gravity: torch.Tensor, aligned_mask: torch.Tensor,
                         rnd: torch.Tensor) -> torch.Tensor:
    """Lines through normalized points (..., N, 2): ``g x x_hom`` where
    ``aligned_mask`` (..., N) is True, else ``r x x_hom`` with ``r`` the
    row of ``rnd`` (..., N, 3) (standard normal draws) made unit length.
    ``gravity`` is (..., 3).  Returns (..., N, 3) with ||l[:2]|| = 1."""
    x_hom = torch.cat([normalized_points,
                       torch.ones_like(normalized_points[..., :1])], dim=-1)
    rnd = rnd / torch.sqrt(torch.sum(rnd * rnd, dim=-1, keepdim=True))
    g = gravity.to(normalized_points.dtype)[..., None, :].expand_as(x_hom)
    direction = torch.where(aligned_mask[..., None], g, rnd)
    return normalize_lines(torch.linalg.cross(direction, x_hom, dim=-1))


def require_cpu_generator(generator: torch.Generator) -> torch.Generator:
    """``generator`` itself, if it lives on the CPU; else a ValueError.

    The front end draws its aligned split and line directions on the CPU
    for every device and moves the draws to the features' device, so the
    card and the CPU write the same database for the same seed (a CUDA
    generator is another random stream, not the CPU's rounded)."""
    if generator.device.type != "cpu":
        raise ValueError(
            "the line lift draws from CPU torch.Generators on every device "
            f"(one on {generator.device} gives another random stream); "
            "pass torch.Generator() and the draws move to the device")
    return generator


def lift_keypoints_to_lines(normalized_points: torch.Tensor,
                            gravity: torch.Tensor,
                            aligned_mask: torch.Tensor,
                            generator: torch.Generator) -> torch.Tensor:
    """Lift normalized image points (..., N, 2) to privacy-preserving lines.

    Semantics of ``LineFeatureWriterThread`` (``extraction.cc:476-504``);
    the random directions are standard normal draws from ``generator``,
    which must live on the CPU (``require_cpu_generator``), moved to the
    points' device.
    """
    rnd = torch.randn(normalized_points.shape[:-1] + (3,),
                      generator=require_cpu_generator(generator),
                      dtype=normalized_points.dtype)
    return lift_with_directions(normalized_points, gravity, aligned_mask,
                                rnd.to(normalized_points.device))


def project_points(proj: torch.Tensor, points3d: torch.Tensor):
    """Apply 3x4 projection(s): returns (normalized_xy, depth z).

    proj: (..., 3, 4), points3d: (..., 3) -> ((..., 2), (...,)).
    """
    xyz = torch.sum(proj[..., :, :3] * points3d[..., None, :], dim=-1) \
        + proj[..., :, 3]
    z = xyz[..., 2]
    z_safe = torch.where(z.abs() < 1e-30, 1e-30, z)
    return xyz[..., :2] / z_safe[..., None], z


def _in_image(im: torch.Tensor, width, height) -> torch.Tensor:
    return ((im[..., 0] >= 0) & (im[..., 0] < width)
            & (im[..., 1] >= 0) & (im[..., 1] < height))


def squared_line_reprojection_error(lines, points3d, proj, camera_model: str,
                                    camera_params, width, height
                                    ) -> torch.Tensor:
    """Squared *pixel* point-to-line reprojection error
    (``CalculateSquaredLineReprojectionError``, ``projection.cc:162-203``):
    project X to the normalized plane, take the closest point on the line
    there, push both through WorldToImage and return their squared pixel
    distance; BIG when the point is behind the camera or projects outside
    the image."""
    xy, z = project_points(proj, points3d)
    line_pt = closest_point_on_line(lines, xy)
    im_proj = cam_ops.world_to_image(camera_model, camera_params, xy)
    im_line = cam_ops.world_to_image(camera_model, camera_params, line_pt)
    err = torch.sum((im_proj - im_line) ** 2, dim=-1)
    valid = (z >= torch.finfo(points3d.dtype).eps) & _in_image(
        im_proj, width, height)
    return torch.where(valid, err, BIG)


def line_angular_error(lines, points3d, proj, camera_model: str,
                       camera_params, width, height) -> torch.Tensor:
    """|pi/2 - angle(line normal, viewing ray)| with cheirality and image
    gating (``CalculateNormalizedLineAngularError``,
    ``projection.cc:241-260``)."""
    line_n = lines / torch.linalg.vector_norm(lines, dim=-1, keepdim=True)
    ray = torch.sum(proj[..., :, :3] * points3d[..., None, :], dim=-1) \
        + proj[..., :, 3]
    ray_n = ray / torch.linalg.vector_norm(ray, dim=-1,
                                           keepdim=True).clamp_min(1e-30)
    cosang = torch.sum(line_n * ray_n, dim=-1).abs()
    err = (torch.pi / 2 - torch.arccos(cosang.clamp(0.0, 1.0))).abs()
    z = ray[..., 2]
    xy = ray[..., :2] / torch.where(z.abs() < 1e-30, 1e-30, z)[..., None]
    im = cam_ops.world_to_image(camera_model, camera_params, xy)
    valid = (z >= 0) & _in_image(im, width, height)
    return torch.where(valid, err, BIG)


def closest_point_on_line(lines: torch.Tensor,
                          pts: torch.Tensor) -> torch.Tensor:
    """Closest point to ``pts`` on normalized line(s). (...,3),(...,2)->(...,2).

    ``p - (l . p_hom) * (a, b)`` — valid because ||(a,b)|| = 1
    (``cost_functions.h:77-82``).
    """
    alpha = lines[..., 0] * pts[..., 0] + lines[..., 1] * pts[..., 1] + lines[..., 2]
    return pts - alpha[..., None] * lines[..., :2]


def line_ba_residual(
    lines: torch.Tensor,
    points3d: torch.Tensor,
    qvec: torch.Tensor,
    tvec: torch.Tensor,
    camera_model: str,
    camera_params: torch.Tensor,
) -> torch.Tensor:
    """2-vector pixel residual of the line BA cost (differentiable).

    Twin of ``BundleAdjustmentLineCostFunction`` (``cost_functions.h:62-100``):
    rotate+translate, project, find closest point on the line in the
    normalized plane, distort both points, residual = pixel difference.
    No gating — masking is the caller's job.
    """
    xyz = lie.quat_rotate(qvec, points3d) + tvec
    z = xyz[..., 2]
    xy = xyz[..., :2] / torch.where(z.abs() < 1e-30, 1e-30, z)[..., None]
    line_pt = closest_point_on_line(lines, xy)
    im_proj = cam_ops.world_to_image(camera_model, camera_params, xy)
    im_line = cam_ops.world_to_image(camera_model, camera_params, line_pt)
    return im_proj - im_line
