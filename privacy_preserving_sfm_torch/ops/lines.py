"""Point-to-line residual of the line bundle adjustment (torch).

Port of ``privacy_preserving_sfm_tpu/ops/lines.py:86-95, 161-185``.  The
privacy-preserving representation stores, per keypoint, a 2D line through
the normalized image point, normalized so that ``||l[:2]|| = 1`` and
``l . p_hom`` is a signed point-to-line distance.  BA cost: reference
``src/base/cost_functions.h:62-100``.
"""

from __future__ import annotations

import torch

from privacy_preserving_sfm_torch.ops import cameras as cam_ops
from privacy_preserving_sfm_torch.ops import lie


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
