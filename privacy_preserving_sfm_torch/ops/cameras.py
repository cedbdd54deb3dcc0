"""Camera model zoo: ``WorldToImage`` and ``ImageToWorld`` of all 11 models.

Port of ``privacy_preserving_sfm_tpu/ops/cameras.py:139-345`` (reference
``src/base/camera_models.h:117-129``).  Parameter layouts are identical
to the reference so text models interoperate:

  SIMPLE_PINHOLE        f, cx, cy
  PINHOLE               fx, fy, cx, cy
  SIMPLE_RADIAL         f, cx, cy, k
  RADIAL                f, cx, cy, k1, k2
  OPENCV                fx, fy, cx, cy, k1, k2, p1, p2
  OPENCV_FISHEYE        fx, fy, cx, cy, k1, k2, k3, k4
  FULL_OPENCV           fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6
  FOV                   fx, fy, cx, cy, omega
  SIMPLE_RADIAL_FISHEYE f, cx, cy, k
  RADIAL_FISHEYE        f, cx, cy, k1, k2
  THIN_PRISM_FISHEYE    fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, sx1, sy1

Every function is written once against an array namespace ``xp``: the
default ``torch`` runs on tensors (and under ``torch.func`` transforms),
and ``xp=numpy`` is the device-free numpy twin the host code uses
(``ops/lines_np.py``).  The namespaces share every name used here
(``sqrt``, ``arctan``, ``tan``, ``where``, ``stack(..., axis=)``,
``ones_like``, ``zeros_like``, ``finfo``); clamps use the ``.clip`` method
both array types have.  ``image_to_world`` (torch only) inverts the
distortion with a fixed 20-step Newton solve whose 2x2 Jacobian comes
from two forward-mode ``torch.func.jvp`` evaluations, as the reference
takes it from forward-mode autodiff.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Distortion functions: extra_params, (u, v) -> (du, dv), all elementwise.
# ---------------------------------------------------------------------------


def _distort_none(p, u, v, xp=torch):
    return xp.zeros_like(u), xp.zeros_like(v)


def _distort_simple_radial(p, u, v, xp=torch):
    k = p[..., 0]
    r2 = u * u + v * v
    radial = k * r2
    return u * radial, v * radial


def _distort_radial(p, u, v, xp=torch):
    k1, k2 = p[..., 0], p[..., 1]
    r2 = u * u + v * v
    radial = k1 * r2 + k2 * r2 * r2
    return u * radial, v * radial


def _distort_opencv(p, u, v, xp=torch):
    k1, k2, p1, p2 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    du = u * radial + 2 * p1 * uv + p2 * (r2 + 2 * u2)
    dv = v * radial + 2 * p2 * uv + p1 * (r2 + 2 * v2)
    return du, dv


def _distort_full_opencv(p, u, v, xp=torch):
    k1, k2, p1, p2 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    k3, k4, k5, k6 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
    du = u * radial + 2 * p1 * uv + p2 * (r2 + 2 * u2) - u
    dv = v * radial + 2 * p2 * uv + p1 * (r2 + 2 * v2) - v
    return du, dv


def _fisheye_thetad(p_terms, u, v, xp=torch):
    """Common fisheye mapping: theta-polynomial radial distortion.

    p_terms is a tuple of odd-power theta coefficients (k1, k2, ...) applied
    as thetad = theta * (1 + k1 th^2 + k2 th^4 + ...).
    """
    eps = xp.finfo(u.dtype).eps
    r = xp.sqrt(u * u + v * v)
    r_safe = r.clip(min=eps)
    theta = xp.arctan(r_safe)
    th2 = theta * theta
    poly = xp.ones_like(theta)
    acc = xp.ones_like(theta)
    for k in p_terms:
        acc = acc * th2
        poly = poly + k * acc
    thetad = theta * poly
    scale = xp.where(r > eps, thetad / r_safe, xp.ones_like(r))
    return u * scale - u, v * scale - v


def _distort_opencv_fisheye(p, u, v, xp=torch):
    return _fisheye_thetad((p[..., 0], p[..., 1], p[..., 2], p[..., 3]), u, v, xp)


def _distort_simple_radial_fisheye(p, u, v, xp=torch):
    return _fisheye_thetad((p[..., 0],), u, v, xp)


def _distort_radial_fisheye(p, u, v, xp=torch):
    return _fisheye_thetad((p[..., 0], p[..., 1]), u, v, xp)


def _distort_fov(p, u, v, xp=torch):
    # FOV model (reference camera_models.h:1136-1173), Taylor fallbacks for
    # small omega / small radius included for the same numerical behavior.
    omega = p[..., 0]
    eps = 1e-4
    radius2 = u * u + v * v
    omega2 = omega * omega
    tan_half = xp.tan(omega / 2)
    radius = xp.sqrt(radius2.clip(min=xp.finfo(u.dtype).tiny))

    factor_generic = xp.arctan(radius * 2 * tan_half) / (radius * omega)
    factor_small_omega = omega2 * radius2 / 3 - omega2 / 12 + 1
    factor_small_radius = (-2 * tan_half * (4 * radius2 * tan_half * tan_half - 3)) / (3 * omega)

    factor = xp.where(
        omega2 < eps,
        factor_small_omega,
        xp.where(radius2 < eps, factor_small_radius, factor_generic),
    )
    # NOTE: FOV "distortion" returns the distorted point directly (u*factor),
    # not a delta — mirrored in world_to_image_uv below.
    return u * factor, v * factor


def _undistort_fov(p, u, v, xp=torch):
    omega = p[..., 0]
    eps = 1e-4
    radius2 = u * u + v * v
    omega2 = omega * omega
    tan_half = xp.tan(omega / 2)
    radius = xp.sqrt(radius2.clip(min=xp.finfo(u.dtype).tiny))

    factor_generic = xp.tan(radius * omega) / (radius * 2 * tan_half)
    factor_small_omega = omega2 * radius2 / 3 - omega2 / 12 + 1
    factor_small_radius = omega * (omega * omega * radius2 + 3) / (6 * tan_half)

    factor = xp.where(
        omega2 < eps,
        factor_small_omega,
        xp.where(radius2 < eps, factor_small_radius, factor_generic),
    )
    return u * factor, v * factor


def _distort_thin_prism_fisheye(p, u, v, xp=torch):
    k1, k2, p1, p2 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    k3, k4, sx1, sy1 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    r4 = r2 * r2
    r6 = r4 * r2
    r8 = r4 * r4
    radial = k1 * r2 + k2 * r4 + k3 * r6 + k4 * r8
    du = u * radial + 2 * p1 * uv + p2 * (r2 + 2 * u2) + sx1 * r2
    dv = v * radial + 2 * p2 * uv + p1 * (r2 + 2 * v2) + sy1 * r2
    return du, dv


# ---------------------------------------------------------------------------
# Model registry
# ---------------------------------------------------------------------------


class CameraModelSpec(NamedTuple):
    model_id: int
    name: str
    num_params: int
    focal_idxs: Tuple[int, ...]
    principal_idxs: Tuple[int, ...]
    extra_idxs: Tuple[int, ...]
    distort: Callable  # (extra_params, u, v, xp) -> (du, dv)
    fisheye_pre: bool  # THIN_PRISM: atan(r)/r pre-warp before distortion
    fov_style: bool  # FOV: distort returns the mapped point


MODELS: Dict[str, CameraModelSpec] = {}
MODEL_BY_ID: Dict[int, CameraModelSpec] = {}


def _register(model_id, name, num_params, focal, principal, extra, distort,
              fisheye_pre=False, fov_style=False):
    spec = CameraModelSpec(model_id, name, num_params, tuple(focal),
                           tuple(principal), tuple(extra), distort,
                           fisheye_pre, fov_style)
    MODELS[name] = spec
    MODEL_BY_ID[model_id] = spec


_register(0, "SIMPLE_PINHOLE", 3, (0,), (1, 2), (), _distort_none)
_register(1, "PINHOLE", 4, (0, 1), (2, 3), (), _distort_none)
_register(2, "SIMPLE_RADIAL", 4, (0,), (1, 2), (3,), _distort_simple_radial)
_register(3, "RADIAL", 5, (0,), (1, 2), (3, 4), _distort_radial)
_register(4, "OPENCV", 8, (0, 1), (2, 3), (4, 5, 6, 7), _distort_opencv)
_register(5, "OPENCV_FISHEYE", 8, (0, 1), (2, 3), (4, 5, 6, 7), _distort_opencv_fisheye)
_register(6, "FULL_OPENCV", 12, (0, 1), (2, 3), tuple(range(4, 12)), _distort_full_opencv)
_register(7, "FOV", 5, (0, 1), (2, 3), (4,), _distort_fov, fov_style=True)
_register(8, "SIMPLE_RADIAL_FISHEYE", 4, (0,), (1, 2), (3,), _distort_simple_radial_fisheye)
_register(9, "RADIAL_FISHEYE", 5, (0,), (1, 2), (3, 4), _distort_radial_fisheye)
_register(10, "THIN_PRISM_FISHEYE", 12, (0, 1), (2, 3), tuple(range(4, 12)),
          _distort_thin_prism_fisheye, fisheye_pre=True)


def _split_params(spec: CameraModelSpec, params, xp=torch):
    f = xp.stack([params[..., i] for i in spec.focal_idxs], axis=-1)
    if len(spec.focal_idxs) == 1:
        fx = fy = f[..., 0]
    else:
        fx, fy = f[..., 0], f[..., 1]
    cx = params[..., spec.principal_idxs[0]]
    cy = params[..., spec.principal_idxs[1]]
    if spec.extra_idxs:
        lo, hi = spec.extra_idxs[0], spec.extra_idxs[-1] + 1
        extra = params[..., lo:hi]
    else:
        extra = params[..., :0]
    return fx, fy, cx, cy, extra


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def world_to_image_uv(model: str, params, u, v, xp=torch):
    """Component-wise ``WorldToImage``: (u, v) arrays -> (x_pix, y_pix).

    ``params`` must broadcast against ``u``/``v`` after its last axis is
    consumed by the parameter split.
    """
    spec = MODELS[model]
    fx, fy, cx, cy, extra = _split_params(spec, params, xp)

    if spec.fisheye_pre:  # THIN_PRISM_FISHEYE: pre-warp to theta coords
        eps = xp.finfo(u.dtype).eps
        r = xp.sqrt(u * u + v * v)
        r_safe = r.clip(min=eps)
        theta = xp.arctan(r_safe)
        scale = xp.where(r > eps, theta / r_safe, xp.ones_like(r))
        u, v = u * scale, v * scale

    if spec.fov_style:
        x, y = spec.distort(extra, u, v, xp)
    else:
        du, dv = spec.distort(extra, u, v, xp)
        x, y = u + du, v + dv
    return fx * x + cx, fy * y + cy


def world_to_image(model: str, params, uv, xp=torch):
    """Normalized camera coords (..., 2) -> pixel coords (..., 2).

    Semantics of ``CameraModel::WorldToImage`` for every model in the zoo.
    Pass ``xp=numpy`` for a device-free host evaluation.
    """
    x, y = world_to_image_uv(model, params, uv[..., 0], uv[..., 1], xp)
    return xp.stack([x, y], axis=-1)


_NEWTON_ITERS = 20


def _newton_undistort(distort_fn, extra: torch.Tensor,
                      xy: torch.Tensor) -> torch.Tensor:
    """Invert p -> p + distort(p) with a fixed ``_NEWTON_ITERS`` Newton loop
    (reference ``camera_models.h:545-588``, which uses 100 central-difference
    steps); the 2x2 Jacobian comes from two forward-mode evaluations."""

    def residual(p):
        du, dv = distort_fn(extra, p[..., 0], p[..., 1])
        return p + torch.stack([du, dv], dim=-1) - xy

    e0 = torch.zeros_like(xy)
    e0[..., 0] = 1.0
    e1 = torch.zeros_like(xy)
    e1[..., 1] = 1.0
    p = xy
    for _ in range(_NEWTON_ITERS):
        r, j0 = torch.func.jvp(residual, (p,), (e0,))
        _, j1 = torch.func.jvp(residual, (p,), (e1,))
        a, c = j0[..., 0], j0[..., 1]  # d r / d p0
        b, d = j1[..., 0], j1[..., 1]  # d r / d p1
        det = a * d - b * c
        det = torch.where(torch.abs(det) < 1e-20, torch.ones_like(det), det)
        step0 = (d * r[..., 0] - b * r[..., 1]) / det
        step1 = (-c * r[..., 0] + a * r[..., 1]) / det
        p = p - torch.stack([step0, step1], dim=-1)
    return p


def image_to_world(model: str, params: torch.Tensor,
                   xy: torch.Tensor) -> torch.Tensor:
    """Pixel coords (..., 2) -> normalized camera coords (..., 2).

    Semantics of ``CameraModel::ImageToWorld`` for every model in the zoo.
    """
    spec = MODELS[model]
    fx, fy, cx, cy, extra = _split_params(spec, params)
    u = (xy[..., 0] - cx) / fx
    v = (xy[..., 1] - cy) / fy

    if spec.fov_style:
        u, v = _undistort_fov(extra, u, v)
        return torch.stack([u, v], dim=-1)

    if spec.extra_idxs:
        uv = _newton_undistort(spec.distort, extra,
                               torch.stack([u, v], dim=-1))
        u, v = uv[..., 0], uv[..., 1]

    if spec.fisheye_pre:  # THIN_PRISM_FISHEYE: undo the theta pre-warp
        eps = torch.finfo(xy.dtype).eps
        theta = torch.sqrt(u * u + v * v)
        tct = theta * torch.cos(theta)
        scale = torch.where(tct > eps, torch.sin(theta) / tct.clamp(min=eps),
                            torch.ones_like(theta))
        u, v = u * scale, v * scale

    return torch.stack([u, v], dim=-1)


def mean_focal_length(model: str, params: torch.Tensor) -> torch.Tensor:
    spec = MODELS[model]
    f = torch.stack([params[..., i] for i in spec.focal_idxs], dim=-1)
    return torch.mean(f, dim=-1)


def image_to_world_threshold(model: str, params: torch.Tensor,
                             threshold) -> torch.Tensor:
    """Pixel-space threshold -> normalized-plane threshold: divided by the
    mean focal length (``BaseCameraModel::ImageToWorldThreshold``,
    ``camera_models.h:533-543``)."""
    return threshold / mean_focal_length(model, params)


def has_bogus_params(model: str, params, width, height,
                     min_focal_ratio: float, max_focal_ratio: float,
                     max_extra_param: float) -> bool:
    """Host-side sanity check of camera parameters: a focal ratio outside
    [min, max] of the larger image side, a principal point outside the
    image or an extra parameter above ``max_extra_param`` in magnitude
    (``HasBogusFocalLength`` / ``HasBogusPrincipalPoint`` /
    ``HasBogusExtraParams``, ``camera_models.h:478-531``)."""
    spec = MODELS[model]
    p = np.asarray(params)
    max_dim = max(width, height)
    for i in spec.focal_idxs:
        ratio = p[i] / max_dim
        if ratio < min_focal_ratio or ratio > max_focal_ratio:
            return True
    cx, cy = p[spec.principal_idxs[0]], p[spec.principal_idxs[1]]
    if not (0 <= cx <= width and 0 <= cy <= height):
        return True
    return any(abs(p[i]) > max_extra_param for i in spec.extra_idxs)
