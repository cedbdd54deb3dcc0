"""Feature extraction: image -> SIFT -> privacy line lift (torch).

Port of ``privacy_preserving_sfm_tpu/features/extraction.py``, the twin of
the reference's extraction pipeline and ``LineFeatureWriterThread``
(``src/feature/extraction.cc``): read the image and its sidecars
(``<image>.gravity.txt``, ``.camera_model.txt``, ``.gps.txt``,
``.mask.png``; ``image_reader.cc:42-50, 206-259``), resize to
``max_image_size``, extract SIFT, pick exactly ``aligned_line_ratio`` of
the keypoints as gravity-aligned (shuffled split, ``extraction.cc:453-458``),
lift every keypoint to a line through its normalized image point
(``extraction.cc:476-504``) and drop the keypoint positions: only
descriptors, lines, aligned flags and gravity leave this module.

Images are read with PIL where it is installed, as the reference does;
without PIL, PNG files go through ``utils/png.py`` and any other format
raises.  Random draws come from a CPU ``torch.Generator`` per image on
every device, so the card writes the CPU's split and line directions; the
core, ``lift_features_with_draws``, takes the draws as tensors.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from privacy_preserving_sfm_torch.features import sift as sift_mod
from privacy_preserving_sfm_torch.ops import cameras as cam_ops
from privacy_preserving_sfm_torch.ops import lines as line_ops
from privacy_preserving_sfm_torch.utils import png


class LiftedFeatures(NamedTuple):
    """Per-image privacy-preserving feature sets (the DB row contents),
    with a leading batch dimension."""

    descriptors: torch.Tensor  # (B, K, 128) uint8
    lines: torch.Tensor  # (B, K, 3) normalized lines
    aligned: torch.Tensor  # (B, K) bool
    valid: torch.Tensor  # (B, K) bool
    gravity: torch.Tensor  # (B, 3)


# ---------------------------------------------------------------------------
# Host IO
# ---------------------------------------------------------------------------


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def load_image_grayscale_u8(path: str) -> np.ndarray:
    """(H, W) uint8 grayscale of an image file (PIL's ``convert("L")``)."""
    Image = _pil_image()
    if Image is not None:
        with Image.open(path) as im:
            return np.asarray(im.convert("L"), dtype=np.uint8)
    if path.lower().endswith(".png"):
        return png.read_png_gray(path)
    raise RuntimeError(f"{path}: reading this format needs PIL, which is "
                       "not installed (PNG files are read without it)")


def load_image_grayscale(path: str) -> np.ndarray:
    """(H, W) float32 grayscale in [0, 1]."""
    return load_image_grayscale_u8(path).astype(np.float32) / 255.0


def read_gravity_file(image_path: str) -> Optional[np.ndarray]:
    """``<image>.gravity.txt`` (3 floats), or None
    (``image_reader.cc:206-216``)."""
    path = image_path + ".gravity.txt"
    if not os.path.exists(path):
        return None
    vals = np.loadtxt(path).reshape(-1)
    if vals.shape[0] != 3:
        raise ValueError(f"bad gravity file {path}")
    return vals.astype(np.float64)


def read_camera_model_file(image_path: str):
    """``<image>.camera_model.txt``: (model name, params) or None
    (``image_reader.cc:236-247``)."""
    path = image_path + ".camera_model.txt"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        content = f.read().strip()
    parts = [p.strip() for p in content.replace("\n", ",").split(",")
             if p.strip()]
    return parts[0].upper(), np.asarray([float(p) for p in parts[1:]],
                                        dtype=np.float64)


def read_exif_gps(image_path: str) -> Optional[np.ndarray]:
    """GPS position (lat deg, lon deg, alt m) from a ``<image>.gps.txt``
    sidecar or the EXIF GPS block, or None (``image_reader.cc:252-259``).
    Without PIL only the sidecar is read."""
    sidecar = image_path + ".gps.txt"
    if os.path.exists(sidecar):
        vals = np.loadtxt(sidecar).reshape(-1)
        if vals.shape[0] != 3:
            raise ValueError(f"bad gps file {sidecar}")
        return vals.astype(np.float64)
    try:
        from PIL import ExifTags, Image

        with Image.open(image_path) as im:
            gps = im.getexif().get_ifd(ExifTags.IFD.GPSInfo)
    except Exception:  # no PIL, no EXIF, unreadable: no prior
        return None
    if not gps:
        return None

    def dms(vals, ref, neg_ref):
        d = float(vals[0]) + float(vals[1]) / 60 + float(vals[2]) / 3600
        return -d if ref == neg_ref else d

    try:
        lat = dms(gps[2], gps.get(1, "N"), "S")
        lon = dms(gps[4], gps.get(3, "E"), "W")
        alt = float(gps.get(6, 0.0))
        if gps.get(5, 0) == 1:  # below sea level
            alt = -alt
        return np.asarray([lat, lon, alt], np.float64)
    except (KeyError, IndexError, TypeError):
        return None


def read_mask(image_path: str) -> Optional[np.ndarray]:
    """``<image>.mask.png`` as bool (True = keep), or None
    (``image_reader.cc:42-50``)."""
    path = image_path + ".mask.png"
    if not os.path.exists(path):
        return None
    return load_image_grayscale_u8(path) > 0


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) float32 weights of an antialiased linear resize along
    one axis: the triangle kernel widened by the downscale factor, each
    output's weights normalized to 1 (the formulas of
    the reference's ``scale_and_translate``, computed in float64)."""
    inv = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(inv, 1.0)
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.from_numpy(np.where(inside[None, :], w, 0.0)
                            .astype(np.float32))


def resize_to_max(image: np.ndarray, max_size: int):
    """Downscale so max(H, W) <= max_size; returns (image, scale factor).

    Antialiased bilinear, as the reference's bilinear resize: one
    weight matrix per axis, contracted in float32; uint8 in, uint8 out
    (rounded half to even, clipped).  Camera parameters scale by the same
    factor (``extraction.cc:187-210``).
    """
    h, w = image.shape
    if max(h, w) <= max_size:
        return image, 1.0
    scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = torch.from_numpy(np.asarray(image, np.float32))
    out = (_resize_weights(h, nh).T @ x @ _resize_weights(w, nw)).numpy()
    if image.dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out, scale


def resize_mask(mask: np.ndarray, shape) -> np.ndarray:
    """Nearest-neighbour resize of a bool mask to ``shape`` (H, W): output
    pixel i reads input floor((i + 0.5) * m / n), in float32, as
    the reference's "nearest" resize does (the CLI only shrinks
    masks, with their images)."""
    out = np.asarray(mask, bool)
    for axis, n in enumerate(shape):
        m = out.shape[axis]
        idx = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                       * np.float32(m) / np.float32(n)).astype(np.int64)
        out = np.take(out, idx, axis=axis)
    return out


# ---------------------------------------------------------------------------
# Compute
# ---------------------------------------------------------------------------


def normalize_u8(images: torch.Tensor) -> torch.Tensor:
    """uint8 images to float32 in [0, 1]: each level i becomes the CPU's
    correctly rounded i / 255, looked up on the images' device.  On CUDA
    a division by the host scalar 255 multiplies by its rounded
    reciprocal, one unit in the last place off for some levels; SIFT then
    orders its keypoints otherwise, and the aligned split and the line
    directions, drawn in that order, land on other keypoints than the
    CPU's."""
    levels = torch.arange(256, dtype=torch.float32) / 255.0
    return levels.to(images.device)[images.long()]


def aligned_split_from_uniforms(valid: torch.Tensor, uniforms: torch.Tensor,
                                ratio: float = 0.5) -> torch.Tensor:
    """Exactly ``floor(ratio * num_valid)`` aligned keypoints per row of
    ``valid`` (..., N): the valid entries with the smallest ``uniforms``
    (..., N), ties to the lower index (``extraction.cc:453-458``)."""
    r = torch.where(valid, uniforms, 2.0)  # padding sorts last
    order = torch.argsort(r, dim=-1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(r.shape[-1], device=r.device
                                          ).expand_as(order))
    num_aligned = torch.floor(ratio * valid.sum(-1, keepdim=True).double())
    return (rank < num_aligned) & valid


def lift_features_with_draws(feats: sift_mod.SiftFeatures,
                             camera_model: str, camera_params: torch.Tensor,
                             gravity: torch.Tensor, aligned_ratio: float,
                             uniforms: torch.Tensor,
                             normals: torch.Tensor) -> LiftedFeatures:
    """Lift extracted keypoints (B, K) to privacy-preserving lines, given
    the draws: ``uniforms`` (B, K) for the aligned split and ``normals``
    (B, K, 3) for the random line directions.  ``camera_params`` (B, P),
    ``gravity`` (B, 3).  The keypoint positions exist only inside this
    function."""
    with record_function("extraction.lift"):
        aligned = aligned_split_from_uniforms(feats.valid, uniforms,
                                              aligned_ratio)
        xy_norm = cam_ops.image_to_world(camera_model,
                                         camera_params[:, None, :],
                                         feats.keypoints[..., :2])
        lines = line_ops.lift_with_directions(xy_norm, gravity, aligned,
                                              normals)
    return LiftedFeatures(descriptors=feats.descriptors, lines=lines,
                          aligned=aligned, valid=feats.valid,
                          gravity=gravity)


def lift_features(feats: sift_mod.SiftFeatures, camera_model: str,
                  camera_params: torch.Tensor, gravity: torch.Tensor,
                  aligned_ratio: float,
                  generators: Sequence[torch.Generator]) -> LiftedFeatures:
    """``lift_features_with_draws``, image b drawing its split and then its
    line directions from ``generators[b]``.  The generators must live on
    the CPU whatever the features' device (``line_ops.
    require_cpu_generator``): the draws are made there and moved, so the
    card and the CPU lift with the same samples."""
    K, dev = feats.valid.shape[1], feats.valid.device
    dtype = torch.promote_types(feats.keypoints.dtype, camera_params.dtype)
    generators = [line_ops.require_cpu_generator(g) for g in generators]
    uniforms = torch.stack([torch.rand(K, generator=g)
                            for g in generators]).to(dev)
    normals = torch.stack([torch.randn(K, 3, generator=g, dtype=dtype)
                           for g in generators]).to(dev)
    return lift_features_with_draws(feats, camera_model, camera_params,
                                    gravity, aligned_ratio, uniforms,
                                    normals)


def extract_and_lift_batch(images: torch.Tensor, camera_model: str,
                           camera_params: torch.Tensor,
                           gravities: torch.Tensor,
                           generators: Sequence[torch.Generator],
                           sift_options: sift_mod.SiftOptions
                           = sift_mod.SiftOptions(),
                           aligned_ratio: float = 0.5,
                           masks: Optional[torch.Tensor] = None
                           ) -> LiftedFeatures:
    """The per-image front end on a batch of same-shape images: SIFT, the
    aligned split and the line lift, on ``images``' device.

    images (B, H, W) uint8 (normalized to [0, 1] by ``normalize_u8``) or
    float;
    camera_params (B, P); gravities (B, 3); ``masks`` (B, H, W) bool drops
    keypoints whose rounded position falls on False; one CPU generator
    per image.  Counterpart of the reference's
    ``extract_and_lift_batch_jit``.
    """
    if not images.is_floating_point():
        images = normalize_u8(images)
    feats = sift_mod.extract_sift(images, sift_options)
    if masks is not None:
        B, h, w = images.shape
        kp = feats.keypoints
        xi = torch.clamp(torch.round(kp[..., 0]).long(), 0, w - 1)
        yi = torch.clamp(torch.round(kp[..., 1]).long(), 0, h - 1)
        inside = torch.gather(masks.reshape(B, -1), 1, yi * w + xi)
        feats = feats._replace(valid=feats.valid & inside)
    return lift_features(feats, camera_model, camera_params, gravities,
                         aligned_ratio, generators)


def extract_and_lift(image: torch.Tensor, camera_model: str,
                     camera_params: torch.Tensor, gravity: torch.Tensor,
                     generator: torch.Generator,
                     sift_options: sift_mod.SiftOptions
                     = sift_mod.SiftOptions(),
                     aligned_ratio: float = 0.5,
                     mask: Optional[torch.Tensor] = None) -> LiftedFeatures:
    """``extract_and_lift_batch`` on one image (H, W); the result keeps a
    batch dimension of 1."""
    return extract_and_lift_batch(
        image[None], camera_model, camera_params[None], gravity[None],
        [generator], sift_options, aligned_ratio,
        None if mask is None else mask[None])
