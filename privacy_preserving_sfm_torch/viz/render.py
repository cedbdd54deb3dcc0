"""Headless sparse-model renderer to PNG (port of
``privacy_preserving_sfm_tpu/viz/render.py``).

The reference ships a Qt5/OpenGL model viewer (``src/ui/
model_viewer_widget.cc``, colormaps in ``src/ui/colormaps.cc``); headless,
the model (3D points colored by track length, reprojection error or
depth, plus camera frusta) is rasterized with matplotlib's Agg backend.
matplotlib is imported when a PNG is drawn, not with this module, and a
machine without it gets an error that names it; the HTML viewer
(``viz/interactive.py``) needs none.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from privacy_preserving_sfm_torch.viz.frustum import frustum_segments


def _pyplot():
    """(pyplot, Line3DCollection) on the Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(
            "a PNG render needs matplotlib, which is not installed; "
            "model_viewer --html needs none") from e
    matplotlib.use("Agg")  # headless; never require a display
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    return plt, Line3DCollection


def _point_colors(rec, pids: Sequence[int], color_by: str) -> np.ndarray:
    """Per-point scalar for the colormap (reference ``colormaps.cc``)."""
    if color_by == "track":
        vals = np.array([len(rec.points3d[p].track) for p in pids], float)
    elif color_by == "error":
        vals = np.array([max(rec.points3d[p].error, 0.0) for p in pids])
    else:  # depth: distance along the mean viewing direction
        xyz = np.stack([rec.points3d[p].xyz for p in pids])
        vals = xyz[:, 2].astype(float)
    lo, hi = np.percentile(vals, [2, 98]) if len(vals) else (0.0, 1.0)
    if hi - lo < 1e-12:
        hi = lo + 1.0
    return np.clip((vals - lo) / (hi - lo), 0.0, 1.0)


def render_model(rec, out_path: str,
                 elev: float = -60.0, azim: float = -90.0,
                 color_by: str = "track",
                 image_size: Tuple[int, int] = (1280, 960),
                 max_points: int = 200_000,
                 draw_cameras: bool = True,
                 title: Optional[str] = None) -> str:
    """Render one view of the sparse model to ``out_path`` (PNG).

    color_by: "track" (track length), "error" (mean reproj error px) or
    "depth" — the quantities of the reference viewer's point colormaps.
    """
    pids = sorted(rec.points3d.keys())
    if len(pids) > max_points:
        step = len(pids) // max_points + 1
        pids = pids[::step]
    xyz = (np.stack([rec.points3d[p].xyz for p in pids])
           if pids else np.zeros((0, 3)))

    plt, Line3DCollection = _pyplot()
    dpi = 100
    fig = plt.figure(figsize=(image_size[0] / dpi, image_size[1] / dpi),
                     dpi=dpi)
    ax = fig.add_subplot(111, projection="3d")
    ax.set_proj_type("persp")

    if len(xyz):
        ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], s=1.0,
                   c=_point_colors(rec, pids, color_by),
                   cmap="viridis", linewidths=0, depthshade=False)

    centers = []
    if draw_cameras and rec.reg_image_ids:
        extent = (np.ptp(xyz, axis=0).max() if len(xyz) else 1.0) or 1.0
        scale = 0.03 * extent
        segs = np.concatenate([
            frustum_segments(rec, iid, scale) for iid in rec.reg_image_ids])
        ax.add_collection3d(
            Line3DCollection(segs, colors=(0.85, 0.1, 0.1, 0.9),
                             linewidths=0.7))
        centers = np.stack([rec.images[iid].projection_center()
                            for iid in rec.reg_image_ids])

    allp = np.concatenate([xyz] + ([centers] if len(centers) else []))
    if len(allp):
        mid = (allp.min(0) + allp.max(0)) / 2
        half = max(float(np.ptp(allp, axis=0).max()) / 2, 1e-6)
        ax.set_xlim(mid[0] - half, mid[0] + half)
        ax.set_ylim(mid[1] - half, mid[1] + half)
        ax.set_zlim(mid[2] - half, mid[2] + half)
    ax.set_box_aspect((1, 1, 1))
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    if title is None:
        title = (f"{rec.num_registered()} images · "
                 f"{len(rec.points3d)} points · "
                 f"mean reproj {rec.compute_mean_reprojection_error():.2f}px")
    ax.set_title(title, fontsize=9)
    fig.tight_layout(pad=0.1)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def render_turntable(rec, out_dir: str, num_frames: int = 12,
                     elev: float = -60.0, **kwargs) -> list:
    """Render ``num_frames`` azimuth steps (360/n apart) to ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for k in range(num_frames):
        azim = -90.0 + 360.0 * k / num_frames
        path = os.path.join(out_dir, f"frame{k:03d}.png")
        paths.append(render_model(rec, path, elev=elev, azim=azim, **kwargs))
    return paths
