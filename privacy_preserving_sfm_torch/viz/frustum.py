"""Camera frustum wireframes, shared by the PNG renderer and the HTML
viewer (reference ``viz/render.py:_frustum_segments``).  numpy only: the
HTML path must not import matplotlib, which the reference's
``render.py`` imports at module level."""

from __future__ import annotations

import numpy as np


def frustum_segments(rec, image_id: int, scale: float) -> np.ndarray:
    """(8, 2, 3) wireframe segments of one camera frustum in world space:
    the image-plane rectangle at depth ``scale`` and the apex rays
    (``model_viewer_widget.cc``'s camera glyph)."""
    img = rec.images[image_id]
    cam = rec.cameras[img.camera_id]
    R = img.rotation_matrix()
    c = img.projection_center()
    f = cam.mean_focal_length()
    hw = 0.5 * cam.width / f
    hh = 0.5 * cam.height / f
    corners_cam = np.array([
        [-hw, -hh, 1.0], [hw, -hh, 1.0], [hw, hh, 1.0], [-hw, hh, 1.0],
    ]) * scale
    corners = corners_cam @ R + c  # R^T @ x per row
    segs = []
    for i in range(4):
        segs.append([c, corners[i]])                     # apex rays
        segs.append([corners[i], corners[(i + 1) % 4]])  # plane rectangle
    return np.asarray(segs)
