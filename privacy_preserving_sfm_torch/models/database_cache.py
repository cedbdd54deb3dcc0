"""DatabaseCache: load cameras/images/lines/gravity/matches into memory.

Numpy host code carried over from
``privacy_preserving_sfm_tpu/models/database_cache.py``.  Mirror of
``src/base/database_cache.{h,cc}``: applies the
``min_num_matches`` filter, keeps only images connected by matches (unless
``ignore_watermarks``-style listing is requested), attaches feature lines +
gravity to each image, checks that aligned lines only appear with known
gravity, and builds the correspondence graph.  The mapper loads two caches:
the full one and an aligned-only one for init track search
(``controllers/incremental_mapper.cc:316-380``).
"""

from __future__ import annotations

from typing import Dict, Optional, Set

import numpy as np

from privacy_preserving_sfm_torch.models.correspondence_graph import (
    CorrespondenceGraph,
)
from privacy_preserving_sfm_torch.models.database import Database
from privacy_preserving_sfm_torch.models.reconstruction import Camera, Image


def _make_graph():
    """Native C++ graph when buildable, pure Python otherwise."""
    from privacy_preserving_sfm_torch.models import native_graph
    if native_graph.available():
        return native_graph.NativeCorrespondenceGraph()
    return CorrespondenceGraph()


class DatabaseCache:
    def __init__(self):
        self.cameras: Dict[int, Camera] = {}
        self.images: Dict[int, Image] = {}
        self.graph = _make_graph()
        self._match_chunks = []  # (image_id1, image_id2, (N,2) matches)
        self._view = None

    @property
    def view(self):
        """Lazily-built flat CSR view of the graph (models/graph_view.py)."""
        if self._view is None and self.images:
            from privacy_preserving_sfm_torch.models.graph_view import GraphView
            num_lines = {iid: img.num_lines
                         for iid, img in self.images.items()}
            if self._match_chunks:
                self._view = GraphView.from_match_chunks(
                    self._match_chunks, num_lines)
            else:
                self._view = GraphView.from_graph(self.graph, num_lines)
        return self._view

    @property
    def graph_kind(self) -> str:
        """"native" (C++) or "python": which graph the cache holds."""
        return "python" if isinstance(self.graph, CorrespondenceGraph) \
            else "native"

    @classmethod
    def load(cls, db: Database, min_num_matches: int = 15,
             image_names: Optional[Set[str]] = None,
             aligned_only: bool = False) -> "DatabaseCache":
        cache = cls()

        for cid, c in db.read_cameras().items():
            cache.cameras[cid] = Camera(
                camera_id=cid, model=c["model"],
                width=c["width"], height=c["height"], params=c["params"],
                prior_focal_length=bool(c.get("prior_focal_length", True)))

        db_images = db.read_images()
        all_matches = db.read_all_matches()

        # Images connected by an above-threshold match.
        connected: Set[int] = set()
        for (i1, i2), m in all_matches.items():
            if len(m) >= min_num_matches:
                connected.add(i1)
                connected.add(i2)

        keep_index_maps: Dict[int, np.ndarray] = {}
        for iid, info in db_images.items():
            if iid not in connected:
                continue
            if image_names is not None and info["name"] not in image_names:
                continue
            lines, aligned = db.read_lines(iid)
            gravity = db.read_gravity(iid)
            if aligned.any():
                assert gravity is not None, (
                    f"image {info['name']} has aligned lines but no gravity")
            if aligned_only:
                keep = np.nonzero(aligned)[0]
                index_map = np.full(len(lines), -1, np.int64)
                index_map[keep] = np.arange(len(keep))
                keep_index_maps[iid] = index_map
                lines = lines[keep]
                aligned = aligned[keep]
            img = Image(image_id=iid, name=info["name"],
                        camera_id=info["camera_id"], gravity=gravity)
            img.lines = lines
            img.aligned = aligned
            img.point3d_ids = np.full(len(lines), -1, np.int64)
            cache.images[iid] = img

        for (i1, i2), m in all_matches.items():
            if len(m) < min_num_matches:
                continue
            if i1 not in cache.images or i2 not in cache.images:
                continue
            if aligned_only:
                m1 = keep_index_maps[i1][m[:, 0]]
                m2 = keep_index_maps[i2][m[:, 1]]
                ok = (m1 >= 0) & (m2 >= 0)
                m = np.stack([m1[ok], m2[ok]], axis=1)
                if len(m) == 0:
                    continue
            cache.graph.add_matches(i1, i2, m)
            cache._match_chunks.append((i1, i2, m))
        cache.graph.finalize()
        return cache

    def to_reconstruction(self):
        from privacy_preserving_sfm_torch.models.reconstruction import (
            Reconstruction,
        )
        rec = Reconstruction()
        for cam in self.cameras.values():
            rec.add_camera(cam)
        for img in self.images.values():
            rec.add_image(img)
        return rec
