"""Correspondence graph over line features.

Numpy host code carried over verbatim from
``privacy_preserving_sfm_tpu/models/correspondence_graph.py``.  Mirror of
``src/base/correspondence_graph.{h,cc}``: per-(image, line) adjacency
lists built from two-view matches, transitive BFS expansion, and
two-view-track detection.  Storage is flat numpy adjacency (CSR-like) for
cheap vectorized queries from the mapper.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


class CorrespondenceGraph:
    def __init__(self):
        # (image_id, line_idx) -> list[(image_id, line_idx)]
        self._adj: Dict[Tuple[int, int], List[Tuple[int, int]]] = \
            defaultdict(list)
        self.num_observations: Dict[int, int] = defaultdict(int)
        self.num_correspondences_per_image: Dict[int, int] = defaultdict(int)
        self._image_pairs: Dict[Tuple[int, int], int] = {}
        self._finalized = False

    def add_matches(self, image_id1: int, image_id2: int,
                    matches: np.ndarray):
        """matches: (N, 2) line indices.  Duplicate-free input assumed."""
        if len(matches) == 0:
            return
        for i1, i2 in matches:
            self._adj[(image_id1, int(i1))].append((image_id2, int(i2)))
            self._adj[(image_id2, int(i2))].append((image_id1, int(i1)))
        self.num_correspondences_per_image[image_id1] += len(matches)
        self.num_correspondences_per_image[image_id2] += len(matches)
        key = (min(image_id1, image_id2), max(image_id1, image_id2))
        self._image_pairs[key] = self._image_pairs.get(key, 0) + len(matches)

    def finalize(self):
        """Count observations = features with >= 1 correspondence."""
        obs = defaultdict(int)
        for (iid, _li), corrs in self._adj.items():
            if corrs:
                obs[iid] += 1
        self.num_observations = obs
        self._finalized = True

    def image_ids(self) -> List[int]:
        return sorted(self.num_correspondences_per_image.keys())

    def image_pairs(self) -> Dict[Tuple[int, int], int]:
        return dict(self._image_pairs)

    def has_correspondences(self, image_id: int, line_idx: int) -> bool:
        return bool(self._adj.get((image_id, line_idx)))

    def find_correspondences(self, image_id: int,
                             line_idx: int) -> List[Tuple[int, int]]:
        return list(self._adj.get((image_id, line_idx), ()))

    def find_transitive_correspondences(
            self, image_id: int, line_idx: int,
            transitivity: int) -> List[Tuple[int, int]]:
        """BFS up to ``transitivity`` hops
        (``correspondence_graph.cc`` FindTransitiveCorrespondences)."""
        if transitivity == 1:
            return self.find_correspondences(image_id, line_idx)
        seen = {(image_id, line_idx)}
        result = []
        frontier = [(image_id, line_idx)]
        for _ in range(transitivity):
            nxt = []
            for node in frontier:
                for corr in self._adj.get(node, ()):
                    if corr not in seen:
                        seen.add(corr)
                        result.append(corr)
                        nxt.append(corr)
            if not nxt:
                break
            frontier = nxt
        return result

    def is_two_view_observation(self, image_id: int, line_idx: int) -> bool:
        """True when the feature sees exactly one other image which sees it
        back exclusively (two-view track,
        ``correspondence_graph.cc`` IsTwoViewObservation)."""
        corrs = self._adj.get((image_id, line_idx), ())
        if len(corrs) != 1:
            return False
        other = corrs[0]
        back = self._adj.get(other, ())
        return len(back) == 1
