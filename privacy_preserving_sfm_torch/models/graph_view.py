"""Flat CSR view of the correspondence graph for vectorized host queries.

Numpy host code carried over verbatim from
``privacy_preserving_sfm_tpu/models/graph_view.py``.
The reference walks per-feature adjacency lists one feature at a time
(``src/base/correspondence_graph.cc`` FindCorrespondences callers in
``incremental_mapper.cc:139-191,594-657``).  Round-1 profiling showed these
per-line queries (ctypes or dict lookups) dominate images-registered/s, so
this module flattens the whole graph once into numpy CSR arrays:

  * every (image, line) feature gets a global flat index;
  * ``row_offsets``/``corr_flat`` give each feature's correspondence list;
  * per-registration-state queries (visible-point counts, 2D-3D search,
    triangulation pools) become O(total_corrs) numpy gathers instead of
    O(lines x corrs) Python loops.

The graph is static after matching, so the view is built once per cache.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


class GraphView:
    """Immutable CSR over all (image, line) features and correspondences."""

    def __init__(self, image_ids: List[int], num_lines: np.ndarray,
                 row_offsets: np.ndarray, corr_flat: np.ndarray):
        self.image_ids = list(image_ids)
        self.dense: Dict[int, int] = {iid: d for d, iid in
                                      enumerate(self.image_ids)}
        self.num_lines = np.asarray(num_lines, np.int64)
        self.feat_offset = np.concatenate(
            [[0], np.cumsum(self.num_lines)]).astype(np.int64)
        self.total_lines = int(self.feat_offset[-1])
        self.row_offsets = np.asarray(row_offsets, np.int64)
        self.corr_flat = np.asarray(corr_flat, np.int64)

        # Derived per-correspondence arrays.
        self.corr_img_dense = (np.searchsorted(
            self.feat_offset, self.corr_flat, "right") - 1).astype(np.int64)
        self.corr_line = (self.corr_flat
                          - self.feat_offset[self.corr_img_dense])
        self.degree = np.diff(self.row_offsets)
        # line index (within its image) of each correspondence's source row
        row_img = np.repeat(np.arange(len(self.image_ids)),
                            self.num_lines)
        row_line = np.arange(self.total_lines) - \
            self.feat_offset[row_img]
        self.line_of_corr = np.repeat(row_line, self.degree)
        # number of features with >= 1 correspondence, per image
        has_corr = self.degree > 0
        self.num_obs_per_image = {
            iid: int(has_corr[self.feat_offset[d]:
                              self.feat_offset[d + 1]].sum())
            for iid, d in self.dense.items()}
        self.image_id_arr = np.asarray(self.image_ids, np.int64)

    # -- construction ----------------------------------------------------

    @classmethod
    def from_match_chunks(cls, chunks: Iterable[Tuple[int, int, np.ndarray]],
                          num_lines: Dict[int, int]) -> "GraphView":
        """Build from raw (image_id1, image_id2, (N,2) matches) chunks."""
        image_ids = sorted(num_lines.keys())
        dense = {iid: d for d, iid in enumerate(image_ids)}
        nl = np.asarray([num_lines[iid] for iid in image_ids], np.int64)
        feat_offset = np.concatenate([[0], np.cumsum(nl)]).astype(np.int64)

        srcs, dsts = [], []
        for i1, i2, m in chunks:
            if i1 not in dense or i2 not in dense or len(m) == 0:
                continue
            m = np.asarray(m, np.int64)
            f1 = feat_offset[dense[i1]] + m[:, 0]
            f2 = feat_offset[dense[i2]] + m[:, 1]
            srcs.append(f1)
            dsts.append(f2)
            srcs.append(f2)
            dsts.append(f1)
        if srcs:
            src = np.concatenate(srcs)
            dst = np.concatenate(dsts)
            order = np.argsort(src, kind="stable")
            src, dst = src[order], dst[order]
        else:
            src = dst = np.zeros(0, np.int64)
        total = int(feat_offset[-1])
        counts = np.bincount(src, minlength=total)
        row_offsets = np.concatenate([[0], np.cumsum(counts)])
        return cls(image_ids, nl, row_offsets, dst)

    @classmethod
    def from_graph(cls, graph, num_lines: Dict[int, int]) -> "GraphView":
        """Fallback: flatten a CorrespondenceGraph via per-line queries."""
        image_ids = sorted(num_lines.keys())
        row_offsets = [0]
        corr_flat: List[int] = []
        dense = {iid: d for d, iid in enumerate(image_ids)}
        nl = np.asarray([num_lines[iid] for iid in image_ids], np.int64)
        feat_offset = np.concatenate([[0], np.cumsum(nl)]).astype(np.int64)
        for iid in image_ids:
            for li in range(num_lines[iid]):
                for ciid, cli in graph.find_correspondences(iid, li):
                    if ciid in dense:
                        corr_flat.append(int(feat_offset[dense[ciid]]) + cli)
                row_offsets.append(len(corr_flat))
        return cls(image_ids, nl, np.asarray(row_offsets, np.int64),
                   np.asarray(corr_flat, np.int64))

    # -- queries ---------------------------------------------------------

    def corr_range(self, image_id: int) -> Tuple[int, int]:
        """[start, end) into the corr arrays for all of an image's rows."""
        d = self.dense[image_id]
        return (int(self.row_offsets[self.feat_offset[d]]),
                int(self.row_offsets[self.feat_offset[d + 1]]))

    def image_row_offsets(self, image_id: int) -> np.ndarray:
        """Per-line offsets (L+1,) into the corr arrays, absolute."""
        d = self.dense[image_id]
        return self.row_offsets[self.feat_offset[d]:
                                self.feat_offset[d + 1] + 1]

    def concat_per_image(self, fn) -> np.ndarray:
        """Build a flat per-feature array from per-image arrays.

        fn(image_id) must return an array of length num_lines[image].
        """
        return np.concatenate([np.asarray(fn(iid))
                               for iid in self.image_ids]) \
            if self.image_ids else np.zeros(0)

    def two_view_flags(self, image_id: int) -> np.ndarray:
        """Per-line bool: feature forms an isolated two-view track
        (``correspondence_graph.cc`` IsTwoViewObservation)."""
        d = self.dense[image_id]
        ro = self.image_row_offsets(image_id)
        deg = np.diff(ro)
        flags = np.zeros(len(deg), bool)
        single = deg == 1
        idx = ro[:-1][single]  # the single correspondence of each such line
        back_deg = self.degree[self.corr_flat[idx]]
        flags[single] = back_deg == 1
        return flags

    def per_line_counts(self, image_id: int,
                        corr_mask: np.ndarray) -> np.ndarray:
        """Count per line of True entries in a mask over the image's corr
        range (handles empty rows)."""
        ro = self.image_row_offsets(image_id)
        base = ro[0]
        cs = np.concatenate([[0], np.cumsum(corr_mask)])
        return cs[ro[1:] - base] - cs[ro[:-1] - base]
