"""ctypes bindings for the native correspondence graph (``native/graph.cpp``).

Numpy/ctypes host code carried over from
``privacy_preserving_sfm_tpu/models/native_graph.py``: an accelerated
``CorrespondenceGraph`` plus the 4-view track assembly of the
initializer, the mapper's host-side hot loops, in C++ (the reference
keeps these in C++ too: ``src/base/correspondence_graph.cc``,
``src/sfm/incremental_mapper.cc``).

On first use the repository's ``native/graph.cpp`` is built with ``g++``
into this package's git-ignored ``kernels/_build/`` (never into
``native/``), under a name that carries a hash of the source; callers
fall back to the pure-Python graph when the build or the load fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Dict, List, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(os.path.dirname(_PKG), "native", "graph.cpp")
BUILD_DIR = os.path.join(_PKG, "kernels", "_build")

_lib = None


def _build() -> str:
    """Path of the built library, building it when missing."""
    with open(_SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    path = os.path.join(BUILD_DIR, f"libppsfm_graph_{tag}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                        "-o", tmp, _SOURCE], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, path)  # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native graph build failed: {e}") from e
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ppsfm_graph_create.restype = ctypes.c_void_p
    lib.ppsfm_graph_destroy.argtypes = [ctypes.c_void_p]
    lib.ppsfm_graph_add_matches.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, u32p,
        ctypes.c_int64]
    lib.ppsfm_graph_find_correspondences.restype = ctypes.c_int64
    lib.ppsfm_graph_find_correspondences.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, u32p, u32p,
        ctypes.c_int64]
    lib.ppsfm_graph_find_transitive.restype = ctypes.c_int64
    lib.ppsfm_graph_find_transitive.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
        u32p, u32p, ctypes.c_int64]
    lib.ppsfm_graph_is_two_view.restype = ctypes.c_int
    lib.ppsfm_graph_is_two_view.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32]
    lib.ppsfm_assemble_tracks.restype = ctypes.c_void_p
    lib.ppsfm_assemble_tracks.argtypes = [
        ctypes.c_void_p, u32p, ctypes.c_int64, u32p, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), i64p, ctypes.c_int]
    lib.ppsfm_tracks_num_sets.restype = ctypes.c_int64
    lib.ppsfm_tracks_num_sets.argtypes = [ctypes.c_void_p]
    lib.ppsfm_tracks_total.restype = ctypes.c_int64
    lib.ppsfm_tracks_total.argtypes = [ctypes.c_void_p]
    lib.ppsfm_tracks_copy.argtypes = [
        ctypes.c_void_p, u32p, i64p, i64p, u32p]
    lib.ppsfm_tracks_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class NativeCorrespondenceGraph:
    """Same query interface as models.CorrespondenceGraph, C++ backed."""

    MAX_CORRS = 4096

    def __init__(self):
        self._lib = _load()
        self._g = self._lib.ppsfm_graph_create()
        self.num_correspondences_per_image: Dict[int, int] = {}
        self._image_pairs: Dict[Tuple[int, int], int] = {}
        self._out_img = np.zeros(self.MAX_CORRS, np.uint32)
        self._out_line = np.zeros(self.MAX_CORRS, np.uint32)

    def __del__(self):
        if getattr(self, "_g", None):
            self._lib.ppsfm_graph_destroy(self._g)
            self._g = None

    def add_matches(self, image_id1: int, image_id2: int,
                    matches: np.ndarray):
        if len(matches) == 0:
            return
        m = np.ascontiguousarray(matches, np.uint32)
        self._lib.ppsfm_graph_add_matches(self._g, image_id1, image_id2,
                                          _u32p(m), len(m))
        self.num_correspondences_per_image[image_id1] = \
            self.num_correspondences_per_image.get(image_id1, 0) + len(m)
        self.num_correspondences_per_image[image_id2] = \
            self.num_correspondences_per_image.get(image_id2, 0) + len(m)
        key = (min(image_id1, image_id2), max(image_id1, image_id2))
        self._image_pairs[key] = self._image_pairs.get(key, 0) + len(m)

    def finalize(self):
        pass

    def image_ids(self) -> List[int]:
        return sorted(self.num_correspondences_per_image.keys())

    def image_pairs(self) -> Dict[Tuple[int, int], int]:
        return dict(self._image_pairs)

    def has_correspondences(self, image_id: int, line_idx: int) -> bool:
        n = self._lib.ppsfm_graph_find_correspondences(
            self._g, image_id, line_idx, _u32p(self._out_img),
            _u32p(self._out_line), 1)
        return n > 0

    def find_correspondences(self, image_id: int,
                             line_idx: int) -> List[Tuple[int, int]]:
        n = self._lib.ppsfm_graph_find_correspondences(
            self._g, image_id, line_idx, _u32p(self._out_img),
            _u32p(self._out_line), self.MAX_CORRS)
        return list(zip(self._out_img[:n].tolist(),
                        self._out_line[:n].tolist()))

    def find_transitive_correspondences(
            self, image_id: int, line_idx: int,
            transitivity: int) -> List[Tuple[int, int]]:
        n = self._lib.ppsfm_graph_find_transitive(
            self._g, image_id, line_idx, transitivity,
            _u32p(self._out_img), _u32p(self._out_line), self.MAX_CORRS)
        return list(zip(self._out_img[:n].tolist(),
                        self._out_line[:n].tolist()))

    def is_two_view_observation(self, image_id: int, line_idx: int) -> bool:
        return bool(self._lib.ppsfm_graph_is_two_view(self._g, image_id,
                                                      line_idx))

    def assemble_four_view_tracks(self, seed_ids, all_ids, aligned_flags,
                                  want_aligned: bool):
        """4-view track sets (init): {image_set: [feat quadruples]}.

        aligned_flags: dict image_id -> uint8 array.
        """
        lib = self._lib
        seeds = np.ascontiguousarray(seed_ids, np.uint32)
        ids = np.ascontiguousarray(all_ids, np.uint32)
        flags = [np.ascontiguousarray(aligned_flags[i], np.uint8)
                 for i in all_ids]
        ptrs = (ctypes.POINTER(ctypes.c_uint8) * len(flags))(
            *[f.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
              for f in flags])
        nlines = np.ascontiguousarray([len(f) for f in flags], np.int64)
        tr = lib.ppsfm_assemble_tracks(
            self._g, _u32p(seeds), len(seeds), _u32p(ids), len(ids),
            ptrs, _i64p(nlines), int(want_aligned))
        try:
            num_sets = lib.ppsfm_tracks_num_sets(tr)
            total = lib.ppsfm_tracks_total(tr)
            image_sets = np.zeros(num_sets * 4, np.uint32)
            offsets = np.zeros(num_sets, np.int64)
            counts = np.zeros(num_sets, np.int64)
            features = np.zeros(total * 4, np.uint32)
            if num_sets:
                lib.ppsfm_tracks_copy(tr, _u32p(image_sets), _i64p(offsets),
                                      _i64p(counts), _u32p(features))
        finally:
            lib.ppsfm_tracks_destroy(tr)
        out = {}
        image_sets = image_sets.reshape(-1, 4)
        features = features.reshape(-1, 4)
        for s in range(num_sets):
            key = tuple(int(v) for v in image_sets[s])
            out[key] = features[offsets[s]:offsets[s] + counts[s]]
        return out
