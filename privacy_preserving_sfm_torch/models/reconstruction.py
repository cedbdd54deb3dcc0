"""Reconstruction data model (cameras, images with lines, 3D points, tracks).

Numpy host code carried over from
``privacy_preserving_sfm_tpu/models/reconstruction.py`` (verbatim where
possible): the containers, bookkeeping (registration, deregistration,
point merges), the reference-compatible text model IO, the point filters
(large reprojection error, small triangulation angle, negative depth),
the image filter, ``normalize``/``transform`` and the squared line
errors.
Mirror of the reference's ``src/base/reconstruction.{h,cc}``,
``image.{h,cc}``, ``point3d.h`` and ``track.h``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from privacy_preserving_sfm_torch.ops.cameras import MODELS

_INVALID = -1


@dataclasses.dataclass
class Camera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray
    # True when the focal came from EXIF / an explicit sidecar rather than
    # the max-dim heuristic (``cameras.prior_focal_length`` DB column);
    # prior-less cameras are eligible for focal search at registration.
    prior_focal_length: bool = True

    def mean_focal_length(self) -> float:
        spec = MODELS[self.model]
        return float(np.mean([self.params[i] for i in spec.focal_idxs]))

    def image_to_world_threshold(self, threshold: float) -> float:
        return threshold / self.mean_focal_length()


@dataclasses.dataclass
class Image:
    """Per-image state: pose, gravity, feature lines, 3D-point links."""

    image_id: int
    name: str
    camera_id: int
    qvec: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0, 0, 0]))
    tvec: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    gravity: Optional[np.ndarray] = None
    lines: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3)))
    aligned: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, bool))
    point3d_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    registered: bool = False
    num_reg_trials: int = 0

    def __post_init__(self):
        if self.point3d_ids.shape[0] != self.lines.shape[0]:
            self.point3d_ids = np.full(self.lines.shape[0], _INVALID,
                                       np.int64)

    def __setattr__(self, name, value):
        # Invalidate the cached pose-derived matrices on pose assignment.
        if name in ("qvec", "tvec"):
            object.__setattr__(self, "_pose_cache", None)
        object.__setattr__(self, name, value)

    @property
    def num_lines(self) -> int:
        return self.lines.shape[0]

    def num_points3d(self) -> int:
        return int((self.point3d_ids != _INVALID).sum())

    def rotation_matrix(self) -> np.ndarray:
        """Pure-numpy quat -> R (hot path for host orchestration loops)."""
        cache = getattr(self, "_pose_cache", None)
        if cache is not None:
            return cache[0]
        q = self.qvec / np.linalg.norm(self.qvec)
        w, x, y, z = q
        R = np.array([
            [w*w + x*x - y*y - z*z, 2*(x*y - w*z), 2*(x*z + w*y)],
            [2*(x*y + w*z), w*w - x*x + y*y - z*z, 2*(y*z - w*x)],
            [2*(x*z - w*y), 2*(y*z + w*x), w*w - x*x - y*y + z*z]])
        proj = np.concatenate([R, self.tvec[:, None]], axis=1)
        center = -R.T @ self.tvec
        object.__setattr__(self, "_pose_cache", (R, proj, center))
        return R

    def projection_matrix(self) -> np.ndarray:
        self.rotation_matrix()
        return self._pose_cache[1]

    def projection_center(self) -> np.ndarray:
        self.rotation_matrix()
        return self._pose_cache[2]


@dataclasses.dataclass
class Point3D:
    xyz: np.ndarray
    track: List[Tuple[int, int]]  # (image_id, line_idx)
    error: float = -1.0
    color: Tuple[int, int, int] = (0, 0, 0)


class Reconstruction:
    """Mutable scene model with reference-equivalent bookkeeping."""

    def __init__(self):
        self.cameras: Dict[int, Camera] = {}
        self.images: Dict[int, Image] = {}
        self.points3d: Dict[int, Point3D] = {}
        self._next_point_id = 1
        self.reg_image_ids: List[int] = []

    # -- basic bookkeeping ----------------------------------------------

    def add_camera(self, camera: Camera):
        self.cameras[camera.camera_id] = camera

    def add_image(self, image: Image):
        self.images[image.image_id] = image

    def register_image(self, image_id: int):
        img = self.images[image_id]
        if not img.registered:
            img.registered = True
            self.reg_image_ids.append(image_id)

    def deregister_image(self, image_id: int):
        """Remove all observations of the image and unregister it
        (``reconstruction.cc`` DeRegisterImage semantics)."""
        img = self.images[image_id]
        for line_idx in np.nonzero(img.point3d_ids != _INVALID)[0]:
            self.delete_observation(image_id, int(line_idx))
        img.registered = False
        if image_id in self.reg_image_ids:
            self.reg_image_ids.remove(image_id)

    def num_registered(self) -> int:
        return len(self.reg_image_ids)

    # -- points and tracks ----------------------------------------------

    def add_point3d(self, xyz: np.ndarray,
                    track: List[Tuple[int, int]]) -> int:
        pid = self._next_point_id
        self._next_point_id += 1
        self.points3d[pid] = Point3D(xyz=np.asarray(xyz, float),
                                     track=list(track))
        for image_id, line_idx in track:
            img = self.images[image_id]
            assert img.point3d_ids[line_idx] == _INVALID
            img.point3d_ids[line_idx] = pid
        return pid

    def add_observation(self, point3d_id: int, image_id: int, line_idx: int):
        img = self.images[image_id]
        assert img.point3d_ids[line_idx] == _INVALID
        img.point3d_ids[line_idx] = point3d_id
        self.points3d[point3d_id].track.append((image_id, line_idx))

    def delete_observation(self, image_id: int, line_idx: int):
        img = self.images[image_id]
        pid = int(img.point3d_ids[line_idx])
        if pid == _INVALID:
            return
        pt = self.points3d[pid]
        pt.track.remove((image_id, line_idx))
        img.point3d_ids[line_idx] = _INVALID
        # A track below 2 observations dies (reference DeleteObservation).
        if len(pt.track) < 2:
            self.delete_point3d(pid)

    def delete_point3d(self, point3d_id: int):
        pt = self.points3d.pop(point3d_id, None)
        if pt is None:
            return
        for image_id, line_idx in pt.track:
            self.images[image_id].point3d_ids[line_idx] = _INVALID

    def merge_points3d(self, pid1: int, pid2: int) -> int:
        """Track-length weighted centroid merge (``reconstruction.cc``
        MergePoints3D)."""
        p1, p2 = self.points3d[pid1], self.points3d[pid2]
        n1, n2 = len(p1.track), len(p2.track)
        xyz = (n1 * p1.xyz + n2 * p2.xyz) / (n1 + n2)
        track = list(p1.track) + list(p2.track)
        for image_id, line_idx in p1.track:
            self.images[image_id].point3d_ids[line_idx] = _INVALID
        for image_id, line_idx in p2.track:
            self.images[image_id].point3d_ids[line_idx] = _INVALID
        del self.points3d[pid1]
        del self.points3d[pid2]
        pid = self._next_point_id
        self._next_point_id += 1
        self.points3d[pid] = Point3D(xyz=xyz, track=track)
        for image_id, line_idx in track:
            self.images[image_id].point3d_ids[line_idx] = pid
        return pid

    def _squared_line_reproj_error(self, image: Image, line_idx: int,
                                   xyz: np.ndarray) -> float:
        from privacy_preserving_sfm_torch.ops import lines_np

        cam = self.cameras[image.camera_id]
        return float(lines_np.squared_line_reprojection_error(
            image.lines[line_idx], np.asarray(xyz, float),
            image.projection_matrix(), cam.model, cam.params,
            cam.width, cam.height))

    def batch_squared_line_errors(self, obs_img: np.ndarray,
                                  obs_li: np.ndarray,
                                  xyz_per_obs: np.ndarray) -> np.ndarray:
        """Vectorized squared pixel line errors for N (image, line) obs.

        Host-only numpy (no device dispatch): groups observations by image
        to amortize pose/param gathers, then evaluates the exact
        ``projection.cc:162-203`` error per observation.
        """
        from privacy_preserving_sfm_torch.ops import lines_np

        obs_img = np.asarray(obs_img, np.int64)
        obs_li = np.asarray(obs_li, np.int64)
        n = len(obs_img)
        if n == 0:
            return np.zeros(0)
        xyz = np.asarray(xyz_per_obs, float)
        if xyz.ndim == 1:
            xyz = np.broadcast_to(xyz, (n, 3))
        errs = np.empty(n)
        # Each image's observations in their given order (a stable sort),
        # as a mask would select them, without a pass over all n per image.
        order = np.argsort(obs_img, kind="stable")
        ids, starts = np.unique(obs_img[order], return_index=True)
        for iid, sel in zip(ids, np.split(order, starts[1:])):
            img = self.images[int(iid)]
            cam = self.cameras[img.camera_id]
            errs[sel] = lines_np.squared_line_reprojection_error(
                img.lines[obs_li[sel]], xyz[sel],
                img.projection_matrix(), cam.model, cam.params,
                cam.width, cam.height)
        return errs

    def filter_points3d(self, max_reproj_error: float, min_tri_angle_deg: float,
                        point3d_ids: Optional[Set[int]] = None) -> int:
        """Combined filter used after BA (``FilterPoints3D``):
        reprojection-error filter then small-tri-angle filter."""
        ids = set(self.points3d.keys()) if point3d_ids is None \
            else set(point3d_ids)
        n = self.filter_points3d_large_reproj_error(max_reproj_error, ids)
        n += self.filter_points3d_small_tri_angle(min_tri_angle_deg, ids)
        return n

    def _flat_track_obs(self, pid_arr: np.ndarray):
        """Flat (obs_img, obs_li, obs_idx) arrays for the tracks of the
        sorted pid array, gathered from the per-image ``point3d_ids``
        vectors (no per-observation Python).  ``obs_idx`` indexes into
        ``pid_arr``.  Observations come out grouped by image."""
        obs_img, obs_li, obs_idx, obs_al = [], [], [], []
        for iid, img in self.images.items():
            ids = img.point3d_ids
            mask = ids >= 0
            mask &= np.isin(ids, pid_arr)
            li = np.nonzero(mask)[0]
            if len(li) == 0:
                continue
            obs_img.append(np.full(len(li), iid, np.int64))
            obs_li.append(li.astype(np.int64))
            obs_idx.append(np.searchsorted(pid_arr, ids[li]))
            obs_al.append(np.asarray(img.aligned[li], bool))
        if not obs_img:
            z = np.zeros(0, np.int64)
            return z, z, z, np.zeros(0, bool)
        return (np.concatenate(obs_img), np.concatenate(obs_li),
                np.concatenate(obs_idx), np.concatenate(obs_al))

    def filter_points3d_large_reproj_error(
            self, max_reproj_error: float, point3d_ids: Set[int]) -> int:
        """Exact semantics of ``reconstruction.cc:657-720``: delete tracks
        with no random line or < 3 observations; then per-observation pixel
        error thresholding; delete the whole point when
        #bad >= track_len - 3.  Fully vectorized: track membership is read
        back from the per-image ``point3d_ids`` arrays and every per-point
        decision is a bincount over the flat observation table."""
        max_sq = max_reproj_error ** 2
        num_filtered = 0

        pid_arr = np.array(sorted(p for p in point3d_ids
                                  if p in self.points3d), np.int64)
        if len(pid_arr) == 0:
            return 0
        obs_img, obs_li, obs_idx, aligned = self._flat_track_obs(pid_arr)
        m = len(pid_arr)
        track_len = np.bincount(obs_idx, minlength=m)
        have_random = np.bincount(obs_idx, weights=~aligned,
                                  minlength=m) > 0

        # Phase 1: the no-random-line / short-track rule.
        phase1_del = (~have_random) | (track_len < 3)
        for k in np.nonzero(phase1_del)[0]:
            num_filtered += int(track_len[k])
            self.delete_point3d(int(pid_arr[k]))
        keep_obs = ~phase1_del[obs_idx]
        obs_img, obs_li, obs_idx = (obs_img[keep_obs], obs_li[keep_obs],
                                    obs_idx[keep_obs])
        if len(obs_idx) == 0:
            return num_filtered

        # Phase 2: one vectorized error evaluation over every observation
        # of every surviving track.
        xyz_tab = np.zeros((m, 3))
        for k in np.nonzero(~phase1_del)[0]:
            xyz_tab[k] = self.points3d[int(pid_arr[k])].xyz
        errs = self.batch_squared_line_errors(obs_img, obs_li,
                                              xyz_tab[obs_idx])

        # Phase 3: per-point decisions (independent across points, so the
        # reference's per-track order of effects is preserved).
        bad = errs > max_sq
        bad_count = np.bincount(obs_idx, weights=bad, minlength=m)
        kill = np.zeros(m, bool)
        kill[~phase1_del] = (bad_count >= track_len - 3)[~phase1_del]
        for k in np.nonzero(kill)[0]:
            num_filtered += int(track_len[k])
            self.delete_point3d(int(pid_arr[k]))
        drop = bad & ~kill[obs_idx]
        num_filtered += int(drop.sum())
        for i, l in zip(obs_img[drop], obs_li[drop]):
            self.delete_observation(int(i), int(l))
        err_sum = np.bincount(obs_idx, weights=np.sqrt(errs) * ~bad,
                              minlength=m)
        for k in np.nonzero(~phase1_del & ~kill)[0]:
            pt = self.points3d.get(int(pid_arr[k]))
            if pt is not None and len(pt.track) > 0:
                pt.error = err_sum[k] / len(pt.track)
        return num_filtered

    def filter_points3d_small_tri_angle(
            self, min_tri_angle_deg: float, point3d_ids: Set[int]) -> int:
        """``reconstruction.cc:594-654``: delete when no image pair in the
        track reaches the minimum triangulation angle.  Vectorized: distinct
        (point, image) pairs are padded to a (points, T) table and all
        pairwise angles evaluated by broadcasting, in point chunks."""
        from privacy_preserving_sfm_torch.ops import lines_np

        min_rad = np.deg2rad(min_tri_angle_deg)
        pid_arr = np.array(sorted(p for p in point3d_ids
                                  if p in self.points3d), np.int64)
        if len(pid_arr) == 0:
            return 0
        obs_img, _, obs_idx, _ = self._flat_track_obs(pid_arr)
        m = len(pid_arr)
        img_list = np.unique(obs_img)
        n_img = len(img_list)
        centers_tab = np.stack([
            self.images[int(i)].projection_center() for i in img_list])
        dense_img = np.searchsorted(img_list, obs_img)
        uk = np.unique(obs_idx * n_img + dense_img)
        p_of = uk // n_img
        xyz_tab = np.zeros((m, 3))
        for k in range(m):
            xyz_tab[k] = self.points3d[int(pid_arr[k])].xyz

        # The folded tri angle d(a, b) = arccos|a.b| is a METRIC on RP^2,
        # so deviations from one reference ray bound every pairwise angle:
        # max_i d(i, 0) >= thr        -> pair (i, 0) qualifies: KEEP;
        # top1 + top2 deviations < thr -> all pairs < thr:       DELETE.
        # Only the thin ambiguous band needs the O(T^2) pairwise check.
        # This replaces the previous (m, T, T) Gram cube (33 s on an
        # 11.5k-point / 40-mean-track model; this path is ~0.1 s).
        rays = centers_tab[uk % n_img] - xyz_tab[p_of]
        nrm = np.linalg.norm(rays, axis=-1)
        good = nrm > 1e-12
        p_of, rays, nrm = p_of[good], rays[good], nrm[good]
        cnt = np.bincount(p_of, minlength=m)
        u = rays / nrm[:, None]
        ptr = np.concatenate([[0], np.cumsum(cnt)])
        first = np.zeros(len(p_of), np.int64)
        first[:] = ptr[p_of]  # index of each point's reference ray
        dev = np.arccos(np.clip(np.abs(np.sum(u * u[first], axis=1)),
                                -1.0, 1.0))
        # Per-point top-2 deviations via one lexsort.
        order = np.lexsort((dev, p_of))
        top1 = np.zeros(m)
        top2 = np.zeros(m)
        has = cnt > 0
        top1[p_of[order[ptr[1:][has] - 1]]] = dev[order[ptr[1:][has] - 1]]
        two = cnt > 1
        top2[p_of[order[ptr[1:][two] - 2]]] = dev[order[ptr[1:][two] - 2]]

        keep = (cnt >= 2) & (top1 >= min_rad)
        delete = (cnt < 2) | ((top1 + top2) < min_rad)
        ambiguous = ~keep & ~delete
        if ambiguous.any():
            cos_thr = np.cos(min_rad)
            for k in np.nonzero(ambiguous)[0]:
                seg = order[ptr[k]:ptr[k + 1]]
                uu = u[seg]
                G = np.abs(uu @ uu.T)
                np.fill_diagonal(G, 2.0)
                if G.min() <= cos_thr:
                    keep[k] = True
                else:
                    delete[k] = True

        num_filtered = 0
        for k in np.nonzero(delete)[0]:
            num_filtered += 1
            self.delete_point3d(int(pid_arr[k]))
        return num_filtered

    def filter_observations_with_negative_depth(self) -> int:
        """``reconstruction.cc:442``-ish: drop observations behind camera."""
        pid_arr = np.array(sorted(self.points3d.keys()), np.int64)
        if len(pid_arr) == 0:
            return 0
        obs_img, obs_li, obs_idx, _ = self._flat_track_obs(pid_arr)
        xyz_tab = np.stack([self.points3d[int(p)].xyz for p in pid_arr])
        z = np.empty(len(obs_img))
        for iid in np.unique(obs_img):
            sel = obs_img == iid
            proj = self.images[int(iid)].projection_matrix()
            z[sel] = xyz_tab[obs_idx[sel]] @ proj[2, :3] + proj[2, 3]
        n = 0
        for i, l in zip(obs_img[z <= 0], obs_li[z <= 0]):
            self.delete_observation(int(i), int(l))
            n += 1
        return n

    def filter_images(self, min_focal_ratio=0.1, max_focal_ratio=10.0,
                      max_extra_param=1.0) -> List[int]:
        """De-register images with no 3D points or bogus cameras
        (``reconstruction.cc`` FilterImages)."""
        filtered = []
        from privacy_preserving_sfm_torch.ops import cameras as cam_ops
        for iid in list(self.reg_image_ids):
            img = self.images[iid]
            cam = self.cameras[img.camera_id]
            bogus = cam_ops.has_bogus_params(
                cam.model, cam.params, cam.width, cam.height,
                min_focal_ratio, max_focal_ratio, max_extra_param)
            if img.num_points3d() == 0 or bogus:
                filtered.append(iid)
        for iid in filtered:
            self.deregister_image(iid)
        return filtered

    def compute_mean_reprojection_error(self) -> float:
        errs = [p.error for p in self.points3d.values() if p.error >= 0]
        return float(np.mean(errs)) if errs else 0.0

    def compute_mean_track_length(self) -> float:
        if not self.points3d:
            return 0.0
        return float(np.mean([len(p.track) for p in self.points3d.values()]))

    def num_observations(self) -> int:
        return sum(len(p.track) for p in self.points3d.values())

    # -- normalization ---------------------------------------------------

    def normalize(self, extent: float = 10.0, p0: float = 0.1,
                  p1: float = 0.9, use_images: bool = True):
        """Robust-bbox rescale + recenter (``reconstruction.cc:302-361``)."""
        if use_images and len(self.reg_image_ids) < 2:
            return
        if not use_images and len(self.points3d) < 2:
            return
        if use_images:
            coords = np.stack([self.images[i].projection_center()
                               for i in self.reg_image_ids])
        else:
            coords = np.stack([p.xyz for p in self.points3d.values()])
        coords_sorted = np.sort(coords.astype(np.float32), axis=0)
        n = coords_sorted.shape[0]
        P0 = int(p0 * (n - 1)) if n > 3 else 0
        P1 = int(p1 * (n - 1)) if n > 3 else n - 1
        bbox_min = coords_sorted[P0]
        bbox_max = coords_sorted[P1]
        mean_coord = coords_sorted[P0:P1 + 1].mean(axis=0).astype(np.float64)
        old_extent = float(np.linalg.norm(bbox_max - bbox_min))
        scale = 1.0 if old_extent < 1e-15 else extent / old_extent
        self.transform(scale, np.eye(3), -scale * mean_coord)

    def transform(self, scale: float, R: np.ndarray, t: np.ndarray):
        """Apply similarity x -> scale * R x + t to the world frame."""
        from privacy_preserving_sfm_torch.ops import lie_np
        for img in self.images.values():
            if not img.registered:
                continue
            # World->cam: x_c = Rc x_w + tc; new world coords:
            # x_w = (R^T (x'_w - t)) / scale
            Rc = img.rotation_matrix()
            Rc_new = Rc @ R.T
            t_new = img.tvec * scale - Rc_new @ t
            img.qvec = lie_np.rotmat_to_quat(Rc_new)
            img.tvec = t_new
        for pt in self.points3d.values():
            pt.xyz = scale * (R @ pt.xyz) + t

    # -- text model IO (reference-compatible) ----------------------------

    def write_text(self, path: str):
        os.makedirs(path, exist_ok=True)
        self._write_cameras_text(os.path.join(path, "cameras.txt"))
        self._write_images_text(os.path.join(path, "images.txt"))
        self._write_points3d_text(os.path.join(path, "points3D.txt"))

    def _write_cameras_text(self, path: str):
        with open(path, "w") as f:
            f.write("# Camera list with one line of data per camera:\n")
            f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
            f.write(f"# Number of cameras: {len(self.cameras)}\n")
            for cid in sorted(self.cameras):
                c = self.cameras[cid]
                params = " ".join(repr(float(p)) for p in c.params)
                f.write(f"{cid} {c.model} {c.width} {c.height} {params}\n")

    def _write_images_text(self, path: str):
        mean_obs = (self.num_observations() / max(1, len(self.reg_image_ids)))
        with open(path, "w") as f:
            f.write("# Image list with two lines of data per image:\n")
            f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, "
                    "NAME\n")
            f.write("#   LINES2D[] as (A, B, C, is_aligned, POINT3D_ID)\n")
            f.write(f"# Number of images: {len(self.reg_image_ids)}, "
                    f"mean observations per image: {mean_obs}\n")
            for iid in sorted(self.images):
                img = self.images[iid]
                if not img.registered:
                    continue
                q = [float(v) for v in img.qvec / np.linalg.norm(img.qvec)]
                t = [float(v) for v in img.tvec]
                f.write(f"{iid} {q[0]!r} {q[1]!r} {q[2]!r} {q[3]!r} "
                        f"{t[0]!r} {t[1]!r} {t[2]!r} "
                        f"{img.camera_id} {img.name}\n")
                n = img.num_lines
                f.write(" ".join(
                    f"{a!r} {b!r} {c!r} {'1' if al else '0'} "
                    f"{pid if pid != _INVALID else -1}"
                    for (a, b, c), al, pid in zip(
                        np.asarray(img.lines[:n], float).tolist(),
                        np.asarray(img.aligned[:n]).tolist(),
                        np.asarray(img.point3d_ids[:n], np.int64).tolist()))
                        + "\n")

    def _write_points3d_text(self, path: str):
        mean_track = self.compute_mean_track_length()
        with open(path, "w") as f:
            f.write("# 3D point list with one line of data per point:\n")
            f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                    "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
            f.write(f"# Number of points: {len(self.points3d)}, "
                    f"mean track length: {mean_track}\n")
            for pid in sorted(self.points3d):
                p = self.points3d[pid]
                track = " ".join(f"{iid} {li}" for iid, li in p.track)
                r, g, b = p.color
                x, y, z = (float(v) for v in p.xyz)
                f.write(f"{pid} {x!r} {y!r} {z!r} "
                        f"{r} {g} {b} {float(p.error)!r} {track}\n")

    @classmethod
    def read_text(cls, path: str) -> "Reconstruction":
        rec = cls()
        with open(os.path.join(path, "cameras.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                cid = int(parts[0])
                rec.add_camera(Camera(
                    camera_id=cid, model=parts[1], width=int(parts[2]),
                    height=int(parts[3]),
                    params=np.asarray([float(p) for p in parts[4:]])))
        with open(os.path.join(path, "images.txt")) as f:
            content = [l.strip() for l in f
                       if l.strip() and not l.startswith("#")]
        for i in range(0, len(content), 2):
            parts = content[i].split()
            iid = int(parts[0])
            img = Image(
                image_id=iid, name=parts[9], camera_id=int(parts[8]),
                qvec=np.asarray([float(p) for p in parts[1:5]]),
                tvec=np.asarray([float(p) for p in parts[5:8]]))
            lparts = content[i + 1].split()
            n = len(lparts) // 5
            lparts = lparts[:5 * n]
            img.lines = np.stack([np.fromiter(map(float, lparts[k::5]),
                                              float, n) for k in range(3)],
                                 axis=1)
            img.aligned = np.array([t == "1" for t in lparts[3::5]], bool)
            img.point3d_ids = np.fromiter(map(int, lparts[4::5]), np.int64,
                                          n)
            rec.add_image(img)
            rec.register_image(iid)
        pts_path = os.path.join(path, "points3D.txt")
        if os.path.exists(pts_path):
            with open(pts_path) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    parts = line.split()
                    pid = int(parts[0])
                    xyz = np.asarray([float(p) for p in parts[1:4]])
                    err = float(parts[7])
                    track = [(int(parts[8 + 2 * k]), int(parts[9 + 2 * k]))
                             for k in range((len(parts) - 8) // 2)]
                    rec.points3d[pid] = Point3D(xyz=xyz, track=track,
                                                error=err)
                    rec._next_point_id = max(rec._next_point_id, pid + 1)
        return rec

    def write_ply(self, path: str):
        """Point cloud export as ASCII PLY (``reconstruction.cc:555-592``):
        each point's position and color."""
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {len(self.points3d)}\n")
            f.write("property float x\nproperty float y\nproperty float z\n")
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\nend_header\n")
            for p in self.points3d.values():
                r, g, b = p.color
                f.write(f"{p.xyz[0]} {p.xyz[1]} {p.xyz[2]} {r} {g} {b}\n")
