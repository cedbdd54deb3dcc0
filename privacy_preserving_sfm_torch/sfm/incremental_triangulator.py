"""Incremental triangulator: Find/Create/Continue/Merge/Complete.

Port of ``privacy_preserving_sfm_tpu/sfm/incremental_triangulator.py``:
host code over ``src/sfm/incremental_triangulator.{h,cc}`` that drives the
batched torch estimators in ``solvers/triangulation`` and
``solvers/triangulation_batch`` on the triangulator's device and dtype:

  * ``Create``: needs >= 3 untriangulated observations AND >= 1 random
    (non-aligned) line (``incremental_triangulator.cc:480-514``); robust
    angular-error LORANSAC over every Create pool of an image in batched
    calls; re-create on >= 3 leftovers (``:555-558``) in following rounds;
  * ``Continue``: attach to the best existing point by angular error
    <= continue_max_angle_error (``:563-604``);
  * ``Merge``: weighted-centroid merge accepted only when ALL observations
    of both tracks pass the pixel line reprojection error, recursive
    (``:606-695``);
  * ``Complete``: transitive BFS growth (<= complete_max_transitivity hops)
    by pixel line error (``:697-765``);
  * ``CompleteImage``: additionally re-tries untriangulated observations
    with a pixel-residual LORANSAC (``:124-236``).

Find and the graph walks read the flat CSR ``GraphView`` of the database
cache; Find takes the direct correspondences (the reference's default
``max_transitivity`` of 1).

Options defaults = ``incremental_triangulator.h:47-90``.  The pool-size
buckets ``N_BUCKETS`` choose which triples a pool tries, so they are kept;
the reference's padding of the track count to a x4 grid (compile keys)
is not: a call solves exactly its tracks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Set

import numpy as np
import torch

from privacy_preserving_sfm_torch.models.graph_view import GraphView
from privacy_preserving_sfm_torch.models.reconstruction import Reconstruction
from privacy_preserving_sfm_torch.ops import lines_np
from privacy_preserving_sfm_torch.solvers import triangulation_batch as tri_batch

MAX_POOL = 24  # overall observation cap of one estimator call
# Pool-size buckets for the batch solver: a pool of n observations runs at
# the smallest bucket >= n, paying C(bucket, 3) hypotheses (<= 512 sampled
# at bucket 24) instead of a fixed C(24,3) = 2024.
N_BUCKETS = (4, 9, 24)
T_CHUNK = 1024  # max tracks per device call (bounds its temporaries)


@dataclasses.dataclass
class TriangulatorOptions:
    create_max_angle_error: float = 2.0  # degrees
    continue_max_angle_error: float = 2.0  # degrees
    merge_max_reproj_error: float = 4.0  # pixels
    complete_max_reproj_error: float = 4.0  # pixels
    complete_max_transitivity: int = 5
    min_angle: float = 1.5  # degrees
    ignore_two_view_tracks: bool = True


class IncrementalTriangulator:
    def __init__(self, rec: Reconstruction, view: GraphView, *,
                 device: torch.device, dtype: torch.dtype):
        if view is None:
            raise ValueError("the triangulator needs the graph's CSR view")
        self.rec = rec
        self.view = view
        self.device = torch.device(device)
        self.dtype = dtype
        self.modified_point3d_ids: Set[int] = set()
        self._merge_trials: Dict[int, Set[int]] = {}
        self._two_view_cache: Dict[int, np.ndarray] = {}
        self.phase_times: Dict[str, float] = {}

    def _tick(self, name: str, t0: float) -> float:
        """Accumulate wall time into the sub-phase profile; returns now."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.phase_times[name] = self.phase_times.get(name, 0.0) + (now - t0)
        return now

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.device, dtype=self.dtype)

    # -- vectorized graph helpers ---------------------------------------

    def _corrs(self, image_id: int, line_idx: int):
        """Correspondences of one feature from the CSR view."""
        view = self.view
        f = int(view.feat_offset[view.dense[image_id]]) + line_idx
        a, b = view.row_offsets[f], view.row_offsets[f + 1]
        return [(int(view.image_id_arr[view.corr_img_dense[j]]),
                 int(view.corr_line[j])) for j in range(a, b)]

    def _registered_dense(self, view) -> np.ndarray:
        out = np.zeros(len(view.image_ids), bool)
        for d, iid in enumerate(view.image_ids):
            img = self.rec.images.get(iid)
            out[d] = img is not None and img.registered
        return out

    def _tri_flat(self, view) -> np.ndarray:
        """Flat per-feature bool: feature currently triangulated."""
        return view.concat_per_image(
            lambda iid: self.rec.images[iid].point3d_ids >= 0
            if iid in self.rec.images
            else np.zeros(view.num_lines[view.dense[iid]], bool))

    def _find_all(self, image_id: int):
        """Find for every line of an image in one vectorized pass: the
        correspondences in registered images and how many of them are
        triangulated.

        Returns [(line_idx, pool, num_triangulated)] for lines with a
        non-empty registered-correspondence pool.
        """
        view = self.view
        s, e = view.corr_range(image_id)
        cim = view.corr_img_dense[s:e]
        cfl = view.corr_flat[s:e]
        cline = view.corr_line[s:e]
        reg = self._registered_dense(view)
        tri = self._tri_flat(view)
        mask = reg[cim]
        ro = view.image_row_offsets(image_id)
        base = ro[0]
        img_ids = view.image_id_arr
        cs = np.concatenate([[0], np.cumsum(mask)])
        out = []
        for li in range(len(ro) - 1):
            a, b = int(ro[li] - base), int(ro[li + 1] - base)
            if cs[b] - cs[a] == 0:
                continue
            idx = np.nonzero(mask[a:b])[0] + a
            pool = [(int(img_ids[cim[j]]), int(cline[j])) for j in idx]
            ntri = int(np.count_nonzero(tri[cfl[idx]]))
            out.append((li, pool, ntri))
        return out

    def _is_two_view(self, image_id: int, line_idx: int) -> bool:
        if image_id not in self._two_view_cache:
            self._two_view_cache[image_id] = \
                self.view.two_view_flags(image_id)
        return bool(self._two_view_cache[image_id][line_idx])

    # -- Continue --------------------------------------------------------

    def _continue(self, options: TriangulatorOptions, image_id: int,
                  line_idx: int, pool) -> int:
        img = self.rec.images[image_id]
        if img.point3d_ids[line_idx] >= 0:
            return 0
        # One vectorized angular-error evaluation over all candidate points
        # (single camera: the image being continued).
        pids: List[int] = []
        seen: Set[int] = set()
        for iid, li in pool:
            pid = int(self.rec.images[iid].point3d_ids[li])
            if pid >= 0 and pid not in seen:
                seen.add(pid)
                pids.append(pid)
        best_err = np.inf
        best_pid = None
        if pids:
            cam = self.rec.cameras[img.camera_id]
            xyzs = np.stack([self.rec.points3d[p].xyz for p in pids])
            errs = lines_np.line_angular_error(
                img.lines[line_idx], xyzs, img.projection_matrix(),
                cam.model, cam.params, cam.width, cam.height)
            k = int(np.argmin(errs))
            best_err = float(errs[k])
            best_pid = pids[k]
        if best_pid is not None and \
                best_err <= np.deg2rad(options.continue_max_angle_error):
            self.rec.add_observation(best_pid, image_id, line_idx)
            self.modified_point3d_ids.add(best_pid)
            return 1
        return 0

    # -- batched create (one batched call per image) --------------------

    def _solve_pools(self, pools, residual: str, max_err, min_ang_rad,
                     phase: str):
        """Solve many pools: bucket by pool size, chunk the track axis.

        Pool-size buckets keep the combination count proportional to the
        actual pool (a 4-obs init pool pays C(4,3)=4 hypotheses, not
        C(24,3)=2024), and the SoA estimator bounds the padded-layout HBM
        footprint; chunking bounds peak memory on huge rounds.

        Returns (success (T,), inlier_mask (T, MAX_POOL), xyz (T, 3))
        aligned with ``pools``.
        """
        T = len(pools)
        success = np.zeros(T, bool)
        inl = np.zeros((T, MAX_POOL), bool)
        xyz = np.zeros((T, 3))
        sizes = np.fromiter((min(len(p), MAX_POOL) for p in pools),
                            np.int64, T)
        cam0 = self.rec.cameras[self.rec.images[pools[0][0][0]].camera_id]
        prev = 0
        for nb in N_BUCKETS:
            sel = np.nonzero((sizes > prev) & (sizes <= nb))[0]
            prev = nb
            for lo in range(0, len(sel), T_CHUNK):
                idx = sel[lo:lo + T_CHUNK]
                sub = [pools[i] for i in idx]
                t0 = time.perf_counter()
                lines, projs, centers, params, valid, _ = \
                    self._pools_to_arrays(sub, len(sub), nb)
                t0 = self._tick(f"{phase}_pack", t0)
                res = tri_batch.estimate_triangulation_batch(
                    self._tensor(lines), self._tensor(projs),
                    self._tensor(centers), self._tensor(params),
                    torch.from_numpy(valid).to(self.device), cam0.model,
                    cam0.width, cam0.height, max_err, min_ang_rad,
                    residual=residual)
                success[idx] = res.success.cpu().numpy()
                inl[idx, :nb] = res.inlier_mask.cpu().numpy()
                xyz[idx] = res.point3d.cpu().numpy()
                self._tick(f"{phase}_solve", t0)
        return success, inl, xyz

    def lines_changed(self):
        """Drop the line table: an intrinsics bake moved the lines."""
        self._lines_flat = None

    def _flat_tables(self):
        """Per-feature line table + per-call pose/param tables.

        Lines change only when the mapper bakes an intrinsics correction
        into them (``lines_changed``), so the (total_lines, 3) table is
        built once and after each bake; projection matrices/centers/params
        are refreshed from the live reconstruction each call (cheap: one
        small matmul per image)."""
        view = self.view
        if getattr(self, "_lines_flat", None) is None:
            self._lines_flat = np.concatenate(
                [np.asarray(self.rec.images[iid].lines)
                 for iid in view.image_ids])
        n_img = len(view.image_ids)
        any_cam = next(iter(self.rec.cameras.values()))
        n_par = len(any_cam.params)
        proj = np.tile(np.eye(3, 4), (n_img, 1, 1))
        centers = np.zeros((n_img, 3))
        params = np.tile(any_cam.params, (n_img, 1))
        for d, iid in enumerate(view.image_ids):
            img = self.rec.images.get(iid)
            if img is not None and img.registered:
                proj[d] = img.projection_matrix()
                centers[d] = img.projection_center()
                params[d] = self.rec.cameras[img.camera_id].params
        return self._lines_flat, proj, centers, params

    def _pools_to_arrays(self, pools, t_bucket: int, n_pool: int = MAX_POOL):
        """Pad T pools to (t_bucket, n_pool) fixed-shape solver inputs.

        Vectorized: one flat-feature index list comprehension, then pure
        fancy-indexed gathers from the flat tables (the previous per-row
        numpy writes — ~300k single-element assignments per image — were
        a top-3 mapper host cost)."""
        view = self.view
        fo = view.feat_offset
        dense = view.dense
        lines_flat, proj_d, centers_d, params_d = self._flat_tables()
        feat = np.fromiter(
            (int(fo[dense[iid]]) + li
             for pool in pools for iid, li in pool[:n_pool]),
            np.int64)
        sizes = np.fromiter((min(len(p), n_pool) for p in pools),
                            np.int64, len(pools))
        ptr = np.concatenate([[0], np.cumsum(sizes)])
        t_idx = np.repeat(np.arange(len(pools)), sizes)
        slot = np.arange(len(feat)) - ptr[:-1][t_idx]
        img_d = np.searchsorted(fo, feat, "right") - 1

        cam0 = self.rec.cameras[self.rec.images[pools[0][0][0]].camera_id]
        lines = np.zeros((t_bucket, n_pool, 3))
        lines[..., 0] = 1.0
        projs = np.tile(np.eye(3, 4), (t_bucket, n_pool, 1, 1))
        centers = np.zeros((t_bucket, n_pool, 3))
        valid = np.zeros((t_bucket, n_pool), bool)
        params = np.tile(cam0.params, (t_bucket, n_pool, 1))
        lines[t_idx, slot] = lines_flat[feat]
        projs[t_idx, slot] = proj_d[img_d]
        centers[t_idx, slot] = centers_d[img_d]
        params[t_idx, slot] = params_d[img_d]
        valid[t_idx, slot] = True
        return lines, projs, centers, params, valid, cam0

    def _batched_create(self, options: TriangulatorOptions, pools) -> int:
        """Triangulate many Create pools with batched calls per round.

        Departure from the reference's strictly sequential per-feature
        loop: all pools of an image are solved against the SAME snapshot of
        the reconstruction, and results are applied in order, dropping
        observations claimed by an earlier track in the batch.  Occasional
        duplicate points are cleaned by the (reference-exact) Merge step.
        Leftover pools (>= 3 unclaimed observations) re-run in following
        rounds, mirroring the recursive re-create.
        """
        num_tris = 0
        rounds = 0
        while pools and rounds < 4:
            rounds += 1
            t0 = time.perf_counter()
            success, inl, xyz = self._solve_pools(
                pools, "angular",
                np.deg2rad(options.create_max_angle_error),
                np.deg2rad(options.min_angle), "tri/create")

            next_pools = []
            for t, pool in enumerate(pools):
                if not success[t]:
                    continue
                track = [pool[i] for i in range(min(len(pool), MAX_POOL))
                         if inl[t, i] and
                         self.rec.images[pool[i][0]].point3d_ids[pool[i][1]] < 0]
                if len(track) < 2:
                    continue
                pid = self.rec.add_point3d(xyz[t], track)
                self.modified_point3d_ids.add(pid)
                num_tris += len(track)
                leftovers = [
                    (iid, li) for iid, li in pool
                    if self.rec.images[iid].point3d_ids[li] < 0]
                if len(leftovers) >= 3 and any(
                        not self.rec.images[iid].aligned[li]
                        for iid, li in leftovers):
                    next_pools.append(leftovers)
            self._tick("tri/create_apply", t0)
            pools = next_pools
        return num_tris

    # -- public API ------------------------------------------------------

    def triangulate_image(self, options: TriangulatorOptions,
                          image_id: int) -> int:
        """``TriangulateImage`` (``incremental_triangulator.cc:63-121``),
        with every Create solve of the image in batched device calls (see
        ``_batched_create``)."""
        num_tris = 0
        self._merge_trials.clear()
        img = self.rec.images[image_id]
        if not img.registered:
            return 0
        # Pass 1: Find everything; Continue (cheap, state-dependent) first.
        t0 = time.perf_counter()
        found = []
        all_found = self._find_all(image_id)
        t0 = self._tick("tri/find", t0)
        for line_idx, pool, num_triangulated in all_found:
            if num_triangulated > 0:
                num_tris += self._continue(options, image_id, line_idx, pool)
            found.append((line_idx, pool))
        t0 = self._tick("tri/continue", t0)

        # Pass 2: assemble Create pools against the post-Continue state.
        pools = []
        for line_idx, pool in found:
            full = pool + [(image_id, line_idx)]
            create_pool = [
                (iid, li) for iid, li in full
                if self.rec.images[iid].point3d_ids[li] < 0]
            if len(create_pool) < 3:
                continue
            if not any(not self.rec.images[iid].aligned[li]
                       for iid, li in create_pool):
                continue
            pools.append(create_pool)
        t0 = self._tick("tri/assemble", t0)
        num_tris += self._batched_create(options, pools)
        self._tick("tri/create", t0)
        return num_tris

    def complete_image(self, options: TriangulatorOptions,
                       image_id: int) -> int:
        """``CompleteImage`` (``incremental_triangulator.cc:123-236``)."""
        num_tris = 0
        self._merge_trials.clear()
        img = self.rec.images[image_id]
        if not img.registered:
            return 0
        t0 = time.perf_counter()
        found = {li: (pool, ntri)
                 for li, pool, ntri in self._find_all(image_id)}
        t0 = self._tick("cmp/find", t0)
        # Complete every already-triangulated observation of the image in
        # one batched BFS, then grow fresh tracks over the remaining lines.
        tri_pids = []
        seen_pids: Set[int] = set()
        for line_idx in range(img.num_lines):
            pid = int(img.point3d_ids[line_idx])
            if pid >= 0 and pid not in seen_pids:
                seen_pids.add(pid)
                tri_pids.append(pid)
        num_tris += self._complete_batch(options, tri_pids)
        t0 = self._tick("cmp/bfs", t0)
        # Assemble every fresh pool against the post-complete state, then
        # solve them all with batched pixel-residual LORANSAC calls.
        fresh = []
        for line_idx in range(img.num_lines):
            pid = int(img.point3d_ids[line_idx])
            if pid >= 0:
                continue
            if options.ignore_two_view_tracks and \
                    self._is_two_view(image_id, line_idx):
                continue
            pool, num_triangulated = found.get(line_idx, ([], 0))
            if num_triangulated or not pool:
                continue
            if any(self.rec.images[iid].point3d_ids[li] >= 0
                   for iid, li in pool):
                continue
            full = pool + [(image_id, line_idx)]
            if len(full) < 3:
                continue
            fresh.append(full)
        if fresh:
            success, inl, xyz = self._solve_pools(
                fresh, "pixel", options.complete_max_reproj_error,
                np.deg2rad(options.min_angle), "cmp/fresh")
            t0 = self._tick("cmp/fresh_solve", t0)
            for t, full in enumerate(fresh):
                if not success[t]:
                    continue
                # Live claim check: an earlier pool in this batch may have
                # claimed a shared observation.
                track = [full[i] for i in range(min(len(full), MAX_POOL))
                         if inl[t, i] and self.rec.images[full[i][0]]
                         .point3d_ids[full[i][1]] < 0]
                if len(track) < 2:
                    continue
                pid = self.rec.add_point3d(xyz[t], track)
                self.modified_point3d_ids.add(pid)
                num_tris += len(track)
        self._tick("cmp/fresh", t0)
        return num_tris

    def _merge(self, options: TriangulatorOptions, pid: int) -> int:
        """Merge with corresponding tracks
        (``incremental_triangulator.cc:606-695``)."""
        if pid not in self.rec.points3d:
            return 0
        max_sq = options.merge_max_reproj_error ** 2
        point = self.rec.points3d[pid]
        for iid, li in list(point.track):
            for ciid, cli in self._corrs(iid, li):
                img = self.rec.images.get(ciid)
                if img is None or not img.registered:
                    continue
                cpid = int(img.point3d_ids[cli])
                if cpid < 0 or cpid == pid:
                    continue
                if cpid in self._merge_trials.setdefault(pid, set()):
                    continue
                self._merge_trials.setdefault(pid, set()).add(cpid)
                self._merge_trials.setdefault(cpid, set()).add(pid)
                corr_point = self.rec.points3d[cpid]
                n1, n2 = len(point.track), len(corr_point.track)
                merged_xyz = (n1 * point.xyz + n2 * corr_point.xyz) / (n1 + n2)
                both = list(point.track) + list(corr_point.track)
                errs = self.rec.batch_squared_line_errors(
                    np.asarray([o[0] for o in both]),
                    np.asarray([o[1] for o in both]), merged_xyz)
                ok = bool(np.all(errs <= max_sq))
                if ok:
                    num_merged = n1 + n2
                    mpid = self.rec.merge_points3d(pid, cpid)
                    self.modified_point3d_ids.discard(pid)
                    self.modified_point3d_ids.discard(cpid)
                    self.modified_point3d_ids.add(mpid)
                    rec_merged = self._merge(options, mpid)
                    return rec_merged if rec_merged > 0 else num_merged
        return 0

    def merge_tracks(self, options: TriangulatorOptions,
                     point3d_ids: Set[int]) -> int:
        self._merge_trials.clear()
        return self._merge_batch(options, list(point3d_ids))

    def _merge_batch(self, options: TriangulatorOptions,
                     pids: List[int]) -> int:
        """Merge candidate discovery for MANY points, vectorized.

        One CSR expansion finds every (point, corresponding-point) pair
        instead of a Python ``_corrs`` walk per observation (which was
        ~80% of merge wall time); the trials themselves run sequentially
        with the exact accept rule of ``_merge``
        (``incremental_triangulator.cc:606-695``).  Deviation: candidate
        order is (point, flat-feature) rather than (point, track-insertion)
        order, which can pick a different (equally valid) merge when two
        partners both pass.
        """
        pids = [p for p in pids if p in self.rec.points3d]
        if not pids:
            return 0
        rec = self.rec
        view = self.view
        # Flat per-feature pid table (int64, -1 = untriangulated).
        pid_flat = view.concat_per_image(
            lambda iid: np.asarray(rec.images[iid].point3d_ids, np.int64)
            if iid in rec.images
            else np.full(int(view.num_lines[view.dense[iid]]), -1, np.int64))
        reg_flat = np.repeat(self._registered_dense(view), view.num_lines)
        pid_arr = np.asarray(pids, np.int64)

        src = np.nonzero(np.isin(pid_flat, pid_arr))[0]
        spid = pid_flat[src]
        # Group source features by the pids' given order.
        pid_order = np.argsort(pid_arr, kind="stable")
        k_of = pid_order[np.searchsorted(pid_arr[pid_order], spid)]
        by_k = np.argsort(k_of, kind="stable")
        src, spid = src[by_k], spid[by_k]

        ro = view.row_offsets
        starts = ro[src]
        degs = ro[src + 1] - starts
        m = int(degs.sum())
        if m == 0:
            return 0
        rep = np.repeat(np.arange(len(src)), degs)
        offs = np.arange(m) - np.repeat(np.cumsum(degs) - degs, degs)
        tgt = view.corr_flat[starts[rep] + offs]
        cpid = pid_flat[tgt]
        spid_e = spid[rep]
        keep = (cpid >= 0) & (cpid != spid_e) & reg_flat[tgt]
        cand_s, cand_c = spid_e[keep], cpid[keep]

        num_merged_total = 0
        max_sq = options.merge_max_reproj_error ** 2
        for s, c in zip(cand_s.tolist(), cand_c.tolist()):
            if s not in rec.points3d or c not in rec.points3d:
                continue  # merged away earlier in this call
            if c in self._merge_trials.setdefault(s, set()):
                continue
            self._merge_trials.setdefault(s, set()).add(c)
            self._merge_trials.setdefault(c, set()).add(s)
            point, corr_point = rec.points3d[s], rec.points3d[c]
            n1, n2 = len(point.track), len(corr_point.track)
            merged_xyz = (n1 * point.xyz + n2 * corr_point.xyz) / (n1 + n2)
            both = list(point.track) + list(corr_point.track)
            errs = rec.batch_squared_line_errors(
                np.asarray([o[0] for o in both]),
                np.asarray([o[1] for o in both]), merged_xyz)
            if not bool(np.all(errs <= max_sq)):
                continue
            mpid = rec.merge_points3d(s, c)
            self.modified_point3d_ids.discard(s)
            self.modified_point3d_ids.discard(c)
            self.modified_point3d_ids.add(mpid)
            rec_merged = self._merge(options, mpid)
            num_merged_total += rec_merged if rec_merged > 0 else n1 + n2
        return num_merged_total

    def merge_all_tracks(self, options: TriangulatorOptions) -> int:
        return self.merge_tracks(options, set(self.rec.points3d.keys()))

    def _complete_batch(self, options: TriangulatorOptions,
                        pids: List[int]) -> int:
        """Transitive track growth for MANY points, vectorized.

        Level-synchronous BFS over the CSR graph view: each transitivity
        level expands every point's frontier at once, gates all candidate
        observations with one vectorized pixel-error call, and claims
        contested features first-come-first-served in frontier order.
        Same accept criterion as the reference's per-point Complete
        (``incremental_triangulator.cc:697-765``); the only deviation is
        claim ordering when two points reach the same feature at
        different levels (the per-point walk finishes point A's whole BFS
        before starting B).  O(levels) numpy calls.
        """
        view = self.view
        pids = [p for p in pids if p in self.rec.points3d]
        if not pids:
            return 0
        max_sq = options.complete_max_reproj_error ** 2
        fo = view.feat_offset
        ro = view.row_offsets
        reg_img = np.array(
            [self.rec.images.get(iid) is not None
             and self.rec.images[iid].registered
             for iid in view.image_ids])
        reg_flat = np.repeat(reg_img, view.num_lines)
        tri_flat = np.concatenate([
            np.asarray(self.rec.images[iid].point3d_ids, np.int64)
            if iid in self.rec.images
            else np.full(int(view.num_lines[d]), -1, np.int64)
            for d, iid in enumerate(view.image_ids)])
        xyz = np.stack([self.rec.points3d[p].xyz for p in pids])

        # Frontier seeding from the flat per-image point3d_id table
        # (tri_flat[f] == pid is the inverse of Track membership for every
        # image in the view, so no per-track Python walk is needed).
        pid_arr = np.asarray(pids, np.int64)
        fr_feat_a = np.nonzero(np.isin(tri_flat, pid_arr))[0]
        pid_order = np.argsort(pid_arr, kind="stable")
        fr_pid_a = pid_order[np.searchsorted(
            pid_arr[pid_order], tri_flat[fr_feat_a])]

        total = 0
        for level in range(options.complete_max_transitivity):
            if len(fr_feat_a) == 0:
                break
            starts = ro[fr_feat_a]
            degs = ro[fr_feat_a + 1] - starts
            m = int(degs.sum())
            if m == 0:
                break
            rep = np.repeat(np.arange(len(fr_feat_a)), degs)
            offs = np.arange(m) - np.repeat(np.cumsum(degs) - degs, degs)
            j = starts[rep] + offs
            tgt = view.corr_flat[j]  # flat feature index of the target
            keep = reg_flat[tgt] & (tri_flat[tgt] < 0)
            tgt, cpid = tgt[keep], fr_pid_a[rep[keep]]
            tgt_img_d = view.corr_img_dense[j[keep]]
            if len(tgt) == 0:
                break
            # Dedup (point, feature) pairs, keeping frontier order.
            key = cpid * np.int64(view.total_lines) + tgt
            _, first_idx = np.unique(key, return_index=True)
            order = np.sort(first_idx)
            tgt, cpid, tgt_img_d = tgt[order], cpid[order], tgt_img_d[order]
            iids = view.image_id_arr[tgt_img_d]
            lis = tgt - fo[tgt_img_d]
            errs = self.rec.batch_squared_line_errors(iids, lis, xyz[cpid])
            acc = errs <= max_sq
            tgt, cpid, iids, lis = tgt[acc], cpid[acc], iids[acc], lis[acc]
            if len(tgt) == 0:
                continue
            # Contested features: first claim in frontier order wins.
            _, fi2 = np.unique(tgt, return_index=True)
            order2 = np.sort(fi2)
            tgt, cpid, iids, lis = (tgt[order2], cpid[order2], iids[order2],
                                    lis[order2])
            for k, iid, li in zip(cpid, iids, lis):
                self.rec.add_observation(pids[int(k)], int(iid), int(li))
                self.modified_point3d_ids.add(pids[int(k)])
            tri_flat[tgt] = 1  # claimed; exact pid value not needed here
            total += len(tgt)
            if level < options.complete_max_transitivity - 1:
                fr_pid_a, fr_feat_a = cpid, tgt
            else:
                break
        return total

    def complete_tracks(self, options: TriangulatorOptions,
                        point3d_ids: Set[int]) -> int:
        return self._complete_batch(options, list(point3d_ids))

    def complete_all_tracks(self, options: TriangulatorOptions) -> int:
        return self.complete_tracks(options, set(self.rec.points3d.keys()))

