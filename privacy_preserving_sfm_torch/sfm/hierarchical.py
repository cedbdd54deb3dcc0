"""Block-parallel (hierarchical) mapper.

Port of ``privacy_preserving_sfm_tpu/sfm/hierarchical.py`` (upstream
COLMAP's HierarchicalMapper role, absent from the reference fork, which
reconstructs strictly sequentially, ``controllers/incremental_mapper.cc:
382-591``): partition the collection into blocks with shared anchor
images, reconstruct every block with the incremental controller, in
worker processes where asked, then chain-merge:

  1. ``partition_sequential``: contiguous blocks of the name-sorted images
     with ``overlap`` shared images (sequential capture order);
  2. each block reconstructed by ``IncrementalMapperController`` on a
     cache restricted by ``DatabaseCache.load(image_names=...)``, which
     keeps the database's image ids;
  3. ``merge_into``: Umeyama similarity on shared camera centres (block 0
     fixes the gauge), pose copy for new images, track union keyed on
     shared (image, line) observations;
  4. one joint iterative global refinement over the full correspondence
     graph, which also triangulates the cross-block tracks.

Blocks run on ``device``: in this process (``num_workers`` 1) or in
``num_workers`` spawned processes (CUDA cannot fork), each given the
device by its full name (``cuda:1`` stays ``cuda:1``); on CUDA the kernel
library is built here first, so the workers only load it.  A worker
returns a snapshot of numpy arrays, never tensors, that names the device
its mapper ran on, index included; ``hierarchical_map`` raises when a
snapshot names another device than the one asked for.
``PPSFM_WORKER_THREADS`` caps each worker's torch threads.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from privacy_preserving_sfm_torch.models.database import Database
from privacy_preserving_sfm_torch.models.database_cache import DatabaseCache
from privacy_preserving_sfm_torch.models.reconstruction import Reconstruction
from privacy_preserving_sfm_torch.ops import lie_np
from privacy_preserving_sfm_torch.sfm.controller import (
    ControllerOptions, IncrementalMapperController,
)
from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
    IncrementalMapper,
)


def partition_sequential(names: Sequence[str], block_size: int,
                         overlap: int) -> List[List[str]]:
    """Contiguous blocks over name-sorted images with ``overlap`` shared."""
    if block_size <= overlap:
        raise ValueError("block_size must exceed overlap")
    names = sorted(names)
    n = len(names)
    blocks: List[List[str]] = []
    start = 0
    while True:
        end = min(start + block_size, n)
        blocks.append(list(names[start:end]))
        if end >= n:
            break
        start = end - overlap
    return blocks


def umeyama(src: np.ndarray, dst: np.ndarray) -> Tuple[float, np.ndarray,
                                                       np.ndarray]:
    """Similarity (s, R, t) with dst ~= s * R @ src + t (Umeyama 1991)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (sc ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-30))
    t = mu_d - s * R @ mu_s
    return s, R, t


def reconstruct_block(database_path: str, image_names: Sequence[str],
                      options: ControllerOptions, device: torch.device,
                      dtype: torch.dtype = torch.float32
                      ) -> Optional[IncrementalMapperController]:
    """Run the incremental controller restricted to ``image_names``;
    returns the controller, None when it wrote no model."""
    with Database(database_path) as db:
        cache = DatabaseCache.load(db, options.min_num_matches,
                                   image_names=set(image_names))
        aligned_names = {img.name for img in cache.images.values()
                         if img.aligned.any()}
        aligned = DatabaseCache.load(db, 4, image_names=aligned_names)
    ctrl = IncrementalMapperController(options, database_cache=cache,
                                       aligned_cache=aligned, device=device,
                                       dtype=dtype)
    return ctrl if ctrl.run() else None


def _block_worker(args) -> Optional[dict]:
    """Reconstruct one block; return its largest model's snapshot (numpy
    only), with the device its mapper ran on, its wall seconds, its
    controller profile and the kernel launches it made."""
    from privacy_preserving_sfm_torch.kernels import build

    database_path, image_names, options, device, dtype = args
    threads = os.environ.get("PPSFM_WORKER_THREADS")
    if threads:
        torch.set_num_threads(int(threads))
    before = dict(build.LAUNCHES)
    t0 = time.perf_counter()
    ctrl = reconstruct_block(database_path, image_names, options,
                             torch.device(device), dtype)
    if ctrl is None:
        return None
    snap = snapshot_model(max(ctrl.reconstructions,
                              key=lambda r: r.num_registered()))
    if ctrl.device.type == "cuda":
        torch.cuda.synchronize(ctrl.device)
    snap.update(device=str(ctrl.device),
                seconds=time.perf_counter() - t0,
                profile=dict(ctrl.profiler.totals),
                launches={k: v - before[k] for k, v in build.LAUNCHES.items()})
    return snap


def snapshot_model(rec: Reconstruction) -> dict:
    """Per registered image (qvec, tvec) and per point (xyz, track)."""
    return {
        "poses": {int(iid): (np.array(rec.images[iid].qvec),
                             np.array(rec.images[iid].tvec))
                  for iid in rec.reg_image_ids},
        "points": [(np.array(pt.xyz), [(int(i), int(l)) for i, l in pt.track])
                   for pt in rec.points3d.values()],
    }


def merge_into(dst: Reconstruction, snap: dict,
               min_common: int = 3) -> bool:
    """Merge a block snapshot into ``dst`` (gauge of ``dst`` wins).

    Alignment uses camera centers of the images registered in both; new
    images copy their (similarity-mapped) block pose; tracks sharing a
    (image, line) observation with an existing dst point merge into it.
    """
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]] = snap["poses"]
    shared = [iid for iid in poses
              if iid in dst.images and dst.images[iid].registered]

    if dst.num_registered() == 0:
        s, R, t = 1.0, np.eye(3), np.zeros(3)
    else:
        if len(shared) < min_common:
            return False

        def center(q, tv):
            return -lie_np.quat_to_rotmat(q).T @ tv

        src_c = np.stack([center(*poses[i]) for i in shared])
        dst_c = np.stack([dst.images[i].projection_center()
                          for i in shared])
        s, R, t = umeyama(src_c, dst_c)

    for iid, (q, tv) in poses.items():
        if iid not in dst.images or dst.images[iid].registered:
            continue  # dst pose wins on shared images
        # World map x' = s R x + t; camera x_c = Rc x + tc becomes
        # Rc' = Rc R^T, tc' = s tc - Rc' t (Reconstruction.transform).
        Rc_new = lie_np.quat_to_rotmat(q) @ R.T
        img = dst.images[iid]
        img.qvec = lie_np.rotmat_to_quat(Rc_new)
        img.tvec = s * tv - Rc_new @ t
        dst.register_image(iid)

    for xyz, track in snap["points"]:
        track = [(i, l) for i, l in track
                 if i in dst.images and dst.images[i].registered]
        if len(track) < 2:
            continue
        target = -1
        for i, l in track:
            pid = int(dst.images[i].point3d_ids[l])
            if pid >= 0:
                target = pid
                break
        if target < 0:
            free = [(i, l) for i, l in track
                    if dst.images[i].point3d_ids[l] < 0]
            if len(free) >= 2:
                dst.add_point3d(s * (R @ xyz) + t, free)
        else:
            for i, l in track:
                if dst.images[i].point3d_ids[l] < 0:
                    dst.add_observation(target, i, l)
    return True


@dataclasses.dataclass
class HierarchicalOptions:
    block_size: int = 30
    overlap: int = 5
    num_workers: int = 1
    min_common: int = 3
    controller: ControllerOptions = dataclasses.field(
        default_factory=ControllerOptions)


def hierarchical_map(database_path: str, options: HierarchicalOptions, *,
                     device: torch.device,
                     dtype: torch.dtype = torch.float32,
                     verbose: bool = True,
                     stats: Optional[dict] = None
                     ) -> Optional[Reconstruction]:
    """Partition -> block SfM (in parallel workers when ``num_workers`` >
    1) -> chain merge -> joint refinement, on ``device`` in ``dtype``.
    ``stats``, when given, receives the block count, the snapshots'
    devices, seconds, profiles and launches, the blocks merged, the
    merged and refined point counts, and the joint refinement's seconds
    and profile."""
    device = torch.device(device)
    stats = {} if stats is None else stats

    def log(msg):
        if verbose:
            print(msg, flush=True)

    ctrl_opts = dataclasses.replace(
        options.controller,
        # One model per block: the chain merge needs each block to commit
        # to its largest model, and block-local "multiple models" would
        # fragment the anchors.
        multiple_models=False,
        min_model_size=min(options.controller.min_model_size,
                           max(4, options.block_size // 2)))

    with Database(database_path) as db:
        names = sorted(v["name"] for v in db.read_images().values())
    blocks = partition_sequential(names, options.block_size, options.overlap)
    log(f"Hierarchical mapper: {len(names)} images -> {len(blocks)} blocks "
        f"(size {options.block_size}, overlap {options.overlap}, "
        f"{options.num_workers} workers, {device})")

    jobs = [(database_path, blk, ctrl_opts, str(device), dtype)
            for blk in blocks]
    if options.num_workers > 1:
        import multiprocessing as mp

        if device.type == "cuda":
            from privacy_preserving_sfm_torch.kernels import build

            build.build()  # once here, not once a worker
        ctx = mp.get_context("spawn")
        with ctx.Pool(options.num_workers) as pool:
            snaps = pool.map(_block_worker, jobs)
    else:
        snaps = [_block_worker(j) for j in jobs]

    ok = [i for i, s in enumerate(snaps) if s is not None]
    stats.update(blocks=len(blocks), reconstructed=len(ok),
                 snapshots=[{k: snaps[i][k] for k in
                             ("device", "seconds", "profile", "launches")}
                            for i in ok])
    for i in ok:
        if snaps[i]["device"] != str(device):
            raise RuntimeError(f"block {i} ran on {snaps[i]['device']}, "
                               f"not {device}")
        log(f"  => block {i}: {len(snaps[i]['poses'])} images in "
            f"{snaps[i]['seconds']:.1f} s on {snaps[i]['device']}")
    log(f"  => {len(ok)}/{len(blocks)} blocks reconstructed")
    if not ok:
        return None

    with Database(database_path) as db:
        full_cache = DatabaseCache.load(
            db, options.controller.min_num_matches)
    merged = full_cache.to_reconstruction()
    for img in merged.images.values():
        img.registered = False
        img.point3d_ids = np.full(img.num_lines, -1, np.int64)
    merged.reg_image_ids = []

    # Chain-merge in block order; retry skipped blocks once at the end
    # (a later block can supply the anchors an earlier skip was missing).
    pending = [snaps[i] for i in ok]
    for _ in range(2):
        pending = [snap for snap in pending
                   if not merge_into(merged, snap, options.min_common)]
        if not pending:
            break
    if pending:
        log(f"  => WARNING: {len(pending)} block(s) had <"
            f"{options.min_common} shared registered images; dropped")
    stats.update(merged=len(ok) - len(pending),
                 merged_points=len(merged.points3d))
    log(f"  => Merged model: {merged.num_registered()} images, "
        f"{len(merged.points3d)} points")

    # Joint refinement over the full correspondence graph: completes the
    # cross-block tracks, then global BA + filtering (the controller's
    # IterativeGlobalRefinement semantics).
    t0 = time.perf_counter()
    mapper = IncrementalMapper(device, dtype, full_cache)
    mapper.begin_reconstruction(merged)
    ctrl = IncrementalMapperController(
        dataclasses.replace(options.controller, verbose=verbose),
        database_cache=full_cache, device=device, dtype=dtype)
    ctrl.iterative_global_refinement(mapper)
    mapper.end_reconstruction(discard=False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats.update(refined_points=len(merged.points3d),
                 refine_seconds=time.perf_counter() - t0,
                 refine_profile=dict(ctrl.profiler.totals))
    log(f"  => Refined model: {merged.num_registered()} images, "
        f"{len(merged.points3d)} points, mean reproj "
        f"{merged.compute_mean_reprojection_error():.3f}px")
    return merged
