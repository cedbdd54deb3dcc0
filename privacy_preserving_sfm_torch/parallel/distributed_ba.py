"""Point-sharded implicit-Schur bundle adjustment over a process group.

Port of ``privacy_preserving_sfm_tpu/parallel/distributed_ba.py``, on
``torch.distributed``: one rank per process, each with its own device;
the reference's mesh is a process group, its ``shard_map`` the slice
``local_shard`` hands each rank, its ``psum`` and ``pmax`` ``all_reduce``.

  * **Points and their observations are sharded** with track-contiguous
    assignment: every observation of a point lives on the point's rank,
    so point-block elimination (Hpp^-1, back-substitution) is local.
  * **Cameras are replicated**: each rank sums its observations into
    camera blocks; the camera blocks, the camera gradient, the cost, the
    right-hand side, the Schur-Jacobi blocks and the CG's ``E y`` term are
    summed over the group (one all-reduce of a (C, 6) vector a CG step),
    and the gradient's max is reduced for the stop test.
  * The (small) preconditioned CG on the reduced camera system then runs
    identically on every rank.

Each rank runs the flat solver's body (``ba.implicit_schur_lm``) on its
shard, with the fixed-order bin sums of ``ba._bins``, so a fixed world
gives one result every run; a world of one rank gives the bits of
``ba.bundle_adjust``.  Every loop decision reads a reduced value, the
same on every rank, so the ranks leave the LM loop together.

``shard_problem`` is the reference's host-side partition ("snake"
balance by observation count, equal padded shards) in numpy.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from privacy_preserving_sfm_torch.optim import ba as ba_mod


def _require_initialized():
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.multihost.initialize_from_env or "
                           "torch.distributed.init_process_group first")


def make_mesh(n_devices: Optional[int] = None):
    """The process group over ranks 0..n_devices-1, or the whole world.
    Every rank of the world must call it (``new_group`` is collective)."""
    _require_initialized()
    world = dist.get_world_size()
    if n_devices is None or n_devices == world:
        return dist.group.WORLD
    if not 1 <= n_devices <= world:
        raise ValueError(f"n_devices {n_devices} outside 1..{world}")
    return dist.new_group(ranks=list(range(n_devices)))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def shard_problem(problem: ba_mod.BAProblem, n_shards: int):
    """Partition points (and their observations) into ``n_shards`` equal
    padded groups (reference ``:46-118``).

    Returns (sharded, meta): ``sharded`` keeps the camera fields and holds
    the point arrays as n_shards blocks of ``points_per_shard`` rows and
    the observation arrays as blocks of ``obs_per_shard`` rows, on the
    problem's device in its dtypes (padding: weight 0, point mask 0, line
    (1, 0, 0)); ``meta`` has ``point_shard`` and ``point_slot`` (P,) (the
    block and row of each input point) and the two block sizes.
    """
    obs_point = _np(problem.obs_point)
    obs_weight = _np(problem.obs_weight)
    P_total = problem.points3d.shape[0]

    # Snake assignment in descending observation count: within one
    # track length of the greedy balance.
    counts = np.bincount(obs_point[obs_weight > 0], minlength=P_total)
    order = np.argsort(-counts, kind="stable")
    ranks = np.empty(P_total, np.int64)
    ranks[order] = np.arange(P_total)
    period = ranks % (2 * n_shards)
    point_shard = np.where(period < n_shards, period,
                           2 * n_shards - 1 - period).astype(np.int32)

    shard_counts = np.bincount(point_shard, minlength=n_shards)
    points_per_shard = max(1, int(shard_counts.max()))
    by_shard = np.argsort(point_shard, kind="stable")
    group_start = np.concatenate([[0], np.cumsum(shard_counts)[:-1]])
    point_slot = np.empty(P_total, np.int32)
    point_slot[by_shard] = (np.arange(P_total)
                            - group_start[point_shard[by_shard]])
    new_points = np.zeros((n_shards, points_per_shard, 3))
    new_point_mask = np.zeros((n_shards, points_per_shard))
    new_points[point_shard, point_slot] = _np(problem.points3d)
    new_point_mask[point_shard, point_slot] = _np(problem.point_mask)

    valid = obs_weight > 0
    obs_shard = point_shard[obs_point]
    obs_shard_counts = np.bincount(obs_shard[valid], minlength=n_shards)
    O = max(1, int(obs_shard_counts.max()))
    vidx = np.nonzero(valid)[0]
    vs = obs_shard[vidx]
    vorder = np.argsort(vs, kind="stable")
    vidx = vidx[vorder]
    vs = vs[vorder]
    ostart = np.concatenate([[0], np.cumsum(obs_shard_counts)[:-1]])
    oslot = np.arange(len(vidx)) - ostart[vs]
    new_obs_cam = np.zeros((n_shards, O), np.int64)
    new_obs_point = np.zeros((n_shards, O), np.int64)
    new_obs_line = np.zeros((n_shards, O, 3))
    new_obs_line[..., 0] = 1.0
    new_obs_weight = np.zeros((n_shards, O))
    new_obs_cam[vs, oslot] = _np(problem.obs_cam)[vidx]
    new_obs_point[vs, oslot] = point_slot[obs_point[vidx]]
    new_obs_line[vs, oslot] = _np(problem.obs_line)[vidx]
    new_obs_weight[vs, oslot] = obs_weight[vidx]

    def like(a, ref):
        return torch.as_tensor(a, dtype=ref.dtype, device=ref.device)

    sharded = problem._replace(
        points3d=like(new_points.reshape(-1, 3), problem.points3d),
        obs_cam=like(new_obs_cam.reshape(-1), problem.obs_cam),
        obs_point=like(new_obs_point.reshape(-1), problem.obs_point),
        obs_line=like(new_obs_line.reshape(-1, 3), problem.obs_line),
        obs_weight=like(new_obs_weight.reshape(-1), problem.obs_weight),
        point_mask=like(new_point_mask.reshape(-1), problem.point_mask))
    meta = {"points_per_shard": points_per_shard, "obs_per_shard": O,
            "point_shard": point_shard, "point_slot": point_slot}
    return sharded, meta


def local_shard(sharded: ba_mod.BAProblem, meta: dict, rank: int,
                device) -> ba_mod.BAProblem:
    """Rank ``rank``'s part of a ``shard_problem`` output on ``device``:
    the camera fields whole, point rows [rank P_s, (rank + 1) P_s) and
    observation rows [rank O_s, (rank + 1) O_s)."""
    P_s, O_s = meta["points_per_shard"], meta["obs_per_shard"]
    pts = slice(rank * P_s, (rank + 1) * P_s)
    obs = slice(rank * O_s, (rank + 1) * O_s)
    if pts.stop > sharded.points3d.shape[0]:
        raise ValueError(f"rank {rank} is past the problem's "
                         f"{sharded.points3d.shape[0] // P_s} shards")
    local = sharded._replace(
        points3d=sharded.points3d[pts], point_mask=sharded.point_mask[pts],
        obs_cam=sharded.obs_cam[obs], obs_point=sharded.obs_point[obs],
        obs_line=sharded.obs_line[obs], obs_weight=sharded.obs_weight[obs])
    return ba_mod.BAProblem(*(x.to(device) for x in local))


class Reducer:
    """The all-reduces of one sharded solve over ``group``: ``sum`` and
    ``max`` of a tensor across the ranks, counted in ``calls``.  With
    ``timed``, the device is synchronised before each call and the host
    seconds inside the calls add up in ``seconds``."""

    def __init__(self, group, timed: bool = False):
        self.group = group
        self.timed = timed
        self.calls = 0
        self.seconds = 0.0

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        out = x.reshape(-1).clone()  # all_reduce works in place
        if self.timed:
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            t0 = time.perf_counter()
        dist.all_reduce(out, op=op, group=self.group)
        if self.timed:
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out.reshape(x.shape)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)


def bundle_adjust_sharded(local: ba_mod.BAProblem, group, camera_model: str,
                          options: ba_mod.BAOptions = ba_mod.BAOptions(),
                          reducer: Optional[Reducer] = None):
    """Distributed LM-BA on this rank's ``local_shard`` (reference
    ``bundle_adjust_sharded``, ``:121-311``); every rank of ``group``
    calls it with its own shard, on its own device.

    Returns (qvecs, tvecs, points3d, BASummary) like ``ba.bundle_adjust``:
    the cameras and the summary are the same on every rank, ``points3d``
    holds this rank's slots (``multihost.gather_points`` collects them).
    ``reducer`` (default ``Reducer(group)``) carries the all-reduces.
    """
    _require_initialized()
    reducer = Reducer(group) if reducer is None else reducer
    return ba_mod.implicit_schur_lm(local, camera_model, options,
                                    reduce_sum=reducer.sum,
                                    reduce_max=reducer.max)
