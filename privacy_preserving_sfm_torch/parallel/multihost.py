"""Multi-process runtime for the point-sharded bundle adjustment.

Port of ``privacy_preserving_sfm_tpu/parallel/multihost.py`` on
``torch.distributed``: one rank per process, each with its own device
(cards on one host or on several):

  * ``initialize_from_env()``: ``init_process_group`` over TCP from
    arguments or the ``PPSFM_COORDINATOR`` / ``PPSFM_NUM_PROCESSES`` /
    ``PPSFM_PROCESS_ID`` environment variables;
  * ``global_mesh()``: the world group;
  * ``make_global_problem()``: this rank's part of a host-replicated
    ``distributed_ba.shard_problem`` output, on its device;
  * ``gather_points()``: the sharded point output of a solve, on every
    rank, in shard order.

Tested by ``tests/test_torch_multihost.py``, which spawns two processes
configured by those environment variables.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from privacy_preserving_sfm_torch.parallel import distributed_ba
from privacy_preserving_sfm_torch.parallel.sharded_matching import (
    gather_rows,
)

# The longest any collective waits for the other ranks before it raises.
TIMEOUT = datetime.timedelta(minutes=5)


def initialize_from_env(coordinator: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None,
                        backend: Optional[str] = None,
                        device="cuda") -> bool:
    """``init_process_group`` from arguments or the environment:
    ``PPSFM_COORDINATOR`` (host:port of rank 0's store),
    ``PPSFM_NUM_PROCESSES``, ``PPSFM_PROCESS_ID``.  Returns True when it
    started a world of several processes, False (and starts nothing) for
    one process or no coordinator.

    The backend is NCCL for a CUDA ``device`` and gloo for the CPU unless
    ``backend`` names one; a backend that fails to start raises, and no
    other is tried.  On CUDA the device becomes the process's current one.
    Every collective waits at most ``TIMEOUT``.
    """
    coordinator = coordinator or os.environ.get("PPSFM_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("PPSFM_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PPSFM_PROCESS_ID", "0"))
    if not coordinator or num_processes <= 1:
        return False
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device}: no CUDA device is available")
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"device {device}: expected cpu or cuda")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return True


def global_mesh():
    """The group of every process of the world."""
    return distributed_ba.make_mesh()


def make_global_problem(sharded, meta: dict, group, device):
    """This rank's part of ``shard_problem``'s output (``n_shards`` the
    group's size), on ``device``; every process holds the same host
    content."""
    if sharded.points3d.shape[0] != meta["points_per_shard"] * \
            dist.get_world_size(group):
        raise ValueError("the problem's shard count is not the group's size")
    return distributed_ba.local_shard(sharded, meta, dist.get_rank(group),
                                      device)


def gather_points(X: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's point shard of a solve, in shard order, on every
    rank: (world * points_per_shard, 3), on ``X``'s device."""
    return gather_rows(X, group)
