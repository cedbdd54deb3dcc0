"""Descriptor matching sharded over image pairs.

Port of ``privacy_preserving_sfm_tpu/parallel/sharded_matching.py``.
Exhaustive matching is embarrassingly parallel over pairs
(``matching.cc:436-498`` block loop): each rank of a process group
matches its contiguous block of the pair list against the replicated
descriptor table with ``features.matching.match_many_pairs`` (the
``match_top2`` kernel on CUDA), with no collective, as the reference's
``shard_map`` over ``P(axis)`` does.  ``gather_rows`` then gives every
rank the whole result, as reading the reference's global array does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from privacy_preserving_sfm_torch.features import matching


def _rank_world(group):
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized")
    return dist.get_rank(group), dist.get_world_size(group)


def match_pairs_sharded(desc: torch.Tensor, valid: torch.Tensor,
                        pairs: torch.Tensor, group=None,
                        **kwargs) -> matching.MatchResult:
    """This rank's rows of the match of a (B, 2) pair list split over the
    ranks of ``group`` (default the world).

    desc: (I, N, 128) descriptor tables and valid (I, N), the same on
    every rank; ``pairs`` padded so that B % world == 0 (pad with [0, 0]
    pairs and ignore their rows).  Returns the ``MatchResult`` of rows
    [rank B / world, (rank + 1) B / world); ``kwargs`` go to
    ``match_many_pairs``.
    """
    rank, world = _rank_world(group)
    B = pairs.shape[0]
    if B % world:
        raise ValueError(f"{B} pairs do not split over {world} ranks: pad "
                         "them with [0, 0] pairs")
    per = B // world
    return matching.match_many_pairs(desc, valid,
                                     pairs[rank * per:(rank + 1) * per],
                                     **kwargs)


def gather_rows(x: Union[torch.Tensor, NamedTuple], group=None):
    """Every rank's equal-sized block of rows of ``x`` (a tensor, or a
    NamedTuple of tensors such as ``MatchResult``), concatenated in rank
    order on every rank, on ``x``'s device.  Through the host unless the
    group's backend is NCCL."""
    if isinstance(x, tuple):
        return type(x)(*(gather_rows(f, group) for f in x))
    _, world = _rank_world(group)
    src = x.contiguous()
    if dist.get_backend(group) != "nccl":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def exhaustive_pair_list(num_images: int, block_size: int = 50) -> np.ndarray:
    """All unordered pairs (i < j), int32 (M, 2), in the reference
    scheduler's block order (``matching.h:50-51``,
    ``matching.cc:436-498``)."""
    pairs = []
    for start1 in range(0, num_images, block_size):
        end1 = min(start1 + block_size, num_images)
        for start2 in range(0, num_images, block_size):
            end2 = min(start2 + block_size, num_images)
            for i in range(start1, end1):
                for j in range(start2, end2):
                    if i < j:
                        pairs.append((i, j))
    seen = set()
    out = []
    for p in pairs:  # first occurrence wins, block order kept
        if p not in seen:
            seen.add(p)
            out.append(p)
    return np.asarray(out, np.int32)


def sequential_pair_list(num_images: int, overlap: int = 10,
                         quadratic_overlap: bool = True) -> np.ndarray:
    """Sequential matcher pair list (``matching.h:279-310``), sorted,
    int32 (M, 2): each image with the next ``overlap`` frames, plus the
    jumps of 2^k frames."""
    pairs = set()
    for i in range(num_images):
        for k in range(1, overlap + 1):
            if i + k < num_images:
                pairs.add((i, i + k))
            if quadratic_overlap:
                j = i + (1 << k)
                if j < num_images:
                    pairs.add((i, j))
    return np.asarray(sorted(pairs), np.int32)
