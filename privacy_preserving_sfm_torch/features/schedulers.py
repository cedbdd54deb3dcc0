"""Matching schedulers: exhaustive / sequential / spatial / transitive.

Port of ``privacy_preserving_sfm_tpu/features/schedulers.py``: host-side
pipelines over the database, mirroring ``src/feature/matching.cc``:

  * exhaustive: block loop (block_size=50) with duplicate-pair skipping
    (``matching.cc:436-498``);
  * sequential: linear overlap + quadratic jumps (``matching.h:279-310``);
  * spatial: kNN over prior positions (``matching.h:331-360``);
  * transitive: closure over existing matches, 3 iterations
    (``matching.h:362-381``);
  * pairs below ``min_num_matches`` are written as empty
    (``matching.cc:414-416``).

The per-pair work is the exact batched matcher (``features/matching``),
run on chunks of up to ``chunk`` pairs against a descriptor table that
lies on the device.  The table is padded only to its largest image (the
kernel masks invalid rows itself); there is no padding of chunks or
block tables to common shapes, since nothing here is compiled per shape.
Results are the same, blob for blob, as the reference package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from privacy_preserving_sfm_torch.features import matching
from privacy_preserving_sfm_torch.models.database import Database


def _load_descriptor_table(db: Database, image_ids: Sequence[int],
                           device: torch.device):
    """Stack per-image descriptors into a padded (I, N, 128) uint8 table
    and its (I, N) validity mask on ``device``."""
    descs = [db.read_descriptors(iid) for iid in image_ids]
    n_max = max(1, max(len(d) for d in descs))
    table = np.zeros((len(descs), n_max, 128), np.uint8)
    valid = np.zeros((len(descs), n_max), bool)
    for i, d in enumerate(descs):
        table[i, :len(d)] = d
        valid[i, :len(d)] = True
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(valid).to(device))


def _match_resident(db: Database, image_ids: Sequence[int],
                    todo: Sequence[Tuple[int, int]],
                    max_ratio: float, max_distance: float, cross_check: bool,
                    min_num_matches: int, chunk: int, verbose: bool,
                    device: torch.device, plain: bool = False,
                    max_num_matches: int = 32768,
                    progress_offset: int = 0,
                    progress_total: Optional[int] = None) -> int:
    """Match a pair list against a fully device-resident descriptor table."""
    index = {iid: i for i, iid in enumerate(image_ids)}
    table, valid = _load_descriptor_table(db, image_ids, device)
    total = progress_total if progress_total is not None else len(todo)

    num_good = 0
    for start in range(0, len(todo), chunk):
        batch = todo[start:start + chunk]
        pair_idx = torch.tensor([[index[a], index[b]] for a, b in batch],
                                dtype=torch.int64, device=device)
        res = matching.match_many_pairs(
            table, valid, pair_idx, max_ratio=max_ratio,
            max_distance=max_distance, cross_check=cross_check, plain=plain)
        m = res.matches.cpu().numpy()
        for k, (a, b) in enumerate(batch):
            idx2 = m[k]
            rows = np.nonzero(idx2 >= 0)[0]
            if len(rows) < min_num_matches:
                out = np.zeros((0, 2), np.uint32)  # zeroed pair
            else:
                out = np.stack([rows, idx2[rows]], 1).astype(np.uint32)
                out = out[:max_num_matches]  # sift.h:137 cap
                num_good += 1
            db.write_matches(a, b, out)
        if verbose:
            print(f"  matched pairs "
                  f"{progress_offset + start + len(batch)}/{total}",
                  flush=True)
    return num_good


def match_pair_list(db: Database, image_ids: Sequence[int],
                    pairs: Sequence[Tuple[int, int]],
                    max_ratio: float = 0.8, max_distance: float = 0.7,
                    cross_check: bool = True, min_num_matches: int = 15,
                    chunk: int = 64, verbose: bool = False,
                    max_resident_images: Optional[int] = 256,
                    max_num_matches: int = 32768,
                    device: torch.device = torch.device("cuda"),
                    plain: bool = False) -> int:
    """Match and persist a pair list; returns #pairs with >= min matches.

    Runs on ``device``, the card unless the caller asks for another, as
    the CLI's ``--device`` does.

    Bounded device memory: when more than ``max_resident_images`` images
    are involved, images are partitioned into blocks and pairs are matched
    block-against-block with only the two blocks' descriptors resident
    (the reference's block-exhaustive loop + LRU ``FeatureMatcherCache``,
    ``matching.h:125-151``, ``matching.cc:436-498``).  ``plain`` matches
    with the plain version of the top-2 search on any device.
    """
    if not pairs:
        return 0
    todo = [p for p in pairs if not db.exists_matches(*p)]
    if not todo:
        db.commit()
        return 0
    involved = sorted({i for p in todo for i in p})
    opts = (max_ratio, max_distance, cross_check, min_num_matches, chunk,
            verbose, device, plain, max_num_matches)

    if max_resident_images is None or len(involved) <= max_resident_images:
        num_good = _match_resident(db, involved, todo, *opts)
        db.commit()
        return num_good

    # Block partition: pair (a, b) -> bucket (block(a), block(b)).
    blk = max(1, max_resident_images // 2)
    block_of = {iid: k // blk for k, iid in enumerate(involved)}
    blocks: Dict[int, List[int]] = {}
    for iid in involved:
        blocks.setdefault(block_of[iid], []).append(iid)
    buckets: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for a, b in todo:
        ba, bb = sorted((block_of[a], block_of[b]))
        buckets.setdefault((ba, bb), []).append((a, b))

    num_good = 0
    done = 0
    for (ba, bb), bucket_pairs in sorted(buckets.items()):
        ids = blocks[ba] if ba == bb else blocks[ba] + blocks[bb]
        num_good += _match_resident(db, ids, bucket_pairs, *opts,
                                    progress_offset=done,
                                    progress_total=len(todo))
        done += len(bucket_pairs)
    db.commit()
    return num_good


def exhaustive_pairs(image_ids: Sequence[int],
                     block_size: int = 50) -> List[Tuple[int, int]]:
    ids = list(image_ids)
    pairs = []
    seen = set()
    for s1 in range(0, len(ids), block_size):
        for s2 in range(0, len(ids), block_size):
            for i in ids[s1:s1 + block_size]:
                for j in ids[s2:s2 + block_size]:
                    a, b = (i, j) if i < j else (j, i)
                    if a != b and (a, b) not in seen:
                        seen.add((a, b))
                        pairs.append((a, b))
    return pairs


def sequential_pairs(image_ids: Sequence[int], overlap: int = 10,
                     quadratic_overlap: bool = True) -> List[Tuple[int, int]]:
    """Assumes image_ids sorted by name (temporal order)."""
    ids = list(image_ids)
    pairs = set()
    for i in range(len(ids)):
        for k in range(1, overlap + 1):
            if i + k < len(ids):
                pairs.add((min(ids[i], ids[i + k]), max(ids[i], ids[i + k])))
            if quadratic_overlap:
                j = i + (1 << k)
                if j < len(ids):
                    pairs.add((min(ids[i], ids[j]), max(ids[i], ids[j])))
    return sorted(pairs)


def spatial_pairs(image_ids: Sequence[int],
                  positions: Dict[int, np.ndarray],
                  max_num_neighbors: int = 50,
                  max_distance: float = 100.0) -> List[Tuple[int, int]]:
    """kNN over prior positions (GPS/ENU), exact (no kd-tree needed)."""
    ids = [i for i in image_ids if i in positions]
    if len(ids) < 2:
        return []
    pos = np.stack([positions[i] for i in ids])
    d2 = ((pos[:, None] - pos[None, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    pairs = set()
    k = min(max_num_neighbors, len(ids) - 1)
    for i in range(len(ids)):
        nn = np.argsort(d2[i])[:k]
        for j in nn:
            if d2[i, j] <= max_distance ** 2:
                a, b = sorted((ids[i], int(ids[j])))
                pairs.add((a, b))
    return sorted(pairs)


def transitive_pairs(db: Database, num_iterations: int = 3,
                     min_num_matches: int = 15) -> List[Tuple[int, int]]:
    """Closure pairs: (a, c) whenever (a, b) and (b, c) matched."""
    new_pairs = set()
    existing = {k for k, v in db.read_all_matches().items()
                if len(v) >= min_num_matches}
    for _ in range(num_iterations):
        adj: Dict[int, set] = {}
        for a, b in existing | new_pairs:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set()).add(a)
        added = set()
        for b, neigh in adj.items():
            neigh = sorted(neigh)
            for i in range(len(neigh)):
                for j in range(i + 1, len(neigh)):
                    p = (neigh[i], neigh[j])
                    if p not in existing and p not in new_pairs:
                        added.add(p)
        if not added:
            break
        new_pairs |= added
    return sorted(new_pairs)
