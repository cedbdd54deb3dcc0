"""Closed loop over a collection's exhaustive pairs, in the block order of
``schedulers.match_pair_list``.

Set-up makes the configuration's descriptor tables on the device
(``gen/descriptors``) and matches one chunk to warm the shapes.  The pair
list is ``exhaustive_pairs`` (blocks of 50), bucketed as
``match_pair_list`` buckets a collection of more than
``max_resident_images`` images (blocks of half that, buckets in order).
A timed unit matches the next ``chunk`` pairs of the list with
``matching.match_many_pairs`` on the device-resident tables and copies
the matches to the host as ``schedulers._match_resident`` does (no
database write).  When the list ends it starts over.

The check: ``check_chunks`` chunks of the window drawn from the seed
(reservoir sampling), and as many more drawn from the chunks that hold a
pair of images that share scene points (most pairs share none), their
matches against the reference matcher of ``reference/frontend.py`` on the
same descriptors: ``match_mismatch``, the share of rows that differ.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.core.base import LoopBase, sub_seed
from benchmark.gen import descriptors
from benchmark.reference import frontend as ref_fe


def exhaustive_pairs(n: int, block_size: int) -> List[Tuple[int, int]]:
    """``schedulers.exhaustive_pairs`` of images 0..n-1."""
    pairs, seen = [], set()
    for s1 in range(0, n, block_size):
        for s2 in range(0, n, block_size):
            for i in range(s1, min(n, s1 + block_size)):
                for j in range(s2, min(n, s2 + block_size)):
                    a, b = (i, j) if i < j else (j, i)
                    if a != b and (a, b) not in seen:
                        seen.add((a, b))
                        pairs.append((a, b))
    return pairs


def block_order(pairs: List[Tuple[int, int]], n: int, max_resident: int
                ) -> List[Tuple[int, int]]:
    """The order in which ``match_pair_list`` matches ``pairs`` of n
    images: one pass when n fits, else buckets of image blocks."""
    if n <= max_resident:
        return list(pairs)
    blk = max(1, max_resident // 2)
    buckets: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for a, b in pairs:
        key = tuple(sorted((a // blk, b // blk)))
        buckets.setdefault(key, []).append((a, b))
    return [p for key in sorted(buckets) for p in buckets[key]]


class Loop(LoopBase):
    def __init__(self, config, mix, seed, device):
        super().__init__(config, mix, seed, device)
        with record_function("bench.make_descriptors"):
            self.desc = descriptors.make_descriptors(
                config, sub_seed(seed, 0), device)
        n = self.desc.shape[0]
        self.valid = torch.ones(self.desc.shape[:2], dtype=torch.bool,
                                device=device)
        order = block_order(exhaustive_pairs(n, int(mix["block_size"])), n,
                            int(mix["max_resident_images"]))
        self.pairs = torch.tensor(order, dtype=torch.int64)
        self.chunk = int(mix["chunk"])
        self.match_opts = mix.get("match_options", {})
        self.pos = 0
        self.pick = np.random.default_rng(sub_seed(seed, 2))
        # Two reservoirs of (pairs (B, 2), matches (B, N1)): every chunk,
        # and the chunks with a pair of overlapping views.
        self.kept: Dict[str, List[tuple]] = {"any": [], "overlap": []}
        self.seen = {"any": 0, "overlap": 0}
        n_feat = int(config["num_features"])
        window = int(config.get("window") or (3 * n_feat) // 4)
        self.span = window / int(config.get("shift") or max(1, window // 12))

    def _next_pairs(self) -> torch.Tensor:
        if self.pos >= len(self.pairs):
            self.pos = 0
        p = self.pairs[self.pos:self.pos + self.chunk]
        self.pos += len(p)
        return p

    def unit(self) -> dict:
        from privacy_preserving_sfm_torch.features import matching

        p = self._next_pairs()
        pair_idx = p.to(self.device)
        with record_function("bench.match_many_pairs"):
            res = matching.match_many_pairs(self.desc, self.valid, pair_idx,
                                            **self.match_opts)
        with record_function("bench.match_copy"):
            m = res.matches.cpu().numpy()
        kinds = ["any"]
        if bool(((p[:, 1] - p[:, 0]).abs() < self.span).any()):
            kinds.append("overlap")
        for kind in kinds:
            self._keep(kind, (p, m))
        n = self.desc.shape[1]
        return {"pairs": len(p), "match_calls": [[(n, n)] * len(p)]}

    def _keep(self, kind: str, item):
        """Reservoir sampling of ``check_chunks`` items, from the seed."""
        k = int(self.mix["check_chunks"])
        i = self.seen[kind]
        self.seen[kind] += 1
        if i < k:
            self.kept[kind].append(item)
        else:
            j = int(self.pick.integers(0, i + 1))
            if j < k:
                self.kept[kind][j] = item

    def warm(self):
        self.unit()
        self.pos = 0
        self.kept = {"any": [], "overlap": []}
        self.seen = {"any": 0, "overlap": 0}

    def readings(self, control: bool = False, explore: bool = False
                 ) -> Dict[str, float]:
        bad = rows = 0
        kept = self.kept["any"] + self.kept["overlap"]
        for p, m in kept:
            a, b = p[:, 0].to(self.device), p[:, 1].to(self.device)
            want = ref_fe.match(self.desc[a], self.desc[b], self.valid[a],
                                self.valid[b], **self.match_opts).cpu()
            if control:
                m = ref_fe.match(self.desc[a], self.desc[b], self.valid[a],
                                 self.valid[b], int4=True,
                                 **self.match_opts).cpu().numpy()
            bad += int((m != want.numpy()).sum())
            rows += m.size
        out = {"match_mismatch": bad / max(rows, 1)}
        if explore:
            out["matches_per_pair"] = float(sum(
                (m >= 0).sum() for _, m in kept)) / max(
                    sum(len(p) for p, _ in kept), 1)
        return out

    def controls(self, explore: bool = False) -> Dict[str, Dict[str, float]]:
        """The control: the reference matcher on 4-bit descriptors in the
        program's place."""
        return {"int4_match": self.readings(control=True, explore=explore)}
