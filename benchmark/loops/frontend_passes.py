"""Closed loop of passes over a video capture: extract, lift, match.

Set-up renders the configuration's frames on the device
(``gen/box_frames``) and runs one unit to warm every shape.  A timed unit
is one batch of ``batch`` frames in capture order, as the
``feature_extractor`` CLI batches them (a short tail padded by repeating
its last frame, whose outputs are dropped): ``extraction.
extract_and_lift_batch`` with one CPU generator a frame seeded from
``--seed`` and its position; the descriptors, lines, aligned flags and
valid flags come to the host as the CLI reads them before its database
write (the write stays outside); the descriptors go into a device-
resident table; then every ``sequential_pairs`` pair whose later frame is
in the batch is matched with ``matching.match_many_pairs`` in chunks of
``chunk`` pairs, each chunk's matches copied to the host as
``schedulers._match_resident`` copies them.  After the last batch a new
pass starts from frame 0 with nothing matched.

The check, after the window, against ``reference/sift.py`` and
``reference/frontend.py``:

* ``lift_mismatch``: over ``check_frames`` frames drawn from the seed
  (their latest lift in the window), the share of feature slots where the
  program and the reference (SIFT and lift of the same frame and draws)
  differ: in the valid flag, the aligned flag, a descriptor byte by more
  than ``desc_tol`` levels, or a line by more than ``line_tol``;
* ``match_mismatch``: over ``check_pairs`` pairs drawn from the seed
  (their latest matches in the window), the share of rows whose match
  differs from the reference matcher's on the reference SIFT's
  descriptors of the pair's two frames.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.core.base import LoopBase, frame_seed, sub_seed
from benchmark.gen import box_frames
from benchmark.reference import frontend as ref_fe
from benchmark.reference import sift as ref_sift


def sequential_pairs(n: int, overlap: int, quadratic: bool
                     ) -> List[Tuple[int, int]]:
    """``schedulers.sequential_pairs`` of frames 0..n-1 (linear overlap and
    quadratic jumps ``i + 2^k``), sorted."""
    pairs = set()
    for i in range(n):
        for k in range(1, overlap + 1):
            if i + k < n:
                pairs.add((i, i + k))
            if quadratic and i + (1 << k) < n:
                pairs.add((i, i + (1 << k)))
    return sorted(pairs)


class Loop(LoopBase):
    def __init__(self, config, mix, seed, device):
        super().__init__(config, mix, seed, device)
        from privacy_preserving_sfm_torch.features import sift

        with record_function("bench.make_frames"):
            self.frames = box_frames.make_frames(config, sub_seed(seed, 0),
                                                 device)
        self.n = self.frames.images.shape[0]
        self.batch = int(mix["batch"])
        self.chunk = int(mix["chunk"])
        self.opts = sift.SiftOptions(**mix.get("sift_options", {}))
        self.match_opts = mix.get("match_options", {})
        self.ratio = float(mix.get("aligned_ratio", 0.5))
        self.model = config["camera_model"]
        K = self.opts.max_num_features
        self.table = torch.zeros(self.n, K, 128, dtype=torch.uint8,
                                 device=device)
        self.valid = torch.zeros(self.n, K, dtype=torch.bool, device=device)
        pairs = sequential_pairs(self.n, int(mix["overlap"]),
                                 bool(mix["quadratic_overlap"]))
        self.pairs_by_last: Dict[int, List[Tuple[int, int]]] = {}
        for a, b in pairs:
            self.pairs_by_last.setdefault(b, []).append((a, b))
        self.num_batches = -(-self.n // self.batch)
        self.step = 0
        self.lifted: Dict[int, tuple] = {}   # frame -> host lift outputs
        self.matched: Dict[Tuple[int, int], np.ndarray] = {}

    def _frames_of(self, b: int) -> List[int]:
        return list(range(b * self.batch, min(self.n, (b + 1) * self.batch)))

    def unit(self) -> dict:
        from privacy_preserving_sfm_torch.features import extraction, matching

        b = self.step % self.num_batches
        self.step += 1
        idx = self._frames_of(b)
        padded = idx + [idx[-1]] * (self.batch - len(idx))
        sel = torch.as_tensor(padded, device=self.device)
        gens = [torch.Generator().manual_seed(frame_seed(self.seed, i))
                for i in padded]
        with record_function("bench.extract_and_lift"):
            lf = extraction.extract_and_lift_batch(
                self.frames.images[sel], self.model, self.frames.params[sel],
                self.frames.gravity[sel], gens, self.opts, self.ratio)
        with record_function("bench.lift_copy"):
            valid, desc, lines, aligned = (t.cpu().numpy() for t in (
                lf.valid, lf.descriptors, lf.lines, lf.aligned))
        n = len(idx)
        for k, i in enumerate(idx):
            self.lifted[i] = (valid[k], desc[k], lines[k], aligned[k])
        real = sel[:n]
        self.table[real] = lf.descriptors[:n]
        self.valid[real] = lf.valid[:n]
        todo = [p for i in idx for p in self.pairs_by_last.get(i, [])]
        calls = []
        for s in range(0, len(todo), self.chunk):
            chunk = todo[s:s + self.chunk]
            pair_idx = torch.tensor(chunk, dtype=torch.int64,
                                    device=self.device)
            with record_function("bench.match_many_pairs"):
                res = matching.match_many_pairs(
                    self.table, self.valid, pair_idx, **self.match_opts)
            with record_function("bench.match_copy"):
                m = res.matches.cpu().numpy()
            for k, p in enumerate(chunk):
                self.matched[p] = m[k]
            calls.append([(int(self.lifted[a][0].sum()),
                           int(self.lifted[b][0].sum())) for a, b in chunk])
        return {"frames": n, "pairs": len(todo), "match_calls": calls}

    def warm(self):
        self.unit()
        self.step = 0
        self.lifted.clear()
        self.matched.clear()

    def _reference_sift(self, frames: List[int], tf32: bool = False):
        """The reference SIFT of ``frames`` in blocks of the mix's batch:
        per frame (keypoints, valid, descriptors) on the device."""
        opts = ref_sift.SiftOptions(**self.mix.get("sift_options", {}))
        out = {}
        for s in range(0, len(frames), self.batch):
            block = frames[s:s + self.batch]
            sel = torch.as_tensor(block, device=self.device)
            f = ref_sift.extract_sift(
                ref_sift_images(self.frames.images[sel]), opts, tf32=tf32)
            for k, i in enumerate(block):
                out[i] = (f.keypoints[k], f.valid[k], f.descriptors[k])
        return out

    def _reference_lift(self, feats, pick: List[int]):
        """Per frame of ``pick``: (valid, descriptors, lines, aligned) on the
        host, the reference lift of the reference features ``feats``."""
        sel = torch.as_tensor(pick, device=self.device)
        kp = torch.stack([feats[i][0] for i in pick])
        valid = torch.stack([feats[i][1] for i in pick])
        lines, aligned = ref_fe.lift(
            kp, valid, self.frames.params[sel], self.frames.gravity[sel],
            [frame_seed(self.seed, i) for i in pick], self.ratio)
        return [(feats[i][1].cpu().numpy(), feats[i][2].cpu().numpy(),
                 lines[k].cpu().numpy(), aligned[k].cpu().numpy())
                for k, i in enumerate(pick)]

    def readings(self, control: bool = False, explore: bool = False
                 ) -> Dict[str, float]:
        """The numbers compared; ``control`` puts the reference in TF32
        (SIFT) and 4-bit descriptors (matcher) in the program's place.
        The reference works out the SIFT of every sampled frame and of
        both frames of every sampled pair again, and matches the pairs on
        its own descriptors."""
        rng = np.random.default_rng(sub_seed(self.seed, 3))
        frames = sorted(self.lifted)
        nf = min(int(self.mix["check_frames"]), len(frames))
        pick = sorted(rng.choice(frames, nf, replace=False).tolist())
        pairs = sorted(self.matched)
        npairs = min(int(self.mix["check_pairs"]), len(pairs))
        chosen = [pairs[j] for j in sorted(
            rng.choice(len(pairs), npairs, replace=False).tolist())]
        feats = self._reference_sift(
            sorted(set(pick) | {f for p in chosen for f in p}))
        want = self._reference_lift(feats, pick)
        if control:  # the reference's own outputs stand in for the program's
            got = self._reference_lift(
                self._reference_sift(pick, tf32=True), pick)
        else:
            got = [self.lifted[i] for i in pick]
        out = {"lift_mismatch": lift_mismatch(
            got, want, int(self.mix["desc_tol"]),
            float(self.mix["line_tol"]))}
        if explore:
            out["lift_mismatch_exact"] = lift_mismatch(got, want, 0, 0.0)

        bad = rows = 0
        for s in range(0, npairs, self.chunk):
            chunk = chosen[s:s + self.chunk]
            d1, d2, v1, v2 = (torch.stack([feats[p[side]][j] for p in chunk])
                              for side, j in ((0, 2), (1, 2), (0, 1),
                                              (1, 1)))
            want_m = ref_fe.match(d1, d2, v1, v2, **self.match_opts).cpu()
            if control:
                got_m = ref_fe.match(d1, d2, v1, v2, int4=True,
                                     **self.match_opts).cpu().numpy()
            else:
                got_m = np.stack([self.matched[p] for p in chunk])
            bad += int((got_m != want_m.numpy()).sum())
            rows += got_m.size
        out["match_mismatch"] = bad / max(rows, 1)
        return out

    def controls(self, explore: bool = False) -> Dict[str, Dict[str, float]]:
        """The control: the reference SIFT in TF32 and the reference
        matcher on 4-bit descriptors in the program's place."""
        return {"tf32_sift_int4_match": self.readings(control=True,
                                                      explore=explore)}

    def free(self):
        self.table = self.valid = None
        super().free()



def lift_mismatch(got, want, desc_tol: int, line_tol: float) -> float:
    """Share of the feature slots valid on either side where the program's
    lift ``got`` and the reference's ``want`` (per frame: valid,
    descriptors, lines, aligned) differ: in the valid flag, the aligned
    flag, a descriptor byte by more than ``desc_tol`` levels or a line by
    more than ``line_tol``."""
    bad = total = 0
    for (v, d, ln, al), (rv, rd, rl, ra) in zip(got, want):
        both = v & rv
        dd = np.abs(d.astype(np.int16) - rd.astype(np.int16)).max(1)
        diff = (v != rv) | (both & ((dd > desc_tol) | (al != ra)
                                    | (np.abs(ln - rl).max(1) > line_tol)))
        bad += int(diff.sum())
        total += int((v | rv).sum())
    return bad / max(total, 1)


def ref_sift_images(u8: torch.Tensor) -> torch.Tensor:
    """uint8 frames to float32 in [0, 1], each level the correctly rounded
    i / 255."""
    levels = torch.arange(256, dtype=torch.float32) / 255.0
    return levels.to(u8.device)[u8.long()]
