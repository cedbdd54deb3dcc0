"""Descriptor matching: exact batched top-2 with ratio/distance/cross checks.

Port of ``privacy_preserving_sfm_tpu/features/matching.py``.  Semantics of
the reference CPU brute-force matcher (``src/feature/sift.cc:54-143,
251-351``): descriptors are uint8 quantizations of 512 * L1-root
normalized SIFT vectors; similarity is the dot product scaled by 1/512^2
and mapped through acos to an angular distance; a match survives if

  * best_dist < max_distance            (0.7 rad default)
  * best_dist < max_ratio * second_dist (0.8 default)
  * cross check: mutual nearest neighbors (cross_check=true)

Pairs with < min_num_matches matches are zeroed by the caller
(``matching.cc:414-416``).

The top-2 search has a plain PyTorch version, ``_top2_both_batched_plain``
(the float32 dot matrix, masked, then argmax/max along both axes), and a
hand-written CUDA kernel, ``kernels/match_top2.cu`` (wrapper:
``features/matching_kernels.py``).  ``_top2_both_batched`` dispatches on
the device of its inputs: CPU tensors take the plain version, CUDA
tensors launch the kernel for any N1 and N2, and anything else raises.
``plain=True`` asks for the plain version on any device, to hold the
kernel against it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

DIST_NORM = 1.0 / (512.0 * 512.0)
BIG = 1e9


class MatchResult(NamedTuple):
    matches: torch.Tensor  # (N1,) int32 index into image 2, -1 = no match
    num_matches: torch.Tensor  # () int32
    best_dist: torch.Tensor  # (N1,) angular distance of the best candidate


def descriptor_dots(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """Raw dot products d1 . d2 of uint8 descriptors, (..., N1, N2) float32
    (LARGER = closer).  Every dot is an integer below 2^24, so the float32
    product is exact in any summation order."""
    return torch.matmul(desc1.float(), desc2.float().transpose(-1, -2))


def descriptor_distances(desc1: torch.Tensor, desc2: torch.Tensor
                         ) -> torch.Tensor:
    """Angular distances acos(clip(d1 . d2 / 512^2)) of uint8 descriptors,
    (..., N1, N2) float32."""
    return _to_angle(descriptor_dots(desc1, desc2))


def _to_angle(dots: torch.Tensor) -> torch.Tensor:
    return torch.arccos(torch.clamp(dots * DIST_NORM, -1.0, 1.0))


def _top2_max(dots: torch.Tensor, dim: int):
    """Largest and second-largest along ``dim``, with the first argmax of
    the largest; the second masks only the argmax position, so a
    duplicate of the best gives second == best.

    acos is monotonically decreasing, so the top-2 dots ARE the top-2
    nearest neighbors; the transcendental is applied to 2N scalars
    afterwards instead of the full N^2 matrix.
    """
    best_idx = torch.argmax(dots, dim=dim, keepdim=True)
    best = torch.gather(dots, dim, best_idx).squeeze(dim)
    second = dots.scatter(dim, best_idx, -BIG).amax(dim=dim)
    return best, second, best_idx.squeeze(dim).to(torch.int32)


def _top2_both_batched_plain(d1s, d2s, valid1, valid2):
    """Plain version of the top-2 search: d1s (B, N1, D), d2s (B, N2, D)
    uint8, valid1 (B, N1), valid2 (B, N2) bool.  Returns
    (bd12, sd12, idx12, bd21, sd21, idx21): raw-dot float32 and int32
    tables (B, N1) and (B, N2); an invalid entry counts as -1e9."""
    dots = descriptor_dots(d1s, d2s)
    dots.masked_fill_(~(valid1[:, :, None] & valid2[:, None, :]), -BIG)
    bd12, sd12, idx12 = _top2_max(dots, dim=2)
    bd21, sd21, idx21 = _top2_max(dots, dim=1)
    return bd12, sd12, idx12, bd21, sd21, idx21


def _top2_both_batched(d1s, d2s, valid1, valid2, plain: bool = False):
    """Top-2 dots + argmax in both directions for B pairs (see
    ``_top2_both_batched_plain``): the plain version on the CPU or when
    ``plain``, the ``match_top2`` kernel on a CUDA device."""
    if plain:
        return _top2_both_batched_plain(d1s, d2s, valid1, valid2)
    from privacy_preserving_sfm_torch.features import matching_kernels

    return matching_kernels.top2_scores_bidir(d1s, d2s, valid1, valid2)


def _gate_and_cross(valid1, bd12, sd12, idx12, bd21, sd21, idx21,
                    max_ratio, max_distance, cross_check):
    """Ratio/distance gates + mutual-NN cross check on (B, N) tables,
    computed in float32."""
    best12, second12 = _to_angle(bd12), _to_angle(sd12)
    ok = valid1 & (best12 < max_distance) & (best12 < max_ratio * second12)
    if cross_check:
        best21, second21 = _to_angle(bd21), _to_angle(sd21)
        ok21 = (best21 < max_distance) & (best21 < max_ratio * second21)
        idx = idx12.long()
        back = torch.gather(idx21, 1, idx)
        okb = torch.gather(ok21, 1, idx)
        rows = torch.arange(idx12.shape[1], device=idx12.device)
        ok = ok & (back == rows[None, :]) & okb
    matches = torch.where(ok, idx12, -1)
    return MatchResult(matches=matches.to(torch.int32),
                       num_matches=ok.sum(dim=1).to(torch.int32),
                       best_dist=best12)


def match_descriptors(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    valid1: Optional[torch.Tensor] = None,
    valid2: Optional[torch.Tensor] = None,
    max_ratio: float = 0.8,
    max_distance: float = 0.7,
    cross_check: bool = True,
) -> MatchResult:
    """Match uint8 SIFT descriptors (padding masked).

    Defaults are ``SiftMatchingOptions`` (``sift.h:117-144``).
    """
    if valid1 is None:
        valid1 = torch.ones(desc1.shape[0], dtype=torch.bool,
                            device=desc1.device)
    if valid2 is None:
        valid2 = torch.ones(desc2.shape[0], dtype=torch.bool,
                            device=desc2.device)
    res = _gate_and_cross(
        valid1[None],
        *_top2_both_batched(desc1[None], desc2[None], valid1[None],
                            valid2[None]),
        max_ratio, max_distance, cross_check)
    return MatchResult(matches=res.matches[0],
                       num_matches=res.num_matches[0],
                       best_dist=res.best_dist[0])


def match_many_pairs(desc: torch.Tensor, valid: torch.Tensor,
                     pairs: torch.Tensor, max_ratio: float = 0.8,
                     max_distance: float = 0.7, cross_check: bool = True,
                     plain: bool = False) -> MatchResult:
    """Batched matcher over a (B, 2) tensor of image-index pairs.

    desc: (I, N, 128) stacked per-image descriptor tables (padded);
    valid: (I, N).  The schedulers batch whole chunks of pairs into one
    call (block structure: ``matching.cc:436-498``).  ``torch.profiler``
    sees the spans ``matching.gather`` (the pairs' descriptor and valid
    rows gathered from the tables), ``matching.top2`` (the top-2 search)
    and ``matching.gate`` (ratio and distance gates, cross check).
    """
    with record_function("matching.gather"):
        a, b = pairs[:, 0], pairs[:, 1]
        d1s, d2s = desc[a], desc[b]
        v1s, v2s = valid[a], valid[b]
    with record_function("matching.top2"):
        top2 = _top2_both_batched(d1s, d2s, v1s, v2s, plain=plain)
    with record_function("matching.gate"):
        return _gate_and_cross(v1s, *top2, max_ratio, max_distance,
                               cross_check)
