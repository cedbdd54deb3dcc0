"""Batched RANSAC pieces (torch): sampling, support scores, selection.

Port of ``privacy_preserving_sfm_tpu/solvers/ransac.py``, PROSAC and the
subset prescreen included (no caller of either package uses those two;
``tests/test_torch_ransac_samplers.py`` holds them).  Semantics follow
the reference framework (``src/optim/ransac.h:78-249``,
``loransac.h:54-238``, ``support_measurement.h:43-77``), executed as a
batch: B hypotheses are generated and scored together.

Support (``InlierSupportMeasurer::Compare``): more inliers wins; equal
inliers -> smaller inlier-residual sum wins, encoded as the single float
``num_inliers - rs / (1 + rs)``.  MSAC (RansacLib, used by the init
module) is ``-sum(min(r, thresh))``.  Selection keeps the first maximum.

Random draws come from a ``torch.Generator`` on the CPU and are returned
on the CPU, so a run on the card and a run on the CPU see the same
samples; the reference's random streams are not reproduced.  Orderings
keep the lower index first among equal values, as the reference's
stable sort and top-k do (``_top_k_indices``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class RansacResult(NamedTuple):
    model: torch.Tensor  # the best hypothesis's model
    score: torch.Tensor
    num_inliers: torch.Tensor
    inlier_mask: torch.Tensor
    best_index: torch.Tensor


def draw_samples(generator: torch.Generator, valid: torch.Tensor,
                 sample_size: int, num_hypotheses: int) -> torch.Tensor:
    """(..., B, k) index samples of k distinct valid entries of each row of
    ``valid`` (..., N), uniform over the k-subsets.

    Floyd's algorithm over the row's valid positions, vectorized over the
    rows and hypotheses: k rounds, each one uniform draw per sample and a
    membership test against the k - 1 members so far, so a call costs
    O(B k^2) per row, whatever N (the reference's Gumbel top-k draws B x N
    keys).  Each row needs at least k valid entries.
    """
    valid = valid.cpu()
    lead = valid.shape[:-1]
    n = valid.shape[-1]
    nv = valid.sum(-1)  # (...)
    if bool((nv < sample_size).any()):
        raise ValueError(f"a row has fewer than {sample_size} valid entries")
    shape = lead + (num_hypotheses,)
    chosen = []
    for step in range(sample_size):
        hi = (nv - sample_size + step + 1)[..., None].expand(shape)  # j + 1
        u = torch.rand(shape, generator=generator, dtype=torch.float64)
        t = torch.minimum((u * hi).long(), hi - 1)
        if chosen:
            taken = torch.stack(chosen, -1)
            t = torch.where((taken == t[..., None]).any(-1), hi - 1, t)
        chosen.append(t)
    rank = torch.stack(chosen, -1)  # positions among the valid entries
    # Position r among the valid entries -> index in the row.
    order = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    return torch.take_along_dim(
        order[..., None, :].expand(shape + (n,)), rank, dim=-1)


def inlier_score(residuals: torch.Tensor, threshold, valid: torch.Tensor):
    """Inlier-count support with the residual-sum tiebreak over the last
    axis.  Returns (score, num_inliers, inlier_mask)."""
    inlier = (residuals < threshold) & valid
    num = torch.sum(inlier, dim=-1)
    rs = torch.sum(torch.where(inlier, residuals, 0.0), dim=-1)
    score = num.to(residuals.dtype) - rs / (1.0 + rs)
    return score, num, inlier


def msac_score(residuals: torch.Tensor, threshold, valid: torch.Tensor):
    """RansacLib LO-MSAC truncated score (negated: higher is better).  A
    residual not below the threshold counts as the threshold, NaN
    included: a hypothesis whose residuals are not finite scores as all
    outliers and cannot win ``select_best`` (in RansacLib no NaN score
    wins a strict comparison).  The reference's ``minimum`` carries a NaN
    into the score, where its argmax takes it; the two agree wherever the
    residuals are finite."""
    th = torch.as_tensor(threshold, dtype=residuals.dtype,
                         device=residuals.device)
    below = residuals < th
    r = torch.where(valid, torch.where(below, residuals, th), 0.0)
    inlier = below & valid
    return -torch.sum(r, dim=-1), torch.sum(inlier, dim=-1), inlier


def select_best(models, score: torch.Tensor, num_inliers: torch.Tensor,
                inlier_mask: torch.Tensor) -> RansacResult:
    """Argmax (first maximum) over the trailing hypothesis axis of
    ``score`` (..., B); ``models`` has leading shape (..., B),
    ``inlier_mask`` (..., B, N)."""
    best = torch.argmax(score, dim=-1)  # (...)

    def take(x):
        idx = best.reshape(best.shape + (1,) * (x.ndim - best.ndim))
        return torch.take_along_dim(x, idx, dim=best.ndim).squeeze(best.ndim)

    return RansacResult(model=take(models), score=take(score),
                        num_inliers=take(num_inliers),
                        inlier_mask=take(inlier_mask), best_index=best)



def _integer_pow(x: float, n: int) -> float:
    """x^n by repeated squaring, the reference's rounding of ``x ** n``."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return 1.0 if acc is None else acc


def num_trials_needed(num_inliers: int, num_valid: int, sample_size: int,
                      confidence: float = 0.99999, multiplier: float = 3.0,
                      max_trials: int = 1_000_000) -> float:
    """Adaptive trial bound ``multiplier * log(1 - conf) / log(1 -
    ratio^m)`` (``ransac.h:158-176``), on the host in float64; callers use
    it to stop between hypothesis batches."""
    ratio = min(max(num_inliers / max(num_valid, 1), 1e-9), 1.0)
    nom = math.log(max(1.0 - confidence, 1e-300))
    denom = math.log1p(-min(_integer_pow(ratio, sample_size), 1.0 - 1e-12))
    trials = multiplier * nom / min(denom, -1e-300)
    return min(trials, max_trials)


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of the last axis, largest first,
    the lower index first among equal values (the reference's top-k); a
    stable descending sort, where ``torch.topk`` promises no order among
    ties."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def prosac_prefix_sizes(num_data: int, sample_size: int,
                        num_hypotheses: int,
                        num_progressive: int = 200_000) -> np.ndarray:
    """PROSAC prefix sizes n_t for t = 1..B, (B,) int32 on the host: the
    t-th hypothesis samples from the n_t best-ranked correspondences
    (``src/optim/progressive_sampler.cc:49-82``, Chum & Matas eq. 3),
    growing towards plain RANSAC."""
    m = sample_size
    T_n = float(num_progressive)
    for i in range(m):
        T_n *= (m - i) / (num_data - i)
    T_n_p = 1.0
    n = m
    out = np.zeros(num_hypotheses, np.int32)
    for t in range(1, num_hypotheses + 1):
        if t == int(T_n_p) and n < num_data:
            T_n_plus_1 = T_n * (n + 1.0) / (n + 1.0 - m)
            T_n_p += np.ceil(T_n_plus_1 - T_n)
            T_n = T_n_plus_1
            n += 1
        out[t - 1] = n
    return out


def gumbel_noise(generator: torch.Generator, num_hypotheses: int,
                 num_data: int) -> torch.Tensor:
    """(B, N) float64 standard Gumbel draws, -log(E) of unit exponential
    draws, from ``generator`` on the CPU."""
    e = torch.empty(num_hypotheses, num_data, dtype=torch.float64)
    return -torch.log(e.exponential_(generator=generator))


def progressive_samples(noise: torch.Tensor, valid: torch.Tensor,
                        sample_size: int,
                        quality_rank: torch.Tensor) -> torch.Tensor:
    """PROSAC samples from given Gumbel ``noise`` (B, N): hypothesis t
    takes the ``sample_size`` largest noise entries among the first n_t of
    the quality order (``prosac_prefix_sizes``, clipped to the number of
    valid entries).  Returns (B, k) int64 indices into the data, on
    ``noise``'s device."""
    num_hypotheses, num_data = noise.shape
    device = noise.device
    valid = valid.to(device)
    rank = torch.where(valid, quality_rank.to(device, noise.dtype),
                       torch.full((), float("inf"), dtype=noise.dtype,
                                  device=device))
    order = torch.argsort(rank, stable=True)  # (N,)
    prefix = torch.minimum(
        torch.as_tensor(prosac_prefix_sizes(num_data, sample_size,
                                            num_hypotheses),
                        dtype=torch.int64, device=device),
        valid.sum())  # never sample padding
    pos = torch.arange(num_data, device=device)
    logits = torch.where(pos[None, :] < prefix[:, None], noise,
                         torch.full((), -float("inf"), dtype=noise.dtype,
                                    device=device))
    return order[_top_k_indices(logits, sample_size)]


def draw_samples_progressive(generator: torch.Generator, num_data: int,
                             valid: torch.Tensor, sample_size: int,
                             num_hypotheses: int,
                             quality_rank: torch.Tensor) -> torch.Tensor:
    """PROSAC sampling, batched (reference ``ransac.py:131-155``): (B, k)
    distinct indices, hypothesis t drawing from the top-n_t entries of the
    quality order (``quality_rank`` (N,), lower = better).  The Gumbel
    noise comes from ``generator`` on the CPU and moves to ``valid``'s
    device."""
    if valid.shape != (num_data,):
        raise ValueError(f"valid must be ({num_data},), got "
                         f"{tuple(valid.shape)}")
    noise = gumbel_noise(generator, num_hypotheses, num_data)
    return progressive_samples(noise.to(valid.device), valid, sample_size,
                               quality_rank)


def subset_prescreen(res_subset: torch.Tensor, threshold,
                     valid_subset: torch.Tensor, keep: int) -> torch.Tensor:
    """Indices (keep,) of the ``keep`` hypotheses with the best support on
    a residual subset (``res_subset`` (B, n_sub) squared residuals), best
    first, the lower index first among equal scores: the batched stand-in
    for the reference's SPRT (``sprt.h:45-80``, ``ransac.py:158-174``)."""
    score, _, _ = inlier_score(res_subset, threshold, valid_subset)
    return _top_k_indices(score, keep)

