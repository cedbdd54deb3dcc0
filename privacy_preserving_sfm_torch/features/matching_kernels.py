"""Wrappers of the exact top-2 match kernel, ``kernels/match_top2.cu``.

Port of the TPU kernels ``top2_scores_bidir`` and ``top2_scores`` of
``privacy_preserving_sfm_tpu/features/matching_kernels.py``: best dot,
second dot and argmax of uint8 descriptor sets, in both directions from
one contraction, or along the candidates only.  On a CUDA tensor both
launch the kernel (``top2_scores`` is its row-only mode) for any N1 and
N2, with D = 128; on a CPU tensor they take the plain version,
``matching._top2_both_batched_plain``; any other device raises.

The values are the plain version's, padding included: an invalid entry
counts as -1e9, a row or column with no valid candidate gives best =
second = -1e9 and idx = 0, and one with a single valid candidate gives
second = -1e9.  (The TPU kernel biased invalid entries by -2^26 instead
and returned those biased values for them.)

The kernel computes the column direction as the row direction of the
swapped pair in the same launch, so it needs no scratch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from privacy_preserving_sfm_torch.features import matching
from privacy_preserving_sfm_torch.kernels import build as kernels

DIM = 128


def _check(d1: torch.Tensor, d2: torch.Tensor, valid1: torch.Tensor,
           valid2: torch.Tensor) -> str:
    """Validates shapes and types; returns the device kind."""
    if d1.dim() != 3 or d2.dim() != 3 or d1.shape[0] != d2.shape[0]:
        raise ValueError(f"expected d1 (B, N1, D) and d2 (B, N2, D), got "
                         f"{tuple(d1.shape)} and {tuple(d2.shape)}")
    if d1.dtype != torch.uint8 or d2.dtype != torch.uint8:
        raise TypeError(f"descriptors must be uint8, got {d1.dtype}, "
                        f"{d2.dtype}")
    if d1.shape[2] != d2.shape[2]:
        raise ValueError("d1 and d2 differ in descriptor length")
    if valid1.shape != d1.shape[:2] or valid2.shape != d2.shape[:2]:
        raise ValueError("valid masks must be (B, N1) and (B, N2)")
    kind = d1.device.type
    if kind not in ("cpu", "cuda"):
        raise RuntimeError(f"no match kernel for device {d1.device}")
    if any(t.device != d1.device for t in (d2, valid1, valid2)):
        raise ValueError("inputs lie on different devices")
    if kind == "cuda":
        if d1.shape[2] != DIM:
            raise ValueError(f"the match kernel takes D = {DIM}, got "
                             f"{d1.shape[2]}")
        if d1.shape[1] == 0 or d2.shape[1] == 0 or d1.shape[0] == 0:
            raise ValueError("the match kernel needs B, N1, N2 >= 1")
    return kind


def _launch(d1, d2, valid1, valid2, both: bool):
    B, N1, _ = d1.shape
    N2 = d2.shape[1]
    d1, d2 = d1.contiguous(), d2.contiguous()
    v1 = valid1.to(torch.uint8).contiguous()
    v2 = valid2.to(torch.uint8).contiguous()
    if d1.data_ptr() % 16 or d2.data_ptr() % 16:
        raise ValueError("the match kernel needs 16-byte aligned "
                         "descriptor tables")
    if B > 65535:
        raise ValueError(f"the match kernel takes at most 65535 pairs a "
                         f"launch, got {B}")
    f32 = dict(dtype=torch.float32, device=d1.device)
    i32 = dict(dtype=torch.int32, device=d1.device)
    rows = (torch.empty(B, N1, **f32), torch.empty(B, N1, **f32),
            torch.empty(B, N1, **i32))
    cols = None
    if both:
        cols = (torch.empty(B, N2, **f32), torch.empty(B, N2, **f32),
                torch.empty(B, N2, **i32))
    kernels.launch_match_top2(d1, d2, v1, v2, *rows, cols=cols)
    return rows if cols is None else rows + cols


def top2_scores_bidir(d1: torch.Tensor, d2: torch.Tensor,
                      valid1: torch.Tensor, valid2: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
    """Top-2 dots + argmax in BOTH directions.

    d1: (B, N1, 128) uint8; d2: (B, N2, 128) uint8; valid1/2: (B, N)
    bool.  Returns (bd12, sd12, idx12, bd21, sd21, idx21): float32,
    float32, int32 tables (B, N1) and (B, N2) of true uint8 dots.
    """
    if _check(d1, d2, valid1, valid2) == "cpu":
        return matching._top2_both_batched_plain(d1, d2, valid1, valid2)
    return _launch(d1, d2, valid1, valid2, both=True)


def top2_scores(d1: torch.Tensor, d2: torch.Tensor, valid2: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    """Top-2 dots + argmax along the candidate axis only (every row of d1
    counts as valid).  Returns (best, second, idx), (B, N1) float32,
    float32, int32."""
    valid1 = torch.ones(d1.shape[:2], dtype=torch.bool, device=d1.device)
    if _check(d1, d2, valid1, valid2) == "cpu":
        return matching._top2_both_batched_plain(d1, d2, valid1,
                                                 valid2)[:3]
    return _launch(d1, d2, valid1, valid2, both=False)
