"""Frozen roofline arithmetic: the least time of a kernel's work on one H100.

Operations and bytes of one call, from the problem's shapes, so that any
implementation is read against the same work (the arithmetic of the
port's ``chip_smoke.py`` as the benchmark was defined).  Bytes count each
input read once and each output written once.  The least time is the
larger of the operations at the peak of their type and the bytes at the
memory rate.  Peaks: NVIDIA's H100 SXM data sheet, dense, at its full
700 W power limit (a card set lower runs slower under load; the run
prints the card's limit beside its numbers).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

PEAK_INT8 = 1979e12   # int8 tensor-core operations per second
PEAK_F32 = 67e12      # float32 outside the tensor cores
PEAK_F64 = 67e12      # float64 on the tensor cores
HBM_BYTES_S = 3.35e12
POWER_LIMIT_W = 700.0


def bound(ops: float, peak: float, nbytes: float) -> Tuple[float, str]:
    """(least ms of the work, "operations" or "bytes")."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def gram_flops(distinct_cams: Sequence[int]) -> float:
    """Flops of the work one Schur Gram needs, S being symmetric: for each
    point of m distinct cameras, 108 FMAs for each of its m (m - 1) / 2
    upper camera pairs, 63 for the i1 <= i2 half of each diagonal block
    and 18 for each camera's rhs term; two flops an FMA."""
    m = np.asarray(distinct_cams, np.float64)
    return 2.0 * float((54.0 * m * (m - 1) + 81.0 * m).sum())


def gram_bound(K: int, P: int, C: int, distinct_cams: Sequence[int],
               itemsize: int = 4) -> Tuple[float, str]:
    """One Gram (both regimes, blocked or not): its flops at the float32
    (float64) peak, against lh (18K x P), gL (3 x P), the camera ids
    (K x P int32), S_corr ((6C)^2) and rhs_corr (6C) once each."""
    peak = PEAK_F32 if itemsize == 4 else PEAK_F64
    nbytes = (18 * K * P + 3 * P + (6 * C) ** 2 + 6 * C) * itemsize \
        + 4 * K * P
    return bound(gram_flops(distinct_cams), peak, nbytes)


def pcg_bound(C: int, iters: int = 30, itemsize: int = 4
              ) -> Tuple[float, str]:
    """One PCG solve of n = 6C: S_corr, the two (C, 6, 6) block arrays, rhs
    and x once each; ``iters`` steps of 2n^2 + 34n flops (the S_corr
    product, the two block products, the vector updates) and the first z."""
    n = 6 * C
    return bound(iters * (2.0 * n * n + 34 * n) + 14 * n,
                 PEAK_F32 if itemsize == 4 else PEAK_F64,
                 (n * n + 72 * C + 2 * n) * itemsize)


def match_bound_pairs(shapes: Sequence[Tuple[int, int]]
                      ) -> Tuple[float, str]:
    """``match_bound`` of one call over pairs of (n1, n2) descriptors each,
    both directions: the operations and bytes of every pair summed."""
    ops = sum(2.0 * n1 * n2 * 128 for n1, n2 in shapes)
    nbytes = sum(n1 * (128 + 1 + 12) + n2 * (128 + 1 + 12)
                 for n1, n2 in shapes)
    return bound(ops, PEAK_INT8, nbytes)


def match_bound(b: int, n1: int, n2: int, both: bool = True
                ) -> Tuple[float, str]:
    """The top-2 search of b pairs of n1 x n2 descriptors: one int8
    contraction, the descriptors and masks (row-only: d2's) read and the
    three tables of each direction written once."""
    mask1, out2 = (1, 12) if both else (0, 0)
    nbytes = b * (n1 * (128 + mask1 + 12) + n2 * (128 + 1 + out2))
    return bound(2.0 * b * n1 * n2 * 128, PEAK_INT8, nbytes)
