"""Seeded inputs of the top-2 match search at the edges of the match
kernel's design (``privacy_preserving_sfm_torch/kernels/match_top2.cu``).

numpy only, so that both the CPU parity tests (which import JAX) and the
card's kernel tests (which must not) can use them.  Each case is
(d1 (B, N1, 128) uint8, d2 (B, N2, 128) uint8, v1 (B, N1) bool,
v2 (B, N2) bool).
"""

import numpy as np

from privacy_preserving_sfm_torch.utils.synthetic import sift_like

TOP = 255  # an all-TOP pair of descriptors has the largest dot, 8,323,200


def _random(rng, b, n1, n2):
    d1 = sift_like(rng.dirichlet(np.full(128, 0.2), (b, n1)))
    d2 = sift_like(rng.dirichlet(np.full(128, 0.2), (b, n2)))
    return d1, d2, np.ones((b, n1), bool), np.ones((b, n2), bool)


def all_top(rng):
    """Pair 0: one all-255 row and two all-255 columns (the largest dot,
    a tie between columns 10 and 140 of different tiles); pair 1: every
    descriptor all-255, so every dot ties at the top of the key range."""
    d1, d2, v1, v2 = _random(rng, 2, 70, 150)
    d1[0, 3] = TOP
    d2[0, 10] = d2[0, 140] = TOP
    d1[1] = TOP
    d2[1] = TOP
    return d1, d2, v1, v2


def tile_ties(rng):
    """Equal best dots on both sides of 128-wide tile boundaries, in the
    column direction (columns 127/128 and 255/256 for rows 5 and 6) and
    the row direction (rows 127/128 and 255/256 for columns 50 and 60)."""
    d1, d2, v1, v2 = _random(rng, 1, 384, 300)
    d2[0, 127] = d2[0, 128] = d1[0, 5]
    d2[0, 255] = d2[0, 256] = d1[0, 6]
    d1[0, 127] = d1[0, 128] = d2[0, 50]
    d1[0, 255] = d1[0, 256] = d2[0, 60]
    return d1, d2, v1, v2


def ragged(rng):
    """N1 < 64 against an N2 that is not a multiple of 64 or 128, and the
    transpose, in one batch shape each way (pair 1 masks some of each)."""
    d1, d2, v1, v2 = _random(rng, 2, 40, 200)
    d2[0, 199] = d1[0, 39]
    v1[1, 30:] = False
    v2[1, 150:] = False
    return d1, d2, v1, v2


def masks(rng):
    """Pair 0: an all-invalid row (7) and an all-invalid column (9);
    pair 1: one valid candidate per row (column 33 only); pair 2: no valid
    row, so every column has no valid candidate."""
    d1, d2, v1, v2 = _random(rng, 3, 130, 260)
    d2[0, 9] = d1[0, 7]  # masked: must not win anything
    v1[0, 7] = False
    v2[0, 9] = False
    v2[1, :] = False
    v2[1, 33] = True
    v1[2, :] = False
    return d1, d2, v1, v2


def one_pair(rng):
    """B = 1, ties along a row and a column."""
    d1, d2, v1, v2 = _random(rng, 1, 100, 260)
    d2[0, 40] = d2[0, 259] = d1[0, 7]
    d1[0, 99] = d1[0, 7]
    return d1, d2, v1, v2


CASES = {"all_top": all_top, "tile_ties": tile_ties, "ragged": ragged,
         "masks": masks, "one_pair": one_pair}


def case(name, transpose=False):
    """The named case from a seed of its own; ``transpose`` swaps the two
    sides (so N1 and N2 trade places)."""
    d1, d2, v1, v2 = CASES[name](np.random.default_rng(len(name)))
    if transpose:
        return d2, d1, v2, v1
    return d1, d2, v1, v2
