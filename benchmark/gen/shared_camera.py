"""Starts of a shared-camera BA whose focal is unknown.

A video from one camera of unknown focal: every image was lifted under the
same start parameters (f0, cx, cy), the focal the mapper holds when the
BA starts.  ``start_focal`` draws f0 uniformly within ``spread`` of the
true focal; ``lifted_lines`` turns the scene's true normalized lines
(``ba_scene``, lifted under the true focal) into the lines the same image
lines lift to under f0.  A focal change with the principal point fixed is
an affinity of the normalized plane, (x, y) -> (x, y) f_true / f0, under
which a line (a, b, c) becomes (a f0 / f_true, b f0 / f_true, c),
renormalized so that ||(a, b)|| = 1.
"""

from __future__ import annotations

import numpy as np
import torch


def start_focal(seed: int, focal: float, spread: float) -> float:
    """f0, uniform in focal (1 - spread, 1 + spread), from ``seed``."""
    u = np.random.default_rng(seed).uniform(-spread, spread)
    return float(focal * (1.0 + u))


def lifted_lines(lines: torch.Tensor, f_true: float, f0: float
                 ) -> torch.Tensor:
    """The lines (O, 3) lifted under ``f_true`` as lifted under ``f0``."""
    a = lines[:, 0] * (f0 / f_true)
    b = lines[:, 1] * (f0 / f_true)
    norm = torch.sqrt(a * a + b * b)
    return torch.stack([a / norm, b / norm, lines[:, 2] / norm], 1)
