"""Build the port's BA problems from numpy fields.

The reference package's ``BAProblem`` / ``DenseBAProblem`` cross over as a
dict of numpy arrays, ``{k: np.asarray(v) for k, v in p._asdict().items()}``,
which these functions turn into the port's containers on ``device``: float
fields in ``dtype``, index fields as int64.  Fields the port does not use
(the dense problem's ``cam_gather`` tables) are ignored.  This module
imports nothing of the reference; the other shared state is the text
model, which both packages read and write.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from privacy_preserving_sfm_torch.optim import ba as ba_mod
from privacy_preserving_sfm_torch.optim import ba_dense

_INDEX_FIELDS = ("obs_cam", "obs_point")


def _tensors(cls, fields: Mapping[str, np.ndarray], device, dtype):
    out = {}
    for name in cls._fields:
        a = np.asarray(fields[name])
        if name in _INDEX_FIELDS:
            out[name] = torch.tensor(a.astype(np.int64), device=device)
        else:
            out[name] = torch.tensor(a, dtype=dtype, device=device)
    return cls(**out)


def ba_problem_from_numpy(fields: Mapping[str, np.ndarray],
                          device, dtype) -> ba_mod.BAProblem:
    return _tensors(ba_mod.BAProblem, fields, device, dtype)


def dense_problem_from_numpy(fields: Mapping[str, np.ndarray],
                             device, dtype) -> ba_dense.DenseBAProblem:
    return _tensors(ba_dense.DenseBAProblem, fields, device, dtype)
