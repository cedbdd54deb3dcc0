"""The sharded BA and the sharded matcher (``parallel/``) on the card.

A world of one rank (NCCL) solves two float32 problems bit-equal to
``ba.bundle_adjust`` on the same card; a world of two ranks sharing the
card through gloo returns the same cameras on both ranks, and its
sharded matcher (``match_top2.cu`` on each rank) equals the unsharded
one.  Every test needs a CUDA device and skips without one.  This file
imports no JAX, so it runs with ``--noconftest`` where JAX is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_parallel_card.py``.
"""

import numpy as np
import pytest
import torch
from torch_dist_worker import random_problem, run_world

from privacy_preserving_sfm_torch.utils.synthetic import sift_like

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from privacy_preserving_sfm_torch.kernels import build

    build.build()  # once here, not once a rank
    work = tmp_path_factory.mktemp("card")
    data = {}
    for name, (seed, C, P, noise) in {"small": (0, 6, 200, 1e-3),
                                      "wide": (1, 20, 2000, 2e-4)}.items():
        for k, v in random_problem(seed, C, P, noise).items():
            data[f"{name}.{k}"] = v
    rng = np.random.default_rng(3)
    desc = sift_like(rng.dirichlet(np.full(128, 0.2), (6, 1000)))
    desc[1, :700] = desc[0, :700]
    valid = np.ones((6, 1000), bool)
    valid[5, 900:] = False
    pairs = np.array([(i, j) for i in range(6) for j in range(i + 1, 6)]
                     + [(0, 0)])  # 15 pairs, padded to 16
    data.update(desc=desc, valid=valid, pairs=pairs.astype(np.int64))
    np.savez(work / "inputs.npz", **data)
    return work


def test_one_rank_nccl_world_is_bit_equal_to_bundle_adjust(inputs):
    run_world(1, "solve", str(inputs), timeout=300, device="cuda:0")
    out = np.load(inputs / "solve_0.npz")
    for name in ("small", "wide"):
        for k in ("q", "t", "X", "summary"):
            np.testing.assert_array_equal(out[f"{name}.{k}"],
                                          out[f"{name}.ref_{k}"])
        assert out[f"{name}.summary"][1] < out[f"{name}.summary"][0]


def test_two_gloo_ranks_on_one_card(inputs):
    run_world(2, "solve", str(inputs), timeout=300, device="cuda:0")
    a, b = (np.load(inputs / f"solve_{r}.npz") for r in range(2))
    for name in ("small", "wide"):
        for k in ("q", "t", "summary", "X_all"):
            np.testing.assert_array_equal(a[f"{name}.{k}"], b[f"{name}.{k}"])
    for out in (a, b):
        for f in ("matches", "num_matches", "best_dist"):
            np.testing.assert_array_equal(out[f"pairs.{f}"],
                                          out[f"pairs.full_{f}"])
    assert a["pairs.num_matches"][0] >= 600  # images 0 and 1 share 700
