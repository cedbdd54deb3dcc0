"""The camera and point bins of the port's BA solvers (``ba._bins``).

``_bins`` sums each bin's rows one after another in ascending source
position, from a ``bin_plan`` built once per solve, so a float32 solve on
the card gives one result every run (``index_add_`` on CUDA adds with
atomics, in an order that changes between runs).  On the CPU that is the
order in which ``index_add_`` adds, so the two agree to the bit, and the
solvers' results on the CPU are what they were with ``index_add_``.  The
solvers are held against the JAX package in ``test_torch_ba_*.py``.
"""

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.optim import ba as tba

torch.set_num_threads(2)


def _index_add(n, index, values):
    return values.new_zeros((n,) + values.shape[1:]).index_add_(0, index,
                                                                values)


def _case(kind, n, N, rng):
    if kind == "uniform":
        return rng.integers(0, n, N)
    if kind == "empty":  # bins 0, 3 and n - 1 get nothing
        index = rng.integers(1, n - 1, N)
        return np.where(index == 3, 4, index)
    return np.full(N, n // 2)  # one bin holds every row


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(), (6,), (6, 6), (3, 3)])
@pytest.mark.parametrize("kind", ["uniform", "empty", "all_in_one"])
def test_bins_equal_index_add_to_the_bit(kind, shape, dtype):
    rng = np.random.default_rng(hash((kind, shape)) % 2 ** 32)
    n, N = 37, 5000
    index = torch.tensor(_case(kind, n, N, rng))
    values = torch.tensor(rng.standard_normal((N,) + shape), dtype=dtype)
    got = tba._bins(tba.bin_plan(n, index), values)
    ref = _index_add(n, index, values)
    assert got.shape == ref.shape and got.dtype == dtype
    assert torch.equal(got, ref)
    if kind != "uniform":
        assert not got[0].any() and not got[n - 1].any()


def test_bin_plan_is_the_stable_order_of_the_ids():
    index = torch.tensor([3, 0, 3, 1, 0, 3, 5])
    plan = tba.bin_plan(6, index)
    assert plan.order.tolist() == [1, 4, 3, 0, 2, 5, 6]
    assert plan.offsets.tolist() == [0, 2, 3, 3, 6, 6, 7]
    # Rows are added in ascending source position: the rounding shows it
    # ((1e-16 + 1) - 1 = 0, where (-1 + 1) + 1e-16 = 1e-16).
    values = torch.tensor([1e-16, 5.0, 1.0, 7.0, -1.0], dtype=torch.float64)
    got = tba._bins(tba.bin_plan(2, torch.tensor([0, 1, 0, 1, 0])), values)
    assert got.tolist() == [0.0, 12.0]


def test_bins_of_no_rows_are_zero():
    plan = tba.bin_plan(4, torch.zeros(0, dtype=torch.long))
    got = tba._bins(plan, torch.zeros(0, 6, dtype=torch.float64))
    assert torch.equal(got, torch.zeros(4, 6, dtype=torch.float64))
