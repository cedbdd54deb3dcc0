"""The camera and point bins of the port's BA solvers (``ba._bins``).

``_bins`` sums each bin's rows one after another in ascending source
position, from a ``bin_plan`` built once per solve, so a float32 solve on
the card gives one result every run (``index_add_`` on CUDA adds with
atomics, in an order that changes between runs).  On the CPU that is the
order in which ``index_add_`` adds, so the two agree to the bit, and the
solvers' results on the CPU are what they were with ``index_add_``.  The
solvers are held against the JAX package in ``test_torch_ba_*.py``.

A plan built with ``keep`` puts the dropped rows into no bin.  The
dense-layout solvers drop their padding slots (weight 0) so: their bins
are those of the observed slots, and a solve returns, to the bit, what it
returns with every slot in the plan (a padding slot only ever added an
exact zero).  The solve-level cases on ``cuda`` skip without a card.
"""

import numpy as np
import pytest
import torch

from privacy_preserving_sfm_torch.ops import lie_np
from privacy_preserving_sfm_torch.optim import ba as tba
from privacy_preserving_sfm_torch.optim import ba_dense as tbd
from privacy_preserving_sfm_torch.optim import ba_soa as tsoa
from privacy_preserving_sfm_torch.optim import convert

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
@pytest.mark.parametrize("kind", ["uniform", "empty", "all_in_one",
                                  "uniform_kept", "empty_kept",
                                  "all_in_one_kept"])
def test_bins_equal_index_add_to_the_bit(kind, shape, dtype):
    """``*_kept``: a plan with ``keep`` that drops a third of the rows
    (every second of them moved to bin 0), each holding NaN, inf or -inf;
    the bins equal ``index_add_`` over the kept rows and stay finite."""
    rng = np.random.default_rng(hash((kind, shape)) % 2 ** 32)
    n, N = 37, 5000
    base = kind.removesuffix("_kept")
    index = torch.tensor(_case(base, n, N, rng))
    values = torch.tensor(rng.standard_normal((N,) + shape), dtype=dtype)
    keep = None
    if kind != base:
        keep = torch.tensor(rng.random(N) < 2 / 3)
        dropped = torch.nonzero(~keep)[:, 0]
        index[dropped[::2]] = 0
        bad = torch.tensor([np.nan, np.inf, -np.inf], dtype=dtype)
        values[dropped] = bad[dropped % 3].reshape((-1,) + (1,) * len(shape))
    got = tba._bins(tba.bin_plan(n, index, keep), values)
    ref = (_index_add(n, index, values) if keep is None
           else _index_add(n, index[keep], values[keep]))
    assert got.shape == ref.shape and got.dtype == dtype
    assert torch.equal(got, ref)
    assert torch.isfinite(got).all()
    if base != "uniform":
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


def test_bin_plan_with_keep_sorts_the_dropped_rows_last():
    index = torch.tensor([3, 0, 3, 1, 0, 3, 5])
    keep = torch.tensor([True, True, False, True, False, True, True])
    plan = tba.bin_plan(6, index, keep)
    assert plan.order.tolist() == [1, 3, 0, 5, 6, 2, 4]
    assert plan.offsets.tolist() == [0, 1, 2, 2, 4, 4, 5]
    values = torch.tensor([1.0, 2.0, np.nan, 4.0, np.inf, 8.0, 16.0],
                          dtype=torch.float64)
    got = tba._bins(plan, values)
    assert got.tolist() == [2.0, 4.0, 0.0, 9.0, 0.0, 16.0]


@pytest.mark.parametrize("n, N", [(5, 300), (37, 5000)])
def test_bin_plan_keeping_every_row_is_the_plan_without_keep(n, N):
    index = torch.tensor(np.random.default_rng(N).integers(0, n, N))
    plain = tba.bin_plan(n, index)
    kept = tba.bin_plan(n, index, torch.ones(N, dtype=torch.bool))
    assert torch.equal(kept.order, plain.order)
    assert torch.equal(kept.offsets, plain.offsets)


def test_bins_with_every_row_dropped_are_zero():
    index = torch.tensor([0, 2, 2, 1, 0])
    plan = tba.bin_plan(3, index, torch.zeros(5, dtype=torch.bool))
    assert plan.offsets.tolist() == [0, 0, 0, 0]
    values = torch.full((5, 6), np.nan, dtype=torch.float32)
    assert torch.equal(tba._bins(plan, values),
                       torch.zeros(3, 6, dtype=torch.float32))


def test_bins_of_no_rows_are_zero():
    plan = tba.bin_plan(4, torch.zeros(0, dtype=torch.long))
    got = tba._bins(plan, torch.zeros(0, 6, dtype=torch.float64))
    assert torch.equal(got, torch.zeros(4, 6, dtype=torch.float64))


def _ragged_problem(seed, dtype, device, C=9, P=150):
    """A flat problem whose tracks are 2 to C views long, so its dense
    layout pads most points' slots; camera 0 holds real observations
    besides the padding, and the gauge freezes camera 4 and one dof of
    camera 6."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (P, 3)) + np.array([0.0, 0.0, 8.0])
    yaw = rng.uniform(-0.4, 0.4, C)
    qs = np.stack([np.cos(yaw / 2), 0 * yaw, np.sin(yaw / 2), 0 * yaw], 1)
    ts = np.stack([rng.uniform(-2, 2, C), rng.uniform(-0.3, 0.3, C),
                   rng.uniform(-0.5, 0.5, C)], 1)
    lengths = rng.integers(2, C + 1, P)
    obs_cam = np.concatenate([rng.permutation(C)[:n] for n in lengths])
    obs_point = np.repeat(np.arange(P), lengths)
    Rm = np.stack([lie_np.quat_to_rotmat(q) for q in qs])
    Xc = np.einsum("oij,oj->oi", Rm[obs_cam], pts[obs_point]) + ts[obs_cam]
    uv = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 1e-3, (len(obs_cam), 2))
    hom = np.concatenate([uv, np.ones((len(uv), 1))], 1)
    lines = np.cross(rng.standard_normal((len(uv), 3)), hom)
    lines /= np.linalg.norm(lines[:, :2], axis=-1, keepdims=True)
    mask = np.ones((C, 6))
    mask[4] = 0.0
    mask[6, 3] = 0.0
    fields = dict(
        qvecs=qs + rng.normal(0, 1e-3, qs.shape),
        tvecs=ts + rng.normal(0, 1e-2, ts.shape),
        cam_params=np.tile([500.0, 320.0, 240.0], (C, 1)),
        points3d=pts + rng.normal(0, 1e-2, pts.shape),
        obs_cam=obs_cam, obs_point=obs_point, obs_line=lines,
        obs_weight=np.ones(len(obs_cam)), cam_dof_mask=mask,
        point_mask=np.ones(P))
    return tbd.from_flat_problem(
        convert.ba_problem_from_numpy(fields, device, dtype))


def _solve(dense, route):
    opts = tba.BAOptions(max_iterations=8,
                         schur_mode="explicit" if route == "soa" else route)
    if route == "soa":
        return tsoa.bundle_adjust_soa(dense, "SIMPLE_PINHOLE", opts,
                                      plain=True)
    return tbd.bundle_adjust_dense(dense, "SIMPLE_PINHOLE", opts)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("route", ["soa", "explicit", "implicit"])
def test_solve_without_padding_in_the_bins_is_bit_equal(route, dtype, device,
                                                        monkeypatch):
    """The dense-layout solvers on a ragged problem return, to the bit,
    the poses and points and the iteration count of the same solve whose
    camera plan keeps every slot, the padding's in camera 0's bin.  Both
    solves sum in the one-level order (the CPU's): on the card a two-level
    plan's runs would move with the padding rows counted in them."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    dense = _ragged_problem(7, dtype, torch.device(device))
    P, K = dense.obs_cam.shape
    padding = dense.obs_weight == 0
    assert 0.3 * P * K < int(padding.sum()) < P * K
    assert int((dense.obs_cam[~padding] == 0).sum()) > 0
    assert bool((dense.obs_cam[padding] == 0).all())

    plans = []
    bin_plan = tba.bin_plan

    def one_level(plan):
        return tba.BinPlan(plan.order, plan.offsets)

    def recorded(num_bins, index, keep=None):
        plans.append(one_level(bin_plan(num_bins, index, keep)))
        return plans[-1]

    monkeypatch.setattr(tba, "bin_plan", recorded)
    *got, s_got = _solve(dense, route)
    assert int(plans[-1].offsets[-1]) == P * K - int(padding.sum())

    monkeypatch.setattr(tba, "bin_plan",
                        lambda num_bins, index, keep=None:
                        one_level(bin_plan(num_bins, index)))
    *ref, s_ref = _solve(dense, route)
    assert s_got.num_iterations == s_ref.num_iterations > 1
    assert s_got.final_cost == s_ref.final_cost < s_got.initial_cost
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _two_level_sum(n, index, values, run, keep=None):
    """The two-level order written out: each bin's kept rows in ascending
    source position, cut into runs of at most ``run``; each run's rows
    added one after another, then the bin's run sums in order."""
    out = []
    for b in range(n):
        rows = [i for i in range(len(index)) if int(index[i]) == b
                and (keep is None or bool(keep[i]))]
        total = torch.zeros_like(values[0])
        for s in range(0, len(rows), run):
            part = torch.zeros_like(values[0])
            for i in rows[s:s + run]:
                part = part + values[i]
            total = total + part
        out.append(total)
    return torch.stack(out)


B = 4
# Rows of bins 0..5: 0, 1, B, B + 1, many (7 runs and a part), 3.
SIZES = [0, 1, B, B + 1, 7 * B + 2, 3]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(), (6,), (3, 3)])
@pytest.mark.parametrize("kept", [False, True])
def test_two_level_bins_are_the_two_level_sum_to_the_bit(kept, shape, dtype):
    """A two-level plan (``run_plan``, runs of B = 4 rows) on the CPU: bins
    of 0, 1, B, B + 1 and many rows, the rows of each bin scattered among
    the others; with ``kept`` a third of the rows dropped (holding NaN
    and inf).  Bit for bit the explicit sum in the same order, the same
    bits in a second run, and the plan's run table of the fixed length
    N // B + bins."""
    rng = np.random.default_rng(len(shape) + 10 * kept)
    n = len(SIZES)
    index = torch.tensor(rng.permutation(np.repeat(np.arange(n), SIZES)))
    N = len(index)
    values = torch.tensor(rng.standard_normal((N,) + shape), dtype=dtype)
    keep = None
    if kept:
        keep = torch.tensor(rng.random(N) < 2 / 3)
        values[~keep] = torch.tensor(np.inf, dtype=dtype)
        values[torch.nonzero(~keep)[::2, 0]] = torch.tensor(np.nan,
                                                            dtype=dtype)
    plan = tba.run_plan(tba.bin_plan(n, index, keep), B)
    assert plan.runs.shape == (N // B + n + 1,)
    assert int(plan.runs[-1]) == int(plan.offsets[-1])
    assert bool((plan.runs[1:] - plan.runs[:-1] <= B).all())
    got = tba._bins(plan, values)
    assert torch.equal(got, _two_level_sum(n, index, values, B, keep))
    assert torch.equal(got, tba._bins(plan, values))
    assert torch.isfinite(got).all()
    assert not got[0].any()


def test_two_level_plan_runs_by_hand():
    """Bin 1 of 5 rows in runs of 2: (2, 2, 1); bin 0 empty; bin 2 one
    row; the two runs past the last bin's are empty."""
    index = torch.tensor([1, 2, 1, 1, 1, 1])
    plan = tba.run_plan(tba.bin_plan(3, index), 2)
    assert plan.order.tolist() == [0, 2, 3, 4, 5, 1]
    assert plan.runs.tolist() == [0, 2, 4, 5, 6, 6, 6]
    assert plan.bin_runs.tolist() == [0, 0, 3, 4]
    # Bin 1's runs (1 + 1e16), (-1e16 + 1), (1) sum to 1e16 - 1e16 + 1 =
    # 1, where one chain of its rows gives (((1 + 1e16) - 1e16) + 1) + 1
    # = 2.
    values = torch.tensor([1.0, 3.0, 1e16, -1e16, 1.0, 1.0],
                          dtype=torch.float64)
    assert tba._bins(plan, values).tolist() == [0.0, 1.0, 3.0]
    one = tba.bin_plan(3, index)
    assert tba._bins(one, values).tolist() == [0.0, 2.0, 3.0]


def test_two_level_bins_of_no_rows_are_zero():
    plan = tba.run_plan(tba.bin_plan(4, torch.zeros(0, dtype=torch.long)), 3)
    got = tba._bins(plan, torch.zeros(0, 6, dtype=torch.float32))
    assert torch.equal(got, torch.zeros(4, 6, dtype=torch.float32))


@pytest.mark.cuda
def test_bins_on_the_card_are_two_level_and_repeat_to_the_bit():
    """On the card ``bin_plan`` is two-level (``BIN_RUN``): a bin of every
    row (one shared camera), bins of 300 cameras, kept rows dropped; the
    same bits in two runs, and the explicit two-level sum's bits on the
    CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    N = 200_000
    for n, keep in ((1, None), (300, rng.random(N) < 0.6)):
        index = torch.tensor(rng.integers(0, n, N), device=dev)
        values = torch.tensor(rng.standard_normal((N, 3, 3)),
                              dtype=torch.float32, device=dev)
        keep_t = None if keep is None else torch.tensor(keep, device=dev)
        plan = tba.bin_plan(n, index, keep_t)
        assert plan.runs is not None
        first = tba._bins(plan, values)
        second = tba._bins(tba.bin_plan(n, index, keep_t), values)
        assert torch.equal(first, second)
        cpu = tba.run_plan(tba.bin_plan(
            n, index.cpu(), None if keep_t is None else keep_t.cpu()),
            tba.BIN_RUN)
        assert torch.equal(first.cpu(), tba._bins(cpu, values.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["soa", "explicit", "implicit"])
def test_two_level_solve_on_the_card_repeats_to_the_bit(route, monkeypatch):
    """The dense-layout solvers on the card, with their camera bins in the
    two-level order: the same poses, points and iterations in two runs,
    and the one-level order's final cost to float32 rounding (1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dense = _ragged_problem(7, torch.float32, torch.device("cuda"))
    *first, s1 = _solve(dense, route)
    *second, s2 = _solve(dense, route)
    assert s1 == s2 and s1.final_cost < s1.initial_cost
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    bin_plan = tba.bin_plan
    monkeypatch.setattr(tba, "bin_plan",
                        lambda num_bins, index, keep=None: tba.BinPlan(
                            *bin_plan(num_bins, index, keep)[:2]))
    *_, s_one = _solve(dense, route)
    assert abs(s1.final_cost - s_one.final_cost) <= 1e-4 * s_one.final_cost
