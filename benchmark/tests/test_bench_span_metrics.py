"""The readers of the program's BA and matcher spans, on hand-built
traced slices, and the cells that report them."""

import pytest

from benchmark.core import spec as spec_mod
from benchmark.core.trace import DeviceOp, TraceSlice

BA = ["collection1000.global_ba", "sequence300.global_ba"]
CELLS = {
    "from_flat_ms_per_solve": BA,
    "bin_sum_ms_per_lm_iter": BA,
    "jacobian_launches_per_lm_iter": BA,
    "lm_reject_pct": BA,
    "host_reads_per_lm_iter": BA,
    "match_gather_us_per_pair.frontend": ["sequence300.frontend"],
    "match_gather_us_per_pair.match": ["collection1000.exhaustive_match"],
}


def _op(dur_us, *spans, cat="kernel"):
    return DeviceOp("k", cat, 0.0, dur_us, tuple(spans))


def ba_slice(iters=(3, 2)):
    """Two solves of ``iters`` LM iterations: per solve one layout span of
    4 ms (the second 6 ms), its 4 reads and the Gram plan's, per
    iteration a Jacobian pass of 3 kernels and a memcpy, two bin sums of
    10 us of device time, two reads; 2 of the 5 steps rejected."""
    spans, ops, t = [], [], 0.0
    for i, it in enumerate(iters):
        spans.append(("bench.from_flat_problem", t, t + 9e3))
        spans.append(("ba_dense.from_flat_problem", t, t + 4e3 + 2e3 * i))
        spans += [("ba_dense.host_read", t, t + 1.0)] * 4
        spans.append(("schur_pcg.host_read", t, t + 1.0))
        for _ in range(it):
            spans.append(("ba_soa.solve_step", t, t + 1.0))
            spans += [("ba_soa.host_read", t, t + 1.0)] * 2
            spans += [("ba.jacobians", t, t + 1.0)] + [
                ("ba.bins", t, t + 1.0)] * 2
            ops += [_op(5.0, "ba_soa.build_normal", "ba.jacobians")] * 3
            ops.append(_op(7.0, "ba_soa.build_normal", "ba.jacobians",
                           cat="gpu_memcpy"))
            ops += [_op(4.0, "ba_soa.build_normal", "ba.bins"),
                    _op(6.0, "ba_soa.build_normal", "ba.bins")] * 2
            ops.append(_op(100.0, "ba_soa.solve_step", "ba_soa.gram"))
        spans += [("ba_soa.host_read", t, t + 1.0)] * 2
        t += 1e5
    spans += [("ba_soa.rejected_step", 0.0, 1.0)] * 2
    units = [{"obs": 10, "iters": it} for it in iters]
    return TraceSlice(window_s=1.0, ops=ops, spans=spans, units=units)


def match_slice(pairs=(64, 36)):
    """Two chunks: gathers of 40 + 24 us under ``matching.gather`` a
    chunk, a kernel under ``matching.top2`` and one under the harness's
    own span only."""
    ops, spans = [], []
    for p in pairs:
        spans += [("bench.match_many_pairs", 0.0, 9.0),
                  ("matching.gather", 0.0, 1.0), ("matching.top2", 1.0, 2.0),
                  ("matching.gate", 2.0, 3.0)]
        ops += [_op(40.0, "bench.match_many_pairs", "matching.gather"),
                _op(24.0, "bench.match_many_pairs", "matching.gather"),
                _op(500.0, "bench.match_many_pairs", "matching.top2"),
                _op(9.0, "bench.match_many_pairs")]
    units = [{"pairs": p, "match_calls": []} for p in pairs]
    return TraceSlice(window_s=1.0, ops=ops, spans=spans, units=units)


def _read(name, sl):
    return spec_mod.load_reader(name)(sl)


def test_ba_readers_give_the_slice_numbers():
    sl = ba_slice()
    assert _read("from_flat_ms_per_solve", sl) == pytest.approx(5.0)
    # 5 iterations x 2 sums x 10 us = 100 us.
    assert _read("bin_sum_ms_per_lm_iter", sl) == pytest.approx(0.02)
    # Kernels only: the memcpy under the span is no launch.
    assert _read("jacobian_launches_per_lm_iter", sl) == pytest.approx(3.0)
    assert _read("lm_reject_pct", sl) == pytest.approx(40.0)
    # 2 solves x (4 + 1 + 2) reads, and 2 an iteration.
    assert _read("host_reads_per_lm_iter", sl) == pytest.approx(24 / 5)


@pytest.mark.parametrize("name", ["match_gather_us_per_pair.frontend",
                                  "match_gather_us_per_pair.match"])
def test_match_gather_reads_device_time_per_pair(name):
    assert _read(name, match_slice()) == pytest.approx(128.0 / 100)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_nothing_to_divide_by_reads_none(name):
    """No LM iteration, solve step or pair; no device operation (a CPU
    run); or the parent program, without the spans."""
    sl = match_slice() if name.startswith("match") else ba_slice()
    no_steps = TraceSlice(1.0, sl.ops, [
        s for s in sl.spans if s[0] not in (
            "ba_soa.solve_step", "ba_dense.from_flat_problem")],
        [dict(u, iters=0, pairs=0) for u in sl.units])
    no_ops = TraceSlice(1.0, [], sl.spans, sl.units)
    parent = TraceSlice(1.0, [
        DeviceOp(o.name, o.cat, o.start_us, o.dur_us,
                 tuple(s for s in o.spans if s.startswith(
                     ("bench.", "ba_soa.build_normal", "ba_soa.solve_step",
                      "ba_soa.gram"))))
        for o in sl.ops],
        [s for s in sl.spans if s[0].startswith(
            ("bench.", "ba_soa.solve_step"))], sl.units)
    assert _read(name, sl) is not None
    for case in (no_steps, no_ops, parent):
        assert _read(name, case) is None


def test_each_metric_is_found_in_its_cells_alone():
    spec = spec_mod.load_spec()
    for w in spec["workloads"]:
        cell = spec_mod.load_cell(w["name"], spec=spec)
        found = {m["name"] for m in cell.per_layer}
        for name, cells in CELLS.items():
            assert (name in found) == (w["name"] in cells), (name, w)
            if name in found:
                assert name in cell.readers
