"""The cells ``uncal300.intrinsics_ba`` and ``sequence300.local_ba`` at
tiny sizes on the CPU, as ``test_bench_harness`` runs the others: the
result line's keys, the per-layer metrics a traced run can read here, the
program inside every limit and each control outside at least one; and the
same at the sizes of ``test_bench_control`` on the card.

``sequence300.local_ba`` is not in ``BENCHMARK.json``: its runs on the
card spread wider than half of ``ba_obs_per_s``' bound (PERF.md, Open
questions).  Its loop, traffic mix, limits and reference stay ready, and
the tests load it with the entries that would bring it back
(``LOCAL_ENTRIES``) appended to the benchmark's own."""

import copy
import importlib.util
import os
import time

import pytest
import torch

from benchmark.core import spec as spec_mod

CELLS = ("uncal300.intrinsics_ba", "sequence300.local_ba")
TINY_CONFIG = {
    "uncal300.intrinsics_ba": dict(num_cameras=10, num_points=300,
                                   longest_track=9, num_observations=2000,
                                   track_lengths="ba300_model",
                                   meas_noise=2e-4),
    "sequence300.local_ba": dict(meas_noise=2e-4),
}
TINY_MIX = {
    "sequence300.local_ba": dict(
        scene=dict(num_cameras=9, num_points=200, longest_track=9,
                   num_observations=1200, track_lengths="ba300_model"),
        free_images=4),
}
SMALL_CONFIG = {
    "uncal300.intrinsics_ba": dict(num_cameras=150, num_points=4000,
                                   longest_track=64,
                                   num_observations=120000),
    "sequence300.local_ba": {},
}
CONTROLS = {"uncal300.intrinsics_ba": {"tf32_reference"},
            "sequence300.local_ba": {"tf32_reference", "bf16_gram"}}


# The entries that put ``sequence300.local_ba`` in the benchmark: its
# workload, its name in ``ba_obs_per_s``' list, and its per-layer metrics
# on the readers that are there.
LOCAL = "sequence300.local_ba"
LOCAL_ENTRIES = {
    "workload": {
        "name": LOCAL, "config": "sequence300", "traffic": "local_ba",
        "chips": 1,
        "why": "closed loop of local BAs at Box300's largest (C=15, 6 free, "
               "P=4,127, K=15, 44% points frozen), soft-L1: the SoA LM loop "
               "at small C, PCG cluster path at n=90"},
    # (name, unit, better, source, layer) of each per-layer metric.
    "per_layer": (
        ("ba_ms_per_lm_iter.local", "ms", "lower", "program_counter",
         "BA solver, LM loop"),
        ("lm_iters_per_solve.local", "count", "lower", "program_counter",
         "BA solver, LM loop"),
        ("gram_roofline_pct.local", "%", "higher", "device_trace",
         "Schur kernels"),
        ("pcg_roofline_pct.local", "%", "higher", "device_trace",
         "Schur kernels"),
        ("launches_per_lm_iter.local", "count", "lower", "device_trace",
         "Host dispatch of the LM loop"),
        ("idle_pct.local", "%", "lower", "device_trace", "Device (H100)")),
}


def _spec():
    """``BENCHMARK.json`` with ``LOCAL_ENTRIES`` appended."""
    spec = copy.deepcopy(spec_mod.load_spec())
    if LOCAL in {w["name"] for w in spec["workloads"]}:
        return spec
    spec["workloads"].append(LOCAL_ENTRIES["workload"])
    for m in spec["end_to_end"]:
        if m["name"] == "ba_obs_per_s":
            m["workloads"].append(LOCAL)
    spec["per_layer"] += [
        {"name": name, "unit": unit, "better": better, "source": source,
         "layer": layer, "moves": "ba_obs_per_s", "workloads": [LOCAL]}
        for name, unit, better, source, layer in LOCAL_ENTRIES["per_layer"]]
    return spec


def _load(workload):
    return spec_mod.load_cell(workload, spec=_spec())


def _cell(workload, config, mix=None):
    cell = copy.copy(_load(workload))
    cell.config = config
    cell.mix = dict(cell.mix, **(mix or {}))
    return cell


def _tiny(workload):
    return _cell(workload, dict(TINY_CONFIG[workload]),
                 TINY_MIX.get(workload))


def _run_module():
    spec = importlib.util.spec_from_file_location(
        "bench_run", os.path.join(spec_mod.ROOT, "benchmark", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line_keys(workload, trace):
    run = _run_module()
    cell = _tiny(workload)
    line, _ = run.run_cell(cell, 2 ** 33 + 17, 0.5, trace,
                           torch.device("cpu"), time.perf_counter(),
                           route_device="cuda")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["checks"]) == set(cell.limits)
    if trace:
        # The readers of device time find no device here; the counts do.
        want = {"lm_iters_per_solve", "ba_ms_per_lm_iter"}
        got = {k.split(".")[0] for k in line["metrics"]}
        assert want <= got <= {m["name"].split(".")[0]
                               for m in cell.per_layer}
    else:
        assert set(line["metrics"]) == {"setup_s", "ba_obs_per_s"}


def _readings(cell, seed, device, route_device=None):
    """``readings.read_seed``'s numbers after one timed unit; on the CPU
    the loop takes the card's route on the plain kernels."""
    loop = spec_mod.loop_class(cell.mix["kind"])(cell.config, cell.mix,
                                                 seed, device)
    if route_device is not None:
        loop.route_device = route_device
    loop.warm()
    loop.unit()
    loop.free()
    return {"program": loop.readings(), "controls": loop.controls()}


def _program_passes_and_controls_fail(cell, out):
    limits = cell.limits
    prog = {k: v for k, v in out["program"].items() if k in limits}
    assert set(prog) == set(limits), prog
    assert all(v <= limits[k] for k, v in prog.items()), prog
    assert set(out["controls"]) == CONTROLS[cell.name]
    for name, readings in out["controls"].items():
        ctrl = {k: v for k, v in readings.items() if k in limits}
        assert set(ctrl) == set(limits)
        assert any(v > limits[k] for k, v in ctrl.items()), (name, ctrl)


@pytest.mark.parametrize("workload", CELLS)
def test_tiny_control_fails_a_limit(workload):
    cell = _tiny(workload)
    out = _readings(cell, 2 ** 31 + 5, torch.device("cpu"), "cuda")
    _program_passes_and_controls_fail(cell, out)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 5, 2 ** 31 + 6, 2 ** 31 + 7])
def test_control_fails_and_program_passes_on_the_card(workload, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base = _load(workload)
    cell = _cell(workload, dict(base.config, **SMALL_CONFIG[workload]))
    out = _readings(cell, seed, torch.device("cuda", 0))
    _program_passes_and_controls_fail(cell, out)
