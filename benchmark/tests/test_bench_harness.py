"""The harness finds a cell's parts by name and prints the result
line."""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark.core import spec as spec_mod
from benchmark.tests.tiny import tiny_cell

ROOT = spec_mod.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _run_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_run", os.path.join(ROOT, "benchmark", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_spec_names_units_and_files():
    spec = spec_mod.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [c["name"] for c in spec["configs"]]
    names += [w["traffic"] for w in spec["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    assert len(json.dumps(spec)) < 64 * 1024
    texts = [c["why"] for c in spec["configs"]] + [
        c["source"] for c in spec["configs"]] + [
        w["why"] for w in spec["workloads"]] + [
        m["layer"] for m in spec["per_layer"]] + spec["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    assert 1 <= spec["run_seconds"] <= 51
    for w in spec["workloads"]:
        cell = spec_mod.load_cell(w["name"], spec=spec)
        assert cell.readers and cell.limits
        for m in cell.per_layer:  # the metric it moves is reported there
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
        for c in spec["configs"]:
            assert os.path.isfile(os.path.join(ROOT, c["file"]))


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    """A cell added by files and entries alone: a new configuration file, a
    new traffic file of an existing kind and a new metric reader."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    spec = spec_mod.load_spec()
    (root / "benchmark" / "configs" / "collection2000.json").write_text(
        json.dumps({"num_cameras": 12, "num_points": 300,
                    "obs_per_point": 5, "meas_noise": 2e-4}))
    (root / "benchmark" / "traffic" / "global_ba_slow.json").write_text(
        json.dumps({"kind": "ba_solves", "ba_options": {"cg_iterations": 10},
                    "rates": {"ba_obs_per_s": "obs"}, "trace_units": 1}))
    (root / "benchmark" / "metrics" / "obs_per_solve.py").write_text(
        "def read(sl):\n    return sl.total('obs') / len(sl.units)\n")
    (root / "benchmark" / "limits" / "collection2000.global_ba_slow.json"
     ).write_text(json.dumps({"limits": {"gram_rel_err": 1.0,
                                         "cost_gap": 1.0}}))
    spec["configs"].append({"name": "collection2000", "source": "x",
                            "file": "benchmark/configs/collection2000.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "collection2000.global_ba_slow",
                              "config": "collection2000",
                              "traffic": "global_ba_slow", "chips": 1,
                              "why": "test"})
    spec["end_to_end"][1]["workloads"].append("collection2000.global_ba_slow")
    spec["per_layer"].append({"name": "obs_per_solve", "unit": "obs",
                              "better": "higher",
                              "source": "program_counter", "layer": "x",
                              "moves": "ba_obs_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = spec_mod.load_cell("collection2000.global_ba_slow",
                              root=str(root))
    assert cell.config["num_cameras"] == 12
    assert cell.mix["ba_options"] == {"cg_iterations": 10}
    assert "obs_per_solve" in cell.readers
    assert cell.readers["obs_per_solve"] is not None
    assert spec_mod.loop_class(cell.mix["kind"]).__module__.endswith(
        "ba_solves")


@pytest.mark.parametrize("workload,trace", [
    ("collection1000.global_ba", False), ("collection1000.global_ba", True),
    ("sequence300.frontend", False),
    ("collection1000.exhaustive_match", False)])
def test_result_line_keys(workload, trace):
    run = _run_module()
    cell = tiny_cell(workload)
    line, _ = run.run_cell(cell, 2 ** 33 + 17, 0.5, trace,
                           torch.device("cpu"), time.perf_counter(),
                           route_device=("cuda" if "global_ba" in workload
                                         else None))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for k, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    json.dumps(line)


def test_run_without_cuda_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "collection1000.global_ba", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_run_in_a_bare_checkout_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: no program to run."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "collection1000.global_ba", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_split_metric_is_read_by_its_base_reader(tmp_path):
    """``idle_pct.<part>`` has no file of its own: ``metrics/idle_pct.py``
    reads every part, a later part too; a part with a file of its own
    takes that file."""
    bench = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark", "metrics"),
                    bench / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = str(bench / "metrics" / "idle_pct.py")
    for part in ("idle_pct.ba", "idle_pct.frontend", "idle_pct.train"):
        assert spec_mod.reader_path(part, str(bench)) == base
    own = bench / "metrics" / "idle_pct.train.py"
    own.write_text("def read(sl):\n    return 7.0\n")
    assert spec_mod.reader_path("idle_pct.train", str(bench)) == str(own)
    assert spec_mod.load_reader("idle_pct.train", str(bench))(None) == 7.0
    spec = spec_mod.load_spec()
    for m in spec["per_layer"]:
        assert os.path.isfile(spec_mod.reader_path(m["name"])), m["name"]
