"""Find a cell's parts by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in files of its own, found by name:

* configuration ``<config>``: the file its ``configs`` entry names;
* traffic mix ``<traffic>``: ``benchmark/traffic/<traffic>.json``, whose
  ``kind`` names the general loop ``benchmark/loops/<kind>.py`` that
  reads it;
* per-layer metric ``<name>``: ``benchmark/metrics/<name>.py``, a reader
  with ``read(trace_slice)``; a split metric ``<base>.<part>`` without a
  file of its own (``idle_pct.ba``, ``idle_pct.frontend``) is read by
  ``benchmark/metrics/<base>.py``;
* the limits of the comparison that decides ``correct``:
  ``benchmark/limits/<workload>.json``.

A later cell, mix or metric is added by adding such files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file's contents
    mix: dict               # the traffic file's contents
    limits: dict            # number name -> limit
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports
    readers: Dict[str, Callable] = field(default_factory=dict)


def load_spec(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    with open(path) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str, e2e_names: List[str]) -> bool:
    """Whether a metric belongs in this cell's line: listed cells where the
    metric has a ``workloads`` key; else every cell (end-to-end) or every
    cell that reports the end-to-end metric it moves (per layer)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def reader_path(name: str, bench_dir: str = BENCH_DIR) -> str:
    """``metrics/<name>.py``, or else ``metrics/<base>.py`` for a metric
    ``<base>.<part>``: one reader serves each part of a split metric."""
    own = os.path.join(bench_dir, "metrics", name + ".py")
    if os.path.isfile(own) or "." not in name:
        return own
    return os.path.join(bench_dir, "metrics", name.split(".")[0] + ".py")


def load_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read`` of the metric's reader file (``reader_path``), loaded by
    path (metric names may hold dots)."""
    path = reader_path(name, bench_dir)
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(workload: str, root: str = ROOT,
              spec: Optional[dict] = None) -> Cell:
    spec = spec if spec is not None else load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    bench_dir = os.path.join(root, "benchmark")
    mix = _read_json(os.path.join(bench_dir, "traffic",
                                  w["traffic"] + ".json"))
    limits_path = os.path.join(bench_dir, "limits", workload + ".json")
    limits = _read_json(limits_path)["limits"] if os.path.isfile(
        limits_path) else {}
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, workload, e2e_names)]
    readers = {m["name"]: load_reader(m["name"], bench_dir)
               for m in per_layer}
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                mix=mix, limits=limits, end_to_end=e2e, per_layer=per_layer,
                readers=readers)


def loop_class(kind: str):
    """The general loop of a traffic mix's ``kind``:
    ``benchmark/loops/<kind>.py``'s ``Loop``."""
    return importlib.import_module(f"benchmark.loops.{kind}").Loop
