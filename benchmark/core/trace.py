"""A bounded traced slice of the steady window, and what it holds.

``trace_units`` runs a few timed units under ``torch.profiler`` (CPU and
CUDA activities), writes the chrome trace to ``TMPDIR``, reads it back and
deletes it.  The slice keeps, for each device operation (kernel, memcpy,
memset), its name, start, duration and the stack of host spans
(``record_function`` ranges, the program's and the benchmark's) that were
open when the host launched it, found through the launch's correlation id.
Per-layer metric readers take their numbers from a ``TraceSlice``.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class DeviceOp:
    name: str
    cat: str  # "kernel", "gpu_memcpy" or "gpu_memset"
    start_us: float
    dur_us: float
    spans: Tuple[str, ...]  # enclosing host spans, outermost first


@dataclass
class TraceSlice:
    window_s: float
    ops: List[DeviceOp]
    spans: List[Tuple[str, float, float]]  # host (name, start_us, end_us)
    units: List[dict]  # what each traced unit returned
    info: dict = field(default_factory=dict)  # the loop's static shapes

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in _merged(self.ops)) / 1e6

    def device_s(self, pred: Callable[[DeviceOp], bool]) -> float:
        return sum(o.dur_us for o in self.ops if pred(o)) / 1e6

    def under(self, prefixes: Sequence[str]) -> Callable[[DeviceOp], bool]:
        """Predicate: the op was launched inside a span whose name starts
        with one of ``prefixes``."""
        prefixes = tuple(prefixes)
        return lambda o: any(s.startswith(prefixes) for s in o.spans)

    def named(self, part: str) -> Callable[[DeviceOp], bool]:
        """Predicate: a kernel whose name holds ``part``."""
        return lambda o: o.cat == "kernel" and part in o.name

    def kernels(self) -> int:
        return sum(1 for o in self.ops if o.cat == "kernel")

    def span_count(self, name: str) -> int:
        return sum(1 for s in self.spans if s[0] == name)

    def total(self, key: str) -> float:
        return sum(u.get(key, 0) for u in self.units)


def _merged(ops: Sequence[DeviceOp]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted((o.start_us, o.start_us + o.dur_us) for o in ops):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def stacks_at(spans: List[Tuple[float, float, str]],
              times: Sequence[float]) -> List[Tuple[str, ...]]:
    """The names of the spans (start, end, name) of one thread, which nest,
    open at each of the ascending ``times``, outermost first."""
    spans = sorted(spans)
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(tuple(s[2] for s in stack if s[1] >= t))
    return out


def parse_trace(events: List[dict], window_s: float, units: List[dict],
                info: dict) -> TraceSlice:
    """A ``TraceSlice`` from chrome-trace events."""
    launches: Dict[int, Tuple[float, int]] = {}  # correlation -> (ts, tid)
    spans_by_tid: Dict[int, List[Tuple[float, float, str]]] = {}
    dev = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args", {})
        if cat == "cuda_runtime" and "correlation" in args:
            launches[args["correlation"]] = (float(e["ts"]), e.get("tid"))
        elif cat == "user_annotation":
            ts = float(e["ts"])
            spans_by_tid.setdefault(e.get("tid"), []).append(
                (ts, ts + float(e.get("dur", 0.0)), e["name"]))
        elif cat in DEVICE_CATS:
            dev.append(e)
    queries: Dict[int, List[Tuple[float, int]]] = {}
    for i, e in enumerate(dev):
        corr = e.get("args", {}).get("correlation")
        if corr in launches:
            ts, tid = launches[corr]
            queries.setdefault(tid, []).append((ts, i))
    stacks: Dict[int, Tuple[str, ...]] = {}
    for tid, q in queries.items():
        q.sort()
        found = stacks_at(spans_by_tid.get(tid, []), [t for t, _ in q])
        stacks.update((i, st) for (_, i), st in zip(q, found))
    ops = [DeviceOp(e["name"], e["cat"], float(e["ts"]), float(e["dur"]),
                    stacks.get(i, ())) for i, e in enumerate(dev)]
    spans = [(n, s, e) for lst in spans_by_tid.values() for s, e, n in lst]
    return TraceSlice(window_s=window_s, ops=ops, spans=spans, units=units,
                      info=info)


def trace_units(unit: Callable[[], dict], n: int, sync: Callable[[], None],
                info: dict) -> TraceSlice:
    """Run ``unit`` ``n`` times under the profiler; the slice's window is
    the host time from the first unit's start to the device's end."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False) as prof:
        t0 = time.perf_counter()
        units = [unit() for _ in range(n)]
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    del prof
    sync()
    return parse_trace(events, window_s, units, info)


def breakdown(sl: TraceSlice, top: int = 10) -> dict:
    """The device operations that took the most time, and the idle gaps
    between device operations summed by the innermost host span open when
    each gap began."""
    by_name: Dict[str, float] = {}
    for o in sl.ops:
        by_name[o.name[:120]] = by_name.get(o.name[:120], 0.0) + o.dur_us
    busy = _merged(sl.ops)
    pairs = list(zip(busy, busy[1:]))
    open_at = stacks_at([(s, e, n) for n, s, e in sl.spans],
                        [e0 for (_, e0), _ in pairs])
    gaps: Dict[str, float] = {}
    for ((_, e0), (s1, _)), st in zip(pairs, open_at):
        name = st[-1] if st else "(no span)"
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0)

    def top_list(d):
        return [[k, v / 1e6] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_list(by_name), "idle_gaps": top_list(gaps)}
