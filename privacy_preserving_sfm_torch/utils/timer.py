"""Wall-clock timing + structured per-phase profiling.

Extends the reference's ``util/timer.{h,cc}`` (start/pause/elapsed prints)
with a phase registry the pipeline uses for its timing report — the
structured profiler the reference lacks (SURVEY.md §5.1); deeper traces
come from ``torch.profiler`` when enabled.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class Timer:
    def __init__(self, start: bool = True):
        self._start = None
        self._elapsed = 0.0
        if start:
            self.start()

    def start(self):
        if self._start is None:
            self._start = time.perf_counter()

    def pause(self):
        if self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None

    def restart(self):
        self._elapsed = 0.0
        self._start = time.perf_counter()

    def elapsed_seconds(self) -> float:
        out = self._elapsed
        if self._start is not None:
            out += time.perf_counter() - self._start
        return out

    def print_seconds(self, label: str = "Elapsed time"):
        print(f"{label}: {self.elapsed_seconds():.3f} [seconds]")

    def print_minutes(self, label: str = "Elapsed time"):
        print(f"{label}: {self.elapsed_seconds() / 60.0:.3f} [minutes]")


class PhaseProfiler:
    """Accumulates wall time per named pipeline phase."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["phase                          total_s   calls"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            lines.append(f"{name:<30} {self.totals[name]:>8.3f} "
                         f"{self.counts[name]:>7d}")
        return "\n".join(lines)


def print_heading1(text: str):
    print("\n" + "=" * 78)
    print(text)
    print("=" * 78)


def print_heading2(text: str):
    print("\n" + text)
    print("-" * len(text))
