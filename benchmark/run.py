"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (scene, frames or descriptors made on the device from the seed, and
one warm unit of the cell's own shapes) is timed from process start as
``setup_s``.  Then timed units run until ``--seconds`` have passed; each
end-to-end rate is the work of every unit completed divided by all the
time they took.  With ``--trace 1`` a bounded slice at the start of the
window runs under ``torch.profiler`` and the line carries the cell's
per-layer metrics instead.  After the window the device's peak memory is
read, the program's state is freed and a sample of what the window
produced is compared with the plain reference under ``benchmark/
reference/``; each number compared is printed beside its limit on
standard error and in the line's last key.  The run fails, and prints no
line, without the CUDA devices the cell asks for, or when JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# Every build and kernel cache at a fixed path inside the checkout.
_CACHE = os.path.join(ROOT, "benchmark", "_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
os.environ["USE_FLAX"] = "0"
# One process with few threads: the host half of each cell (Python
# dispatch, numpy regrouping) runs steadier without a pool of spinning
# CPU workers beside it.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "2"

from benchmark.core import guard  # noqa: E402
from benchmark.core import spec as spec_mod  # noqa: E402
from benchmark.core import trace as trace_mod  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 1):
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def require_devices(chips: int):
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs only on the card", 2)
    if torch.cuda.device_count() < chips:
        fail(f"the cell asks for {chips} CUDA devices, "
             f"{torch.cuda.device_count()} present", 2)


def run_window(loop, seconds: float, trace: bool):
    """Timed units until ``seconds`` have passed.  Returns (units, elapsed,
    trace slice or None)."""
    sl = None
    units = []
    t0 = time.perf_counter()
    if trace:
        sl = trace_mod.trace_units(loop.unit, loop.trace_units(),
                                   loop.sync, loop.info())
        units.extend(sl.units)
    while time.perf_counter() - t0 < seconds:
        units.append(loop.unit())
    loop.sync()
    return units, time.perf_counter() - t0, sl


def result_line(cell, units, elapsed, setup_s, sl, checks, peak_bytes,
                device):
    import torch

    failed = sum(1 for u in units if u.get("failed"))
    if sl is None:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
                continue
            work = cell.mix["rates"][m["name"]]
            metrics[m["name"]] = {
                "value": sum(u.get(work, 0) for u in units) / elapsed,
                "unit": m["unit"]}
    else:
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](sl)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak_bytes}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": len(units), "failed": failed, "metrics": metrics,
           "device": dev}
    if sl is not None:
        dev["busy_s"] = sl.busy_s
        dev["window_s"] = sl.window_s
        out["breakdown"] = trace_mod.breakdown(sl)
    out["checks"] = checks
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, route_device: str = None):
    """Set-up, window and check of one run; returns (result line,
    loop).  ``route_device`` is for the CPU tests, which drive the card's
    route on the plain kernels."""
    import torch

    Loop = spec_mod.loop_class(cell.mix["kind"])
    loop = Loop(cell.config, cell.mix, seed, device)
    if route_device is not None:
        loop.route_device = route_device
    loop.warm()
    loop.sync()
    setup_s = time.perf_counter() - t_start

    units, elapsed, sl = run_window(loop, seconds, trace)
    peak_bytes = (int(torch.cuda.max_memory_allocated(device))
                  if device.type == "cuda" else 0)
    checks = loop.check(cell.limits)
    line = result_line(cell, units, elapsed, setup_s, sl, checks,
                       peak_bytes, device)
    return line, loop


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = spec_mod.load_cell(args.workload)
    require_devices(cell.chips)
    import torch

    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line, loop = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device, T_START)
    found = guard.loaded(guard.FORBIDDEN)
    if found:
        fail("loaded after the window (forbidden): " + ", ".join(found))
    if args.trace:
        print(f"card: {loop.card_text()}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
