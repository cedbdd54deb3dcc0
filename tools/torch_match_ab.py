#!/usr/bin/env python3
"""Time the port's top-2 match kernel of several source trees in turns.

    python3 tools/torch_match_ab.py --tree parent=DIR --tree change=. \\
        --order parent,change,change,parent

Each turn runs this script's ``--measure`` mode in a fresh process that
imports ``privacy_preserving_sfm_torch`` from the named tree (building its
kernels there on first use), so trees with different kernel sources and
wrappers compare on one card in one run.  A turn calls the wrappers
``top2_scores_bidir`` and ``top2_scores`` on seeded random descriptors,
all valid, at each ``--shapes`` entry BxN1xN2, and records a digest of the
output tables and the launch's peak device memory.  It then takes, for
every shape and mode, a call's time by CUDA events (mean of ``--reps``
after a warm-up) and its host path (the host time to issue a call, the
card running behind); then, under torch.profiler, the device time of the
match kernels and of all kernels a call; then the first two once more,
after the profiler.  The script prints one line per turn and shape, with
the share of the bound (``chip_smoke.match_bound``), and fails if two
trees' tables differ.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

SHAPES = "64x8192x8192,4x8192x8192,1x8192x8192,2x1000x8192,3x384x512"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Device kernels of a match call that belong to the kernel source.
MATCH_KERNELS = ("match_top2_kernel", "merge_spans_kernel")


def _smoke():
    """This checkout's chip_smoke.py (bounds and timers), by path, so that
    a tree under test that has its own copy does not shadow it."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shapes(text):
    return [tuple(int(x) for x in s.split("x")) for s in text.split(",")]


def device_ms(fn, reps):
    """(match kernels, all kernels) device ms a call of ``fn``, under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    host = {e.key for e in averages
            if e.device_type == torch.autograd.DeviceType.CPU}
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key not in host and e.self_device_time_total > 0]
    mine = sum(e.self_device_time_total for e in events
               if any(k in e.key for k in MATCH_KERNELS))
    total = sum(e.self_device_time_total for e in events)
    return mine / reps / 1e3, total / reps / 1e3


def measure(root, shapes, reps, seed):
    smoke = _smoke()
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from privacy_preserving_sfm_torch.features import matching_kernels as mk

    if not torch.cuda.is_available():
        raise SystemExit("torch_match_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    calls, out = [], {}
    for b, n1, n2 in shapes:
        d1 = torch.randint(0, 256, (b, n1, 128), generator=g, device=dev,
                           dtype=torch.uint8)
        d2 = torch.randint(0, 256, (b, n2, 128), generator=g, device=dev,
                           dtype=torch.uint8)
        v1 = torch.ones(b, n1, dtype=torch.bool, device=dev)
        v2 = torch.ones(b, n2, dtype=torch.bool, device=dev)
        out[b, n1, n2] = {"shape": [b, n1, n2]}
        for mode, fn in (
                ("bidir", lambda d1=d1, d2=d2, v1=v1, v2=v2:
                 mk.top2_scores_bidir(d1, d2, v1, v2)),
                ("rows", lambda d1=d1, d2=d2, v2=v2:
                 mk.top2_scores(d1, d2, v2))):
            tables = fn()
            torch.cuda.synchronize()
            h = hashlib.sha256()
            for t in tables:
                h.update(t.cpu().numpy().tobytes())
            del tables
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            out[b, n1, n2][mode] = dict(peak_mib=peak / 2 ** 20,
                                        digest=h.hexdigest())
            calls.append(((b, n1, n2), mode, fn))
    for shape, mode, fn in calls:
        out[shape][mode].update(ms=smoke.cuda_ms(fn, reps),
                                host_ms=smoke.host_ms(fn, reps))
    for shape, mode, fn in calls:
        kernel, total = device_ms(fn, reps)
        out[shape][mode].update(kernel_ms=kernel, device_ms=total)
    for shape, mode, fn in calls:
        out[shape][mode].update(ms_after=smoke.cuda_ms(fn, reps),
                                host_ms_after=smoke.host_ms(fn, reps))
    for r in out.values():
        print(json.dumps(r), flush=True)


def drive(trees, order, shapes_text, reps, seed):
    smoke = _smoke()
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    digests = {}
    ok = True
    for turn, name in enumerate(order):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure",
             trees[name], "--shapes", shapes_text, "--reps", str(reps),
             "--seed", str(seed)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"turn {turn} {name}: failed\n{proc.stdout}{proc.stderr}",
                  flush=True)
            return 1
        for line in proc.stdout.splitlines():
            if not line.startswith("{"):
                continue
            r = json.loads(line)
            b, n1, n2 = r["shape"]
            text = []
            for mode in ("bidir", "rows"):
                m = r[mode]
                bnd, _ = smoke.match_bound(b, n1, n2, mode == "bidir")
                text.append(
                    f"{mode} {m['ms']:.4f} ms = {m['ms'] / b * 1e3:.2f} "
                    f"us/pair ({100 * bnd / m['ms']:.1f} % of the "
                    f"{bnd:.4f} ms bound), host path {m['host_ms']:.4f}, "
                    f"device: match kernels {m['kernel_ms']:.4f}, all "
                    f"{m['device_ms']:.4f}; after the profiler "
                    f"{m['ms_after']:.4f}, host path "
                    f"{m['host_ms_after']:.4f}; launch memory "
                    f"{m['peak_mib']:.1f} MiB")
                key = (b, n1, n2, mode)
                digests.setdefault(key, m["digest"])
                if digests[key] != m["digest"]:
                    ok = False
                    text.append("TABLES DIFFER")
            print(f"turn {turn} {name} B={b} N1={n1} N2={n2} (ms a call): "
                  + " | ".join(text) + f" | {card}", flush=True)
    print("tables equal across trees" if ok else "tables differ", flush=True)
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR of a source tree (repeatable)")
    ap.add_argument("--order", help="comma-separated tree names, in turns")
    ap.add_argument("--shapes", default=SHAPES)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--measure", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        measure(args.measure, _shapes(args.shapes), args.reps, args.seed)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",") if args.order else list(trees)
    return drive(trees, order, args.shapes, args.reps, args.seed)


if __name__ == "__main__":
    sys.exit(main())
