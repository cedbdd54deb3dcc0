#!/usr/bin/env python3
"""Time the port's PCG kernel and BA solves of several source trees in turns.

    python3 tools/torch_pcg_ab.py --tree parent=DIR --tree change=. \\
        --order parent,change,change,parent [--ba] [--ba1280] [--bins]

Each turn runs this script's ``--measure`` mode in a fresh process that
imports ``privacy_preserving_sfm_torch`` from the named tree (building its
kernels there on first use), so trees with different kernel sources and
wrappers compare on one card in one run.  A turn times, by CUDA events
(mean of ``--reps`` after a warm-up), one PCG solve of ``--iters`` steps on
the reduced camera system of each ``--cams`` entry C (the Gram of random
blocks of 6 distinct cameras a point, 20,000 points, as ``chip_smoke.py``
builds it), float32: through ``schur_pcg.pcg_schur`` where the tree has it
(its "auto" path), else through ``schur_pcg.pcg`` on the dense system
identity-padded to ``padded_dim(C)``, which that tree's solvers built
before every call (the build is timed apart).  With ``--ba``, a turn also
solves the BA-100 model (100 cameras, 20,000 points, 120,000 observations,
float32, 20 LM iterations of 30 CG steps at most) on the SoA and dense
explicit routes in turns, ``--ba-runs`` times each, and reports ms per LM
iteration (host clock, synced) and the iteration counts; with
``--ba1280``, the 1,280-camera model (600,000 observations) on the dense
implicit route, twice, with its solve seconds and, under torch.profiler,
the device time inside ``ba_dense.cg``; with ``--bins``, the camera-bin
sum alone at ``BIN_SHAPES`` (``_bins_times``).  The script prints one line
per turn and measurement, each with the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMS = "100,320,640"
# (observations, cameras, block shape) of the camera-bin sums: BA-100's
# Hcc and gc blocks, BA-1280's implicit CG step (cam_side).
BIN_SHAPES = ((120000, 100, (6, 6)), (120000, 100, (6,)),
              (600000, 1280, (6,)))


def _smoke():
    """This checkout's chip_smoke.py (timers, inputs, bounds), by path, so
    that a tree under test that has its own copy does not shadow it."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pcg_times(smoke, dev, cams, iters, reps):
    import torch

    from privacy_preserving_sfm_torch.optim import schur_pcg as sp

    out = []
    for C in cams:
        S_corr, dHcc, minv, rhs = (
            a.float() for a in smoke.pcg_system(C, dev, seed=C))
        if hasattr(sp, "pcg_schur"):
            def call():
                return sp.pcg_schur(S_corr, dHcc, minv, rhs, iters)
            build_ms = 0.0
        else:  # the dense contract: S and Minv padded, built per LM step
            n, n_pad = 6 * C, sp.padded_dim(C)

            def dense():
                S = sp.embed_block_diag(dHcc, n_pad)
                S[:n, :n] -= S_corr
                return (S, sp.embed_block_diag(minv, n_pad),
                        torch.cat([rhs, rhs.new_zeros(n_pad - n)]))

            S, M, r = dense()

            def call():
                return sp.pcg(S, M, r, iters)[:n]
            build_ms = smoke.cuda_ms(dense, reps)
        x = call()
        torch.cuda.synchronize()
        out.append(dict(kind="pcg", C=C, n=6 * C, ms=smoke.cuda_ms(call,
                                                                    reps),
                        build_ms=build_ms, x_norm=float(x.double().norm())))
    return out


def _bins_times(smoke, dev, reps):
    """The camera-bin sum at BIN_SHAPES, float32, uniform camera ids: the
    tree's ``ba._bins`` (``index_add_`` where the tree has no ``bin_plan``)
    and, where it has one, the fixed-order candidate it did not take, a
    camera-major padded gather (a zero row in the padding) summed over its
    slots; each with whether two calls are bit-equal."""
    import torch

    from privacy_preserving_sfm_torch.optim import ba

    out = []
    for N, C, shape in BIN_SHAPES:
        g = torch.Generator(device=dev).manual_seed(C)
        idx = torch.randint(0, C, (N,), generator=g, device=dev)
        v = torch.randn((N,) + shape, generator=g, device=dev)
        calls = {}
        if hasattr(ba, "bin_plan"):
            plan = ba.bin_plan(C, idx)
            calls["bins"] = lambda: ba._bins(plan, v)
            counts = plan.offsets.diff()
            slot = torch.arange(N, device=dev) - torch.repeat_interleave(
                plan.offsets[:-1], counts)
            table = torch.full((C, int(counts.max())), N, device=dev)
            table[idx[plan.order], slot] = plan.order
            zero = v.new_zeros((1,) + shape)
            calls["padded"] = lambda: torch.cat([v, zero])[table].sum(1)
        else:
            calls["bins"] = lambda: ba._bins(C, idx, v)
        for method, call in calls.items():
            out.append(dict(kind="bins", method=method, N=N, C=C,
                            shape=list(shape), ms=smoke.cuda_ms(call, reps),
                            stable=bool(torch.equal(call(), call()))))
    return out


def _assembled(dev, num_images, num_points, seed):
    import torch

    from privacy_preserving_sfm_torch.optim import ba_dense
    from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
        IncrementalMapper,
    )
    from privacy_preserving_sfm_torch.utils.synthetic import synthetic_model

    rec = synthetic_model(num_images, num_points, 6, seed=seed,
                          meas_noise=2e-4)
    rec.filter_observations_with_negative_depth()
    mapper = IncrementalMapper(dev, torch.float32)
    mapper.begin_reconstruction(rec)
    reg = rec.reg_image_ids
    asm = mapper.assemble_ba(reg, {reg[0]}, {reg[1]})
    return ba_dense.from_flat_problem(asm.problem), asm.camera_model


def _solve(route, dense, model, max_iterations):
    import torch

    from privacy_preserving_sfm_torch.optim import ba as ba_mod
    from privacy_preserving_sfm_torch.optim import ba_dense, ba_soa

    opts = ba_mod.BAOptions(max_iterations=max_iterations,
                            schur_mode="explicit" if route == "soa"
                            else route)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if route == "soa":
        *_, s = ba_soa.bundle_adjust_soa(dense, model, opts)
    else:
        *_, s = ba_dense.bundle_adjust_dense(dense, model, opts)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, s


def _ba_times(dev, runs):
    dense, model = _assembled(dev, 100, 20000, 0)
    _solve("soa", dense, model, 3)  # the process's one-time set-up
    out = []
    for _ in range(runs):
        for route in ("soa", "explicit"):
            sec, s = _solve(route, dense, model, 20)
            out.append(dict(kind="ba100", route=route, s=sec,
                            iters=s.num_iterations,
                            ms_per_iter=sec / s.num_iterations * 1e3,
                            final_cost=s.final_cost))
    return out


def _cg_device_ms(run):
    """Device ms of the kernels inside the ``ba_dense.cg`` spans of run(),
    all device ms, under torch.profiler, and what run() returns."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    inside = sum(e.device_time_total for e in prof.events()
                 if e.name == "ba_dense.cg" and e.device_type == cpu)
    averages = prof.key_averages()
    host = {e.key for e in averages if e.device_type == cpu}
    total = sum(e.self_device_time_total for e in averages
                if e.device_type == cuda and e.key not in host)
    return inside / 1e3, total / 1e3, out


def _ba1280_times(dev):
    dense, model = _assembled(dev, 1280, 100000, 3)
    _solve("implicit", dense, model, 2)
    out = []
    for _ in range(2):
        sec, s = _solve("implicit", dense, model, 100)
        out.append(dict(kind="ba1280", s=sec, iters=s.num_iterations,
                        final_cost=s.final_cost))
    cg_ms, device_ms, (_, s) = _cg_device_ms(
        lambda: _solve("implicit", dense, model, 100))
    out.append(dict(kind="ba1280_profile", cg_ms=cg_ms, device_ms=device_ms,
                    iters=s.num_iterations))
    return out


def measure(root, cams, iters, reps, ba, ba_runs, ba1280, bins):
    smoke = _smoke()
    sys.path.insert(0, os.path.abspath(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_pcg_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    results = _pcg_times(smoke, dev, cams, iters, reps)
    if ba:
        results += _ba_times(dev, ba_runs)
    if ba1280:
        results += _ba1280_times(dev)
    if bins:
        results += _bins_times(smoke, dev, reps)
    for r in results:
        print(json.dumps(r), flush=True)


def _text(r):
    if r["kind"] == "pcg":
        build = (f", dense S and Minv built per call {r['build_ms']:.4f} ms"
                 if r["build_ms"] else "")
        return (f"PCG C={r['C']} n={r['n']} float32: {r['ms']:.4f} ms a "
                f"solve{build} (|x| {r['x_norm']:.6g})")
    if r["kind"] == "ba100":
        return (f"BA-100 {r['route']}: {r['iters']} LM iterations in "
                f"{r['s']:.4f} s = {r['ms_per_iter']:.3f} ms an iteration, "
                f"final cost {r['final_cost']!r}")
    if r["kind"] == "bins":
        return (f"camera bins {r['method']} N={r['N']} C={r['C']} "
                f"{tuple(r['shape'])}: {r['ms']:.4f} ms, two calls "
                f"bit-equal={r['stable']}")
    if r["kind"] == "ba1280":
        return (f"BA-1280 implicit: {r['iters']} LM iterations, solve "
                f"{r['s']:.4f} s, final cost {r['final_cost']!r}")
    return (f"BA-1280 under torch.profiler: device time inside ba_dense.cg "
            f"{r['cg_ms']:.3f} ms of {r['device_ms']:.3f} ms in "
            f"{r['iters']} LM iterations ({r['cg_ms'] / r['iters']:.3f} ms "
            f"an iteration)")


def drive(trees, order, args):
    smoke = _smoke()
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    for turn, name in enumerate(order):
        cmd = [sys.executable, os.path.abspath(__file__), "--measure",
               trees[name], "--cams", args.cams, "--iters", str(args.iters),
               "--reps", str(args.reps), "--ba-runs", str(args.ba_runs)]
        cmd += ["--ba"] if args.ba else []
        cmd += ["--ba1280"] if args.ba1280 else []
        cmd += ["--bins"] if args.bins else []
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"turn {turn} {name}: failed\n{proc.stdout}{proc.stderr}",
                  flush=True)
            return 1
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(f"turn {turn} {name}: {_text(json.loads(line))} | "
                      f"{card}", flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR of a source tree (repeatable)")
    ap.add_argument("--order", help="comma-separated tree names, in turns")
    ap.add_argument("--cams", default=CAMS)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ba", action="store_true")
    ap.add_argument("--ba-runs", type=int, default=2)
    ap.add_argument("--ba1280", action="store_true")
    ap.add_argument("--bins", action="store_true")
    ap.add_argument("--measure", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cams = [int(c) for c in args.cams.split(",")]
    if args.measure:
        measure(args.measure, cams, args.iters, args.reps, args.ba,
                args.ba_runs, args.ba1280, args.bins)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",") if args.order else list(trees)
    return drive(trees, order, args)


if __name__ == "__main__":
    sys.exit(main())
