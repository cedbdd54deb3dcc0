#!/usr/bin/env python3
"""One 300-view phase of chip_smoke.py on the card, with a deadline.

    python3 tools/torch_scale300.py hier300|box300 [DEADLINE_S] [--ba300]
        [--out DIR]

Runs phase_device and phase_build, then the named phase in this process.
A watchdog thread prints a progress line every minute and, at DEADLINE_S
after the start, the state of the run (images registered, BAs by route,
the largest C, the controllers' profiles) and exits 3.  With --ba300,
phase ba300 follows at the shape of the largest BA the run logged.
Progress also goes to DIR/<phase>_progress.log (DIR: --out, by default
_out/ in the checkout), and the mapper's BA log (PPSFM_BA_LOG) to
DIR/<phase>_ba.log at the end or the deadline.
"""
import argparse
import collections
import functools
import os
import shutil
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def watchdog(which, deadline, t0, workdir, out, mappers, ctrls):
    log_path = os.path.join(out, f"{which}_progress.log")
    ba_log = os.path.join(workdir, f"{which}_ba.log")

    def state():
        reg = max((m.rec.num_registered() for m in list(mappers)
                   if m.rec is not None), default=0)
        try:
            routes, largest, widest = cs.ba_log_summary(ba_log)
        except (OSError, RuntimeError):  # nothing logged yet
            routes, largest, widest = [], None, None
        prof = [", ".join(f"{k} {v:.1f}" for k, v in sorted(
            c.profiler.totals.items(), key=lambda kv: -kv[1])[:14])
            for c in list(ctrls)]
        return (f"[{which} progress] {time.perf_counter() - t0:.0f} s: "
                f"registered {reg} (this process), BAs "
                f"{dict(collections.Counter(routes))}, (C, P, K, nobs) of "
                f"the most cameras {widest}, of the most observations "
                f"{largest}; profiles {prof}")

    def keep_log():
        if os.path.exists(ba_log):
            shutil.copy(ba_log, os.path.join(out, f"{which}_ba.log"))

    def say(text):
        sys.__stdout__.write(text + "\n")
        sys.__stdout__.flush()
        with open(log_path, "a") as f:
            f.write(text + "\n")

    while True:
        left = deadline - (time.perf_counter() - t0)
        if left <= 0:
            say(state())
            keep_log()
            say(f"[{which}] deadline of {deadline:.0f} s reached: stopped")
            os._exit(3)
        time.sleep(min(60.0, left))
        if time.perf_counter() - t0 < deadline:
            say(state())


def main():
    import torch

    from privacy_preserving_sfm_torch.sfm.controller import (
        IncrementalMapperController,
    )
    from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
        IncrementalMapper,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("which", choices=["hier300", "box300"])
    ap.add_argument("deadline", type=float, nargs="?", default=3300.0)
    ap.add_argument("--ba300", action="store_true")
    ap.add_argument("--out", default=os.path.join(REPO, "_out"))
    args = ap.parse_args()
    which, deadline, out = args.which, args.deadline, args.out
    t0 = time.perf_counter()
    os.makedirs(out, exist_ok=True)
    mappers, ctrls = [], []
    begin, init = (IncrementalMapper.begin_reconstruction,
                   IncrementalMapperController.__init__)

    def begin_kept(self, rec):
        mappers.append(self)
        return begin(self, rec)

    def init_kept(self, *a, **kw):
        ctrls.append(self)
        return init(self, *a, **kw)

    IncrementalMapper.begin_reconstruction = begin_kept
    IncrementalMapperController.__init__ = init_kept
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    workdir = tempfile.mkdtemp(prefix=f"{which}_")
    threading.Thread(target=watchdog, daemon=True, args=(
        which, deadline, t0, workdir, out, mappers, ctrls)).start()
    card = cs.phase_device()
    cs.timed("build", cs.phase_build)
    if which == "hier300":
        cs.timed("hier300", cs.phase_hier300, device, card, workdir)
    else:
        cs.timed("box300", functools.partial(
            cs.phase_scene, name="box300", scene=cs.BOX300,
            camera="SIMPLE_PINHOLE", bar=cs.BOX300_BAR,
            targets=cs.BOX300_TARGETS, matcher="sequential",
            overlap=cs.SEQUENTIAL_OVERLAP,
            require=("schur_gram", "schur_pcg", "schur_pcg_grid",
                     "match_top2")), device, card, workdir)
    shutil.copy(os.path.join(workdir, f"{which}_ba.log"),
                os.path.join(out, f"{which}_ba.log"))
    if args.ba300:
        _, largest, _ = cs.ba_log_summary(
            os.path.join(workdir, f"{which}_ba.log"))
        cs.BA300 = largest
        cs.phase(which, f"phase ba300 at the run's largest BA {largest}")
        with tempfile.TemporaryDirectory() as ba_dir:
            cs.timed("ba300", cs.phase_ba300, device, card, ba_dir)
    cs.phase(which, f"script done in {time.perf_counter() - t0:.1f} s")
    print(cs.card_line())


if __name__ == "__main__":
    try:
        main()
    except Exception:
        import traceback
        traceback.print_exc()
        print("scale300: FAILED", flush=True)
        sys.stdout.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)
