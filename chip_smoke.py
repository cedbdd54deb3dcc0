#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, checks
each against its plain PyTorch version on the card (the PCG on both of
its paths, cluster and grid, after measuring one grid sync and one
cluster barrier), then drives the port's paths through its CLI:
``bundle_adjuster`` on a seeded synthetic model at the line-BA
benchmark's size (100 cameras, 20,000 points, 120,000 observations), on
the SoA solver (phase ``main``) and on the dense-block explicit-Schur
solver (``PPSFM_BA_PATH=dense``, phase ``dense_explicit``), each solved
twice with bit-equal output models and LM iteration counts required;
``bundle_adjuster`` with no override on a 1,280-camera
global BA (100,000 points, 600,000 observations), which the mapper sends
to the dense-block implicit solver (phase ``dense_implicit``);
``bundle_adjuster`` on a seeded model at ``BA300``, the shape of the
largest global BA the mapper ran at the reference's 300-view scale (phase
``ba300``: the SoA route with the PCG on its grid path, two solves
bit-equal, every Gram and PCG call of the solve held against its plain
version in float32 and float64 as in phase ``mapper``); the same at
``BA1000``, 1,000 cameras and 1.2 M observations, the reference's 512 <
C <= 1024 regime (phase ``ba1000``, whose plain Gram sums V a chunk of
points at a time); and ``exhaustive_matcher`` on a seeded synthetic
database of 64 images x 8,192 descriptors (the reference's default
feature cap; 2,016 pairs), checked against the generator's true
correspondences, against the plain version on 16 pairs and against the
bounded-memory block mode, then once more under torch.profiler; the
front end (phase ``sift``: SIFT and the line
lift at ``bench.py``'s shape, its split by span, the card against the CPU
and against itself, repeatability and inlier rate on rendered plane pairs
against bars from the reference package, one image at the default cap);
and ``feature_extractor`` with its defaults on 16 rendered 1,600 x 1,200
box images, in a fresh process with torch's default flags and again in
this one (byte-identical rows required), then ``exhaustive_matcher`` on
its database (phase ``extractor``); and ``line_initializer`` on that
database (phase ``line_init``): twice on the card (byte-identical models,
4 images, at least ``MIN_INIT_POINTS`` points, poses within
``LINE_INIT_BAR`` of the rendering's truth), once on the CPU (the same
images, within the bar) and once under torch.profiler; ``mapper`` on that
database (phase ``mapper``, cell Mapper-1600): on the card (one model,
all 16 images, poses within ``MAPPER_BAR``, ``schur_gram`` and
``schur_pcg`` launched, and the run's largest local and global BA
solved again with the kernels and with the plain versions, every Gram
and PCG call of the solve checked against its plain version on the same
inputs); and
``hierarchical_mapper --block_size 8 --overlap 3`` on that database
(phase ``hier``, cell Hier-1600): with one worker and with two spawned
workers on the card (byte-identical models, every block's snapshot from
the card, all 16 images within ``HIER_BAR``, ``schur_gram`` and
``schur_pcg`` launched); ``automatic_reconstructor`` in a fresh process on
12 freshly rendered 640 x 480 box images (phase ``auto``: all registered
in one model within ``AUTO_BAR``, ``match_top2`` launched); the
reference's box50d (phase ``box50d``, cell Box50d): 50 box views at
640 x 480 through the OPENCV camera with the reference's photometric
degradation, rendered here from the seed by the port's
``tools/synth_dataset``, through ``automatic_reconstructor`` in this
process (one model, 50 of 50, ATE RMSE and mean rotation error by the
port's ``tools/evaluate`` within ``BOX50D_BAR``, every BA on the SoA
route, ``schur_gram``, ``schur_pcg`` and ``match_top2`` launched, and
the run's largest local and global BA held against the plain route as
in phase ``mapper``); and the
uncalibrated path (phase ``uncal``, cell Uncal-1600): 12 box images at
1,600 x 1,200 rendered with a focal 12 % under the extractor's heuristic
and no calibration sidecar, extracted and matched on the card, then the
controller with ``ba_refine_focal_length`` (one model, every image
within ``UNCAL_BAR``, every focal within ``UNCAL_FOCAL_BAR`` of the
truth, every BA on the intrinsics route, no Schur kernel launched, the
largest intrinsics BA solved again in float32, bit-equal, and held
against float64), and one focal search at the model's size on the card against
the CPU; ``model_viewer --html`` on phase ``mapper``'s model in a fresh
process (phase ``viewer``: the embedded payload decodes to the model's
points and registered images; a PNG is written where matplotlib is
installed and refused with an error naming it elsewhere); and the
sharded paths of ``parallel/`` in ranks spawned from this script on
cuda:0 (phase ``parallel``): BA-100 point-sharded in a one-rank NCCL
world (bit-equal to ``ba.bundle_adjust`` on the card) and in a two-rank
gloo world sharing the card (the same cameras and summary on both ranks,
bit-equal run to run, cost within 1e-3 of ``ba.bundle_adjust`` and of a
float64 run), with the wall, the LM iterations and the all-reduces'
count and share; then the Matcher cell's 2,016 pairs split over the two
ranks, ``match_top2.cu`` launched on each, the gathered result equal to
the unsharded match in every field.  With ``PPSFM_SMOKE_PROFILE=1``,
phase ``mapper`` runs a second time and phase ``uncal`` runs its
controller a second time, each under torch.profiler split by span
(byte-identical models required), and phase ``hier``'s one-worker run
goes under it too.  A spawned child process makes and writes the seeded
models of phases ``ba300``, ``ba1000`` and ``dense_implicit`` beside
phases ``matcher``, ``parallel`` and ``sift`` (no kernel timing of the
kernels line runs beside it), and has ended before ``ba300``, which runs
after ``sift``.  Prints one line
per phase and each phase's
seconds, then a JSON line with each kernel's launches, error, times and
bound (the larger of its operations at the H100's peak for their type and
its bytes at the memory rate), the card's name and power limit, and as
its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Any failed phase
exits non-zero without that line; so does a machine without a CUDA
device, or a directory without the ``privacy_preserving_sfm_torch``
package.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

# (K, P, C) for the Gram checks: the main path's shape first, then the
# shapes of the reference's three regimes (C <= 512 with K = 16, a
# K = 128 global, and the 512 < C <= 1024 blocked regime).
GRAM_SHAPES = [(6, 20000, 100), (16, 20000, 100), (128, 8192, 320),
               (8, 16384, 640)]
# (K, P, C) for the AoS Gram checks: the dense explicit path's shape,
# the TPU kernel's K and C ceilings; then a ragged problem (tracks of
# 2..RAGGED[0] slots, padding slots at camera -1).
GRAM_AOS_SHAPES = [(6, 20000, 100), (16, 20000, 100), (8, 16384, 256)]
RAGGED = (32, 20000, 100)
# The Gram's kernels by name (schur_gram.cu: compaction, strips, reduction).
GRAM_KERNEL = r"gram_(compact|strip|reduce)_kernel"
PCG_KERNEL = r"pcg_(cluster|grid)_kernel"
# C for the PCG checks: a local BA (16), BA-100 (reported in the kernels
# line), the Gram's regimes, BA1000's C (n = 6,000, no multiple of 128:
# held here in float32 at 1e-4 on a well-posed system, where phase
# ba1000's float32 calls are held only within plain float32's own error)
# and the explicit ceiling (n = 6,144); at the
# C of PCG_BOTH, both of the kernel's paths are checked and timed (the
# cluster path where it fits), to place the crossover between them.
PCG_CAMS = [16, 100, 320, 640, 1000, 1024]
PCG_BOTH = [16, 50, 100, 109, 155]
PCG_MAIN = 100
CG_ITERS = 30
MAIN = dict(num_images=100, num_points=20000, obs_per_point=6,
            meas_noise=2e-4)
LM_ITERS = 20
# A global BA past the explicit-Schur ceiling of 1,024 cameras, the size
# of a 1DSfM collection (Madrid Metropolis: 1,344 images); the CLI's
# default cap of 100 LM iterations.
IMPLICIT = dict(num_images=1280, num_points=100000, obs_per_point=6,
                meas_noise=2e-4)
# (B, N1, N2, kind) for the match kernel checks: the production shape
# (the reference's max_num_features = 8192), padding with duplicates and
# ties ("ties"), an N1 that is not a multiple of 128; the exhaustive
# matcher's launch (its chunk of 64 pairs), one pair (match_descriptors),
# all-255 descriptors at the top of the dot range ("top"), and an N2 that
# is not a multiple of 128.
MATCH_SHAPES = [(4, 8192, 8192, None), (3, 384, 512, "ties"),
                (2, 1000, 8192, None), (64, 8192, 8192, None),
                (1, 8192, 8192, None), (2, 8192, 8192, "top"),
                (4, 8192, 8100, None)]
# The match kernel's main-path shape, reported in the kernels line.
MATCH_MAIN = (64, 8192, 8192)
# The plain version holds the (B, N1, N2) float32 dots and copies of them:
# it runs on at most this many pairs a call.
PLAIN_PAIRS = 4
# Published H100 SXM peaks (NVIDIA data sheet, dense): the least time of a
# kernel's work is the larger of its operations at the peak of their type
# and its bytes (each input read once, each output written once) at the
# memory rate.
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12    # outside the tensor cores
PEAK_F64 = 67e12    # on the tensor cores (34e12 outside them)
HBM_BYTES_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
MATCHER = dict(num_images=64, num_features=8192)
# Thresholds of the matcher phase against the generator's truth, set from
# the first run on an H100 (precision 1.00000, recall 0.97531).
MIN_PRECISION, MIN_RECALL = 0.99, 0.95
# The front end: bench.py:129-147's throughput shape (B, H, W); the size
# the CLI's default cap (--max_image_size 3200) allows; the extractor run,
# (images, (H, W)) of 1DSfM-like photo sizes (1,600 x 1,200).
SIFT_BENCH = (8, 480, 640)
SIFT_CAP = (2400, 3200)
EXTRACTOR = (16, (1200, 1600))
# tools/frontend_eval.py's pairs (index gap 2), pixel tolerance and
# feature cap (4,096), and the bars on repeatability and match inlier
# rate: 0.02 below the reference package's 0.62052 and 0.78430 (692.0
# matches a pair; both selections alike) on the same rendered images
# (render_dataset(..., 7, 640, 480, seed=0, scene="plane")), measured with
# tools/frontend_eval.py on a CPU.
SIFT_PAIRS = [("img000.png", "img002.png"), ("img002.png", "img004.png"),
              ("img004.png", "img006.png")]
SIFT_TOL = 3.0
MIN_REPEATABILITY, MIN_INLIER_RATE = 0.60, 0.76
# The line lift on the card against the CPU's (generators of one seed):
# the least share of matched keypoints (0.01 px) whose aligned flags
# agree, and the largest distance of their lines.
LIFT_BAR = (0.98, 1e-5)
# line_initializer on the extractor's database: the least number of
# triangulated points, and the bar on the 4 poses against the rendering's
# truth up to gauge (rotation, translation direction; degrees): twice the
# reference CLI's errors on a database the port's CLI wrote from the same
# rendering (tests/torch_init_bar.py, on a CPU), floored at 0.25 and 1.
MIN_INIT_POINTS = 100
LINE_INIT_BAR = (0.25, 1.0)
# mapper on the extractor's database (cell Mapper-1600) and
# automatic_reconstructor on AUTO = (images, (H, W), render seed): every
# image registered in one model, the poses within the bar against the
# rendering's truth up to gauge (rotation, translation direction; degrees,
# the largest over the cameras relative to the first): twice the reference
# CLI's errors on the same renderings, floored at 0.25 and 1
# (tests/torch_mapper_bar.py on a CPU: the reference mapper on a
# CPU-written database of the Mapper-1600 rendering, 16 of 16 images,
# 0.02924 and 0.14298 deg; the reference automatic_reconstructor on AUTO's
# rendering, 12 of 12, 0.06069 and 0.22236 deg).
MAPPER_BAR = (0.25, 1.0)
# The mapper's largest local and global BA solved again on the card with
# the kernels and with the plain versions: every free camera within this
# (rotation, degrees; centre, relative to the cameras' mean distance from
# the problem's first camera) of the float64 plain solve, a 25th of
# MAPPER_BAR's rotation (0.01 deg = 1.75e-4 rad, the same for the
# centre), a third of the mapper's measured pose error.
MAPPER_BA_TOL = (0.01, 1.75e-4)
AUTO = (12, (480, 640), 1)
AUTO_BAR = (0.25, 1.0)
# The reference's own accuracy scene (cell Box50d): BOX50D = (views,
# (H, W), render seed, degrade level) of tools/synth_dataset.py's box
# scene through its OPENCV camera (barrel and tangential distortion) and
# its photometric degradation at level 1.0 ("a plausible consumer camera"),
# rendered on this machine by the port's tools/synth_dataset, run through
# automatic_reconstructor and scored by the port's tools/evaluate
# (similarity alignment, ATE RMSE, mean rotation error).
# BOX50D_BAR = (ATE RMSE, mean rotation error in degrees): twice the
# reference CLI's on the same rendering, floored at 0.005 and 0.25 deg
# (tests/torch_mapper_bar.py box50d on a CPU: 50 of 50 images, 8,101
# points, ATE RMSE 0.002120, mean rotation error 0.06904 deg).
# BOX50D_TARGETS: the reference's round-5 run of box50d on a TPU
# (reports/eval_box50d_tpu_r5_0.json), accuracy targets from another
# platform, printed beside the card's numbers.
BOX50D = (50, (480, 640), 0, 1.0)
BOX50D_BAR = (max(2 * 0.002120000578489829, 0.005),
              max(2 * 0.06904010978004925, 0.25))
BOX50D_TARGETS = dict(registered=50, ate_rmse=0.0020, mean_rot_deg=0.060)
# The reference's 300-view scale (cells Box300 and Hier300): BOX300 =
# tools/synth_dataset.py's "OUT 300 box" (SIMPLE_PINHOLE, f 400, no
# degradation, seed 0), matched sequentially with overlap 10 (pairs of
# images up to 10 apart in name order) as the reference's runs were.
# Box300 is automatic_reconstructor --matcher sequential --overlap 10;
# its bar (ATE RMSE, mean rotation error in degrees) is twice the
# reference's accuracy on another platform (reports/eval_box300_tpu_r5_0
# .json: 300 of 300, 0.002413, 0.04484 deg), floored at 0.005 and 0.25.
# Hier300 is hierarchical_mapper with HIER300 = (block size, overlap,
# workers) on a database of the same rendering made by feature_extractor
# and sequential_matcher; its bar is twice the reference's CPU run
# (reports/eval_hier300_cpu_r4.json: 300 of 300, 0.002629, 0.05462 deg),
# floored the same way.  Neither fits this script's time limit: each runs
# from a script of its own (README).
BOX300 = (300, (480, 640), 0, 0.0)
SEQUENTIAL_OVERLAP = 10
BOX300_TARGETS = dict(registered=300, ate_rmse=0.0024131254331015,
                      mean_rot_deg=0.044840981009035726)
BOX300_BAR = (max(2 * BOX300_TARGETS["ate_rmse"], 0.005),
              max(2 * BOX300_TARGETS["mean_rot_deg"], 0.25))
HIER300 = (80, 8, 4)
HIER300_TARGETS = dict(registered=300, ate_rmse=0.0026287585555720572,
                       mean_rot_deg=0.054622698922911016)
HIER300_BAR = (max(2 * HIER300_TARGETS["ate_rmse"], 0.005),
               max(2 * HIER300_TARGETS["mean_rot_deg"], 0.25))
# Phase ba300: bundle_adjuster on a seeded model at BA300 = (cameras,
# points, longest track, observations), the largest global BA of the
# port's mapper at that scale, where the PCG takes its grid path (C >
# 155): Box300's last global BA as its PPSFM_BA_LOG measured it on an H100
# (tools/torch_scale300.py box300).
BA300 = (300, 13409, 128, 755822)
# Phase ba1000: bundle_adjuster on a model of MAIN's generator at the
# reference's C = 1,000 crossover row (reports/ba_crossover_r5.json: C
# 1000, P 200,000, 1,200,000 observations), the regime 512 < C <= 1024 of
# its route table (the SoA solver with the blocked Gram, gram_soa_blocked)
# that no other phase runs inside the LM loop; the size of a 1DSfM
# collection such as Vienna Cathedral (836 images).
BA1000 = dict(num_images=1000, num_points=200000, obs_per_point=6,
              meas_noise=2e-4)
# hierarchical_mapper on the extractor's database (cell Hier-1600) with
# HIER = (block size, overlap): 3 blocks of 8, 8 and 6 images.  Its bar is
# MAPPER_BAR's kind: twice the reference CLI's errors on a CPU-written
# database of the same rendering, floored at 0.25 and 1 deg
# (tests/torch_mapper_bar.py hier: 16 of 16 images in one model, 6,137
# points, 0.02973 and 0.11863 deg).
HIER = (8, 3)
HIER_BAR = (0.25, 1.0)
# PPSFM_SMOKE_PROFILE=1 runs phase mapper's and phase uncal's second run
# and phase hier's one-worker run under torch.profiler, split by span
# (``span_split``): about 7 minutes more (the three runs launch ~0.9, ~2
# and ~0.9 M kernels; stopping the profiler and reading its events take
# most of it).
PROFILE = os.environ.get("PPSFM_SMOKE_PROFILE") == "1"
# The uncalibrated path (cell Uncal-1600): UNCAL = (images, (H, W), render
# seed) box images rendered with the true focal UNCAL_FOCAL, 1,920 / 1.12 =
# 1,714.3 px, so that the heuristic 1.2 x 1,600 = 1,920 is 12 % high (the
# ratio of tests/test_e2e_synthetic.py's TestUncalibrated, 560 against
# 500).  The reference controller with ba_refine_focal_length on a
# CPU-written database of the same rendering (tests/torch_mapper_bar.py
# uncal): 12 of 12 images in one model, 5,718 points, 0.01375 and 0.03578
# deg, focal 1,713.95 (relative error 0.00020).  Bars: at least its image
# count; twice its pose errors, floored at 0.25 and 1 deg; twice its focal
# error, floored at 3 % (TestUncalibrated's 15 / 500).
UNCAL = (12, (1200, 1600), 2)
UNCAL_FOCAL = 1714.3
UNCAL_MIN_IMAGES = 12
UNCAL_BAR = (0.25, 1.0)
UNCAL_FOCAL_BAR = 0.03


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` on the card, by CUDA events, after
    one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, then a line with the phase's seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    phase(name, f"phase done in {time.perf_counter() - t0:.1f} s")
    return out


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def phase_device():
    import torch

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on")
    phase("device", f"{torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda} | python "
          f"{sys.version.split()[0]} | TF32 off")
    return card


def kernel_name(mangled):
    """The ``*_kernel`` identifier inside a mangled name (each identifier
    there follows its length), or the mangled name."""
    for m in re.finditer(r"(?=(\d+))", mangled):
        end = m.start() + len(m.group(1))
        word = mangled[end:end + int(m.group(1))]
        if word.endswith("_kernel"):
            return word
    return mangled


def phase_build():
    from privacy_preserving_sfm_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    dt = time.perf_counter() - t0
    phase("build", f"kernels built and loaded in {dt:.2f} s "
          f"({', '.join(build.SOURCES)})")
    # ptxas reports each entry function, then its spills and registers.
    name, spills = "?", ""
    with open(os.path.join(build.BUILD_DIR, "build.log")) as f:
        for ln in f:
            entry = re.search(r"Compiling entry function '(\w+)'", ln)
            if entry:
                name = kernel_name(entry.group(1))
            elif "spill" in ln:
                spills = ln.strip()
            elif "registers" in ln:
                regs = re.search(r"Used (\d+) registers", ln)
                phase("build", f"{name}: {regs.group(1) if regs else '?'} "
                      f"registers, {spills}")


def gram_inputs(K, P, C, dtype, device, seed):
    """Random Gram inputs; every point sees K distinct cameras."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    lh = torch.randn(18 * K, P, generator=g, device=device, dtype=dtype)
    gl = torch.randn(3, P, generator=g, device=device, dtype=dtype)
    cam = torch.rand(P, C, generator=g, device=device).argsort(dim=1)
    return lh, gl, cam[:, :K].T.contiguous().to(torch.int32)


def useful_gflop(plan):
    """GFLOP of the work one Gram needs, S being symmetric: for each point
    of m distinct cameras, 108 FMAs for each of its m (m - 1) / 2 upper
    camera pairs, 63 for the i1 <= i2 half of each diagonal block and 18
    for each camera's rhs term; two flops an FMA."""
    m = plan.count.double()
    return 2.0 * float((54.0 * m * (m - 1) + 81.0 * m).sum()) / 1e9


def gram_times(gram, plan_of, a, b, cam, C, reps, precision="f32"):
    """Times (CUDA events, ms) of one Gram: the launch alone with the plan
    prebuilt, the plan build, the wrapper with a plan per call; and the
    plan."""
    plan = plan_of(cam, C)
    ms = cuda_ms(lambda: gram(a, b, cam, C, precision, plan=plan), reps)
    plan_ms = cuda_ms(lambda: plan_of(cam, C), reps)
    call_ms = cuda_ms(lambda: gram(a, b, cam, C, precision), reps)
    return ms, plan_ms, call_ms, plan


def gram_bound(K, P, C, plan, itemsize):
    """bound_ms and bound_by of one Gram: its useful flops at the float32
    (or float64) peak, against lh, gL, the camera ids, S and rhs once
    each."""
    peak = PEAK_F32 if itemsize == 4 else PEAK_F64
    nbytes = (18 * K * P + 3 * P + (6 * C) ** 2 + 6 * C) * itemsize + 4 * K * P
    bound_ms, bound_by = bound(useful_gflop(plan) * 1e9, peak, nbytes)
    return dict(bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def times_text(ms, plan_ms, call_ms, plain_ms, plan, bnd):
    return (f"kernel {ms:.4f} ms (launch alone, plan prebuilt; "
            f"{useful_gflop(plan) / ms * 1e3:.1f} useful GFLOP/s; bound "
            f"{bnd['bound_ms']:.4f} ms, {bnd['bound_by']}), plan "
            f"build {plan_ms:.4f} ms, plan per call {call_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")


def phase_gram(device, card, reps=5):
    """Gram kernel vs gram_soa_plain; returns the main-path shape's
    stats."""
    import torch

    from privacy_preserving_sfm_torch.optim import schur_pcg

    def plan_of(cam, C):
        return schur_pcg.gram_plan(cam, C, "soa")

    main_stats = None
    for K, P, C in GRAM_SHAPES:
        lh, gl, cam = gram_inputs(K, P, C, torch.float64, device, seed=C + K)
        S_ref, r_ref = schur_pcg.gram_soa_plain(lh, gl, cam, C)
        s_scale = float(S_ref.abs().max())
        r_scale = float(r_ref.abs().max())
        for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
            a, b = lh.to(dtype), gl.to(dtype)
            plan = plan_of(cam, C)
            S, r = schur_pcg.gram_soa(a, b, cam, C, plan=plan)
            S2, r2 = schur_pcg.gram_soa(a, b, cam, C)
            torch.cuda.synchronize()
            err_s = float((S.double() - S_ref).abs().max())
            err_r = float((r.double() - r_ref).abs().max())
            asym = float((S - S.T).abs().max())
            bit_equal = torch.equal(S, S2) and torch.equal(r, r2)
            ms, plan_ms, call_ms, plan = gram_times(
                schur_pcg.gram_soa, plan_of, a, b, cam, C, reps)
            plain_ms = cuda_ms(
                lambda: schur_pcg.gram_soa_plain(a, b, cam, C), reps)
            bnd = gram_bound(K, P, C, plan, a.element_size())
            name = str(dtype).replace("torch.", "")
            phase("gram", f"K={K} P={P} C={C} {name}: max|dS|={err_s:.3e} "
                  f"(tol {tol * s_scale:.3e}) max|drhs|={err_r:.3e} "
                  f"(tol {tol * r_scale:.3e}) max|S-S^T|={asym:.3e} "
                  f"bit-equal={bit_equal} "
                  f"{times_text(ms, plan_ms, call_ms, plain_ms, plan, bnd)} "
                  f"| {card}")
            check(err_s <= tol * s_scale, "Gram S disagrees")
            check(err_r <= tol * r_scale, "Gram rhs disagrees")
            check(asym <= 1e-6 * s_scale, "Gram S not symmetric")
            check(bit_equal, "Gram kernel not deterministic")
            if (K, P, C) == GRAM_SHAPES[0] and dtype == torch.float32:
                main_stats = dict(max_abs_err=err_s, ms=ms, plain_ms=plain_ms,
                                  **bnd)
        del lh, gl, S_ref
    return main_stats


def aos_inputs(K, P, C, dtype, device, seed, ragged=False):
    """Random AoS Gram inputs; every point sees K distinct cameras, or,
    with ``ragged``, 2..K of them and padding slots (camera -1, zero
    blocks) for the rest."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    LH = torch.randn(P, K, 3, 6, generator=g, device=device, dtype=dtype)
    gL = torch.randn(P, 3, generator=g, device=device, dtype=dtype)
    cam = torch.rand(P, C, generator=g, device=device).argsort(dim=1)
    cam = cam[:, :K].to(torch.int32)
    if ragged:
        n = torch.randint(2, K + 1, (P, 1), generator=g, device=device)
        pad = torch.arange(K, device=device)[None, :] >= n
        cam[pad] = -1
        LH[pad] = 0.0
    return LH, gL, cam.contiguous()


def phase_gram_aos(device, card, reps=5):
    """AoS Gram kernel vs gram_aos_plain at the dense explicit path's
    shape, the TPU kernel's K and C ceilings and a ragged problem; bf16
    mode (distinct and repeated cameras) and the SoA kernel at the first
    shape.  Returns the first shape's float32 stats."""
    import torch

    from privacy_preserving_sfm_torch.optim import schur_pcg

    def plan_of(cam, C):
        return schur_pcg.gram_plan(cam, C, "aos")

    shapes = [(K, P, C, False) for K, P, C in GRAM_AOS_SHAPES]
    shapes.append(RAGGED + (True,))
    main_stats = None
    for K, P, C, ragged in shapes:
        LH, gL, cam = aos_inputs(K, P, C, torch.float64, device, seed=C + K,
                                 ragged=ragged)
        S_ref, r_ref = schur_pcg.gram_aos_plain(LH, gL, cam, C)
        s_scale = float(S_ref.abs().max())
        r_scale = float(r_ref.abs().max())
        what = f"K={K} P={P} C={C}"
        if ragged:
            what += (f" ragged (2..{K} slots a point, "
                     f"{int((cam >= 0).sum())} observations)")
        for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
            a, b = LH.to(dtype), gL.to(dtype)
            plan = plan_of(cam, C)
            S, r = schur_pcg.gram_aos(a, b, cam, C, plan=plan)
            S2, r2 = schur_pcg.gram_aos(a, b, cam, C)
            torch.cuda.synchronize()
            err_s = float((S.double() - S_ref).abs().max())
            err_r = float((r.double() - r_ref).abs().max())
            asym = float((S - S.T).abs().max())
            bit_equal = torch.equal(S, S2) and torch.equal(r, r2)
            ms, plan_ms, call_ms, plan = gram_times(
                schur_pcg.gram_aos, plan_of, a, b, cam, C, reps)
            plain_ms = cuda_ms(
                lambda: schur_pcg.gram_aos_plain(a, b, cam, C), reps)
            bnd = gram_bound(K, P, C, plan, a.element_size())
            name = str(dtype).replace("torch.", "")
            phase("gram_aos", f"{what} {name}: max|dS|={err_s:.3e} "
                  f"(tol {tol * s_scale:.3e}) max|drhs|={err_r:.3e} "
                  f"(tol {tol * r_scale:.3e}) max|S-S^T|={asym:.3e} "
                  f"bit-equal={bit_equal} "
                  f"{times_text(ms, plan_ms, call_ms, plain_ms, plan, bnd)} "
                  f"| {card}")
            check(err_s <= tol * s_scale, "AoS Gram S disagrees")
            check(err_r <= tol * r_scale, "AoS Gram rhs disagrees")
            check(asym <= 1e-6 * s_scale, "AoS Gram S not symmetric")
            check(bit_equal, "AoS Gram kernel not deterministic")
            if main_stats is None and dtype == torch.float32:
                main_stats = dict(max_abs_err=err_s, ms=ms, plain_ms=plain_ms,
                                  **bnd)
        if (K, P, C, ragged) == shapes[0]:
            phase_gram_bf16(a, b, cam, C, card, reps)
            rep = cam.clone()
            rep[::3, 1] = rep[::3, 0]  # a third of the points repeat a camera
            phase_gram_bf16(a, b, rep, C, card, reps, repeated=True)
        del LH, gL, S_ref
        torch.cuda.empty_cache()
    return main_stats


def phase_gram_bf16(a, b, cam, C, card, reps, repeated=False):
    """bf16 mode of the AoS kernel against its plain version (both round
    V's entries: only the sum order differs), the SoA kernel on the same
    blocks, bit-equal to the AoS one; with ``repeated``, points that have
    two slots in one camera, where rounding each slot instead of V's
    entry would give another S."""
    import torch

    from privacy_preserving_sfm_torch.optim import schur_pcg

    P, K = cam.shape
    S_ref, r_ref = schur_pcg.gram_aos_plain(a, b, cam, C, "bf16")
    plan = schur_pcg.gram_plan(cam, C, "aos")
    S, r = schur_pcg.gram_aos(a, b, cam, C, "bf16", plan=plan)
    S2, r2 = schur_pcg.gram_aos(a, b, cam, C, "bf16")
    _, r32 = schur_pcg.gram_aos(a, b, cam, C, plan=plan)
    torch.cuda.synchronize()
    s_scale = float(S_ref.abs().max())
    err_s = float((S - S_ref).abs().max())
    err_r = float((r - r_ref).abs().max())
    asym = float((S - S.T).abs().max())
    bit_equal = torch.equal(S, S2) and torch.equal(r, r2)
    ms = cuda_ms(lambda: schur_pcg.gram_aos(a, b, cam, C, "bf16", plan=plan),
                 reps)
    plain_ms = cuda_ms(
        lambda: schur_pcg.gram_aos_plain(a, b, cam, C, "bf16"), reps)
    what = f"K={K} P={P} C={C} bf16 operands"
    if repeated:
        what += (f", repeated cameras ({int((cam[:, 1] == cam[:, 0]).sum())}"
                 f" points)")
    phase("gram_aos", f"{what}: max|dS|={err_s:.3e} (tol "
          f"{1e-4 * s_scale:.3e}) max|drhs|={err_r:.3e} (tol "
          f"{1e-4 * float(r_ref.abs().max()):.3e}) rhs equal to float32 rhs="
          f"{torch.equal(r, r32)} max|S-S^T|={asym:.3e} bit-equal="
          f"{bit_equal} kernel {ms:.4f} ms (launch alone), plain "
          f"{plain_ms:.4f} ms | {card}")
    check(err_s <= 1e-4 * s_scale, "bf16 AoS Gram S disagrees")
    check(err_r <= 1e-4 * float(r_ref.abs().max()),
          "bf16 AoS Gram rhs disagrees")
    check(torch.equal(r, r32), "bf16 AoS Gram rounded rhs")
    check(asym <= 1e-6 * s_scale, "bf16 AoS Gram S not symmetric")
    check(bit_equal, "bf16 AoS Gram kernel not deterministic")
    lh_stack = a.permute(2, 3, 1, 0).reshape(18 * K, P).contiguous()
    gl, cam_kp = b.T.contiguous(), cam.T.contiguous()
    if repeated:
        # Per-slot rounding (the port before it rounded V's entries).
        V = schur_pcg._expand_v(schur_pcg._round_bf16(a), cam, C)
        slot_err = float((V.T @ V - S_ref).abs().max())
        S_soa, r_soa = schur_pcg.gram_soa(lh_stack, gl, cam_kp, C, "bf16")
        same = torch.equal(S_soa, S) and torch.equal(r_soa, r)
        phase("gram_aos", f"{what}: SoA kernel bit-equal to AoS={same}; "
              f"rounding each slot instead would move S by {slot_err:.3e} "
              f"(tol {1e-4 * s_scale:.3e}) | {card}")
        check(same, "bf16 SoA and AoS Gram kernels differ")
        check(slot_err > 1e-4 * s_scale,
              "repeated cameras do not tell the roundings apart")
        return
    S_soa, r_soa = schur_pcg.gram_soa(lh_stack, gl, cam_kp, C)
    S_aos, r_aos = schur_pcg.gram_aos(a, b, cam, C)
    same = torch.equal(S_soa, S_aos) and torch.equal(r_soa, r_aos)
    plan_soa = schur_pcg.gram_plan(cam_kp, C, "soa")
    soa_ms = cuda_ms(lambda: schur_pcg.gram_soa(lh_stack, gl, cam_kp, C,
                                                plan=plan_soa), reps)
    aos_ms = cuda_ms(lambda: schur_pcg.gram_aos(a, b, cam, C, plan=plan),
                     reps)
    phase("gram_aos", f"K={K} P={P} C={C} float32, same blocks: AoS kernel "
          f"{aos_ms:.4f} ms, SoA kernel {soa_ms:.4f} ms (launch alone), "
          f"outputs bit-equal={same} | {card}")
    check(same, "SoA and AoS Gram kernels differ on the same blocks")


def pcg_system(C, device, seed):
    """A reduced camera system in the solvers' form, S = blockdiag(dHcc) -
    S_corr, from the Gram G of BA-100-like random blocks (6 distinct
    cameras a point, 20,000 points): S_corr = -G and damping blocks dHcc,
    so S = G + diag(0.1 d + 1e-3 max d) is SPD; the block-Jacobi
    preconditioner inv(dHcc - diag_blocks(S_corr)), as the solvers build
    it, and a rhs.  float64."""
    import torch

    from privacy_preserving_sfm_torch.optim import schur_pcg

    lh, gl, cam = gram_inputs(6, 20000, C, torch.float64, device, seed)
    G, _ = schur_pcg.gram_soa(lh, gl, cam, C)
    d = torch.diagonal(G).reshape(C, 6)
    dHcc = torch.diag_embed(0.1 * d + 1e-3 * float(d.max()))
    minv = torch.linalg.inv(dHcc + schur_pcg.diag_blocks(G, C))
    g = torch.Generator(device=device).manual_seed(seed)
    rhs = torch.randn(6 * C, generator=g, device=device, dtype=torch.float64)
    return -G, dHcc, minv, rhs


def pcg_bound(C, itemsize, iters=CG_ITERS):
    """bound() of one PCG solve: S_corr, the two block arrays, rhs and x
    once each; iters steps of 2n^2 + 34n flops (the S_corr product, the
    two block products, the vector updates) and the first z."""
    n = 6 * C
    return bound(iters * (2.0 * n * n + 34 * n) + 14 * n,
                 PEAK_F32 if itemsize == 4 else PEAK_F64,
                 (n * n + 72 * C + 2 * n) * itemsize)


def pcg_floor(C, itemsize, sync_ms, l2_rate, iters=CG_ITERS):
    """A floor the kernel can reach, ms: two exchanges a step at their
    measured cost, and S_corr read once a step and once more, from L2 where
    it fits (at the measured L2 rate), else from HBM."""
    nbytes = (6 * C) ** 2 * itemsize
    rate = l2_rate if nbytes <= L2_BYTES else HBM_BYTES_S
    return iters * 2 * sync_ms + (iters + 1) * nbytes / rate * 1e3


def phase_sync(device, card, reps=2000):
    """The cost of one grid sync (a cooperative grid of one CTA an SM, the
    PCG's grid path) and of one cluster barrier (16 CTAs, the cluster
    path), by CUDA events over reps of each in one launch less the same
    launch with half the reps; the L2 read rate (a 32 MiB buffer held in
    L2, read 20 times by one CTA an SM, against one read).  Returns (grid
    ms, cluster ms, L2 B/s)."""
    import torch

    from privacy_preserving_sfm_torch.kernels import build

    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def per_sync(**kw):
        full = cuda_ms(lambda: build.launch_sync_probe(device, reps, **kw), 5)
        half = cuda_ms(lambda: build.launch_sync_probe(device, reps // 2,
                                                       **kw), 5)
        return (full - half) / (reps - reps // 2)

    grid_ms = per_sync(blocks=sms)
    cluster_ms = per_sync(cluster_ctas=16)
    buf = torch.ones(8 * 2 ** 20, device=device)
    out = torch.empty(sms * 512, device=device)

    def reads(k):
        return cuda_ms(lambda: build.launch_l2_probe(buf, k, out, sms), 5)

    l2_rate = 19 * buf.numel() * 4 / ((reads(20) - reads(1)) / 1e3)
    phase("sync", f"one grid sync ({sms} CTAs) {grid_ms * 1e3:.3f} us, one "
          f"cluster barrier (16 CTAs) {cluster_ms * 1e3:.3f} us, L2 "
          f"read rate {l2_rate / 1e12:.2f} TB/s (32 MiB) | {card}")
    return grid_ms, cluster_ms, l2_rate


def pcg_device_ms(fn, reps):
    """Device ms of the PCG kernel a call of ``fn``, under torch.profiler:
    its time on the card without the wrapper's host path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if re.search(PCG_KERNEL, e.key)) / reps / 1e3


def pcg_steps(system, card, sync, reps=20):
    """The main path's PCG (BA-100, float32) split by its device time at 0,
    1 and CG_ITERS steps: the fixed cost of a launch, and the cost of a
    step against its two measured exchanges."""
    from privacy_preserving_sfm_torch.optim import schur_pcg

    times = {k: pcg_device_ms(lambda k=k: schur_pcg.pcg_schur(*system, k),
                              reps) for k in (0, 1, CG_ITERS)}
    step = (times[CG_ITERS] - times[1]) / (CG_ITERS - 1)
    phase("pcg", f"C={PCG_MAIN} float32 auto path, device ms by steps: "
          f"{times[0]:.4f} (0), {times[1]:.4f} (1), {times[CG_ITERS]:.4f} "
          f"({CG_ITERS}); a step {step * 1e3:.3f} us against two cluster "
          f"barriers {2 * sync[1] * 1e3:.3f} us | {card}")


def pcg_path_run(system, path):
    """The PCG on ``path`` ("cluster" may not fit): (x, path taken) or
    (None, None)."""
    from privacy_preserving_sfm_torch.kernels import build
    from privacy_preserving_sfm_torch.optim import schur_pcg

    before = dict(build.LAUNCHES)
    try:
        x = schur_pcg.pcg_schur(*system, CG_ITERS, path=path)
    except RuntimeError:
        if path != "cluster":
            raise
        return None, None
    taken = [p for p in ("cluster", "grid")
             if build.LAUNCHES[f"schur_pcg_{p}"] > before[f"schur_pcg_{p}"]]
    return x, taken[0]


def phase_pcg(device, card, sync, reps=5):
    """The PCG kernel against its plain twin on both of its paths (the
    cluster path where it fits), both dtypes; times against the bound and
    the floor.  Returns the BA-100 stats of the kernels line."""
    import torch

    from privacy_preserving_sfm_torch.optim import schur_pcg

    grid_ms, cluster_ms, l2_rate = sync
    main_stats = None
    seen = set()
    for C in sorted(set(PCG_CAMS) | set(PCG_BOTH)):
        system64 = pcg_system(C, device, seed=C)
        for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
            system = [a.to(dtype) for a in system64]
            x_ref = schur_pcg.pcg_schur_plain(*system, CG_ITERS)
            plain_ms = cuda_ms(
                lambda: schur_pcg.pcg_schur_plain(*system, CG_ITERS), reps)
            paths = ["auto"] + (["cluster", "grid"] if C in PCG_BOTH else [])
            size = system[0].element_size()
            bound_ms, bound_by = pcg_bound(C, size)
            name = str(dtype).replace("torch.", "")
            for path in paths:
                x, taken = pcg_path_run(system, path)
                if x is None:
                    phase("pcg", f"C={C} n={6 * C} {name} path=cluster: "
                          f"does not fit in a cluster's shared memory")
                    continue
                again = schur_pcg.pcg_schur(*system, CG_ITERS, path=path)
                torch.cuda.synchronize()
                rel = float((x - x_ref).norm() / x_ref.norm())
                err = float((x - x_ref).abs().max())
                stable = torch.equal(x, again)
                def call():
                    return schur_pcg.pcg_schur(*system, CG_ITERS, path=path)
                ms = cuda_ms(call, reps)
                dev_ms = pcg_device_ms(call, reps)
                floor = pcg_floor(C, size, cluster_ms if taken == "cluster"
                                  else grid_ms, l2_rate)
                seen.add(taken)
                phase("pcg", f"C={C} n={6 * C} iters={CG_ITERS} {name} "
                      f"path={path}->{taken}: |dx|/|x|={rel:.3e} (tol "
                      f"{tol:.0e}) max|dx|={err:.3e} bit-equal across runs="
                      f"{stable} kernel {ms:.4f} ms (device {dev_ms:.4f}), "
                      f"bound {bound_ms:.5f} ms ({bound_by}), floor "
                      f"{floor:.4f} ms (measured exchanges), plain "
                      f"{plain_ms:.4f} ms | {card}")
                check(rel <= tol, "PCG disagrees with its plain twin")
                check(stable, "PCG kernel not deterministic")
                if C == PCG_MAIN and dtype == torch.float32 \
                        and path == "auto":
                    main_stats = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms, bound_ms=bound_ms,
                                      bound_by=bound_by, library_ms=None)
                    pcg_steps(system, card, sync)
        del system64
        torch.cuda.empty_cache()
    check(seen == {"cluster", "grid"}, f"PCG paths launched: {seen}")
    return main_stats


def write_model(in_dir, cfg, seed):
    """``synthetic_model(seed=seed, **cfg)`` written as text to ``in_dir``;
    returns what the phases print and hold of it (its squared line error
    sum ``err_in`` among them)."""
    from privacy_preserving_sfm_torch.utils.synthetic import (
        line_error_sum, synthetic_model,
    )

    t0 = time.perf_counter()
    start = synthetic_model(seed=seed, **cfg)
    start.write_text(in_dir)
    return dict(in_dir=in_dir, err_in=line_error_sum(start),
                images=start.num_registered(), points=len(start.points3d),
                observations=start.num_observations(),
                longest=max(len(p.track) for p in start.points3d.values()),
                seconds=time.perf_counter() - t0)


def made_models():
    """(phase, cfg, seed) of the models ``start_models`` makes, in the order
    the phases take them."""
    return [("ba300", ba300_model(BA300), 0), ("ba1000", BA1000, 0),
            ("dense_implicit", IMPLICIT, 3)]


# Seconds ba300 waits for the models of start_models before it fails.
MODELS_TIMEOUT = 300


def start_models(workdir):
    """A pool of one spawned process (one BLAS thread) that makes and
    writes each model of ``made_models()`` into ``workdir/<phase>``
    (``write_model``) while this process runs the phases before theirs:
    making and writing a model of 0.6-1.2 M observations is host work the
    card need not wait for.  Returns the pool and each phase's pending
    result."""
    import multiprocessing

    with environ({"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
                  "MKL_NUM_THREADS": "1"}):
        pool = multiprocessing.get_context("spawn").Pool(1)
    return pool, {name: pool.apply_async(
        write_model, (os.path.join(workdir, name), cfg, seed))
        for name, cfg, seed in made_models()}


def finish_models(pool, pending):
    """The facts (``write_model``) of every model of ``start_models``, all
    within MODELS_TIMEOUT seconds; then the pool is closed, so that no
    child runs beside the phases that take them."""
    t0 = time.perf_counter()
    models = {name: result.get(timeout=max(
        0.0, MODELS_TIMEOUT - (time.perf_counter() - t0)))
        for name, result in pending.items()}
    pool.close()
    pool.join()
    phase("models", f"{', '.join(models)} made and written by the maker "
          f"process, waited {time.perf_counter() - t0:.1f} s for them")
    return models


def seeded_model(name, cfg, seed, workdir, models):
    """Phase ``name``'s model ``synthetic_model(seed=seed, **cfg)``: from
    ``models`` (``finish_models``) when given, else made and written here
    into ``workdir/in``.  Prints its size and where it was made; returns
    its facts (``write_model``)."""
    if models is None:
        start = write_model(os.path.join(workdir, "in"), cfg, seed)
        where = "here"
    else:
        start = models[name]
        where = "by the maker process"
    phase(name, f"synthetic model: {start['images']} images, "
          f"{start['points']} points, {start['observations']} "
          f"observations, longest track {start['longest']}, made and "
          f"written in {start['seconds']:.1f} s {where}")
    return start


def phase_main_path(device, card, workdir, *, name="main", cfg=MAIN,
                    path="cluster", check_ba=False, warm_up=False,
                    models=None):
    """``bundle_adjuster --device`` in float32 on a model made by
    ``synthetic_model(seed=0, **cfg)``: ``schur_gram``, ``schur_pcg`` and
    the PCG's ``path`` launched, the output model finite with the line
    error at least halved, and a second solve bit-equal in as many LM
    iterations.  Without ``check_ba``, the final cost is held against a
    float64 solve through the plain Gram and PCG, and the second solve is
    the CLI's again under torch.profiler.  With ``check_ba``, the solve is
    held against the plain route by ``check_mapper_ba`` (every Gram and
    PCG call, float32 and float64), whose kernel re-solve in this process
    is the second solve (at BA300's and BA1000's sizes, a CLI run's text
    IO and the profiler would take most of the phase).  With ``warm_up``
    (the first solve in the process) a small solve comes first.  The
    model comes from ``models`` (``finish_models``) under ``name`` when
    given.  Returns the launches and, with ``check_ba``,
    ``check_mapper_ba``'s errors."""
    import torch

    from privacy_preserving_sfm_torch.exe import ppsfm
    from privacy_preserving_sfm_torch.kernels import build
    from privacy_preserving_sfm_torch.utils.synthetic import synthetic_model

    out_dir = os.path.join(workdir, "out")
    start = seeded_model(name, cfg, 0, workdir, models)
    in_dir, err_in = start["in_dir"], start["err_in"]

    if warm_up:
        # The first solve in a process pays one-time costs (lazy loading
        # of PyTorch's CUDA modules, torch.func set-up); time them apart.
        warm_dir = os.path.join(workdir, "warm")
        synthetic_model(10, 500, 6, seed=1).write_text(warm_dir)
        t0 = time.perf_counter()
        ppsfm.main(["bundle_adjuster", "--input_path", warm_dir,
                    "--output_path", os.path.join(workdir, "warm_out"),
                    "--max_num_iterations", "3", "--device", device.type,
                    "--dtype", "float32"])
        torch.cuda.synchronize()
        phase(name, f"warm-up solve (10 images, first in the process): "
              f"{time.perf_counter() - t0:.3f} s")

    for k in build.LAUNCHES:
        build.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    solves = {}
    t0 = time.perf_counter()
    with mapper_ba_capture(solves) if check_ba else contextlib.nullcontext():
        mapper = ppsfm.main(["bundle_adjuster", "--input_path", in_dir,
                             "--output_path", out_dir,
                             "--max_num_iterations", str(LM_ITERS),
                             "--device", device.type, "--dtype", "float32"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    summary = mapper.last_summary
    solve_s = mapper.phase_times["ba_solve"]
    nobs = start["observations"]
    rate = nobs * summary.num_iterations / solve_s
    phase(name, f"bundle_adjuster --device {device.type} (float32): route "
          f"{tuple(mapper.last_route)}, wall {wall:.3f} s, ba_solve "
          f"{solve_s:.3f} s, LM iterations {summary.num_iterations}, "
          f"{rate:.1f} obs*iter/s (ba_solve), peak device memory "
          f"{peak / 2**20:.1f} MiB, launches {launches} | {card}")
    check(mapper.last_route.solver == "soa",
          f"the solve took route {tuple(mapper.last_route)}, not soa")
    for k in ("schur_gram", "schur_pcg", f"schur_pcg_{path}"):
        check(launches[k] > 0, f"kernel {k} was not launched by the solve")

    check_output_model(out_dir, cfg, err_in, name)
    if check_ba:
        errors = check_mapper_ba(device, card, solves, name,
                                 kinds=("global",))
        phase(name, f"peak device memory of the solve and its checks "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB | "
              f"{card}")
        return launches, errors
    float64_plain(device, in_dir, summary)
    again = gram_share(name, card, lambda: ppsfm.main([
        "bundle_adjuster", "--input_path", in_dir, "--output_path",
        os.path.join(workdir, "out_prof"), "--max_num_iterations",
        str(LM_ITERS), "--device", device.type, "--dtype", "float32"]))
    check_same_solve(name, out_dir, os.path.join(workdir, "out_prof"),
                     summary, again.last_summary)
    return launches, None


def float64_plain(device, in_dir, summary):
    """The model at ``in_dir`` solved in float64 on the SoA route through
    the plain Gram and PCG: the float32 ``summary``'s final cost within
    1e-3 of it."""
    import torch

    from privacy_preserving_sfm_torch.models.reconstruction import (
        Reconstruction,
    )
    from privacy_preserving_sfm_torch.optim import ba as ba_mod
    from privacy_preserving_sfm_torch.optim import ba_dense, ba_soa
    from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
        IncrementalMapper,
    )

    # The same problem in float64 through the plain Gram and PCG.
    rec = Reconstruction.read_text(in_dir)
    rec.filter_observations_with_negative_depth()
    ref = IncrementalMapper(device, torch.float64)
    ref.begin_reconstruction(rec)
    reg = rec.reg_image_ids
    asm = ref.assemble_ba(reg, {reg[0]}, {reg[1]})
    t0 = time.perf_counter()
    _, _, _, s64 = ba_soa.bundle_adjust_soa(
        ba_dense.from_flat_problem(asm.problem), asm.camera_model,
        ba_mod.BAOptions(max_iterations=LM_ITERS), plain=True)
    torch.cuda.synchronize()
    rel = abs(summary.final_cost - s64.final_cost) / s64.final_cost
    phase("main", f"final cost float32 kernels {summary.final_cost!r} vs "
          f"float64 plain {s64.final_cost!r} ({s64.num_iterations} LM "
          f"iterations, {time.perf_counter() - t0:.3f} s): rel diff "
          f"{rel:.3e} (tol 1e-3); initial cost {summary.initial_cost!r}")
    check(rel <= 1e-3, "final cost disagrees with the float64 plain run")


def ba300_model(shape, seed=300):
    """``synthetic_model``'s arguments for a global BA of ``shape`` = (C,
    P, K, observations): a fiftieth of the points (at least one) seen by
    K cameras, the rest by a seeded number of cameras, uniform from 4
    (three lines or fewer leave a point's 3 x 3 block near singular) to
    what makes up the observations on average."""
    import numpy as np

    C, P, K, nobs = shape
    n_long = max(1, P // 50)
    mean = (nobs - n_long * K) / (P - n_long)
    rng = np.random.default_rng(seed)
    rest = rng.integers(4, max(5, int(round(2 * mean)) - 3), P - n_long)
    lengths = np.concatenate([np.full(n_long, K), np.minimum(rest, K)])
    return dict(num_images=C, num_points=P, obs_per_point=K,
                track_lengths=rng.permutation(lengths).tolist(),
                meas_noise=MAIN["meas_noise"])


def phase_ba300(device, card, workdir, models=None):
    """``bundle_adjuster`` (phase ``main``'s code) at BA300, the shape of
    the largest global BA the port's mapper ran at the reference's
    300-view scale: the SoA route with the PCG on "auto", which takes the
    grid path there; every Gram and PCG call of the solve held against
    the plain version and the solve made again, bit-equal
    (``check_mapper_ba``).  Returns the launches and those errors."""
    return phase_main_path(device, card, workdir, name="ba300",
                           cfg=ba300_model(BA300), path="grid",
                           check_ba=True, models=models)


def phase_ba1000(device, card, workdir, models=None):
    """``bundle_adjuster`` (phase ``main``'s code) at BA1000, the
    reference's 512 < C <= 1024 regime: the SoA route with the PCG on
    "auto", which takes the grid path there; every Gram and PCG call of
    the solve held against the plain version and the solve made again,
    bit-equal (``check_mapper_ba``).  Returns the launches and those
    errors."""
    return phase_main_path(device, card, workdir, name="ba1000",
                           cfg=BA1000, path="grid", check_ba=True,
                           models=models)


def check_same_solve(name, out_a, out_b, summary_a, summary_b):
    """Two solves of one model wrote byte-identical models (poses and
    points as repr of the float32 results) in as many LM iterations."""
    def text(out, name):
        with open(os.path.join(out, name), "rb") as f:
            return f.read()

    same = all(text(out_a, f) == text(out_b, f)
               for f in ("cameras.txt", "images.txt", "points3D.txt"))
    phase(name, f"the same solve twice: LM iterations "
          f"{summary_a.num_iterations} and {summary_b.num_iterations}, "
          f"final cost {summary_a.final_cost!r} and "
          f"{summary_b.final_cost!r}, output models bit-equal={same}")
    check(summary_a.num_iterations == summary_b.num_iterations,
          "two solves of one model took different LM iteration counts")
    check(same, "two solves of one model gave different models")


def gram_share(name, card, run):
    """``run()`` once more under torch.profiler: the Gram kernels' share
    of kernel time (the kernels' self device time by name); returns what
    ``run()`` returns."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only (kernels, copies), less the device-timeline
    # intervals of record_function spans, which carry a host op's name.
    averages = prof.key_averages()
    host = {e.key for e in averages
            if e.device_type == torch.autograd.DeviceType.CPU}
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key not in host and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events)
    grams = [e for e in events if re.search(GRAM_KERNEL, e.key)]
    gram = sum(e.self_device_time_total for e in grams)
    pcg = sum(e.self_device_time_total for e in events
              if re.search(PCG_KERNEL, e.key))
    each = ", ".join(
        f"{re.search(GRAM_KERNEL, e.key).group(0)} "
        f"{e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in grams)
    phase(name, f"under torch.profiler: wall {wall:.3f} s, kernel time "
          f"{total / 1e3:.3f} ms (busy {total / 1e4 / wall:.1f} %), Gram "
          f"kernels {gram / 1e3:.3f} ms = {100 * gram / max(total, 1):.1f} % "
          f"of kernel time ({each}), PCG {pcg / 1e3:.3f} ms | {card}")
    check(gram > 0, "the profiled run launched no Gram kernel")
    return out


def check_output_model(out_dir, cfg, err_in, name):
    """The output model keeps every image and point, all finite, and the
    BA at least halved the line error."""
    import numpy as np

    from privacy_preserving_sfm_torch.models.reconstruction import (
        Reconstruction,
    )
    from privacy_preserving_sfm_torch.utils.synthetic import line_error_sum

    out = Reconstruction.read_text(out_dir)
    check(out.num_registered() == cfg["num_images"], "images lost")
    check(len(out.points3d) == cfg["num_points"], "points lost")
    finite = all(np.isfinite(img.qvec).all() and np.isfinite(img.tvec).all()
                 for img in out.images.values())
    finite &= all(np.isfinite(p.xyz).all() for p in out.points3d.values())
    check(finite, "non-finite pose or point in the output model")
    err_out = line_error_sum(out)
    phase(name, f"squared pixel line error sum {err_in!r} -> {err_out!r} "
          f"(ratio {err_out / err_in:.4f}, must be <= 0.5)")
    check(err_out <= 0.5 * err_in, "BA did not halve the line error")


def run_bundle_adjuster(device, in_dir, out_dir, env, extra=()):
    """``bundle_adjuster`` through the CLI in float32 with the environment
    variables ``env`` set (None: unset) and restored after, launch counts
    set to 0 just before; returns (mapper, launches, wall s, peak bytes)."""
    import torch

    from privacy_preserving_sfm_torch.exe import ppsfm
    from privacy_preserving_sfm_torch.kernels import build

    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        for name in build.LAUNCHES:
            build.LAUNCHES[name] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mapper = ppsfm.main(["bundle_adjuster", "--input_path", in_dir,
                             "--output_path", out_dir, "--device",
                             device.type, "--dtype", "float32", *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return mapper, launches, wall, torch.cuda.max_memory_allocated()


def float64_cost(device, in_dir, options):
    """Final cost and iterations of the float64 dense-block solve of the
    same problem on the card, Gram and PCG in their plain versions."""
    import torch

    from privacy_preserving_sfm_torch.models.reconstruction import (
        Reconstruction,
    )
    from privacy_preserving_sfm_torch.optim import ba_dense
    from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
        IncrementalMapper,
    )

    rec = Reconstruction.read_text(in_dir)
    rec.filter_observations_with_negative_depth()
    ref = IncrementalMapper(device, torch.float64)
    ref.begin_reconstruction(rec)
    reg = rec.reg_image_ids
    asm = ref.assemble_ba(reg, {reg[0]}, {reg[1]})
    t0 = time.perf_counter()
    _, _, _, s64 = ba_dense.bundle_adjust_dense(
        ba_dense.from_flat_problem(asm.problem), asm.camera_model, options,
        plain=True)
    torch.cuda.synchronize()
    return s64, time.perf_counter() - t0


def report_solve(name, mapper, launches, wall, peak, nobs, card):
    s = mapper.last_summary
    solve_s = mapper.phase_times["ba_solve"]
    phase(name, f"route {tuple(mapper.last_route)}: wall {wall:.3f} s, "
          f"ba_assemble {mapper.phase_times['ba_assemble']:.3f} s, "
          f"ba_solve {solve_s:.3f} s, LM iterations {s.num_iterations}, "
          f"{nobs * s.num_iterations / solve_s:.1f} obs*iter/s (ba_solve), "
          f"peak device memory {peak / 2**20:.1f} MiB, launches {launches} "
          f"| {card}")


def compare_float64(name, summary, s64, dt):
    rel = abs(summary.final_cost - s64.final_cost) / s64.final_cost
    phase(name, f"final cost float32 {summary.final_cost!r} vs float64 "
          f"{s64.final_cost!r} ({s64.num_iterations} LM iterations, "
          f"{dt:.3f} s): rel diff {rel:.3e} (tol 1e-3); initial cost "
          f"{summary.initial_cost!r}")
    check(rel <= 1e-3, "final cost disagrees with the float64 run")


def phase_dense_explicit(device, card, workdir):
    """The main phase's model through ``PPSFM_BA_PATH=dense``: the dense
    solver's explicit Schur, with the AoS Gram and PCG kernels."""
    from privacy_preserving_sfm_torch.models.reconstruction import (
        Reconstruction,
    )
    from privacy_preserving_sfm_torch.optim import ba as ba_mod
    from privacy_preserving_sfm_torch.utils.synthetic import line_error_sum

    in_dir = os.path.join(workdir, "in")  # written by phase_main_path
    start = Reconstruction.read_text(in_dir)
    mapper, launches, wall, peak = run_bundle_adjuster(
        device, in_dir, os.path.join(workdir, "out_dense"),
        {"PPSFM_BA_PATH": "dense", "PPSFM_SCHUR_MODE": None},
        ["--max_num_iterations", str(LM_ITERS)])
    report_solve("dense_explicit", mapper, launches, wall, peak,
                 start.num_observations(), card)
    check(mapper.last_route.solver == "dense" and mapper.last_route.explicit,
          "PPSFM_BA_PATH=dense did not take the dense explicit route")
    for name in ("schur_gram_aos", "schur_pcg"):
        check(launches[name] > 0,
              f"kernel {name} was not launched by the dense explicit path")
    check(launches["schur_gram"] == 0,
          "the dense explicit path launched the SoA Gram")
    check_output_model(os.path.join(workdir, "out_dense"), MAIN,
                       line_error_sum(start), "dense_explicit")
    s64, dt = float64_cost(device, in_dir, ba_mod.BAOptions(
        max_iterations=LM_ITERS, schur_mode="explicit"))
    compare_float64("dense_explicit", mapper.last_summary, s64, dt)
    again, *_ = gram_share(
        "dense_explicit", card, lambda: run_bundle_adjuster(
            device, in_dir, os.path.join(workdir, "out_dense_prof"),
            {"PPSFM_BA_PATH": "dense", "PPSFM_SCHUR_MODE": None},
            ["--max_num_iterations", str(LM_ITERS)]))
    check_same_solve("dense_explicit", os.path.join(workdir, "out_dense"),
                     os.path.join(workdir, "out_dense_prof"),
                     mapper.last_summary, again.last_summary)
    return launches


def phase_dense_implicit(device, card, workdir, models=None):
    """A 1,280-camera global BA with no override: the mapper sends it to
    the dense solver's implicit CG, which runs no Schur kernel.  The model
    comes from ``models`` when given."""
    from privacy_preserving_sfm_torch.optim import ba as ba_mod

    out_dir = os.path.join(workdir, "out")
    start = seeded_model("dense_implicit", IMPLICIT, 3, workdir, models)
    in_dir, nobs = start["in_dir"], start["observations"]
    mapper, launches, wall, peak = run_bundle_adjuster(
        device, in_dir, out_dir,
        {"PPSFM_BA_PATH": None, "PPSFM_SCHUR_MODE": None})
    report_solve("dense_implicit", mapper, launches, wall, peak, nobs, card)
    check(mapper.last_route.solver == "dense"
          and not mapper.last_route.explicit,
          "a 1,280-camera BA did not take the dense implicit route")
    check(sum(launches.values()) == 0, "a kernel ran on the implicit route")
    phase("dense_implicit", "no Schur kernel runs on this route (the "
          "implicit CG never forms S): launches all 0, as expected")
    check_output_model(out_dir, IMPLICIT, start["err_in"], "dense_implicit")
    s64, dt = float64_cost(device, in_dir, ba_mod.BAOptions(
        max_iterations=100, schur_mode="implicit"))
    compare_float64("dense_implicit", mapper.last_summary, s64, dt)


def bound(ops, peak, nbytes):
    """(least ms of the work on the card, "operations" or "bytes")."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def match_bound(b, n1, n2, both):
    """bound() of the top-2 search of b pairs: one int8 contraction, and
    the descriptors and masks (row-only: d2's) read and the three tables
    of each direction written once."""
    mask1, out2 = (1, 12) if both else (0, 0)
    nbytes = b * (n1 * (128 + mask1 + 12) + n2 * (128 + 1 + out2))
    return bound(2.0 * b * n1 * n2 * 128, PEAK_INT8, nbytes)


def host_ms(fn, reps):
    """Mean host milliseconds to issue ``fn()``, the card running behind,
    after one warm-up call: the wrapper's host path."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


def match_inputs(b, n1, n2, kind, device, seed):
    """SIFT-convention descriptors on the card.  "ties": exact duplicates
    making ties along a row and a column, padding on both sides in pair 1
    and a single valid candidate per row in pair 2; "top": all-255 rows
    and columns in pair 0 (the largest dot, tied across tiles) and every
    descriptor all-255 in pair 1 (every dot tied at the top)."""
    import numpy as np
    import torch

    from privacy_preserving_sfm_torch.utils.synthetic import sift_like

    rng = np.random.default_rng(seed)
    d1 = sift_like(rng.dirichlet(np.full(128, 0.2), (b, n1)))
    d2 = sift_like(rng.dirichlet(np.full(128, 0.2), (b, n2)))
    v1 = np.ones((b, n1), bool)
    v2 = np.ones((b, n2), bool)
    if kind == "ties":
        d2[0, 40] = d2[0, n2 - 1] = d1[0, 7]
        d2[1, 3] = d2[1, 5]
        d1[0, n1 - 1] = d1[0, 7]
        v1[1, (2 * n1) // 3:] = False
        v2[1, n2 // 2:] = False
        v2[2, 1:] = False
    elif kind == "top":
        d1[0, 3] = d1[0, n1 - 1] = 255
        d2[0, 127] = d2[0, 128] = d2[0, n2 - 1] = 255
        d1[1] = 255
        d2[1] = 255
    return [torch.from_numpy(a).to(device) for a in (d1, d2, v1, v2)]


def plain_chunked(fn, *args):
    """``fn`` (the plain version) on PLAIN_PAIRS pairs a call, joined."""
    import torch

    parts = [fn(*(a[i:i + PLAIN_PAIRS] for a in args))
             for i in range(0, args[0].shape[0], PLAIN_PAIRS)]
    return tuple(torch.cat(p) for p in zip(*parts))


def phase_match(device, card, reps=5):
    """Match kernel vs its plain version: exact equality of the six
    tables (three in row-only mode) and two runs bit-equal at every
    shape; times against the bound.  Returns the main-path shape's
    stats."""
    import torch

    from privacy_preserving_sfm_torch.features import matching
    from privacy_preserving_sfm_torch.features import matching_kernels as mk

    plain = matching._top2_both_batched_plain
    main_stats = None
    for b, n1, n2, kind in MATCH_SHAPES:
        d1, d2, v1, v2 = match_inputs(b, n1, n2, kind, device,
                                      seed=n1 + n2 + b)
        ones = torch.ones_like(v1)
        got = mk.top2_scores_bidir(d1, d2, v1, v2)
        again = mk.top2_scores_bidir(d1, d2, v1, v2)
        rows = mk.top2_scores(d1, d2, v2)
        torch.cuda.synchronize()
        ref = plain_chunked(plain, d1, d2, v1, v2)
        ref_rows = plain_chunked(plain, d1, d2, ones, v2)[:3]
        exact = all(torch.equal(g, r) for g, r in zip(got, ref))
        exact_rows = all(torch.equal(g, r) for g, r in zip(rows, ref_rows))
        stable = all(torch.equal(g, h) for g, h in zip(got, again))
        err = max(float((g.double() - r.double()).abs().max())
                  for g, r in zip(got, ref))
        del ref, ref_rows, got, again, rows
        ms = cuda_ms(lambda: mk.top2_scores_bidir(d1, d2, v1, v2), reps)
        ms_rows = cuda_ms(lambda: mk.top2_scores(d1, d2, v2), reps)
        plain_ms = cuda_ms(lambda: plain_chunked(plain, d1, d2, v1, v2),
                           reps)
        plain_rows_ms = cuda_ms(
            lambda: plain_chunked(plain, d1, d2, ones, v2)[:3], reps)
        host = host_ms(lambda: mk.top2_scores_bidir(d1, d2, v1, v2), reps)
        bound_ms, bound_by = match_bound(b, n1, n2, True)
        rows_bound_ms, _ = match_bound(b, n1, n2, False)
        int_mm = int_mm_ms(n1, n2, device, reps)
        what = f" ({kind})" if kind else ""
        phase("match", f"B={b} N1={n1} N2={n2}{what}: six tables exact="
              f"{exact}, row-only exact={exact_rows}, bit-equal across runs="
              f"{stable}, max|diff|={err!r} | bidir kernel {ms:.4f} ms = "
              f"{ms / b * 1e3:.2f} us/pair, bound {bound_ms:.4f} ms "
              f"({bound_by}; {100 * bound_ms / ms:.1f} % of it reached), "
              f"host path {host:.4f} ms a call, "
              f"plain {plain_ms:.4f} ms | row-only kernel {ms_rows:.4f} ms "
              f"= {ms_rows / b * 1e3:.2f} us/pair, bound {rows_bound_ms:.4f} "
              f"ms ({100 * rows_bound_ms / ms_rows:.1f} %), plain "
              f"{plain_rows_ms:.4f} ms | torch._int_mm on one pair's int8 "
              f"operands (contraction only, not the same function): "
              f"{int_mm} | plain on {PLAIN_PAIRS} pairs a call | {card}")
        check(exact, "match kernel disagrees with its plain version")
        check(exact_rows, "row-only match kernel disagrees")
        check(stable, "match kernel not deterministic")
        if (b, n1, n2) == MATCH_MAIN:
            main_stats = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=None)
        del d1, d2, v1, v2
        torch.cuda.empty_cache()
    return main_stats


def int_mm_ms(n1, n2, device, reps):
    """Text: ms of ``torch._int_mm`` on (n1, 128) x (128, n2) int8, a
    yardstick of the contraction alone that the port never calls."""
    import torch

    a = torch.randint(-128, 128, (n1, 128), dtype=torch.int8, device=device)
    b = torch.randint(-128, 128, (n2, 128), dtype=torch.int8, device=device)
    try:
        ms = cuda_ms(lambda: torch._int_mm(a, b.t()), reps)
    except RuntimeError as e:  # a yardstick only: report, do not fail
        return f"not available ({str(e).splitlines()[0][:80]})"
    return f"{ms:.4f} ms"


def _blobs(path, pairs=None):
    import sqlite3

    from privacy_preserving_sfm_torch.models.database import (
        image_pair_to_pair_id,
    )

    con = sqlite3.connect(path)
    try:
        rows = dict((r[0], r[1:]) for r in con.execute(
            "SELECT pair_id, rows, cols, data FROM matches"))
    finally:
        con.close()
    if pairs is None:
        return rows
    return {k: rows.get(k) for k in
            (image_pair_to_pair_id(a, b) for a, b in pairs)}


def phase_matcher(device, card, workdir):
    import shutil

    import torch

    from privacy_preserving_sfm_torch.exe import ppsfm
    from privacy_preserving_sfm_torch.features import schedulers
    from privacy_preserving_sfm_torch.kernels import build
    from privacy_preserving_sfm_torch.models.database import Database
    from privacy_preserving_sfm_torch.utils.synthetic import (
        match_quality, synthetic_matching_database,
    )

    path = os.path.join(workdir, "scene.db")
    t0 = time.perf_counter()
    scene = synthetic_matching_database(path, seed=0, **MATCHER)
    fresh = os.path.join(workdir, "fresh.db")
    shutil.copy(path, fresh)
    ids = scene.image_ids
    npairs = len(ids) * (len(ids) - 1) // 2
    phase("matcher", f"synthetic database: {len(ids)} images x "
          f"{MATCHER['num_features']} descriptors, {npairs} pairs, "
          f"{len(scene.true_matches)} overlapping, "
          f"{sum(len(m) for m in scene.true_matches.values())} true "
          f"correspondences, written in {time.perf_counter() - t0:.1f} s")

    for name in build.LAUNCHES:
        build.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    good = ppsfm.main(["exhaustive_matcher", "--database_path", path,
                       "--device", device.type])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    with Database(path) as db:
        precision, recall, stored = match_quality(db, scene)
    phase("matcher", f"exhaustive_matcher --device {device.type}: wall "
          f"{wall:.3f} s, {npairs / wall:.1f} pairs/s, {good}/{npairs} "
          f"pairs above threshold, {stored} matches stored, precision "
          f"{precision:.5f} (min {MIN_PRECISION}), recall {recall:.5f} "
          f"(min {MIN_RECALL}), peak device memory {peak / 2**20:.1f} MiB, "
          f"launches {launches} | {card}")
    check(launches["match_top2"] > 0,
          "kernel match_top2 was not launched by the matcher")
    check(len(_blobs(path)) == npairs, "a pair's matches were not written")
    check(0 < good < npairs, "no pair, or every pair, above threshold")
    check(precision >= MIN_PRECISION, "matcher precision below threshold")
    check(recall >= MIN_RECALL, "matcher recall below threshold")

    # 16 pairs again with the plain version on the card: eight neighbours
    # (above threshold) and eight far pairs (zeroed).
    pairs = [(ids[i], ids[i + 1]) for i in range(0, 64, 8)]
    pairs += [(ids[i], ids[i + 40]) for i in range(0, 24, 3)]
    plain_db = os.path.join(workdir, "plain.db")
    shutil.copy(fresh, plain_db)
    t0 = time.perf_counter()
    with Database(plain_db) as db:
        schedulers.match_pair_list(db, ids, pairs, device=device,
                                   plain=True, chunk=4)
    torch.cuda.synchronize()
    same = _blobs(plain_db, pairs) == _blobs(path, pairs)
    nonempty = sum(r[0] > 0 for r in _blobs(path, pairs).values())
    phase("matcher", f"{len(pairs)} pairs re-matched with the plain "
          f"version on the card in {time.perf_counter() - t0:.3f} s "
          f"({nonempty} above threshold): blobs byte-identical={same}")
    check(same, "plain-version blobs differ from the kernel's")

    # Bounded-memory block mode over the first 24 images.
    sub = ids[:24]
    sub_pairs = schedulers.exhaustive_pairs(sub)
    block_db = os.path.join(workdir, "block.db")
    shutil.copy(fresh, block_db)
    t0 = time.perf_counter()
    with Database(block_db) as db:
        schedulers.match_pair_list(db, sub, sub_pairs, device=device,
                                   max_resident_images=16)
    torch.cuda.synchronize()
    same = _blobs(block_db, sub_pairs) == _blobs(path, sub_pairs)
    phase("matcher", f"block mode (max_resident_images=16) over "
          f"{len(sub_pairs)} pairs of {len(sub)} images in "
          f"{time.perf_counter() - t0:.3f} s: blobs equal to the resident "
          f"run={same}")
    check(same, "block mode differs from resident mode")

    # The same run once more on a fresh database under torch.profiler.
    prof_db = os.path.join(workdir, "prof.db")
    shutil.copy(fresh, prof_db)
    device_split("matcher", card, lambda: ppsfm.main([
        "exhaustive_matcher", "--database_path", prof_db, "--device",
        device.type]), "match_top2_kernel")
    return launches


def match_keypoints(ka, kb, tol_px, tol_scale):
    """For each row (x, y, scale, angle) of ka, the row of kb within
    ``tol_px`` (both coordinates) and ``tol_scale`` relative scale with the
    nearest angle (the row of the same index among equals: SIFT may give
    one keypoint twice), or -1."""
    import numpy as np
    from scipy.spatial import cKDTree

    out = np.full(len(ka), -1)
    if not len(ka) or not len(kb):
        return out
    near = cKDTree(kb[:, :2]).query_ball_point(ka[:, :2], tol_px * 1.5)
    for i, cand in enumerate(near):
        cand = np.asarray(cand, int)
        cand = cand[(np.abs(kb[cand, :2] - ka[i, :2]).max(1) <= tol_px)
                    & (np.abs(kb[cand, 2] - ka[i, 2]) <= tol_scale
                       * ka[i, 2])]
        if len(cand):
            da = np.abs((kb[cand, 3] - ka[i, 3] + np.pi) % (2 * np.pi)
                        - np.pi)
            best = cand[da == da.min()]
            out[i] = i if i in best else best[0]
    return out


def span_split(name, card, run, prefixes=("sift.", "extraction.")):
    """``run()`` once under torch.profiler: the device's busy share, and
    each span's (named with one of ``prefixes``) host time, and the device
    time and number of the kernels launched inside it.  Reads the
    profiler's raw events (a kernel belongs to a span when the op that
    launched it started inside the span), not its parsed event tree,
    which takes minutes at a million launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    cpu = torch.autograd.DeviceType.CPU
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t_parse = time.perf_counter()
    op_start, host_names, spans, device = {}, set(), {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu:
            n = e.name()
            host_names.add(n)
            # Ops and spans link to nothing; the runtime's launch calls
            # link to their op and reuse its ids in another space.
            if e.linked_correlation_id() == 0:
                op_start[e.correlation_id()] = e.start_ns()
            if n.startswith(prefixes):
                spans.setdefault(n, []).append((e.start_ns(), e.end_ns()))
        elif e.duration_ns() > 0:
            device.append((e.name(), e.duration_ns(),
                           e.linked_correlation_id()))
    # Device copies of the spans' ranges are not kernels.
    device = [(n, d, op_start.get(c, -1)) for n, d, c in device
              if n not in host_names]
    dur = np.array([d[1] for d in device], np.float64) / 1e6  # ms
    launched = np.array([d[2] for d in device], np.int64)
    total = float(dur.sum())
    split = []
    for k, ranges in spans.items():
        ranges = np.array(sorted(ranges), np.int64)
        i = np.searchsorted(ranges[:, 0], launched, "right") - 1
        inside = (i >= 0) & (launched < ranges[np.maximum(i, 0), 1])
        host = float((ranges[:, 1] - ranges[:, 0]).sum()) / 1e6
        split.append((k, host, float(dur[inside].sum()), int(inside.sum()),
                      len(ranges)))
    split = "; ".join(
        f"{k} host {h:.2f} ms, device {d:.2f} ms "
        f"({100 * d / max(total, 1e-9):.1f} %, {c} launches) x{n}"
        for k, h, d, c, n in sorted(split, key=lambda x: -x[2]))
    by_name = {}
    for (kname, _, _), ms in zip(device, dur):
        t, c = by_name.get(kname, (0.0, 0))
        by_name[kname] = (t + ms, c + 1)
    top = "; ".join(f"{k[:50]} {t:.2f} ms x{c}" for k, (t, c) in sorted(
        by_name.items(), key=lambda kv: -kv[1][0])[:6])
    phase(name, f"under torch.profiler: wall {wall * 1e3:.2f} ms, kernel "
          f"time {total:.2f} ms (busy {100 * total / 1e3 / wall:.1f} %, "
          f"{len(device)} launches); spans: {split}; top kernels: {top}; "
          f"split in {time.perf_counter() - t_parse:.1f} s | {card}")
    check(total > 0, "the profiled run launched nothing on the card")


def lift_card_cpu(device, path, seed=3):
    """SIFT of the image at ``path`` on ``device`` and on the CPU, each
    lifted by ``lift_features`` from a fresh CPU generator seeded with
    ``seed`` (the front end's draws, made on the CPU for every device).
    Returns, on the keypoints ``match_keypoints`` pairs (0.01 px, 1e-4
    relative scale), the share whose aligned flags agree, the largest
    distance of their lines and the share within ``LIFT_BAR[1]``."""
    import numpy as np
    import torch

    from privacy_preserving_sfm_torch.features import extraction, sift

    img = torch.from_numpy(extraction.load_image_grayscale_u8(path))
    model, params = extraction.read_camera_model_file(path)
    gravity = extraction.read_gravity_file(path)
    out = []
    for dev in (torch.device("cpu"), device):
        feats = sift.extract_sift(extraction.normalize_u8(img[None].to(dev)))
        lifted = extraction.lift_features(
            feats, model,
            torch.tensor(params, dtype=torch.float32, device=dev)[None],
            torch.tensor(gravity, dtype=torch.float32, device=dev)[None],
            0.5, [torch.Generator().manual_seed(seed)])
        out.append([t[0].cpu().numpy() for t in (
            feats.keypoints, feats.valid, lifted.aligned, lifted.lines)])
    (kc, vc, ac, lc), (kg, vg, ag, lg) = out
    ic, ig = np.nonzero(vc)[0], np.nonzero(vg)[0]
    m = match_keypoints(kc[ic], kg[ig], 0.01, 1e-4)
    j = np.nonzero(m >= 0)[0]
    a, b = ic[j], ig[m[j]]
    dl = np.abs(lc[a] - lg[b]).max(1)
    return dict(keypoints=(len(ic), len(ig)), matched=len(j),
                aligned=float((ac[a] == ag[b]).mean()),
                line_max=float(dl.max()),
                line_share=float((dl <= LIFT_BAR[1]).mean()))


def frontend_quality(device, ds, opts):
    """``tools/frontend_eval.py``'s repeatability and match inlier rate on
    the rendered plane pairs ``SIFT_PAIRS`` of ``ds``, through the port's
    SIFT and matcher on ``device``."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from privacy_preserving_sfm_torch.features import extraction, matching
    from privacy_preserving_sfm_torch.features import sift
    from privacy_preserving_sfm_torch.utils.synthetic import plane_homography

    root, meta = ds
    feats = {}
    for name in sorted({n for p in SIFT_PAIRS for n in p}):
        img = extraction.load_image_grayscale(os.path.join(root, name))
        f = sift.extract_sift(torch.from_numpy(img)[None].to(device), opts)
        feats[name] = [t[0] for t in (f.keypoints, f.descriptors, f.valid)]
    rep, inl, nm = [], [], []
    for na, nb in SIFT_PAIRS:
        (kpa, da, va), (kpb, db_, vb) = feats[na], feats[nb]
        H_ab = (plane_homography(meta, *meta["poses"][nb])
                @ np.linalg.inv(plane_homography(meta, *meta["poses"][na])))
        ka, kb = kpa.cpu().numpy(), kpb.cpu().numpy()
        xa = ka[va.cpu().numpy(), :2]
        xb = kb[vb.cpu().numpy(), :2]
        hom = np.concatenate([xa, np.ones((len(xa), 1))], 1) @ H_ab.T
        xa_b = hom[:, :2] / hom[:, 2:]
        vis = ((xa_b[:, 0] >= 0) & (xa_b[:, 0] < meta["width"])
               & (xa_b[:, 1] >= 0) & (xa_b[:, 1] < meta["height"]))
        d, _ = cKDTree(xb).query(xa_b[vis])
        rep.append(float((d <= SIFT_TOL).mean()))
        res = matching.match_descriptors(da, db_, va, vb)
        idx2 = res.matches.cpu().numpy()
        rows = np.nonzero(idx2 >= 0)[0]
        m1 = np.concatenate([ka[rows, :2], np.ones((len(rows), 1))], 1)
        m1 = m1 @ H_ab.T
        err = np.linalg.norm(m1[:, :2] / m1[:, 2:] - kb[idx2[rows], :2],
                             axis=1)
        inl.append(float((err <= SIFT_TOL).mean()) if len(err) else 0.0)
        nm.append(len(rows))
    return float(np.mean(rep)), float(np.mean(inl)), float(np.mean(nm))


def phase_sift(device, card, workdir):
    """The front end on the card: throughput at bench.py's shape with its
    span split, the card against the CPU and against itself on a rendered
    plane image, repeatability and inlier rate against the reference
    package's on the same rendered pairs, and one image at the default
    cap."""
    import numpy as np
    import torch

    from privacy_preserving_sfm_torch.features import extraction, sift
    from privacy_preserving_sfm_torch.utils.synthetic import render_dataset

    # Throughput at bench.py:129-147's shape: B seeded random images.
    B, h, w = SIFT_BENCH
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.random((B, h, w), dtype=np.float32)
                            ).to(device)
    params = torch.tensor([[500.0, w / 2, h / 2]] * B, device=device)
    grav = torch.tensor([[0.0, 1.0, 0.0]] * B, device=device)
    opts = sift.SiftOptions(max_num_features=2048)

    def bench():
        gens = [torch.Generator().manual_seed(i) for i in range(B)]
        return extraction.extract_and_lift_batch(
            imgs, "SIMPLE_PINHOLE", params, grav, gens, opts)

    t0 = time.perf_counter()
    lf = bench()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        bench()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    phase("sift", f"extract_and_lift_batch B={B} {w}x{h} "
          f"max_num_features=2048: first call {first:.3f} s, warm "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms: best "
          f"{B / min(times):.1f} images/s; valid "
          f"{lf.valid.sum(1).tolist()} | {card}")
    check(bool((lf.valid.sum(1) > 100).all()), "too few features")
    span_split("sift", card, bench)

    # The card against the CPU, and against itself, on a rendered plane.
    ds = (os.path.join(workdir, "plane"), render_dataset(
        os.path.join(workdir, "plane"), 7, 640, 480, seed=0, scene="plane"))
    img = extraction.load_image_grayscale(os.path.join(ds[0], "img003.png"))
    dflt = sift.SiftOptions()
    t0 = time.perf_counter()
    cpu = sift.extract_sift(torch.from_numpy(img)[None], dflt)
    cpu_s = time.perf_counter() - t0
    a = sift.extract_sift(torch.from_numpy(img)[None].to(device), dflt)
    b = sift.extract_sift(torch.from_numpy(img)[None].to(device), dflt)
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    vc, vg = cpu.valid[0].numpy(), a.valid[0].cpu().numpy()
    kc, kg = cpu.keypoints[0].numpy()[vc], a.keypoints[0].cpu().numpy()[vg]
    m = match_keypoints(kc, kg, 0.01, 1e-4)
    j = np.nonzero(m >= 0)[0]
    dc = cpu.descriptors[0].numpy()[vc].astype(int)[j]
    dg = a.descriptors[0].cpu().numpy()[vg].astype(int)[m[j]]
    dq = np.abs(dc - dg).max(1)
    matched, close = float((m >= 0).mean()), float((dq <= 2).mean())
    phase("sift", f"rendered 640x480 plane, default options: CPU "
          f"{len(kc)} keypoints ({cpu_s:.2f} s), card {len(kg)}; "
          f"{matched:.5f} of the CPU's within 0.01 px and 1e-4 relative "
          f"scale of the card's (min 0.98), {close:.5f} of those within 2 "
          f"descriptor quanta (min 0.99; L-inf histogram "
          f"{np.bincount(dq).tolist()[:6]}); two card runs bit-equal={same}")
    check(matched >= 0.98, "card keypoints disagree with the CPU's")
    check(close >= 0.99, "card descriptors disagree with the CPU's")
    check(same, "two card runs differ")

    # The lift: the card draws the CPU's samples and writes its lines.
    lift = lift_card_cpu(device, os.path.join(ds[0], "img003.png"))
    phase("sift", f"line lift, card against CPU (draws from one CPU "
          f"generator seed): keypoints (CPU, card) {lift['keypoints']}, "
          f"{lift['matched']} paired within 0.01 px (min {LIFT_BAR[0]} of "
          f"the CPU's): "
          f"aligned flags agree on {lift['aligned']:.5f} (min "
          f"{LIFT_BAR[0]}), lines within {LIFT_BAR[1]} on "
          f"{lift['line_share']:.5f}, largest distance "
          f"{lift['line_max']:.3e} (max {LIFT_BAR[1]})")
    check(lift["matched"] >= LIFT_BAR[0] * lift["keypoints"][0],
          "the card's keypoints of the lift disagree with the CPU's")
    check(lift["aligned"] >= LIFT_BAR[0],
          "the card's aligned flags disagree with the CPU's")
    check(lift["line_max"] <= LIFT_BAR[1],
          "the card's lines disagree with the CPU's")

    # Repeatability and inlier rate (tools/frontend_eval.py's measures).
    rep, inl, nm = frontend_quality(device, ds, sift.SiftOptions(
        max_num_features=4096))
    phase("sift", f"quality: repeatability {rep:.5f} (min "
          f"{MIN_REPEATABILITY}), match inlier rate {inl:.5f} (min "
          f"{MIN_INLIER_RATE}), {nm:.1f} matches a pair over "
          f"{len(SIFT_PAIRS)} pairs")
    check(rep >= MIN_REPEATABILITY, "repeatability below the bar")
    check(inl >= MIN_INLIER_RATE, "inlier rate below the bar")

    # One image at the size the default cap allows, default options.
    big = torch.from_numpy(rng.integers(0, 256, (1,) + SIFT_CAP, np.uint8)
                           ).to(device)
    p1, g1 = params[:1] * 5, grav[:1]

    def cap():
        return extraction.extract_and_lift_batch(
            big, "SIMPLE_PINHOLE", p1, g1, [torch.Generator()], dflt)

    cap()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = cap()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    phase("sift", f"{SIFT_CAP[1]}x{SIFT_CAP[0]} image, default options: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms, "
          f"{int(out.valid.sum())} features, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB | {card}")


def _feature_rows(path):
    import sqlite3

    con = sqlite3.connect(path)
    try:
        return {t: con.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
                for t in ("images", "descriptors", "line_features",
                          "gravity_directions")}
    finally:
        con.close()


def phase_extractor(device, card, workdir):
    """``feature_extractor`` with its defaults on rendered box images, in a
    fresh process with torch's default flags, then again in this process
    (TF32 off throughout); then ``exhaustive_matcher`` on its database.
    Returns match_top2's launches in the matcher run."""
    import numpy as np
    import torch

    from privacy_preserving_sfm_torch.exe import ppsfm
    from privacy_preserving_sfm_torch.kernels import build
    from privacy_preserving_sfm_torch.models.database import Database
    from privacy_preserving_sfm_torch.utils.synthetic import render_dataset

    n, (h, w) = EXTRACTOR
    images = os.path.join(workdir, "images")
    t0 = time.perf_counter()
    render_dataset(images, n, w, h, seed=0, scene="box")
    phase("extractor", f"rendered {n} box images {w}x{h} in "
          f"{time.perf_counter() - t0:.1f} s")

    def cli(db):
        return ["feature_extractor", "--database_path", db, "--image_path",
                images, "--device", device.type]

    fresh = os.path.join(workdir, "fresh.db")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "privacy_preserving_sfm_torch"
                          ".exe"] + cli(fresh), cwd=REPO, timeout=600,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"feature_extractor failed: {out.stderr}")
    batches = re.findall(r"\[batch of (\d+): device ([\d.]+)s", out.stdout)
    peak = re.search(r"peak device memory ([\d.]+) MiB", out.stdout)
    phase("extractor", f"feature_extractor --device {device.type} in a "
          f"fresh process (torch's default flags): wall {wall:.2f} s, "
          f"batches (images, device s) {batches}, peak device memory "
          f"{peak.group(1) if peak else '?'} MiB | {card}")

    again = os.path.join(workdir, "again.db")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ppsfm.main(cli(again))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    same = _feature_rows(fresh) == _feature_rows(again)
    phase("extractor", f"the same run in this process (TF32 off): wall "
          f"{wall:.2f} s, {n / wall:.2f} images/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; rows "
          f"byte-identical to the fresh process's={same} | {card}")
    check(same, "a rerun with the same seed wrote other rows")

    with Database(fresh) as db:
        ids = sorted(db.read_images())
        check(len(ids) == n, "an image has no rows")
        counts, worst_n, worst_g = [], 0.0, 0.0
        for iid in ids:
            k = db.count_descriptors(iid)
            raw = np.frombuffer(db.conn.execute(
                "SELECT data FROM line_features WHERE image_id = ?",
                (iid,)).fetchone()[0], np.float32).reshape(-1, 4)
            aligned = raw[:, 3] > 0
            g = db.read_gravity(iid)
            check(k == len(raw) > 0, "descriptor and line rows differ")
            check(aligned.sum() == k // 2, "aligned count is not floor(n/2)")
            worst_n = max(worst_n, float(np.abs(np.linalg.norm(
                raw[:, :2], axis=1) - 1).max()))
            worst_g = max(worst_g, float(np.abs(raw[aligned, :3] @ g).max()))
            counts.append(k)
    phase("extractor", f"rows: {counts} features; max | ||l[:2]|| - 1 | "
          f"{worst_n:.2e} (tol 1e-6), max |l.g| on aligned lines "
          f"{worst_g:.2e} (tol 1e-5)")
    check(worst_n <= 1e-6 and worst_g <= 1e-5, "line rows out of tolerance")

    for name in build.LAUNCHES:
        build.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    good = ppsfm.main(["exhaustive_matcher", "--database_path", fresh,
                       "--device", device.type])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    npairs = n * (n - 1) // 2
    with Database(fresh) as db:
        neighbours = [len(db.read_matches(a, b))
                      for a, b in zip(ids[:-1], ids[1:])]
    phase("extractor", f"exhaustive_matcher --device {device.type}: wall "
          f"{wall:.3f} s, {npairs / wall:.1f} pairs/s, {good}/{npairs} "
          f"pairs above threshold; neighbouring pairs' matches "
          f"{neighbours}; launches {launches} | {card}")
    check(launches["match_top2"] > 0, "match_top2 was not launched")
    check(min(neighbours) >= 15, "a neighbouring pair is under "
          "min_num_matches")
    return launches["match_top2"]


def _model_bytes(path):
    out = {}
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def init_errors(out_dir, gt):
    """The model written to ``out_dir``: (model, registered names, rotation
    and translation-direction errors in degrees against ``gt``, up to
    gauge)."""
    import numpy as np

    from privacy_preserving_sfm_torch.models.reconstruction import (
        Reconstruction,
    )
    from privacy_preserving_sfm_torch.utils.synthetic import (
        gauge_align_errors,
    )

    rec = Reconstruction.read_text(out_dir)
    names = [rec.images[i].name for i in rec.reg_image_ids]
    check(len(names) == 4, f"{len(names)} images registered, not 4")
    poses = np.stack([rec.images[i].projection_matrix()
                      for i in rec.reg_image_ids])
    rot, dirn = gauge_align_errors(np.stack([gt[n][0] for n in names]),
                                   np.stack([gt[n][1] for n in names]),
                                   poses)
    return rec, names, float(np.degrees(rot)), float(np.degrees(dirn))


@contextlib.contextmanager
def init_stage_peaks(record):
    """Inside it, each of the mapper's three init stages resets the card's
    peak memory when it starts and keeps its own peak (bytes) in
    ``record`` under its span's name; ``record["sets"]`` is the last
    candidate sets the initializer solved."""
    import torch

    from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
        IncrementalMapper,
    )

    spans = {"assemble_init_sets": "init.assemble",
             "solve_init_sets": "init.solve",
             "register_initial_poses": "init.triangulate"}
    saved = {k: getattr(IncrementalMapper, k) for k in spans}

    def wrap(name, fn):
        def stage(self, *args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            record[spans[name]] = max(record.get(spans[name], 0),
                                      torch.cuda.max_memory_allocated())
            if name == "solve_init_sets":
                record["sets"] = args[0]
            return out
        return stage

    for name, fn in saved.items():
        setattr(IncrementalMapper, name, wrap(name, fn))
    try:
        yield record
    finally:
        for name, fn in saved.items():
            setattr(IncrementalMapper, name, fn)


def init_chunk_numbers(device, sets, num_samples):
    """The numbers per entry that the initializer's two chunk bodies
    (``_score_models``, ``_score_offsets``) hold at their peak on the card,
    float32, at the set and track counts of ``sets`` and the chunk sizes
    the initializer takes for them: (four-view numbers, offset numbers,
    models a four-view chunk, hypotheses an offset chunk)."""
    import torch

    from privacy_preserving_sfm_torch.init import initializer as ti

    s, _, n, _ = sets.aligned.shape
    m = sets.random.shape[2]
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen, dtype=torch.float64).to(
            device=device, dtype=torch.float32)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bool, device=device)

    def peak_numbers(fn, entries):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        used = torch.cuda.max_memory_allocated() - base
        del out
        return used / (entries * 4)

    k = 16 * ti._chunk(num_samples, s * 16 * n, 4, ti.FOURVIEW_NUMBERS)
    cams, x_all, thresh = rand(s, k, 4, 2, 3), rand(s, 4, n, 2), rand(s)
    four = peak_numbers(lambda: ti._score_models(
        cams, x_all, thresh, ones(s, n), ones(s, k)), s * k * n)
    del cams, x_all
    c = ti._chunk(num_samples, s * m, 4, ti.OFFSET_NUMBERS)
    poses, rg, lines = rand(s, 4, 3, 4), rand(s, 4, 3, 3), rand(s, 4, m, 3)
    idx = torch.randint(0, m, (s, c, 3), generator=gen).to(device)
    off = peak_numbers(lambda: ti._score_offsets(
        poses, rg, lines, ones(s, m), thresh, idx), s * c * m)
    return four, off, k, c


def phase_line_init(device, card, workdir, db):
    """``line_initializer`` on phase ``extractor``'s database: twice on the
    card (4 images, >= MIN_INIT_POINTS points, byte-identical models, the
    poses within LINE_INIT_BAR of the rendering's truth, the peak memory of
    each ``init.*`` stage, and the numbers per entry of the initializer's
    chunk bodies held to the constants that size the chunks), once on the
    CPU (the same images, within the bar), and once more on the card under
    torch.profiler, split by the mapper's ``init.*`` spans."""
    import torch

    from privacy_preserving_sfm_torch.exe import ppsfm
    from privacy_preserving_sfm_torch.init import initializer as ti
    from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
        MapperOptions,
    )
    from privacy_preserving_sfm_torch.utils.synthetic import read_gt_poses

    gt = read_gt_poses(os.path.join(workdir, "images", "gt_poses.txt"))
    stages = {}

    def run(dev, out):
        on_card = dev.type == "cuda"
        stages.clear()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with (init_stage_peaks(stages) if on_card
              else contextlib.nullcontext()):
            mapper = ppsfm.main(["line_initializer", "--database_path", db,
                                 "--output_path", out, "--device", dev.type])
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(mapper.device.type == dev.type
              and mapper.triangulator.device.type == dev.type,
              f"line_initializer ran on {mapper.device}, not {dev.type}")
        times = ", ".join(f"{k} {v:.3f} s" for k, v in
                          list(mapper.phase_times.items())
                          + list(mapper.triangulator.phase_times.items()))
        peak = "n/a"
        if on_card:
            each = {k: v for k, v in stages.items() if k.startswith("init.")}
            top = max(each, key=each.get)
            peak = (f"{max(each.values()) / 2**20:.1f} MiB, set by {top} ("
                    + ", ".join(f"{k} {v / 2**20:.1f} MiB"
                                for k, v in each.items()) + ")")
        return wall, times, peak

    outs = [os.path.join(workdir, f"init_card{k}") for k in range(2)]
    walls = []
    for out in outs:
        wall, times, peak = run(device, out)
        walls.append(wall)
        rec, names, rot, dirn = init_errors(out, gt)
        phase("line_init", f"line_initializer --device {device.type}: wall "
              f"{wall:.3f} s ({times}), peak device memory {peak}; images "
              f"{names}, {len(rec.points3d)} points; rotation error "
              f"{rot:.4f} deg, translation direction error {dirn:.4f} deg "
              f"(bar {LINE_INIT_BAR[0]} and {LINE_INIT_BAR[1]} deg) | {card}")
        check(len(rec.points3d) >= MIN_INIT_POINTS,
              f"{len(rec.points3d)} points, under {MIN_INIT_POINTS}")
        check(rot <= LINE_INIT_BAR[0] and dirn <= LINE_INIT_BAR[1],
              "the card's poses miss the bar")
    same = _model_bytes(outs[0]) == _model_bytes(outs[1])
    phase("line_init", f"two card runs byte-identical={same}")
    check(same, "two card runs wrote different models")
    if device.type == "cuda":
        sets = stages["sets"]
        four, off, k, c = init_chunk_numbers(
            device, sets, MapperOptions().init_num_samples)
        phase("line_init", f"chunk bodies at S={sets.aligned.shape[0]}, "
              f"N={sets.aligned.shape[2]}, M={sets.random.shape[2]}: "
              f"_score_models {four:.2f} numbers an entry at {k} models "
              f"(FOURVIEW_NUMBERS {ti.FOURVIEW_NUMBERS}), _score_offsets "
              f"{off:.2f} at {c} hypotheses (OFFSET_NUMBERS "
              f"{ti.OFFSET_NUMBERS}) | {card}")
        check(four <= ti.FOURVIEW_NUMBERS and off <= ti.OFFSET_NUMBERS,
              "a chunk body holds more than its constant sizes it for")

    out = os.path.join(workdir, "init_cpu")
    wall, times, _ = run(torch.device("cpu"), out)
    rec_c, names_c, rot_c, dir_c = init_errors(out, gt)
    phase("line_init", f"line_initializer --device cpu: wall {wall:.3f} s "
          f"({times}); images {names_c}, {len(rec_c.points3d)} points; "
          f"rotation error {rot_c:.4f} deg, translation direction error "
          f"{dir_c:.4f} deg | {card}")
    check(names_c == names, "the CPU registered another image set")
    check(rot_c <= LINE_INIT_BAR[0] and dir_c <= LINE_INIT_BAR[1],
          "the CPU's poses miss the bar")

    span_split("line_init", card, lambda: run(
        device, os.path.join(workdir, "init_profiled")), prefixes=("init.",))
    return walls


def model_errors(out_dir, gt):
    """The model in ``out_dir``: (model, registered names, rotation and
    translation-direction errors in degrees of every pose relative to the
    first by name, against ``gt`` up to gauge)."""
    import numpy as np

    from privacy_preserving_sfm_torch.models.reconstruction import (
        Reconstruction,
    )
    from privacy_preserving_sfm_torch.utils.synthetic import (
        gauge_align_errors,
    )

    rec = Reconstruction.read_text(out_dir)
    ids = sorted(rec.reg_image_ids, key=lambda i: rec.images[i].name)
    names = [rec.images[i].name for i in ids]
    check(len(names) >= 2, f"{len(names)} images registered")
    poses = np.stack([rec.images[i].projection_matrix() for i in ids])
    rot, dirn = gauge_align_errors(np.stack([gt[n][0] for n in names]),
                                   np.stack([gt[n][1] for n in names]),
                                   poses)
    return rec, names, float(np.degrees(rot)), float(np.degrees(dirn))


# The mapper's methods that open a top-level span, by span name.
MAPPER_SPANS = {"register_initial_line_images": "init",
                "register_next_image": "mapper.register",
                "triangulate_image": "mapper.triangulate",
                "complete_tracks": "mapper.triangulate",
                "merge_tracks": "mapper.triangulate",
                "adjust_local_bundle": "mapper.local_ba (with its filter)",
                "adjust_global_bundle": "mapper.global_ba",
                "filter_points": "mapper.filter",
                "filter_images": "mapper.filter"}


@contextlib.contextmanager
def mapper_span_peaks(record):
    """Inside it, each of the mapper's top-level span methods resets the
    card's peak memory when it starts and keeps the largest peak (bytes)
    of its span in ``record``; none of them calls another."""
    import torch

    from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
        IncrementalMapper,
    )

    saved = {k: getattr(IncrementalMapper, k) for k in MAPPER_SPANS}

    def wrap(name, fn):
        def method(self, *args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            span = MAPPER_SPANS[name]
            record[span] = max(record.get(span, 0),
                               torch.cuda.max_memory_allocated())
            return out
        return method

    for name, fn in saved.items():
        setattr(IncrementalMapper, name, wrap(name, fn))
    try:
        yield record
    finally:
        for name, fn in saved.items():
            setattr(IncrementalMapper, name, fn)


@contextlib.contextmanager
def mapper_ba_capture(record):
    """Inside it, every SoA solve is kept in ``record`` as (valid
    observations, problem, camera model, options, result) when it is the
    largest so far of its kind: "local" (some points frozen, as local BA
    freezes them) or "global" (every point variable)."""
    from privacy_preserving_sfm_torch.optim import ba as ba_mod
    from privacy_preserving_sfm_torch.optim import ba_soa

    solve = ba_soa.bundle_adjust_soa

    def keep(problem, camera_model, options=ba_mod.BAOptions(), *,
             plain=False):
        out = solve(problem, camera_model, options, plain=plain)
        kind = "local" if bool((problem.point_mask == 0).any()) else "global"
        nobs = int((problem.obs_weight > 0).sum())
        if nobs > record.get(kind, (0,))[0]:
            # Kept on the host, off the card's peaks by span.
            record[kind] = (nobs, to_device(problem, "cpu"), camera_model,
                            options, tuple(to_device(out[:3], "cpu"))
                            + out[3:])
        return out

    ba_soa.bundle_adjust_soa = keep
    try:
        yield record
    finally:
        ba_soa.bundle_adjust_soa = solve


def to_device(tensors, device):
    """A tuple of tensors (a problem's NamedTuple too) on ``device``."""
    return type(tensors)(*(t.to(device) for t in tensors)) \
        if hasattr(tensors, "_fields") else tuple(
            t.to(device) for t in tensors)


def pose_differences(qa, ta, qb, tb, free):
    """Largest rotation angle (degrees) between two pose sets and largest
    camera-centre distance relative to the free cameras' mean distance
    from the problem's first camera, over the ``free`` cameras; then the
    same centre distance after the least-squares scale of the first set's
    centres about the first camera, and that scale."""
    import numpy as np

    from privacy_preserving_sfm_torch.ops.lie_np import quat_to_rotmat

    qa, ta, qb, tb = (a.double().cpu().numpy() for a in (qa, ta, qb, tb))
    dot = np.abs((qa * qb).sum(1)) / (np.linalg.norm(qa, axis=1)
                                     * np.linalg.norm(qb, axis=1))
    rot = np.degrees(2.0 * np.arccos(np.minimum(dot, 1.0)))[free].max()

    def centres(q, t):
        return np.stack([-quat_to_rotmat(qc).T @ tc
                         for qc, tc in zip(q, t)])

    a, b = (c - c[0] for c in (centres(qa, ta), centres(qb, tb)))
    scale = max(np.linalg.norm(a[free], axis=1).mean(), 1e-300)
    s = float((a * b).sum() / max((a * a).sum(), 1e-300))
    return (float(rot), float(np.linalg.norm(a - b, axis=1)[free].max()
                              / scale),
            float(np.linalg.norm(s * a - b, axis=1)[free].max() / scale), s)


def pcg_schur_plain_kernel_order(S_corr, dHcc, minv_blocks, rhs, iters):
    """``pcg_schur_plain`` with S p formed as ``kernels/schur_pcg.cu``
    forms it, D p - S_corr p (D = blockdiag(dHcc)), where the plain version
    forms S = D - S_corr first.  Where D's blocks and S_corr's diagonal
    blocks nearly cancel, that difference is exact and the two products
    are not, so the orders part by more than two summation orders do."""
    import torch

    from privacy_preserving_sfm_torch.optim import schur_pcg

    C = dHcc.shape[0]

    def blocks(M, v):
        return torch.einsum("cij,cj->ci", M, v.reshape(C, 6)).reshape(-1)

    z = blocks(minv_blocks, rhs)
    x, r, p = torch.zeros_like(rhs), rhs, z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = blocks(dHcc, p) - S_corr @ p
        alpha = rz / schur_pcg._guard(torch.sum(p * Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = blocks(minv_blocks, r)
        rz_new = torch.sum(r * z)
        p = z + rz_new / schur_pcg._guard(rz) * p
        rz = rz_new
    return x


def check_mapper_ba(device, card, record, name="mapper",
                    kinds=("local", "global")):
    """The mapper's largest local BA (frozen extra cameras and frozen
    points) and largest global BA (of ``kinds``, both unless told), held
    against the plain route on the card.  Each is solved again with the
    kernels, which must give the mapper's own result bit for bit; every
    Gram and PCG call of that solve is checked against its plain version on
    the same inputs: the Gram at phase ``gram``'s tolerances (1e-4 float32,
    1e-10 float64, of the largest entry); the PCG against a float64 plain
    solve: in float64, call by call, at phase ``pcg``'s 1e-10 or, where
    the call's system is more sensitive, four times its spread: the larger
    distance from the card's plain float64 solve of the host's (another
    summation order) and of ``pcg_schur_plain_kernel_order``'s (S p formed
    as the kernel forms it); in float32 at 1e-4 or, where the solve's
    systems are more sensitive, four times the largest error of the plain
    float32 solves of the same calls.  Each precision is held on its own:
    a call whose float64 plain result is non-finite (the solver handed it
    non-finite inputs, a step it zeroes) holds the float64 kernel result
    to being non-finite too, and a call whose float32 kernel result is
    non-finite (float32 overflow) holds it to being non-finite if and only
    if the plain float32 result is; those calls are printed with whether
    their inputs were finite, and at least one call of each kernel must
    be finite.  Then the whole problem in float32 through the plain
    versions (plain=True) and in float64 through them: final costs within
    1e-3 of the float64 one, every free camera's rotation within
    MAPPER_BA_TOL[0] degrees and centre within MAPPER_BA_TOL[1] of the
    float64 one after the least-squares scale about the first camera
    (``pose_differences``; the distance before it and the scale are
    printed), the kernels' scale no farther from 1 than MAPPER_BA_TOL[1]
    or four times the plain float32 solve's.  That scale is the one
    direction a float32 LM leaves unresolved: on box50d's global BA (C =
    50, 145,154 observations) every float32 solve, the kernels', the
    plain one and the reference package's on the same problem, stops
    4e-4 short of the float64 scale within float32's resolution of the
    cost (0.9996, 8e-4 of centre before it, 7e-5 after).  The PCG
    launches of the kernel re-solve are counted by path (cluster, grid).
    Every kind is held before a failure raises.  Prints under phase
    ``name``.  Returns, for the Gram and the PCG, the largest relative
    error of the float32 calls, ``mapper_shape_times`` of each kind (keys
    ``mapper_*`` for the local BA, ``global_*`` for the global one) and,
    for the PCG, the re-solves' launches by path."""
    import torch

    from privacy_preserving_sfm_torch.kernels import build
    from privacy_preserving_sfm_torch.optim import ba as ba_mod
    from privacy_preserving_sfm_torch.optim import ba_soa, schur_pcg

    t_start = time.perf_counter()
    check("local" in record or "local" not in kinds,
          "the mapper ran no SoA local BA with frozen points")
    check("global" in record or "global" not in kinds,
          "the mapper ran no SoA global BA")
    worst = {"schur_gram": 0.0, "schur_pcg": 0.0}
    times = {"schur_gram": {}, "schur_pcg": {}}
    paths = collections.Counter()
    failures = []  # every kind is held before the first failure raises

    def hold(ok, msg):
        if not ok:
            failures.append(msg)

    for kind in kinds:
        nobs, problem, model, options, (q0, t0, X0, s0) = record[kind]
        problem = to_device(problem, device)
        q0, t0, X0 = to_device((q0, t0, X0), device)
        P, K = problem.obs_cam.shape
        C = problem.qvecs.shape[0]
        free = (problem.cam_dof_mask.sum(1) > 0).cpu().numpy()
        frozen_points = int((problem.point_mask == 0).sum())
        grams, pcgs = [], []
        gram, pcg = schur_pcg.gram_soa, schur_pcg.pcg_schur

        def gram_keep(lh, gl, cam, num_cams, precision="f32", plan=None):
            grams.append((lh.clone(), gl.clone(), cam.clone(), precision))
            return gram(lh, gl, cam, num_cams, precision, plan=plan)

        def pcg_keep(S, dH, minv, rhs, iters, path="auto"):
            pcgs.append((S.clone(), dH.clone(), minv.clone(), rhs.clone(),
                         iters))
            return pcg(S, dH, minv, rhs, iters, path)

        schur_pcg.gram_soa, schur_pcg.pcg_schur = gram_keep, pcg_keep
        before = dict(build.LAUNCHES)
        try:
            q, t, X, s = ba_soa.bundle_adjust_soa(problem, model, options)
        finally:
            schur_pcg.gram_soa, schur_pcg.pcg_schur = gram, pcg
        torch.cuda.synchronize()
        took = {p: build.LAUNCHES[f"schur_pcg_{p}"] - before[f"schur_pcg_{p}"]
                for p in ("cluster", "grid")}
        paths.update(took)
        same = (torch.equal(q, q0) and torch.equal(t, t0)
                and torch.equal(X, X0) and s == s0)
        check(len(grams) > 0 and len(pcgs) > 0,
              f"the {kind} BA solve made no Gram or PCG call")

        # Each precision is held on its own.  Float64: every call whose
        # float64 plain result is finite holds the kernel's to the
        # tolerance; a call whose float64 plain result is not (the solver
        # handed it non-finite inputs, a step it zeroes) holds the kernel's
        # to being non-finite too.  Float32: a call whose float32 kernel
        # result is non-finite (float32 overflows where float64 does not)
        # holds it to being non-finite if and only if the plain float32
        # result is; the other calls are held to the tolerance.
        def finite(*ts):
            return all(bool(torch.isfinite(t).all()) for t in ts)

        def finite_or_inf(e):
            return e if math.isfinite(e) else math.inf

        # (kernel, call, precision, inputs finite, non-finite as the plain
        # version is) of each call held by finiteness.
        odd = []
        g32s, g64s = [], []
        for i, (lh, gl, cam, precision) in enumerate(grams):
            S_ref, r_ref = schur_pcg.gram_soa_plain(lh.double(), gl.double(),
                                                    cam, C)
            scales = (max(float(S_ref.abs().max()), 1e-300),
                      max(float(r_ref.abs().max()), 1e-300))
            S32, r32 = gram(lh, gl, cam, C, precision)
            S64, r64 = gram(lh.double(), gl.double(), cam, C)
            torch.cuda.synchronize()

            def err(S, r):
                return finite_or_inf(max(
                    float((S.double() - S_ref).abs().max()) / scales[0],
                    float((r.double() - r_ref).abs().max()) / scales[1]))

            if finite(S_ref, r_ref):
                g64s.append(err(S64, r64))
            else:
                odd.append(("Gram", i, "f64", finite(lh, gl),
                            not finite(S64, r64)))
            e32 = err(S32, r32)
            if math.isfinite(e32):
                g32s.append(e32)
            else:
                S32p, r32p = schur_pcg.gram_soa_plain(lh, gl, cam, C,
                                                      precision)
                odd.append(("Gram", i, "f32", finite(lh, gl),
                            finite(S32, r32) == finite(S32p, r32p)))
        # Float64 PCG, each call whose card plain float64 solve is finite:
        # (kernel, host plain, kernel-order plain, kernel from the
        # kernel-order plain), each a distance from the card's plain float64
        # solve (the last from the kernel-order one) over its norm.  The
        # host's solve is the same arithmetic summed in another order; the
        # kernel-order solve forms S p as D p - S_corr p, as the kernel
        # does.  A call's spread is the larger of those two distances.
        p32s, plain32s, calls64, replays = [], [], [], []
        for i, (S, dH, minv, rhs, iters) in enumerate(pcgs):
            system64 = [a.double() for a in (S, dH, minv, rhs)]
            x_ref = schur_pcg.pcg_schur_plain(*system64, iters)
            norm = max(float(x_ref.norm()), 1e-300)

            def rel(x, y=x_ref):
                return finite_or_inf(float(
                    (x.double().to(y.device) - y).norm()) / norm)

            x32 = pcg(S, dH, minv, rhs, iters)
            x32p = schur_pcg.pcg_schur_plain(S, dH, minv, rhs, iters)
            x64 = pcg(*system64, iters)
            e32 = rel(x32)
            if math.isfinite(e32):
                p32s.append((e32, rel(x32p)))
            else:
                odd.append(("PCG", i, "f32", finite(S, dH, minv, rhs),
                            finite(x32) == finite(x32p)))
            if math.isfinite(rel(x32p)):
                plain32s.append(rel(x32p))
            if finite(x_ref):
                x_order = pcg_schur_plain_kernel_order(*system64, iters)
                calls64.append((rel(x64), rel(schur_pcg.pcg_schur_plain(
                    *(a.cpu() for a in system64), iters)), rel(x_order),
                    rel(x64, x_order)))
            else:
                odd.append(("PCG", i, "f64", finite(S, dH, minv, rhs),
                            not finite(x64)))
                # Which inputs, and the preconditioner's blocks made again
                # from this call's S_corr and dHcc on the card and on the
                # CPU: how many of them are non-finite on each.
                SJ = dH - schur_pcg.diag_blocks(S, C) + 1e-12 * torch.eye(
                    6, dtype=dH.dtype, device=dH.device)
                replays.append((i, [n for n, t in zip(
                    ("S_corr", "dHcc", "minv", "rhs"), (S, dH, minv, rhs))
                    if not finite(t)], *(int((~torch.isfinite(
                        ba_mod._inv6(b)).flatten(1).all(1)).sum())
                        for b in (SJ, SJ.cpu()))))
        agree = all(c[-1] for c in odd)
        if odd:
            phase(name, f"{kind} BA: calls held by finiteness (kernel, "
                  f"call, precision, inputs finite, non-finite as the "
                  f"plain version is): {odd} of {len(grams)} Gram and "
                  f"{len(pcgs)} PCG calls; PCG calls with non-finite "
                  f"inputs (call, inputs not finite, blocks of the "
                  f"preconditioner made again that are non-finite on the "
                  f"card, on the CPU): {replays}")
        g32, g64, p32, plain32 = (max(c, default=0.0) for c in (
            g32s, g64s, [e for e, _ in p32s], plain32s))
        # Every float64 kernel solve within four times its own call's
        # spread, as every float32 one is within plain float32's error.
        tols64 = [max(1e-10, 4 * max(c[1], c[2])) for c in calls64]
        p64, host64, order64, kernel_order = (
            max(col, default=0.0) for col in zip(*calls64)) \
            if calls64 else (0.0,) * 4
        tight = max(zip(calls64, tols64), key=lambda ct: ct[0][0] / ct[1],
                    default=((0.0,) * 4, 1e-10))
        ratio = max((e / max(p, 1e-300) for e, p in p32s), default=0.0)
        worst["schur_gram"] = max(worst["schur_gram"], g32)
        worst["schur_pcg"] = max(worst["schur_pcg"], p32)
        for k, v in mapper_shape_times(card, gram, pcg, C, grams[0],
                                       pcgs[0], name, kind).items():
            times[k].update(v)

        problem64 = problem._replace(**{
            f: getattr(problem, f).double() for f in problem._fields
            if getattr(problem, f).is_floating_point()})
        qp, tp, _, sp = ba_soa.bundle_adjust_soa(problem, model, options,
                                                 plain=True)
        q64, t64, _, s64 = ba_soa.bundle_adjust_soa(problem64, model,
                                                    options, plain=True)
        torch.cuda.synchronize()
        rel_k = abs(s.final_cost - s64.final_cost) / s64.final_cost
        rel_p = abs(sp.final_cost - s64.final_cost) / s64.final_cost
        rot_k, raw_k, ctr_k, sc_k = pose_differences(q, t, q64, t64, free)
        rot_p, raw_p, ctr_p, sc_p = pose_differences(qp, tp, q64, t64,
                                                     free)
        phase(name, f"{kind} BA held against the plain route (C={C}, "
              f"{int(free.sum())} free, P={P} ({frozen_points} frozen), "
              f"K={K}, {nobs} observations): kernel re-solve bit-equal to "
              f"the mapper's={same}, PCG launches by path {took}; "
              f"{len(grams)} Gram calls, max rel err "
              f"float32 {g32:.3e} (tol 1e-4) float64 {g64:.3e} (tol "
              f"1e-10); {len(pcgs)} PCG calls against float64 plain, max "
              f"rel err float32 {p32:.3e} (tol "
              f"{max(1e-4, 4 * plain32):.3e}) float64 {p64:.3e} (each "
              f"call within max(1e-10, 4 x its spread); spreads at most: "
              f"host's plain float64 solve {host64:.3e}, kernel-order "
              f"plain float64 solve {order64:.3e}; kernel from the "
              f"kernel-order solve {kernel_order:.3e} at most; on the "
              f"call nearest its bound, kernel {tight[0][0]:.3e}, host "
              f"{tight[0][1]:.3e}, kernel order {tight[0][2]:.3e}, kernel "
              f"from kernel order {tight[0][3]:.3e}, bound "
              f"{tight[1]:.3e}), plain float32 {plain32:.3e}, "
              f"largest ratio of a call's float32 kernel and plain errors "
              f"{ratio:.3f}; final "
              f"cost kernels float32 "
              f"{s.final_cost!r} ({s.num_iterations} it), plain float32 "
              f"{sp.final_cost!r} ({sp.num_iterations} it), plain float64 "
              f"{s64.final_cost!r} ({s64.num_iterations} it), initial "
              f"{s.initial_cost!r}: rel diff {rel_k:.3e} and {rel_p:.3e} "
              f"(tol 1e-3); against float64, rotation {rot_k:.3e} and "
              f"{rot_p:.3e} deg (tol {MAPPER_BA_TOL[0]}), centre "
              f"{ctr_k:.3e} and {ctr_p:.3e} (tol {MAPPER_BA_TOL[1]}) after "
              f"scales {sc_k:.7f} and {sc_p:.7f} (kernels' tol 1 +- "
              f"{max(MAPPER_BA_TOL[1], 4 * abs(1 - sc_p)):.3e}; "
              f"{raw_k:.3e} and {raw_p:.3e} before) | "
              f"{card}")
        hold(same, f"the {kind} BA solved again gave another result")
        hold(g32 <= 1e-4 and g64 <= 1e-10,
             f"the Gram disagrees with its plain version in the {kind} BA")
        hold(agree, f"a Gram or PCG result in the {kind} BA is non-finite "
             "where its plain version's is not, or the reverse")
        hold(bool(g32s) and bool(p32s) and bool(calls64),
             f"no Gram or PCG call of the {kind} BA had finite results")
        hold(all(math.isfinite(c[1]) and math.isfinite(c[2])
                 for c in calls64),
             f"a plain float64 PCG solve of the {kind} BA is non-finite "
             "where the card's is not")
        hold(all(c[0] <= t for c, t in zip(calls64, tols64))
             and p32 <= max(1e-4, 4 * plain32),
             f"the PCG disagrees with its plain version in the {kind} BA")
        hold(frozen_points > 0 or kind == "global",
              "the local BA froze no point")
        hold(abs(1 - sc_k) <= max(MAPPER_BA_TOL[1], 4 * abs(1 - sc_p)),
              f"the {kind} BA's scale (kernels) disagrees with the float64 "
              "plain solve")
        for what, r, rot, ctr in (("kernels", rel_k, rot_k, ctr_k),
                                  ("plain float32", rel_p, rot_p, ctr_p)):
            hold(r <= 1e-3, f"the {kind} BA's final cost ({what}) "
                  "disagrees with the float64 plain solve")
            hold(rot <= MAPPER_BA_TOL[0] and ctr <= MAPPER_BA_TOL[1],
                  f"the {kind} BA's poses ({what}) disagree with the "
                  "float64 plain solve")
    phase(name, f"BAs held against the plain route in "
          f"{time.perf_counter() - t_start:.1f} s")
    check(not failures, "; ".join(failures))
    out = {k: dict(mapper_max_rel_err=worst[k], **times[k]) for k in worst}
    out["schur_pcg"].update(recheck_cluster_launches=paths["cluster"],
                            recheck_grid_launches=paths["grid"])
    return out


def mapper_shape_times(card, gram, pcg, C, gram_args, pcg_args, name,
                       kind="local", reps=5):
    """Times (CUDA events, ms) of the kernels and their plain versions on
    the first Gram and PCG inputs of the mapper's largest ``kind`` BA,
    with their bounds and the PCG's path at that C."""
    from privacy_preserving_sfm_torch.kernels import build
    from privacy_preserving_sfm_torch.optim import schur_pcg

    lh, gl, cam, precision = gram_args
    K, P = cam.shape
    plan = schur_pcg.gram_plan(cam, C, "soa")
    g_ms = cuda_ms(lambda: gram(lh, gl, cam, C, precision, plan=plan), reps)
    g_plain = cuda_ms(
        lambda: schur_pcg.gram_soa_plain(lh, gl, cam, C, precision), reps)
    g_bound = gram_bound(K, P, C, plan, lh.element_size())
    S, dH, minv, rhs, iters = pcg_args
    grid = build.LAUNCHES["schur_pcg_grid"]
    p_ms = cuda_ms(lambda: pcg(S, dH, minv, rhs, iters), reps)
    path = "grid" if build.LAUNCHES["schur_pcg_grid"] > grid else "cluster"
    p_plain = cuda_ms(
        lambda: schur_pcg.pcg_schur_plain(S, dH, minv, rhs, iters), reps)
    p_bound, p_by = pcg_bound(C, S.element_size(), iters)
    phase(name, f"at the {kind} BA's shape (K={K} P={P} C={C}): Gram "
          f"kernel {g_ms:.4f} ms (plan prebuilt; bound "
          f"{g_bound['bound_ms']:.3e} ms, {g_bound['bound_by']}), plain "
          f"{g_plain:.4f} ms; PCG (n={6 * C}, {iters} iterations, {path} "
          f"path) kernel {p_ms:.4f} ms (bound {p_bound:.3e} ms, {p_by}), "
          f"plain {p_plain:.4f} ms | {card}")
    key = "mapper" if kind == "local" else kind
    return {"schur_gram": {f"{key}_ms": g_ms, f"{key}_plain_ms": g_plain,
                           f"{key}_bound_ms": g_bound["bound_ms"]},
            "schur_pcg": {f"{key}_ms": p_ms, f"{key}_plain_ms": p_plain,
                          f"{key}_bound_ms": p_bound,
                          f"{key}_path": path}}


def phase_mapper(device, card, workdir, db):
    """``mapper`` on phase ``extractor``'s database (cell Mapper-1600) on
    the card: one model with every image registered, the poses within
    MAPPER_BAR of the rendering's truth, the run's largest local and
    global BA held against the plain route (``check_mapper_ba``), and
    ``schur_gram`` and ``schur_pcg`` launched.  When PROFILE is set, a
    second run under torch.profiler split by the mapper's ``mapper.*`` and
    ``init.*`` spans must write the same model byte for byte (the default
    run leaves it out for time: phases ``main``, ``ba300`` and ``ba1000``
    hold the solvers' determinism).  Returns the first run's wall, the
    last run's launches and the kernels' largest errors in those BAs."""
    import torch

    from privacy_preserving_sfm_torch.exe import ppsfm
    from privacy_preserving_sfm_torch.kernels import build
    from privacy_preserving_sfm_torch.utils.synthetic import read_gt_poses

    gt = read_gt_poses(os.path.join(workdir, "images", "gt_poses.txt"))
    launches = {}

    def run(out):
        for name in build.LAUNCHES:
            build.LAUNCHES[name] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctrl = ppsfm.main(["mapper", "--database_path", db, "--output_path",
                           out, "--device", device.type])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches.clear()
        launches.update(build.LAUNCHES)
        check(ctrl.device.type == device.type,
              f"the mapper ran on {ctrl.device}, not {device.type}")
        models = sorted(os.listdir(out))
        check(models == ["0"], f"models {models}, not one")
        rec, names, rot, dirn = model_errors(os.path.join(out, "0"), gt)
        check(len(names) == len(gt), f"{len(names)} of {len(gt)} images "
              "registered")
        check(rot <= MAPPER_BAR[0] and dirn <= MAPPER_BAR[1],
              "the mapper's poses miss the bar")
        return ctrl, wall, rec, rot, dirn

    peaks, solves = {}, {}
    out_a = os.path.join(workdir, "mapper_a")
    with mapper_span_peaks(peaks), mapper_ba_capture(solves):
        ctrl, wall, rec, rot, dirn = run(out_a)
    tot = ctrl.profiler.totals
    top = ", ".join(f"{k} {tot[k]:.3f} s" for k in (
        "init", "register", "triangulate", "local_refine", "global_refine"))
    subs = ", ".join(f"{k} {v:.3f} s" for k, v in sorted(
        tot.items(), key=lambda kv: -kv[1]) if "/" in k and v >= 0.05)
    phase("mapper", f"mapper --device {device.type}: wall {wall:.3f} s, "
          f"{len(rec.reg_image_ids) / wall:.3f} images registered/s, "
          f"{len(rec.points3d)} points, mean reproj "
          f"{rec.compute_mean_reprojection_error():.3f} px; rotation error "
          f"{rot:.4f} deg, translation direction error {dirn:.4f} deg (bar "
          f"{MAPPER_BAR[0]} and {MAPPER_BAR[1]} deg); phase times {top}; "
          f"sub-phases {subs}; launches {dict(launches)} | {card}")
    phase("mapper", "peak device memory by span: " + ", ".join(
        f"{k} {v / 2**20:.1f} MiB" for k, v in sorted(
            peaks.items(), key=lambda kv: -kv[1])) + f" | {card}")
    errors = check_mapper_ba(device, card, solves)
    solves.clear()
    torch.cuda.empty_cache()
    if PROFILE:
        out_b = os.path.join(workdir, "mapper_b")
        span_split("mapper", card, lambda: run(out_b),
                   prefixes=("mapper.", "init."))
        same = _model_bytes(os.path.join(out_a, "0")) == _model_bytes(
            os.path.join(out_b, "0"))
        phase("mapper", f"second run's launches {dict(launches)}; two "
              f"card runs byte-identical={same}")
        check(same, "two card runs wrote different models")
    check(launches["schur_gram"] > 0 and launches["schur_pcg"] > 0,
          "the mapper launched no schur_gram or no schur_pcg")
    return wall, dict(launches), errors


@contextlib.contextmanager
def environ(changes):
    """Inside it, ``os.environ`` with ``changes`` (a value of None unsets
    the variable)."""
    saved = {k: os.environ.get(k) for k in changes}

    def put(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    put(changes)
    try:
        yield
    finally:
        put(saved)


def reconstruct(device, images, ws, fresh, env=None, extra=()):
    """``automatic_reconstructor --device`` (and the flags ``extra``) on
    ``images`` into workspace ``ws``, in a fresh process (``fresh``) or in
    this one, with ``env`` applied as ``environ`` does; in this process
    every kernel count and
    the card's peak memory are reset first.  Checks that it wrote one
    model.  Returns (wall s, the CLI's standard output, its launches, its
    images registered/s and peak device memory in MiB as printed, or
    "?")."""
    import io

    import torch

    from privacy_preserving_sfm_torch.exe import ppsfm
    from privacy_preserving_sfm_torch.kernels import build

    argv = ["automatic_reconstructor", "--workspace_path", ws,
            "--image_path", images, "--device", device.type, *extra]
    with environ(env or {}):
        if fresh:
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "privacy_preserving_sfm_torch.exe",
                 *argv], cwd=REPO, timeout=1100, capture_output=True,
                env=dict(os.environ, PYTHONPATH=REPO), text=True)
            wall = time.perf_counter() - t0
            check(out.returncode == 0,
                  f"automatic_reconstructor failed: {out.stderr[-3000:]}")
            text = out.stdout
        else:
            for name in build.LAUNCHES:
                build.LAUNCHES[name] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            buf = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    ppsfm.main(argv)
            except BaseException:
                print(buf.getvalue()[-3000:], file=sys.stderr)
                raise
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            text = buf.getvalue()
    launches = {k: int(v) for k, v in re.findall(
        r"(\w+)=(\d+)", re.search(r"kernel launches: (.*)", text).group(1))}
    rate = re.search(r"images registered/s: ([\d.]+)", text)
    peak = re.search(r"peak device memory ([\d.]+) MiB", text)
    models = sorted(os.listdir(os.path.join(ws, "sparse")))
    check(models == ["0"], f"models {models}, not one")
    return (wall, text, launches, rate.group(1) if rate else "?",
            peak.group(1) if peak else "?")


def phase_auto(device, card, workdir):
    """``automatic_reconstructor`` in a fresh process on a fresh seeded
    rendering (AUTO): one model with every image registered within
    AUTO_BAR, and ``match_top2`` launched.  Returns the process's
    launches."""
    from privacy_preserving_sfm_torch.utils.synthetic import (
        read_gt_poses, render_dataset,
    )

    n, (h, w), seed = AUTO
    images = os.path.join(workdir, "auto_images")
    render_dataset(images, n, w, h, seed=seed, scene="box")
    ws = os.path.join(workdir, "auto")
    wall, _, launches, rate, peak = reconstruct(device, images, ws,
                                                fresh=True)
    gt = read_gt_poses(os.path.join(images, "gt_poses.txt"))
    rec, names, rot, dirn = model_errors(os.path.join(ws, "sparse", "0"),
                                         gt)
    phase("auto", f"automatic_reconstructor --device {device.type} on {n} "
          f"box images {w}x{h} (seed {seed}) in a fresh process: wall "
          f"{wall:.2f} s, mapper {rate} images registered/s, peak device "
          f"memory {peak} MiB; {len(names)} images, "
          f"{len(rec.points3d)} points; rotation error {rot:.4f} deg, "
          f"translation direction error {dirn:.4f} deg (bar {AUTO_BAR[0]} "
          f"and {AUTO_BAR[1]} deg); launches {launches} | {card}")
    check(len(names) == n, f"{len(names)} of {n} images registered")
    check(rot <= AUTO_BAR[0] and dirn <= AUTO_BAR[1],
          "automatic_reconstructor's poses miss the bar")
    check(launches["match_top2"] > 0, "match_top2 was not launched")
    return launches


def ba_log_summary(path):
    """The mapper's ``PPSFM_BA_LOG`` at ``path``: the solves' routes, and
    (C, P, K, observations) of the solve with the most observations and of
    the one with the most cameras."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.strip():
                route, *fields = line.split()
                kv = dict(x.split("=") for x in fields)
                rows.append((route, *(int(kv[k]) for k in
                                      ("C", "P", "K", "nobs"))))
    check(rows, f"no BA was logged in {path}")
    largest = max(rows, key=lambda r: (r[4], r[1]))[1:]
    widest = max(rows, key=lambda r: (r[1], r[4]))[1:]
    return [r[0] for r in rows], largest, widest


def scene_log(name, text, ba_log):
    """A line with the matcher's pairs and the mapper's profile, as the
    CLI printed them in ``text``, and one with the BA log's summary.
    Returns ``ba_log_summary``."""
    pairs = re.findall(r"=> (\d+)/(\d+) pairs above threshold", text)
    profile = re.findall(r"^([a-z_/]+) +([\d.]+) +(\d+)$", text, re.M)
    phase(name, f"matcher pairs above threshold/scheduled {pairs}" + (
        "; mapper phase profile (s, calls): " + ", ".join(
            f"{k} {v} {c}" for k, v, c in profile) if profile else ""))
    routes, largest, widest = ba_log_summary(ba_log)
    phase(name, f"{len(routes)} BA solves by route "
          f"{dict(collections.Counter(routes))}; the solve with the most "
          f"observations (C, P, K, observations) {largest}, with the most "
          f"cameras {widest}")
    return routes, largest, widest


def phase_scene(device, card, workdir, *, name="box50d", scene=BOX50D,
                camera="OPENCV", bar=BOX50D_BAR, targets=BOX50D_TARGETS,
                matcher="exhaustive", overlap=10,
                require=("schur_gram", "schur_pcg", "match_top2")):
    """``automatic_reconstructor --matcher matcher --overlap overlap`` in
    this process on ``scene`` = (views, (H, W), seed, degrade) box views
    rendered here from the seed by the port's ``tools/synth_dataset``
    through ``camera``: one model, every image registered, ATE RMSE and
    mean rotation error (the port's ``tools/evaluate``) within ``bar``,
    every kernel count in ``require`` above 0, every BA of the run on
    route ``soa`` (the mapper's ``PPSFM_BA_LOG``), and the run's largest
    local and global BA held against the plain route
    (``check_mapper_ba``).  ``targets`` are the reference's accuracy on
    another platform, printed beside the card's.  Returns the run's
    launches and the largest relative errors of the float32 Gram and PCG
    calls in those BAs."""
    import torch

    from privacy_preserving_sfm_torch.tools import evaluate
    from privacy_preserving_sfm_torch.tools.synth_dataset import (
        make_dataset,
    )

    n, (h, w), seed, degrade = scene
    images = os.path.join(workdir, f"{name}_images")
    t0 = time.perf_counter()
    make_dataset(images, n, w, h, f=0.625 * w, seed=seed, scene="box",
                 camera=camera, degrade=degrade)
    render_s = time.perf_counter() - t0
    ws = os.path.join(workdir, name)
    ba_log = os.path.join(workdir, f"{name}_ba.log")
    solves = {}
    with mapper_ba_capture(solves):
        wall, text, launches, rate, peak = reconstruct(
            device, images, ws, fresh=False, env=dict(
                PPSFM_BA_LOG=ba_log, PPSFM_BA_PATH=None,
                PPSFM_SCHUR_MODE=None),
            extra=("--matcher", matcher, "--overlap", str(overlap)))
    stages = re.findall(r"Elapsed time: ([\d.]+) \[minutes\]", text)
    rep = evaluate.report(os.path.join(ws, "sparse", "0"),
                          gt=os.path.join(images, "gt_poses.txt"))
    ate, rot = rep["ate_rmse"], rep["mean_rot_deg"]
    phase(name, f"rendered {n} box views {w}x{h} ({camera}, degrade "
          f"{degrade}, seed {seed}) in {render_s:.1f} s on the host; "
          f"automatic_reconstructor --matcher {matcher} --overlap {overlap} "
          f"--device {device.type} in this process: wall {wall:.2f} s "
          f"(extraction, matching, mapper {', '.join(stages)} min), mapper "
          f"{rate} images registered/s, peak device memory {peak} MiB; host "
          f"cores {os.cpu_count()} | {card}")
    routes, _, _ = scene_log(name, text, ba_log)
    phase(name, f"{rep['num_registered']} of {n} images registered, "
          f"{rep['num_points3d']} points, mean reprojection error "
          f"{rep['mean_reproj_error_px']:.4f} px; ATE RMSE {ate:.6f} (bar "
          f"{bar[0]:.6f}), mean rotation error {rot:.5f} deg (bar "
          f"{bar[1]:.5f}), median {rep['median_rot_deg']:.5f} deg; "
          f"accuracy targets of the reference's run on another platform: "
          f"{targets['registered']}/{n}, ATE {targets['ate_rmse']}, "
          f"{targets['mean_rot_deg']} deg")
    phase(name, f"launches {launches}")
    check(rep["num_registered"] == n, f"{rep['num_registered']} of {n} "
          "images registered")
    check(ate <= bar[0] and rot <= bar[1], f"{name}'s poses miss the bar")
    check(set(routes) == {"soa"},
          f"BAs off the SoA route: {collections.Counter(routes)}")
    for k in require:
        check(launches[k] > 0, f"{k} was not launched")
    errors = check_mapper_ba(device, card, solves, name)
    solves.clear()
    torch.cuda.empty_cache()
    return launches, {k: v["mapper_max_rel_err"] for k, v in errors.items()}


def phase_hier300(device, card, workdir, *, name="hier300", scene=BOX300,
                  hier=HIER300, bar=HIER300_BAR, targets=HIER300_TARGETS,
                  overlap=SEQUENTIAL_OVERLAP):
    """``hierarchical_mapper --block_size B --overlap V --num_workers W``
    (``hier``) on ``scene``'s box views (pinhole, rendered here by the
    port's ``tools/synth_dataset``), after ``feature_extractor`` and
    ``sequential_matcher --overlap overlap`` on the card: the blocks in
    spawned workers sharing the card (each with ``os.cpu_count() / W``
    torch threads), the merge and the joint refinement in this process.
    One model, every image registered, ATE RMSE and mean rotation error
    within ``bar``, every block's snapshot from the card, every BA of the
    workers and of the refinement on route ``soa`` (``PPSFM_BA_LOG``),
    ``match_top2`` launched by the matcher and ``schur_gram``,
    ``schur_pcg`` and the PCG's grid path by the refinement, and the
    refinement's largest global BA held against the plain route
    (``check_mapper_ba``).  Returns the refinement's launches and the
    largest relative errors of its float32 Gram and PCG calls."""
    import io

    import torch

    from privacy_preserving_sfm_torch.exe import ppsfm
    from privacy_preserving_sfm_torch.kernels import build
    from privacy_preserving_sfm_torch.tools import evaluate
    from privacy_preserving_sfm_torch.tools.synth_dataset import (
        make_dataset,
    )

    n, (h, w), seed, degrade = scene
    block, block_overlap, workers = hier
    images = os.path.join(workdir, f"{name}_images")
    t0 = time.perf_counter()
    make_dataset(images, n, w, h, f=0.625 * w, seed=seed, scene="box",
                 degrade=degrade)
    render_s = time.perf_counter() - t0
    db = os.path.join(workdir, f"{name}.db")
    out = os.path.join(workdir, name)
    ba_log = os.path.join(workdir, f"{name}_ba.log")
    stage_s, launches = {}, {}

    def stage(what, argv):
        for k in build.LAUNCHES:
            build.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                got = ppsfm.main(argv)
        except BaseException:
            print(buf.getvalue()[-3000:], file=sys.stderr)
            raise
        torch.cuda.synchronize()
        stage_s[what] = time.perf_counter() - t0
        launches[what] = dict(build.LAUNCHES)
        return got, buf.getvalue()

    dev = ["--device", device.type]
    stage("feature_extractor", ["feature_extractor", "--database_path", db,
                                "--image_path", images, *dev])
    _, text = stage("sequential_matcher", [
        "sequential_matcher", "--database_path", db, "--overlap",
        str(overlap), *dev])
    torch.cuda.reset_peak_memory_stats()
    solves = {}
    with mapper_ba_capture(solves), environ(dict(
            PPSFM_BA_LOG=ba_log, PPSFM_BA_PATH=None, PPSFM_SCHUR_MODE=None,
            PPSFM_WORKER_THREADS=str(max(1, (os.cpu_count() or 1)
                                         // workers)))):
        stats, hier_text = stage("hierarchical_mapper", [
            "hierarchical_mapper", "--database_path", db, "--output_path",
            out, "--block_size", str(block), "--overlap",
            str(block_overlap), "--num_workers", str(workers), *dev])
    peak = torch.cuda.max_memory_allocated()
    rep = evaluate.report(os.path.join(out, "0"),
                          gt=os.path.join(images, "gt_poses.txt"))
    ate, rot = rep["ate_rmse"], rep["mean_rot_deg"]
    devices = [snap["device"] for snap in stats["snapshots"]]
    blocks = "; ".join(
        f"{snap['seconds']:.1f} s (" + ", ".join(
            f"{k} {v:.1f}" for k, v in sorted(
                snap["profile"].items(), key=lambda kv: -kv[1])
            if "/" not in k) + f"), launches {snap['launches']}"
        for snap in stats["snapshots"])
    phase(name, f"rendered {n} box views {w}x{h} (seed {seed}) in "
          f"{render_s:.1f} s on the host; --device {device.type}: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in stage_s.items())
          + f"; {rep['num_registered'] / stats['wall']:.3f} images "
          f"registered/s (the mapper's wall); this process's peak device "
          f"memory during the mapper "
          f"{peak / 2**20:.1f} MiB; host cores {os.cpu_count()} | {card}")
    phase(name, f"hierarchical_mapper --block_size {block} --overlap "
          f"{block_overlap} --num_workers {workers}: blocks "
          f"{stats['reconstructed']} of {stats['blocks']} reconstructed, "
          f"{stats['merged']} merged, on {devices}; blocks' wall, profile "
          f"(s) and launches: {blocks}")
    refine = stats["refine_profile"]
    phase(name, f"merged {stats['merged_points']} points, refined "
          f"{stats['refined_points']}; joint refinement "
          f"{stats['refine_seconds']:.2f} s, profile (s) " + ", ".join(
              f"{k} {v:.2f}" for k, v in sorted(refine.items(),
                                                key=lambda kv: -kv[1]))
          + f"; launches by stage {launches}")
    routes, _, _ = scene_log(name, text + hier_text, ba_log)
    phase(name, f"{rep['num_registered']} of {n} images registered, "
          f"{rep['num_points3d']} points, mean reprojection error "
          f"{rep['mean_reproj_error_px']:.4f} px; ATE RMSE {ate:.6f} (bar "
          f"{bar[0]:.6f}), mean rotation error {rot:.5f} deg (bar "
          f"{bar[1]:.5f}), median {rep['median_rot_deg']:.5f} deg; "
          f"accuracy of the reference's run on another platform: "
          f"{targets['registered']}/{n}, ATE {targets['ate_rmse']:.6f}, "
          f"{targets['mean_rot_deg']:.5f} deg")
    # The refinement's BA is held first: it does not depend on the counts.
    errors = check_mapper_ba(device, card, solves, name, kinds=("global",))
    solves.clear()
    check(stats["reconstructed"] == stats["merged"] == stats["blocks"],
          f"{stats['reconstructed']} of {stats['blocks']} blocks "
          f"reconstructed, {stats['merged']} merged")
    check(devices == [device.type] * stats["reconstructed"],
          f"a block ran on another device: {devices}")
    check(rep["num_registered"] == n, f"{rep['num_registered']} of {n} "
          "images registered")
    check(ate <= bar[0] and rot <= bar[1], f"{name}'s poses miss the bar")
    check(set(routes) == {"soa"},
          f"BAs off the SoA route: {collections.Counter(routes)}")
    check(launches["sequential_matcher"]["match_top2"] > 0,
          "match_top2 was not launched")
    mapped = launches["hierarchical_mapper"]
    for k in ("schur_gram", "schur_pcg", "schur_pcg_grid"):
        check(mapped[k] > 0, f"the joint refinement launched no {k}")
    torch.cuda.empty_cache()
    return mapped, {k: v["mapper_max_rel_err"] for k, v in errors.items()}


def phase_hier(device, card, workdir, db):
    """``hierarchical_mapper --block_size 8 --overlap 3`` on phase
    ``extractor``'s database (cell Hier-1600), once with one worker (this
    process; under torch.profiler with PROFILE) and once with two spawned
    workers on the same card: one model with every image within
    HIER_BAR, the two models byte-identical, every block's snapshot from
    the card, ``schur_gram`` and ``schur_pcg`` launched in the one-worker
    run.  Returns that run's launches; the two-worker run's are printed
    (this process's and the blocks' snapshots')."""
    import torch

    from privacy_preserving_sfm_torch.exe import ppsfm
    from privacy_preserving_sfm_torch.kernels import build
    from privacy_preserving_sfm_torch.utils.synthetic import read_gt_poses

    gt = read_gt_poses(os.path.join(workdir, "images", "gt_poses.txt"))
    runs = {}
    for workers in (1, 2):
        out = os.path.join(workdir, f"hier_{workers}")
        for name in build.LAUNCHES:
            build.LAUNCHES[name] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got = {}

        def go():
            t0 = time.perf_counter()
            got["stats"] = ppsfm.main([
                "hierarchical_mapper", "--database_path", db, "--output_path",
                out, "--device", device.type, "--block_size", str(HIER[0]),
                "--overlap", str(HIER[1]), "--num_workers", str(workers)])
            torch.cuda.synchronize()
            got["wall"] = time.perf_counter() - t0

        if PROFILE and workers == 1:
            span_split("hier", card, go, prefixes=("mapper.", "init."))
        else:
            go()
        stats, wall = got["stats"], got["wall"]
        launches = collections.Counter(build.LAUNCHES)
        if workers > 1:  # the blocks ran in other processes
            for snap in stats["snapshots"]:
                launches.update(snap["launches"])
        launches = dict(launches)
        peak = torch.cuda.max_memory_allocated()
        check(stats["model"] is not None, "no model")
        check(sorted(os.listdir(out)) == ["0"], "not one model")
        rec, names, rot, dirn = model_errors(os.path.join(out, "0"), gt)
        devices = [snap["device"] for snap in stats["snapshots"]]
        blocks = "; ".join(
            f"{snap['seconds']:.2f} s (" + ", ".join(
                f"{k} {snap['profile'].get(k, 0.0):.2f}" for k in (
                    "init", "register", "local_refine", "global_refine"))
            + f"), schur_gram {snap['launches']['schur_gram']}"
            for snap in stats["snapshots"])
        phase("hier", f"hierarchical_mapper --device {device.type} "
              f"--block_size {HIER[0]} --overlap {HIER[1]} --num_workers "
              f"{workers}: wall {wall:.3f} s, {len(names) / wall:.3f} "
              f"images registered/s; blocks {stats['reconstructed']} of "
              f"{stats['blocks']} reconstructed, {stats['merged']} merged, "
              f"on {devices}; blocks' wall and launches: {blocks}; merged "
              f"{stats['merged_points']} points, refined "
              f"{stats['refined_points']} points, mean reproj "
              f"{rec.compute_mean_reprojection_error():.3f} px; joint "
              f"refinement {stats['refine_seconds']:.3f} s; rotation error {rot:.4f} deg, translation direction "
              f"error {dirn:.4f} deg (bar {HIER_BAR[0]} and {HIER_BAR[1]} "
              f"deg); this process's peak device memory "
              f"{peak / 2**20:.1f} MiB, launches (this process and the "
              f"blocks) {launches} | {card}")
        check(devices == [device.type] * stats["blocks"],
              f"a block ran on another device: {devices}")
        check(len(names) == len(gt), f"{len(names)} of {len(gt)} images "
              "registered")
        check(rot <= HIER_BAR[0] and dirn <= HIER_BAR[1],
              "the hierarchical mapper's poses miss the bar")
        runs[workers] = (out, launches)
    same = _model_bytes(os.path.join(runs[1][0], "0")) == _model_bytes(
        os.path.join(runs[2][0], "0"))
    phase("hier", f"one and two workers byte-identical={same}")
    check(same, "one and two workers wrote different models")
    launches = runs[1][1]
    check(launches["schur_gram"] > 0 and launches["schur_pcg"] > 0,
          "the hierarchical mapper launched no schur_gram or no schur_pcg")
    return launches


@contextlib.contextmanager
def intrinsics_capture(record):
    """Inside it, the mapper's largest intrinsics BA is kept in
    ``record["largest"]`` on the host as (valid observations, problem,
    camera model, options, result); every route ``_run_ba`` took is
    appended to ``record["routes"]`` and every focal search to
    ``record["searches"]``."""
    from privacy_preserving_sfm_torch.optim import ba_intrinsics
    from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
        IncrementalMapper,
    )

    solve = ba_intrinsics.bundle_adjust_intrinsics
    run_ba = IncrementalMapper._run_ba
    search = IncrementalMapper._focal_search
    record.setdefault("routes", [])
    record.setdefault("searches", [])

    def keep(problem, camera_model, options):
        out = solve(problem, camera_model, options)
        nobs = int((problem.base.obs_weight > 0).sum())
        if nobs > record.get("largest", (0,))[0]:
            record["largest"] = (
                nobs, type(problem)(to_device(problem.base, "cpu"),
                                    *to_device(problem[1:], "cpu")),
                camera_model, options,
                tuple(to_device(out[:4], "cpu")) + out[4:])
        return out

    def routes(self, *args, **kwargs):
        out = run_ba(self, *args, **kwargs)
        record["routes"].append(self.last_route)
        return out

    def searches(self, options, image_id, corrs):
        before = len(self.focal_searches)
        search(self, options, image_id, corrs)
        record["searches"].append(
            (image_id, self.focal_searches[before:]))

    ba_intrinsics.bundle_adjust_intrinsics = keep
    IncrementalMapper._run_ba = routes
    IncrementalMapper._focal_search = searches
    try:
        yield record
    finally:
        ba_intrinsics.bundle_adjust_intrinsics = solve
        IncrementalMapper._run_ba = run_ba
        IncrementalMapper._focal_search = search


def check_intrinsics_ba(device, card, largest):
    """The mapper's largest intrinsics BA solved again on the card in
    float32 (bit-equal to the mapper's solve) and in float64: final cost
    within 1e-3, every refined focal within 1e-4 relative and every free
    pose within MAPPER_BA_TOL of the float64 solve."""
    import torch

    from privacy_preserving_sfm_torch.optim import ba_intrinsics

    nobs, problem, model, options, (q0, t0, X0, i0, s0) = largest
    problem = type(problem)(to_device(problem.base, device),
                            *to_device(problem[1:], device))
    t_start = time.perf_counter()
    q, t, X, intr, s = ba_intrinsics.bundle_adjust_intrinsics(
        problem, model, options)
    torch.cuda.synchronize()
    dt32 = time.perf_counter() - t_start
    same = all(torch.equal(a.cpu(), b) for a, b in
               ((q, q0), (t, t0), (X, X0), (intr, i0))) and s == s0

    def f64(tup):
        return tup._replace(**{
            k: v.double() for k, v in tup._asdict().items()
            if isinstance(v, torch.Tensor) and v.is_floating_point()})

    p64 = f64(problem)._replace(base=f64(problem.base))
    t_start = time.perf_counter()
    q64, t64, _, i64, s64 = ba_intrinsics.bundle_adjust_intrinsics(
        p64, model, options)
    torch.cuda.synchronize()
    dt64 = time.perf_counter() - t_start
    free = (problem.base.cam_dof_mask.sum(1) > 0).cpu().numpy()
    rel = abs(s.final_cost - s64.final_cost) / s64.final_cost
    refined = problem.intr_mask > 0
    focal = float(((intr.double() - i64).abs() / i64.abs())[refined].max())
    rot, ctr = pose_differences(q, t, q64, t64, free)[:2]
    C, U = problem.base.qvecs.shape[0], problem.intr_params.shape[0]
    phase("uncal", f"largest intrinsics BA (C={C}, {int(free.sum())} free,"
          f" P={problem.base.points3d.shape[0]}, U={U}, {nobs} "
          f"observations) solved again: float32 bit-equal to the "
          f"mapper's={same} ({s.num_iterations} it, {dt32:.3f} s); final "
          f"cost float32 {s.final_cost!r}, float64 {s64.final_cost!r} "
          f"({s64.num_iterations} it, {dt64:.3f} s), initial "
          f"{s.initial_cost!r}: rel diff {rel:.3e} (tol 1e-3); focal "
          f"float32 {intr[0, 0].item()!r} float64 {i64[0, 0].item()!r}, "
          f"max rel diff {focal:.3e} (tol 1e-4); poses against float64 "
          f"rotation {rot:.3e} deg (tol {MAPPER_BA_TOL[0]}), centre "
          f"{ctr:.3e} (tol {MAPPER_BA_TOL[1]}) | {card}")
    check(same, "the intrinsics BA solved again gave another result")
    check(rel <= 1e-3, "the intrinsics BA's final cost disagrees with "
          "float64")
    check(focal <= 1e-4, "the intrinsics BA's focal disagrees with float64")
    check(rot <= MAPPER_BA_TOL[0] and ctr <= MAPPER_BA_TOL[1],
          "the intrinsics BA's poses disagree with float64")


def focal_search_card_cpu(device, card, db, rec):
    """One focal search at the model's size, on the card and on the CPU on
    the same draws (a fresh mapper on a copy of the model, its ``_rng``
    seeded alike, the first registered image's correspondences): every
    candidate's inlier count within max(2, 1 % of N) of the CPU's, the
    winner with at least ``abs_pose_min_num_inliers``.  Prints the time,
    the card's peak and both winners."""
    import copy

    import numpy as np
    import torch

    from privacy_preserving_sfm_torch.models.database import Database
    from privacy_preserving_sfm_torch.models.database_cache import (
        DatabaseCache,
    )
    from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
        IncrementalMapper, MapperOptions,
    )
    from privacy_preserving_sfm_torch.solvers import p6l

    with Database(db) as d:
        cache = DatabaseCache.load(d, 15)
    options = MapperOptions()
    estimate = p6l.estimate_pose_candidates
    found = {}

    def search(dev):
        model = copy.deepcopy(rec)
        mapper = IncrementalMapper(dev, torch.float32, cache)
        mapper.begin_reconstruction(model)
        mapper._rng = np.random.default_rng(1)
        iid = sorted(model.reg_image_ids)[0]
        cid = model.images[iid].camera_id
        corrs = mapper.correspondences_2d3d(options, iid)

        def keep(*args):
            out = estimate(*args)
            found[dev.type] = np.where(out.success.cpu().numpy(),
                                       out.num_inliers.cpu().numpy(), -1)
            return out

        p6l.estimate_pose_candidates = keep
        try:
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            mapper._focal_search(options, iid, corrs)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            p6l.estimate_pose_candidates = estimate
        return (len(corrs), float(rec.cameras[cid].params[0]),
                float(model.cameras[cid].params[0]), dt)

    n, f0, f_card, dt_card = search(device)
    peak = torch.cuda.max_memory_allocated()
    _, _, f_cpu, dt_cpu = search(torch.device("cpu"))
    diff = int(np.abs(found[device.type] - found["cpu"]).max())
    best = int(found[device.type].max())
    phase("uncal", f"one focal search at the model's size "
          f"({options.num_focal_length_samples} candidates x "
          f"{max(256, options.num_hypotheses // 4)} hypotheses, N = {n}): "
          f"card {dt_card:.3f} s, peak device memory {peak / 2**20:.1f} "
          f"MiB; CPU {dt_cpu:.3f} s; inlier counts by candidate (card) "
          f"{found[device.type].tolist()}, largest difference from the "
          f"CPU's {diff} (tol {max(2, n // 100)}); focal {f0:.2f} -> card "
          f"{f_card:.2f}, CPU {f_cpu:.2f} | {card}")
    check(diff <= max(2, n // 100),
          "the focal search's inlier counts on the card and the CPU differ")
    check(best >= options.abs_pose_min_num_inliers,
          "the focal search's best candidate has too few inliers")
    torch.cuda.empty_cache()


def phase_uncal(device, card, workdir):
    """The uncalibrated path (cell Uncal-1600): UNCAL box images rendered
    with the true focal UNCAL_FOCAL and no camera sidecar, so
    ``feature_extractor`` takes the heuristic 1.2 x 1,600 with no prior;
    ``exhaustive_matcher``; then the controller with
    ``ba_refine_focal_length`` in this process (and, when PROFILE is set,
    again under torch.profiler, byte-identical): one model with every
    image, poses within UNCAL_BAR, every camera's focal within
    UNCAL_FOCAL_BAR of the truth, every BA on the intrinsics route, no
    Schur kernel launched, the largest intrinsics BA held against float64
    (``check_intrinsics_ba``); and one focal search at the model's size
    on the card against the CPU (``focal_search_card_cpu``)."""
    import torch

    from privacy_preserving_sfm_torch.exe import ppsfm
    from privacy_preserving_sfm_torch.kernels import build
    from privacy_preserving_sfm_torch.models.database import Database
    from privacy_preserving_sfm_torch.sfm.controller import (
        ControllerOptions, IncrementalMapperController,
    )
    from privacy_preserving_sfm_torch.utils.synthetic import (
        read_gt_poses, render_dataset,
    )

    n, (h, w), seed = UNCAL
    images = os.path.join(workdir, "uncal_images")
    render_dataset(images, n, w, h, f=UNCAL_FOCAL, seed=seed, scene="box")
    for name in os.listdir(images):
        if name.endswith(".camera_model.txt"):
            os.remove(os.path.join(images, name))
    db = os.path.join(workdir, "uncal.db")
    t0 = time.perf_counter()
    ppsfm.main(["feature_extractor", "--database_path", db, "--image_path",
                images, "--device", device.type])
    ppsfm.main(["exhaustive_matcher", "--database_path", db, "--device",
                device.type])
    torch.cuda.synchronize()
    t_front = time.perf_counter() - t0
    with Database(db) as d:
        cams = d.read_cameras()
    heuristic = 1.2 * max(w, h)
    check(len(cams) == 1 and all(
        not c.get("prior_focal_length", True)
        and abs(c["params"][0] - heuristic) < 1e-6 for c in cams.values()),
        f"the extractor did not take the heuristic focal: {cams}")
    gt = read_gt_poses(os.path.join(images, "gt_poses.txt"))

    def run(out):
        for name in build.LAUNCHES:
            build.LAUNCHES[name] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctrl = IncrementalMapperController(
            ControllerOptions(ba_refine_focal_length=True),
            database_path=db, device=device, dtype=torch.float32)
        recs = ctrl.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(len(recs) == 1, f"{len(recs)} models, not one")
        recs[0].write_text(os.path.join(out, "0"))
        return ctrl, recs[0], wall, dict(build.LAUNCHES)

    peaks, record = {}, {}
    out_a = os.path.join(workdir, "uncal_a")
    with mapper_span_peaks(peaks), intrinsics_capture(record):
        ctrl, rec, wall, launches = run(out_a)
    rec, names, rot, dirn = model_errors(os.path.join(out_a, "0"), gt)
    focals = {cid: float(c.params[0]) for cid, c in rec.cameras.items()
              if any(img.camera_id == cid and img.registered
                     for img in rec.images.values())}
    worst = max(abs(f / UNCAL_FOCAL - 1) for f in focals.values())
    tot = ctrl.profiler.totals
    top = ", ".join(f"{k} {tot[k]:.3f} s" for k in (
        "init", "register", "triangulate", "local_refine", "global_refine"))
    ba_solve = sum(v for k, v in tot.items() if k.endswith("/ba_solve"))
    routes = {tuple(r) for r in record["routes"]}
    phase("uncal", f"{n} box images {w}x{h} (seed {seed}, true focal "
          f"{UNCAL_FOCAL}, no sidecar: heuristic {heuristic}); extractor "
          f"and matcher {t_front:.2f} s; controller with "
          f"ba_refine_focal_length: wall {wall:.3f} s, "
          f"{len(names) / wall:.3f} images registered/s, {len(names)} "
          f"images, {len(rec.points3d)} points, mean reproj "
          f"{rec.compute_mean_reprojection_error():.3f} px; phase times "
          f"{top}; intrinsics BA solves {ba_solve:.3f} s "
          f"({100 * ba_solve / wall:.1f} % of the wall) over "
          f"{len(record['routes'])} BAs, routes {sorted(routes)}; focal "
          f"{heuristic} -> {sorted(focals.values())} (max rel err "
          f"{worst:.5f}, bar {UNCAL_FOCAL_BAR}); focal searches run "
          f"{record['searches']}; rotation error {rot:.4f} deg, "
          f"translation direction error {dirn:.4f} deg (bar "
          f"{UNCAL_BAR[0]} and {UNCAL_BAR[1]} deg); launches {launches} | "
          f"{card}")
    phase("uncal", "peak device memory by span: " + ", ".join(
        f"{k} {v / 2**20:.1f} MiB" for k, v in sorted(
            peaks.items(), key=lambda kv: -kv[1])) + f" | {card}")
    check(len(names) >= UNCAL_MIN_IMAGES, f"{len(names)} images "
          f"registered, fewer than {UNCAL_MIN_IMAGES}")
    check(rot <= UNCAL_BAR[0] and dirn <= UNCAL_BAR[1],
          "the uncalibrated mapper's poses miss the bar")
    check(worst <= UNCAL_FOCAL_BAR, "a focal misses the bar")
    check(routes == {("intrinsics", False)},
          f"a BA took another route: {routes}")
    check(launches["schur_gram"] == 0 and launches["schur_pcg"] == 0,
          "a Schur kernel was launched on the intrinsics path")
    check_intrinsics_ba(device, card, record.pop("largest"))

    focal_search_card_cpu(device, card, db, rec)

    # The second run only under PROFILE: the default run leaves it out to
    # stay within the script's time limit (the bit-equal re-solve of the
    # largest intrinsics BA above still holds the path to one result).
    if PROFILE:
        out_b = os.path.join(workdir, "uncal_b")
        span_split("uncal", card, lambda: run(out_b),
                   prefixes=("mapper.", "init.", "ba_intr."))
        same = _model_bytes(os.path.join(out_a, "0")) == _model_bytes(
            os.path.join(out_b, "0"))
        phase("uncal", f"two card runs byte-identical={same}")
        check(same, "two card runs wrote different models")


# The sharded BA and matcher run in spawned ranks on cuda:0: a world of
# one rank on NCCL, and a world of two ranks that share the card through
# gloo (NCCL takes one rank a card).  A world that outlives its timeout
# is killed, every rank of it, and fails the phase.
PARALLEL_TIMEOUT = 300
PARALLEL_LM = 20
PARALLEL_CG = 30


def parallel_world(n, backend, workdir, device):
    """Run ``n`` ranks of this script (``--parallel-rank``) on ``device``
    with ``backend``; fails when a rank fails or the world outlives
    PARALLEL_TIMEOUT, after killing every rank.  Returns each rank's
    results (``parallel_rank``)."""
    import random

    import numpy as np

    while True:  # a free port below the ephemeral range (32768 and up),
        port = random.randrange(20000, 32000)  # which connections draw on
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
                break
            except OSError:
                continue
    procs, logs = [], []
    for rank in range(n):
        log = open(os.path.join(workdir, f"{backend}{n}_rank{rank}.log"),
                   "w+")
        logs.append(log)
        env = dict(os.environ, PPSFM_COORDINATOR=f"127.0.0.1:{port}",
                   PPSFM_NUM_PROCESSES=str(n), PPSFM_PROCESS_ID=str(rank),
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank",
             backend, workdir, str(device)], env=env, stdout=log,
            stderr=subprocess.STDOUT, cwd=REPO))
    deadline = time.monotonic() + PARALLEL_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    failed = False
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            failed = True
            print(f"[parallel] {backend} rank {rank} of {n} exited "
                  f"{p.returncode}; its log ends:\n{text[-3000:]}",
                  flush=True)
    check(not failed, f"a rank of the {backend} world of {n} failed or "
          f"outlived {PARALLEL_TIMEOUT} s")
    return [dict(np.load(os.path.join(workdir, f"{backend}{n}_{r}.npz")))
            for r in range(n)]


def parallel_rank(backend, workdir, device_name):
    """One rank of phase ``parallel`` (``--parallel-rank``): three solves
    of the BA-100 problem point-sharded over the world (the first cold,
    the second for the wall, the third with the all-reduces timed), then,
    in the gloo world, this rank's block of the exhaustive pairs through
    ``match_pairs_sharded`` (``match_top2``'s launches counted around that
    call alone), ``gather_rows``, a digest of the gathered result, and
    ``match_top2`` timed on the rank's block with the other rank idle.
    Writes ``<backend><world>_<rank>.npz``."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from privacy_preserving_sfm_torch.features import matching
    from privacy_preserving_sfm_torch.features import matching_kernels
    from privacy_preserving_sfm_torch.kernels import build
    from privacy_preserving_sfm_torch.optim import ba as ba_mod
    from privacy_preserving_sfm_torch.parallel import (
        distributed_ba, multihost, sharded_matching,
    )

    device = torch.device(device_name)
    torch.set_num_threads(1)  # ranks share the host's cores
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not multihost.initialize_from_env(backend=backend, device=device):
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(  # a world of one rank
            backend, init_method="tcp://" + os.environ["PPSFM_COORDINATOR"],
            world_size=1, rank=0, timeout=multihost.TIMEOUT)
    group = multihost.global_mesh()
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    out = {}
    try:
        data = np.load(os.path.join(workdir, "parallel_ba.npz"))
        problem = ba_mod.BAProblem(*(torch.from_numpy(data[f]).to(device)
                                     for f in ba_mod.BAProblem._fields))
        opts = ba_mod.BAOptions(max_iterations=PARALLEL_LM,
                                cg_iterations=PARALLEL_CG)
        sharded, meta = distributed_ba.shard_problem(problem, world)
        local = multihost.make_global_problem(sharded, meta, group, device)
        out.update(points_per_shard=meta["points_per_shard"],
                   obs_per_shard=meta["obs_per_shard"])
        for k, timed in enumerate((False, False, True)):
            reducer = distributed_ba.Reducer(group, timed=timed)
            dist.barrier(group)
            sync()
            t0 = time.perf_counter()
            q, t, X, s = distributed_ba.bundle_adjust_sharded(
                local, group, str(data["camera_model"]), opts, reducer)
            sync()
            out.update({f"wall{k}": time.perf_counter() - t0,
                        f"q{k}": q.cpu().numpy(), f"t{k}": t.cpu().numpy(),
                        f"X{k}": multihost.gather_points(X, group)
                        .cpu().numpy(),
                        f"summary{k}": np.asarray(s, np.float64),
                        f"calls{k}": reducer.calls,
                        f"reduce_s{k}": reducer.seconds})
        if os.path.exists(os.path.join(workdir, "parallel_match.npz")):
            m = np.load(os.path.join(workdir, "parallel_match.npz"))
            desc = torch.from_numpy(m["desc"]).to(device)
            valid = torch.from_numpy(m["valid"]).to(device)
            pairs = torch.from_numpy(m["pairs"]).to(device)
            dist.barrier(group)
            for name in build.LAUNCHES:
                build.LAUNCHES[name] = 0
            sync()
            t0 = time.perf_counter()
            res = sharded_matching.match_pairs_sharded(desc, valid, pairs,
                                                       group)
            sync()
            out["match_s"] = time.perf_counter() - t0
            out["launches"] = build.LAUNCHES["match_top2"]
            every = sharded_matching.gather_rows(res, group)
            out["digest"] = np.asarray([hashlib.sha256(
                getattr(every, f).cpu().numpy().tobytes()).hexdigest()
                for f in matching.MatchResult._fields])
            per = pairs.shape[0] // world
            mine = pairs[rank * per:(rank + 1) * per]
            a, b = mine[:, 0], mine[:, 1]
            args = (desc[a], desc[b], valid[a], valid[b])
            def kernel():
                return matching_kernels.top2_scores_bidir(*args)

            for turn in range(world):  # one rank at a time on the card
                dist.barrier(group)
                if turn == rank and device.type == "cuda":
                    out["kernel_ms"] = cuda_ms(kernel, 3)
                elif turn == rank:  # a CPU rehearsal: the plain version
                    t0 = time.perf_counter()
                    kernel()
                    out["kernel_ms"] = 1e3 * (time.perf_counter() - t0)
            out["pairs_here"] = per
        np.savez(os.path.join(workdir, f"{backend}{world}_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def phase_parallel(device, card, workdir):
    """The sharded BA at BA-100's shape (MAIN, float32, PARALLEL_LM LM x
    PARALLEL_CG CG) in a one-rank NCCL world (bit-equal to
    ``ba.bundle_adjust`` on the card) and a two-rank gloo world on the same
    card (the same cameras and summary on both ranks, bit-equal run to
    run, cost within 1e-3 of ``ba.bundle_adjust`` and of a float64 run);
    then the sharded matcher at the Matcher cell's shape (MATCHER, all
    exhaustive pairs split over the two gloo ranks, ``match_top2.cu`` on
    each) against the unsharded ``match_many_pairs`` on the card, every
    field equal.  Returns the ranks' ``match_top2`` launches."""
    import hashlib

    import numpy as np
    import torch

    from privacy_preserving_sfm_torch.features import matching
    from privacy_preserving_sfm_torch.kernels import build
    from privacy_preserving_sfm_torch.models.database import Database
    from privacy_preserving_sfm_torch.optim import ba as ba_mod
    from privacy_preserving_sfm_torch.parallel import sharded_matching
    from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
        IncrementalMapper,
    )
    from privacy_preserving_sfm_torch.utils.synthetic import (
        synthetic_matching_database, synthetic_model,
    )

    build.build()  # once here, not once a rank
    t0 = time.perf_counter()
    rec = synthetic_model(seed=0, **MAIN)
    rec.filter_observations_with_negative_depth()
    mapper = IncrementalMapper(device, torch.float32)
    mapper.begin_reconstruction(rec)
    reg = rec.reg_image_ids
    asm = mapper.assemble_ba(reg, {reg[0]}, {reg[1]})
    problem, model = asm.problem, asm.camera_model
    np.savez(os.path.join(workdir, "parallel_ba.npz"), camera_model=model,
             **{f: x.cpu().numpy() for f, x in problem._asdict().items()})
    opts = ba_mod.BAOptions(max_iterations=PARALLEL_LM,
                            cg_iterations=PARALLEL_CG)
    nobs = problem.obs_cam.shape[0]
    phase("parallel", f"BA problem: {problem.qvecs.shape[0]} cameras, "
          f"{problem.points3d.shape[0]} points, {nobs} observations "
          f"({model}, float32), in {time.perf_counter() - t0:.1f} s")

    ref, walls = None, []
    for _ in range(2):  # the first call warms the flat solver
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = ba_mod.bundle_adjust(problem, model, opts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    s32 = ref[3]
    p64 = ba_mod.BAProblem(*(x.double() if x.is_floating_point() else x
                             for x in problem))
    s64 = ba_mod.bundle_adjust(p64, model, opts)[3]
    phase("parallel", f"ba.bundle_adjust on the card: float32 wall "
          f"{walls[1]:.3f} s (cold {walls[0]:.3f} s), {s32.num_iterations} "
          f"LM iterations, cost {s32.initial_cost!r} -> {s32.final_cost!r}; "
          f"float64 {s64.num_iterations} iterations, cost "
          f"{s64.final_cost!r} | {card}")

    def same(a, b, keys):
        return all(np.array_equal(a[k], b[k]) for k in keys)

    def report(label, ranks):
        r0 = ranks[0]
        iters = int(r0["summary1"][2])
        final = float(r0["summary1"][1])
        share = r0["reduce_s2"] / r0["wall2"]
        phase("parallel", f"{label}: wall {r0['wall1']:.3f} s (cold "
              f"{r0['wall0']:.3f} s; ba.bundle_adjust {walls[1]:.3f} s), "
              f"{iters} LM iterations, {nobs * iters / r0['wall1']:.1f} "
              f"obs*iter/s, {r0['calls1']} all-reduces, {r0['reduce_s2']:.3f}"
              f" s of a {r0['wall2']:.3f} s timed solve in them "
              f"({100 * share:.1f} %), cost {final!r} (float32 "
              f"{s32.final_cost!r}, float64 {s64.final_cost!r}); shards of "
              f"{r0['points_per_shard']} points, {r0['obs_per_shard']} "
              f"observations | {card}")
        return final

    keys = [f"{k}{i}" for i in range(3) for k in ("q", "t", "X", "summary")]
    one = parallel_world(1, "nccl", workdir, device)
    report("one rank, NCCL", one)
    bit = all(np.array_equal(one[0][f"{k}0"], v.cpu().numpy())
              for k, v in zip("qtX", ref[:3])) and np.array_equal(
        one[0]["summary0"], np.asarray(s32, np.float64))
    repeat = all(same({k: one[0][f"{k}{i}"] for k in ("q", "t", "X",
                                                       "summary")},
                      {k: one[0][f"{k}0"] for k in ("q", "t", "X",
                                                     "summary")},
                      ("q", "t", "X", "summary")) for i in (1, 2))
    phase("parallel", f"one rank: bit-equal to ba.bundle_adjust={bit}, "
          f"its three solves bit-equal={repeat}")
    check(bit, "a one-rank world differs from ba.bundle_adjust")
    check(repeat, "a one-rank world's solves differ")

    t0 = time.perf_counter()
    path = os.path.join(workdir, "parallel.db")
    scene = synthetic_matching_database(path, seed=0, **MATCHER)
    with Database(path) as db:
        desc = np.stack([db.read_descriptors(i) for i in scene.image_ids])
    valid = np.ones(desc.shape[:2], bool)
    pairs = sharded_matching.exhaustive_pair_list(len(desc)).astype(np.int64)
    check(len(pairs) % 2 == 0, "the pair list does not split over 2 ranks")
    np.savez(os.path.join(workdir, "parallel_match.npz"), desc=desc,
             valid=valid, pairs=pairs)
    d, v = torch.from_numpy(desc).to(device), torch.from_numpy(valid).to(
        device)
    p = torch.from_numpy(pairs).to(device)
    parts = [matching.match_many_pairs(d, v, p[i:i + 64])
             for i in range(0, len(pairs), 64)]
    full = matching.MatchResult(*(torch.cat(f) for f in zip(*parts)))
    want = [hashlib.sha256(f.cpu().numpy().tobytes()).hexdigest()
            for f in full]
    del d, v, p, parts
    torch.cuda.empty_cache()
    phase("parallel", f"matcher inputs: {desc.shape[0]} images x "
          f"{desc.shape[1]} descriptors, {len(pairs)} pairs, the unsharded "
          f"match on the card in chunks of 64, {int(full.num_matches.sum())}"
          f" matches, in {time.perf_counter() - t0:.1f} s")

    two = parallel_world(2, "gloo", workdir, device)
    final = report("two ranks, gloo on one card", two)
    consistent = same(two[0], two[1], keys)
    repeat = all(same({k: r[f"{k}{i}"] for k in ("q", "t", "X", "summary")},
                      {k: r[f"{k}0"] for k in ("q", "t", "X", "summary")},
                      ("q", "t", "X", "summary"))
                 for r in two for i in (1, 2))
    rel32 = abs(final - s32.final_cost) / s32.final_cost
    rel64 = abs(final - s64.final_cost) / s64.final_cost
    phase("parallel", f"two ranks: the same on both ranks={consistent}, "
          f"three solves bit-equal={repeat}, cost rel diff {rel32:.3e} "
          f"against ba.bundle_adjust float32 and {rel64:.3e} against "
          f"float64 (tol 1e-3)")
    check(consistent, "the two ranks returned different results")
    check(repeat, "the two-rank solves differ run to run")
    check(rel32 <= 1e-3 and rel64 <= 1e-3,
          "the two-rank cost is off ba.bundle_adjust's")

    launches = [int(r["launches"]) for r in two]
    equal = all(list(r["digest"]) == want for r in two)
    phase("parallel", "sharded matcher, two gloo ranks: " + "; ".join(
        f"rank {k}: {int(r['pairs_here'])} pairs, match_top2 launches "
        f"{int(r['launches'])}, match_pairs_sharded {r['match_s']:.3f} s, "
        f"kernel {r['kernel_ms']:.4f} ms "
        f"({1e3 * r['kernel_ms'] / r['pairs_here']:.2f} us a pair)"
        for k, r in enumerate(two)) + f"; gathered result equal to the "
        f"unsharded one in every field={equal} | {card}")
    check(all(n > 0 for n in launches),
          "a rank of the sharded matcher launched no match_top2")
    check(equal, "the sharded matcher differs from the unsharded one")
    return sum(launches)


def phase_viewer(workdir):
    """``model_viewer --html`` on phase ``mapper``'s first model in a fresh
    process: the embedded payload decodes to the model's points (in point
    id order), its registered images' names and centres and 8 frustum
    segments an image.  A PNG needs matplotlib: where it is installed the
    PNG is written, elsewhere the request fails with an error naming it."""
    import base64
    import importlib.util
    import re

    import numpy as np

    from privacy_preserving_sfm_torch.models.reconstruction import (
        Reconstruction,
    )

    model = os.path.join(workdir, "mapper_a", "0")
    html = os.path.join(workdir, "viewer.html")
    cli = [sys.executable, "-m", "privacy_preserving_sfm_torch.exe",
           "model_viewer", "--input_path", model]
    env = dict(os.environ, PYTHONPATH=REPO)
    # The PNG request (below) runs in its own fresh process beside this one.
    png = os.path.join(workdir, "viewer.png")
    png_run = subprocess.Popen(cli + ["--output_path", png], cwd=REPO,
                               env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        subprocess.run(cli + ["--html", html], check=True, cwd=REPO,
                       env=env, timeout=120, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        _, png_err = png_run.communicate(timeout=300)
    finally:
        if png_run.poll() is None:
            png_run.kill()
            png_run.wait()
    with open(html) as f:
        payload = json.loads(re.search(r"const D=(\{.*?\});\n",
                                       f.read()).group(1))

    def f32(key):
        return np.frombuffer(base64.b64decode(payload[key]), np.float32)

    rec = Reconstruction.read_text(model)
    pids = sorted(rec.points3d)
    reg = [i for i in sorted(rec.images) if rec.images[i].registered]
    xyz = np.stack([rec.points3d[p].xyz for p in pids]).astype(np.float32)
    centers = np.stack([rec.images[i].projection_center()
                        for i in reg]).astype(np.float32)
    ok = (payload["n_points"] == len(pids)
          and np.array_equal(f32("xyz").reshape(-1, 3), xyz)
          and payload["n_images"] == len(reg) == rec.num_registered()
          and payload["names"] == [rec.images[i].name for i in reg]
          and np.array_equal(f32("centers").reshape(-1, 3), centers)
          and f32("frusta").size == len(reg) * 8 * 2 * 3)
    phase("viewer", f"model_viewer --html: {os.path.getsize(html)} bytes "
          f"in {wall:.2f} s (fresh process), {payload['n_points']} points "
          f"and {payload['n_images']} cameras, payload equal to the model="
          f"{ok}")
    check(ok, "the viewer's payload differs from the model")
    if importlib.util.find_spec("matplotlib") is not None:
        ok = png_run.returncode == 0 and os.path.getsize(png) > 1000
        phase("viewer", f"model_viewer PNG (matplotlib installed): "
              f"written={ok}")
        check(ok, f"model_viewer PNG failed: {png_err[-2000:]}")
    else:
        ok = png_run.returncode != 0 and "matplotlib" in png_err
        phase("viewer", f"model_viewer PNG without matplotlib: refused "
              f"with an error naming it={ok}")
        check(ok, "a PNG without matplotlib did not fail as it should")


def device_split(name, card, run, kernel, top=6):
    """``run()`` under torch.profiler: wall, kernel time and busy share,
    ``kernel``'s share of kernel time and the ``top`` device events by
    self device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    host = {e.key for e in averages
            if e.device_type == torch.autograd.DeviceType.CPU}
    events = sorted((e for e in averages
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.key not in host and e.self_device_time_total > 0),
                    key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in events)
    mine = sum(e.self_device_time_total for e in events if kernel in e.key)
    each = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms "
                     f"x{e.count}" for e in events[:top])
    phase(name, f"under torch.profiler: wall {wall:.3f} s, kernel time "
          f"{total / 1e3:.3f} ms (busy {total / 1e4 / wall:.1f} %), "
          f"{kernel} {mine / 1e3:.3f} ms = {100 * mine / max(total, 1):.1f} "
          f"% of kernel time; top: {each} | {card}")
    check(mine > 0, f"the profiled run launched no {kernel}")


def ba_keys(name, launches, errors, kernel):
    """The kernels line's keys of a ``bundle_adjuster`` phase held by
    ``check_mapper_ba`` (its global BA): launches (the PCG's grid path's
    too), the largest float32 error against plain, and the kernel's,
    plain version's and bound's ms at the solve's shape."""
    e = errors[kernel]
    keys = {f"{name}_launches": launches[kernel]}
    if kernel == "schur_pcg":
        keys[f"{name}_grid_launches"] = launches["schur_pcg_grid"]
    keys.update({f"{name}_max_rel_err": e["mapper_max_rel_err"],
                 f"{name}_ms": e["global_ms"],
                 f"{name}_plain_ms": e["global_plain_ms"],
                 f"{name}_bound_ms": e["global_bound_ms"]})
    return keys


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "privacy_preserving_sfm_torch")):
        print("chip_smoke: privacy_preserving_sfm_torch not found beside "
              "this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    models_dir = tempfile.mkdtemp(prefix="chip_smoke_models_")
    maker = None
    try:
        card = phase_device()
        timed("build", phase_build)
        gram_stats = timed("gram", phase_gram, device, card)
        sync = timed("sync", phase_sync, device, card)
        pcg_stats = timed("pcg", phase_pcg, device, card, sync)
        torch.cuda.empty_cache()
        gram_aos_stats = timed("gram_aos", phase_gram_aos, device, card)
        with tempfile.TemporaryDirectory() as workdir:
            launches, _ = timed("main", phase_main_path, device, card,
                                workdir, warm_up=True)
            launches["schur_gram_aos"] = timed(
                "dense_explicit", phase_dense_explicit, device, card,
                workdir)["schur_gram_aos"]
        torch.cuda.empty_cache()
        match_stats = timed("match", phase_match, device, card)
        # The models of ba300, ba1000 and dense_implicit are made beside
        # matcher, parallel and sift, which time no kernel for the kernels
        # line; the maker has ended before ba300.
        maker, pending = start_models(models_dir)
        with tempfile.TemporaryDirectory() as workdir:
            launches["match_top2"] = timed(
                "matcher", phase_matcher, device, card,
                workdir)["match_top2"]
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as workdir:
            parallel_launches = timed("parallel", phase_parallel, device,
                                      card, workdir)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as workdir:
            timed("sift", phase_sift, device, card, workdir)
        models = finish_models(maker, pending)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as workdir:
            ba300_launches, ba300_errors = timed("ba300", phase_ba300,
                                                 device, card, workdir,
                                                 models)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as workdir:
            ba1000_launches, ba1000_errors = timed(
                "ba1000", phase_ba1000, device, card, workdir, models)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as workdir:
            extractor_launches = timed("extractor", phase_extractor, device,
                                       card, workdir)
            torch.cuda.empty_cache()
            timed("line_init", phase_line_init, device, card, workdir,
                  os.path.join(workdir, "fresh.db"))
            torch.cuda.empty_cache()
            _, mapper_launches, mapper_errors = timed(
                "mapper", phase_mapper, device, card, workdir,
                os.path.join(workdir, "fresh.db"))
            torch.cuda.empty_cache()
            hier_launches = timed("hier", phase_hier, device, card, workdir,
                                  os.path.join(workdir, "fresh.db"))
            timed("viewer", phase_viewer, workdir)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as workdir:
            auto_launches = timed("auto", phase_auto, device, card, workdir)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as workdir:
            box50d_launches, box50d_errors = timed(
                "box50d", phase_scene, device, card, workdir)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as workdir:
            timed("uncal", phase_uncal, device, card, workdir)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as workdir:
            timed("dense_implicit", phase_dense_implicit, device, card,
                  workdir, models)
    except Exception:  # every phase failure ends the run with no result
        traceback.print_exc()
        print("chip_smoke: FAILED", flush=True)
        return 1
    finally:
        if maker is not None:
            maker.terminate()
            maker.join()
        shutil.rmtree(models_dir, ignore_errors=True)
    src = "privacy_preserving_sfm_torch/kernels/"
    ref = "privacy_preserving_sfm_tpu/optim/schur_pcg.py"
    mref = "privacy_preserving_sfm_tpu/features/matching_kernels.py"
    kernels = [
        dict(name="schur_gram", route="cuda", source=src + "schur_gram.cu",
             replaces=f"{ref}:383", also_replaces=f"{ref}:500",
             launches=launches["schur_gram"],
             mapper_launches=mapper_launches["schur_gram"],
             hier_launches=hier_launches["schur_gram"],
             box50d_launches=box50d_launches["schur_gram"],
             box50d_max_rel_err=box50d_errors["schur_gram"],
             **ba_keys("ba300", ba300_launches, ba300_errors, "schur_gram"),
             **ba_keys("ba1000", ba1000_launches, ba1000_errors,
                       "schur_gram"),
             **mapper_errors["schur_gram"], **gram_stats),
        dict(name="schur_pcg", route="cuda", source=src + "schur_pcg.cu",
             replaces=f"{ref}:93", launches=launches["schur_pcg"],
             mapper_launches=mapper_launches["schur_pcg"],
             hier_launches=hier_launches["schur_pcg"],
             box50d_launches=box50d_launches["schur_pcg"],
             box50d_max_rel_err=box50d_errors["schur_pcg"],
             **ba_keys("ba300", ba300_launches, ba300_errors, "schur_pcg"),
             **ba_keys("ba1000", ba1000_launches, ba1000_errors,
                       "schur_pcg"),
             **mapper_errors["schur_pcg"], **pcg_stats),
        dict(name="match_top2", route="cuda", source=src + "match_top2.cu",
             replaces=f"{mref}:250", also_replaces=f"{mref}:123",
             launches=launches["match_top2"],
             parallel_launches=parallel_launches,
             extractor_launches=extractor_launches,
             auto_launches=auto_launches["match_top2"],
             box50d_launches=box50d_launches["match_top2"], **match_stats),
        dict(name="schur_gram_aos", route="cuda",
             source=src + "schur_gram.cu", replaces=f"{ref}:256",
             launches=launches["schur_gram_aos"], **gram_aos_stats),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:  # a rank of phase parallel
        sys.path.insert(0, REPO)
        parallel_rank(*sys.argv[2:])
        sys.exit(0)
    sys.exit(main())
