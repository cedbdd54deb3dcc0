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
to the dense-block implicit solver (phase ``dense_implicit``); and
``exhaustive_matcher`` on a seeded synthetic database of 64 images x 8,192
descriptors (the reference's default feature cap; 2,016 pairs), checked
against the generator's true correspondences, against the plain version
on 16 pairs and against the bounded-memory block mode, then once more
under torch.profiler.  Prints one line per phase and each phase's
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

import json
import os
import re
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
# line), the Gram's regimes and the explicit ceiling (n = 6,144); at the
# C of PCG_BOTH, both of the kernel's paths are checked and timed (the
# cluster path where it fits), to place the crossover between them.
PCG_CAMS = [16, 100, 320, 640, 1024]
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


def timed(name, fn, *args):
    """``fn(*args)``, then a line with the phase's seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
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


def phase_main_path(device, card, workdir):
    import torch

    from privacy_preserving_sfm_torch.exe import ppsfm
    from privacy_preserving_sfm_torch.kernels import build
    from privacy_preserving_sfm_torch.models.reconstruction import (
        Reconstruction,
    )
    from privacy_preserving_sfm_torch.optim import ba as ba_mod
    from privacy_preserving_sfm_torch.optim import ba_dense, ba_soa
    from privacy_preserving_sfm_torch.sfm.incremental_mapper import (
        IncrementalMapper,
    )
    from privacy_preserving_sfm_torch.utils.synthetic import (
        line_error_sum, synthetic_model,
    )

    t0 = time.perf_counter()
    in_dir = os.path.join(workdir, "in")
    out_dir = os.path.join(workdir, "out")
    synthetic_model(seed=0, **MAIN).write_text(in_dir)
    warm_dir = os.path.join(workdir, "warm")
    synthetic_model(10, 500, 6, seed=1).write_text(warm_dir)
    start = Reconstruction.read_text(in_dir)
    err_in = line_error_sum(start)
    phase("main", f"synthetic model: {start.num_registered()} images, "
          f"{len(start.points3d)} points, {start.num_observations()} "
          f"observations, written in {time.perf_counter() - t0:.1f} s")

    # The first solve in a process pays one-time costs (lazy loading of
    # PyTorch's CUDA modules, torch.func set-up); time them apart.
    t0 = time.perf_counter()
    ppsfm.main(["bundle_adjuster", "--input_path", warm_dir, "--output_path",
                os.path.join(workdir, "warm_out"), "--max_num_iterations",
                "3", "--device", device.type, "--dtype", "float32"])
    torch.cuda.synchronize()
    phase("main", f"warm-up solve (10 images, first in the process): "
          f"{time.perf_counter() - t0:.3f} s")

    for name in build.LAUNCHES:
        build.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mapper = ppsfm.main(["bundle_adjuster", "--input_path", in_dir,
                         "--output_path", out_dir, "--max_num_iterations",
                         str(LM_ITERS), "--device", device.type,
                         "--dtype", "float32"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    summary = mapper.last_summary
    solve_s = mapper.phase_times["ba_solve"]
    nobs = start.num_observations()
    rate = nobs * summary.num_iterations / solve_s
    phase("main", f"bundle_adjuster --device {device.type} (float32): "
          f"wall {wall:.3f} s, ba_solve {solve_s:.3f} s, LM iterations "
          f"{summary.num_iterations}, {rate:.1f} obs*iter/s (ba_solve), "
          f"peak device memory {peak / 2**20:.1f} MiB, launches "
          f"{launches} | {card}")
    for name in ("schur_gram", "schur_pcg", "schur_pcg_cluster"):
        check(launches[name] > 0,
              f"kernel {name} was not launched by the main path")

    check_output_model(out_dir, MAIN, err_in, "main")

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
    again = gram_share("main", card, lambda: ppsfm.main([
        "bundle_adjuster", "--input_path", in_dir, "--output_path",
        os.path.join(workdir, "out_prof"), "--max_num_iterations",
        str(LM_ITERS), "--device", device.type, "--dtype", "float32"]))
    check_same_solve("main", out_dir, os.path.join(workdir, "out_prof"),
                     summary, again.last_summary)
    return launches


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


def phase_dense_implicit(device, card, workdir):
    """A 1,280-camera global BA with no override: the mapper sends it to
    the dense solver's implicit CG, which runs no Schur kernel."""
    from privacy_preserving_sfm_torch.models.reconstruction import (
        Reconstruction,
    )
    from privacy_preserving_sfm_torch.optim import ba as ba_mod
    from privacy_preserving_sfm_torch.utils.synthetic import (
        line_error_sum, synthetic_model,
    )

    t0 = time.perf_counter()
    in_dir = os.path.join(workdir, "in")
    out_dir = os.path.join(workdir, "out")
    synthetic_model(seed=3, **IMPLICIT).write_text(in_dir)
    start = Reconstruction.read_text(in_dir)
    nobs = start.num_observations()
    phase("dense_implicit", f"synthetic model: {start.num_registered()} "
          f"images, {len(start.points3d)} points, {nobs} observations, "
          f"written in {time.perf_counter() - t0:.1f} s")
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
    check_output_model(out_dir, IMPLICIT, line_error_sum(start),
                       "dense_implicit")
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
    try:
        card = phase_device()
        timed("build", phase_build)
        gram_stats = timed("gram", phase_gram, device, card)
        sync = timed("sync", phase_sync, device, card)
        pcg_stats = timed("pcg", phase_pcg, device, card, sync)
        torch.cuda.empty_cache()
        gram_aos_stats = timed("gram_aos", phase_gram_aos, device, card)
        with tempfile.TemporaryDirectory() as workdir:
            launches = timed("main", phase_main_path, device, card, workdir)
            launches["schur_gram_aos"] = timed(
                "dense_explicit", phase_dense_explicit, device, card,
                workdir)["schur_gram_aos"]
        torch.cuda.empty_cache()
        match_stats = timed("match", phase_match, device, card)
        with tempfile.TemporaryDirectory() as workdir:
            launches["match_top2"] = timed(
                "matcher", phase_matcher, device, card,
                workdir)["match_top2"]
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as workdir:
            timed("dense_implicit", phase_dense_implicit, device, card,
                  workdir)
    except Exception:  # every phase failure ends the run with no result
        traceback.print_exc()
        print("chip_smoke: FAILED", flush=True)
        return 1
    src = "privacy_preserving_sfm_torch/kernels/"
    ref = "privacy_preserving_sfm_tpu/optim/schur_pcg.py"
    mref = "privacy_preserving_sfm_tpu/features/matching_kernels.py"
    kernels = [
        dict(name="schur_gram", route="cuda", source=src + "schur_gram.cu",
             replaces=f"{ref}:383", also_replaces=f"{ref}:500",
             launches=launches["schur_gram"], **gram_stats),
        dict(name="schur_pcg", route="cuda", source=src + "schur_pcg.cu",
             replaces=f"{ref}:93", launches=launches["schur_pcg"],
             **pcg_stats),
        dict(name="match_top2", route="cuda", source=src + "match_top2.cu",
             replaces=f"{mref}:250", also_replaces=f"{mref}:123",
             launches=launches["match_top2"], **match_stats),
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
    sys.exit(main())
