#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, checks
each against its plain PyTorch version on the card, then drives the
port's two paths once each through its CLI: ``bundle_adjuster`` on a
seeded synthetic model at the line-BA benchmark's size (100 cameras,
20,000 points, 120,000 observations), and ``exhaustive_matcher`` on a
seeded synthetic database of 64 images x 8,192 descriptors (the
reference's default feature cap; 2,016 pairs), checked against the
generator's true correspondences, against the plain version on 16 pairs
and against the bounded-memory block mode.  Prints one line per phase,
then a JSON
line with each kernel's launches, error and times, the card's name and
power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Any failed phase
exits non-zero without that line; so does a machine without a CUDA
device, or a directory without the ``privacy_preserving_sfm_torch``
package.
"""

from __future__ import annotations

import json
import os
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
PCG_CAMS = [100, 320, 640]
CG_ITERS = 30
MAIN = dict(num_images=100, num_points=20000, obs_per_point=6,
            meas_noise=2e-4)
LM_ITERS = 20
# (B, N1, N2, special) for the match kernel checks: the production shape
# (the reference's max_num_features = 8192), padding with duplicates and
# ties, and an N1 that is not a multiple of 128.
MATCH_SHAPES = [(4, 8192, 8192, False), (3, 384, 512, True),
                (2, 1000, 8192, False)]
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


def phase_build():
    from privacy_preserving_sfm_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    dt = time.perf_counter() - t0
    with open(os.path.join(build.BUILD_DIR, "build.log")) as f:
        ptxas = [ln.strip() for ln in f
                 if "registers" in ln or "spill" in ln]
    phase("build", f"kernels built and loaded in {dt:.2f} s "
          f"({', '.join(build.SOURCES)})")
    for ln in ptxas:
        phase("build", ln)


def gram_inputs(K, P, C, dtype, device, seed):
    """Random Gram inputs; every point sees K distinct cameras."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    lh = torch.randn(18 * K, P, generator=g, device=device, dtype=dtype)
    gl = torch.randn(3, P, generator=g, device=device, dtype=dtype)
    cam = torch.rand(P, C, generator=g, device=device).argsort(dim=1)
    return lh, gl, cam[:, :K].T.contiguous().to(torch.int32)


def phase_gram(device, reps=5):
    """Gram kernel vs gram_soa_plain; returns the main-path shape's stats
    and the float64 Grams (for the PCG systems)."""
    import torch

    from privacy_preserving_sfm_torch.optim import schur_pcg

    grams = {}
    main_stats = None
    for K, P, C in GRAM_SHAPES:
        lh, gl, cam = gram_inputs(K, P, C, torch.float64, device, seed=C + K)
        S_ref, r_ref = schur_pcg.gram_soa_plain(lh, gl, cam, C)
        s_scale = float(S_ref.abs().max())
        r_scale = float(r_ref.abs().max())
        for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
            a, b = lh.to(dtype), gl.to(dtype)
            S, r = schur_pcg.gram_soa(a, b, cam, C)
            S2, r2 = schur_pcg.gram_soa(a, b, cam, C)
            torch.cuda.synchronize()
            err_s = float((S.double() - S_ref).abs().max())
            err_r = float((r.double() - r_ref).abs().max())
            asym = float((S - S.T).abs().max())
            bit_equal = torch.equal(S, S2) and torch.equal(r, r2)
            ms = cuda_ms(lambda: schur_pcg.gram_soa(a, b, cam, C), reps)
            plain_ms = cuda_ms(
                lambda: schur_pcg.gram_soa_plain(a, b, cam, C), reps)
            name = str(dtype).replace("torch.", "")
            phase("gram", f"K={K} P={P} C={C} {name}: max|dS|={err_s:.3e} "
                  f"(tol {tol * s_scale:.3e}) max|drhs|={err_r:.3e} "
                  f"(tol {tol * r_scale:.3e}) max|S-S^T|={asym:.3e} "
                  f"bit-equal={bit_equal} kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms")
            check(err_s <= tol * s_scale, "Gram S disagrees")
            check(err_r <= tol * r_scale, "Gram rhs disagrees")
            check(asym <= 1e-6 * s_scale, "Gram S not symmetric")
            check(bit_equal, "Gram kernel not deterministic")
            if (K, P, C) == GRAM_SHAPES[0] and dtype == torch.float32:
                main_stats = dict(max_abs_err=err_s, ms=ms, plain_ms=plain_ms)
        grams[C] = S_ref
        del lh, gl, S_ref
    return main_stats, grams


def pcg_system(S_corr, C, device, seed):
    """A damped SPD system from a Gram, padded with identity to
    padded_dim(C), with its block-Jacobi preconditioner and a rhs."""
    import torch

    from privacy_preserving_sfm_torch.optim import schur_pcg

    n = 6 * C
    N = schur_pcg.padded_dim(C)
    S = torch.eye(N, dtype=torch.float64, device=device)
    d = torch.diagonal(S_corr)
    S[:n, :n] = S_corr + torch.diag(0.1 * d + 1e-3 * float(d.max()))
    blocks = schur_pcg.diag_blocks(S, C)
    Minv = torch.eye(N, dtype=torch.float64, device=device)
    inv = torch.linalg.inv(blocks)
    ar = torch.arange(C, device=device)
    Minv[:n, :n].view(C, 6, C, 6)[ar, :, ar, :] = inv
    g = torch.Generator(device=device).manual_seed(seed)
    rhs = torch.randn(N, generator=g, device=device, dtype=torch.float64)
    return S, Minv, rhs


def phase_pcg(device, grams, reps=5):
    import torch

    from privacy_preserving_sfm_torch.optim import schur_pcg

    main_stats = None
    for C in PCG_CAMS:
        S64, M64, r64 = pcg_system(grams[C], C, device, seed=C)
        for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
            S, M, r = S64.to(dtype), M64.to(dtype), r64.to(dtype)
            x = schur_pcg.pcg(S, M, r, CG_ITERS)
            x_ref = schur_pcg.pcg_plain(S, M, r, CG_ITERS)
            torch.cuda.synchronize()
            rel = float((x - x_ref).norm() / x_ref.norm())
            err = float((x - x_ref).abs().max())
            ms = cuda_ms(lambda: schur_pcg.pcg(S, M, r, CG_ITERS), reps)
            plain_ms = cuda_ms(
                lambda: schur_pcg.pcg_plain(S, M, r, CG_ITERS), reps)
            name = str(dtype).replace("torch.", "")
            phase("pcg", f"C={C} N={S.shape[0]} iters={CG_ITERS} {name}: "
                  f"|dx|/|x|={rel:.3e} (tol {tol:.0e}) max|dx|={err:.3e} "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            check(rel <= tol, "PCG disagrees with pcg_plain")
            if C == PCG_CAMS[0] and dtype == torch.float32:
                main_stats = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return main_stats


def phase_main_path(device, card, workdir):
    import numpy as np
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
    for name in ("schur_gram", "schur_pcg"):
        check(launches[name] > 0,
              f"kernel {name} was not launched by the main path")

    out = Reconstruction.read_text(out_dir)
    check(out.num_registered() == MAIN["num_images"], "images lost")
    finite = all(np.isfinite(img.qvec).all() and np.isfinite(img.tvec).all()
                 for img in out.images.values())
    finite &= all(np.isfinite(p.xyz).all() for p in out.points3d.values())
    check(finite, "non-finite pose or point in the output model")
    check(len(out.points3d) == MAIN["num_points"], "points lost")
    err_out = line_error_sum(out)
    phase("main", f"squared pixel line error sum {err_in!r} -> {err_out!r} "
          f"(ratio {err_out / err_in:.4f}, must be <= 0.5)")
    check(err_out <= 0.5 * err_in, "BA did not halve the line error")

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
    return launches


def match_inputs(b, n1, n2, special, device, seed):
    """SIFT-convention descriptors on the card; with ``special``, exact
    duplicates making ties along a row and a column, padding on both
    sides in pair 1 and a single valid candidate per row in pair 2."""
    import numpy as np
    import torch

    from privacy_preserving_sfm_torch.utils.synthetic import sift_like

    rng = np.random.default_rng(seed)
    d1 = sift_like(rng.dirichlet(np.full(128, 0.2), (b, n1)))
    d2 = sift_like(rng.dirichlet(np.full(128, 0.2), (b, n2)))
    v1 = np.ones((b, n1), bool)
    v2 = np.ones((b, n2), bool)
    if special:
        d2[0, 40] = d2[0, n2 - 1] = d1[0, 7]
        d2[1, 3] = d2[1, 5]
        d1[0, n1 - 1] = d1[0, 7]
        v1[1, (2 * n1) // 3:] = False
        v2[1, n2 // 2:] = False
        v2[2, 1:] = False
    return [torch.from_numpy(a).to(device) for a in (d1, d2, v1, v2)]


def phase_match(device, card, reps=5):
    """Match kernel vs its plain version: exact equality of the six
    tables (three in row-only mode); returns the production shape's
    stats."""
    import torch

    from privacy_preserving_sfm_torch.features import matching
    from privacy_preserving_sfm_torch.features import matching_kernels as mk

    plain = matching._top2_both_batched_plain
    main_stats = None
    for b, n1, n2, special in MATCH_SHAPES:
        d1, d2, v1, v2 = match_inputs(b, n1, n2, special, device,
                                      seed=n1 + n2)
        ones = torch.ones_like(v1)
        got = mk.top2_scores_bidir(d1, d2, v1, v2)
        again = mk.top2_scores_bidir(d1, d2, v1, v2)
        rows = mk.top2_scores(d1, d2, v2)
        torch.cuda.synchronize()
        ref = plain(d1, d2, v1, v2)
        ref_rows = plain(d1, d2, ones, v2)[:3]
        exact = all(torch.equal(g, r) for g, r in zip(got, ref))
        exact_rows = all(torch.equal(g, r) for g, r in zip(rows, ref_rows))
        stable = all(torch.equal(g, h) for g, h in zip(got, again))
        err = max(float((g.double() - r.double()).abs().max())
                  for g, r in zip(got, ref))
        del ref, ref_rows, got, again, rows
        ms = cuda_ms(lambda: mk.top2_scores_bidir(d1, d2, v1, v2), reps)
        ms_rows = cuda_ms(lambda: mk.top2_scores(d1, d2, v2), reps)
        plain_ms = cuda_ms(lambda: plain(d1, d2, v1, v2), reps)
        plain_rows_ms = cuda_ms(lambda: plain(d1, d2, ones, v2)[:3], reps)
        ops = 2.0 * b * n1 * n2 * 128
        phase("match", f"B={b} N1={n1} N2={n2}"
              f"{' (padding, duplicates, ties)' if special else ''}: "
              f"six tables exact={exact}, row-only exact={exact_rows}, "
              f"bit-equal across runs={stable}, max|diff|={err!r} | "
              f"bidir kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} T int-op/s, "
              f"{ms / b * 1e3:.1f} us/pair), plain {plain_ms:.4f} ms | "
              f"row-only kernel {ms_rows:.4f} ms, plain "
              f"{plain_rows_ms:.4f} ms | {card}")
        check(exact, "match kernel disagrees with its plain version")
        check(exact_rows, "row-only match kernel disagrees")
        check(stable, "match kernel not deterministic")
        if main_stats is None:
            main_stats = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        del d1, d2, v1, v2
        torch.cuda.empty_cache()
    return main_stats


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
    return launches


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
        phase_build()
        gram_stats, grams = phase_gram(device)
        pcg_stats = phase_pcg(device, grams)
        del grams
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as workdir:
            launches = phase_main_path(device, card, workdir)
        torch.cuda.empty_cache()
        match_stats = phase_match(device, card)
        with tempfile.TemporaryDirectory() as workdir:
            launches["match_top2"] = phase_matcher(
                device, card, workdir)["match_top2"]
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
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
