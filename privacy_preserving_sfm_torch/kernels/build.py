"""Build, load and launch the port's CUDA kernels.

The ``.cu`` sources beside this file are compiled on first use by
``nvcc``, one process per source started together, and linked into one
shared library with a plain C interface, under ``_build/`` (listed in
``.gitignore``), loaded with ``ctypes``.  The library's name carries a
hash of the sources and flags, so an edited source rebuilds.  Nothing is
built or loaded when the module is imported.

The launchers below are the only places a kernel is launched.  Each adds
one to ``LAUNCHES[name]`` when it launches, so a run can show that its
main path went through the kernels.  A kernel launches on PyTorch's
current stream and allocates nothing; the callers in
``optim/schur_pcg.py`` and ``features/matching_kernels.py`` allocate
outputs and scratch.  A failed build or a
non-zero ``cudaError_t`` from a launcher raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional, Tuple

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
SOURCES = ("schur_gram.cu", "schur_pcg.cu", "match_top2.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Launch counts by kernel name; callers may reset them to 0.
LAUNCHES: Dict[str, int] = {"schur_gram": 0, "schur_gram_aos": 0,
                             "schur_pcg": 0, "match_top2": 0}

# Capacity of the PCG kernel's per-block partial sums (its grid is one
# persistent block per resident slot, at most this many).
PCG_MAX_BLOCKS = 4096

# Rows per CTA of the match kernel: its column partials hold
# ceil(N1 / MATCH_ROWS) row blocks.
MATCH_ROWS = 128

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build privacy_preserving_sfm_torch's kernels")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels unless an up-to-date library exists; returns
    its path.  The compiler's output (ptxas register and shared-memory
    report included) is kept in ``_build/build.log``."""
    lib_path = os.path.join(BUILD_DIR, f"libppsfm_kernels_{_digest()}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, f"{src}.{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(_DIR, src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = "", False
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log += f"$ {' '.join(cmd)}\n{out}[exit {proc.returncode}]\n"
        failed |= proc.returncode != 0
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
               *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                f"[exit {proc.returncode}]\n")
        failed = proc.returncode != 0
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    log += f"[{time.perf_counter() - t0:.1f} s]\n"
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(log)
    if failed:
        raise RuntimeError(f"nvcc failed building the kernels:\n{log}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for suffix in ("f32", "f64"):
        for layout in ("", "aos_"):
            fn = getattr(lib, f"ppsfm_schur_gram_{layout}{suffix}")
            fn.argtypes = [vp] * 12 + [ci] * 7 + [vp]
            fn.restype = ci
        fn = getattr(lib, f"ppsfm_schur_pcg_{suffix}")
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
        fn.restype = ci
    lib.ppsfm_match_top2.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                     vp, vp, vp, vp, vp, vp, vp, vp]
    lib.ppsfm_match_top2.restype = ci
    _lib = lib
    return lib


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _suffix(t: torch.Tensor) -> str:
    if t.dtype not in _SUFFIX:
        raise TypeError(f"kernels take float32 or float64, got {t.dtype}")
    return _SUFFIX[t.dtype]


def _check(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launch_gram(name: str, K: int, P: int, lh, gl, slot_d, dcam, count,
                 obs, offsets, Vc, ws, ws_rhs, S, rhs, cam_block: int,
                 splits: int, bf16: bool):
    C = offsets.shape[0] - 1
    M = dcam.shape[1]
    fn = getattr(library(), f"ppsfm_{name}_{_suffix(lh)}")
    ptrs = [t.data_ptr() for t in (lh, gl, slot_d, dcam, count, obs,
                                   offsets, Vc, ws, ws_rhs, S, rhs)]
    with torch.cuda.device(lh.device):
        err = fn(*ptrs, K, P, C, M, cam_block, splits, int(bf16),
                 _stream(lh))
    _check(name, err)
    LAUNCHES[name] += 1


def launch_schur_gram(lh: torch.Tensor, gl: torch.Tensor,
                      slot_d: torch.Tensor, dcam: torch.Tensor,
                      count: torch.Tensor, obs: torch.Tensor,
                      offsets: torch.Tensor, Vc: torch.Tensor,
                      ws: torch.Tensor, ws_rhs: torch.Tensor,
                      S: torch.Tensor, rhs: torch.Tensor, cam_block: int,
                      splits: int, bf16: bool = False):
    """Launch ``schur_gram.cu`` on the SoA layout: S (6C, 6C) and rhs (6C,)
    from lh (18K, P), gl (3, P) and a Gram plan (int32: slot_d (K, P),
    dcam (P, M), count (P,), obs (P*M,), offsets (C + 1,)), through the
    scratch Vc (P, M, 24) and, for ``splits`` > 1, the split partials ws
    (splits, 6C, 6C) and ws_rhs (splits, 6C); ``bf16`` rounds V's entries
    to bfloat16.  The caller has checked shapes and types."""
    K, P = slot_d.shape
    _launch_gram("schur_gram", K, P, lh, gl, slot_d, dcam, count, obs,
                 offsets, Vc, ws, ws_rhs, S, rhs, cam_block, splits, bf16)


def launch_schur_gram_aos(lh: torch.Tensor, gl: torch.Tensor,
                          slot_d: torch.Tensor, dcam: torch.Tensor,
                          count: torch.Tensor, obs: torch.Tensor,
                          offsets: torch.Tensor, Vc: torch.Tensor,
                          ws: torch.Tensor, ws_rhs: torch.Tensor,
                          S: torch.Tensor, rhs: torch.Tensor,
                          cam_block: int, splits: int, bf16: bool = False):
    """Launch ``schur_gram.cu`` on the AoS layout: lh (P, K, 3, 6), gl
    (P, 3), slot_d (P, K); otherwise as ``launch_schur_gram``."""
    P, K = slot_d.shape
    _launch_gram("schur_gram_aos", K, P, lh, gl, slot_d, dcam, count, obs,
                 offsets, Vc, ws, ws_rhs, S, rhs, cam_block, splits, bf16)


def launch_schur_pcg(S: torch.Tensor, Minv: torch.Tensor, rhs: torch.Tensor,
                     x: torch.Tensor, work: torch.Tensor, iters: int):
    """Launch ``schur_pcg.cu``: x (N,) from S, Minv (N, N) and rhs (N,);
    ``work`` holds 4 * N + 2 * PCG_MAX_BLOCKS scratch elements."""
    N = S.shape[0]
    fn = getattr(library(), f"ppsfm_schur_pcg_{_suffix(S)}")
    with torch.cuda.device(S.device):
        err = fn(S.data_ptr(), Minv.data_ptr(), rhs.data_ptr(),
                 x.data_ptr(), work.data_ptr(), N, iters, PCG_MAX_BLOCKS,
                 _stream(S))
    _check("schur_pcg", err)
    LAUNCHES["schur_pcg"] += 1


def launch_match_top2(d1: torch.Tensor, d2: torch.Tensor, v1: torch.Tensor,
                      v2: torch.Tensor, bd12: torch.Tensor,
                      sd12: torch.Tensor, idx12: torch.Tensor,
                      cols: Optional[Tuple[torch.Tensor, ...]] = None):
    """Launch ``match_top2.cu`` on d1 (B, N1, 128), d2 (B, N2, 128) uint8
    and v1 (B, N1), v2 (B, N2) uint8: the row direction into bd12, sd12
    float32 and idx12 int32 (B, N1).  With ``cols`` = (bd21, sd21, idx21,
    part), also the column direction (B, N2), through the int32 scratch
    ``part`` of 3 * B * ceil(N1 / MATCH_ROWS) * N2 elements.  The caller
    has checked shapes and types."""
    B, N1, _ = d1.shape
    N2 = d2.shape[1]
    rest = [t.data_ptr() for t in cols] if cols is not None else [None] * 4
    with torch.cuda.device(d1.device):
        err = library().ppsfm_match_top2(
            d1.data_ptr(), d2.data_ptr(), v1.data_ptr(), v2.data_ptr(), B,
            N1, N2, bd12.data_ptr(), sd12.data_ptr(), idx12.data_ptr(),
            *rest, _stream(d1))
    _check("match_top2", err)
    LAUNCHES["match_top2"] += 1
