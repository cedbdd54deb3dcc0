"""Explicit Schur complement: the reduced camera system and its PCG solve.

Port of ``privacy_preserving_sfm_tpu/optim/schur_pcg.py``.  Two functions
carry the solver's heavy work, each with a plain PyTorch version and a
hand-written Hopper kernel (``kernels/``):

* ``gram_soa``: the Schur Gram ``S_corr = V^T V`` (6C, 6C) and
  ``rhs_corr = V^T gL`` (6C,), where V (3P, 6C) is the camera expansion of
  the per-observation blocks ``lh_stack`` (18K, P), rows (a*6+i)*K + k.
  Plain twin of ``gram_soa_xla``: ``gram_soa_plain``.  Kernel:
  ``kernels/schur_gram.cu`` (replaces the TPU kernels ``gram_soa`` and
  ``gram_soa_blocked``).
* ``pcg``: a fixed number of block-Jacobi PCG steps on dense S.  Plain
  twin of ``pcg_xla``: ``pcg_plain``.  Kernel: ``kernels/schur_pcg.cu``
  (replaces the TPU kernel ``pcg_fused``).

``gram_soa`` and ``pcg`` dispatch on the device of their inputs: tensors
on the CPU take the plain version, CUDA tensors launch the kernel, and
anything else raises.  There is no fallback from a failed kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from privacy_preserving_sfm_torch.kernels import build as kernels

_LANE = 128
# Column cameras per CTA strip of the Gram kernel: the strip (6, 6*CB)
# is held in shared memory (36 KB in either precision).
_GRAM_CAM_BLOCK = {torch.float32: 256, torch.float64: 128}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def padded_dim(num_cams: int) -> int:
    return _round_up(6 * num_cams, _LANE)


def explicit_fits(num_cams: int) -> bool:
    """True when the explicit-Schur path supports the camera count
    (C <= 1024, the reference's DENSE_SCHUR + SPARSE_SCHUR regimes)."""
    return padded_dim(num_cams) <= 6144


def diag_blocks(S: torch.Tensor, num_cams: int) -> torch.Tensor:
    """Extract (C, 6, 6) diagonal blocks from dense S (>=6C, >=6C)."""
    n = 6 * num_cams
    S4 = S[:n, :n].reshape(num_cams, 6, num_cams, 6)
    ar = torch.arange(num_cams, device=S.device)
    return S4[ar, :, ar, :]


def _device_kind(t: torch.Tensor) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise RuntimeError(f"no Schur kernel for device {t.device}")
    return kind


# ---------------------------------------------------------------------------
# Schur Gram
# ---------------------------------------------------------------------------


def gram_soa_plain(lh_stack: torch.Tensor, gL: torch.Tensor,
                   cam_kp: torch.Tensor,
                   num_cams: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the Schur Gram (twin of ``gram_soa_xla``).

    Materializes V (P, 3, C, 6) by adding each slot's (3, 6) block into
    its camera's columns (repeated cameras of one point add up), then
    ``S_corr = V^T V`` and ``rhs_corr = V^T vec(gL^T)`` as two matrix
    products.  Slots with a negative camera id contribute nothing.
    """
    RK, P = lh_stack.shape
    K = RK // 18
    C = num_cams
    n = 6 * C
    lh4 = lh_stack.reshape(3, 6, K, P)
    V = lh_stack.new_zeros(P, 3, C + 1, 6)  # column C takes id -1 slots
    pts = torch.arange(P, device=lh_stack.device)
    cam = torch.where(cam_kp < 0, C, cam_kp).long()
    for k in range(K):
        V[pts, :, cam[k], :] += lh4[:, :, k, :].permute(2, 0, 1)
    V = V[:, :, :C, :].reshape(3 * P, n)
    S = V.T @ V
    rhs = V.T @ gL.T.reshape(-1)
    return S, rhs


def _gram_cuda(lh_stack, gL, cam_kp, num_cams):
    RK, P = lh_stack.shape
    K = RK // 18
    C = num_cams
    if lh_stack.dtype not in _GRAM_CAM_BLOCK or gL.dtype != lh_stack.dtype:
        raise TypeError("gram_soa kernel takes float32 or float64 lh/gL "
                        f"of one dtype, got {lh_stack.dtype}/{gL.dtype}")
    if RK != 18 * K or gL.shape != (3, P) or cam_kp.shape != (K, P):
        raise ValueError("gram_soa shapes: lh (18K, P), gL (3, P), cam (K, P)"
                         f"; got {tuple(lh_stack.shape)}, {tuple(gL.shape)}, "
                         f"{tuple(cam_kp.shape)}")
    if K * P >= 2 ** 31:
        raise ValueError(f"gram_soa kernel indexes slots in int32; "
                         f"K * P = {K * P} is too large")
    dev = lh_stack.device
    if gL.device != dev or cam_kp.device != dev:
        raise ValueError("gram_soa inputs must share one device")
    lh = lh_stack.contiguous()
    gl = gL.contiguous()
    cam = cam_kp.to(torch.int32).contiguous()
    # Camera-sorted observation list: flat slot ids k*P + p ordered by
    # (camera, point, slot); the keys are unique, so the order is fixed.
    flat = cam.reshape(-1).long()
    slot = torch.arange(K * P, device=dev)
    valid = flat >= 0
    slot = slot[valid]
    cams = flat[valid]
    pk = (slot % P) * K + slot // P
    _, perm = torch.sort(cams * (K * P) + pk)
    order = slot[perm].to(torch.int32)
    counts = torch.bincount(cams, minlength=C)
    offsets = torch.zeros(C + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    offsets = offsets.to(torch.int32)
    S = torch.empty(6 * C, 6 * C, dtype=lh.dtype, device=dev)
    rhs = torch.empty(6 * C, dtype=lh.dtype, device=dev)
    kernels.launch_schur_gram(lh, gl, cam, order, offsets, S, rhs,
                              min(C, _GRAM_CAM_BLOCK[lh.dtype]))
    return S, rhs


def gram_soa(lh_stack: torch.Tensor, gL: torch.Tensor, cam_kp: torch.Tensor,
             num_cams: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """S_corr (6C, 6C) and rhs_corr (6C,) in the 6c+i layout.

    lh_stack: (18K, P), rows (a*6+i)*K + k; gL: (3, P); cam_kp: (K, P)
    integer camera ids (negative = no camera).  CPU tensors take
    ``gram_soa_plain``; CUDA tensors launch ``kernels/schur_gram.cu``,
    which takes any C and K (no C <= 1024 / K <= 16 gate).
    """
    if _device_kind(lh_stack) == "cpu":
        return gram_soa_plain(lh_stack, gL, cam_kp, num_cams)
    return _gram_cuda(lh_stack, gL, cam_kp, num_cams)


# ---------------------------------------------------------------------------
# PCG
# ---------------------------------------------------------------------------


def _guard(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v.abs() < 1e-30, v.new_full((), 1e-30), v)


def pcg_plain(S: torch.Tensor, Minv: torch.Tensor, rhs: torch.Tensor,
              iters: int) -> torch.Tensor:
    """Plain version of the PCG (twin of ``pcg_xla``): fixed ``iters``
    steps, no host synchronisation."""
    z = Minv @ rhs
    x = torch.zeros_like(rhs)
    r = rhs
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = S @ p
        pAp = torch.sum(p * Ap)
        alpha = rz / _guard(pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv @ r
        rz_new = torch.sum(r * z)
        beta = rz_new / _guard(rz)
        p = z + beta * p
        rz = rz_new
    return x


def _pcg_cuda(S, Minv, rhs, iters):
    N = S.shape[0]
    if S.dtype not in (torch.float32, torch.float64) or \
            Minv.dtype != S.dtype or rhs.dtype != S.dtype:
        raise TypeError("pcg kernel takes float32 or float64 S/Minv/rhs of "
                        f"one dtype, got {S.dtype}/{Minv.dtype}/{rhs.dtype}")
    if S.shape != (N, N) or Minv.shape != (N, N) or rhs.shape != (N,):
        raise ValueError("pcg shapes: S, Minv (N, N), rhs (N,); got "
                         f"{tuple(S.shape)}, {tuple(Minv.shape)}, "
                         f"{tuple(rhs.shape)}")
    if Minv.device != S.device or rhs.device != S.device:
        raise ValueError("pcg inputs must share one device")
    S = S.contiguous()
    Minv = Minv.contiguous()
    rhs = rhs.contiguous()
    x = torch.empty_like(rhs)
    work = torch.empty(4 * N + 2 * kernels.PCG_MAX_BLOCKS, dtype=S.dtype,
                       device=S.device)
    kernels.launch_schur_pcg(S, Minv, rhs, x, work, iters)
    return x


def pcg(S: torch.Tensor, Minv: torch.Tensor, rhs: torch.Tensor,
        iters: int) -> torch.Tensor:
    """Solve S x = rhs by ``iters`` steps of PCG with preconditioner Minv.

    S, Minv: (N, N) symmetric; rhs: (N,).  CPU tensors take
    ``pcg_plain``; CUDA tensors launch ``kernels/schur_pcg.cu``.
    """
    if _device_kind(S) == "cpu":
        return pcg_plain(S, Minv, rhs, iters)
    return _pcg_cuda(S, Minv, rhs, iters)
