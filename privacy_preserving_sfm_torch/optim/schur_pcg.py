"""Explicit Schur complement: the reduced camera system and its PCG solve.

Port of ``privacy_preserving_sfm_tpu/optim/schur_pcg.py``.  Two functions
carry the explicit-Schur solvers' heavy work, each with a plain PyTorch
version and a hand-written Hopper kernel (``kernels/``):

* the Schur Gram ``S_corr = V^T V`` (6C, 6C) and ``rhs_corr = V^T gL``
  (6C,), where V (3P, 6C) is the camera expansion of the per-observation
  (3, 6) blocks ``L^T Hcp``.  Two input layouts:
  - ``gram_soa`` takes ``lh_stack`` (18K, P), rows (a*6+i)*K + k, the
    layout of ``ba_soa``.  Plain twin of ``gram_soa_xla``:
    ``gram_soa_plain``.  Kernel: ``kernels/schur_gram.cu`` (replaces the
    TPU kernels ``gram_soa`` and ``gram_soa_blocked``);
  - ``gram_aos`` takes ``LH`` (P, K, 3, 6), the layout of ``ba_dense``.
    Plain twin of ``build_u_matrix`` + the one Gram product of
    ``ba_dense``: ``gram_aos_plain``.  Kernel: the same source with its
    AoS staging (replaces the TPU kernel ``gram_fused``).
* ``pcg``: a fixed number of block-Jacobi PCG steps on dense S.  Plain
  twin of ``pcg_xla``: ``pcg_plain``.  Kernel: ``kernels/schur_pcg.cu``
  (replaces the TPU kernel ``pcg_fused``).

``gram_soa``, ``gram_aos`` and ``pcg`` dispatch on the device of their
inputs: tensors on the CPU take the plain version, CUDA tensors launch
the kernel, and anything else raises.  There is no fallback from a failed
kernel.  The reference's ``gram_mode`` and ``PPSFM_PCG`` switches (TPU
kernel against XLA loop) have no counterpart: ``plain=True`` on a solver
is the only way to the plain versions on the card.

``precision="bf16"`` is the Gram's one lower-precision mode (the
reference's ``schur_precision``): the V operands of ``S_corr`` are
rounded to bfloat16 and their products summed in the input precision;
``rhs_corr`` stays unrounded.  Kernel and plain version both round each
observation slot's block before adding it into V.  The reference rounds
V's entries, which are sums over the slots of one point that share a
camera, so the two differ only where a point has two valid slots in one
camera.
"""

from __future__ import annotations

from typing import Tuple

import torch

from privacy_preserving_sfm_torch.kernels import build as kernels

_LANE = 128
# Column cameras per CTA strip of the Gram kernel: the strip (6, 6*CB)
# is held in shared memory (36 KB in either precision).
_GRAM_CAM_BLOCK = {torch.float32: 256, torch.float64: 128}
_PRECISIONS = ("f32", "bf16")


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


def embed_block_diag(blocks: torch.Tensor, n_pad: int) -> torch.Tensor:
    """(C, 6, 6) diagonal blocks -> dense (n_pad, n_pad), identity padding."""
    C = blocks.shape[0]
    n = 6 * C
    out = blocks.new_zeros(n_pad, n_pad)
    ar = torch.arange(C, device=blocks.device)
    out[:n, :n].view(C, 6, C, 6)[ar, :, ar, :] = blocks
    pad = torch.arange(n, n_pad, device=blocks.device)
    out[pad, pad] = 1.0
    return out


def _device_kind(t: torch.Tensor) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise RuntimeError(f"no Schur kernel for device {t.device}")
    return kind


# ---------------------------------------------------------------------------
# Schur Gram
# ---------------------------------------------------------------------------


def _check_precision(precision: str):
    if precision not in _PRECISIONS:
        raise ValueError(f"Gram precision must be one of {_PRECISIONS}, "
                         f"got {precision!r}")


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest even) and cast back to its dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _expand_v(blocks: torch.Tensor, cam: torch.Tensor,
              num_cams: int) -> torch.Tensor:
    """V (3P, 6C) from blocks (P, K, 3, 6): each slot's block is added
    into its camera's columns (repeated cameras of one point add up);
    slots with a negative camera id contribute nothing."""
    P, K = cam.shape
    C = num_cams
    V = blocks.new_zeros(P, 3, C + 1, 6)  # column C takes id -1 slots
    pts = torch.arange(P, device=blocks.device)
    cam = torch.where(cam < 0, C, cam).long()
    for k in range(K):
        V[pts, :, cam[:, k], :] += blocks[:, k]
    return V[:, :, :C, :].reshape(3 * P, 6 * C)


def gram_aos_plain(LH: torch.Tensor, gL: torch.Tensor, obs_cam: torch.Tensor,
                   num_cams: int, precision: str = "f32"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the AoS Schur Gram.

    Materializes V (3P, 6C) and computes ``S_corr = V^T V`` and
    ``rhs_corr = V^T vec(gL)`` as two matrix products, the twin of the
    reference's ``build_u_matrix`` followed by its one Gram product.  With
    ``precision="bf16"`` the blocks are rounded before V is built for
    ``S_corr`` (see the module note).
    """
    _check_precision(precision)
    V = _expand_v(LH, obs_cam, num_cams)
    rhs = V.T @ gL.reshape(-1)
    if precision == "bf16":
        V = _expand_v(_round_bf16(LH), obs_cam, num_cams)
    return V.T @ V, rhs


def gram_soa_plain(lh_stack: torch.Tensor, gL: torch.Tensor,
                   cam_kp: torch.Tensor, num_cams: int,
                   precision: str = "f32"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the SoA Schur Gram (twin of ``gram_soa_xla``):
    ``gram_aos_plain`` on the same blocks in the AoS layout."""
    RK, P = lh_stack.shape
    K = RK // 18
    LH = lh_stack.reshape(3, 6, K, P).permute(3, 2, 0, 1)
    return gram_aos_plain(LH, gL.T, cam_kp.T, num_cams, precision)


def _check_gram_inputs(name, lh, gL, cam, lh_shape, gl_shape, cam_shape,
                       precision):
    _check_precision(precision)
    if lh.dtype not in _GRAM_CAM_BLOCK or gL.dtype != lh.dtype:
        raise TypeError(f"{name} kernel takes float32 or float64 lh/gL of "
                        f"one dtype, got {lh.dtype}/{gL.dtype}")
    if (tuple(lh.shape), tuple(gL.shape), tuple(cam.shape)) != (
            lh_shape, gl_shape, cam_shape):
        raise ValueError(f"{name} shapes: lh {lh_shape}, gL {gl_shape}, cam "
                         f"{cam_shape}; got {tuple(lh.shape)}, "
                         f"{tuple(gL.shape)}, {tuple(cam.shape)}")
    if gL.device != lh.device or cam.device != lh.device:
        raise ValueError(f"{name} inputs must share one device")


def _camera_order(cam_kp: torch.Tensor, num_cams: int):
    """The kernel's camera-sorted observation list: flat slot ids k*P + p
    ordered by (camera, point, slot), and each camera's offsets into it
    (C + 1,), both int32.  The sort keys are unique, so the order is
    fixed.  Negative camera ids are left out."""
    K, P = cam_kp.shape
    if K * P >= 2 ** 31:
        raise ValueError(f"the Gram kernel indexes slots in int32; "
                         f"K * P = {K * P} is too large")
    dev = cam_kp.device
    flat = cam_kp.reshape(-1).long()
    slot = torch.arange(K * P, device=dev)
    valid = flat >= 0
    slot = slot[valid]
    cams = flat[valid]
    pk = (slot % P) * K + slot // P
    _, perm = torch.sort(cams * (K * P) + pk)
    order = slot[perm].to(torch.int32)
    counts = torch.bincount(cams, minlength=num_cams)
    offsets = torch.zeros(num_cams + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    return order, offsets.to(torch.int32)


def _gram_out(lh: torch.Tensor, num_cams: int):
    n = 6 * num_cams
    return (torch.empty(n, n, dtype=lh.dtype, device=lh.device),
            torch.empty(n, dtype=lh.dtype, device=lh.device))


def _gram_soa_cuda(lh_stack, gL, cam_kp, num_cams, precision):
    RK, P = lh_stack.shape
    K = RK // 18
    _check_gram_inputs("gram_soa", lh_stack, gL, cam_kp, (18 * K, P), (3, P),
                       (K, P), precision)
    cam = cam_kp.to(torch.int32).contiguous()
    order, offsets = _camera_order(cam, num_cams)
    S, rhs = _gram_out(lh_stack, num_cams)
    kernels.launch_schur_gram(
        lh_stack.contiguous(), gL.contiguous(), cam, order, offsets, S, rhs,
        min(num_cams, _GRAM_CAM_BLOCK[lh_stack.dtype]), precision == "bf16")
    return S, rhs


def _gram_aos_cuda(LH, gL, obs_cam, num_cams, precision):
    P, K = obs_cam.shape
    _check_gram_inputs("gram_aos", LH, gL, obs_cam, (P, K, 3, 6), (P, 3),
                       (P, K), precision)
    cam = obs_cam.to(torch.int32).contiguous()
    order, offsets = _camera_order(cam.T, num_cams)
    S, rhs = _gram_out(LH, num_cams)
    kernels.launch_schur_gram_aos(
        LH.contiguous(), gL.contiguous(), cam, order, offsets, S, rhs,
        min(num_cams, _GRAM_CAM_BLOCK[LH.dtype]), precision == "bf16")
    return S, rhs


def gram_soa(lh_stack: torch.Tensor, gL: torch.Tensor, cam_kp: torch.Tensor,
             num_cams: int, precision: str = "f32"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """S_corr (6C, 6C) and rhs_corr (6C,) in the 6c+i layout.

    lh_stack: (18K, P), rows (a*6+i)*K + k; gL: (3, P); cam_kp: (K, P)
    integer camera ids (negative = no camera).  CPU tensors take
    ``gram_soa_plain``; CUDA tensors launch ``kernels/schur_gram.cu``,
    which takes any C and K (no C <= 1024 / K <= 16 gate).
    """
    if _device_kind(lh_stack) == "cpu":
        return gram_soa_plain(lh_stack, gL, cam_kp, num_cams, precision)
    return _gram_soa_cuda(lh_stack, gL, cam_kp, num_cams, precision)


def gram_aos(LH: torch.Tensor, gL: torch.Tensor, obs_cam: torch.Tensor,
             num_cams: int, precision: str = "f32"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """S_corr (6C, 6C) and rhs_corr (6C,) in the 6c+i layout.

    LH: (P, K, 3, 6) = L^T Hcp per slot; gL: (P, 3); obs_cam: (P, K)
    integer camera ids (negative = no camera: give padding slots -1).  CPU
    tensors take ``gram_aos_plain``; CUDA tensors launch the AoS mode of
    ``kernels/schur_gram.cu``, for any C and K (the TPU kernel's C <= 256,
    K <= 16 gate does not apply).
    """
    if _device_kind(LH) == "cpu":
        return gram_aos_plain(LH, gL, obs_cam, num_cams, precision)
    return _gram_aos_cuda(LH, gL, obs_cam, num_cams, precision)


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
