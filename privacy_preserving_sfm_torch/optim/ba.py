"""Point-to-line bundle adjustment: problem layout, options, shared pieces.

Port of ``privacy_preserving_sfm_tpu/optim/ba.py:46-228, 440-455``: the
containers and helpers the explicit-Schur solver (``optim/ba_soa.py``)
needs.  The flat implicit-Schur solver ``bundle_adjust`` is not ported yet
(ROADMAP.md Queue 1 #8).

Problem layout:

  cameras  C:  qvecs (C, 4), tvecs (C, 3), camera params (C, Pr) [constant],
               dof mask (C, 6) — 3 rotation-tangent + 3 translation dofs;
               gauge fixing = zeroed mask entries.
  points   P:  points3d (P, 3), point mask (P,) (variable vs constant).
  obs      O:  camera index, point index, line (O, 3), weight (O,).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from privacy_preserving_sfm_torch.ops import lie, linalg


class BAProblem(NamedTuple):
    qvecs: torch.Tensor  # (C, 4)
    tvecs: torch.Tensor  # (C, 3)
    cam_params: torch.Tensor  # (C, Pr) intrinsics, constant
    points3d: torch.Tensor  # (P, 3)
    obs_cam: torch.Tensor  # (O,) int64
    obs_point: torch.Tensor  # (O,) int64
    obs_line: torch.Tensor  # (O, 3) normalized lines
    obs_weight: torch.Tensor  # (O,) float, 0 = padding
    cam_dof_mask: torch.Tensor  # (C, 6) float, 0 = frozen dof
    point_mask: torch.Tensor  # (P,) float, 0 = constant point


class BAOptions(NamedTuple):
    max_iterations: int = 50  # ba_global_max_num_iterations default
    loss: str = "trivial"  # trivial | soft_l1 | cauchy
    loss_scale: float = 1.0
    cg_iterations: int = 30
    initial_lambda: float = 1e-4
    min_lambda: float = 1e-10
    max_lambda: float = 1e10
    function_tolerance: float = 1e-8
    # Ceres-style termination on the max-abs gradient entry; 0 disables.
    gradient_tolerance: float = 0.0
    # Give up after this many consecutive rejected steps (each grows
    # lambda 4x: the solve is at a numerical local minimum).
    max_consecutive_rejections: int = 8
    # Intrinsics refinement (reference BundleAdjustmentOptions.refine_*);
    # the port's mapper refuses them until ``ba_intrinsics`` is ported.
    refine_focal_length: bool = False
    refine_principal_point: bool = False
    refine_extra_params: bool = False


def _f32(x: float) -> float:
    return float(np.float32(x))


class DynamicBAOptions(NamedTuple):
    """The per-solve knobs of one LM run as plain Python scalars.

    The reference carries them as float32 device scalars (its one compiled
    kernel serves every option set); ``from_options`` rounds them through
    float32 the same way, which keeps the two solvers' LM trajectories
    identical.
    """

    loss: str
    loss_scale: float
    gradient_tolerance: float  # <= 0 disables
    function_tolerance: float
    initial_lambda: float
    max_iterations: int

    @staticmethod
    def from_options(options: BAOptions) -> "DynamicBAOptions":
        if options.loss not in ("trivial", "soft_l1", "cauchy"):
            raise ValueError(f"unknown loss {options.loss}")
        return DynamicBAOptions(
            loss=options.loss,
            loss_scale=_f32(options.loss_scale),
            gradient_tolerance=_f32(options.gradient_tolerance),
            function_tolerance=_f32(options.function_tolerance),
            initial_lambda=_f32(options.initial_lambda),
            max_iterations=int(options.max_iterations))


class BASummary(NamedTuple):
    initial_cost: float
    final_cost: float
    num_iterations: int
    lam: float


def _robust_weight(sq_norm: torch.Tensor, loss: str,
                   scale: float) -> torch.Tensor:
    """IRLS weight rho'(s) for squared residual norm s."""
    if loss == "trivial":
        return torch.ones_like(sq_norm)
    s = sq_norm / (scale * scale)
    if loss == "soft_l1":
        return 1.0 / torch.sqrt(1.0 + s)
    if loss == "cauchy":
        return 1.0 / (1.0 + s)
    raise ValueError(f"unknown loss {loss}")


def _robust_cost(sq_norm: torch.Tensor, loss: str,
                 scale: float) -> torch.Tensor:
    """rho(s): the robustified cost of a squared residual norm."""
    if loss == "trivial":
        return sq_norm
    b = scale * scale
    s = sq_norm / b
    if loss == "soft_l1":
        return 2.0 * b * (torch.sqrt(1.0 + s) - 1.0)
    if loss == "cauchy":
        return b * torch.log1p(s)
    raise ValueError(f"unknown loss {loss}")


def _quat_delta(dq: torch.Tensor) -> torch.Tensor:
    """Smooth quaternion increment (1, dq/2)/sqrt(1+|dq/2|^2), batched."""
    half = dq / 2.0
    w = torch.ones(dq.shape[:-1] + (1,), dtype=dq.dtype, device=dq.device)
    q = torch.cat([w, half], dim=-1)
    return q / torch.sqrt(1.0 + torch.sum(half * half, dim=-1, keepdim=True))


def _apply_step(qvecs, tvecs, points, dc, dp):
    """Apply camera tangent steps (C, 6) and point steps (P, 3)."""
    q_new = lie.quat_normalize(
        lie.quat_multiply(qvecs, _quat_delta(dc[:, :3])))
    return q_new, tvecs + dc[:, 3:], points + dp


def _inv6(A: torch.Tensor) -> torch.Tensor:
    """Blockwise 6x6 inverse via 3x3 Schur complement (closed forms only)."""
    A11 = A[..., :3, :3]
    A12 = A[..., :3, 3:]
    A21 = A[..., 3:, :3]
    A22 = A[..., 3:, 3:]
    A11i = linalg.inv3(A11)
    S = A22 - A21 @ A11i @ A12
    Si = linalg.inv3(S)
    B11 = A11i + A11i @ A12 @ Si @ A21 @ A11i
    B12 = -(A11i @ A12 @ Si)
    B21 = -(Si @ A21 @ A11i)
    top = torch.cat([B11, B12], dim=-1)
    bot = torch.cat([B21, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)
