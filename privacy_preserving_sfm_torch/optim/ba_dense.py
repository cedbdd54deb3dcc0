"""Dense per-point observation layout for bundle adjustment.

Port of ``privacy_preserving_sfm_tpu/optim/ba_dense.py:34-141``: the
``DenseBAProblem`` container and ``from_flat_problem``, which lays the
observations out densely per point,

  cam_idx (P, K), lines (P, K, 3), weight (P, K)   with K = max track len,

so point-side reductions become sums over the K axis.  The dense-block
solver itself (implicit Schur) is not ported yet (ROADMAP.md Queue 1 #8).

Differences from the reference, none of them semantic:
  * K is the longest track, not a rung of the reference's K ladder (that
    ladder bounds XLA compile keys; padded slots carry weight 0 and add
    exact zeros);
  * the per-camera gather tables (``cam_gather``) are not built: only the
    implicit dense solver reads them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from privacy_preserving_sfm_torch.optim import ba as ba_mod


class DenseBAProblem(NamedTuple):
    qvecs: torch.Tensor  # (C, 4)
    tvecs: torch.Tensor  # (C, 3)
    cam_params: torch.Tensor  # (C, Pr)
    points3d: torch.Tensor  # (P, 3)
    obs_cam: torch.Tensor  # (P, K) int64
    obs_line: torch.Tensor  # (P, K, 3)
    obs_weight: torch.Tensor  # (P, K) float, 0 = padding
    cam_dof_mask: torch.Tensor  # (C, 6)
    point_mask: torch.Tensor  # (P,)


def from_flat_problem(problem: ba_mod.BAProblem) -> DenseBAProblem:
    """Convert a flat BAProblem to dense per-point blocks (host-side numpy).

    Padding slots get camera 0, line (1, 0, 0) and weight 0, as in the
    reference.
    """
    obs_point = problem.obs_point.cpu().numpy()
    obs_cam = problem.obs_cam.cpu().numpy()
    obs_line = problem.obs_line.cpu().numpy()
    obs_weight = problem.obs_weight.cpu().numpy()
    P = problem.points3d.shape[0]

    valid = obs_weight > 0
    counts = np.bincount(obs_point[valid], minlength=P)
    K = int(max(1, counts.max())) if P else 1

    # Per-point slots: stable sort by point, position within group.
    vidx = np.nonzero(valid)[0]
    vp = obs_point[vidx]
    order = np.argsort(vp, kind="stable")
    vidx, vp = vidx[order], vp[order]
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    kslot = np.arange(len(vidx)) - start[vp]

    cam_idx = np.zeros((P, K), np.int64)
    lines = np.zeros((P, K, 3))
    lines[..., 0] = 1.0
    weight = np.zeros((P, K))
    cam_idx[vp, kslot] = obs_cam[vidx]
    lines[vp, kslot] = obs_line[vidx]
    weight[vp, kslot] = obs_weight[vidx]

    def like(a, ref):
        return torch.as_tensor(a, dtype=ref.dtype, device=ref.device)

    return DenseBAProblem(
        qvecs=problem.qvecs, tvecs=problem.tvecs,
        cam_params=problem.cam_params, points3d=problem.points3d,
        obs_cam=torch.as_tensor(cam_idx, device=problem.obs_cam.device),
        obs_line=like(lines, problem.obs_line),
        obs_weight=like(weight, problem.obs_weight),
        cam_dof_mask=problem.cam_dof_mask, point_mask=problem.point_mask)
