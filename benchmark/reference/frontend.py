"""Plain reference of the front end's line lift and of the matcher.

Imports nothing of the program.

Lift (``extraction.cc:453-504``): each image draws from its own CPU
``torch.Generator`` first K uniforms, which pick exactly floor(ratio *
valid) keypoints as aligned (the valid ones with the smallest draws, ties
to the lower index), then K x 3 normals; a keypoint's normalized point
x = ((u - cx) / f, (v - cy) / f) (SIMPLE_PINHOLE) lifts to the line
d x (x, 1), d the gravity where aligned and the unit normal draw
elsewhere, scaled so that ||(a, b)|| = 1.

Matcher (``sift.cc:54-143``): uint8 descriptors, dots d1 . d2 exact in
float32 (integers below 2^24); for each row the best dot (first index on
ties) and the second best (the row with only the best's position masked);
angles acos(dot / 512^2); a row matches its best when that angle is below
``max_distance`` and below ``max_ratio`` times the second's, and, with the
cross check, when the column's own best is that row and passes the same
gates.  ``int4=True`` rounds the descriptors to 4 bits first: the control,
the precision below the matcher's 8-bit descriptors.
"""

from __future__ import annotations

from typing import Sequence

import torch

DIST_NORM = 1.0 / (512.0 * 512.0)


def lift(keypoints: torch.Tensor, valid: torch.Tensor, params: torch.Tensor,
         gravity: torch.Tensor, seeds: Sequence[int], ratio: float = 0.5):
    """keypoints (B, K, >=2) pixels, valid (B, K), params (B, 3) SIMPLE_
    PINHOLE, gravity (B, 3).  Returns lines (B, K, 3), aligned (B, K)."""
    B, K = valid.shape
    dev = keypoints.device
    uni, nrm = [], []
    for s in seeds:
        g = torch.Generator().manual_seed(int(s))
        uni.append(torch.rand(K, generator=g))
        nrm.append(torch.randn(K, 3, generator=g, dtype=torch.float32))
    uni = torch.stack(uni).to(dev)
    nrm = torch.stack(nrm).to(dev)
    r = torch.where(valid, uni, 2.0)
    order = torch.argsort(r, dim=-1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(K, device=dev).expand_as(order))
    n_al = torch.floor(ratio * valid.sum(-1, keepdim=True).double())
    aligned = (rank < n_al) & valid
    f, cx, cy = params[:, 0:1], params[:, 1:2], params[:, 2:3]
    x = (keypoints[..., 0] - cx) / f
    y = (keypoints[..., 1] - cy) / f
    xh = torch.stack([x, y, torch.ones_like(x)], -1)
    nrm = nrm / torch.sqrt(torch.sum(nrm * nrm, -1, keepdim=True))
    d = torch.where(aligned[..., None],
                    gravity.to(xh.dtype)[:, None, :].expand_as(xh), nrm)
    line = torch.linalg.cross(d, xh, dim=-1)
    n = torch.sqrt(torch.sum(line[..., :2] * line[..., :2], -1, keepdim=True))
    return line / torch.clamp(n, min=1e-12), aligned


def _top2(dots: torch.Tensor, dim: int):
    best_idx = torch.argmax(dots, dim=dim, keepdim=True)
    best = torch.gather(dots, dim, best_idx).squeeze(dim)
    second = dots.scatter(dim, best_idx, -1e9).amax(dim=dim)
    return best, second, best_idx.squeeze(dim)


def match(d1: torch.Tensor, d2: torch.Tensor, v1: torch.Tensor,
          v2: torch.Tensor, max_ratio: float = 0.8,
          max_distance: float = 0.7, cross_check: bool = True,
          int4: bool = False) -> torch.Tensor:
    """Matches of B pairs: d1 (B, N1, 128), d2 (B, N2, 128) uint8, valid
    masks.  Returns (B, N1) int64, the matched row of image 2 or -1."""
    a, b = d1.float(), d2.float()
    if int4:
        a = torch.round(a / 16.0) * 16.0
        b = torch.round(b / 16.0) * 16.0
    dots = torch.matmul(a, b.transpose(1, 2))
    dots.masked_fill_(~(v1[:, :, None] & v2[:, None, :]), -1e9)
    b12, s12, i12 = _top2(dots, 2)
    b21, s21, i21 = _top2(dots, 1)

    def ang(x):
        return torch.arccos(torch.clamp(x * DIST_NORM, -1.0, 1.0))

    ok = v1 & (ang(b12) < max_distance) & (ang(b12) < max_ratio * ang(s12))
    if cross_check:
        ok21 = (ang(b21) < max_distance) & (ang(b21) < max_ratio * ang(s21))
        back = torch.gather(i21, 1, i12)
        rows = torch.arange(i12.shape[1], device=i12.device)
        ok = ok & (back == rows[None]) & torch.gather(ok21, 1, i12)
    return torch.where(ok, i12, -1)
