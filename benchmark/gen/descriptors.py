"""A collection's SIFT descriptors, made on the device from a seed.

The distributions of the port's ``utils/synthetic.
synthetic_matching_database``: scene points are Dirichlet(0.2) histograms
on the 128-simplex; image k sees the ``window`` scene points from
k * ``shift`` on (defaults: 3/4 of the features, and window // 12), each
view mixing in a fresh histogram with a weight from U(0.05, 0.45); the
rest of its features are distractors; each image's features are
shuffled; descriptors are SIFT's uint8 convention round(512 sqrt(p)).
Drawn with a ``torch.Generator`` on the device, in blocks of images.
"""

from __future__ import annotations

import torch

BLOCK = 32  # images a call


def dirichlet(g: torch.Generator, n: int, device, alpha: float = 0.2
              ) -> torch.Tensor:
    """(n, 128) Dirichlet(alpha) rows: normalized Gamma(alpha) draws."""
    x = torch._standard_gamma(torch.full((n, 128), alpha, device=device),
                              generator=g)
    return x / x.sum(1, keepdim=True).clamp_min(1e-30)


def sift_like(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(512.0 * torch.sqrt(p)), 0, 255).to(
        torch.uint8)


def make_descriptors(cfg: dict, seed: int, device) -> torch.Tensor:
    """(num_images, num_features, 128) uint8."""
    n_img, n_feat = int(cfg["num_images"]), int(cfg["num_features"])
    window = int(cfg.get("window") or (3 * n_feat) // 4)
    shift = int(cfg.get("shift") or max(1, window // 12))
    g = torch.Generator(device=device).manual_seed(seed)
    scene = dirichlet(g, (n_img - 1) * shift + window, device)
    out = torch.empty(n_img, n_feat, 128, dtype=torch.uint8, device=device)
    for k0 in range(0, n_img, BLOCK):
        ks = range(k0, min(n_img, k0 + BLOCK))
        b = len(ks)
        lam = 0.05 + 0.4 * torch.rand(b, window, 1, generator=g,
                                      device=device)
        idx = torch.tensor([k * shift for k in ks], device=device)[:, None] \
            + torch.arange(window, device=device)[None]
        seen = scene[idx]  # (b, window, 128)
        fresh = dirichlet(g, b * window, device).view(b, window, 128)
        distract = dirichlet(g, b * (n_feat - window), device).view(
            b, n_feat - window, 128)
        content = torch.cat([(1.0 - lam) * seen + lam * fresh, distract], 1)
        order = torch.argsort(torch.rand(b, n_feat, generator=g,
                                         device=device), dim=1)
        content = torch.gather(content, 1, order[..., None].expand(-1, -1,
                                                                   128))
        out[k0:k0 + b] = sift_like(content)
    return out
