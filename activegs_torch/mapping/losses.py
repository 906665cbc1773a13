"""Training losses for the Gaussian-surfel map (port of
`activegs_tpu/mapping/losses.py`). All operate on (V, C, H, W) batches."""

from __future__ import annotations

import torch

W_DEPTH = 0.8
W_CONS = 0.1
W_TV = 0.1
TV_SIGMA = 0.3  # the normal TV's edge scale


def l1_masked(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-element masked L1 map."""
    return torch.abs((pred - gt) * mask)


def consistency_loss(normals: torch.Tensor, depth_normals: torch.Tensor) -> torch.Tensor:
    """1 - cos(rendered normal, depth-derived normal) per pixel, (V, 3, H, W)."""
    return 1.0 - torch.sum(normals * depth_normals, dim=1)


def normal_tv_maps(normals: torch.Tensor, depths: torch.Tensor, mask: torch.Tensor, sigma: float = TV_SIGMA):
    """The two axis terms of the edge-aware normal TV a pixel pair:
    (V, H, W - 1) along x and (V, H - 1, W) along y, each the squared
    normal difference to the neighbour, gated to flat depth (diff <= 1e-4)
    and weighted by exp(-diff / 2 sigma^2), where either pixel's mask is
    set. `depths` are detached by the caller."""
    m = mask[:, 0] if mask.dim() == 4 else mask
    inv_two_sigma_sq = 1.0 / (2.0 * sigma**2)

    def axis_term(sl_a, sl_b):
        nd = torch.sum((normals[sl_a] - normals[sl_b]) ** 2, dim=1)
        dd = torch.sum((depths[sl_a] - depths[sl_b]) ** 2, dim=1)
        term = (dd <= 1e-4) * torch.exp(-nd * inv_two_sigma_sq) * nd
        msl_a = (sl_a[0],) + sl_a[2:]
        msl_b = (sl_b[0],) + sl_b[2:]
        return term * (m[msl_a] + m[msl_b])

    s = slice(None)
    return (axis_term((s, s, s, slice(None, -1)), (s, s, s, slice(1, None))),
            axis_term((s, s, slice(None, -1), s), (s, s, slice(1, None), s)))


def normal_tv_loss(normals: torch.Tensor, depths: torch.Tensor, mask: torch.Tensor, sigma: float = TV_SIGMA) -> torch.Tensor:
    """Edge-aware normal total variation: the terms of `normal_tv_maps` to
    the 4 neighbours, summed once per axis with both neighbours' masks,
    over 4 V H W."""
    v, _, h, w = normals.shape
    tv_x, tv_y = normal_tv_maps(normals, depths, mask, sigma)
    return (torch.sum(tv_x) + torch.sum(tv_y)) / (v * 4 * h * w)


def total_from_view_terms(rgb_t, depth_t, cons_t, tv_t):
    """Unfused 4-term total from per-view scalar terms (each (V,))."""
    return (
        torch.mean(rgb_t)
        + W_DEPTH * torch.mean(depth_t)
        + W_CONS * torch.mean(cons_t)
        + W_TV * torch.mean(tv_t)
    )
