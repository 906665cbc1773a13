"""The method's 4-term mapping loss of one view (a frozen copy of its plain
math): masked L1 colour, 0.8 masked L1 depth, 0.1 normal consistency with
the depth-derived normals, 0.1 edge-aware normal total variation."""

from __future__ import annotations

import torch

W_DEPTH, W_CONS, W_TV = 0.8, 0.1, 0.1


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _pad_edge(x: torch.Tensor) -> torch.Tensor:
    """Edge-replicate padding by 1 along the first two dims."""
    for d in (0, 1):
        first = x.narrow(d, 0, 1)
        last = x.narrow(d, x.shape[d] - 1, 1)
        x = torch.cat([first, x, last], dim=d)
    return x


def depth_to_normal(depth: torch.Tensor, mask: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Camera-space normals (h, w, 3) of a z-depth map: the mean of the four
    cross products of the masked differences to the 4 neighbours,
    normalised, zero outside `mask`."""
    h, w = depth.shape
    fx, fy, cx, cy = intr[0, 0] * w, intr[1, 1] * h, intr[0, 2] * w, intr[1, 2] * h
    us = torch.arange(w, dtype=depth.dtype, device=depth.device) + 0.5
    vs = torch.arange(h, dtype=depth.dtype, device=depth.device) + 0.5
    gv, gu = torch.meshgrid(vs, us, indexing="ij")
    p = torch.stack([(gu - cx) / fx * depth, (gv - cy) / fy * depth, depth], dim=-1)
    m = mask.to(depth.dtype)[..., None]
    pp, mp = _pad_edge(p), _pad_edge(m)
    p_c = pp[1:-1, 1:-1] * mp[1:-1, 1:-1]
    p_u = (pp[:-2, 1:-1] - p_c) * mp[:-2, 1:-1]
    p_l = (pp[1:-1, :-2] - p_c) * mp[1:-1, :-2]
    p_b = (pp[2:, 1:-1] - p_c) * mp[2:, 1:-1]
    p_r = (pp[1:-1, 2:] - p_c) * mp[1:-1, 2:]
    n = _cross(p_u, p_l) + _cross(p_r, p_u) + _cross(p_b, p_r) + _cross(p_l, p_b)
    n = n * torch.rsqrt(torch.clamp(torch.sum(n * n, dim=-1, keepdim=True), min=1e-24))
    return n * m


def normal_tv(normal: torch.Tensor, depth: torch.Tensor, mask: torch.Tensor, sigma: float = 0.3) -> torch.Tensor:
    """Edge-aware normal TV of one view, normal (3, h, w), depth (1, h, w)
    detached, mask (1, h, w) boolean."""
    _, h, w = normal.shape
    m = mask[0].to(torch.bool)
    k = 1.0 / (2.0 * sigma**2)

    def term(na, nb, da, db, ma, mb):
        # a pair counts where either neighbour has depth (the masks are
        # boolean and combine by `or`, as in the method's code)
        nd = torch.sum((na - nb) ** 2, dim=0)
        dd = torch.sum((da - db) ** 2, dim=0)
        return torch.sum((dd <= 1e-4) * torch.exp(-nd * k) * nd * (ma | mb))

    total = term(normal[:, :, :-1], normal[:, :, 1:], depth[:, :, :-1], depth[:, :, 1:], m[:, :-1], m[:, 1:])
    total = total + term(normal[:, :-1], normal[:, 1:], depth[:, :-1], depth[:, 1:], m[:-1], m[1:])
    return total / (4 * h * w)


def view_loss(o: dict, rgb_gt, depth_gt, intr):
    """(loss, error) of one rendered view `o` against its frame: the 4-term
    loss, and the colour + depth error the sampler tracks."""
    h, w = rgb_gt.shape[-2:]
    vis = o["opacity"].detach() > 1e-3
    has_depth = depth_gt > 0.0
    rgb_px = torch.sum(torch.abs((o["rgb"] - rgb_gt) * vis), dim=0) / 3.0
    depth_px = torch.abs((o["depth"] - depth_gt) * has_depth)[0]
    d2n = depth_to_normal(o["depth"][0], vis[0], intr).permute(2, 0, 1)
    cons_px = (1.0 - torch.sum(o["normal"] * d2n, dim=0)) * vis[0]
    tv = normal_tv(o["normal"], o["depth"].detach(), has_depth)
    inv = 1.0 / (h * w)
    loss = torch.sum(rgb_px + W_DEPTH * depth_px + W_CONS * cons_px) * inv + W_TV * tv
    return loss, (torch.sum(rgb_px + depth_px) * inv).detach()
