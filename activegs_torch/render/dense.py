"""Dense reference compositor: the test oracle (port of
`activegs_tpu/render/dense.py`). Every gaussian against every pixel with one
(N, H*W) alpha matrix: no binning, tiling or chunking. Differentiable through
autograd; only for small scenes."""

from __future__ import annotations

import torch

from . import preprocess as pp
from .types import O_CONF, O_DEPTH, O_TRANS, Camera, GaussianAttrs, RasterConfig


def composite_dense(
    params2d: torch.Tensor,
    order: torch.Tensor,
    image_shape: tuple[int, int],
    cfg: RasterConfig,
    render_mask: torch.Tensor | None = None,
    weight_thres: float = 0.03,
):
    """Composite depth-ordered gaussians over the full image. Returns
    (out (10, H*W), importance (N,), count (N,))."""
    h, w = image_shape
    n = params2d.shape[0]
    dev = params2d.device
    entries = params2d[order, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    px = gx.reshape(1, -1)
    py = gy.reshape(1, -1)

    alpha, tdep = pp.eval_alpha_depth_cols(pp.entry_cols(entries), px, py, cfg)
    # in the pair dtype (bf16 under cfg.bf16_pairs), then float32 as the
    # reference's products with float32 operands promote it
    cum = torch.cumprod(1.0 - alpha, dim=0)
    excl = torch.cat([torch.ones_like(cum[:1]), cum[:-1]], dim=0)
    weight = (alpha * excl).float()
    t_final = cum[-1].float()
    feats = torch.cat([entries[:, 6:12], entries[:, 16:17]], dim=1)  # (N, 7)
    ch = feats.T @ weight
    depth = torch.sum(weight * tdep, dim=0, keepdim=True)
    out = torch.cat(
        [ch[:6], depth, ch[6:7], t_final[None], torch.zeros_like(t_final)[None]], dim=0
    )

    mask = (
        torch.ones(h * w, device=dev)
        if render_mask is None
        else render_mask.reshape(-1).to(torch.float32)
    )
    wm = weight * mask[None, :]
    importance_sorted = torch.sum(wm, dim=1)
    count_sorted = torch.sum((wm >= weight_thres).to(torch.int32), dim=1)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    return out, importance_sorted[inv], count_sorted[inv].to(torch.int32)


def render_dense(
    attrs: GaussianAttrs,
    camera: Camera,
    image_shape: tuple[int, int],
    cfg: RasterConfig = RasterConfig(),
    front_only: bool = False,
    render_mask: torch.Tensor | None = None,
    weight_thres: float = 0.03,
    background: torch.Tensor | None = None,
) -> dict:
    """Oracle render: preprocess + dense composite + channel post."""
    h, w = image_shape
    params2d, radius, depth_z, in_view = pp.preprocess(attrs, camera, image_shape, cfg, front_only)
    order = torch.sort(torch.where(in_view, depth_z.detach(), torch.inf), stable=True).indices
    out, importance, count = composite_dense(params2d, order, image_shape, cfg, render_mask, weight_thres)
    trans = out[O_TRANS].reshape(1, h, w)
    rgb = out[0:3].reshape(3, h, w)
    if background is not None:
        rgb = rgb + trans * background[:, None, None]
    normal = out[3:6].reshape(3, h, w)
    opacity = 1.0 - trans
    vis = opacity > 1e-2
    n2 = torch.sum(normal * normal, dim=0, keepdim=True)
    normal = normal * torch.rsqrt(torch.clamp(n2, min=1e-24)) * vis
    return {
        "rgb": rgb,
        "depth": out[O_DEPTH].reshape(1, h, w),
        "normal": normal,
        "opacity": opacity,
        "confidence": out[O_CONF].reshape(1, h, w),
        "importance": importance,
        "count": count,
        "in_view": in_view,
        "radius": radius,
        "transmittance": trans,
        "raw": out,
    }
