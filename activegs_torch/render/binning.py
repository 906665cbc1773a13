"""Tile binning: expand gaussians into depth-ordered, K-aligned per-tile
entry segments (port of `activegs_tpu/render/binning.py`).

Output-changing behaviour is kept exactly: the max_dup span cap with its
centred shrink, the exact ellipse/tile cull, the (tile, float32 depth,
enumeration index) order, K-aligned segments, and the entry-budget
truncation with its `num_dropped` count. The TPU-only machinery (matmul
histogram, dummy injection into the sort, inverse-position adjoint aids)
becomes `bincount`, two stable sorts and a scatter. Non-differentiable.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import tracing
from .types import P_CONIC_A, P_CONIC_B, P_CONIC_C, P_EXT_X, P_EXT_Y, P_OPACITY, RasterConfig


@dataclasses.dataclass(frozen=True)
class BinResult:
    gid: torch.Tensor  # (E_budget,) int64 gaussian index per entry, -1 = pad
    tile_start: torch.Tensor  # (T,) int32, K-aligned segment starts
    tile_len: torch.Tensor  # (T,) int32, real (unpadded) segment lengths
    num_dropped: torch.Tensor  # () int64, entries lost to span/budget caps


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def bin_tile_dims(image_shape: tuple[int, int], cfg: RasterConfig):
    """(tile_h, tile_w, ntx, nty) of the tile grid."""
    h, w = image_shape
    return cfg.tile_h, cfg.tile_w, -(-w // cfg.tile_w), -(-h // cfg.tile_h)


def tile_spans(mean_x, mean_y, ext_x, ext_y, in_view, image_shape, cfg: RasterConfig):
    """Clamped per-gaussian tile span capped at max_dup tiles (centred
    shrink). Returns (tx0, ty0, span_w, span_h, n_truncated)."""
    th, tw, ntx, nty = bin_tile_dims(image_shape, cfg)
    max_dup = cfg.max_dup
    i32 = torch.int32
    tx0 = torch.clamp(torch.floor((mean_x - ext_x) / tw), 0, ntx - 1).to(i32)
    tx1 = torch.clamp(torch.floor((mean_x + ext_x) / tw), 0, ntx - 1).to(i32)
    ty0 = torch.clamp(torch.floor((mean_y - ext_y) / th), 0, nty - 1).to(i32)
    ty1 = torch.clamp(torch.floor((mean_y + ext_y) / th), 0, nty - 1).to(i32)
    sw = tx1 - tx0 + 1
    sh = ty1 - ty0 + 1
    area = sw * sh
    shrink = torch.sqrt(max_dup / torch.clamp(area, min=1).to(torch.float32))
    sw_c = torch.where(area > max_dup, torch.floor(sw * shrink), sw.to(torch.float32)).to(i32)
    sw_c = torch.minimum(torch.clamp(sw_c, min=1), sw)
    sh_c = torch.minimum(max_dup // sw_c, sh)
    # recentre the capped span on the projected mean
    ctx = torch.minimum(torch.maximum((mean_x / tw).to(i32), tx0), tx1)
    cty = torch.minimum(torch.maximum((mean_y / th).to(i32), ty0), ty1)
    tx0c = torch.minimum(torch.maximum(ctx - (sw_c - 1) // 2, tx0), tx1 - sw_c + 1)
    ty0c = torch.minimum(torch.maximum(cty - (sh_c - 1) // 2, ty0), ty1 - sh_c + 1)
    n_trunc = torch.sum(torch.where(in_view, sw * sh - sw_c * sh_c, 0).to(torch.int64))
    return tx0c, ty0c, sw_c, sh_c, n_trunc


def candidate_tiles(params2d: torch.Tensor, in_view: torch.Tensor, image_shape, cfg: RasterConfig):
    """Per-gaussian candidate tiles: the capped span from `tile_spans`,
    culled exactly per (gaussian, tile) where the conic quadratic's minimum
    over the tile's pixel-center rect exceeds 2 ln(opacity / alpha_cut)
    (+0.05 margin), then front-compacted. Returns (tile (N, max_dup) int32,
    kept (N, max_dup) bool, kept_n (N,) int32, n_trunc)."""
    th, tw, ntx, nty = bin_tile_dims(image_shape, cfg)
    max_dup = cfg.max_dup
    mean_x = params2d[:, 0]
    mean_y = params2d[:, 1]
    tx0c, ty0c, sw_c, sh_c, n_trunc = tile_spans(
        mean_x, mean_y, params2d[:, P_EXT_X], params2d[:, P_EXT_Y], in_view, image_shape, cfg
    )
    dup = torch.where(in_view, sw_c * sh_c, 0)
    j = torch.arange(max_dup, dtype=torch.int32, device=params2d.device)[None, :]
    sel = j < dup[:, None]
    r = j // sw_c[:, None]
    c = j % sw_c[:, None]
    cx = tx0c[:, None] + c
    cy = ty0c[:, None] + r
    tile = cy * ntx + cx
    if not cfg.tile_cull:
        return tile, sel, dup, n_trunc

    ca = params2d[:, P_CONIC_A][:, None]
    cb = params2d[:, P_CONIC_B][:, None]
    cc = params2d[:, P_CONIC_C][:, None]
    fw = float(tw)
    fh = float(th)
    x0 = cx.to(torch.float32) * fw + 0.5 - mean_x[:, None]
    x1 = x0 + (fw - 1.0)
    y0 = cy.to(torch.float32) * fh + 0.5 - mean_y[:, None]
    y1 = y0 + (fh - 1.0)

    def edge_x(xv):
        ys_ = torch.minimum(torch.maximum(-cb * xv / torch.clamp(cc, min=1e-12), y0), y1)
        return ca * xv * xv + 2.0 * cb * xv * ys_ + cc * ys_ * ys_

    def edge_y(yv):
        xs_ = torch.minimum(torch.maximum(-cb * yv / torch.clamp(ca, min=1e-12), x0), x1)
        return ca * xs_ * xs_ + 2.0 * cb * xs_ * yv + cc * yv * yv

    q = torch.minimum(torch.minimum(edge_x(x0), edge_x(x1)), torch.minimum(edge_y(y0), edge_y(y1)))
    inside = (x0 <= 0.0) & (x1 >= 0.0) & (y0 <= 0.0) & (y1 >= 0.0)
    q = torch.where(inside, 0.0, q)
    op = params2d[:, P_OPACITY]
    qstar = 2.0 * torch.log(torch.clamp(op, min=cfg.alpha_cut) * (1.0 / cfg.alpha_cut))
    keep = sel & (q <= qstar[:, None] + 0.05)

    # front-compact the kept candidates, ascending tile order preserved
    kept_n = keep.sum(dim=1).to(torch.int32)
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    tile_c = torch.where(j < kept_n[:, None], torch.gather(tile, 1, order), 0)
    kept = j < kept_n[:, None]
    return tile_c, kept, kept_n, n_trunc


def entry_count(params2d, in_view, image_shape, cfg: RasterConfig) -> torch.Tensor:
    """Raw kept-candidate count `bin_entries` will bin for this view (binning
    adds at most chunk-1 alignment slots per tile, which budgets cover)."""
    _, _, kept_n, _ = candidate_tiles(params2d, in_view, image_shape, cfg)
    return torch.sum(kept_n.to(torch.int64))


def stream_length(n: int, image_shape: tuple[int, int], cfg: RasterConfig, entry_budget: int | None = None) -> int:
    """Length E of the entry stream `bin_entries` gives a view of `n`
    gaussians: the budget (`entry_budget`, or `entry_budget_mult` per
    gaussian) plus a chunk's pad per tile, K-aligned, at most the most
    entries the view can bin."""
    _, _, ntx, nty = bin_tile_dims(image_shape, cfg)
    num_tiles, kchunk = ntx * nty, cfg.chunk
    e_alloc = _round_up(n * cfg.max_dup + num_tiles * kchunk, kchunk)
    base = int(n * cfg.entry_budget_mult) if entry_budget is None else entry_budget
    return min(_round_up(base + num_tiles * (kchunk - 1), kchunk), e_alloc)


@tracing.span("render.binning")
def bin_entries(
    params2d: torch.Tensor,
    depth_z: torch.Tensor,
    in_view: torch.Tensor,
    image_shape: tuple[int, int],
    cfg: RasterConfig,
    entry_budget: int | None = None,
) -> BinResult:
    """K-aligned per-tile entry layout in (tile, depth, enumeration) order.

    The dense (N, max_dup) candidate grid is enumerated gaussian-major, so a
    stable sort by depth followed by a stable sort by tile yields the
    reference's lexicographic order, depth ties broken by gaussian index.
    Each tile's segment starts at a multiple of K; the stream is cut at the
    entry budget, and every cut entry counts in `num_dropped`."""
    _, _, ntx, nty = bin_tile_dims(image_shape, cfg)
    num_tiles = ntx * nty
    n = params2d.shape[0]
    kchunk = cfg.chunk
    max_dup = cfg.max_dup
    dev = params2d.device

    tile, sel, _, n_trunc = candidate_tiles(params2d, in_view, image_shape, cfg)
    tile_f = tile.reshape(-1).to(torch.int64)
    sel_f = sel.reshape(-1)
    with tracing.host_read("bin_entries.nonzero"):
        cand = torch.nonzero(sel_f).squeeze(1)  # enumeration order i*max_dup+j
    ct = tile_f[cand]
    cd = depth_z.detach()[cand // max_dup]
    o1 = torch.sort(cd, stable=True).indices
    o2 = torch.sort(ct[o1], stable=True).indices
    order = o1[o2]
    ct_s = ct[order]
    gid_s = cand[order] // max_dup

    with tracing.host_read("bin_entries.bincount"):
        seg_len = torch.bincount(ct, minlength=num_tiles)
    pad_len = (seg_len + kchunk - 1) // kchunk * kchunk
    start = torch.cumsum(pad_len, 0) - pad_len
    first = torch.cumsum(seg_len, 0) - seg_len
    rank = torch.arange(ct_s.shape[0], device=dev) - first[ct_s]
    pos = start[ct_s] + rank

    e_budget = stream_length(n, image_shape, cfg, entry_budget)

    start_c = torch.clamp(start, max=e_budget)
    pad_len_c = torch.minimum(pad_len, e_budget - start_c)
    len_c = torch.minimum(seg_len, pad_len_c)
    num_dropped = n_trunc + torch.sum(seg_len - len_c)

    gid = torch.full((e_budget,), -1, dtype=torch.int64, device=dev)
    fits = pos < e_budget
    with tracing.host_read("bin_entries.mask"):
        gid[pos[fits]] = gid_s[fits]
    return BinResult(
        gid=gid,
        tile_start=start_c.to(torch.int32),
        tile_len=len_c.to(torch.int32),
        num_dropped=num_dropped,
    )
