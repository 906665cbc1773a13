"""Public rendering API (port of `activegs_tpu/render/renderer.py`).

`render_view` renders one posed view with the full channel set through
preprocess -> binning -> the differentiable tile composite;
`render_views_batched` renders several through one compositor launch;
`render_stats`
returns per-gaussian importance/count from the stats kernel. The entry
gather `params2d[gid]` and the per-view subset gather are
`core.scatter.gather_rows`, whose adjoint sums by id in a fixed order, so a
training step gives the same gradients on every run. Bins can be frozen per
keyframe (`prepare_view_bins`) and reused across steps.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..core.scatter import gather_rows, scatter_sum
from . import binning
from . import composite as cp
from . import preprocess as pp
from .types import O_CONF, O_DEPTH, O_TRANS, Camera, GaussianAttrs, RasterConfig, RenderOutput


def tiles_to_image(out_tiles: torch.Tensor, image_shape, cfg: RasterConfig) -> torch.Tensor:
    """(T, C, P) tile-major output -> (C, h, w) image."""
    h, w = image_shape
    th, tw, ntx, nty = binning.bin_tile_dims(image_shape, cfg)
    c = out_tiles.shape[1]
    img = out_tiles.reshape(nty, ntx, c, th, tw).permute(2, 0, 3, 1, 4)
    return img.reshape(c, nty * th, ntx * tw)[:, :h, :w]


def tiles_to_image_batched(out_tiles: torch.Tensor, v: int, image_shape, cfg: RasterConfig) -> torch.Tensor:
    """(V * T, C, P) output of V concatenated views -> (V, C, h, w) images
    in one relayout."""
    h, w = image_shape
    th, tw, ntx, nty = binning.bin_tile_dims(image_shape, cfg)
    c = out_tiles.shape[1]
    img = out_tiles.reshape(v, nty, ntx, c, th, tw).permute(0, 3, 1, 4, 2, 5)
    return img.reshape(v, c, nty * th, ntx * tw)[:, :, :h, :w]


def image_to_tiles(img: torch.Tensor, image_shape, cfg: RasterConfig) -> torch.Tensor:
    """(h, w) image -> (T, P) tile-major layout, zero-padded to whole tiles."""
    h, w = image_shape
    th, tw, ntx, nty = binning.bin_tile_dims(image_shape, cfg)
    m = torch.nn.functional.pad(img.to(torch.float32), (0, ntx * tw - w, 0, nty * th - h))
    return m.reshape(nty, th, ntx, tw).permute(0, 2, 1, 3).reshape(nty * ntx, th * tw).contiguous()


@tracing.span("render.bins")
def prepare_view_bins(
    attrs: GaussianAttrs,
    camera: Camera,
    image_shape: tuple[int, int],
    cfg: RasterConfig = RasterConfig(),
    front_only: bool = False,
    entry_budget: int | None = None,
) -> binning.BinResult:
    """Per-tile entry lists for a view (non-differentiable), reusable across
    the optimization steps of one keyframe (frozen bins)."""
    with torch.no_grad():
        params2d, _, depth_z, in_view = pp.preprocess(attrs, camera, image_shape, cfg, front_only)
        return binning.bin_entries(params2d, depth_z, in_view, image_shape, cfg, entry_budget)


def gather_entries(params2d: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """(PARAM_DIM, E) entry stream; pad entries (gid = -1) are zero rows.
    The adjoint sums entry gradients into params2d rows in a fixed order."""
    return gather_rows(params2d, torch.clamp(gid, min=0), gid >= 0).t().contiguous()


def _view_entries(attrs, camera, image_shape, cfg, front_only, bin_result, entry_budget):
    """(entry stream, bins, radius, in_view) of one view: preprocess, then
    the frozen bins `bin_result` or binning at `entry_budget`."""
    params2d, radius, depth_z, in_view = pp.preprocess(attrs, camera, image_shape, cfg, front_only)
    b = bin_result
    if b is None:
        b = binning.bin_entries(
            params2d.detach(), depth_z.detach(), in_view, image_shape, cfg, entry_budget
        )
    return gather_entries(params2d, b.gid), b, radius, in_view


def _render_output(img: torch.Tensor, background: torch.Tensor | None):
    """(RenderOutput, transmittance) of the composited rows 0..O_TRANS of
    one view, (C, h, w), or of a batch of views, (V, C, h, w): background
    blend, opacity, and normals normalized and masked where visible."""
    trans = img[..., O_TRANS : O_TRANS + 1, :, :]
    rgb = img[..., 0:3, :, :]
    if background is not None:
        rgb = rgb + trans * background[:, None, None]
    opacity = 1.0 - trans
    vis = opacity.detach() > 1e-2
    normal = img[..., 3:6, :, :]
    n2 = torch.sum(normal * normal, dim=-3, keepdim=True)
    normal = normal * torch.rsqrt(torch.clamp(n2, min=1e-24))
    normal = normal * vis
    output = RenderOutput(
        rgb=rgb,
        depth=img[..., O_DEPTH : O_DEPTH + 1, :, :],
        normal=normal,
        opacity=opacity,
        confidence=img[..., O_CONF : O_CONF + 1, :, :],
    )
    return output, trans


@tracing.span("render.view")
def render_view(
    attrs: GaussianAttrs,
    camera: Camera,
    image_shape: tuple[int, int],
    cfg: RasterConfig = RasterConfig(),
    front_only: bool = False,
    background: torch.Tensor | None = None,
    bin_result: binning.BinResult | None = None,
    entry_budget: int | None = None,
):
    """Render one view. Returns (RenderOutput, aux) with aux = {in_view,
    radius, transmittance, num_dropped}. Pass `bin_result` (from
    `prepare_view_bins`) to reuse frozen tile lists."""
    entries, b, radius, in_view = _view_entries(
        attrs, camera, image_shape, cfg, front_only, bin_result, entry_budget
    )
    _, _, ntx, _ = binning.bin_tile_dims(image_shape, cfg)
    out_tiles = cp.composite(entries, b.tile_start, b.tile_len, ntx, cfg)
    img = tiles_to_image(out_tiles[:, : O_TRANS + 1], image_shape, cfg)
    output, trans = _render_output(img, background)
    aux = {
        "in_view": in_view,
        "radius": radius,
        "transmittance": trans,
        "num_dropped": b.num_dropped,
    }
    return output, aux


@tracing.span("render.views")
def render_views_batched(
    attrs_per_view: list,
    cameras: list,
    image_shape: tuple[int, int],
    cfg: RasterConfig = RasterConfig(),
    background: torch.Tensor | None = None,
    bin_results: list | None = None,
    entry_budget: int | None = None,
):
    """Render V posed views through one forward launch of the compositor
    (and one backward launch under autograd). Each view is preprocessed
    and binned as `render_view` does it (or takes its frozen bins from
    `bin_results`); the entry streams are concatenated, view i's tile
    starts offset by i * E, and the compositor runs once over the V * T
    tiles with T tiles per view. Every view's entry stream must have the
    same length E (one entry budget). Returns (RenderOutput with a leading
    view axis, aux = {num_dropped (V,)}): each view's images are those of
    `render_view`, since every tile runs the same program."""
    v = len(attrs_per_view)
    _, _, ntx, nty = binning.bin_tile_dims(image_shape, cfg)
    entries_l, bins_l = [], []
    for i in range(v):
        bins = None if bin_results is None else bin_results[i]
        entries, b, _, _ = _view_entries(
            attrs_per_view[i], cameras[i], image_shape, cfg, False, bins, entry_budget
        )
        entries_l.append(entries)
        bins_l.append(b)
    e = entries_l[0].shape[1]
    if any(x.shape[1] != e for x in entries_l):
        raise ValueError(f"views of unequal entry budgets {[x.shape[1] for x in entries_l]}: one budget required")
    if v * e > cp.INT32_MAX:
        raise ValueError(f"{v} views of {e} entries: the int32 tile_start offsets reach at most {cp.INT32_MAX}")
    entries = torch.cat(entries_l, dim=1)
    starts = torch.cat([b.tile_start + i * e for i, b in enumerate(bins_l)])
    lens = torch.cat([b.tile_len for b in bins_l])
    out_tiles = cp.composite(entries, starts, lens, ntx, cfg, ntx * nty)
    img = tiles_to_image_batched(out_tiles[:, : O_TRANS + 1], v, image_shape, cfg)
    output, _ = _render_output(img, background)
    return output, {"num_dropped": torch.stack([b.num_dropped for b in bins_l])}


# ---------------------------------------------------------------------------
# per-view in-view compaction
# ---------------------------------------------------------------------------

PACK_DIM = 16  # means3 scales3 rot4 opac1 col3 conf1 valid1


def pack_attrs(attrs: GaussianAttrs) -> torch.Tensor:
    """(N, 16) row packing so a per-view subset is one row gather."""
    return torch.cat(
        [
            attrs.means,
            attrs.scales,
            attrs.rotations,
            attrs.opacities[:, None],
            attrs.colors,
            attrs.confidences[:, None],
            attrs.valid.to(torch.float32)[:, None],
        ],
        dim=1,
    )


def unpack_attrs(packed: torch.Tensor) -> GaussianAttrs:
    return GaussianAttrs(
        means=packed[:, 0:3],
        scales=packed[:, 3:6],
        rotations=packed[:, 6:10],
        opacities=packed[:, 10],
        colors=packed[:, 11:14],
        confidences=packed[:, 14],
        valid=packed[:, 15] > 0.5,
    )


def compact_in_view(in_view: torch.Tensor, bucket: int):
    """Compact the in-view gaussians into a static bucket, keeping their
    order. Returns (sel (B,) int64, sel_valid (B,) bool, inv (N,) int64 with
    -1 for absent, count ())."""
    n = in_view.shape[0]
    sel_full = torch.sort((~in_view).to(torch.int8), stable=True).indices
    pos = torch.empty_like(sel_full)
    pos[sel_full] = torch.arange(n, device=in_view.device)
    count = in_view.sum()
    sel_valid = torch.arange(bucket, device=in_view.device) < count
    sel = torch.where(sel_valid, sel_full[:bucket], 0)
    inv = torch.where(in_view & (pos < bucket), pos, -1)
    return sel, sel_valid, inv, count


def subset_view(packed: torch.Tensor, subset) -> GaussianAttrs:
    """Differentiable compact attrs for one view; subset = (sel, sel_valid,
    inv) from `compact_in_view`. The gather's adjoint sums in a fixed order."""
    sel, sel_valid, _ = subset
    return unpack_attrs(gather_rows(packed, sel, sel_valid))


@tracing.span("render.stats")
def render_stats(
    attrs: GaussianAttrs,
    camera: Camera,
    image_shape: tuple[int, int],
    cfg: RasterConfig = RasterConfig(),
    render_mask: torch.Tensor | None = None,
    weight_thres: float = 0.03,
    front_only: bool = True,
    subset_bucket: int | None = None,
    entry_budget: int | None = None,
):
    """Per-gaussian (importance (N,) f32, count (N,) int32) for one view:
    the stats kernel's per-entry sums added up by gid in a fixed order.
    `subset_bucket` compacts the view's in-view gaussians first (exact);
    `entry_budget` bounds the binned entry stream."""
    with torch.no_grad():
        if subset_bucket is not None and subset_bucket < attrs.num:
            _, _, _, iv = pp.preprocess(attrs, camera, image_shape, cfg, front_only)
            sel, selv, inv, _ = compact_in_view(iv, subset_bucket)
            imp_s, cnt_s = render_stats(
                subset_view(pack_attrs(attrs), (sel, selv, inv)), camera, image_shape, cfg,
                render_mask, weight_thres, front_only, entry_budget=entry_budget,
            )
            present = inv >= 0
            inv_c = torch.clamp(inv, min=0)
            return torch.where(present, imp_s[inv_c], 0.0), torch.where(present, cnt_s[inv_c], 0)
        h, w = image_shape
        params2d, _, depth_z, in_view = pp.preprocess(attrs, camera, image_shape, cfg, front_only)
        b = binning.bin_entries(params2d, depth_z, in_view, image_shape, cfg, entry_budget)
        _, _, ntx, _ = binning.bin_tile_dims(image_shape, cfg)
        entries = gather_entries(params2d, b.gid)
        if render_mask is None:
            render_mask = torch.ones((h, w), device=entries.device)
        mask_tiles = image_to_tiles(render_mask.reshape(h, w), image_shape, cfg)
        imp_e, cnt_e = cp.composite_stats(
            entries, b.tile_start, b.tile_len, mask_tiles, weight_thres, ntx, cfg
        )
        n = attrs.num
        sums = scatter_sum(torch.stack([imp_e[0], cnt_e[0]], dim=1), torch.clamp(b.gid, min=0), n, b.gid >= 0)
        return sums[:, 0].contiguous(), sums[:, 1].to(torch.int32)
