"""Per-keyframe training + post-processing for the Gaussian-surfel map
(port of `activegs_tpu/mapping/trainer.py`).

Each keyframe draws one view batch (`draw_batch`), bins each view once
(frozen bins, optionally on the view's compacted in-view subset), and runs
`optimization_steps` of render -> 4-term loss -> Adam with a fresh
optimizer. With a `parallel.ViewGroup` the batch's views are split over
the group's ranks (`parallel.sharded_train_step`). With
`MapConfig.resample_per_step` every step draws a fresh batch and bins it
anew instead. `post_process` stats-renders keyframes for the Welford
confidence update and the periodic prune.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from .. import tracing
from ..render import binning as rb
from ..render import preprocess as rp
from ..render.renderer import (
    compact_in_view,
    pack_attrs,
    prepare_view_bins,
    render_stats,
    render_view,
    render_views_batched,
    subset_view,
)
from ..render.types import Camera, RasterConfig, RenderOutput
from . import gaussians as gm
from . import keyframes as kf
from .view_loss import view_loss

PARAM_FIELDS = ("means", "scales_raw", "rotations_raw", "opacities_raw", "colors")
_LR = {
    "means": "mean_lr",
    "scales_raw": "scale_lr",
    "rotations_raw": "rotation_lr",
    "opacities_raw": "opacity_lr",
    "colors": "harmonic_lr",
}


def make_optimizer(params: dict, cfg: gm.MapConfig) -> torch.optim.Adam:
    """Adam(eps=1e-15) with the reference's per-group learning rates — the
    same update as optax scale_by_adam -> per-group lr -> scale(-1)."""
    groups = [{"params": [params[k]], "lr": getattr(cfg, _LR[k])} for k in PARAM_FIELDS]
    return torch.optim.Adam(groups, eps=1e-15)


def _view_loss(o, rgb_gt, depth_gt, intrinsic):
    """(loss_v, err_v) for one view: loss_v = rgb + 0.8 depth + 0.1
    consistency + 0.1 normal-TV, err_v = rgb + depth (the sampler's error);
    `view_loss.view_loss`, one kernel each way on the card."""
    return view_loss(o.rgb, o.depth, o.normal, o.opacity, rgb_gt, depth_gt, intrinsic)


def batch_loss(
    params: dict,
    state: gm.GaussianMapState,
    batch: tuple,
    counts: torch.Tensor,
    cfg: gm.MapConfig,
    raster_cfg: RasterConfig,
    bins: list | None = None,
    subsets: list | None = None,
):
    """4-term mapping loss over a view batch: the per-view losses weighted
    by `counts` (V,), the times each view was drawn, over their total, i.e.
    the mean over the drawn batch. `bins` are per-view frozen `BinResult`s;
    `subsets` per-view (sel, sel_valid, inv) compactions the bins were built
    on. With `cfg.fused_view_kernel` and `subsets`, the views render
    through one compositor launch (`render_views_batched`). Returns (loss,
    per_frame_error detached)."""
    rgb_gt, depth_gt, extrinsics, intrinsics = batch
    v, _, h, w = rgb_gt.shape
    if cfg.fused_view_kernel and subsets is None:
        warnings.warn(
            "fused_view_kernel=True is only honored on the batched-subset "
            "path (subset_bucket set, single-device); falling back to "
            "per-view dispatch",
            stacklevel=2,
        )
    attrs = gm.attrs_of(dataclasses.replace(state, **params), cfg)
    packed = pack_attrs(attrs) if subsets is not None else None
    with tracing.host_read("batch_loss.background"):
        background = torch.tensor(cfg.background, dtype=torch.float32, device=rgb_gt.device)
    cams = [Camera(extrinsic=extrinsics[i], intrinsic=intrinsics[i]) for i in range(v)]
    views = [attrs if subsets is None else subset_view(packed, subsets[i]) for i in range(v)]
    if cfg.fused_view_kernel and subsets is not None:
        out, _ = render_views_batched(views, cams, (h, w), raster_cfg, background=background, bin_results=bins)
        outs = [RenderOutput(**{f.name: getattr(out, f.name)[i] for f in dataclasses.fields(out)}) for i in range(v)]
    else:
        outs = [
            render_view(
                views[i], cams[i], (h, w), raster_cfg, background=background,
                bin_result=None if bins is None else bins[i],
            )[0]
            for i in range(v)
        ]
    loss_t, err_t = [], []
    for i, o in enumerate(outs):
        lv, ev = _view_loss(o, rgb_gt[i], depth_gt[i], intrinsics[i])
        loss_t.append(lv)
        err_t.append(ev)
    w = counts.to(torch.float32)
    return torch.sum(torch.stack(loss_t) * w) / torch.sum(w), torch.stack(err_t).detach()


def batch_views(ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A drawn batch (V,) as (its distinct frames, the times each was
    drawn). While the buffer holds fewer keyframes than the batch, the
    sampler repeats frames: each distinct frame then renders once and
    weighs its count in `batch_loss`, the same mean as rendering every
    copy."""
    with tracing.host_read("batch_views.unique"):
        return torch.unique(ids, return_counts=True)


def draw_batch(
    buf: kf.KeyframeBuffer, cfg: gm.MapConfig, generator: torch.Generator, sampler: str = "weighted"
) -> tuple[torch.Tensor, torch.Tensor]:
    """The keyframe's view batch (chronological ranks), drawn once, as
    `batch_views`."""
    sample = kf.sample_weighted if sampler == "weighted" else kf.sample_uniform
    return batch_views(sample(buf, generator, cfg.batch_size, cfg.active_size))


@torch.no_grad()
def keyframe_view_stats(state, buf, ids, cfg: gm.MapConfig, raster_cfg: RasterConfig):
    """(max in-view count, max binned entry count) over the batch `ids` —
    read on the host to pick the subset bucket and the entry budget."""
    _, _, exts, intrs = kf.decode_frames(buf, ids)
    h, w = buf.rgb.shape[-2:]
    attrs0 = gm.attrs_of(state, cfg)
    ivs, ents = [], []
    for ext, intr in zip(exts, intrs):
        p2d, _, _, iv = rp.preprocess(attrs0, Camera(ext, intr), (h, w), raster_cfg)
        ivs.append(iv.sum())
        ents.append(rb.entry_count(p2d, iv, (h, w), raster_cfg))
    with tracing.host_read("keyframe_view_stats"):
        return int(torch.stack(ivs).max()), int(torch.stack(ents).max())


def _half_step_bucket(need: int, min_bucket: int) -> int:
    """Smallest bucket >= need on the {p2, 1.5 * p2} ladder."""
    if min_bucket & (min_bucket - 1):
        raise ValueError("min_bucket must be a power of two")
    b = min_bucket
    while b < need:
        if b + b // 2 >= need:
            return b + b // 2
        b *= 2
    return b


def pick_subset_bucket(max_count: int, capacity: int, min_bucket: int = 8192) -> int | None:
    """Per-view subset bucket, or None when compaction would not shrink the
    problem (bucket ~ capacity)."""
    b = _half_step_bucket(max_count, min_bucket)
    return None if b * 2 > capacity else b


def pick_entry_bucket(max_entries: int, min_bucket: int = 16384) -> int:
    """Entry budget covering the measured per-view binned entry count."""
    return _half_step_bucket(max_entries, min_bucket)


@torch.no_grad()
def prepare_views(
    state, batch, cfg: gm.MapConfig, raster_cfg: RasterConfig, subset_bucket=None, entry_budget=None, only=None
):
    """Frozen per-view bins (and subsets when `subset_bucket` is set) for
    the keyframe's batch, from the state before its first step. With
    `only` (a range of views, a rank's share), the other views' entries
    are None."""
    _, _, exts, intrs = batch
    h, w = batch[0].shape[-2:]
    attrs0 = gm.attrs_of(state, cfg)
    packed0 = pack_attrs(attrs0) if subset_bucket is not None else None
    bins = []
    subsets = [] if subset_bucket is not None else None
    for i, (ext, intr) in enumerate(zip(exts, intrs)):
        if only is not None and i not in only:
            bins.append(None)
            if subsets is not None:
                subsets.append(None)
            continue
        cam = Camera(ext, intr)
        attrs_v = attrs0
        if subset_bucket is not None:
            _, _, _, iv = rp.preprocess(attrs0, cam, (h, w), raster_cfg)
            sel, selv, inv, _ = compact_in_view(iv, subset_bucket)
            subsets.append((sel, selv, inv))
            attrs_v = subset_view(packed0, subsets[-1])
        bins.append(prepare_view_bins(attrs_v, cam, (h, w), raster_cfg, entry_budget=entry_budget))
    return bins, subsets


@tracing.span("train.keyframe")
def train_keyframe(
    state: gm.GaussianMapState,
    buf: kf.KeyframeBuffer,
    views: tuple[torch.Tensor, torch.Tensor] | None,
    cfg: gm.MapConfig,
    raster_cfg: RasterConfig,
    steps: int | None = None,
    subset_bucket: int | None = None,
    entry_budget: int | None = None,
    group=None,
    generator: torch.Generator | None = None,
    draw=None,
):
    """Per-keyframe optimization on the batch `views` = (ids, counts), from
    `draw_batch`: fresh Adam, `steps` iterations of render -> loss -> update
    with the view bins frozen at the first step. With `group` (a
    `parallel.ViewGroup`) each rank bins and renders its share of the views
    and the gradients are summed over the ranks (`sharded_train_step`);
    every view renders on its own (no `render_views_batched` across ranks;
    `fused_view_kernel` batches a rank's own views). Returns (state, buf,
    last loss, aux) with aux num_dropped / num_entries summed over the
    drawn batch (each view times its count); the sampler performance of the
    batch frames is updated in place.

    With `cfg.resample_per_step`, `views` is ignored: every step draws a
    fresh batch with `draw(buf)` (default: `draw_batch` from `generator`)
    on the performance as it stands, renders it with no frozen bins,
    subsets or entry budget (binning runs inside each render), and aux
    reads -1 (not tracked), as in the reference."""
    steps = cfg.optimization_steps if steps is None else steps
    with tracing.span("train.prepare"):
        params = {k: getattr(state, k).detach().clone().requires_grad_(True) for k in PARAM_FIELDS}
        opt = make_optimizer(params, cfg)
    last_loss = torch.zeros((), device=state.means.device)
    if cfg.resample_per_step:
        # unsharded on every rank, as the reference's resample loop ignores
        # its mesh: every rank draws the same batch from the same generator
        # state, so the ranks stay in step without a collective
        draw = draw or (lambda b: draw_batch(b, cfg, generator))
        for _ in range(steps):
            with tracing.span("train.prepare"):
                ids, counts = draw(buf)
                batch = kf.decode_frames(buf, ids)
            with tracing.span("train.update"):
                opt.zero_grad(set_to_none=True)
            with tracing.span("train.forward"):
                loss, per_frame = batch_loss(params, state, batch, counts, cfg, raster_cfg)
            with tracing.span("train.backward"):
                loss.backward()
            with tracing.span("train.update"):
                opt.step()
                kf.update_performance(buf, ids, per_frame)
            last_loss = loss.detach()
        new_state = dataclasses.replace(state, **{k: p.detach() for k, p in params.items()})
        return new_state, buf, last_loss, {"num_dropped": -1, "num_entries": -1}

    with tracing.span("train.prepare"):
        ids, counts = views
        batch = kf.decode_frames(buf, ids)
        share = None
        if group is not None:
            from ..parallel import sharded

            share = sharded.view_share(len(ids), group)
        bins, subsets = prepare_views(state, batch, cfg, raster_cfg, subset_bucket, entry_budget, only=share)
    for _ in range(steps):
        with tracing.span("train.update"):
            opt.zero_grad(set_to_none=True)
        if group is None:
            with tracing.span("train.forward"):
                loss, per_frame = batch_loss(params, state, batch, counts, cfg, raster_cfg, bins, subsets)
            with tracing.span("train.backward"):
                loss.backward()
        else:
            loss, grads, per_frame = sharded.sharded_train_step(
                params, state, batch, counts, group, cfg, raster_cfg, bins, subsets
            )
            for k, g in grads.items():
                params[k].grad = g
        with tracing.span("train.update"):
            opt.step()
            kf.update_performance(buf, ids, per_frame)
        last_loss = loss.detach()
    new_state = dataclasses.replace(state, **{k: p.detach() for k, p in params.items()})
    # truncation telemetry over the views binned here, summed over the ranks
    mine = [i for i, b in enumerate(bins) if b is not None]
    tele = torch.zeros(2, dtype=torch.int64, device=state.means.device)
    if mine:
        with tracing.host_read("train_keyframe.views"):
            c = counts[mine]
        tele[0] = torch.sum(torch.stack([bins[i].num_dropped for i in mine]) * c)
        tele[1] = torch.sum(torch.stack([bins[i].tile_len.sum() for i in mine]) * c)
    if group is not None:
        sharded.all_reduce_sum(tele, group)
    aux = {"num_dropped": tele[0], "num_entries": tele[1]}
    return new_state, buf, last_loss, aux


@torch.no_grad()
def stats_view_budgets(state, buf: kf.KeyframeBuffer, cfg: gm.MapConfig, raster_cfg: RasterConfig, require_prune: bool):
    """(max front-facing in-view count, max binned entry count) over the
    keyframes `post_process` will stats-render (the latest, or all of them
    on prune keyframes)."""
    h, w = buf.rgb.shape[-2:]
    attrs0 = gm.attrs_of(state, cfg)
    frames = range(buf.count) if require_prune else [max(buf.count - 1, 0)]
    ivs, ents = [], []
    for i in frames:
        cam = Camera(buf.extrinsics[i], buf.intrinsics[i])
        p2d, _, _, iv = rp.preprocess(attrs0, cam, (h, w), raster_cfg, front_only=True)
        ivs.append(iv.sum())
        ents.append(rb.entry_count(p2d, iv, (h, w), raster_cfg))
    with tracing.host_read("stats_view_budgets"):
        return int(torch.stack(ivs).max()), int(torch.stack(ents).max())


@torch.no_grad()
def post_process(
    state: gm.GaussianMapState,
    buf: kf.KeyframeBuffer,
    depth_far,
    cfg: gm.MapConfig,
    raster_cfg: RasterConfig,
    require_prune: bool,
    stats_bucket: int | None = None,
    stats_entry_budget: int | None = None,
):
    """Confidence statistics + periodic pruning: stats-render the latest
    keyframe (front-only, render mask depth > 0), update the Welford view
    statistics; with `require_prune`, accumulate visibility over all
    keyframes and prune never-visible or transparent gaussians. Returns
    (state, n_pruned)."""
    attrs = gm.attrs_of(state, cfg)
    h, w = buf.rgb.shape[-2:]
    latest = max(buf.count - 1, 0)

    def stats_for(i):
        with tracing.host_read("post_process.frame"):
            rank = torch.tensor([i], device=buf.order.device)
        _, depth, ext, intr = kf.decode_frames(buf, rank)
        return render_stats(
            attrs, Camera(ext[0], intr[0]), (h, w), raster_cfg,
            render_mask=(depth[0, 0] > 0.0).to(torch.float32), front_only=True,
            subset_bucket=stats_bucket, entry_budget=stats_entry_budget,
        )

    _, cnt_latest = stats_for(latest)
    cam_pos = buf.extrinsics[latest][:3, 3]
    state = gm.update_confidence(state, cfg, cam_pos, depth_far, cnt_latest)
    n_pruned = 0
    if require_prune:
        vis_any = torch.zeros(state.capacity, dtype=torch.bool, device=state.means.device)
        for i in range(buf.count):
            vis_any |= stats_for(i)[1] >= 1
        state, n_pruned = gm.prune(state, cfg, vis_any)
    return state, n_pruned
