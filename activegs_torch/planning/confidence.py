"""Confidence planner: exploration + distance-aware uncertainty utility (port
of `activegs_tpu/planning/confidence.py`).

A plan step scores its candidate views as one batch, as the reference's
compiled map over candidates does: each candidate compacts the map to the
gaussians it sees and is preprocessed and binned on its own, then all
candidates render at `render_ratio` of the sensor resolution through
`render_views_batched`, one forward compositor launch per group of
candidates (a group's entry streams take at most `GROUP_BYTES`). The entry
budget and the subset bucket are measured over all candidates first
(`_candidate_entry_stats`), as the reference does, so every candidate's
stream has the same length. `candidate_view_stats` scores one view.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..mapping import gaussians as gm
from ..mapping import voxel_map as vm
from ..mapping.trainer import pick_entry_bucket, pick_subset_bucket
from ..render import binning as rb
from ..render import preprocess as rp
from ..render.renderer import compact_in_view, pack_attrs, render_view, render_views_batched, subset_view
from ..render.types import PARAM_DIM, Camera
from .planner import PlanBase

# the most bytes of concatenated entry streams one batched candidate launch takes
GROUP_BYTES = 4 << 30


@torch.no_grad()
def _candidate_entry_stats(gm_state, candidates, intrinsic, shape, map_cfg, raster_cfg):
    """(max binned entry count, max in-view count) over the candidate views
    (preprocess and span sums, no sort): they pick the utility renders'
    entry budget and subset bucket."""
    attrs = gm.attrs_of(gm_state, map_cfg)
    ents, ivs = [], []
    for ext in candidates:
        p2d, _, _, iv = rp.preprocess(attrs, Camera(extrinsic=ext, intrinsic=intrinsic), shape, raster_cfg)
        ents.append(rb.entry_count(p2d, iv, shape, raster_cfg))
        ivs.append(iv.sum())
    with tracing.host_read("candidate_entry_stats"):
        return int(torch.stack(ents).max()), int(torch.stack(ivs).max())


@torch.no_grad()
def candidate_view_stats(
    attrs,
    extrinsic,
    intrinsic,
    valid,
    unexplored,
    depth_range,
    grid,
    shape,
    raster_cfg,
    entry_budget,
    explore_only: bool,
    subset_bucket: int | None = None,
    packed=None,
):
    """(explore, exploit) for one candidate view: the visible-and-unexplored
    voxel fraction, and the distance-aware uncertainty (0 with
    `explore_only`). `subset_bucket` compacts the render to the candidate's
    in-view gaussians (exact: the others contribute nothing); `packed` is
    pack_attrs(attrs), hoisted out of the candidate loop."""
    cam = Camera(extrinsic=extrinsic, intrinsic=intrinsic)
    attrs = _candidate_attrs(attrs, cam, shape, raster_cfg, subset_bucket, packed)
    out, _ = render_view(attrs, cam, shape, raster_cfg, entry_budget=entry_budget)
    return _view_utility(out.depth[0], out.confidence[0], extrinsic, intrinsic, valid, unexplored, depth_range,
                         grid, explore_only)


def _candidate_attrs(attrs, cam, shape, raster_cfg, subset_bucket, packed):
    """The gaussians a candidate renders: its in-view subset in a bucket of
    `subset_bucket` (exact: the others contribute nothing), or all."""
    if subset_bucket is None:
        return attrs
    _, _, _, iv = rp.preprocess(attrs, cam, shape, raster_cfg)
    sel, selv, inv, _ = compact_in_view(iv, subset_bucket)
    return subset_view(packed, (sel, selv, inv))


def _view_utility(depth, conf, extrinsic, intrinsic, valid, unexplored, depth_range, grid, explore_only):
    """(explore, exploit) of one candidate from its rendered depth and
    confidence (h, w)."""

    # exploration: visible-and-unexplored voxel fraction
    depth_voxel = torch.where(depth < 0.001, 1e4, depth)
    depth_voxel = torch.clamp(depth_voxel, depth_range[0], depth_range[1])
    depth_voxel = torch.where(valid, depth_voxel, -1.0)
    visible = vm.visible_mask(None, grid, extrinsic, intrinsic, depth_voxel)
    explore = torch.sum(visible & unexplored) / grid.num_voxels
    if explore_only:
        return explore, torch.zeros_like(explore)

    # exploitation: distance-aware uncertainty
    conf = torch.where(depth > depth_range[1], 1.0, conf)
    conf = torch.where(valid, conf, 1.0)
    depth_surface = torch.where(depth < 0.001, depth_range[1] * 0.5, depth)
    exploit = torch.mean((1.0 - conf) * depth_surface / depth_range[1])
    return explore, exploit


@torch.no_grad()
def _confidence_utility_batch(
    gm_state,
    unexplored,
    candidates,
    intrinsic,
    valid_masks,
    depth_range,
    grid,
    shape,
    map_cfg,
    raster_cfg,
    entry_budget=None,
    explore_only=False,
    subset_bucket=None,
):
    """Per-candidate (explore (N,), exploit (N,)) utilities, NaN -> 0: each
    group of `utility_groups` renders through one `render_views_batched`
    call at the shared `entry_budget`, then each candidate's utility is
    taken from its slice of the group's images."""
    attrs = gm.attrs_of(gm_state, map_cfg)
    packed = pack_attrs(attrs) if subset_bucket is not None else None
    cams = [Camera(extrinsic=ext, intrinsic=intrinsic) for ext in candidates]
    stats = []
    for group in utility_groups(len(cams), attrs.num, shape, raster_cfg, entry_budget, subset_bucket):
        views = [_candidate_attrs(attrs, cams[i], shape, raster_cfg, subset_bucket, packed) for i in group]
        out, _ = render_views_batched(views, [cams[i] for i in group], shape, raster_cfg, entry_budget=entry_budget)
        stats += [
            _view_utility(out.depth[j, 0], out.confidence[j, 0], candidates[i], intrinsic, valid_masks[i],
                          unexplored, depth_range, grid, explore_only)
            for j, i in enumerate(group)
        ]
    explore, exploit = (torch.stack(x) for x in zip(*stats))
    return torch.nan_to_num(explore, nan=0.0), torch.nan_to_num(exploit, nan=0.0)


def utility_groups(n: int, num_gaussians: int, shape, raster_cfg, entry_budget, subset_bucket) -> list[range]:
    """The candidates [0, n) in the consecutive groups that
    `_confidence_utility_batch` renders together: as many as keep the
    group's entry streams within GROUP_BYTES (at least one), each stream
    that of the subset bucket (or of all `num_gaussians`) at
    `entry_budget`."""
    m = num_gaussians if subset_bucket is None else subset_bucket
    stream_bytes = PARAM_DIM * 4 * rb.stream_length(m, shape, raster_cfg, entry_budget)
    per = max(1, GROUP_BYTES // stream_bytes)
    return [range(i, min(i + per, n)) for i in range(0, n, per)]


def candidate_utilities(planner: PlanBase, gm_state, vstate, grid, candidates, simulator, explore_only):
    """Candidate (explore, exploit) utilities as numpy, with the measured
    entry budget and subset bucket; shared by the confidence and the
    exploration planners. With `planner.group` the candidates are split
    over its ranks (`parallel.sharded_candidate_utility`); the entry stats
    run over all candidates on every rank, so every rank picks the same
    budget and bucket. Returns (explore, exploit, seconds)."""
    h, w = (int(round(planner.cfg.render_ratio * r)) for r in simulator.resolution)
    valid_masks, _ = planner._candidate_valid_masks(candidates, simulator, (h, w))
    dev = gm_state.means.device
    with tracing.span("plan.utility") as whole:
        with tracing.span("plan.utility_stats") as stats:
            with tracing.host_read("candidate_utilities.poses"):
                cands = torch.as_tensor(np.asarray(candidates, np.float32), device=dev)
            max_ents, max_iv = _candidate_entry_stats(
                gm_state, cands, simulator.intrinsic, (h, w), planner.map_cfg, planner.utility_raster_cfg
            )
            entry_budget = pick_entry_bucket(max_ents)
            subset_bucket = pick_subset_bucket(max_iv, gm_state.capacity)
        with tracing.span("plan.utility_batch") as batch:
            with tracing.host_read("candidate_utilities.depth_range"):
                depth_range = torch.tensor(simulator.depth_range, dtype=torch.float32, device=dev)
            args = (gm_state, vstate.unexplored, cands, simulator.intrinsic, valid_masks, depth_range)
            rest = (grid, (h, w), planner.map_cfg, planner.utility_raster_cfg)
            opts = dict(entry_budget=entry_budget, explore_only=explore_only, subset_bucket=subset_bucket)
            if planner.group is not None:
                from ..parallel.sharded import sharded_candidate_utility

                explore, exploit = sharded_candidate_utility(*args, planner.group, *rest, **opts)
            else:
                explore, exploit = _confidence_utility_batch(*args, *rest, **opts)
            with tracing.host_read("candidate_utilities.to_host"):
                explore, exploit = explore.cpu().numpy(), exploit.cpu().numpy()
    # sub-phase telemetry, merged into step_stats' plan_times by plan()
    planner.last_utility_times = {"stats": round(stats.seconds, 3), "batch": round(batch.seconds, 3)}
    return explore, exploit, whole.seconds


class ConfidencePlanner(PlanBase):
    """utility = explore_weight * explore + exploit."""

    def cal_utility(self, gm_state, vstate, grid, candidates, simulator):
        explore, exploit, t = candidate_utilities(
            self, gm_state, vstate, grid, candidates, simulator, explore_only=False
        )
        return self.cfg.explore_weight * explore + exploit, t
