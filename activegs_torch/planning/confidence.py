"""Confidence planner: exploration + distance-aware uncertainty utility (port
of `activegs_tpu/planning/confidence.py`).

Candidate views are scored one after another: each candidate compacts the
map to the gaussians it sees and renders once at `render_ratio` of the
sensor resolution through `render_view`, so it launches the forward
compositor kernel once. The entry budget and the subset bucket are measured
over all candidates first (`_candidate_entry_stats`), as the reference does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..mapping import gaussians as gm
from ..mapping import voxel_map as vm
from ..mapping.trainer import pick_entry_bucket, pick_subset_bucket
from ..render import binning as rb
from ..render import preprocess as rp
from ..render.renderer import compact_in_view, pack_attrs, render_view, subset_view
from ..render.types import Camera
from .planner import PlanBase


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
    if subset_bucket is not None:
        _, _, _, iv = rp.preprocess(attrs, cam, shape, raster_cfg)
        sel, selv, inv, _ = compact_in_view(iv, subset_bucket)
        attrs = subset_view(packed, (sel, selv, inv))
    out, _ = render_view(attrs, cam, shape, raster_cfg, entry_budget=entry_budget)
    depth = out.depth[0]

    # exploration: visible-and-unexplored voxel fraction
    depth_voxel = torch.where(depth < 0.001, 1e4, depth)
    depth_voxel = torch.clamp(depth_voxel, depth_range[0], depth_range[1])
    depth_voxel = torch.where(valid, depth_voxel, -1.0)
    visible = vm.visible_mask(None, grid, extrinsic, intrinsic, depth_voxel)
    explore = torch.sum(visible & unexplored) / grid.num_voxels
    if explore_only:
        return explore, torch.zeros_like(explore)

    # exploitation: distance-aware uncertainty
    conf = out.confidence[0]
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
    """Per-candidate (explore (N,), exploit (N,)) utilities, NaN -> 0."""
    attrs = gm.attrs_of(gm_state, map_cfg)
    packed = pack_attrs(attrs) if subset_bucket is not None else None
    explore, exploit = zip(*(
        candidate_view_stats(
            attrs, ext, intrinsic, valid, unexplored, depth_range, grid, shape, raster_cfg,
            entry_budget, explore_only, subset_bucket, packed,
        )
        for ext, valid in zip(candidates, valid_masks)
    ))
    explore, exploit = torch.stack(explore), torch.stack(exploit)
    return torch.nan_to_num(explore, nan=0.0), torch.nan_to_num(exploit, nan=0.0)


def candidate_utilities(planner: PlanBase, gm_state, vstate, grid, candidates, simulator, explore_only):
    """Candidate (explore, exploit) utilities as numpy, with the measured
    entry budget and subset bucket; shared by the confidence and the
    exploration planners. Returns (explore, exploit, seconds)."""
    h, w = (int(round(planner.cfg.render_ratio * r)) for r in simulator.resolution)
    valid_masks, _ = planner._candidate_valid_masks(candidates, simulator, (h, w))
    t0 = time.perf_counter()
    dev = gm_state.means.device
    cands = torch.as_tensor(np.asarray(candidates, np.float32), device=dev)
    max_ents, max_iv = _candidate_entry_stats(
        gm_state, cands, simulator.intrinsic, (h, w), planner.map_cfg, planner.utility_raster_cfg
    )
    entry_budget = pick_entry_bucket(max_ents)
    subset_bucket = pick_subset_bucket(max_iv, gm_state.capacity)
    t_stats = time.perf_counter() - t0
    explore, exploit = _confidence_utility_batch(
        gm_state, vstate.unexplored, cands, simulator.intrinsic, valid_masks,
        torch.tensor(simulator.depth_range, dtype=torch.float32, device=dev), grid, (h, w),
        planner.map_cfg, planner.utility_raster_cfg,
        entry_budget=entry_budget, explore_only=explore_only, subset_bucket=subset_bucket,
    )
    explore, exploit = explore.cpu().numpy(), exploit.cpu().numpy()
    t = time.perf_counter() - t0
    # sub-phase telemetry, merged into step_stats' plan_times by plan()
    planner.last_utility_times = {"stats": round(t_stats, 3), "batch": round(t - t_stats, 3)}
    return explore, exploit, t


class ConfidencePlanner(PlanBase):
    """utility = explore_weight * explore + exploit."""

    def cal_utility(self, gm_state, vstate, grid, candidates, simulator):
        explore, exploit, t = candidate_utilities(
            self, gm_state, vstate, grid, candidates, simulator, explore_only=False
        )
        return self.cfg.explore_weight * explore + exploit, t
