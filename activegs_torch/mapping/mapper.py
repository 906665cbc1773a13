"""The mapping half of one mission step (port of
`activegs_tpu/mapping/mapper.py::IncrementalMapper._step_inner`, lines
139-219): spawn on the new frame -> add the keyframe -> view stats ->
train_keyframe -> stats budgets -> post_process -> write back. The voxel
map, the planner and the mission loop come with the next slice.
"""

from __future__ import annotations

import time

import torch

from ..render.types import RasterConfig
from . import gaussians as gm
from . import keyframes as kfb
from . import trainer


def mapping_step(
    state: gm.GaussianMapState,
    buf: kfb.KeyframeBuffer,
    frame: dict,
    cfg: gm.MapConfig,
    raster_cfg: RasterConfig,
    generator: torch.Generator,
):
    """Integrate one posed RGB-D frame into the map. Returns (state, buf,
    stats) with the loss, spawn/prune counts, truncation telemetry and
    per-phase wall times (seconds, the device synchronized at each mark)."""
    dev = state.means.device
    phase_t = {}
    t0 = time.perf_counter()

    def mark(name):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        phase_t[name] = time.perf_counter() - t0 - sum(phase_t.values())

    state, n_new, n_spawn_dropped = gm.spawn(
        state, frame, cfg, raster_cfg,
        render_bucket=gm.bucket_capacity(state.count, cfg.capacity),
    )
    buf = kfb.add_frame(buf, frame)
    mark("spawn")

    cap_b = gm.bucket_capacity(state.count, cfg.capacity)
    sub = gm.slice_state(state, cap_b)
    views = trainer.draw_batch(buf, cfg, generator)
    max_in_view, max_entries = trainer.keyframe_view_stats(sub, buf, views[0], cfg, raster_cfg)
    subset_bucket = trainer.pick_subset_bucket(max_in_view, cap_b)
    entry_budget = trainer.pick_entry_bucket(max_entries)
    mark("view_stats")
    sub, buf, loss, aux = trainer.train_keyframe(
        sub, buf, views, cfg, raster_cfg, subset_bucket=subset_bucket, entry_budget=entry_budget
    )
    loss = float(loss)
    mark("train")

    occupancy = state.count / cfg.capacity
    early_prune = occupancy > cfg.prune_occupancy
    require_prune = buf.count % cfg.prune_interval == 0 or early_prune
    stats_iv, stats_ents = trainer.stats_view_budgets(sub, buf, cfg, raster_cfg, require_prune)
    sub, n_pruned = trainer.post_process(
        sub, buf, frame["depth_range"][1], cfg, raster_cfg, require_prune,
        stats_bucket=trainer.pick_subset_bucket(stats_iv, cap_b),
        stats_entry_budget=trainer.pick_entry_bucket(stats_ents),
    )
    state = gm.write_back(state, sub)
    mark("post")

    num_dropped = int(aux["num_dropped"])
    num_entries = int(aux["num_entries"])
    stats = {
        "loss": loss,
        "n_new": n_new,
        "n_pruned": n_pruned,
        "n_gaussians": state.count,
        "n_spawn_dropped": n_spawn_dropped,
        "num_dropped": num_dropped,
        "num_entries": num_entries,
        "dropped_frac": num_dropped / max(num_dropped + num_entries, 1),
        "require_prune": require_prune,
        "capacity_bucket": cap_b,
        "subset_bucket": subset_bucket,
        "entry_budget": entry_budget,
        "phase_times": phase_t,
    }
    return state, buf, stats
