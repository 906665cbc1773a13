"""Incremental mapper: the online active-reconstruction mission loop (port
of `activegs_tpu/mapping/mapper.py`).

Each step plans to the next-best view and senses there, then updates the
map: `mapping_step` (spawn on the new frame -> add the keyframe -> view
stats -> train_keyframe -> stats budgets -> post_process -> write back),
then the voxel log-odds update, then records, until the simulated-time
budget runs out. Host code orchestrates; the heavy steps are the renderer's
kernels and torch ops on the map's device.

When `torch.distributed` is initialized with more than one rank, every rank
runs this loop on the same inputs and seeds: training views and planner
candidates are split over the ranks (`parallel/sharded.py`), every other
step is computed by each rank alike, so the ranks' maps stay bitwise equal;
only rank 0 writes through the recorder and the viewer.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .. import tracing
from ..io.recorder import MissionRecorder
from ..render.types import RasterConfig
from . import gaussians as gm
from . import keyframes as kfb
from . import trainer
from . import voxel_map as vm


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        with tracing.host_read("mapper.synchronize"):
            torch.cuda.synchronize(dev)


def mapping_step(
    state: gm.GaussianMapState,
    buf: kfb.KeyframeBuffer,
    frame: dict,
    cfg: gm.MapConfig,
    raster_cfg: RasterConfig,
    generator: torch.Generator,
    group=None,
):
    """Integrate one posed RGB-D frame into the map. Returns (state, buf,
    stats) with the loss, spawn/prune counts, truncation telemetry and
    per-phase wall times (seconds, the spans `map.<phase>`, each ending with
    the device synchronized).
    `group` (a `parallel.ViewGroup`) splits the training views over its
    ranks. Under `cfg.resample_per_step` the batch is drawn at every step
    inside `train_keyframe`, so there are no view stats, buckets or
    truncation telemetry (-1)."""
    dev = state.means.device
    phase_t = {}

    with tracing.span("map.spawn") as sp:
        state, n_new, n_spawn_dropped = gm.spawn(
            state, frame, cfg, raster_cfg,
            render_bucket=gm.bucket_capacity(state.count, cfg.capacity),
        )
        buf = kfb.add_frame(buf, frame)
        _sync(dev)
    phase_t["spawn"] = sp.seconds

    with tracing.span("map.view_stats") as sp:
        cap_b = gm.bucket_capacity(state.count, cfg.capacity)
        sub = gm.slice_state(state, cap_b)
        views = subset_bucket = entry_budget = None
        if not cfg.resample_per_step:
            views = trainer.draw_batch(buf, cfg, generator)
            max_in_view, max_entries = trainer.keyframe_view_stats(sub, buf, views[0], cfg, raster_cfg)
            subset_bucket = trainer.pick_subset_bucket(max_in_view, cap_b)
            entry_budget = trainer.pick_entry_bucket(max_entries)
        _sync(dev)
    phase_t["view_stats"] = sp.seconds

    with tracing.span("map.train") as sp:
        sub, buf, loss, aux = trainer.train_keyframe(
            sub, buf, views, cfg, raster_cfg, subset_bucket=subset_bucket, entry_budget=entry_budget, group=group,
            generator=generator,
        )
        with tracing.host_read("mapping_step.loss"):
            loss = float(loss)
        _sync(dev)
    phase_t["train"] = sp.seconds

    with tracing.span("map.post") as sp:
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
        _sync(dev)
    phase_t["post"] = sp.seconds

    with tracing.host_read("mapping_step.telemetry"):
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
        "dropped_frac": dropped_fraction(num_dropped, num_entries),
        "occupancy": occupancy,
        "early_prune": early_prune,
        "require_prune": require_prune,
        "capacity_bucket": cap_b,
        "subset_bucket": subset_bucket,
        "entry_budget": entry_budget,
        "phase_times": phase_t,
    }
    return state, buf, stats


def dropped_fraction(num_dropped: int, num_entries: int) -> float:
    """num_dropped / (num_dropped + num_entries), or -1.0 where the
    counters were not tracked (-1, the resampling path)."""
    if num_dropped < 0:
        return -1.0
    return num_dropped / max(num_dropped + num_entries, 1)


class IncrementalMapper:
    """The mission loop: plan -> sense -> map -> voxel update -> record.
    Wire a simulator, a planner and optionally a recorder, then `init_map`
    and `step` (or `run`). Random draws come from a `torch.Generator`
    seeded with `seed`; the planner keeps its own numpy generator.
    `viewer` (`viz.MissionViewer` or `viz.WebViewer`) gets `on_step` after
    each step.

    With `torch.distributed` initialized over more than one rank, the
    mapper builds a `parallel.ViewGroup` of all ranks and hands it to
    training and to the planner. The world size must be a power of two
    that divides `MapConfig.batch_size` (the reference left the devices
    past such a size idle; here every rank runs the whole loop, so a rank
    cannot sit out). Every rank must pass the same seeds."""

    def __init__(
        self,
        map_cfg: gm.MapConfig = gm.MapConfig(),
        voxel_cfg: vm.VoxelConfig = vm.VoxelConfig(),
        raster_cfg: RasterConfig = RasterConfig(),
        keyframe_capacity: int = 256,
        seed: int = 0,
        device="cuda",
        viewer=None,
    ):
        self.map_cfg = map_cfg
        self.voxel_cfg = voxel_cfg
        self.raster_cfg = raster_cfg
        self.keyframe_capacity = keyframe_capacity
        self.device = torch.device(device)
        self.generator = torch.Generator().manual_seed(seed)
        self.viewer = viewer
        self.group = None
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            from ..parallel import sharded

            world = dist.get_world_size()
            if sharded.group_size(world, map_cfg.batch_size) != world:
                raise ValueError(
                    f"{world} ranks: the views split over a power of two of ranks that divides "
                    f"batch_size {map_cfg.batch_size}"
                )
            self.group = sharded.make_view_group()
        self.simulator = None
        self.planner = None
        self.recorder: Optional[MissionRecorder] = None
        self.gm_state: Optional[gm.GaussianMapState] = None
        self.vm_state: Optional[vm.VoxelMapState] = None
        self.grid: Optional[vm.VoxelGrid] = None
        self.keyframes: Optional[kfb.KeyframeBuffer] = None
        self.frame_id = 0

    def load_simulator(self, simulator):
        self.simulator = simulator

    def load_planner(self, planner):
        self.planner = planner
        if self.group is not None and getattr(planner, "group", None) is None:
            planner.group = self.group

    @property
    def writes(self) -> bool:
        """Whether this process writes through the recorder and the viewer
        (rank 0, or the only process)."""
        return self.group is None or self.group.rank == 0

    def load_recorder(self, recorder):
        self.recorder = recorder

    def init_map(self):
        self.gm_state = gm.init_state(self.map_cfg, self.device)
        self.grid = vm.VoxelGrid.create(self.simulator.bbox, self.voxel_cfg)
        self.vm_state = vm.init_state(self.grid, self.device)
        h, w = (int(x) for x in self.simulator.resolution)
        self.keyframes = kfb.init_buffer(self.keyframe_capacity, h, w, self.device)

    def get_new_dataframe(self):
        """Plan to the next-best view and sense there. Returns (frame, the
        camera path (S, 4, 4) numpy)."""
        cap_b = gm.bucket_capacity(self.gm_state.count, self.map_cfg.capacity)
        path = self.planner.plan(
            gm.slice_state(self.gm_state, cap_b), self.vm_state, self.grid, self.simulator,
            self.recorder if self.writes else None,
        )
        return self.simulator.simulate(torch.as_tensor(path[-1], device=self.device)), path

    def step(self) -> dict:
        """One mission iteration. Returns its stats: loss, spawn / prune
        counts, truncation telemetry, mapping phase times (spawn,
        view_stats, train, post, voxel) and the planner's phase times."""
        frame, path = self.get_new_dataframe()
        with tracing.span("map.step") as step_span:
            self.gm_state, self.keyframes, st = mapping_step(
                self.gm_state, self.keyframes, frame, self.map_cfg, self.raster_cfg, self.generator, self.group
            )
            phase_t = st["phase_times"]
            with tracing.span("map.voxel") as sp:
                self.vm_state = vm.update(self.vm_state, self.grid, frame)
                _sync(self.device)
            phase_t["voxel"] = sp.seconds
        t_mapping = step_span.seconds

        num_dropped, num_entries = st["num_dropped"], st["num_entries"]
        dropped_frac = round(dropped_fraction(num_dropped, num_entries), 5)
        # truncation health: both caps are survivable by design, but never
        # silent
        if dropped_frac > self.map_cfg.warn_dropped_frac:
            print(
                f" WARNING: {100 * dropped_frac:.1f}% of tile entries dropped "
                f"(max_dup/entry-budget truncation) at step {self.frame_id + 1}"
            )
        if st["n_spawn_dropped"] > 0:
            print(
                f" WARNING: {st['n_spawn_dropped']} spawns dropped at full capacity "
                f"({self.gm_state.count}/{self.map_cfg.capacity}) at step {self.frame_id + 1}"
            )

        self.frame_id += 1
        occupancy = st["occupancy"]
        stats = {
            "frame_id": self.frame_id,
            "loss": st["loss"],
            "n_new": st["n_new"],
            "n_pruned": st["n_pruned"],
            "n_gaussians": self.gm_state.count,
            "t_mapping": t_mapping,
            "num_dropped": num_dropped,
            "num_entries": num_entries,
            "dropped_frac": dropped_frac,
            "n_spawn_dropped": st["n_spawn_dropped"],
            "capacity_occupancy": round(occupancy, 4),
            "early_prune": st["early_prune"],
            "capacity_bucket": st["capacity_bucket"],
            "bucket_occupancy": self.gm_state.count / st["capacity_bucket"],
            "subset_bucket": st["subset_bucket"],
            "entry_budget": st["entry_budget"],
            "phase_times": {k: round(v, 3) for k, v in phase_t.items()},
            "plan_times": dict(getattr(self.planner, "last_plan_times", {})),
        }
        if self.viewer is not None and self.writes:
            self.viewer.on_step(self, frame, path, stats)
        if self.recorder is not None and self.writes:
            self.recorder.update_time("mapping", t_mapping)
            self.recorder.log_step_stats(stats)
            self.recorder.log()
            self.recorder.save_dataframe(frame, f"{self.frame_id:03d}")
            if self.recorder.require_record:
                self.recorder.save_map(self.gm_state, self.map_cfg, f"{self.frame_id:03d}")
                self.recorder.save_path()
        return stats

    def run(self, max_steps: Optional[int] = None):
        """Run the mission until the budget expires (or `max_steps`)."""
        self.init_map()
        while self.alive():
            stats = self.step()
            print(
                f" step {stats['frame_id']}: loss {stats['loss']:.4f}, "
                f"{stats['n_gaussians']} gaussians (+{stats['n_new']}/-{stats['n_pruned']}), "
                f"mapping {stats['t_mapping']:.2f}s "
                f"({' '.join(f'{k}={v:.2f}' for k, v in stats['phase_times'].items())}), "
                f"dropped {stats['num_dropped']}, "
                f"bucket {stats['n_gaussians']}/{stats['capacity_bucket']}, "
                f"subset {stats['subset_bucket']}, entries {stats['entry_budget']}"
            )
            if max_steps is not None and self.frame_id >= max_steps:
                break
        if self.recorder is not None and self.writes:
            self.recorder.save_map(self.gm_state, self.map_cfg, "final")
            self.recorder.save_path()

    def alive(self) -> bool:
        """Whether the mission budget has time left: rank 0's recorder
        decides for every rank (the ranks' clocks differ)."""
        alive = self.recorder is None or not self.writes or self.recorder.is_alive
        if self.group is None:
            return alive
        from ..parallel.sharded import broadcast_flag

        return broadcast_flag(alive, self.group, self.device)
