"""Traffic generator `mission`: the online mission loop in laps.

Set-up builds the mission from the seed through the port's
`apps.common.build_mission`, on the configuration file as it stands (every
setting the loader reads is in the file), flies `snapshot_after` steps,
and snapshots the mapper's state from outside the program: the map, the
keyframe buffer, the voxel map, the mapper's and the simulator's torch
generators, the planner's numpy generator, pose and roadmap, and the
frame id. It then flies `warm_laps` laps, so that every shape the window
uses has been run. The window runs laps: a lap restores the snapshot and
flies `lap_steps` steps through `IncrementalMapper.step`, and the window
ends at the first lap boundary at or after `--seconds`, so every run, at
any speed, measures the same steps. The traced run flies one more lap
under the profiler after the window.
"""

from __future__ import annotations

import copy
import dataclasses
import time

import torch

from activegs_torch.apps.common import build_mission
from activegs_torch.config import ConfigNode

from . import probe


def load(config: dict, seed: int) -> ConfigNode:
    """The configuration tree of a configuration file, with the run's
    seed."""
    tree = copy.deepcopy(config["config"])
    tree["seed"] = seed
    return ConfigNode.wrap(tree)


class System:
    unit = "steps"

    def __init__(self, cell, seed: int, device):
        tr = cell.traffic
        self.lap_steps = self.traced_units = tr["lap_steps"]
        self.device = device
        cfg = load(cell.config, seed)
        self.mapper, self.sim, self.planner, self.comp = build_mission(cfg, device)
        self.sim.generator.manual_seed(seed)
        self.spans = probe.Spans(device, self.sim, self.mapper, self.planner)
        self.capture = probe.Capture(self.planner if tr.get("check_planner", True) else None)
        self.check_step = seed % self.lap_steps
        self.mapper.init_map()
        for _ in range(tr["snapshot_after"]):
            self.mapper.step()
        self.snap = self._snapshot()
        for _ in range(tr["warm_laps"]):
            self.lap()

    def _snapshot(self) -> dict:
        m, p = self.mapper, self.planner
        kf = m.keyframes
        return {
            "gm": dataclasses.replace(m.gm_state, **{f: getattr(m.gm_state, f).clone() for f in probe.MAP_FIELDS}),
            "kf": dataclasses.replace(kf, **{f: getattr(kf, f).clone() for f in
                                             ("rgb", "depth", "order", "extrinsics", "intrinsics", "performance")}),
            "vm": dataclasses.replace(m.vm_state, **{f.name: getattr(m.vm_state, f.name).clone()
                                                     for f in dataclasses.fields(m.vm_state)}),
            "gen": m.generator.get_state(), "sim_gen": self.sim.generator.get_state(), "frame_id": m.frame_id,
            "rng": copy.deepcopy(p.rng.bit_generator.state), "pose": p.pose.copy(),
            "initialized": p.initialized, "graph": copy.deepcopy(p.graph),
        }

    def restore(self) -> None:
        s, m, p = self.snap, self.mapper, self.planner
        m.gm_state = dataclasses.replace(s["gm"], **{f: getattr(s["gm"], f).clone() for f in probe.MAP_FIELDS})
        m.keyframes = dataclasses.replace(s["kf"], **{f: getattr(s["kf"], f).clone() for f in
                                                      ("rgb", "depth", "order", "extrinsics", "intrinsics",
                                                       "performance")})
        m.vm_state = dataclasses.replace(s["vm"], **{f.name: getattr(s["vm"], f.name).clone()
                                                     for f in dataclasses.fields(s["vm"])})
        m.generator.set_state(s["gen"])
        self.sim.generator.set_state(s["sim_gen"])
        m.frame_id = s["frame_id"]
        p.rng.bit_generator.state = copy.deepcopy(s["rng"])
        p.pose = s["pose"].copy()
        p.initialized = s["initialized"]
        p.graph = copy.deepcopy(s["graph"])

    def lap(self, check: bool = False) -> list[dict]:
        """Restore the snapshot and fly one lap; with `check`, arm the
        capture for the sampled step. Returns the steps' stats."""
        t0 = time.time_ns()
        self.restore()
        self.spans.mark("restore", t0, time.time_ns())
        stats = []
        for j in range(self.lap_steps):
            armed = check and j == self.check_step
            if armed:
                self.capture.arm()
            stats.append(self.mapper.step())
            if armed:
                self.capture.disarm()
        return stats

    def window(self, seconds: float) -> dict:
        """Laps until `seconds` have passed, at a lap boundary."""
        self.spans.sensing.clear()
        steps = []
        t0 = time.perf_counter()
        while True:
            steps += self.lap(check=not steps)
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        return {"wall_s": wall, "units": len(steps), "steps": steps, "sensing": list(self.spans.sensing),
                "failed": sum(1 for s in steps if not s["loss"] == s["loss"]),
                "e2e": {"mission_step_s": wall / len(steps)}}

    def traced(self):
        """One lap, for the profiler; returns its host spans."""
        self.spans.spans.clear()
        self.lap()
        return list(self.spans.spans)

    def close(self) -> None:
        self.capture.close()
        self.spans.close()
        self.mapper = self.sim = self.planner = self.snap = None
