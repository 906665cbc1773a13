"""Wrappers the harness puts around the program's entry points, from
outside the program: they pass every call through, and record what the
harness needs around it.

- `Spans`: host-clock spans (`time.time_ns`, the profiler's clock) around
  a mission step, the plan, the simulator, a keyframe's training and its
  post-processing; the simulator's span synchronises the device on both
  sides, so it times the frame synthesis itself.
- `Capture`: while armed, for one sampled step, what the comparison with
  the plain reference reads: the training's inputs and first three steps
  (per-step loss, the first step's per-view images, Adam's first moment
  after step 1, the leaves after step 3), the post-processing's input and
  its first stats render, and the planner's candidates, utilities, path
  lengths and scores. Tensors the program changes in place are cloned.
- `Launches`: while armed, each forward and backward compositor call's
  inputs in launch order, for the roofline's work count.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from activegs_torch.mapping import trainer
from activegs_torch.planning import astar, confidence
from activegs_torch.render import composite as cp

MAP_FIELDS = ("means", "scales_raw", "rotations_raw", "opacities_raw", "colors",
              "view_scores", "view_supports", "view_means")


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def raw_map(state) -> dict:
    """A clone of a map state's fields and its live count."""
    return {**{f: getattr(state, f).detach().clone() for f in MAP_FIELDS}, "count": int(state.count)}


class _Patches:
    def __init__(self):
        self._undo = []

    def patch(self, owner, name, wrap):
        """Put wrap(owner.name) in its place: on a module, or on an
        instance (whose bound method then comes back on close)."""
        old = getattr(owner, name)
        had = name in vars(owner)
        setattr(owner, name, wrap(old))
        self._undo.append((owner, name, old, had))

    def close(self):
        for owner, name, old, had in reversed(self._undo):
            if had:
                setattr(owner, name, old)
            else:
                delattr(owner, name)
        self._undo.clear()


class Spans(_Patches):
    """Host spans [(name, start_ns, end_ns)] while `on`; `sensing` holds
    the synchronised seconds of each simulator call."""

    def __init__(self, device, simulator=None, mapper=None, planner=None):
        super().__init__()
        self.device = device
        self.on = True
        self.spans: list = []
        self.sensing: list = []

        def span(name, sync=False):
            def wrap(fn):
                def inner(*a, **k):
                    if not self.on:
                        return fn(*a, **k)
                    if sync:
                        _sync(self.device)
                    t0 = time.time_ns()
                    try:
                        return fn(*a, **k)
                    finally:
                        if sync:
                            _sync(self.device)
                        t1 = time.time_ns()
                        self.spans.append((name, t0, t1))
                        if name == "simulate":
                            self.sensing.append((t1 - t0) / 1e9)
                return inner
            return wrap

        self.patch(trainer, "train_keyframe", span("train_keyframe"))
        self.patch(trainer, "post_process", span("post_process"))
        if simulator is not None:
            self.patch(simulator, "simulate", span("simulate", sync=True))
        if mapper is not None:
            self.patch(mapper, "step", span("step"))
        if planner is not None:
            self.patch(planner, "plan", span("plan"))

    def mark(self, name, t0, t1):
        self.spans.append((name, t0, t1))


class Capture(_Patches):
    """What one armed step computes, in `rec`."""

    def __init__(self, planner=None):
        super().__init__()
        self.armed = False
        self.rec: dict = {}
        self._calls = 0
        self._opt = None
        self._stats_next = False
        self.planner = planner

        def make_optimizer(fn):
            def inner(params, cfg):
                opt = fn(params, cfg)
                if self.armed and "train" not in self.rec:
                    self._opt = opt
                return opt
            return inner

        def batch_loss(fn):
            def inner(params, state, batch, counts, *a, **k):
                first = self.armed and "train" not in self.rec and self._calls == 0
                if first:
                    self._views = []
                loss, per_frame = fn(params, state, batch, counts, *a, **k)
                if self.armed and "train" not in self.rec:
                    i = self._calls
                    if i == 0:
                        self._t = {"raw": {**raw_map(state), **{k2: p.detach().clone() for k2, p in params.items()}},
                                   "batch": batch, "counts": counts.clone(), "loss": [], "images": self._views}
                    if i == 1 and self._opt is not None:
                        self._t["exp_avg"] = {k2: self._opt.state[p]["exp_avg"].clone() for k2, p in params.items()}
                    if i <= 2:
                        self._t["loss"].append(loss.detach())
                    if i == 3:
                        self._t["params"] = {k2: p.detach().clone() for k2, p in params.items()}
                        self.rec["train"] = self._t
                    self._calls += 1
                return loss, per_frame
            return inner

        def render_view(fn):
            def inner(*a, **k):
                out = fn(*a, **k)
                if self.armed and "train" not in self.rec and self._calls == 0:
                    o = out[0]
                    self._views.append({"rgb": o.rgb.detach(), "depth": o.depth.detach(),
                                        "confidence": o.confidence.detach()})
                return out
            return inner

        def train_keyframe(fn):
            def inner(*a, **k):
                out = fn(*a, **k)
                if self.armed and "train" in self.rec and "num_dropped" not in self.rec:
                    self.rec["num_dropped"] = out[3]["num_dropped"]
                return out
            return inner

        def post_process(fn):
            def inner(state, buf, depth_far, cfg, raster_cfg, require_prune, *a, **k):
                if self.armed and "stats" not in self.rec:
                    latest = max(buf.count - 1, 0)
                    slot = buf.order[latest]
                    self.rec["stats_in"] = {"raw": raw_map(state), "ext": buf.extrinsics[latest].clone(),
                                            "intr": buf.intrinsics[latest].clone(),
                                            "depth": buf.depth[slot, 0].to(torch.float32).clone()}
                    self._stats_next = True
                return fn(state, buf, depth_far, cfg, raster_cfg, require_prune, *a, **k)
            return inner

        def render_stats(fn):
            def inner(*a, **k):
                out = fn(*a, **k)
                if self._stats_next:
                    self.rec["stats"] = (out[0].clone(), out[1].clone())
                    self._stats_next = False
                return out
            return inner

        self.patch(trainer, "make_optimizer", make_optimizer)
        self.patch(trainer, "batch_loss", batch_loss)
        self.patch(trainer, "render_view", render_view)
        self.patch(trainer, "train_keyframe", train_keyframe)
        self.patch(trainer, "post_process", post_process)
        self.patch(trainer, "render_stats", render_stats)
        if planner is not None:
            def cal_utility(fn):
                def inner(gm_state, vstate, grid, candidates, simulator):
                    if self.armed and "plan" not in self.rec:
                        self.rec["plan"] = {"raw": raw_map(gm_state), "unexplored": vstate.unexplored.clone(),
                                            "candidates": np.array(candidates, np.float32)}
                    out = fn(gm_state, vstate, grid, candidates, simulator)
                    if self.armed and "utility" not in self.rec:
                        self.rec["utility"] = np.array(out[0], np.float64)
                    return out
                return inner

            def search_goal(fn):
                def inner(*a, **k):
                    out = fn(*a, **k)
                    if self.armed and "lengths" not in self.rec:
                        self.rec["lengths"] = np.array(out[1], np.float64)
                    return out
                return inner

            def candidate_utilities(fn):
                def inner(*a, **k):
                    out = fn(*a, **k)
                    if self.armed and "explore" not in self.rec:
                        self.rec["explore"] = np.array(out[0], np.float64)
                        self.rec["exploit"] = np.array(out[1], np.float64)
                    return out
                return inner

            self.patch(planner, "cal_utility", cal_utility)
            self.patch(confidence, "candidate_utilities", candidate_utilities)
            self.patch(astar, "search_goal", search_goal)

    def arm(self):
        self.armed, self._calls, self._opt = True, 0, None

    def disarm(self):
        self.armed = False
        if self.planner is not None and "utility" in self.rec and "choice" not in self.rec:
            self.rec["choice"] = int(np.argmax(self.planner.last_scores))


class Launches(_Patches):
    """Each compositor forward / backward call's inputs while `on`:
    `fwd` [(entries, tile_start, tile_len, ntx, cfg, tpv)], `bwd`
    [index into `fwd` of the call whose entries it differentiates]."""

    def __init__(self):
        super().__init__()
        self.on = False
        self.fwd: list = []
        self.bwd: list = []
        self._by_ptr: dict = {}

        def fwd(fn):
            def inner(entries, tile_start, tile_len, ntx, cfg, tpv=None):
                if self.on:
                    self._by_ptr[entries.data_ptr()] = len(self.fwd)
                    self.fwd.append((entries, tile_start, tile_len, ntx, cfg, tpv))
                return fn(entries, tile_start, tile_len, ntx, cfg, tpv)
            return inner

        def bwd(fn):
            def inner(entries, *a, **k):
                if self.on:
                    self.bwd.append(self._by_ptr.get(entries.data_ptr()))
                return fn(entries, *a, **k)
            return inner

        self.patch(cp, "composite_fwd", fwd)
        self.patch(cp, "composite_bwd", bwd)
