"""Traffic generator `train`: one keyframe's training after another, the
reference bench's shape, with the planner bypassed.

Set-up makes the scene on the device from the seed, in a few large calls
(`surfels` camera-facing surfels on the floor and four walls of a room of
`room` metres, opacity logit `opacity_raw`, and a ring of `keyframes`
frames at the room's centre looking at the walls), slices the map to its
capacity bucket, picks the subset bucket and the entry budget that every
view of the ring needs (`keyframe_view_stats`, with the mission's
buckets), and runs one warm `train_keyframe`. The window calls
`trainer.train_keyframe` as `scripts/bench.py::run_bench` and the mapper
call it: on a batch that `trainer.draw_batch` draws with the configured
weighted sampler from a generator seeded by `--seed`, each call on fresh
frames drawn on the device (colours on the 8-bit grid, depths in
`depth_range` on the half-precision grid, so the buffer holds them
exactly); it ends at a call boundary at or after `--seconds`. The budgets
come from every view of the ring, so they cover every draw. With the
ring's 8 keyframes, batch 8 and active 3, every draw holds each view once
(`run_bench` reports `distinct_views` 8), so every call does the same
work: the map and the poses stay, the frames change.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from activegs_torch.config import build_components
from activegs_torch.mapping import gaussians as gm
from activegs_torch.mapping import keyframes as kf
from activegs_torch.mapping import trainer

from . import arith, probe
from .check import intrinsics
from .mission import load

# the unit quaternion (w, x, y, z) turning the surfel's z axis onto each
# face's inward normal: +x, +y, +z (floor), -x, -y
_S = math.sqrt(0.5)
FACE_QUATS = ((_S, 0.0, _S, 0.0), (_S, -_S, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (_S, 0.0, -_S, 0.0), (_S, _S, 0.0, 0.0))


class System:
    unit = "keyframes"
    traced_units = 3

    def __init__(self, cell, seed: int, device):
        tr = cell.traffic
        cfg = load(cell.config, seed)
        comp = build_components(cfg)
        self.cfg, self.rc, self.device = comp["map_cfg"], comp["raster_cfg"], device
        self.res = tuple(int(x) for x in cfg.simulator.sensor.resolution)
        self.depth_range = tr["depth_range"]
        self.gen = torch.Generator(device=device).manual_seed(seed)
        state, self.buf = self._scene(tr, cfg)
        cap_b = arith.bucket_capacity(state.count, self.cfg.capacity)
        self.state = gm.slice_state(state, cap_b)
        self.draws = torch.Generator().manual_seed(seed)
        ring = torch.arange(tr["keyframes"], device=device)
        max_iv, max_e = trainer.keyframe_view_stats(self.state, self.buf, ring, self.cfg, self.rc)
        self.subset_bucket = arith.subset_bucket(max_iv, cap_b)
        self.entry_budget = arith.entry_budget(max_e)
        self.spans = probe.Spans(device)
        self.capture = probe.Capture()
        self.check_call = seed % 3
        self.call()

    def _scene(self, tr: dict, cfg):
        dev, g, n = self.device, self.gen, tr["surfels"]
        dims = torch.tensor(tr["room"], dtype=torch.float32, device=dev)
        face = torch.randint(0, 5, (n,), generator=g, device=dev)
        uv = torch.rand((n, 2), generator=g, device=dev)
        axis, side = face % 3, (face // 3).to(torch.float32)
        pts = torch.zeros((n, 3), device=dev)
        ar = torch.arange(n, device=dev)
        other0, other1 = (axis + 1) % 3, (axis + 2) % 3
        lo, hi = torch.minimum(other0, other1), torch.maximum(other0, other1)
        pts[ar, lo] = uv[:, 0] * dims[lo]
        pts[ar, hi] = uv[:, 1] * dims[hi]
        pts[ar, axis] = side * dims[axis]
        state = gm.init_state(self.cfg, dev)
        state.means[:n] = pts
        state.rotations_raw[:n] = torch.tensor(FACE_QUATS, device=dev)[face]
        state.scales_raw[:n, 2] = gm.FLAT_SCALE_RAW
        state.opacities_raw[:n] = tr["opacity_raw"]
        state.colors[:n] = torch.rand((n, 3), generator=g, device=dev)
        state = type(state)(**{**{f: getattr(state, f) for f in probe.MAP_FIELDS}, "count": n})

        h, w = self.res
        buf = kf.init_buffer(tr["keyframes"], h, w, dev)
        intr = intrinsics(cfg.simulator.sensor.fov, dev)
        centre = np.asarray(tr["room"], np.float64) / 2
        for i in range(tr["keyframes"]):
            ang = 2 * np.pi * i / tr["keyframes"]
            e = np.eye(4, dtype=np.float32)
            e[:3, :3] = arith.rotation_from_z(np.array([np.cos(ang), np.sin(ang), 0.05]))
            e[:3, 3] = centre
            rgb, depth = self._frame(1)
            buf = kf.add_frame(buf, {"rgb": rgb[0], "depth": depth[0], "extrinsic": torch.from_numpy(e).to(dev),
                                     "intrinsic": intr,
                                     "depth_range": torch.tensor(cfg.simulator.sensor.depth_range, device=dev)})
        return state, buf

    def _frame(self, n: int):
        """`n` frames: colours on the 8-bit grid, depths in depth_range on
        the half-precision grid."""
        h, w = self.res
        rgb = torch.randint(0, 256, (n, 3, h, w), generator=self.gen, device=self.device).to(torch.float32) / 255.0
        lo, hi = self.depth_range
        depth = (lo + (hi - lo) * torch.rand((n, 1, h, w), generator=self.gen, device=self.device)).half().float()
        return rgb, depth

    def call(self, check: bool = False):
        """Fresh frames for every view of the ring, a drawn batch, then one
        keyframe's training."""
        rgb, depth = self._frame(self.buf.count)
        self.buf.rgb[self.buf.order[: self.buf.count]] = torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.uint8)
        self.buf.depth[self.buf.order[: self.buf.count]] = depth.half()
        views = trainer.draw_batch(self.buf, self.cfg, self.draws)
        if check:
            self.capture.arm()
        out = trainer.train_keyframe(self.state, self.buf, views, self.cfg, self.rc,
                                     subset_bucket=self.subset_bucket, entry_budget=self.entry_budget)
        if check:
            self.capture.disarm()
        return out

    def window(self, seconds: float) -> dict:
        """Keyframes until `seconds` have passed, at a keyframe boundary."""
        calls, losses = 0, []
        t0 = time.perf_counter()
        while True:
            t = time.time_ns()
            losses.append(self.call(check=calls == self.check_call)[2])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.spans.mark("train_keyframe", t, time.time_ns())
            calls += 1
            if time.perf_counter() - t0 >= seconds and calls > self.check_call:
                break
        wall = time.perf_counter() - t0
        h, w = self.res
        rays = calls * arith.rays(self.cfg.optimization_steps, self.cfg.batch_size, h, w)
        return {"wall_s": wall, "units": calls, "failed": sum(1 for x in losses if not torch.isfinite(x)),
                "e2e": {"train_mrays_per_s": rays / wall / 1e6}}

    def traced(self):
        """`traced_units` keyframes, for the profiler; returns their host
        spans."""
        self.spans.spans.clear()
        for _ in range(self.traced_units):
            t = time.time_ns()
            self.call()
            torch.cuda.synchronize(self.device)
            self.spans.mark("train_keyframe", t, time.time_ns())
        return list(self.spans.spans)

    def close(self) -> None:
        self.capture.close()
        self.spans.close()
        self.state = self.buf = None
