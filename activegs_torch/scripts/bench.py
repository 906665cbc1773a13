"""Train-step throughput of the port: rays/s through one keyframe's training
(port of the root `bench.py`).

    python -m activegs_torch.scripts.bench                # on the GPU
    BENCH_OPAQUE=1 python -m activegs_torch.scripts.bench
    BENCH_RES=32 BENCH_GAUSSIANS=512 BENCH_STEPS=1 python -m activegs_torch.scripts.bench device=cpu

The reference's workload shape: `MapConfig(capacity=2**19, batch_size=8,
optimization_steps=10)`, 512x512 frames and 200,000 camera-facing surfels
on the walls of a 6 x 5 x 3 m room (`build_scene`, the reference's numpy
draws in the reference's order), an 8-keyframe ring looking at the walls.
As in the mission loop, the map is sliced to its capacity bucket, and the
subset bucket and the entry budget are picked from
`trainer.keyframe_view_stats` over the four batches the runs draw. One
warm-up `train_keyframe` (kernel builds, the allocator's growth), then
three timed ones, each fenced by `torch.cuda.synchronize()`; the minimum
counts. rays = steps x batch x res^2, the reference's count: the port
renders each distinct drawn frame once and weights it by its count
(`trainer.batch_views`), so an earlier line (on stderr) also gives the
distinct views a step.

Knobs (the reference's environment names): BENCH_RES, BENCH_GAUSSIANS,
BENCH_STEPS; BENCH_BF16=1 sets `RasterConfig.bf16_pairs`; BENCH_OPAQUE=1
builds the scene at opacity_raw 5.0 (a converged map, where tiles saturate
and stop early) and adds `term_stats` from the forward wrapper's stop and
transmittance rows on keyframe 0; BENCH_PROFILE=<dir> writes a
torch.profiler trace of the timed runs there. The reference's
cross-tile-prefetch knob has no counterpart (a TPU-only option), and its
`--scaling` harness is not ported: on one card it is the main line.

Runs on the GPU; `device=cpu` runs the plain PyTorch versions on the CPU.
Prints ONE JSON line on stdout: `metric` train_rays_per_s_fwd_bwd, `value`,
`unit`, `vs_baseline` (and `variant`, `term_stats` under BENCH_OPAQUE).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ..apps.common import mission_device
from ..core import geometry as geo
from ..core import quaternions as quat
from ..mapping import gaussians as gm
from ..mapping import keyframes as kf
from ..mapping import trainer
from ..mapping.mapper import _sync
from ..planning.paths import rotation_from_z
from ..render import binning
from ..render import composite as cp
from ..render.renderer import _view_entries
from ..render.types import O_STOP, O_TRANS, Camera, RasterConfig

# the reference's normalization: an estimate of the original CUDA tile
# rasterizer's fwd+bwd throughput on one GPU (root `bench.py`)
BASELINE_RAYS_PER_S = 2.0e8
BATCH = 8
# the draws of the warm-up run and of the three timed runs, as the
# reference's PRNG keys (99, 0, 1, 2); here the seeds of torch.Generators
BENCH_KEYS = (99, 0, 1, 2)


def build_scene(res: int, n_gauss: int, cfg: gm.MapConfig, opacity_raw: float = 1.0, device="cuda"):
    """The reference's bench scene: surfels on 5 faces of a 6 x 5 x 3 m room
    shell facing inward, and an 8-keyframe ring at the room's centre looking
    at the walls, with random frames. Every value comes from
    `np.random.default_rng(0)` in the reference's order, so the scene is the
    reference's up to the quaternion math's rounding. opacity_raw 1.0
    (opacity 0.73) is a mid-mission map, 5.0 (0.993) a converged one.
    Returns (state, buf)."""
    rng = np.random.default_rng(0)
    pts = np.zeros((n_gauss, 3), np.float32)
    face = rng.integers(0, 5, n_gauss)
    r2 = rng.uniform(0, 1, (n_gauss, 2))
    dims = np.array([6.0, 5.0, 3.0])
    normals = np.zeros((n_gauss, 3), np.float32)
    for f in range(5):
        m = face == f
        axis, side = f % 3, f // 3
        p = np.zeros((m.sum(), 3))
        other = [a for a in range(3) if a != axis]
        p[:, other[0]] = r2[m, 0] * dims[other[0]]
        p[:, other[1]] = r2[m, 1] * dims[other[1]]
        p[:, axis] = side * dims[axis]
        pts[m] = p
        normals[m, axis] = 1.0 - 2.0 * side
    q, _ = quat.normal_to_quaternion(torch.from_numpy(normals).to(device))
    colors = rng.uniform(0, 1, (n_gauss, 3)).astype(np.float32)

    state = gm.init_state(cfg, device)
    state.means[:n_gauss] = torch.from_numpy(pts).to(device)
    state.rotations_raw[:n_gauss] = q
    state.scales_raw[:n_gauss, 2] = gm.FLAT_SCALE_RAW
    state.opacities_raw[:n_gauss] = opacity_raw
    state.colors[:n_gauss] = torch.from_numpy(colors).to(device)
    state = dataclasses.replace(state, count=n_gauss)

    buf = kf.init_buffer(8, res, res, device)
    intr = geo.intrinsics_from_fov(60.0, 60.0, device)
    center = dims / 2
    for i in range(8):
        ang = 2 * np.pi * i / 8
        e = np.eye(4, dtype=np.float32)
        e[:3, :3] = rotation_from_z(np.array([np.cos(ang), np.sin(ang), 0.05]))[0]
        e[:3, 3] = center
        frame = {
            "rgb": torch.from_numpy(rng.uniform(0, 1, (3, res, res)).astype(np.float32)).to(device),
            "depth": torch.from_numpy(rng.uniform(1.0, 4.0, (1, res, res)).astype(np.float32)).to(device),
            "extrinsic": torch.from_numpy(e).to(device),
            "intrinsic": intr,
            "depth_range": torch.tensor([0.0, 5.0], device=device),
        }
        buf = kf.add_frame(buf, frame)
    return state, buf


@torch.no_grad()
def term_probe(state, buf, map_cfg: gm.MapConfig, raster_cfg: RasterConfig, res: int) -> dict:
    """Early-termination telemetry on keyframe 0, from the forward
    wrapper's stop and transmittance rows: chunks available, chunks
    processed, tiles that stopped early, mean final transmittance."""
    attrs = gm.attrs_of(state, map_cfg)
    cam = Camera(extrinsic=buf.extrinsics[0], intrinsic=buf.intrinsics[0])
    shape = (res, res)
    entries, b, _, _ = _view_entries(attrs, cam, shape, raster_cfg, False, None, None)
    _, _, ntx, _ = binning.bin_tile_dims(shape, raster_cfg)
    out = cp.composite_fwd(entries, b.tile_start, b.tile_len, ntx, raster_cfg)
    stop = out[:, O_STOP, 0]
    nch = torch.ceil(b.tile_len.to(torch.float32) / raster_cfg.chunk)
    return {
        "chunks_available": int(nch.sum()),
        "chunks_processed": int(stop.sum()),
        "tiles_terminated_early": int((stop < nch).sum()),
        "num_tiles": len(b.tile_start),
        "mean_final_transmittance": round(float(out[:, O_TRANS, :].mean()), 4),
    }


def run_bench(
    res: int = 512,
    n_gauss: int = 200_000,
    steps: int = 10,
    bf16: bool = False,
    opaque: bool = False,
    device="cuda",
    profile_dir: str | None = None,
) -> dict:
    """The bench on `device`. Returns its JSON line's keys and, beside them,
    what the earlier lines report: `seconds` (the four runs), `subset_bucket`,
    `entry_budget`, `distinct_views` (a step, of each timed draw) and
    `rays`."""
    device = torch.device(device)
    cfg = gm.MapConfig(capacity=1 << 19, batch_size=BATCH, optimization_steps=steps)
    raster_cfg = RasterConfig(bf16_pairs=bf16)
    state, buf = build_scene(res, n_gauss, cfg, opacity_raw=5.0 if opaque else 1.0, device=device)

    # as the mission loop: the heavy work runs on the live-count bucket, and
    # each view trains its compacted in-view subset
    cap_b = gm.bucket_capacity(n_gauss, cfg.capacity)
    state = gm.slice_state(state, cap_b)
    # the budgets cover every batch the runs draw (a subset that misses a
    # gaussian drops it silently, unlike a dropped entry)
    draws = {k: trainer.draw_batch(buf, cfg, torch.Generator().manual_seed(k)) for k in BENCH_KEYS}
    stats = [trainer.keyframe_view_stats(state, buf, draws[k][0], cfg, raster_cfg) for k in BENCH_KEYS]
    subset_bucket = trainer.pick_subset_bucket(max(s[0] for s in stats), cap_b)
    entry_budget = trainer.pick_entry_bucket(max(s[1] for s in stats))

    def run(k):
        t0 = time.perf_counter()
        trainer.train_keyframe(state, buf, draws[k], cfg, raster_cfg, steps=steps,
                               subset_bucket=subset_bucket, entry_budget=entry_budget)
        _sync(device)
        return time.perf_counter() - t0

    warm = run(BENCH_KEYS[0])
    prof = contextlib.nullcontext()
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir))
    with prof:
        times = [run(k) for k in BENCH_KEYS[1:]]
    t = min(times)

    rays = steps * BATCH * res * res
    line = {
        "metric": "train_rays_per_s_fwd_bwd",
        "value": rays / t,
        "unit": "rays/s",
        "vs_baseline": rays / t / BASELINE_RAYS_PER_S,
    }
    if opaque:
        line["variant"] = "opaque"
        line["term_stats"] = term_probe(state, buf, cfg, raster_cfg, res)
    return {
        **line,
        "seconds": {"warm_up": warm, "timed": times},
        "subset_bucket": subset_bucket,
        "entry_budget": entry_budget,
        "distinct_views": [len(draws[k][0]) for k in BENCH_KEYS[1:]],
        "rays": rays,
    }


def env_flag(name: str) -> bool:
    """An environment switch: unset, empty and "0" are off."""
    return os.environ.get(name, "") not in ("", "0")


def main(argv: list[str] | None = None) -> dict:
    """The bench that the environment configures, on the device of the
    `device=` argument (default the card). Returns the printed line."""
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    device = mission_device(args)
    rec = run_bench(
        res=int(os.environ.get("BENCH_RES", 512)),
        n_gauss=int(os.environ.get("BENCH_GAUSSIANS", 200_000)),
        steps=int(os.environ.get("BENCH_STEPS", 10)),
        bf16=env_flag("BENCH_BF16"),
        opaque=env_flag("BENCH_OPAQUE"),
        device=device,
        profile_dir=os.environ.get("BENCH_PROFILE"),
    )
    line = {k: rec[k] for k in ("metric", "value", "unit", "vs_baseline", "variant", "term_stats") if k in rec}
    secs = rec["seconds"]
    print(
        f" {rec['rays']} rays a run (steps x batch {BATCH} x res^2, the reference's count); distinct views a step "
        f"{rec['distinct_views']} (each rendered once, weighted by its count); subset bucket {rec['subset_bucket']}, "
        f"entry budget {rec['entry_budget']}; warm-up {secs['warm_up']:.3f} s, timed "
        + " ".join(f"{t:.3f}" for t in secs["timed"]) + f" s on {device}",
        file=sys.stderr,
    )
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
