"""Train-step throughput of the port: rays/s through one keyframe's training
(port of the root `bench.py`).

    python -m activegs_torch.scripts.bench                # on the GPU
    BENCH_OPAQUE=1 python -m activegs_torch.scripts.bench
    BENCH_RES=32 BENCH_GAUSSIANS=512 BENCH_STEPS=1 python -m activegs_torch.scripts.bench device=cpu
    python -m activegs_torch.scripts.bench scaling=1      # the sharded step over 1, 2, 4, ... ranks
    python -m activegs_torch.scripts.bench scaling=1 device=cpu ranks=1,2

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
cross-tile-prefetch knob has no counterpart (a TPU-only option).

`scaling=1` runs the port of the reference's `--scaling` harness
(`run_scaling`): the sharded train step (`parallel.sharded_train_step`)
of the reference's scaling scene (BENCH_RES default 128, BENCH_GAUSSIANS
4096, 8 views, BENCH_STEPS default 2) over every power of two of ranks up
to the card count (at most 8; one card: n = 1), one process a rank joined
over NCCL on localhost, each rank on its own card; with `device=cpu`, 1, 2
and 4 gloo ranks, as the reference's BENCH_SCALING_CPU; `ranks=1,2` picks
the sizes. One JSON line a size (`metric` scaling_train_rays_per_s,
`mesh_devices`, `value`, `unit`, `efficiency_vs_1dev`, `backend`, and the
largest scaled difference of rank 0's summed gradients from the single
process's on the same batch, `grad_max_scaled_err`), then a closing line
with the largest size's efficiency.

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
from ..render import preprocess as pp
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


def env_flag_value(value: str | None) -> bool:
    """A switch's value: unset, empty and "0" are off."""
    return (value or "") not in ("", "0")


def env_flag(name: str) -> bool:
    """An environment switch: unset, empty and "0" are off."""
    return env_flag_value(os.environ.get(name))


SCALING_VIEWS = 8  # the scaling batch, divisible by every size


def scaling_inputs(res: int, n_gauss: int, device):
    """The reference's scaling scene and batch (root `bench.py::run_scaling`),
    from `np.random.default_rng(0)` in its order: `n_gauss` surfels of
    random normals and colours in [-1, 1]^2 x [1, 3], opacity_raw 1, and 8
    identity-pose views of random frames. Returns (cfg, state, batch)."""
    rng = np.random.default_rng(0)
    cfg = gm.MapConfig(capacity=max(512, 1 << (n_gauss - 1).bit_length()))
    state = gm.init_state(cfg, device)
    normals = rng.normal(size=(n_gauss, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    q, _ = quat.normal_to_quaternion(torch.from_numpy(normals).to(device))
    state.means[:n_gauss] = torch.from_numpy(rng.uniform(-1, 1, (n_gauss, 3)).astype(np.float32)).to(device)
    state.means[:n_gauss, 2] += 2.0
    state.rotations_raw[:n_gauss] = q
    state.colors[:n_gauss] = torch.from_numpy(rng.uniform(0, 1, (n_gauss, 3)).astype(np.float32)).to(device)
    state.opacities_raw[:n_gauss] = 1.0
    state = dataclasses.replace(state, count=n_gauss)
    v = SCALING_VIEWS
    rgb = torch.from_numpy(rng.uniform(0, 1, (v, 3, res, res)).astype(np.float32)).to(device)
    depth = torch.from_numpy(rng.uniform(1, 3, (v, 1, res, res)).astype(np.float32)).to(device)
    exts = torch.eye(4, device=device).repeat(v, 1, 1)
    intrs = geo.intrinsics_from_fov(60.0, 60.0, device).repeat(v, 1, 1)
    return cfg, state, (rgb, depth, exts, intrs)


def _scaling_rank(rank: int, n: int, port: int, res: int, n_gauss: int, steps: int, cuda: bool, out) -> None:
    """One rank of a scaling size: joins the group of `n` ranks on
    localhost:`port` (NCCL, each rank on card `rank`; gloo on the CPU),
    times the sharded step (a warm-up, then max(2, steps) runs, each on
    the batch's colours moved by 1e-6 (i + 1) and fenced by a
    synchronize), and on rank 0 puts the fastest run's seconds, the loss,
    the rank's kernel launches in the sharded steps (read before the
    check), and the largest scaled difference of the summed gradients from
    the single process's `batch_loss` gradients on `out`."""
    import torch.distributed as dist

    from ..parallel import sharded

    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * n)))
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=n)
    try:
        cfg, state, batch = scaling_inputs(res, n_gauss, dev)
        rcfg, group = RasterConfig(), sharded.make_view_group(n)
        counts = torch.ones(SCALING_VIEWS, dtype=torch.int64, device=dev)
        params = {k: getattr(state, k).detach().clone().requires_grad_(True) for k in trainer.PARAM_FIELDS}

        def step(b):
            loss, grads, _ = sharded.sharded_train_step(params, state, b, counts, group, cfg, rcfg)
            _sync(dev)
            return loss, grads

        loss, grads = step(batch)
        times = []
        for i in range(max(2, steps)):
            t0 = time.perf_counter()
            step((batch[0] + 1e-6 * (i + 1), *batch[1:]))
            times.append(time.perf_counter() - t0)
        launches = {k.name: k.launches for k in (*cp.KERNELS, *cp.BF16_KERNELS, *pp.KERNELS)}
        if rank == 0:
            loss1, _ = trainer.batch_loss(params, state, batch, counts, cfg, rcfg)
            want = torch.autograd.grad(loss1, [params[k] for k in trainer.PARAM_FIELDS])
            err = max(float((grads[k] - w).abs().max() / w.abs().max().clamp(min=1e-30))
                      for k, w in zip(trainer.PARAM_FIELDS, want))
            out.put({"seconds": min(times), "runs_s": times, "loss": float(loss.detach()),
                     "loss_single": float(loss1.detach()), "grad_max_scaled_err": err,
                     "launches": launches})
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_scaling(res: int = 128, n_gauss: int = 4096, steps: int = 2, device="cuda", sizes=None) -> list[dict]:
    """The sharded train step's rays/s at each size of `sizes` (default:
    the powers of two up to the card count, at most 8, on the card; 1, 2
    and 4 on the CPU), each in its own processes. Returns one record a
    size, the reference's keys first."""
    import torch.multiprocessing as mp

    cuda = torch.device(device).type == "cuda"
    if sizes is None:
        top = min(torch.cuda.device_count(), 8) if cuda else 4
        sizes = [1 << i for i in range(top.bit_length()) if 1 << i <= top]
    if cuda and max(sizes) > torch.cuda.device_count():
        raise RuntimeError(f"NCCL takes one rank a card: sizes {sizes} on {torch.cuda.device_count()} card(s)")
    ctx = mp.get_context("spawn")
    results, base = [], None
    for n in sizes:
        out = ctx.SimpleQueue()
        mp.start_processes(_scaling_rank, args=(n, free_port(), res, n_gauss, steps, cuda, out), nprocs=n,
                           start_method="spawn")
        rec = out.get()
        rps = SCALING_VIEWS * res * res / rec["seconds"]
        base = rps if base is None else base
        results.append({
            "metric": "scaling_train_rays_per_s",
            "mesh_devices": n,
            "value": rps,
            "unit": "rays/s",
            "efficiency_vs_1dev": rps / (base * n),
            "backend": "nccl" if cuda else "gloo",
            **rec,
        })
    return results


def scaling_main(args: dict, device) -> dict:
    """`scaling=1`: one line a size, then the closing line."""
    env = os.environ.get
    sizes = [int(x) for x in args["ranks"].split(",")] if args.get("ranks") else None
    results = run_scaling(int(env("BENCH_RES", 128)), int(env("BENCH_GAUSSIANS", 4096)), int(env("BENCH_STEPS", 2)),
                          device, sizes)
    for line in results:
        print(json.dumps(line))
    last = results[-1]
    summary = {"metric": "scaling_efficiency", "value": last["efficiency_vs_1dev"], "unit": "fraction",
               "mesh_devices": [r["mesh_devices"] for r in results], "backend": last["backend"],
               "grad_max_scaled_err": max(r["grad_max_scaled_err"] for r in results),
               "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"}
    print(json.dumps(summary))
    return {"lines": results, "summary": summary}


def main(argv: list[str] | None = None) -> dict:
    """The bench that the environment configures, on the device of the
    `device=` argument (default the card). Returns the printed line (with
    `scaling=1`, the size lines and the closing line)."""
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    device = mission_device(args)
    if env_flag_value(args.get("scaling")):
        return scaling_main(args, device)
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
