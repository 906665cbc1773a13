"""What the profiling scripts of this package share: their arguments, the
bench's train-step setup, host and device timing, and torch.profiler's
device busy time.

The scripts (`tile_scan`, `kernel_overhead`, `profile_bwd`, `profile_step`,
`profile_planner`, `profile_mission_train`) are the ports of the
reference's `scripts/` of the same names. They measure what those measure
at the same shapes; only the timing method is this card's, not the TPU's
(the reference ran ITERS calls inside one jit and subtracted a fixed
dispatch time):

- host ms: the host clock around a call that ends in
  `torch.cuda.synchronize()`, the median of several calls after a warm-up;
- event ms: CUDA events around each call, the median (`probe.time_ms`);
- device busy ms: the union of the device operations' intervals in a
  torch.profiler trace of one call (CUDA activity), padded by PAD_S of
  idle on each side: on the card's machine a short trace may lose its
  first device operations (in runs of `chip_smoke.py` on an NVIDIA H100,
  half the traces padded by 1 s lost 36-38 of them, and one in seven
  padded by 2.5 s lost some). The trace also counts the runtime calls
  that launch a kernel, copy or fill, so a lossy trace shows as fewer
  operations recorded than launched, and is taken again, at most TRACES
  times in all. A script takes every host time before its first trace
  (`timed`).

On the CPU (`device=cpu`) the host times are CPU times and every device
figure is None ("not measured"): a CPU run has no device time.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import sys
import time

import torch

from ..apps.common import mission_device
from ..mapping import gaussians as gm
from ..mapping import keyframes as kf
from ..mapping import trainer
from ..render.types import RasterConfig
from . import bench

PAD_S = 2.5  # idle before and after a profiled call
TRACES = 5  # traces of a call at most, while they record fewer operations than were launched


def parse(argv: list[str] | None) -> tuple[dict, list[str], torch.device]:
    """(`key=value` arguments, the other arguments, the device): the card
    unless `device=` names another; raises without a card unless told
    `device=cpu`."""
    argv = sys.argv[1:] if argv is None else argv
    args = dict(a.split("=", 1) for a in argv if "=" in a)
    return args, [a for a in argv if "=" not in a], mission_device(args)


def bench_shape(res: int = 512, n_gauss: int = 200_000, steps: int = 10) -> tuple[int, int, int]:
    """(BENCH_RES, BENCH_GAUSSIANS, BENCH_STEPS) from the environment, the
    reference's knobs, with the given defaults (the bench's shape)."""
    env = os.environ.get
    return int(env("BENCH_RES", res)), int(env("BENCH_GAUSSIANS", n_gauss)), int(env("BENCH_STEPS", steps))


@dataclasses.dataclass
class BenchStep:
    """The bench's train step as the reference's profiling scripts set it
    up: the bench scene sliced to its capacity bucket, the batch drawn with
    key 0 and its distinct views, the subset bucket and the entry budget
    that batch needs, its decoded frames and its frozen per-view bins and
    subsets, under `RasterConfig()`."""

    cfg: gm.MapConfig
    raster_cfg: RasterConfig
    state: gm.GaussianMapState
    capacity_bucket: int
    ids: torch.Tensor
    counts: torch.Tensor
    subset_bucket: int | None
    entry_budget: int
    batch: tuple
    bins: list
    subsets: list | None


def bench_step(res: int, n_gauss: int, steps: int, device) -> BenchStep:
    """The bench scene at (res, n_gauss) with `steps` optimization steps,
    and the train step of the batch drawn from seed 0 (the reference's
    scripts take PRNG key 0)."""
    rcfg = RasterConfig()
    cfg = gm.MapConfig(capacity=1 << 19, batch_size=bench.BATCH, optimization_steps=steps)
    state, buf = bench.build_scene(res, n_gauss, cfg, device=device)
    cap_b = gm.bucket_capacity(n_gauss, cfg.capacity)
    state = gm.slice_state(state, cap_b)
    ids, counts = trainer.draw_batch(buf, cfg, torch.Generator().manual_seed(0))
    max_iv, max_e = trainer.keyframe_view_stats(state, buf, ids, cfg, rcfg)
    sb = trainer.pick_subset_bucket(max_iv, cap_b)
    eb = trainer.pick_entry_bucket(max_e)
    batch = kf.decode_frames(buf, ids)
    bins, subsets = trainer.prepare_views(state, batch, cfg, rcfg, sb, eb)
    return BenchStep(cfg, rcfg, state, cap_b, ids, counts, sb, eb, batch, bins, subsets)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_ms(fn, device, n: int = 3) -> list[float]:
    """Host ms of `n` calls of `fn` after a warm-up call, each fenced by a
    synchronize."""
    fn()
    sync(device)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def device_busy(fn, device, trace: str | None = None) -> dict | None:
    """One call of `fn` (which the caller has warmed up) under
    torch.profiler with the CUDA activity, traced again while the trace
    records fewer device operations than the runtime calls launched (at
    most TRACES traces): the device's busy ms (the union of the recorded
    device operations' intervals), the device operations recorded, the
    runtime calls that launched one, the traces taken, and the device
    operations' self time by name, most first. `trace`: also write the
    Chrome trace to that file. None on the CPU, which has no device time."""
    if torch.device(device).type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for traces in range(1, TRACES + 1):
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PAD_S)
            fn()
            torch.cuda.synchronize(device)
            time.sleep(PAD_S)
        events = prof.events()
        ops = [e for e in events if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
        launched = sum(1 for e in events if e.device_type == DeviceType.CPU
                       and re.search(r"LaunchKernel|Memcpy|Memset", e.name))
        if len(ops) >= launched:
            break
    if trace:
        os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
        prof.export_chrome_trace(trace)
    busy, end = 0.0, -math.inf
    by_name: dict[str, float] = {}
    for e in sorted(ops, key=lambda e: e.time_range.start):
        s0, s1 = e.time_range.start, e.time_range.end
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
        by_name[e.name] = by_name.get(e.name, 0.0) + (s1 - s0) / 1e3
    return {"busy_ms": busy / 1e3, "device_ops": len(ops), "launched": launched, "traces": traces,
            "by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1]))}


def timed(fns: dict, device, n: int = 3, traces: dict | None = None) -> dict:
    """Each phase's figures, {name: call} -> {name: record}: host ms (median
    of `n`, and each), then device busy ms with the device operations
    recorded and launched (None on the CPU) and the idle share of the host
    time. Every host time is taken before the first trace: a process that
    has run a torch.profiler session may launch more slowly after it, as
    `profile_step`'s `full_step_after_traces_ms` shows. `traces`: {name:
    file} for the phases whose Chrome trace to write."""
    recs = {}
    for name, fn in fns.items():
        host = host_ms(fn, device, n)
        recs[name] = {"host_ms": statistics.median(host), "host_ms_runs": host, "device_busy_ms": None,
                      "idle_share": None}
    for name, fn in fns.items():
        dev = device_busy(fn, device, (traces or {}).get(name))
        if dev is not None:
            rec = recs[name]
            rec.update(device_busy_ms=dev["busy_ms"], idle_share=1.0 - dev["busy_ms"] / rec["host_ms"],
                       device_ops=dev["device_ops"], launched=dev["launched"], traces=dev["traces"],
                       by_name=dev["by_name"])
    return recs


def fmt_device(rec: dict) -> str:
    """A phase's device figures for a printed line."""
    if rec["device_busy_ms"] is None:
        return "device busy not measured (CPU run)"
    return (f"device busy {rec['device_busy_ms']:.3f} ms ({rec['device_ops']} of {rec['launched']} launched device "
            f"operations recorded, trace {rec['traces']}), idle share {rec['idle_share']:.4f}")


def event_timing(device, n: int) -> str:
    """What an event-timed script's times are, for its JSON line."""
    return f"CUDA events, median of {n}" if device.type == "cuda" else f"host clock (CPU), median of {n}"


def card() -> str | None:
    """The card's name, or None on a machine without one."""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else None


def emit(line: dict) -> dict:
    """Prints the script's closing JSON line on stdout; returns it."""
    print(json.dumps(line, default=float), flush=True)
    return line
