"""`train_keyframe` at the bench's shape with an 8-slot and a 256-slot
keyframe buffer (port of `scripts/profile_mission_train.py`).

    python -m activegs_torch.scripts.profile_mission_train
    BENCH_RES=32 BENCH_GAUSSIANS=512 BENCH_STEPS=1 python -m activegs_torch.scripts.profile_mission_train device=cpu

The reference asked whether the mission's keyframe buffer (256 slots, a
loop-carried state of about 1.1 GB at 512x512 there) made the mission's
training slower than the bench's at the same render shapes; the port's
buffer keeps colour as uint8 and depth as float16, 335 MB at 256 slots.
Here the bench scene's 8 frames go into a buffer of 8 slots (the bench's)
and into one of 256 slots (the mission's `keyframe_capacity`), and each
trains a keyframe of
BENCH_STEPS steps on the batch drawn with key 0, with the subset bucket
and entry budget measured over that batch: a warm-up (key 9), then three
timed runs (keys 0, 1, 2; host clock, each fenced by a synchronize), the
fastest counts. Each run starts from the scene's sampler performance.
Runs on the card unless given `device=cpu`. Prints the reference's lines
and ends with one JSON line: the 256-slot time over the 8-slot one
(`value`) and both.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..mapping import gaussians as gm
from ..mapping import keyframes as kf
from ..mapping import trainer
from ..render.types import RasterConfig
from . import bench, profiling

MISSION_SLOTS = 256
WARM_KEY = 9
TIMED_KEYS = (0, 1, 2)


def widen(buf: kf.KeyframeBuffer, slots: int) -> kf.KeyframeBuffer:
    """`buf`'s frames in a buffer of `slots` slots, in the same ranks."""
    big = kf.init_buffer(slots, *buf.rgb.shape[-2:], device=buf.rgb.device)
    n = buf.count
    slot = buf.order[:n]
    big.rgb[:n], big.depth[:n] = buf.rgb[slot], buf.depth[slot]
    for f in ("extrinsics", "intrinsics", "performance"):
        getattr(big, f)[:n] = getattr(buf, f)[:n]
    big.count = n
    return big


def train_ms(state, buf, cfg: gm.MapConfig, rcfg: RasterConfig, steps: int, device) -> dict:
    ids, _ = trainer.draw_batch(buf, cfg, torch.Generator().manual_seed(0))
    max_iv, max_e = trainer.keyframe_view_stats(state, buf, ids, cfg, rcfg)
    sb = trainer.pick_subset_bucket(max_iv, state.capacity)
    eb = trainer.pick_entry_bucket(max_e)

    def run(key):
        b = dataclasses.replace(buf, performance=buf.performance.clone())
        views = trainer.draw_batch(b, cfg, torch.Generator().manual_seed(key))
        t0 = time.perf_counter()
        trainer.train_keyframe(state, b, views, cfg, rcfg, steps=steps, subset_bucket=sb, entry_budget=eb)
        profiling.sync(device)
        return (time.perf_counter() - t0) * 1e3

    run(WARM_KEY)
    times = [run(k) for k in TIMED_KEYS]
    return {"subset_bucket": sb, "entry_budget": eb, "train_ms": min(times), "runs_ms": times,
            "buffer_bytes": buf.rgb.numel() + 2 * buf.depth.numel()}


def main(argv: list[str] | None = None) -> dict:
    _, _, device = profiling.parse(argv)
    res, n_gauss, steps = profiling.bench_shape()
    cfg, rcfg = gm.MapConfig(capacity=1 << 19, batch_size=bench.BATCH, optimization_steps=steps), RasterConfig()
    state, buf8 = bench.build_scene(res, n_gauss, cfg, device=device)
    state = gm.slice_state(state, gm.bucket_capacity(n_gauss, cfg.capacity))
    recs = {}
    for name, buf in ((f"kf_cap={buf8.capacity}", buf8), (f"kf_cap={MISSION_SLOTS}", widen(buf8, MISSION_SLOTS))):
        recs[name] = rec = train_ms(state, buf, cfg, rcfg, steps, device)
        print(f"{name}: subset={rec['subset_bucket']} entries={rec['entry_budget']} train={rec['train_ms']:.0f} ms "
              f"(runs " + " ".join(f"{t:.1f}" for t in rec["runs_ms"]) + f"; buffer {rec['buffer_bytes'] / 1e6:.1f} MB)")
    small, big = recs[f"kf_cap={buf8.capacity}"], recs[f"kf_cap={MISSION_SLOTS}"]
    return profiling.emit({
        "metric": "train_keyframe_ms_ratio_256_to_8_slots",
        "value": big["train_ms"] / small["train_ms"],
        "unit": "ratio",
        "buffers": recs,
        "steps": steps, "res": res, "gaussians": n_gauss,
        "device": profiling.card() if device.type == "cuda" else "cpu",
    })


if __name__ == "__main__":
    main()
