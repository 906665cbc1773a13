"""Scan the rasterizer's tile / chunk / max_dup configs on the bench's
training workload (port of `scripts/tile_scan.py`).

    python -m activegs_torch.scripts.tile_scan
    python -m activegs_torch.scripts.tile_scan '[[32,32,128,4],[16,16,128,8]]'   # [tile_h, tile_w, chunk, max_dup]
    BENCH_RES=32 BENCH_GAUSSIANS=512 BENCH_STEPS=1 python -m activegs_torch.scripts.tile_scan device=cpu

Times `trainer.train_keyframe` (the bench's hot path: BENCH_STEPS steps x
8 views at BENCH_RES^2, BENCH_GAUSSIANS surfels of the bench scene in its
capacity bucket, the subset bucket that `keyframe_view_stats` measures
over the batch drawn with key 0) for each `RasterConfig` and prints one
JSON row a config: `tile`, `chunk`, `max_dup`, `subset_bucket`,
`rays_per_s` (steps x 8 x res^2 over the fastest of 3 timed runs, keys 0,
1, 2), `ms_per_step`, `num_dropped` and `loss` (of key 2's run),
`runs_s` (the timed runs' seconds, taken in the configs' turns: `scan`)
and `build_s`, the first run's seconds (key 99), where the reference had
`compile_s`: here it pays the kernels' build on a fresh checkout and the
allocator's growth. As in the reference no entry budget is passed, so
each view bins at its default.
The defaults are the reference's four configs: 32x32, 16x32, 16x16 and
8x16 tiles.

A config whose tile the kernels do not take (`composite.check_tile`: more
than 1024 pixels, not a multiple of 32, or one the forward kernel cannot
split) prints an `error` row; any other exception propagates. Runs on the
card unless given `device=cpu`. Ends with one JSON line: the fastest
config's rays/s (`value`), its tile, and the rows.
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from ..mapping import gaussians as gm
from ..mapping import trainer
from ..mapping.mapper import _sync
from ..render import composite as cp
from ..render.types import RasterConfig
from . import bench, profiling

DEFAULT_CONFIGS = [[32, 32, 128, 4], [16, 32, 128, 8], [16, 16, 128, 8], [8, 16, 128, 16]]
WARM_KEY = 99
TIMED_KEYS = (0, 1, 2)


def config_runner(state, buf, cfg: gm.MapConfig, cap_b: int, steps: int, rcfg: RasterConfig, device):
    """(the config's subset bucket, run(key) -> (seconds, loss, aux) of one
    `train_keyframe` on the batch drawn with `key`)."""
    ids, _ = trainer.draw_batch(buf, cfg, torch.Generator().manual_seed(0))
    max_iv, _ = trainer.keyframe_view_stats(state, buf, ids, cfg, rcfg)
    sb = trainer.pick_subset_bucket(max_iv, cap_b)

    def run(key):
        # train_keyframe updates the sampler's performance in place: every
        # run starts from the scene's, as the reference's functional runs do
        b = dataclasses.replace(buf, performance=buf.performance.clone())
        views = trainer.draw_batch(b, cfg, torch.Generator().manual_seed(key))
        t0 = time.perf_counter()
        _, _, loss, aux = trainer.train_keyframe(state, b, views, cfg, rcfg, steps=steps, subset_bucket=sb)
        _sync(device)
        return time.perf_counter() - t0, loss, aux

    return sb, run


def scan(configs, res: int, n_gauss: int, steps: int, device) -> list[dict]:
    """Prints and returns one row a config, [tile_h, tile_w, chunk, max_dup].
    Each config first runs once (its `build_s`); the timed runs then go in
    turns, config after config, one key a round, the order reversed every
    other round, so that a drift of the host's speed falls on every config
    alike. A row keeps its timed runs' seconds (`runs_s`)."""
    cfg = gm.MapConfig(capacity=1 << 19, batch_size=bench.BATCH, optimization_steps=steps)
    state, buf = bench.build_scene(res, n_gauss, cfg, device=device)
    cap_b = gm.bucket_capacity(n_gauss, cfg.capacity)
    state = gm.slice_state(state, cap_b)
    rows, runners, builds = [], {}, {}
    for i, (th, tw, chunk, max_dup) in enumerate(configs):
        rcfg = RasterConfig(tile_h=th, tile_w=tw, chunk=chunk, max_dup=max_dup)
        row = {"tile": [th, tw], "chunk": chunk, "max_dup": max_dup}
        try:
            cp.check_tile(rcfg)
        except ValueError as e:  # a tile the kernels do not take
            row["error"] = repr(e)[:200]
        else:
            row["subset_bucket"], runners[i] = config_runner(state, buf, cfg, cap_b, steps, rcfg, device)
            builds[i] = runners[i](WARM_KEY)[0]
        rows.append(row)
    runs = {i: [] for i in runners}
    for r, key in enumerate(TIMED_KEYS):
        for i in (list(runners) if r % 2 == 0 else list(runners)[::-1]):
            runs[i].append(runners[i](key))
    rays = steps * bench.BATCH * res * res
    for i, row in enumerate(rows):
        if i in runs:
            t = min(run[0] for run in runs[i])
            _, loss, aux = runs[i][-1]  # the last key's, as the reference reports
            row.update(rays_per_s=rays / t, ms_per_step=1e3 * t / steps, num_dropped=int(aux["num_dropped"]),
                       loss=float(loss), runs_s=[run[0] for run in runs[i]], build_s=builds[i])
        print(json.dumps(row), flush=True)
    return rows


def main(argv: list[str] | None = None) -> dict:
    """The scan of the configs given as the first argument (a JSON list),
    or the reference's four, on the device of `device=`. Returns the
    closing line."""
    _, positional, device = profiling.parse(argv)
    configs = json.loads(positional[0]) if positional else DEFAULT_CONFIGS
    res, n_gauss, steps = profiling.bench_shape()
    rows = scan(configs, res, n_gauss, steps, device)
    ok = [r for r in rows if "error" not in r]
    best = max(ok, key=lambda r: r["rays_per_s"]) if ok else None
    return profiling.emit({
        "metric": "tile_scan_best_rays_per_s",
        "value": best["rays_per_s"] if best else None,
        "unit": "rays/s",
        "best_tile": best["tile"] if best else None,
        "configs": len(rows),
        "errors": len(rows) - len(ok),
        "res": res, "gaussians": n_gauss, "steps": steps,
        "device": profiling.card() if device.type == "cuda" else "cpu",
        "rows": rows,
    })


if __name__ == "__main__":
    main()
