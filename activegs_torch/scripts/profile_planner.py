"""Where a plan step's candidate scoring spends its time, at the bench's map
shape (port of `scripts/profile_planner.py`).

    python -m activegs_torch.scripts.profile_planner [cands=100] [runs=3]
    BENCH_RES=32 BENCH_GAUSSIANS=512 python -m activegs_torch.scripts.profile_planner device=cpu cands=4

The bench scene (BENCH_GAUSSIANS surfels, frames of BENCH_RES^2) in its
capacity bucket, a fresh voxel map over the 6 x 5 x 3 m room, and `cands`
candidate poses from `np.random.default_rng(0)` (identity rotations,
positions uniform in [1, 4] x [1, 4] x [0.5, 2] m, keyframe 0's
intrinsics), each rendered at BENCH_RES / 4 square (128x128 at the bench's
512, the planner's render ratio) with the utility raster config (max_dup
2, entry_budget_mult 1.0), as the reference times them:

- `utility_batch`: `confidence._confidence_utility_batch` over every
  candidate, the map whole, at the default entry budget;
- `utility_batch_compacted`: the same with the entry budget and the subset
  bucket that `_candidate_entry_stats` measures over the candidates (what
  `candidate_utilities` runs; printed first);
- `render_only`: the candidates' renders alone (`render_views_batched` in
  the groups the utility batch renders, no utility math);
- `render_compacted`: each candidate compacted to its in-view gaussians in
  a bucket of 65536 (at most the capacity bucket), then rendered;

and two more of the plan step's host steps: `entry_stats`
(`_candidate_entry_stats`, which the wired path runs first: a preprocess
and a span count a candidate, each read back) and `preprocess` (the
candidates' preprocess alone).

Each gets host ms (median of `runs` after a warm-up, each fenced by a
synchronize; all before the first trace), device busy ms from
torch.profiler (`profiling.device_busy`), the idle share of its host
time, and ms a candidate. Runs on the card unless given `device=cpu`
(device figures "not measured"). Ends with one JSON line: the compacted utility batch's
host ms (`value`) and every timing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mapping import gaussians as gm
from ..mapping import voxel_map as vm
from ..mapping.trainer import pick_entry_bucket, pick_subset_bucket
from ..planning import confidence as cf
from ..render import preprocess as rp
from ..render.renderer import compact_in_view, pack_attrs, render_views_batched, subset_view
from ..render.types import Camera, RasterConfig
from . import bench, profiling

UTILITY_RASTER = RasterConfig(max_dup=2, entry_budget_mult=1.0)
COMPACT_BUCKET = 65536
ROOM = ((0.0, 0.0, 0.0), (6.0, 5.0, 3.0))


def candidates(n: int, device) -> torch.Tensor:
    """The reference's candidate poses: identity rotations at positions
    uniform in [1, 4]^3 scaled by (1, 1, 0.5)."""
    rng = np.random.default_rng(0)
    cands = np.tile(np.eye(4, dtype=np.float32)[None], (n, 1, 1))
    cands[:, :3, 3] = rng.uniform(1, 4, (n, 3)) * np.array([1, 1, 0.5])
    return torch.from_numpy(cands).to(device)


def timings(res: int, n_gauss: int, n_cand: int, device) -> tuple[dict, dict]:
    """({timing: call}, what was measured first: the entry and in-view
    maxima, the budget and bucket they pick, the shape)."""
    cfg, rcfg = gm.MapConfig(capacity=1 << 19), UTILITY_RASTER
    state, buf = bench.build_scene(res, n_gauss, cfg, device=device)
    cap_b = gm.bucket_capacity(n_gauss, cfg.capacity)
    state = gm.slice_state(state, cap_b)
    grid = vm.VoxelGrid.create(ROOM, vm.VoxelConfig())
    vstate = vm.init_state(grid, device)
    shape = (res // 4, res // 4)
    cands = candidates(n_cand, device)
    intr = buf.intrinsics[0]
    valid = torch.ones((n_cand, *shape), dtype=torch.bool, device=device)
    depth_range = torch.tensor([0.0, 5.0], device=device)
    max_ents, max_iv = cf._candidate_entry_stats(state, cands, intr, shape, cfg, rcfg)
    eb, sb = pick_entry_bucket(max_ents), pick_subset_bucket(max_iv, cap_b)
    measured = {"max_entries": max_ents, "entry_budget": eb, "max_in_view": max_iv, "subset_bucket": sb,
                "shape": list(shape), "candidates": n_cand}
    attrs = gm.attrs_of(state, cfg)
    cams = [Camera(extrinsic=ext, intrinsic=intr) for ext in cands]
    bucket = min(COMPACT_BUCKET, cap_b)

    def utility(**kw):
        return cf._confidence_utility_batch(state, vstate.unexplored, cands, intr, valid, depth_range, grid, shape,
                                            cfg, rcfg, **kw)

    def render(views):
        groups = cf.utility_groups(n_cand, attrs.num, shape, rcfg, None, None)
        return sum(float(render_views_batched([views[i] for i in g], [cams[i] for i in g], shape, rcfg)[0].rgb.sum())
                   for g in groups)

    @torch.no_grad()
    def render_only():
        return render([attrs] * n_cand)

    @torch.no_grad()
    def render_compacted():
        packed = pack_attrs(attrs)
        views = []
        for cam in cams:
            _, _, _, iv = rp.preprocess(attrs, cam, shape, rcfg)
            views.append(subset_view(packed, compact_in_view(iv, bucket)[:3]))
        return render(views)

    @torch.no_grad()
    def preprocess():
        return [rp.preprocess(attrs, cam, shape, rcfg)[3] for cam in cams]

    return {
        "utility_batch": utility,
        "utility_batch_compacted": lambda: utility(entry_budget=eb, subset_bucket=sb),
        "render_only": render_only,
        "render_compacted": render_compacted,
        "entry_stats": lambda: cf._candidate_entry_stats(state, cands, intr, shape, cfg, rcfg),
        "preprocess": preprocess,
    }, measured


LABELS = {"utility_batch": "utility batch", "utility_batch_compacted": "utility batch compacted",
          "render_only": "render-only", "render_compacted": "render compacted(64k)",
          "entry_stats": "candidate entry stats", "preprocess": "preprocess alone"}


def main(argv: list[str] | None = None) -> dict:
    args, _, device = profiling.parse(argv)
    res, n_gauss, _ = profiling.bench_shape()
    n_cand, runs = int(args.get("cands", 100)), int(args.get("runs", 3))
    fns, measured = timings(res, n_gauss, n_cand, device)
    print(f"measured: entries {measured['max_entries']} -> budget {measured['entry_budget']}; in-view "
          f"{measured['max_in_view']} -> subset {measured['subset_bucket']}")
    recs = profiling.timed(fns, device, runs)
    for name, rec in recs.items():
        rec.pop("by_name", None)
        rec["host_ms_per_candidate"] = rec["host_ms"] / n_cand
        print(f"{LABELS[name] + ':':25s}{rec['host_ms']:9.1f} ms  ({rec['host_ms_per_candidate']:6.2f} ms/cand; "
              f"{n_cand} candidates at {measured['shape'][0]}x{measured['shape'][1]}); {profiling.fmt_device(rec)}")
    return profiling.emit({
        "metric": "planner_utility_batch_host_ms",
        "value": recs["utility_batch_compacted"]["host_ms"],
        "unit": "ms/plan step",
        "timings": recs,
        **measured,
        "res": res, "gaussians": n_gauss,
        "device": profiling.card() if device.type == "cuda" else "cpu",
    })


if __name__ == "__main__":
    main()
