"""Mission benchmark of the port: steady-state seconds per keyframe (port of
`scripts/bench_mission.py`).

    python -m activegs_torch.scripts.bench_mission [steps=30] [prewarm=1] [out=experiments/...]
    python -m activegs_torch.scripts.bench_mission device=cpu "simulator.sensor.resolution=[64,64]" \
        mapper.gaussian_map.capacity=4096 planner.sample_num=8 steps=5 prewarm=0

The train-step bench (`bench.py`) times one keyframe's training; this runs a
whole mission on the default config (synthetic boxroom, confidence
planner, 512x512, capacity 2^19, the shapes of `apps.main`) and reports
the per-keyframe cost at steady state: the steps from frame STEADY_FROM on
(earlier steps climb the capacity-bucket ladder). `prewarm=1` (default)
first flies a throwaway, unrecorded mission of max(steps, 20) steps in the
same process, so that the kernel builds, the A* build, the CUDA context
and the allocator's growth land before the measured steps. The report
carries medians and percentiles beside the mean, and the spike steps
(above twice the median: prune keyframes, new buckets), so that the
headline tracks the typical keyframe. `out=<dir>` records the measured
mission there (budget and snapshot interval unbounded) and saves its final
map. Other `key=value` arguments go to the config loader (`device=cpu`
runs on the CPU).

`IncrementalMapper.step` returns every key the aggregation reads
(`frame_id`, `t_mapping`, `phase_times` with spawn, view_stats, train,
post and voxel, `plan_times` with masks, roi_rand, utility, astar and the
`utility_stats` / `utility_batch` sub-phases, `n_gaussians`,
`capacity_bucket`, `num_dropped`), under the reference's names; none
differs. Prints ONE JSON line on stdout, the steps on stderr.
"""

from __future__ import annotations

import gc
import json
import sys

import numpy as np
import torch

from ..apps.common import build_mission, mission_device
from ..config.loader import load_config
from ..io.recorder import MissionRecorder

STEADY_FROM = 4  # 1-based frame id; earlier steps climb the bucket ladder


def _planning(stats: dict) -> float:
    """A step's planning seconds: its plan phases without the `utility_*`
    sub-phases, which `utility` already holds."""
    return sum(v for k, v in stats["plan_times"].items() if not k.startswith("utility_"))


def summarize(all_stats: list[dict], steady_from: int = STEADY_FROM) -> dict:
    """The benchmark's figures from the mission's step stats, in the
    reference's keys and formulas: the steady steps' (frame_id >=
    `steady_from`) mapping-time median as `value`, its mean and p10 / p90
    (rounded to ms), the spike steps (mapping time above twice the median),
    each mapping phase's mean and median, the planning time's mean and
    median and each plan phase's mean, and the last step's map size,
    capacity bucket and dropped entries."""
    steady = [s for s in all_stats if s["frame_id"] >= steady_from]
    mean = lambda xs: float(np.mean(xs)) if xs else None  # noqa: E731
    med = lambda xs: float(np.median(xs)) if xs else None  # noqa: E731
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else None  # noqa: E731
    rnd = lambda x: None if x is None else round(x, 3)  # noqa: E731
    phases = sorted({k for s in steady for k in s["phase_times"]})
    plan_phases = sorted({k for s in steady for k in s["plan_times"]})
    t_map = [s["t_mapping"] for s in steady]
    planning = [_planning(s) for s in steady]
    return {
        "metric": "mission_s_per_keyframe",
        "value": med(t_map),
        "unit": "s/keyframe (mapping, steady-state median)",
        "mean": rnd(mean(t_map)),
        "p10": rnd(pct(t_map, 10)),
        "p90": rnd(pct(t_map, 90)),
        "spike_steps": [s["frame_id"] for s in steady if s["t_mapping"] > 2.0 * med(t_map)],
        "steady_steps": [s["frame_id"] for s in steady],
        "phase_s": {k: rnd(mean([s["phase_times"].get(k, 0.0) for s in steady])) for k in phases},
        "phase_s_median": {k: rnd(med([s["phase_times"].get(k, 0.0) for s in steady])) for k in phases},
        "planning_s": round(mean(planning) or 0.0, 3),
        "planning_s_median": round(med(planning) or 0.0, 3),
        "plan_phase_s": {k: rnd(mean([s["plan_times"].get(k, 0.0) for s in steady])) for k in plan_phases},
        "n_gaussians_final": all_stats[-1]["n_gaussians"],
        "capacity_bucket_final": all_stats[-1]["capacity_bucket"],
        "num_dropped_final": all_stats[-1]["num_dropped"],
    }


def main(argv: list[str] | None = None) -> dict:
    """Fly and measure the mission that the `key=value` arguments (default:
    the command line) configure. Returns the printed result."""
    argd = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    steps = int(argd.pop("steps", 30))
    out = argd.pop("out", None)
    prewarm = int(argd.pop("prewarm", 1))
    overrides = [f"{k}={v}" for k, v in argd.items()]
    cfg = load_config("main", overrides)
    device = mission_device(cfg)

    if prewarm:
        # a throwaway mission pays every first use (builds, context, the
        # allocator up the bucket ladder) before the measured one
        print(f" prewarm mission ({max(steps, 20)} steps)...", file=sys.stderr)
        wmapper, _, _, _ = build_mission(load_config("main", overrides), device)
        wmapper.init_map()
        for _ in range(max(steps, 20)):
            wmapper.step()
        del wmapper
        gc.collect()

    mapper, simulator, _, comp = build_mission(cfg, device)
    if out:
        mapper.load_recorder(MissionRecorder(out, budget=1e9, record_interval=1e9))
    mapper.init_map()
    all_stats = []
    for _ in range(steps):
        s = mapper.step()
        print(
            f" step {s['frame_id']}: mapping {s['t_mapping']:.2f}s "
            f"({' '.join(f'{k}={v:.2f}' for k, v in s['phase_times'].items())}) "
            f"plan({' '.join(f'{k}={v:.3f}' for k, v in s['plan_times'].items())}) "
            f"n={s['n_gaussians']}",
            file=sys.stderr,
        )
        all_stats.append(s)

    result = summarize(all_stats)
    result["prewarmed"] = bool(prewarm)
    result["config"] = {
        "planner": cfg.planner.planner_name,
        "scene": cfg.scene.scene_name,
        "resolution": [int(x) for x in getattr(simulator, "resolution", ())],
        "capacity": comp["map_cfg"].capacity,
        "optimization_steps": comp["map_cfg"].optimization_steps,
        "device": str(device),
        "card": torch.cuda.get_device_name(device) if device.type == "cuda" else None,
    }
    print(json.dumps(result, default=lambda o: o.item()))
    if out:
        mapper.recorder.save_map(mapper.gm_state, mapper.map_cfg, "final")
        mapper.recorder.save_path()
    return result


if __name__ == "__main__":
    main()
