"""Runs one cell of the benchmark of `activegs_torch` once and prints its
result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics (`metrics/<name>.py`), after a profiled lap. Both
compare what the window's sampled step produced with the plain reference
(`reference/`) and print each compared number beside its limit. The cell's
configuration, traffic mix and limits are the files that `BENCHMARK.json`
names; see README.md.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "activegs_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was loaded."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_LOADED


_T_LOADED = time.perf_counter()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool, device=None, overrides: dict | None = None,
        spec: dict | None = None) -> dict:
    """One run of cell `workload`: set-up, the window, the traced lap (with
    `trace`), then the comparison. Returns the result line's object. A
    `device` other than the card and `overrides` of configuration keys
    serve the tests and the control."""
    import torch

    from harness import cells, check, roofline
    from harness import trace as tr_mod
    from harness.probe import Launches

    cell = cells.find(workload, spec)
    overrides = dict(overrides or {})
    for key in [k for k in overrides if k.startswith("traffic.")]:
        cell.traffic[key.split(".", 1)[1]] = overrides.pop(key)
    for key, val in overrides.items():
        node = cell.config["config"]
        for part in key.split(".")[:-1]:
            node = node.setdefault(part, {})
        node[key.split(".")[-1]] = val
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"cell {workload} needs {cell.chips} cards, found {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    seed = int(seed) % (1 << 63)

    system = cells.generator(cell).System(cell, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = process_age_s()
    phases = {"setup": setup_s}
    t = time.perf_counter()
    win = system.window(seconds)
    phases["window"] = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx = {"cell": workload, "window": win, "trace": None, "work": None}
    metrics = {}
    breakdown = None
    device_rec = {"platform": "gpu" if cuda else device.type,
                  "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                  "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        launches = Launches()
        launches.on = True
        t = time.perf_counter()
        if cuda:
            tr = tr_mod.session(system.traced, device)
        else:  # the tests' CPU runs: no device trace
            t0 = time.time_ns()
            tr = {"spans": system.traced(), "ops": [], "t0": t0, "t1": time.time_ns(), "busy_s": None,
                  "window_s": None, "launched": 0}
        launches.on = False
        launches.close()
        phases["trace"] = time.perf_counter() - t
        t = time.perf_counter()
        ctx["trace"] = tr
        ctx["work"] = {"fwd": [roofline.live_pairs(*f) for f in launches.fwd],
                       "bwd": launches.bwd, "tile_pixels": [f[4].tile_pixels for f in launches.fwd],
                       "units": system.traced_units}
        launches.fwd.clear()
        phases["roofline_count"] = time.perf_counter() - t
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if cuda:
            device_rec.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
            breakdown = tr_mod.breakdown(tr)
            print(f"trace: {len(tr['ops'])} device operations recorded, {tr['launched']} launched", file=sys.stderr)
    else:
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else win["e2e"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    rec = system.capture.rec
    config = cell.config
    system_unit = system.unit
    system.close()
    del system, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    info: list[str] = []
    t = time.perf_counter()
    nums = check.numbers(rec, config, info)
    del rec
    phases["reference"] = time.perf_counter() - t
    print("phase seconds: " + json.dumps(phases), file=sys.stderr)
    correct, table = check.judge(nums, cell.limits)
    for line in info:
        print(line, file=sys.stderr)
    print("readings: " + json.dumps(nums), file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or of the JAX package loaded: {found}")
    out = {"correct": bool(correct), "attempted": win["units"], "failed": win["failed"], "metrics": metrics,
           "device": device_rec}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["window"] = {"seconds": win["wall_s"], system_unit: win["units"]}
    out["readings"] = nums
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in table.items()}
    for k, (v, lim) in table.items():
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
