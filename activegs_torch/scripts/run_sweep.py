"""The planner-comparison sweep of the port, in one process: scenes x
planners x seeds -> mission -> mesh -> evaluation -> plots -> one summary
(port of `scripts/run_sweep.py`).

    python -m activegs_torch.scripts.run_sweep exp_id=sweep budget=120 record_interval=40 runs=3 \
        scenes=synthetic/tworoom planners=confidence,confidence_wo_roi,exploration,random \
        num_test_views=96 mesh_resolution=512

The experiment that defines the system: at an equal mission budget, the
confidence planner should map better than exploration alone and than
random views, in rendering and in mesh quality. Each run flies a recorded
mission (`build_mission`, `MissionRecorder`: the mission clock bills the
measured mapping and planning seconds plus the modelled flight), meshes
every snapshot (`generate_mesh` at `mesh_resolution`^2 along the recorded
cameras) and scores it (`EvaluationTool(...).eval(mode="complete")` at the
test poses, which `sample_test_views_from_sim(sim, num_test_views, seed=0)`
draws once per scene and every planner and seed shares), then writes the
run's `final_result.json`. Run r flies with `seed=r` and
`experiment.run_id=r`.

One process on purpose: the recorder charges measured seconds to the
mission budget, so every first use (the nvcc builds of the compositor
kernels, in f32 and, when configured, bf16; the g++ build of A*; the CUDA
context; the allocator's growth) must land before the first recorded
mission. A throwaway unrecorded warm-up mission of `warmup_steps` steps
(default 20; 0 skips it) on the first scene with the first run's
overrides pays them; each run prints its first step's mapping time
against the median of the rest, which shows it. Each run's mapper, maps
and caches are freed before the next, so the caching allocator's
footprint stays flat over the runs (each run prints it).

Each run also writes `run_info.json`: the package digest (`package_digest`,
taken when the invocation starts), the protocol (budget, snapshot
interval, seeds, test views, mesh resolution, warm-up steps, config
overrides, device and card), the invocation that flew it (an id and its
warm-up seconds) and the mission's record (steps, first and median
mapping seconds, seconds, allocator reserve).

The whole protocol may not fit one invocation (a time limit on one
command): `run_ids=0,1` flies only those of the `runs` seeds, and
`merge=1` builds the summary from every run's `final_result.json` under
`experiments/<exp_id>/` (`summarize`), this invocation's and earlier
ones', so the protocol can be spread over several invocations, one
planner or a few seeds each. `merge=1` refuses a run whose `run_info.json`
is missing or names another package digest or protocol than this
invocation's. The summary counts the invocations its runs came from
(`invocations`) and their seconds (`wall_clock_s`: the runs' and each
invocation's warm-up). `max_steps=N` ends each recorded mission after N
steps if its budget has not ended it first. Other `key=value` arguments go
to the config loader for every mission (`device=cpu` runs on the CPU,
`simulator.sensor.resolution=[64,64]` shrinks the frames).

Artifacts: `experiments/<exp_id>/<scene>/<planner>/<run>/`
(`exp_config.yaml`, `step_stats.jsonl`, map snapshots, meshes,
`final_result.json`, `run_info.json`), per-scene plots (where matplotlib
is installed) and `experiments/<exp_id>/summary.json`.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import subprocess
import sys
import time
import uuid
from pathlib import Path

import numpy as np
import torch

from ..apps.common import build_mission, dump_config, experiment_path, mission_device
from ..apps.data_generation import sample_test_views_from_sim
from ..apps.eval_app import load_snapshots
from ..config.loader import load_config
from ..eval.evaluation import EvaluationTool, generate_mesh
from ..io import ply
from ..io.recorder import MissionRecorder
from ..sim import get_simulator

# the final-snapshot scores the summary aggregates
FINAL_METRICS = (
    "mean_psnr",
    "mean_ssim",
    "mean_depth_mse",
    "mean_perceptual",
    "mesh_accuracy",
    "mesh_completion",
    "mesh_completion_ratio",
)


class _CachedGT:
    """A simulator whose `simulate` renders each pose once: the evaluation's
    ground-truth frames render once per scene, not once per (run, pose)."""

    def __init__(self, simulator):
        self.simulator = simulator
        self._cache = {}

    def __getattr__(self, name):
        return getattr(self.simulator, name)

    def simulate(self, pose, require_gt=False, **kw):
        key = np.asarray(pose, np.float32).tobytes()
        if key not in self._cache:
            self._cache[key] = self.simulator.simulate(pose, require_gt=require_gt, **kw)
        return self._cache[key]


def run_one_mission(cfg, device, budget, record_interval, recorded=True):
    """Fly one mission of `cfg`. Recorded: into its experiment directory
    under the budget (and `max_steps` of `cfg`, where set), returning
    (path, typed configs, step stats); else (the warm-up) `budget` steps
    with no recorder, returning (None, typed configs, None)."""
    mapper, _, _, comp = build_mission(cfg, device)
    if not recorded:
        mapper.run(max_steps=int(budget))
        return None, comp, None
    path = experiment_path(cfg)
    dump_config(cfg, path)
    mapper.load_recorder(MissionRecorder(path, budget=budget, record_interval=record_interval))
    mapper.run(max_steps=cfg.get("max_steps", None))
    with open(os.path.join(path, "step_stats.jsonl")) as f:
        steps = [json.loads(line) for line in f if line.strip()]
    return path, comp, steps


def mesh_and_eval(exp_path, comp, gt, test_poses, mesh_resolution, device):
    """`mesh_app` and `eval_app` in process: a mesh of every snapshot
    (saved beside it), then every snapshot and mesh scored; writes and
    returns the run's `final_result.json`, or None without snapshots."""
    snap = load_snapshots(exp_path, device)
    if snap is None:
        return None
    ids, times, lengths, maps, _ = snap
    meshes = []
    for i, (state, mcfg) in zip(ids, maps):
        with open(os.path.join(exp_path, "map", f"cameras_{i}.json")) as f:
            cams = [(np.asarray(r[:16], np.float32).reshape(4, 4), np.asarray(r[16:], np.float32).reshape(3, 3))
                    for r in json.load(f)]
        verts, faces, colors = generate_mesh(
            state, mcfg, cams, resolution=mesh_resolution, raster_cfg=comp["raster_cfg"],
            bbox=getattr(gt, "bbox", None),
        )
        ply.save_ply(os.path.join(exp_path, "map", f"mesh_{i}.ply"), verts, faces, colors)
        meshes.append((verts, faces))
    tool = EvaluationTool(
        maps=maps,
        meshes=meshes,
        test_poses=test_poses,
        gt_provider=gt,
        mesh_gt=(np.asarray(gt.mesh_vertices), np.asarray(gt.mesh_faces)),
        raster_cfg=comp["raster_cfg"],
    )
    result = tool.eval(mode="complete")
    result["step"] = ids
    result["time"] = times
    result["path_length"] = lengths
    with open(os.path.join(exp_path, "final_result.json"), "w") as f:
        json.dump(result, f, indent=4)
    return result


def summarize(per_run: dict) -> dict:
    """{scene: {planner: {"final": {metric: {mean, std, runs}}, "n_runs"}}}
    from {scene: {planner: [final_result dicts]}}: each metric's last
    snapshot over the runs (runs without it skipped), as the reference
    aggregates them."""
    scenes = {}
    for scene, planners in per_run.items():
        scenes[scene] = {}
        for planner, results in planners.items():
            finals = {k: [r[k][-1] for r in results if r and r.get(k)] for k in FINAL_METRICS}
            scenes[scene][planner] = {
                "final": {
                    k: {
                        "mean": float(np.mean([v for v in vs if v is not None])),
                        "std": float(np.std([v for v in vs if v is not None])),
                        "runs": vs,
                    }
                    for k, vs in finals.items()
                    if vs and any(v is not None for v in vs)
                },
                "n_runs": len(results),
            }
    return scenes


def runs_on_disk(root: str, runs: int, digest: str, protocol: dict) -> list:
    """[(final_result, run_info)] of every run 0..runs-1 under `root` (the
    sweep's directory) that has a `final_result.json`, in (scene, planner,
    run) order. Raises ValueError for a run whose `run_info.json` is
    missing or names another package digest or protocol."""
    out = []
    for scene in sorted(os.listdir(root)):
        planners = sorted(os.listdir(os.path.join(root, scene))) if os.path.isdir(os.path.join(root, scene)) else []
        for planner in planners:
            for run in range(runs):
                d = os.path.join(root, scene, planner, str(run))
                if not os.path.exists(os.path.join(d, "final_result.json")):
                    continue
                if not os.path.exists(os.path.join(d, "run_info.json")):
                    raise ValueError(f"merge: {d} has no run_info.json, so nothing says what it ran")
                with open(os.path.join(d, "final_result.json")) as f:
                    result = json.load(f)
                with open(os.path.join(d, "run_info.json")) as f:
                    info = json.load(f)
                if info["package_digest"] != digest:
                    raise ValueError(f"merge: {d} ran package {info['package_digest']}, this invocation {digest}")
                differ = sorted(k for k in protocol.keys() | info["protocol"].keys()
                                if protocol.get(k) != info["protocol"].get(k))
                if differ:
                    raise ValueError(f"merge: {d} ran another protocol: " + ", ".join(
                        f"{k} {info['protocol'].get(k)!r} against {protocol.get(k)!r}" for k in differ))
                out.append((result, info))
    return out


def sweep_summary(entries: list, protocol: dict, digest: str) -> dict:
    """The summary of [(final_result, run_info)] runs of one protocol: the
    reference's keys (`summarize`'s cells), the missions' records, and the
    invocations and seconds they took."""
    per_run = {}
    for result, info in entries:
        m = info["mission"]
        per_run.setdefault(m["scene"], {}).setdefault(m["planner"], []).append(result)
    warmups = {info["invocation"]["id"]: info["invocation"]["warmup_s"] for _, info in entries}
    return {
        "budget_s": protocol["budget_s"],
        "record_interval_s": protocol["record_interval_s"],
        "runs": protocol["runs"],
        "num_test_views": protocol["num_test_views"],
        "mesh_resolution": protocol["mesh_resolution"],
        "scenes": summarize(per_run),
        "wall_clock_s": round(sum(info["mission"]["seconds"] for _, info in entries) + sum(warmups.values()), 1),
        "invocations": len(warmups),
        "missions": [info["mission"] for _, info in entries],
        "warmup_steps": protocol["warmup_steps"],
        "overrides": protocol["overrides"],
        "device": protocol["device"],
        "card": protocol["card"],
        "package_digest": digest,
    }


def package_digest() -> str:
    """sha256 (16 hex digits) of the port's sources: every .py, .cu, .cuh,
    .cpp and .yaml file of the package, by path and content."""
    root = Path(__file__).resolve().parents[1]
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.suffix in (".py", ".cu", ".cuh", ".cpp", ".yaml") and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def card_name() -> str | None:
    """The card's name and power limit as nvidia-smi gives them, or None."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return None


def _plot(root: str) -> None:
    from ..apps.plot import plot

    try:
        plot(root, os.path.join(root, "plots"))
    except ImportError as e:
        print(f"=== plots of {root} not drawn: {e} ===")


def main(argv: list[str] | None = None) -> dict:
    """Run the sweep that the `key=value` arguments (default: the command
    line) configure. Returns the summary."""
    argd = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    exp_id = argd.pop("exp_id", "sweep")
    budget = float(argd.pop("budget", 150))
    record_interval = float(argd.pop("record_interval", 45))
    runs = int(argd.pop("runs", 3))
    run_ids = [int(r) for r in argd.pop("run_ids", ",".join(map(str, range(runs)))).split(",") if r]
    scenes = argd.pop("scenes", "synthetic/boxroom,synthetic/tworoom").split(",")
    planners = argd.pop("planners", "confidence,confidence_wo_roi,exploration,random").split(",")
    num_test_views = int(argd.pop("num_test_views", 128))
    mesh_resolution = int(argd.pop("mesh_resolution", 512))
    warmup_steps = int(argd.pop("warmup_steps", 20))
    merge = int(argd.pop("merge", 0))
    overrides = [f"{k}={v}" for k, v in argd.items()]
    cfg0 = load_config("main", [f"scene={scenes[0]}", *overrides])
    device = mission_device(cfg0)
    root = os.path.join(cfg0.experiment.output_dir, exp_id)
    digest = package_digest()
    protocol = {
        "budget_s": budget, "record_interval_s": record_interval, "runs": runs, "num_test_views": num_test_views,
        "mesh_resolution": mesh_resolution, "warmup_steps": warmup_steps, "overrides": sorted(overrides),
        "device": device.type, "card": card_name() if device.type == "cuda" else None,
    }

    t_sweep = time.time()
    if warmup_steps > 0:
        print(f"=== warm-up mission ({warmup_steps} steps, unrecorded) ===")
        cfg = load_config("main", [f"scene={scenes[0]}", "planner=confidence", "seed=999", *overrides])
        run_one_mission(cfg, device, warmup_steps, 1e9, recorded=False)
        gc.collect()
        print(f"=== warm-up done in {time.time() - t_sweep:.0f}s ===")
    invocation = {"id": uuid.uuid4().hex[:12], "warmup_s": round(time.time() - t_sweep, 1)}

    entries = []
    for scene in scenes:
        scene_base = os.path.basename(scene)
        cfg_s = load_config("main", [f"scene={scene}", *overrides])
        gt = _CachedGT(get_simulator(cfg_s, device=device))
        test_poses = sample_test_views_from_sim(gt.simulator, num_test_views, seed=0)
        for planner in planners:
            for run in run_ids:
                t0 = time.time()
                print(f"=== scene={scene} planner={planner} run={run} ===")
                cfg = load_config("main", [
                    f"scene={scene}", f"planner={planner}", f"experiment.exp_id={exp_id}",
                    f"experiment.run_id={run}", f"seed={run}", *overrides,
                ])
                exp_path, comp, steps = run_one_mission(cfg, device, budget, record_interval)
                result = mesh_and_eval(exp_path, comp, gt, test_poses, mesh_resolution, device)
                t_map = [s["t_mapping"] for s in steps]
                rec = {"scene": scene_base, "planner": planner, "run": run, "steps": len(steps),
                       "t_mapping_first": t_map[0],
                       "t_mapping_median_rest": float(np.median(t_map[1:])) if len(t_map) > 1 else None,
                       "seconds": round(time.time() - t0, 1)}
                del comp, steps
                gc.collect()
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                    rec["reserved_gib"] = round(torch.cuda.memory_reserved(device) / 2**30, 3)
                    rec["max_reserved_gib"] = round(torch.cuda.max_memory_reserved(device) / 2**30, 3)
                info = {"package_digest": digest, "protocol": protocol, "invocation": invocation, "mission": rec}
                with open(os.path.join(exp_path, "run_info.json"), "w") as f:
                    json.dump(info, f, indent=2)
                entries.append((result, info))
                print(
                    f"=== done in {rec['seconds']:.0f}s: {rec['steps']} steps, first step's mapping "
                    f"{rec['t_mapping_first']:.2f} s against the rest's median {rec['t_mapping_median_rest']}; "
                    f"final PSNR {result['mean_psnr'][-1]:.2f} dB, completion ratio "
                    f"{result['mesh_completion_ratio'][-1]}"
                    + (f"; allocator reserves {rec['reserved_gib']} GiB (peak {rec['max_reserved_gib']})"
                       if "reserved_gib" in rec else "") + " ==="
                )
        del gt
        gc.collect()
        _plot(os.path.join(root, scene_base))

    if merge:
        entries = runs_on_disk(root, runs, digest, protocol)
    summary = sweep_summary(entries, protocol, digest)
    out = os.path.join(root, "summary.json")
    os.makedirs(root, exist_ok=True)
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    print(f"summary written to {out}")
    return summary


if __name__ == "__main__":
    main()
