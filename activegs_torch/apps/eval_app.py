"""Offline evaluation (port of `activegs_tpu/apps/eval_app.py`).

    python -m activegs_torch.apps.eval_app experiment.exp_id=test
    python -m activegs_torch.apps.eval_app device=cpu experiment.exp_id=test test_folder=./datasets/boxroom_test

Loads every map snapshot (and its mesh, where `mesh_app` made one) of an
experiment, renders the test views (`test_folder/traj.txt`, else poses
sampled from the simulator's free space), scores the renders and the
meshes, and writes `final_result.json` into the experiment directory,
merged into the one there. Runs on the GPU; `device=cpu` runs it on the
CPU.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..eval.evaluation import EvaluationTool
from ..io import checkpoint, ply
from ..sim import get_simulator
from .common import build_components, experiment_path, mission_device, parse_cli


def load_snapshots(exp_path: str, device="cuda"):
    """(ids, mission times, path lengths, [(state, map config)], [mesh or
    None]) of the snapshots in `record_info.txt`, or None without it."""
    info_file = os.path.join(exp_path, "map", "record_info.txt")
    if not os.path.exists(info_file):
        print("no record file!!!")
        return None
    with open(info_file) as f:
        rows = [line.split() for line in f if line.strip()]
    ids = [r[0] for r in rows]
    times = [float(r[1]) for r in rows]
    lengths = [float(r[2]) for r in rows]
    maps, meshes = [], []
    for i in ids:
        maps.append(checkpoint.load_gaussian_map(os.path.join(exp_path, "map", f"map_{i}.npz"), device=device))
        mesh_file = os.path.join(exp_path, "map", f"mesh_{i}.ply")
        meshes.append(ply.load_ply(mesh_file) if os.path.exists(mesh_file) else None)
    return ids, times, lengths, maps, meshes


def main(argv: list[str] | None = None) -> dict | None:
    """Evaluate the experiment that the `key=value` arguments (default: the
    command line) name. Returns the written result."""
    cfg = parse_cli("eval", argv)
    device = mission_device(cfg)
    exp_path = experiment_path(cfg)
    snap = load_snapshots(exp_path, device)
    if snap is None:
        return None
    ids, times, lengths, maps, meshes = snap

    simulator = get_simulator(cfg, device=device)
    comp = build_components(cfg)

    test_folder = cfg.get("test_folder", None)
    traj_file = os.path.join(test_folder, "traj.txt") if test_folder else None
    if traj_file and os.path.exists(traj_file):
        poses = np.loadtxt(traj_file).reshape(-1, 4, 4).astype(np.float32)
    else:
        from .data_generation import sample_test_views_from_sim

        poses = sample_test_views_from_sim(simulator, cfg.get("num_test_views", 200))

    mesh_gt = None
    if hasattr(simulator, "mesh_vertices"):
        mesh_gt = (np.asarray(simulator.mesh_vertices), np.asarray(simulator.mesh_faces))
    elif test_folder and os.path.exists(os.path.join(test_folder, "mesh.ply")):
        mesh_gt = ply.load_ply(os.path.join(test_folder, "mesh.ply"))

    tool = EvaluationTool(
        maps=maps,
        meshes=meshes,
        test_poses=poses,
        gt_provider=simulator,
        mesh_gt=mesh_gt,
        raster_cfg=comp["raster_cfg"],
    )
    result = tool.eval(mode=cfg.get("eval_mode", "complete"))
    result["step"] = ids
    result["time"] = times
    result["path_length"] = lengths

    out_file = os.path.join(exp_path, "final_result.json")
    if os.path.exists(out_file):
        with open(out_file) as f:
            old = json.load(f)
        old.update(result)
        result = old
    with open(out_file, "w") as f:
        json.dump(result, f, indent=4)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
