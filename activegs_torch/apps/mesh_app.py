"""Offline mesh extraction (port of `activegs_tpu/apps/mesh_app.py`).

    python -m activegs_torch.apps.mesh_app experiment.exp_id=test
    python -m activegs_torch.apps.mesh_app device=cpu experiment.exp_id=test mesh_resolution=256

For every map snapshot in the experiment's `map/record_info.txt`: render
RGB-D at `mesh_resolution`^2 (default 1024) along the recorded cameras
(`cameras_<id>.json`), fuse a TSDF (2 cm voxels, 10 cm truncation) over
the scene's bbox, drop isolated clusters, and save `map/mesh_<id>.ply`.
Runs on the GPU; `device=cpu` runs it on the CPU.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..eval.evaluation import generate_mesh
from ..io import checkpoint, ply
from ..sim import get_simulator
from .common import build_components, experiment_path, mission_device, parse_cli


def main(argv: list[str] | None = None) -> list[str]:
    """Mesh every snapshot of the experiment that the `key=value` arguments
    (default: the command line) name. Returns the written mesh files."""
    cfg = parse_cli("main", argv)
    device = mission_device(cfg)
    exp_path = experiment_path(cfg)
    info_file = os.path.join(exp_path, "map", "record_info.txt")
    if not os.path.exists(info_file):
        print("no record file!!!")
        return []
    comp = build_components(cfg)
    simulator = get_simulator(cfg, device=device)
    bbox = getattr(simulator, "bbox", None)
    resolution = cfg.get("mesh_resolution", 1024)

    written = []
    with open(info_file) as f:
        map_ids = [line.split()[0] for line in f if line.strip()]
    for map_id in map_ids:
        print(f"generating mesh for gaussian map {map_id}")
        state, mcfg = checkpoint.load_gaussian_map(os.path.join(exp_path, "map", f"map_{map_id}.npz"), device=device)
        with open(os.path.join(exp_path, "map", f"cameras_{map_id}.json")) as f:
            rows = json.load(f)
        cams = [(np.asarray(r[:16], np.float32).reshape(4, 4), np.asarray(r[16:], np.float32).reshape(3, 3))
                for r in rows]
        verts, faces, colors = generate_mesh(
            state, mcfg, cams, resolution=resolution, raster_cfg=comp["raster_cfg"], bbox=bbox
        )
        path = os.path.join(exp_path, "map", f"mesh_{map_id}.ply")
        ply.save_ply(path, verts, faces, colors)
        written.append(path)
    return written


if __name__ == "__main__":
    main(sys.argv[1:])
