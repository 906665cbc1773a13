"""Test-view generation (port of `activegs_tpu/apps/data_generation.py`).

    python -m activegs_torch.apps.data_generation num_views=200
    python -m activegs_torch.apps.data_generation device=cpu "simulator.sensor.resolution=[64,64]"

Explores the scene with the random planner until the voxel map converges
(no change of the unexplored voxels for `converged_step` iterations),
samples `num_views` random poses inside free voxels, and writes
`<dataset_path>/<scene>_test/`: `traj.txt`, `intrinsic.txt` and, unless
`save_pose_only`, `rgb/*.png` and `depth/*.npy`. Runs on the GPU;
`device=cpu` runs it on the CPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..io.png import write_png
from ..mapping import voxel_map as vm
from ..planning import PlannerConfig, RandomPlanner
from ..planning.paths import random_rotation
from ..sim import get_simulator
from .common import build_components, mission_device, parse_cli


def generate_test_views(vstate, grid, voxel_cfg, num_views: int, rng):
    """`num_views` random (4, 4) poses at jittered free-voxel centers with
    random rotations, drawn from the numpy generator `rng`."""
    centers = np.asarray(grid.centers)
    size = np.asarray(grid.size)
    free = vm.free_mask(vstate, voxel_cfg).cpu().numpy()
    free_centers = centers[free]
    if len(free_centers) == 0:
        free_centers = centers
    picks = free_centers[rng.integers(0, len(free_centers), num_views)]
    jitter = rng.uniform(-0.5, 0.5, picks.shape) * size
    points = picks + jitter
    ts = np.tile(np.eye(4), (num_views, 1, 1)).astype(np.float32)
    ts[:, :3, 3] = points
    ts[:, :3, :3] = random_rotation(num_views, pitch_angle=None, rng=rng)
    return ts


def explore_until_converged(simulator, planner, grid, voxel_cfg, max_iter=100, converged_step=5):
    """Random walk through free space, the voxel map updated from each
    ground-truth frame, until `converged_step` iterations in a row leave
    the unexplored voxels unchanged or `max_iter` iterations ran. Returns
    the voxel state on the simulator's device."""
    vstate = vm.init_state(grid, simulator.device)
    converged = 0
    it = 0
    while it < max_iter and converged < converged_step:
        path = planner.plan(None, vstate, grid, simulator, None)
        frame = simulator.simulate(np.asarray(path[-1]), require_gt=True)
        old = vstate.unexplored
        vstate = vm.update(vstate, grid, frame)
        converged = converged + 1 if torch.equal(old, vstate.unexplored) else 0
        it += 1
    return vstate


def sample_test_views_from_sim(simulator, num_views: int, seed: int = 0):
    """Test poses when no recorded test set exists: a short exploration on a
    0.4 m voxel map, then `generate_test_views`."""
    voxel_cfg = vm.VoxelConfig(map_resolution=(0.4, 0.4, 0.4))
    grid = vm.VoxelGrid.create(simulator.bbox, voxel_cfg)
    center = 0.5 * (simulator.bbox[0] + simulator.bbox[1])
    init_pose = np.eye(4, dtype=np.float32)
    init_pose[:3, 3] = center
    planner = RandomPlanner(
        PlannerConfig(
            type="random",
            sample_num=8,
            max_roi_sample_num=0,
            radius=2.0,
            init_pose=tuple(tuple(r) for r in init_pose),
        ),
        None,
        voxel_cfg,
        seed=seed,
    )
    vstate = explore_until_converged(simulator, planner, grid, voxel_cfg, max_iter=20, converged_step=3)
    return generate_test_views(vstate, grid, voxel_cfg, num_views, np.random.default_rng(seed))


def main(argv: list[str] | None = None) -> str:
    """Generate the test views that the `key=value` arguments (default: the
    command line) configure. Returns the output directory."""
    cfg = parse_cli("data_generation", argv)
    device = mission_device(cfg)
    simulator = get_simulator(cfg, device=device)
    comp = build_components(cfg)
    voxel_cfg = comp["voxel_cfg"]
    grid = vm.VoxelGrid.create(simulator.bbox, voxel_cfg)
    planner = RandomPlanner(comp["planner_cfg"], comp["map_cfg"], voxel_cfg, comp["raster_cfg"])
    vstate = explore_until_converged(
        simulator,
        planner,
        grid,
        voxel_cfg,
        max_iter=cfg.get("max_iter", 100),
        converged_step=cfg.get("converged_step", 5),
    )
    rng = np.random.default_rng(cfg.get("seed", 0))
    views = generate_test_views(vstate, grid, voxel_cfg, cfg.num_views, rng)

    out = os.path.join(cfg.dataset_path, simulator.scene_name + "_test")
    os.makedirs(out, exist_ok=True)
    np.savetxt(os.path.join(out, "traj.txt"), views.reshape(len(views), -1))
    np.savetxt(os.path.join(out, "intrinsic.txt"), simulator.intrinsic.cpu().numpy().reshape(-1))
    if not cfg.get("save_pose_only", False):
        os.makedirs(os.path.join(out, "rgb"), exist_ok=True)
        os.makedirs(os.path.join(out, "depth"), exist_ok=True)
        for i, pose in enumerate(views):
            frame = simulator.simulate(pose, require_gt=True)
            rgb = (torch.clamp(frame["rgb"], 0, 1) * 255).to(torch.uint8).permute(1, 2, 0)
            write_png(os.path.join(out, "rgb", f"{i:05d}.png"), rgb.cpu().numpy())
            np.save(os.path.join(out, "depth", f"{i:05d}.npy"), frame["depth"][0].cpu().numpy())
    print(f"saved {len(views)} test views to {out}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
