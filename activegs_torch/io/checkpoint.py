"""Map checkpointing: save / load the gaussian and voxel map states (port of
`activegs_tpu/io/checkpoint.py`).

npz + JSON with the reference's keys, so a map saved by either package
loads in the other. Only the live prefix of the static-capacity store is
written. Optimizer state is not persisted: Adam is recreated each keyframe.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..mapping import gaussians as gm
from ..mapping import voxel_map as vm


def save_gaussian_map(path: str, state: gm.GaussianMapState, cfg: gm.MapConfig):
    np.savez_compressed(
        path,
        **gm.state_to_numpy(state),
        meta=json.dumps(
            {
                "near": cfg.bound[0],
                "far": cfg.bound[1],
                "background": list(cfg.background),
                "scale_factor": cfg.scale_factor,
                "use_view_distribution": cfg.use_view_distribution,
            }
        ),
    )


def load_gaussian_map(path: str, cfg: gm.MapConfig | None = None, capacity=None, device="cuda"):
    """Returns (state, cfg). Without `cfg`, the stored meta rebuilds the map
    config; the capacity is the config's, or the next power of two that
    holds the map."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    n = len(data["means"])
    if cfg is None:
        cfg = gm.MapConfig(
            bound=(meta["near"], meta["far"]),
            background=tuple(meta["background"]),
            scale_factor=meta["scale_factor"],
            use_view_distribution=meta["use_view_distribution"],
        )
    cap = capacity or max(cfg.capacity, 1 << (n - 1).bit_length())
    if cap < n:
        cap = 1 << (n - 1).bit_length()
    cfg = dataclasses.replace(cfg, capacity=cap)
    return gm.state_from_numpy(data, device, capacity=cap), cfg


def save_voxel_map(path: str, state: vm.VoxelMapState, grid: vm.VoxelGrid):
    np.savez_compressed(
        path,
        **vm.voxel_state_to_numpy(state),
        meta=json.dumps(
            {
                "bbox_min": list(grid.bbox_min),
                "bbox_max": list(grid.bbox_max),
                "dim": list(grid.dim),
                "size": list(grid.size),
            }
        ),
    )


def load_voxel_map(path: str, device="cuda"):
    """Returns (state, grid)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    grid = vm.VoxelGrid(
        bbox_min=tuple(meta["bbox_min"]),
        bbox_max=tuple(meta["bbox_max"]),
        dim=tuple(meta["dim"]),
        size=tuple(meta["size"]),
    )
    return vm.voxel_state_from_numpy(data, device), grid
