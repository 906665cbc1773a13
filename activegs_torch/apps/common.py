"""Shared app plumbing: config loading, the device, experiment directories,
component wiring (port of `activegs_tpu/apps/common.py`)."""

from __future__ import annotations

import os
import sys

import torch

from .. import runtime
from ..config import build_components, load_config, yaml_subset
from ..mapping.mapper import IncrementalMapper
from ..planning import get_planner
from ..sim import get_simulator


def parse_cli(config_name: str, argv: list[str] | None = None):
    """The config `config_name` with the `key=value` arguments of `argv`
    (default: the command line) applied. Joins the process group that the
    environment describes, if it asks for one (`runtime.init_distributed`)."""
    args = sys.argv[1:] if argv is None else argv
    cfg = load_config(config_name, [a for a in args if "=" in a])
    runtime.init_distributed()
    return cfg


def mission_device(cfg) -> torch.device:
    """The device a mission runs on: the card, unless the config's `device`
    key (`device=cpu` on the command line) names another. Raises when it
    names the card, or names none, and there is no CUDA device."""
    dev = torch.device(cfg.get("device") or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the mission runs on the GPU; pass device=cpu to run it on the CPU")
    return dev


def experiment_path(cfg) -> str:
    return os.path.join(
        cfg.experiment.output_dir,
        str(cfg.experiment.exp_id),
        cfg.scene.scene_name,
        cfg.planner.planner_name,
        str(cfg.experiment.run_id),
    )


def dump_config(cfg, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "exp_config.yaml"), "w") as f:
        f.write(yaml_subset.dumps(cfg.to_dict()))


def build_mission(cfg, device, viewer=None):
    """(mapper, simulator, planner, typed configs) of a loaded config, on
    `device`, the mapper wired to the simulator, the planner and
    `viewer`."""
    comp = build_components(cfg)
    simulator = get_simulator(cfg, device=device)
    planner = get_planner(
        comp["planner_cfg"], comp["map_cfg"], comp["voxel_cfg"], comp["raster_cfg"], seed=cfg.get("seed", 0)
    )
    mapper = IncrementalMapper(
        comp["map_cfg"],
        comp["voxel_cfg"],
        comp["raster_cfg"],
        keyframe_capacity=cfg.mapper.get("keyframe_capacity", 256),
        seed=cfg.get("seed", 0),
        device=device,
        viewer=viewer,
    )
    mapper.load_simulator(simulator)
    mapper.load_planner(planner)
    return mapper, simulator, planner, comp
