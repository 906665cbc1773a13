"""Mission entry point (port of `activegs_tpu/apps/main.py`).

    python -m activegs_torch.apps.main planner=confidence scene=synthetic/boxroom \
        experiment.budget=300 max_steps=10 mapper.raster.bf16_pairs=true

Runs on the GPU; `device=cpu` runs the mission on the CPU, with the
compositor's plain PyTorch versions. Results go to
`<experiment.output_dir>/<exp_id>/<scene_name>/<planner_name>/<run_id>/`.
`use_gui=true` serves a live viewer at http://127.0.0.1:<gui_port>/
(default 8787; 0 takes a free port); `dump_views=true` writes each step's
panels under `<experiment>/viewer/`.

Over several ranks (`torchrun --nproc_per_node=N -m activegs_torch.apps.main
...`, N a power of two dividing the batch size; ACTIVEGS_DIST_BACKEND=gloo
for ranks that share a card) the training views and planner candidates
are split over the ranks, and rank 0 records and serves the viewer.
"""

from __future__ import annotations

import os
import sys

import torch.distributed as dist

from ..io.recorder import MissionRecorder
from .common import build_mission, dump_config, experiment_path, mission_device, parse_cli


def main(argv: list[str] | None = None):
    """Fly the mission that the `key=value` arguments (default: the command
    line) configure. Returns the mapper after its last step."""
    cfg = parse_cli("main", argv)
    device = mission_device(cfg)
    writes = not dist.is_initialized() or dist.get_rank() == 0
    viewer = None
    if writes and cfg.get("use_gui", False):
        from ..viz.webviewer import WebViewer

        viewer = WebViewer(port=int(cfg.get("gui_port", 8787)))
        print(f" live viewer: http://127.0.0.1:{viewer.port}/")
    elif writes and cfg.get("dump_views", False):
        from ..viz.viewer import MissionViewer

        viewer = MissionViewer(os.path.join(experiment_path(cfg), "viewer"))

    prewarm_steps = int(cfg.experiment.get("prewarm_steps", 0))
    if prewarm_steps > 0:
        # a throwaway unrecorded mission first, so that kernel builds and
        # first-use costs never bill against the recorded budget
        print(f" prewarm: {prewarm_steps} unrecorded steps...")
        wmapper, _, _, _ = build_mission(cfg, device)
        wmapper.run(max_steps=prewarm_steps)
        del wmapper

    mapper, _, _, _ = build_mission(cfg, device, viewer=viewer)
    if writes and not cfg.get("debug", False):
        path = experiment_path(cfg)
        dump_config(cfg, path)
        mapper.load_recorder(
            MissionRecorder(
                path,
                budget=cfg.experiment.budget,
                record_interval=cfg.experiment.record_interval,
                record_rgbd=cfg.experiment.get("record_rgbd", False),
                record_global_path=cfg.experiment.get("record_global_path", True),
            )
        )
    mapper.run(max_steps=cfg.get("max_steps", None))
    return mapper


if __name__ == "__main__":
    main(sys.argv[1:])
