"""Orbit views of a saved map (port of `activegs_tpu/apps/visualize.py`).

    python -m activegs_torch.apps.visualize --map experiments/.../map_final.npz \
        --out ./viz --views 12 --resolution 512

Writes one channel panel (rgb | depth | confidence over opacity | normal |
depth-to-normal) per view on an orbit around the map, as `view_XX.png`.
Runs on the GPU; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..core import geometry as geo
from ..io import checkpoint
from ..io.png import write_png
from ..planning.paths import rotation_from_z
from ..render.types import Camera, RasterConfig
from ..viz.viewer import render_channel_panel


def orbit_poses(center: np.ndarray, radius: float, height: float, n: int) -> list[np.ndarray]:
    """`n` (4, 4) float32 poses on a circle of `radius` around `center`,
    `height` above it, each looking at the center."""
    poses = []
    for ang in np.linspace(0, 2 * np.pi, n, endpoint=False):
        pos = center + [radius * np.cos(ang), radius * np.sin(ang), height]
        e = np.eye(4, dtype=np.float32)
        e[:3, :3] = rotation_from_z(center - pos)[0]
        e[:3, 3] = pos
        poses.append(e)
    return poses


def main(argv: list[str] | None = None) -> list[str]:
    """Render the orbit panels of `--map`. Returns the written files."""
    ap = argparse.ArgumentParser(description="channel panels of a saved map from an orbit around it")
    ap.add_argument("--map", required=True)
    ap.add_argument("--out", default="./viz")
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--fov", type=float, default=60.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: visualize runs on the GPU; pass --device cpu to run it on the CPU")

    state, cfg = checkpoint.load_gaussian_map(args.map, device=dev)
    means = state.means[: state.count].cpu().numpy()
    center = means.mean(0)
    radius = 0.6 * float(np.linalg.norm(means.max(0) - means.min(0)))
    os.makedirs(args.out, exist_ok=True)
    intr = geo.intrinsics_from_fov(args.fov, args.fov, device=dev)
    written = []
    for i, pose in enumerate(orbit_poses(center, radius, 0.3 * radius, args.views)):
        cam = Camera(extrinsic=torch.as_tensor(pose, device=dev), intrinsic=intr)
        panel = render_channel_panel(state, cfg, cam, (args.resolution, args.resolution), RasterConfig())
        written.append(os.path.join(args.out, f"view_{i:02d}.png"))
        write_png(written[-1], panel)
    print(f"wrote {args.views} channel panels to {args.out}")
    return written


if __name__ == "__main__":
    main()
