"""Dataset-replay simulator: serves pre-recorded posed RGB-D frames (port of
`activegs_tpu/sim/replay.py`).

A dataset is a directory with `meta.json` (scene name, resolution,
normalized intrinsic, depth range, bbox) and `frames.npz` (`extrinsics`
(F, 4, 4), `rgbs` (F, 3, H, W) uint8, `depths` (F, H, W) float32 with 0 =
missing), in the reference's format, so either package reads the other's
recordings. A requested pose gets the frame of the nearest recorded pose
(position distance + 0.5 x rotation distance).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .base import SimulatorBase


class ReplaySimulator(SimulatorBase):
    """Replays a recorded dataset; frames come back as tensors on `device`,
    sensor noise from a seeded CPU `torch.Generator`."""

    def __init__(self, dataset_dir: str, depth_noise_co: float = 0.01, seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        self.dataset_dir = dataset_dir
        with open(os.path.join(dataset_dir, "meta.json")) as f:
            meta = json.load(f)
        self.scene_name = meta["scene_name"]
        self.resolution = tuple(int(x) for x in meta["resolution"])
        self.intrinsic = torch.tensor(meta["intrinsic"], dtype=torch.float32, device=self.device).reshape(3, 3)
        self.depth_range = tuple(meta["depth_range"])
        self.bbox = np.asarray(meta["bbox"], np.float32)
        self.has_missing_surface = meta.get("has_missing_surface", False)
        self.depth_noise_co = depth_noise_co
        self.generator = torch.Generator().manual_seed(seed)
        with np.load(os.path.join(dataset_dir, "frames.npz")) as data:
            self.poses = data["extrinsics"]  # (F, 4, 4) host copy for the nearest-pose search
            self.rgbs = torch.from_numpy(data["rgbs"]).to(self.device)  # (F, 3, H, W) uint8
            self.depths = torch.from_numpy(data["depths"]).to(self.device)  # (F, H, W) float32
        self.poses_on = torch.from_numpy(self.poses).to(self.device)

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        return cls(cfg.simulator.dataset_dir, device=device)

    @staticmethod
    def record(path, simulator, poses):
        """Record a dataset from another simulator's clean renders at `poses`."""
        os.makedirs(path, exist_ok=True)
        rgbs, depths = [], []
        for pose in poses:
            c2w = torch.as_tensor(np.asarray(pose), dtype=torch.float32, device=simulator.device)
            rgb, depth, hit = simulator.render_clean(c2w)
            rgbs.append((torch.clamp(rgb, 0, 1) * 255).to(torch.uint8).cpu().numpy())
            depths.append(torch.where(hit, depth, 0.0).to(torch.float32).cpu().numpy())
        np.savez_compressed(
            os.path.join(path, "frames.npz"),
            extrinsics=np.asarray(poses, np.float32),
            rgbs=np.stack(rgbs),
            depths=np.stack(depths),
        )
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(
                {
                    "scene_name": simulator.scene_name,
                    "resolution": [int(x) for x in simulator.resolution],
                    "intrinsic": torch.as_tensor(simulator.intrinsic).cpu().numpy().reshape(-1).tolist(),
                    "depth_range": list(simulator.depth_range),
                    "bbox": np.asarray(simulator.bbox).tolist(),
                    "has_missing_surface": simulator.has_missing_surface,
                },
                f,
            )

    def _nearest(self, c2w: np.ndarray) -> int:
        dp = np.linalg.norm(self.poses[:, :3, 3] - c2w[:3, 3], axis=1)
        dr = np.linalg.norm(self.poses[:, :3, :3] - c2w[:3, :3], axis=(1, 2))
        return int(np.argmin(dp + 0.5 * dr))

    @torch.no_grad()
    def simulate(self, c2w, valid_mask_only: bool = False, require_gt: bool = False):
        c2w = c2w.cpu().numpy() if isinstance(c2w, torch.Tensor) else c2w
        i = self._nearest(np.asarray(c2w, np.float32))
        depth = self.depths[i]
        hit = depth > 0
        if valid_mask_only:
            return hit
        rgb = self.rgbs[i].to(torch.float32) / 255.0
        if require_gt:
            out_depth = torch.where(hit, depth, -2.0)
        else:
            out_depth, _ = self.apply_sensor_model(depth, self.generator)
        return {
            "extrinsic": self.poses_on[i],
            "intrinsic": self.intrinsic,
            "rgb": rgb,
            "depth": out_depth[None],
            "depth_range": torch.tensor(self.depth_range, dtype=torch.float32, device=self.device),
        }
