"""Simulator seam: the dataframe contract (port of `activegs_tpu/sim/base.py`).

The mapper consumes only this dict:
  {extrinsic (4, 4) OpenCV c2w, intrinsic (3, 3) normalized, rgb (3, H, W),
   depth (1, H, W) with sentinels, depth_range (2,)}
with depth -1 = out of sensor range, -2 = missing surface, and proportional
gaussian noise sigma = depth_noise_co * d on mapping frames.
"""

from __future__ import annotations

import torch


class SimulatorBase:
    scene_name: str = "unknown"
    has_missing_surface: bool = False
    depth_range: tuple[float, float]
    depth_noise_co: float = 0.01

    def simulate(self, c2w, valid_mask_only: bool = False, require_gt: bool = False):
        raise NotImplementedError

    def apply_sensor_model(self, depth: torch.Tensor, generator: torch.Generator):
        """Noise + range sentinels. `generator` is a CPU generator; the noise
        moves to the depth's device. Returns (noisy depth, valid mask)."""
        valid = depth > 0
        lo, hi = self.depth_range
        in_range = (depth > lo) & (depth < hi)
        noise = torch.randn(depth.shape, generator=generator).to(depth.device)
        noisy = depth + noise * torch.abs(depth) * self.depth_noise_co
        noisy = torch.where(in_range, noisy, -1.0)
        noisy = torch.where(valid, noisy, -2.0)
        return noisy, valid
