"""Camera / projection geometry (port of `activegs_tpu/core/geometry.py`).

Extrinsics are OpenCV camera-to-world 4x4; intrinsics are 3x3 and
normalized by the image size; pixel centers sit at (i + 0.5) / n.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing


def apply_rotation(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) written out elementwise (the reference's op
    order, so both packages round alike)."""
    return (
        rot[..., :, 0] * v[..., 0:1]
        + rot[..., :, 1] * v[..., 1:2]
        + rot[..., :, 2] * v[..., 2:3]
    )


def intrinsics_from_fov(
    vfov_deg: float, hfov_deg: float, device="cuda"
) -> torch.Tensor:
    """Normalized pinhole intrinsics: fx = 0.5 / tan(hfov / 2), cx = cy = 0.5.
    Float32 host math through numpy, which rounds tan like the reference."""
    f32 = np.float32
    fx = f32(0.5) / np.tan(f32(np.deg2rad(f32(hfov_deg))) / f32(2.0))
    fy = f32(0.5) / np.tan(f32(np.deg2rad(f32(vfov_deg))) / f32(2.0))
    k = np.array([[fx, 0.0, 0.5], [0.0, fy, 0.5], [0.0, 0.0, 1.0]], np.float32)
    return torch.from_numpy(k).to(device)


def fov_from_intrinsics(intrinsics: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) normalized intrinsics -> (..., 2) (fov_x, fov_y) radians."""
    fx = intrinsics[..., 0, 0]
    fy = intrinsics[..., 1, 1]
    cx = intrinsics[..., 0, 2]
    cy = intrinsics[..., 1, 2]
    fov_x = torch.atan2(1.0 - cx, fx) + torch.atan2(cx, fx)
    fov_y = torch.atan2(1.0 - cy, fy) + torch.atan2(cy, fy)
    return torch.stack([fov_x, fov_y], dim=-1)


def fov_to_focal(fov: torch.Tensor, pixels) -> torch.Tensor:
    return pixels / (2.0 * torch.tan(fov / 2.0))


def focal_to_fov(focal: torch.Tensor, pixels) -> torch.Tensor:
    return 2.0 * torch.atan2(torch.as_tensor(pixels, dtype=focal.dtype), 2.0 * focal)


def pixel_grid(h: int, w: int, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """(h, w, 2) normalized (x, y) pixel-center coordinates in [0, 1]."""
    ys = (torch.arange(h, dtype=dtype, device=device) + 0.5) / h
    xs = (torch.arange(w, dtype=dtype, device=device) + 0.5) / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def invert_rigid(extrinsic: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid 4x4 camera-to-world transform."""
    r = extrinsic[..., :3, :3]
    t = extrinsic[..., :3, 3]
    rt = r.transpose(-1, -2)
    top = torch.cat([rt, -apply_rotation(rt, t)[..., None]], dim=-1)
    with tracing.host_read("invert_rigid"):
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=extrinsic.dtype, device=extrinsic.device)
    bottom = bottom.expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def unproject(coords: torch.Tensor, z: torch.Tensor, intrinsics: torch.Tensor):
    """Normalized image coords (..., 2) + depth (...,) -> camera points (..., 3)."""
    fx = intrinsics[..., 0, 0]
    fy = intrinsics[..., 1, 1]
    cx = intrinsics[..., 0, 2]
    cy = intrinsics[..., 1, 2]
    x = (coords[..., 0] - cx) / fx
    y = (coords[..., 1] - cy) / fy
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return d * z[..., None]


def get_world_rays(coords: torch.Tensor, extrinsic: torch.Tensor, intrinsics: torch.Tensor):
    """Normalized image coords -> (origins, directions) in world space.
    Directions have unit camera-frame z, so `origin + dir * depth` lands on
    the surface for a z-depth map."""
    d_cam = unproject(coords, torch.ones_like(coords[..., 0]), intrinsics)
    d_world = apply_rotation(extrinsic[..., :3, :3], d_cam)
    origins = extrinsic[..., :3, 3].expand(d_world.shape)
    return origins, d_world


def project_points(points: torch.Tensor, extrinsic: torch.Tensor, intrinsics: torch.Tensor):
    """World points (..., 3) -> normalized image xy (..., 2), cam depth, valid."""
    w2c = invert_rigid(extrinsic)
    p_cam = apply_rotation(w2c[..., :3, :3], points) + w2c[..., :3, 3]
    z = p_cam[..., 2]
    eps = torch.finfo(torch.float32).eps
    xy = p_cam[..., :2] / (z[..., None] + eps)
    u = xy[..., 0] * intrinsics[..., 0, 0] + intrinsics[..., 0, 2]
    v = xy[..., 1] * intrinsics[..., 1, 1] + intrinsics[..., 1, 2]
    return torch.stack([u, v], dim=-1), z, z > 0


def backproject_depth(depth: torch.Tensor, extrinsic: torch.Tensor, intrinsics: torch.Tensor):
    """Depth map (h, w) -> world points (h, w, 3) (z-depth convention)."""
    h, w = depth.shape[-2:]
    coords = pixel_grid(h, w, device=depth.device, dtype=depth.dtype)
    origins, dirs = get_world_rays(coords, extrinsic, intrinsics)
    return origins + dirs * depth[..., None]


def look_at(pos, target, device="cuda") -> torch.Tensor:
    """(4, 4) camera-to-world pose at `pos` looking at `target`, no roll."""
    from .quaternions import rotation_from_z

    z = torch.as_tensor(target, dtype=torch.float32) - torch.as_tensor(
        pos, dtype=torch.float32
    )
    e = torch.eye(4, dtype=torch.float32)
    e[:3, :3] = rotation_from_z(z[None])[0]
    e[:3, 3] = torch.as_tensor(pos, dtype=torch.float32)
    return e.to(device)
