"""Synthetic RGB-D simulator: a procedurally textured box room ray-cast in
torch (port of `activegs_tpu/sim/synthetic.py`). Brute-force
Möller-Trumbore over all triangles, in pixel chunks."""

from __future__ import annotations

import numpy as np
import torch

from ..core import geometry as geo
from ..core.quaternions import cross
from .base import SimulatorBase


def _box(bmin, bmax, inward: bool):
    """12 triangles of an axis-aligned box; inward=True flips windings so
    normals face inside (room walls)."""
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    v = np.array(
        [[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
         [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]]
    )
    f = np.array(
        [(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7), (0, 1, 5), (0, 5, 4),
         (3, 6, 2), (3, 7, 6), (0, 4, 7), (0, 7, 3), (1, 2, 6), (1, 6, 5)]
    )
    if inward:
        f = f[:, [0, 2, 1]]
    return v, f


def _scene(boxes):
    verts, faces, mats = [], [], []
    for bmin, bmax, mat, inward in boxes:
        v, f = _box(bmin, bmax, inward)
        faces.append(f + sum(len(x) for x in verts))
        verts.append(v)
        mats.append(np.full(len(f), mat))
    return (
        np.concatenate(verts).astype(np.float32),
        np.concatenate(faces).astype(np.int32),
        np.concatenate(mats).astype(np.int32),
    )


def default_room():
    """A 6 x 5 x 3 m room with three furniture boxes and a pillar."""
    return _scene(
        [
            ((0.0, 0.0, 0.0), (6.0, 5.0, 3.0), 0, True),  # room shell
            ((1.0, 1.0, 0.0), (2.2, 2.0, 0.9), 1, False),  # table
            ((4.0, 3.2, 0.0), (5.4, 4.6, 1.4), 2, False),  # cabinet
            ((2.8, 0.4, 0.0), (3.4, 1.0, 0.5), 3, False),  # stool
            ((4.4, 0.8, 0.0), (4.9, 1.3, 3.0), 4, False),  # pillar
        ]
    )


def two_room():
    """Two 5 x 5 x 3 m rooms joined by a 1.2 m-wide, 2.1 m-tall doorway."""
    return _scene(
        [
            ((0.0, 0.0, 0.0), (10.0, 5.0, 3.0), 0, True),
            ((4.92, 0.0, 0.0), (5.08, 1.9, 3.0), 0, False),
            ((4.92, 3.1, 0.0), (5.08, 5.0, 3.0), 0, False),
            ((4.92, 1.9, 2.1), (5.08, 3.1, 3.0), 0, False),
            ((1.0, 1.0, 0.0), (2.2, 2.0, 0.9), 1, False),
            ((2.8, 3.6, 0.0), (3.4, 4.2, 0.5), 3, False),
            ((6.2, 3.4, 0.0), (8.2, 4.6, 0.6), 2, False),
            ((9.2, 0.4, 0.0), (9.8, 1.6, 1.8), 4, False),
        ]
    )


SCENE_BUILDERS = {"boxroom": default_room, "tworoom": two_room}

_BASE_COLORS = (
    (0.75, 0.72, 0.68),  # walls
    (0.55, 0.35, 0.20),  # table
    (0.25, 0.45, 0.60),  # cabinet
    (0.60, 0.20, 0.25),  # stool
    (0.35, 0.55, 0.30),  # pillar
)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def raycast(extrinsic, intrinsic, tri_v, tri_mat, h: int, w: int, pixels_per_chunk: int = 1 << 15):
    """Returns (rgb (3, h, w), z-depth (h, w), hit mask (h, w))."""
    dev = tri_v.device
    coords = geo.pixel_grid(h, w, device=dev).reshape(-1, 2)
    origin, dirs = geo.get_world_rays(coords, extrinsic, intrinsic)
    o = origin[0]
    v0 = tri_v[:, 0]
    e1 = tri_v[:, 1] - v0
    e2 = tri_v[:, 2] - v0
    tvec = (o[None] - v0)[None]  # (1, M, 3)
    qvec = cross(tvec, e1[None])
    t_best, best = [], []
    for d in torch.split(dirs, pixels_per_chunk):
        pvec = cross(d[:, None, :], e2[None])  # (p, M, 3)
        det = _dot(pvec, e1[None])
        ok = torch.abs(det) > 1e-9
        inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        u = _dot(tvec, pvec) * inv
        vv = _dot(qvec, d[:, None, :]) * inv
        t = _dot(qvec, e2[None]) * inv
        hit = ok & (u >= 0) & (vv >= 0) & (u + vv <= 1) & (t > 1e-4)
        t = torch.where(hit, t, torch.inf)
        b = torch.argmin(t, dim=1)
        best.append(b)
        t_best.append(torch.gather(t, 1, b[:, None])[:, 0])
    t_best = torch.cat(t_best)
    best = torch.cat(best)
    has_hit = torch.isfinite(t_best)
    depth = torch.where(has_hit, t_best, 0.0)

    # o + d * t rounded once, as the reference's fused multiply-add does:
    # surface points on the room walls sit exactly on checker boundaries,
    # where a second rounding flips whole texture rows
    p = (o.double()[None] + dirs.double() * t_best.double()[:, None]).float()
    base = torch.tensor(_BASE_COLORS, device=dev)[tri_mat[best]]
    checker = torch.remainder(
        torch.floor(p[:, 0] / 0.2) + torch.floor(p[:, 1] / 0.2) + torch.floor(p[:, 2] / 0.2), 2.0
    )
    tint = 0.85 + 0.15 * checker[:, None]
    wave = 0.08 * torch.sin(7.0 * p[:, 0:1]) * torch.cos(5.0 * p[:, 1:2] + 3.0 * p[:, 2:3])
    rgb = torch.clamp(base * tint + wave, 0.0, 1.0)
    rgb = torch.where(has_hit[:, None], rgb, 0.0)
    return rgb.T.reshape(3, h, w), depth.reshape(h, w), has_hit.reshape(h, w)


class BoxRoomSimulator(SimulatorBase):
    """Simulator over the synthetic room; sensor noise comes from a seeded
    CPU `torch.Generator`."""

    def __init__(
        self,
        resolution=(512, 512),
        fov=(60.0, 60.0),
        depth_range=(0.0, 5.0),
        depth_noise_co=0.01,
        seed=0,
        scene=None,
        scene_name="boxroom",
        missing_band=None,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.scene_name = scene_name
        self.resolution = tuple(int(x) for x in resolution)
        self.fov = tuple(fov)
        self.intrinsic = geo.intrinsics_from_fov(fov[0], fov[1], device=self.device)
        self.depth_range = tuple(depth_range)
        self.depth_noise_co = depth_noise_co
        self.generator = torch.Generator().manual_seed(seed)
        verts, faces, mats = scene if scene is not None else default_room()
        self.mesh_vertices = verts
        self.mesh_faces = faces
        self.tri_v = torch.as_tensor(verts[faces], device=self.device)  # (M, 3, 3)
        self.tri_mat = torch.as_tensor(mats, dtype=torch.int64, device=self.device)
        self.bbox = np.stack([verts.min(0), verts.max(0)])
        # optional "missing surface" height band: hits with world z in
        # [z0, z1] are dropped
        self.missing_band = missing_band
        self.has_missing_surface = missing_band is not None

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        """The simulator of a loaded mission config: the sensor of
        `cfg.simulator.sensor`, the scene `cfg.scene.geometry` (default: its
        `scene_name`, which also names the experiment directory) and, where
        the scene config gives one, its `missing_band` [z0, z1]."""
        s = cfg.simulator
        name = cfg.scene.scene_name
        geom = cfg.scene.get("geometry", name)
        if geom not in SCENE_BUILDERS:
            raise ValueError(f"unknown synthetic scene {geom!r}; have {sorted(SCENE_BUILDERS)}")
        band = cfg.scene.get("missing_band", None)
        return cls(
            resolution=tuple(s.sensor.resolution),
            fov=tuple(s.sensor.fov),
            depth_range=tuple(s.sensor.depth_range),
            depth_noise_co=s.sensor.depth_noise_co,
            scene=SCENE_BUILDERS[geom](),
            scene_name=name,
            missing_band=tuple(band) if band else None,
            device=device,
        )

    def render_clean(self, c2w: torch.Tensor):
        h, w = self.resolution
        rgb, depth, hit = raycast(c2w, self.intrinsic, self.tri_v, self.tri_mat, h, w)
        if self.missing_band is not None:
            z0, z1 = self.missing_band
            pts = geo.backproject_depth(depth, c2w, self.intrinsic)
            hole = (pts[..., 2] > z0) & (pts[..., 2] < z1) & hit
            depth = torch.where(hole, 0.0, depth)
            hit = hit & ~hole
        return rgb, depth, hit

    @torch.no_grad()
    def simulate(self, c2w, valid_mask_only: bool = False, require_gt: bool = False):
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=self.device)
        rgb, depth, hit = self.render_clean(c2w)
        if valid_mask_only:
            return hit
        depth = torch.where(hit, depth, 0.0)
        if require_gt:
            out_depth = torch.where(hit, depth, -2.0)
        else:
            out_depth, _ = self.apply_sensor_model(depth, self.generator)
        return {
            "extrinsic": c2w,
            "intrinsic": self.intrinsic,
            "rgb": rgb,
            "depth": out_depth[None].to(torch.float32),
            "depth_range": torch.tensor(self.depth_range, dtype=torch.float32, device=self.device),
        }
