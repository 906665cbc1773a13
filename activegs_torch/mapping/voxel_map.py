"""Voxel occupancy map: log-odds grid and the exploration / ROI masks (port
of `activegs_tpu/mapping/voxel_map.py`).

Grid geometry is a static, hashable `VoxelGrid`; the mutable fields
(log-odds, unexplored, ROI, per-voxel normals) are tensors of a
`VoxelMapState` on the map's device. The update is projections and
scatters, and the binary dilations are shift-ORs on the device. The hit
scatter is a boolean set, so its order does not matter; the count and
normal sums of `update_utility` go through `core.scatter.scatter_sum`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core import geometry as geo
from ..core.scatter import scatter_sum

LO_STEP = 2.8  # log-odds increment
LO_CLIP = 4.5  # keeps p in (0.01, 0.99)


@dataclasses.dataclass(frozen=True)
class VoxelConfig:
    """`config/mapper/incremental.yaml`, voxel part."""

    map_resolution: tuple[float, float, float] = (0.2, 0.2, 0.2)
    safety_margin: float = 0.3
    min_gaussian_per_voxel: int = 5
    occ_thres: float = 0.8
    free_thres: float = 0.2


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Static grid geometry from the scene bbox: dim = ceil(extent /
    resolution), size = extent / dim (float64 host math)."""

    bbox_min: tuple[float, float, float]
    bbox_max: tuple[float, float, float]
    dim: tuple[int, int, int]
    size: tuple[float, float, float]

    @classmethod
    def create(cls, bbox, cfg: VoxelConfig) -> "VoxelGrid":
        bmin = np.asarray(bbox[0], np.float64)
        bmax = np.asarray(bbox[1], np.float64)
        extent = bmax - bmin
        dim = np.ceil(extent / np.asarray(cfg.map_resolution)).astype(int)
        size = extent / dim
        return cls(
            bbox_min=tuple(bmin.tolist()),
            bbox_max=tuple(bmax.tolist()),
            dim=tuple(int(d) for d in dim),
            size=tuple(size.tolist()),
        )

    @property
    def num_voxels(self) -> int:
        return int(np.prod(self.dim))

    @functools.cached_property
    def centers(self) -> np.ndarray:
        """(T, 3) float32 voxel centers, host copy (the planner's)."""
        idx = np.stack(np.meshgrid(*[np.arange(d) for d in self.dim], indexing="ij"), axis=-1).reshape(-1, 3)
        c = np.asarray(self.bbox_min) + (idx + 0.5) * np.asarray(self.size)
        return np.asarray(c, np.float32)

    def centers_on(self, device) -> torch.Tensor:
        """The voxel centers as a tensor on `device`, cached per device."""
        cache = self.__dict__.setdefault("_centers_on", {})
        key = str(torch.device(device))
        if key not in cache:
            cache[key] = torch.from_numpy(self.centers).to(device)
        return cache[key]

    def voxelize(self, points: torch.Tensor):
        """xyz (..., 3) -> (ijk int32 index, in-bounds mask); floors."""
        f32 = dict(dtype=torch.float32, device=points.device)
        rel = points - torch.tensor(self.bbox_min, **f32)
        idx = torch.floor(rel / torch.tensor(self.size, **f32)).to(torch.int32)
        dim = torch.tensor(self.dim, dtype=torch.int32, device=points.device)
        ok = torch.all(idx >= 0, -1) & torch.all(idx < dim, -1)
        return idx, ok

    def linear(self, idx: torch.Tensor) -> torch.Tensor:
        return idx[..., 0] * (self.dim[1] * self.dim[2]) + idx[..., 1] * self.dim[2] + idx[..., 2]


@dataclasses.dataclass(frozen=True)
class VoxelMapState:
    log_odds: torch.Tensor  # (T,) f32
    unexplored: torch.Tensor  # (T,) bool
    roi_mask: torch.Tensor  # (T,) bool
    voxel_normal: torch.Tensor  # (T, 3) mean normal of low-confidence surfels


def init_state(grid: VoxelGrid, device="cuda") -> VoxelMapState:
    t = grid.num_voxels
    return VoxelMapState(
        log_odds=torch.zeros(t, device=device),
        unexplored=torch.ones(t, dtype=torch.bool, device=device),
        roi_mask=torch.zeros(t, dtype=torch.bool, device=device),
        voxel_normal=torch.zeros((t, 3), device=device),
    )


def voxel_state_from_numpy(d, device="cuda") -> VoxelMapState:
    """State from arrays named like the `VoxelMapState` fields (the keys of
    a voxel-map checkpoint)."""
    return VoxelMapState(
        log_odds=torch.tensor(np.asarray(d["log_odds"], np.float32), device=device),
        unexplored=torch.tensor(np.asarray(d["unexplored"], bool), device=device),
        roi_mask=torch.tensor(np.asarray(d["roi_mask"], bool), device=device),
        voxel_normal=torch.tensor(np.asarray(d["voxel_normal"], np.float32), device=device),
    )


def voxel_state_to_numpy(state: VoxelMapState) -> dict:
    return {f.name: getattr(state, f.name).cpu().numpy() for f in dataclasses.fields(state)}


# ---------------------------------------------------------------------------
# dilation structuring elements (static offset lists)
# ---------------------------------------------------------------------------


def sphere_offsets(radius_vox: float):
    """Offsets of the spherical structuring element of radius `radius_vox`."""
    r = int(np.ceil(radius_vox))
    return tuple(
        (x, y, z)
        for x in range(-r, r + 1)
        for y in range(-r, r + 1)
        for z in range(-r, r + 1)
        if x * x + y * y + z * z <= radius_vox * radius_vox
    )


# generate_binary_structure(3, 1)
CROSS_OFFSETS = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))


def dilate(mask: torch.Tensor, grid: VoxelGrid, offsets) -> torch.Tensor:
    """Binary dilation of a flat (T,) mask by a static offset set (what
    scipy.ndimage.binary_dilation gives with that structure)."""
    m = mask.reshape(grid.dim)
    rx, ry, rz = (max(abs(o[i]) for o in offsets) for i in range(3))
    mp = torch.nn.functional.pad(m.to(torch.uint8), (rz, rz, ry, ry, rx, rx)).bool()
    out = torch.zeros_like(m)
    dx, dy, dz = grid.dim
    for ox, oy, oz in offsets:
        out |= mp[rx - ox : rx - ox + dx, ry - oy : ry - oy + dy, rz - oz : rz - oz + dz]
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# state masks
# ---------------------------------------------------------------------------


def probabilities(state: VoxelMapState) -> torch.Tensor:
    return torch.sigmoid(state.log_odds)


def free_mask(state: VoxelMapState, cfg: VoxelConfig) -> torch.Tensor:
    return probabilities(state) <= cfg.free_thres


def occ_mask(state: VoxelMapState, cfg: VoxelConfig) -> torch.Tensor:
    return probabilities(state) >= cfg.occ_thres


def unknown_mask(state: VoxelMapState, cfg: VoxelConfig) -> torch.Tensor:
    return ~free_mask(state, cfg) & ~occ_mask(state, cfg)


def free_mask_w_margin(state: VoxelMapState, grid: VoxelGrid, cfg: VoxelConfig) -> torch.Tensor:
    """Free voxels minus a safety-margin dilation of occupied space."""
    radius = max(cfg.safety_margin / s for s in grid.size)
    occ_d = dilate(occ_mask(state, cfg), grid, sphere_offsets(radius))
    return free_mask(state, cfg) & ~occ_d


def frontier_mask(state: VoxelMapState, grid: VoxelGrid, cfg: VoxelConfig) -> torch.Tensor:
    """Free voxels next to unexplored space."""
    return dilate(state.unexplored, grid, CROSS_OFFSETS) & free_mask(state, cfg)


# ---------------------------------------------------------------------------
# projection / visibility
# ---------------------------------------------------------------------------


def _frustum_mask(grid: VoxelGrid, extrinsic, intrinsic, depth_map):
    """Voxels in the camera frustum in front of the observed surface, and
    those looking at an invalid (negative) measurement. depth_map (h, w).
    Pixel indices truncate toward zero, as the reference's cast does."""
    h, w = depth_map.shape
    uv, z, front = geo.project_points(grid.centers_on(depth_map.device), extrinsic, intrinsic)
    x = uv[..., 0] * w
    y = uv[..., 1] * h
    valid_x = (x >= 0) & (x < w)
    valid_y = (y >= 0) & (y < h)
    xi = torch.clamp(x.to(torch.int32), 0, w - 1).long()
    yi = torch.clamp(y.to(torch.int32), 0, h - 1).long()
    depth_at = torch.where(valid_x & valid_y, depth_map[yi, xi], -1.0)
    fov = front & valid_x & valid_y
    return fov & (depth_at > z), fov & (depth_at < 0.0)


def visible_mask(state, grid: VoxelGrid, extrinsic, intrinsic, depth_map) -> torch.Tensor:
    frustum, _ = _frustum_mask(grid, extrinsic, intrinsic, depth_map)
    return frustum


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------


def inverse_sensor_model(distance: torch.Tensor) -> torch.Tensor:
    """Distance-weighted evidence."""
    return torch.clamp(1.0 - 0.1 * distance, 0.0, 1.0)


@torch.no_grad()
def update(state: VoxelMapState, grid: VoxelGrid, frame: dict) -> VoxelMapState:
    """Log-odds update from one posed depth frame: hit voxels +,
    pass-through voxels -, both distance weighted; clears unexplored."""
    depth_map = frame["depth"][0]  # (h, w), sentinels -1 (range) / -2 (hole)
    extrinsic = frame["extrinsic"]
    intrinsic = frame["intrinsic"]
    depth_clone = torch.where(depth_map == -1.0, frame["depth_range"][1], depth_map)
    pass_mask, _ = _frustum_mask(grid, extrinsic, intrinsic, depth_clone)

    # hit voxels: back-projected valid-depth pixels (a boolean set)
    pts = geo.backproject_depth(depth_map, extrinsic, intrinsic).reshape(-1, 3)
    idx, in_bounds = grid.voxelize(pts)
    ok = in_bounds & (depth_map.reshape(-1) >= 0.0)
    lin = torch.where(ok, grid.linear(idx), grid.num_voxels).long()
    hit = torch.zeros(grid.num_voxels + 1, dtype=torch.bool, device=depth_map.device)
    hit[lin] = True
    hit = hit[: grid.num_voxels]

    pass_mask = pass_mask & ~hit
    d = grid.centers_on(depth_map.device) - extrinsic[:3, 3]
    dist = torch.sqrt(torch.sum(d * d, dim=-1))
    w_lo = LO_STEP * inverse_sensor_model(dist)
    lo = state.log_odds + torch.where(hit, w_lo, 0.0) - torch.where(pass_mask, w_lo, 0.0)
    lo = torch.clamp(lo, -LO_CLIP, LO_CLIP)
    unexplored = state.unexplored & ~hit & ~pass_mask
    return dataclasses.replace(state, log_odds=lo, unexplored=unexplored)


# ---------------------------------------------------------------------------
# utility / ROI
# ---------------------------------------------------------------------------


@torch.no_grad()
def update_utility(
    state: VoxelMapState,
    grid: VoxelGrid,
    cfg: VoxelConfig,
    gaussian_means: torch.Tensor,
    gaussian_normals: torch.Tensor,
    gaussian_confidences: torch.Tensor,
    gaussian_opacities: torch.Tensor,
    gaussian_alive: torch.Tensor,
    use_confidence: bool = True,
    confidence_thres: float = 0.3,
) -> VoxelMapState:
    """ROI = frontier voxels + voxels holding > min_gaussian_per_voxel
    low-confidence (< 0.3) high-opacity (> 0.7) surfels, restricted to
    voxels touching free space; per-ROI mean surfel normal for cone
    sampling."""
    t = grid.num_voxels
    raw_roi = frontier_mask(state, grid, cfg)
    voxel_normal = torch.zeros_like(state.voxel_normal)
    if use_confidence:
        idx, ok = grid.voxelize(gaussian_means)
        sel = ok & gaussian_alive & (gaussian_confidences < confidence_thres) & (gaussian_opacities > 0.7)
        lin = torch.where(sel, grid.linear(idx), 0).long()
        ones = torch.ones_like(gaussian_means[:, :1])
        sums = scatter_sum(torch.cat([ones, gaussian_normals], dim=1), lin, t, sel)
        counts, nsum = sums[:, 0], sums[:, 1:]
        update_m = counts > cfg.min_gaussian_per_voxel
        mean_n = nsum / torch.clamp(counts[:, None], min=1.0)
        mean_n = mean_n / torch.clamp(torch.sqrt(torch.sum(mean_n * mean_n, -1, keepdim=True)), min=1e-12)
        voxel_normal = torch.where(update_m[:, None], mean_n, 0.0)
        raw_roi = raw_roi | update_m
    free_d = dilate(free_mask(state, cfg), grid, CROSS_OFFSETS)
    return dataclasses.replace(state, roi_mask=raw_roi & free_d, voxel_normal=voxel_normal)


def in_free_space(state: VoxelMapState, grid: VoxelGrid, cfg: VoxelConfig, points: torch.Tensor) -> torch.Tensor:
    """Points in free space, against the safety-margin mask."""
    idx, ok = grid.voxelize(points)
    lin = torch.where(ok, grid.linear(idx), 0).long()
    return torch.where(ok, free_mask_w_margin(state, grid, cfg)[lin], False)


def occupied_filter(state: VoxelMapState, grid: VoxelGrid, cfg: VoxelConfig, points: torch.Tensor) -> torch.Tensor:
    """Points inside the (margin-extended) scene box but not in free space."""
    f32 = dict(dtype=torch.float32, device=points.device)
    bmin = torch.tensor(grid.bbox_min, **f32) - 0.05
    bmax = torch.tensor(grid.bbox_max, **f32) + 0.05
    inside = torch.all(points > bmin, -1) & torch.all(points < bmax, -1)
    return inside & ~in_free_space(state, grid, cfg, points)
