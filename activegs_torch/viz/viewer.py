"""Mission viewer: PNG panels of the map state (port of
`activegs_tpu/viz/viewer.py`).

The six render channels (rgb, depth, confidence / opacity, normal,
depth-to-normal), a top view of the voxel map's masks and the executed
path, written per step as PNG files (`io/png.py`, no PIL). The renders run
on the map's device through `render_view` (so the forward compositor
kernel on the card); the panel arithmetic is numpy on the host, as in the
reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.image_ops import depth_to_normal
from ..io.png import write_png
from ..mapping import gaussians as gm
from ..mapping import voxel_map as vm
from ..render.renderer import render_view
from ..render.types import Camera, RasterConfig


def _np(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _colormap(x: np.ndarray, lo=None, hi=None) -> np.ndarray:
    """Jet-like colormap of a scalar map, (h, w) -> (h, w, 3)."""
    lo = np.nanmin(x) if lo is None else lo
    hi = np.nanmax(x) if hi is None else hi
    t = np.clip((x - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return np.stack([r, g, b], -1)


def channel_images(out, intrinsic) -> dict:
    """The render's channels as host arrays: rgb / normal / d2n (h, w, 3),
    depth / confidence / opacity (h, w)."""
    d2n = depth_to_normal(out.depth[0], out.opacity[0] > 1e-2, intrinsic)
    return {
        "rgb": np.clip(_np(out.rgb).transpose(1, 2, 0), 0, 1),
        "depth": _np(out.depth[0]),
        "confidence": _np(out.confidence[0]),
        "opacity": _np(out.opacity[0]),
        "normal": _np(out.normal).transpose(1, 2, 0),
        "d2n": _np(d2n),
    }


def panel_of(ch: dict, depth_range=(0.0, 5.0)) -> np.ndarray:
    """(2h, 3w, 3) uint8: rgb | depth | confidence over opacity | normal |
    d2n."""
    row1 = np.concatenate([ch["rgb"], _colormap(ch["depth"], *depth_range), _colormap(ch["confidence"], 0, 1)], axis=1)
    row2 = np.concatenate([_colormap(ch["opacity"], 0, 1), 0.5 * (ch["normal"] + 1.0), 0.5 * (ch["d2n"] + 1.0)], axis=1)
    panel = np.concatenate([row1, row2], axis=0)
    return (np.clip(panel, 0, 1) * 255).astype(np.uint8)


@torch.no_grad()
def render_channel_panel(
    gm_state,
    map_cfg,
    camera: Camera,
    shape,
    raster_cfg: RasterConfig = RasterConfig(),
    depth_range=(0.0, 5.0),
) -> np.ndarray:
    """(2h, 3w, 3) uint8 panel of one view of the map: rgb | depth |
    confidence over opacity | normal | depth-to-normal."""
    out, _ = render_view(gm.attrs_of(gm_state, map_cfg), camera, shape, raster_cfg)
    return panel_of(channel_images(out, camera.intrinsic), depth_range)


def voxel_top_view(vstate, grid, voxel_cfg, px_per_voxel: int = 4) -> np.ndarray:
    """Top-down summary of the voxel masks: free (green), occupied (red),
    unknown (gray), frontier (blue), ROI (magenta)."""
    free = _np(vm.free_mask(vstate, voxel_cfg)).reshape(grid.dim)
    occ = _np(vm.occ_mask(vstate, voxel_cfg)).reshape(grid.dim)
    frontier = _np(vm.frontier_mask(vstate, grid, voxel_cfg)).reshape(grid.dim)
    roi = _np(vstate.roi_mask).reshape(grid.dim)

    img = np.full(tuple(grid.dim[:2]) + (3,), 0.5, np.float32)
    img[free.any(2)] = [0.2, 0.8, 0.2]
    img[occ.any(2)] = [0.85, 0.2, 0.2]
    img[frontier.any(2)] = [0.2, 0.4, 0.9]
    img[roi.any(2)] = [0.9, 0.2, 0.9]
    img = np.repeat(np.repeat(img, px_per_voxel, 0), px_per_voxel, 1)
    return (img * 255).astype(np.uint8)


def _draw_line(img: np.ndarray, p0, p1, color) -> None:
    """Sample-based line in voxel-pixel coordinates ((row, col) floats)."""
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1])) * 2) + 2
    t = np.linspace(0.0, 1.0, n)
    rows = np.clip((p0[0] + t * (p1[0] - p0[0])).astype(int), 0, img.shape[0] - 1)
    cols = np.clip((p0[1] + t * (p1[1] - p0[1])).astype(int), 0, img.shape[1] - 1)
    img[rows, cols] = color


def _draw_dot(img: np.ndarray, p, color, r: int = 1) -> None:
    r0 = slice(max(int(p[0]) - r, 0), int(p[0]) + r + 1)
    c0 = slice(max(int(p[1]) - r, 0), int(p[1]) + r + 1)
    img[r0, c0] = color


def scene_overlay(
    vstate,
    grid,
    voxel_cfg,
    exec_path: np.ndarray | None = None,
    planned_path: np.ndarray | None = None,
    candidates: np.ndarray | None = None,
    nbv: np.ndarray | None = None,
    camera=None,
    px_per_voxel: int = 4,
    frustum_len: float = 1.5,
) -> np.ndarray:
    """The voxel top view with the mission's overlays: executed path
    (white), planned path (yellow), candidate poses (cyan), the chosen view
    (magenta) and the camera's field of view (orange). World (x, y) maps
    to image (row, col)."""
    img = voxel_top_view(vstate, grid, voxel_cfg, px_per_voxel).astype(np.float32) / 255.0
    bbox_min = np.asarray(grid.bbox_min)[:2]
    size = np.asarray(grid.size)[:2]

    def to_px(pos):
        pos = np.asarray(pos, np.float32).reshape(-1, 3)
        return (pos[:, :2] - bbox_min) / size * px_per_voxel

    if exec_path is not None and len(exec_path) > 1:
        pts = to_px(exec_path)
        for a, b in zip(pts[:-1], pts[1:]):
            _draw_line(img, a, b, [1.0, 1.0, 1.0])
    if planned_path is not None and len(planned_path) > 1:
        pts = to_px(np.asarray(planned_path)[:, :3, 3])
        for a, b in zip(pts[:-1], pts[1:]):
            _draw_line(img, a, b, [1.0, 0.9, 0.1])
    if candidates is not None and len(candidates):
        for p in to_px(np.asarray(candidates)[:, :3, 3]):
            _draw_dot(img, p, [0.1, 0.9, 0.95], r=1)
    if nbv is not None:
        _draw_dot(img, to_px(np.asarray(nbv)[:3, 3])[0], [1.0, 0.2, 1.0], r=2)
    if camera is not None:
        ext = _np(camera.extrinsic).astype(np.float32)
        intr = _np(camera.intrinsic).astype(np.float32)
        # the field of view's edge rays in the camera's xz-plane, projected
        # to world (x, y)
        half = np.arctan2(intr[0, 2], intr[0, 0])
        origin = ext[:3, 3]
        for s in (-1.0, 1.0):
            d = ext[:3, :3] @ np.array([np.sin(s * half), 0.0, np.cos(s * half)], np.float32)
            tip = origin + frustum_len * d
            _draw_line(img, to_px(origin)[0], to_px(tip)[0], [1.0, 0.55, 0.1])
        _draw_dot(img, to_px(origin)[0], [1.0, 0.55, 0.1], r=2)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


class MissionViewer:
    """A mapper's `viewer`: writes `channels_XXX.png` (the frame's view of
    the map) and `voxels_XXX.png` every `every` steps into `out_dir`."""

    def __init__(self, out_dir: str, every: int = 1, shape=(256, 256)):
        self.out_dir = out_dir
        self.every = every
        self.shape = shape
        os.makedirs(out_dir, exist_ok=True)

    def on_step(self, mapper, frame, path, stats) -> None:
        if stats["frame_id"] % self.every:
            return
        cam = Camera(extrinsic=frame["extrinsic"], intrinsic=frame["intrinsic"])
        panel = render_channel_panel(
            mapper.gm_state, mapper.map_cfg, cam, self.shape, mapper.raster_cfg,
            depth_range=tuple(_np(frame["depth_range"]).tolist()),
        )
        write_png(os.path.join(self.out_dir, f"channels_{stats['frame_id']:03d}.png"), panel)
        top = voxel_top_view(mapper.vm_state, mapper.grid, mapper.voxel_cfg)
        write_png(os.path.join(self.out_dir, f"voxels_{stats['frame_id']:03d}.png"), top)
