"""Plain reference of the confidence planner's candidate utilities and its
view choice: each candidate rendered at render_ratio of the sensor with
the utility raster settings; explore = the share of voxels in the
candidate's frustum, in front of its rendered surface and unexplored;
exploit = the mean of (1 - confidence) * depth / far over its pixels; the
score = explore_weight * explore + exploit normalised over the candidates,
less path_length_factor times the normalised path length."""

from __future__ import annotations

import numpy as np
import torch

from . import raster


def voxel_grid(bbox, resolution):
    """(bbox_min, dim, size, centres (V, 3) float32) of the voxel grid over
    the scene box: dim = ceil(extent / resolution), size = extent / dim."""
    bmin = np.asarray(bbox[0], np.float64)
    extent = np.asarray(bbox[1], np.float64) - bmin
    dim = np.ceil(extent / np.asarray(resolution)).astype(int)
    size = extent / dim
    idx = np.stack(np.meshgrid(*[np.arange(d) for d in dim], indexing="ij"), axis=-1).reshape(-1, 3)
    return bmin, dim, size, np.asarray(bmin + (idx + 0.5) * size, np.float32)


def visible_voxels(centres: torch.Tensor, ext, intr, depth: torch.Tensor) -> torch.Tensor:
    """Voxels whose centre projects inside the image in front of the camera
    and nearer than the depth at its pixel (pixel indices truncated)."""
    h, w = depth.shape
    w2c = raster.invert_rigid(ext)
    r = w2c[:3, :3]
    pc = r[:, 0] * centres[:, 0:1] + r[:, 1] * centres[:, 1:2] + r[:, 2] * centres[:, 2:3] + w2c[:3, 3]
    z = pc[:, 2]
    eps = torch.finfo(torch.float32).eps
    x = (pc[:, 0] / (z + eps) * intr[0, 0] + intr[0, 2]) * w
    y = (pc[:, 1] / (z + eps) * intr[1, 1] + intr[1, 2]) * h
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    xi = torch.clamp(x.to(torch.int32), 0, w - 1).long()
    yi = torch.clamp(y.to(torch.int32), 0, h - 1).long()
    d = torch.where(inside, depth[yi, xi], -1.0)
    return (z > 0) & inside & (d > z)


@torch.no_grad()
def utilities(a: dict, candidates: torch.Tensor, intr, shape, rc: raster.Raster, unexplored: torch.Tensor,
              centres: torch.Tensor, depth_range) -> tuple[torch.Tensor, torch.Tensor]:
    """(explore (N,), exploit (N,)) of the candidate views (N, 4, 4)."""
    lo, hi = depth_range
    n_vox = centres.shape[0]
    ex, xp = [], []
    for c in candidates:
        o, _ = raster.render(a, c, intr, shape, rc)
        depth, conf = o["depth"][0], o["confidence"][0]
        dv = torch.clamp(torch.where(depth < 0.001, 1e4, depth), lo, hi)
        ex.append(torch.sum(visible_voxels(centres, c, intr, dv) & unexplored) / n_vox)
        conf = torch.where(depth > hi, 1.0, conf)
        surf = torch.where(depth < 0.001, hi * 0.5, depth)
        xp.append(torch.mean((1.0 - conf) * surf / hi))
    return (torch.nan_to_num(torch.stack(ex), nan=0.0), torch.nan_to_num(torch.stack(xp), nan=0.0))


def scores(utility: np.ndarray, lengths: np.ndarray, path_length_factor: float) -> np.ndarray:
    """The candidates' scores: utility over its sum, less the factor times
    the path length over the sum of the reachable lengths (an unreachable
    candidate's length counts 1e7)."""
    lengths = np.asarray(lengths, np.float64)
    ok = ~np.isinf(lengths)
    total = lengths[ok].sum()
    norm = lengths / total if total > 0 else lengths.copy()
    norm[~ok] = 1e7
    u = np.asarray(utility, np.float64)
    u = u / u.sum() if u.sum() > 0 else u
    u[np.isnan(u)] = 0.0
    return u - path_length_factor * norm
