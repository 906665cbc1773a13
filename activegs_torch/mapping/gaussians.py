"""Gaussian-surfel map: fixed-capacity store + spawn / confidence / prune
(port of `activegs_tpu/mapping/gaussians.py`).

The map is a static-capacity struct of tensors with a live prefix —
gaussians [0, count) are alive — and `count` is a host integer. Spawn
appends into the prefix, prune compacts it with one stable sort, and the
mapping step runs on capacity buckets (`bucket_capacity`/`slice_state`/
`write_back`) exactly as the reference does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing
from ..core import geometry as geo
from ..core import image_ops
from ..core import quaternions as quat
from ..render.renderer import render_view
from ..render.types import Camera, GaussianAttrs, RasterConfig

# pre-activation third scale: exp(-20) * scale_factor ~ 2e-11 m, the surfel's
# flat axis
FLAT_SCALE_RAW = -20.0

FIELDS = (
    "means", "scales_raw", "rotations_raw", "opacities_raw", "colors",
    "view_scores", "view_supports", "view_means",
)


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Map configuration (`activegs_tpu/config/mapper/incremental.yaml`)."""

    capacity: int = 1 << 19
    bound: tuple[float, float] = (0.001, 10.0)
    background: tuple[float, float, float] = (0.0, 0.0, 0.0)
    error_thres: float = 0.25
    scale_factor: float = 0.01
    scale_max: float = 0.05
    optimization_steps: int = 10
    prune_interval: int = 5
    prune_opacity: float = 0.1
    prune_occupancy: float = 0.95  # early prune above this count/capacity
    # mission-loop warning threshold on the tile-entry truncation fraction
    warn_dropped_frac: float = 0.10
    use_view_distribution: bool = True
    spawn_voxel_size: float = 0.02
    batch_size: int = 8
    active_size: int = 3
    # draw a fresh view batch and bin it anew at every Adam step, as the
    # original system does, instead of one batch with frozen bins a keyframe
    resample_per_step: bool = False
    # render a train step's views through one forward and one backward
    # compositor launch (`renderer.render_views_batched`); honored where the
    # views render compacted subsets (`subset_bucket` set), as in the
    # reference; off by default
    fused_view_kernel: bool = False
    mean_lr: float = 5e-4
    rotation_lr: float = 5e-4
    opacity_lr: float = 1e-2
    scale_lr: float = 1e-2
    harmonic_lr: float = 1e-4
    bilateral_radius: int = 7


@dataclasses.dataclass(frozen=True)
class GaussianMapState:
    """Raw (pre-activation) parameters + confidence statistics + live count."""

    means: torch.Tensor  # (CAP, 3)
    scales_raw: torch.Tensor  # (CAP, 3) log-scale
    rotations_raw: torch.Tensor  # (CAP, 4)
    opacities_raw: torch.Tensor  # (CAP,) logit
    colors: torch.Tensor  # (CAP, 3)
    view_scores: torch.Tensor  # (CAP,)
    view_supports: torch.Tensor  # (CAP,)
    view_means: torch.Tensor  # (CAP, 3)
    count: int

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def alive(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.means.device) < self.count


def init_state(cfg: MapConfig, device="cuda") -> GaussianMapState:
    cap = cfg.capacity
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    q0 = z(cap, 4)
    q0[:, 0] = 1.0
    return GaussianMapState(
        means=z(cap, 3), scales_raw=z(cap, 3), rotations_raw=q0, opacities_raw=z(cap),
        colors=z(cap, 3), view_scores=z(cap), view_supports=z(cap), view_means=z(cap, 3),
        count=0,
    )


def state_from_numpy(d, device="cuda", capacity: int | None = None) -> GaussianMapState:
    """State from arrays named like the `GaussianMapState` fields, holding
    the live prefix — the keys `activegs_tpu/io/checkpoint.py` writes, so a
    reference map checkpoint loads here. Free slots get `init_state` values."""
    n = len(d["means"])
    state = init_state(MapConfig(capacity=capacity or n), device)
    if state.capacity < n:
        raise ValueError(f"capacity {state.capacity} < {n} gaussians")
    for f in FIELDS:
        getattr(state, f)[:n] = torch.tensor(np.asarray(d[f], np.float32), device=device)
    return dataclasses.replace(state, count=n)


def state_to_numpy(state: GaussianMapState) -> dict:
    """The live prefix of every field as numpy arrays (checkpoint keys)."""
    n = state.count
    return {f: getattr(state, f)[:n].detach().cpu().numpy() for f in FIELDS}


def bucket_capacity(count: int, full_capacity: int, min_cap: int = 1 << 15) -> int:
    """Smallest power-of-two capacity holding count with 25% headroom."""
    need = max(int(count * 1.25), min_cap)
    cap = min_cap
    while cap < need:
        cap *= 2
    return min(cap, full_capacity)


def slice_state(state: GaussianMapState, cap: int) -> GaussianMapState:
    """View of the first `cap` slots (requires count <= cap)."""
    if cap >= state.capacity:
        return state
    return dataclasses.replace(state, **{f: getattr(state, f)[:cap] for f in FIELDS})


def write_back(full: GaussianMapState, sub: GaussianMapState) -> GaussianMapState:
    """Merge a processed slice back into the full-capacity state (in place
    on `full`'s tensors)."""
    if sub.capacity >= full.capacity:
        return sub
    with torch.no_grad():
        for f in FIELDS:
            getattr(full, f)[: sub.capacity] = getattr(sub, f)
    return dataclasses.replace(full, count=sub.count)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


def activate_scales(scales_raw: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    return torch.clamp(cfg.scale_factor * torch.exp(scales_raw), 0.0, cfg.scale_max)


def confidences_of(state: GaussianMapState, cfg: MapConfig) -> torch.Tensor:
    """View-distribution factor x accumulated view score, clamped to [0, 1];
    ablation variant 1 - exp(-supports)."""
    if cfg.use_view_distribution:
        view_var = torch.sqrt(torch.sum(state.view_means * state.view_means, dim=-1))
        view_var = torch.where(torch.isnan(view_var), 1.0, view_var)
        return torch.clamp(torch.exp(1.0 - view_var) * state.view_scores, 0.0, 1.0)
    return torch.clamp(1.0 - torch.exp(-state.view_supports), 0.0, 1.0)


def normals_of(state: GaussianMapState) -> torch.Tensor:
    """World normals = third column of R(q)."""
    return quat.quaternion_to_matrix(quat.normalize(state.rotations_raw))[..., :, 2]


def attrs_of(state: GaussianMapState, cfg: MapConfig) -> GaussianAttrs:
    """Activated attributes; confidences are detached (non-trainable)."""
    return GaussianAttrs(
        means=state.means,
        scales=activate_scales(state.scales_raw, cfg),
        rotations=quat.normalize(state.rotations_raw),
        opacities=torch.sigmoid(state.opacities_raw),
        colors=state.colors,
        confidences=confidences_of(state, cfg).detach(),
        valid=state.alive,
    )


# ---------------------------------------------------------------------------
# spawn
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF


def _voxel_dedup_mask(points: torch.Tensor, select: torch.Tensor, voxel: float) -> torch.Tensor:
    """Keep at most one selected point per voxel: the first in hash order
    (stable, so the lowest pixel index) of each hash. The hash wraps in 32
    bits like the reference's int32 products."""
    ids = torch.floor(points / voxel).to(torch.int32).to(torch.int64)
    h = (
        ((ids[:, 0] * 73856093) & _U32)
        ^ ((ids[:, 1] * 19349663) & _U32)
        ^ ((ids[:, 2] * 83492791) & _U32)
    )
    key = torch.where(select, h, _U32)
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=sk.device), sk[1:] != sk[:-1]])
    first &= sk != _U32
    keep = torch.zeros_like(select)
    keep[order] = first
    return keep & select


@torch.no_grad()
def spawn(
    state: GaussianMapState,
    frame: dict,
    cfg: MapConfig,
    raster_cfg: RasterConfig,
    render_bucket: int | None = None,
):
    """Spawn surfels from a posed RGB-D frame: bilateral-smoothed depth ->
    normals; back-project valid camera-facing pixels; keep pixels the
    current map renders badly (rgb error, low opacity, occluded depth);
    2 cm voxel dedup; append with opacity logit 0, flat third scale and
    normal-aligned quaternions. `render_bucket` (>= count) runs the
    error-mask render on the sliced live prefix (exact). Returns
    (state, n_new, n_dropped); n_dropped counts survivors that did not fit.
    Writes the new slots in place."""
    rgb = frame["rgb"]
    depth = frame["depth"]
    extrinsic = frame["extrinsic"]
    intrinsic = frame["intrinsic"]
    _, h, w = rgb.shape
    dev = rgb.device

    valid = (depth[0] > 0.0).reshape(-1)
    depth_smooth = image_ops.bilateral_filter(depth[0], radius=cfg.bilateral_radius)
    normals_cam = image_ops.depth_to_normal(depth_smooth, depth[0] > 0.0, intrinsic).reshape(-1, 3)
    valid &= torch.sum(normals_cam**2, dim=-1) > 0.0
    normals_world = geo.apply_rotation(extrinsic[:3, :3], normals_cam)

    coords = geo.pixel_grid(h, w, device=dev).reshape(-1, 2)
    origins, dirs = geo.get_world_rays(coords, extrinsic, intrinsic)
    points = origins + dirs * depth[0].reshape(-1, 1)
    dirs_n = quat.normalize(dirs)
    valid &= torch.sum(dirs_n * normals_world, dim=-1) < -0.01

    cam = Camera(extrinsic=extrinsic, intrinsic=intrinsic)
    rstate = state if render_bucket is None else slice_state(state, render_bucket)
    pred, _ = render_view(
        attrs_of(rstate, cfg), cam, (h, w), raster_cfg,
        background=torch.tensor(cfg.background, dtype=torch.float32, device=dev),
    )
    rgb_err = torch.mean((rgb - pred.rgb) ** 2, dim=0)
    need = rgb_err > cfg.error_thres
    need |= pred.opacity[0] < 0.5
    need |= (depth[0] - pred.depth[0]) < -0.05 * depth[0]
    select = valid & need.reshape(-1)

    keep = _voxel_dedup_mask(points, select, cfg.spawn_voxel_size)
    q_new, _ = quat.normal_to_quaternion(normals_world)
    keep &= torch.all(torch.isfinite(q_new), dim=-1)

    idx = torch.nonzero(keep).squeeze(1)
    n_want = idx.shape[0]
    n_new = min(n_want, state.capacity - state.count)
    idx = idx[:n_new]
    s = slice(state.count, state.count + n_new)
    state.means[s] = points[idx]
    state.scales_raw[s] = torch.tensor([0.0, 0.0, FLAT_SCALE_RAW], device=dev)
    state.rotations_raw[s] = q_new[idx]
    state.opacities_raw[s] = 0.0
    state.colors[s] = rgb.reshape(3, -1).T[idx]
    state.view_scores[s] = 0.0
    state.view_supports[s] = 0.0
    state.view_means[s] = 0.0
    return dataclasses.replace(state, count=state.count + n_new), n_new, n_want - n_new


# ---------------------------------------------------------------------------
# confidence statistics + prune
# ---------------------------------------------------------------------------


@torch.no_grad()
def update_confidence(
    state: GaussianMapState,
    cfg: MapConfig,
    cam_pos: torch.Tensor,
    depth_far,
    visible_count: torch.Tensor,
) -> GaussianMapState:
    """Welford-style view statistics for the latest view: supports +=
    visible; running mean of unit view directions; view_scores +=
    (1 - d / d_far) * max(0, n . v)."""
    update = (visible_count >= 1) & state.alive
    supports = state.view_supports + update.to(torch.float32)
    view_dirs = cam_pos[None, :] - state.means
    dist = torch.sqrt(torch.sum(view_dirs * view_dirs, dim=-1))
    view_dirs = view_dirs / torch.clamp(dist[:, None], min=1e-12)
    delta = view_dirs - state.view_means
    view_means = torch.where(
        update[:, None], state.view_means + delta / torch.clamp(supports[:, None], min=1.0), state.view_means
    )
    cos = torch.clamp(torch.sum(normals_of(state) * view_dirs, dim=-1), 0.0, 1.0)
    dist_factor = torch.clamp(dist / depth_far, 0.0, 1.0)
    scores = torch.where(update, state.view_scores + (1.0 - dist_factor) * cos, state.view_scores)
    if not cfg.use_view_distribution:
        view_means = state.view_means
        scores = state.view_scores
    return dataclasses.replace(state, view_supports=supports, view_means=view_means, view_scores=scores)


@torch.no_grad()
def prune(state: GaussianMapState, cfg: MapConfig, visible_any: torch.Tensor):
    """Remove gaussians invisible to every keyframe or with opacity < 0.1,
    then compact the live prefix with one stable sort. Returns
    (new_state, n_pruned)."""
    keep = state.alive & visible_any & (torch.sigmoid(state.opacities_raw) >= cfg.prune_opacity)
    with tracing.host_read("prune.count"):
        n_keep = int(keep.sum())
    perm = torch.sort((~keep).to(torch.int8), stable=True).indices
    new = dataclasses.replace(state, count=n_keep, **{f: getattr(state, f)[perm] for f in FIELDS})
    return new, state.count - n_keep
