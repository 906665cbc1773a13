"""Fixed-capacity keyframe buffer + training-frame samplers (port of
`activegs_tpu/mapping/keyframes.py`).

Keyframes live in one device buffer: rgb quantized to uint8, depth to
float16. Chronological rank i lives at physical slot order[i] for the two
image tensors; per-frame metadata stays rank-ordered, so eviction moves only
(F,)-sized arrays and writes one image slot. `add_frame` and
`update_performance` update the buffer in place and return it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing


@dataclasses.dataclass
class KeyframeBuffer:
    rgb: torch.Tensor  # (F, 3, H, W) uint8, physical slots
    depth: torch.Tensor  # (F, 1, H, W) float16, physical slots (sentinels kept)
    order: torch.Tensor  # (F,) int64: physical slot of chronological rank i
    extrinsics: torch.Tensor  # (F, 4, 4), rank-ordered
    intrinsics: torch.Tensor  # (F, 3, 3), rank-ordered
    performance: torch.Tensor  # (F,) tracked rgb+depth error, rank-ordered
    count: int

    @property
    def capacity(self) -> int:
        return self.rgb.shape[0]


def init_buffer(capacity: int, h: int, w: int, device="cuda") -> KeyframeBuffer:
    return KeyframeBuffer(
        rgb=torch.zeros((capacity, 3, h, w), dtype=torch.uint8, device=device),
        depth=torch.zeros((capacity, 1, h, w), dtype=torch.float16, device=device),
        order=torch.arange(capacity, device=device),
        extrinsics=torch.eye(4, device=device).repeat(capacity, 1, 1),
        intrinsics=torch.eye(3, device=device).repeat(capacity, 1, 1),
        performance=torch.zeros(capacity, device=device),
        count=0,
    )


def buffer_from_numpy(d, device="cuda") -> KeyframeBuffer:
    """Buffer from arrays named like the `KeyframeBuffer` fields (e.g. the
    reference buffer's leaves), so both packages can start from one state."""
    t = lambda k, dt: torch.as_tensor(np.array(d[k]), dtype=dt, device=device)  # noqa: E731
    return KeyframeBuffer(
        rgb=t("rgb", torch.uint8),
        depth=t("depth", torch.float16),
        order=t("order", torch.int64),
        extrinsics=t("extrinsics", torch.float32),
        intrinsics=t("intrinsics", torch.float32),
        performance=t("performance", torch.float32),
        count=int(d["count"]),
    )


@torch.no_grad()
def add_frame(buf: KeyframeBuffer, frame: dict) -> KeyframeBuffer:
    """Append a frame with performance 10. At capacity, evict the lowest
    performance (best-learned) keyframe: later frames shift down one rank,
    the victim's physical image slot takes the new frame."""
    rgb_u8 = torch.clamp(frame["rgb"] * 255.0 + 0.5, 0, 255).to(torch.uint8)
    depth_f16 = frame["depth"].to(torch.float16)
    if buf.count < buf.capacity:
        i = buf.count
        slot = int(buf.order[i])
        buf.count += 1
    else:
        victim = int(torch.argmin(buf.performance))
        slot = int(buf.order[victim])
        i = buf.capacity - 1
        for x in (buf.order, buf.extrinsics, buf.intrinsics, buf.performance):
            x[victim:i] = x[victim + 1 :].clone()
        buf.order[i] = slot
    buf.rgb[slot] = rgb_u8
    buf.depth[slot] = depth_f16
    buf.extrinsics[i] = frame["extrinsic"]
    buf.intrinsics[i] = frame["intrinsic"]
    buf.performance[i] = 10.0
    return buf


def decode_frames(buf: KeyframeBuffer, ids: torch.Tensor):
    """Gather + dequantize frames by chronological rank ->
    (rgb f32, depth f32, extrinsics, intrinsics)."""
    slots = buf.order[ids]
    rgb = buf.rgb[slots].to(torch.float32) / 255.0
    depth = buf.depth[slots].to(torch.float32)
    return rgb, depth, buf.extrinsics[ids], buf.intrinsics[ids]


def _draw(buf: KeyframeBuffer, scores_rest: torch.Tensor, batch: int, active: int) -> torch.Tensor:
    """The last `active` keyframes, then the best-scored rest frames (a
    score of -inf marks a frame out of the rest pool); positions the rest
    cannot fill repeat the latest frame."""
    dev = buf.performance.device
    f = buf.count
    n_active = min(active, f)
    idx = torch.arange(batch, device=dev)
    active_ids = torch.clamp(f - 1 - idx, min=0)
    n_rest = max(f - n_active, 0)
    rest_ids = torch.sort(-scores_rest, stable=True).indices[:batch]
    take_rest = min(max(batch - n_active, 0), n_rest)
    pick = torch.clamp(idx - n_active, 0, rest_ids.shape[0] - 1)
    ids = torch.where(idx < n_active, active_ids, rest_ids[pick])
    use = (idx < n_active) | ((idx >= n_active) & (idx < n_active + take_rest))
    ids = torch.where(use, ids, active_ids[0])
    return torch.clamp(ids, 0, max(f - 1, 0))


def sample_weighted(buf: KeyframeBuffer, generator: torch.Generator, batch: int, active: int) -> torch.Tensor:
    """WeightedSampler: the last `active` keyframes plus error-weighted draws
    without replacement (Gumbel top-k) from the rest. `generator` is a CPU
    generator; the draws move to the buffer's device."""
    cap = buf.capacity
    n_rest = max(buf.count - min(active, buf.count), 0)
    with tracing.host_read("sample_weighted.draws"):
        u = torch.rand(cap, generator=generator).to(buf.performance.device)
    in_rest = torch.arange(cap, device=u.device) < n_rest
    weights = torch.where(in_rest, buf.performance + 1e-6, 0.0)
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    scores = torch.where(weights > 0, torch.log(weights) + g, -torch.inf)
    return _draw(buf, scores, batch, active)


def sample_uniform(buf: KeyframeBuffer, generator: torch.Generator, batch: int, active: int) -> torch.Tensor:
    """UniformSampler: the last `active` keyframes plus uniform draws without
    replacement from the older rest."""
    cap = buf.capacity
    n_rest = max(buf.count - min(active, buf.count), 0)
    with tracing.host_read("sample_uniform.draws"):
        u = torch.rand(cap, generator=generator).to(buf.performance.device)
    scores = torch.where(torch.arange(cap, device=u.device) < n_rest, u, -torch.inf)
    return _draw(buf, scores, batch, active)


def update_performance(buf: KeyframeBuffer, ids: torch.Tensor, errors: torch.Tensor) -> KeyframeBuffer:
    """Per-frame mean rgb + depth error feeds the weighted sampler."""
    buf.performance[ids] = errors.to(buf.performance.dtype)
    return buf
