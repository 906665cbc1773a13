"""Arithmetic copied from the port's measurement scripts and mapper, frozen
here so that the yardstick does not move with the program:
`scripts/bench_mission.py::_planning`, `scripts/bench.py`'s rays count and
scene ring, `mapping/gaussians.py::bucket_capacity` and
`mapping/trainer.py::pick_subset_bucket` / `pick_entry_bucket`."""

from __future__ import annotations

import numpy as np


def planning_s(plan_times: dict) -> float:
    """A step's planning seconds: its plan phases without the `utility_*`
    sub-phases, which `utility` already holds."""
    return sum(v for k, v in plan_times.items() if not k.startswith("utility_"))


def rays(steps: int, batch: int, h: int, w: int) -> int:
    """The rays of one keyframe's training, as the reference counts them:
    optimization steps x batch size x H x W."""
    return steps * batch * h * w


def bucket_capacity(count: int, full: int, min_cap: int = 1 << 15) -> int:
    """Smallest power-of-two capacity holding `count` with 25% headroom."""
    need = max(int(count * 1.25), min_cap)
    cap = min_cap
    while cap < need:
        cap *= 2
    return min(cap, full)


def _half_step(need: int, b: int) -> int:
    while b < need:
        if b + b // 2 >= need:
            return b + b // 2
        b *= 2
    return b


def subset_bucket(max_in_view: int, capacity: int) -> int | None:
    """A view's subset bucket on the {2^k, 1.5 2^k} ladder from 8192, or
    None where it would not shrink the problem."""
    b = _half_step(max_in_view, 8192)
    return None if b * 2 > capacity else b


def entry_budget(max_entries: int) -> int:
    """The entry budget covering the largest binned entry count, on the same
    ladder from 16384."""
    return _half_step(max_entries, 16384)


def rotation_from_z(z: np.ndarray) -> np.ndarray:
    """A no-roll camera rotation whose z (view) axis is `z`."""
    z = np.asarray(z, np.float64)
    z = z / np.linalg.norm(z)
    x = np.cross(np.array([0.0, 0.0, -1.0]), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y / np.linalg.norm(y), z], axis=-1)
