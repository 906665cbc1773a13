"""What the per-layer metric readers (`metrics/<name>.py`) share. Each
takes the run's context: `window` (the generator's window record: a
mission's `steps` stats and `sensing` seconds), `trace` (the profiled
lap's session, None in a `--trace 0` run) and `work` (each compositor
call of the profiled lap: its live pairs, `roofline.live_pairs`; `units`,
the keyframes or steps the profiled stretch ran). Each
returns None where it finds nothing to read."""

from __future__ import annotations

import statistics

from . import roofline
from .trace import kernel_times

KERNELS = {"fwd": r"(^|\W)fwd_kernel(\W|$)", "bwd": r"(^|\W)bwd_kernel(\W|$)"}


def step_mean(ctx, fn):
    """The mean over the window's mission steps of fn(step stats)."""
    steps = ctx["window"].get("steps")
    if not steps:
        return None
    return statistics.fmean(fn(s) for s in steps)


def _calls(ctx, kind: str):
    """[(live-pair record, pixels a tile)] of each call of `kind` in launch
    order."""
    w = ctx["work"]
    if not w:
        return []
    if kind == "fwd":
        return list(zip(w["fwd"], w["tile_pixels"]))
    return [(w["fwd"][i], w["tile_pixels"][i]) for i in w["bwd"] if i is not None]


def roofline_share(ctx, kind: str):
    """100 x the least time of the work the kernel's inputs needed over its
    device time, summed over its launches in the profiled lap (the last
    launches, where the trace recorded fewer than were made)."""
    tr = ctx["trace"]
    calls = _calls(ctx, kind)
    if not tr or not tr["ops"] or not calls:
        return None
    times = kernel_times(tr, KERNELS[kind])
    n = min(len(times), len(calls))
    if n == 0:
        return None
    least = sum(roofline.least_seconds(kind, work, px) for work, px in calls[len(calls) - n:])
    return 100.0 * least / sum(times[len(times) - n:])


def step_mfu(ctx):
    """100 x the operations that the compositor calls' inputs needed
    (forward and backward), a unit of work (keyframe, mission step) as the
    profiled stretch counted them, times the window's units, over the
    window's wall seconds at the FP32 peak. The window is the timed one,
    before the profiler: a profiler session slows the host, so its own
    seconds would read low."""
    w, win = ctx["work"], ctx["window"]
    if not w or not w.get("units") or not win.get("wall_s"):
        return None
    ops = sum(roofline.flops(k, x) for k in ("fwd", "bwd") for x, _ in _calls(ctx, k))
    if ops == 0:
        return None
    return 100.0 * ops / w["units"] * win["units"] / (win["wall_s"] * roofline.PEAK_FLOPS)


def idle_share(ctx):
    """100 x (1 - device busy seconds / the profiled window's seconds)."""
    tr = ctx["trace"]
    if not tr or not tr.get("window_s") or not tr["ops"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def sensing(ctx):
    xs = ctx["window"].get("sensing")
    return statistics.fmean(xs) if xs else None
