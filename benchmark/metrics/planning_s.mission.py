"""Planning seconds a mission step: the mean over the window's steps of the
planner's phases (`last_plan_times`) without the `utility_*` sub-phases,
which `utility` holds (the arithmetic of `scripts/bench_mission.py`)."""

from harness import arith, readers


def read(ctx):
    return readers.step_mean(ctx, lambda s: arith.planning_s(s["plan_times"]))
