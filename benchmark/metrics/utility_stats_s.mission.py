"""Candidate entry-stats seconds a mission step: the mean over the window's
steps of `plan_times["utility_stats"]` (the planner's own clock, ending in
a host read of a device value); none where the planner renders nothing."""

from harness import readers


def read(ctx):
    steps = ctx["window"].get("steps") or []
    if not steps or not all("utility_stats" in s["plan_times"] for s in steps):
        return None
    return readers.step_mean(ctx, lambda s: s["plan_times"]["utility_stats"])
