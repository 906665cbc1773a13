"""Random planner baseline: uniform utilities (port of
`activegs_tpu/planning/random_planner.py`)."""

from __future__ import annotations

from .planner import PlanBase


class RandomPlanner(PlanBase):
    def cal_utility(self, gm_state, vstate, grid, candidates, simulator):
        return self.rng.uniform(size=len(candidates)), 0.0
