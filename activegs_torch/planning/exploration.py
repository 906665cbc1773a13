"""Exploration planner: the visible-unexplored-voxel utility alone (port of
`activegs_tpu/planning/exploration.py`)."""

from __future__ import annotations

from .confidence import candidate_utilities
from .planner import PlanBase


class ExplorationPlanner(PlanBase):
    def cal_utility(self, gm_state, vstate, grid, candidates, simulator):
        explore, _, t = candidate_utilities(
            self, gm_state, vstate, grid, candidates, simulator, explore_only=True
        )
        return explore, t
