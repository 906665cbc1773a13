"""Next-best-view planners (port of `activegs_tpu/planning/`)."""

from .confidence import ConfidencePlanner  # noqa: F401
from .exploration import ExplorationPlanner  # noqa: F401
from .planner import PlanBase, PlannerConfig  # noqa: F401
from .random_planner import RandomPlanner  # noqa: F401


def get_planner(planner_cfg: PlannerConfig, *args, **kwargs):
    """The planner named by `planner_cfg.type`."""
    table = {
        "confidence": ConfidencePlanner,
        "exploration": ExplorationPlanner,
        "random": RandomPlanner,
    }
    return table[planner_cfg.type](planner_cfg, *args, **kwargs)
