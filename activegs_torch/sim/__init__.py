"""Simulators (port of `activegs_tpu/sim/`)."""

from .replay import ReplaySimulator  # noqa: F401
from .synthetic import BoxRoomSimulator, default_room  # noqa: F401


def get_simulator(cfg, device="cuda"):
    """The simulator that `cfg.simulator.type` names, on `device`."""
    kind = cfg.simulator.type
    if kind == "synthetic":
        return BoxRoomSimulator.from_config(cfg, device=device)
    if kind == "replay":
        return ReplaySimulator.from_config(cfg, device=device)
    raise ValueError(f"unknown simulator type: {kind}")
