"""Simulators (port of `activegs_tpu/sim/`)."""

from .synthetic import BoxRoomSimulator, default_room  # noqa: F401


def get_simulator(cfg, device="cuda"):
    """The simulator that `cfg.simulator.type` names, on `device`."""
    kind = cfg.simulator.type
    if kind == "synthetic":
        return BoxRoomSimulator.from_config(cfg, device=device)
    if kind == "replay":
        raise NotImplementedError(
            "simulator.type=replay: the replay simulator (sim/replay.py) is not ported yet "
            "(ROADMAP.md, queue 1 item 4)"
        )
    raise ValueError(f"unknown simulator type: {kind}")
