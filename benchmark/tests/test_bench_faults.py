"""A whole run of each cell at a tiny size on the CPU (the look for a card
skipped, the kernels' plain versions in their place), once sound and once
with each fault the cell can have planted in the timed path underneath:
`correct` must come out true, then false. The faults: a step that returns
its state unchanged (Adam's step does nothing); half of the view batch
left out, the mean taken over the rest; an answer altered where it is
produced (the planner's chosen view, or a rendered tile's colours). One
chip: no exchange between chips to leave out.

The mission cells (`mission_cells.json`, out of BENCHMARK.json until the
program's backward is repaired: PERF.md, Open questions) run only with
their faults planted: the program's sound runs of them read gradient gaps
above their limits on some seeds, at this size too."""

import json
from pathlib import Path

import pytest
import torch

import run
from harness import cells, faults


def spec_with_missions() -> dict:
    spec = cells.benchmark_spec()
    extra = json.loads((Path(__file__).parent / "mission_cells.json").read_text())
    return {k: spec[k] + extra.get(k, []) if isinstance(spec[k], list) else spec[k] for k in spec}

TINY = {"simulator.sensor.resolution": [32, 32], "mapper.gaussian_map.capacity": 4096,
        "planner.sample_num": 4, "planner.max_roi_sample_num": 2}
SIZES = {
    "train-bench-200k": {"traffic.surfels": 1500, "traffic.keyframes": 4},
    "mission-confidence-boxroom": {"traffic.snapshot_after": 3, "traffic.lap_steps": 2, "traffic.warm_laps": 0},
    "mission-random-boxroom": {"traffic.snapshot_after": 3, "traffic.lap_steps": 2, "traffic.warm_laps": 0},
}


CASES = [("train-bench-200k", None)] + [
    ("train-bench-200k", "unchanged"), ("train-bench-200k", "half_batch"), ("train-bench-200k", "altered_tile"),
    ("mission-confidence-boxroom", "unchanged"), ("mission-confidence-boxroom", "half_batch"),
    ("mission-confidence-boxroom", "altered_choice"),
    ("mission-random-boxroom", "unchanged"), ("mission-random-boxroom", "half_batch"),
    ("mission-random-boxroom", "altered_tile"),
]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_fails_the_check(workload, fault, monkeypatch):
    torch.set_num_threads(4)
    if fault:
        monkeypatch.setattr(*faults.FAULTS[fault]())
    out = run.run(workload, 2**31 + 12345, 0.01, False, device="cpu", overrides={**TINY, **SIZES[workload]},
                  spec=spec_with_missions())
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] >= 1
