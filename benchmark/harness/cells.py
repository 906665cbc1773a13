"""A cell's files, found by the names in `BENCHMARK.json`:
`configs/<config>.json`, `traffic/<mix>.json` (its `generator` names a
module of this package), `limits/<workload>.json` and one reader
`metrics/<metric>.py` a per-layer metric."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict  # the configuration file
    traffic_name: str
    traffic: dict  # the traffic file
    limits: dict  # {number: limit}
    end_to_end: list  # the metric entries of BENCHMARK.json this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(name: str, spec: dict | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files. Raises KeyError
    for a name that is not a cell."""
    spec = spec or benchmark_spec()
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; have {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if m["moves"] in moved and _reports(m, name)]
    return Cell(
        name=name, chips=w["chips"], config_name=w["config"], config=load_json(ROOT / conf["file"]),
        traffic_name=w["traffic"], traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{name}.json"), end_to_end=e2e, per_layer=layer,
    )


def generator(cell: Cell):
    """The traffic generator module the cell's mix names."""
    return importlib.import_module(f"harness.{cell.traffic['generator']}")


def metric_reader(name: str):
    """`read(ctx)` of `metrics/<name>.py`: the metric's value from the run's
    context, or None where it finds nothing to read."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
