"""BENCHMARK.json and the files its names lead to."""

import ast
import json
import re

import pytest

from harness import cells

ROOT = cells.ROOT
BENCH = cells.BENCH
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]
        assert 1 <= len(c["source"]) <= 200 and len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[k]]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[k]}) == len(SPEC[k])
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in SPEC["end_to_end"] + SPEC["per_layer"])
    assert all(m["better"] in ("lower", "higher") for m in SPEC["end_to_end"] + SPEC["per_layer"])


def test_every_metric_reaches_its_cells():
    cell_names = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cell_names)) <= set(e2e[m["moves"]].get("workloads", cell_names))
        assert "_roofline" not in m["name"] or m["unit"] == "%"
    for name in cell_names:
        cell = cells.find(name, SPEC)
        assert any(m["name"] == "setup_s" for m in cell.end_to_end) and len(cell.end_to_end) >= 2
        assert cell.per_layer
        assert {m["name"] for m in SPEC["configs"]} >= {cell.config_name}


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = cells.find(workload, SPEC)
    assert cell.config["config"]["mapper"]["raster"]["bf16_pairs"] is False
    assert cells.generator(cell).System
    assert cell.limits, "a cell's limits file names the numbers it compares"
    for m in cell.per_layer:
        assert callable(cells.metric_reader(m["name"]))


def test_config_files():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(body["assumed"])


def test_traffic_files_are_data():
    for w in SPEC["workloads"]:
        body = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "harness" / f"{body['generator']}.py").exists()


def test_command_stays_inside_paths():
    cmd = SPEC["command"]
    assert cmd[0] == "python3" and all(not a.startswith("/") and ".." not in a for a in cmd)
    assert all(a.startswith("benchmark/") for a in cmd[1:])


def test_no_jax_import_anywhere():
    """No module under benchmark/ imports jax, jaxlib, flax or the JAX
    package, compared by whole top-level names; the reference imports
    nothing of the program either."""
    bad = {"jax", "jaxlib", "flax", "activegs_tpu"}
    for path in BENCH.rglob("*.py"):
        tops = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops.add(node.module.split(".")[0])
        assert not tops & bad, (path, tops & bad)
        if "reference" in path.parts:
            assert "activegs_torch" not in tops, path


def test_names_are_whole_not_prefixes():
    """The port's name starts with the JAX package's: the check compares
    whole top-level names."""
    import run

    assert "activegs_torch".split(".")[0] not in run.FORBIDDEN
    assert "activegs_tpu" in run.FORBIDDEN


def test_mission_cells_kept_for_later_are_whole():
    """The mission cells left out of BENCHMARK.json (PERF.md, Open
    questions) keep their files, for the change that adds them back."""
    extra = json.loads((BENCH / "tests" / "mission_cells.json").read_text())
    spec = {k: SPEC[k] + extra.get(k, []) if isinstance(SPEC[k], list) else SPEC[k] for k in SPEC}
    for c in extra["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in extra["workloads"]:
        cell = cells.find(w["name"], spec)
        assert cell.limits and cells.generator(cell).System
        assert len(cell.per_layer) >= 5
        for m in cell.per_layer:
            assert callable(cells.metric_reader(m["name"]))
