"""The port's mission entry point against the reference's: the YAML subset
parser, the copied configs, `build_components`, `from_config`, and
`python -m activegs_torch.apps.main` on the CPU (`device=cpu`).

The reference's loader reads its files with PyYAML (present here), which
is the yardstick of the port's own parser and emitter.
"""

import dataclasses
import glob
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from activegs_torch.apps import common as tcommon
from activegs_torch.apps import main as tmain
from activegs_torch.config import build_components, load_config, yaml_subset
from activegs_torch.io import checkpoint as tckpt
from activegs_torch.sim import get_simulator
from activegs_tpu.config import build_components as j_build_components
from activegs_tpu.config import load_config as j_load_config
from activegs_tpu.sim.synthetic import BoxRoomSimulator as JBoxRoom

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT_CONF = ROOT / "activegs_torch" / "config"
REF_CONF = ROOT / "activegs_tpu" / "config"
GROUPS = ("mapper", "planner", "scene/synthetic", "simulator")
FILES = ["main.yaml"] + sorted(str(p.relative_to(REF_CONF)) for g in GROUPS for p in (REF_CONF / g).glob("*.yaml"))
# the overrides of the reference's CLI test (`tests/test_apps.py:223-275`),
# with the sensor resolution that `from_config` reads
CLI_OVERRIDES = [
    "simulator.sensor.resolution=[64,64]",
    "mapper.gaussian_map.capacity=4096",
    "mapper.gaussian_map.optimization_steps=2",
    "mapper.gaussian_map.bilateral_radius=2",
    "mapper.keyframe_capacity=8",
    "planner.sample_num=8",
    "planner.max_roi_sample_num=0",
    "mapper.raster.entry_budget_mult=4.0",
    "max_steps=2",
]
OVERRIDE_VALUES = ["[64,64]", "4096", "2", "8", "0", "4.0", "true", "cpu", "confidence", "/tmp/out/exp",
                   "[32,32]", "synthetic/boxroom_holes", "null", "0.5", "1e-4", "[[0, 0, 1, 0], [-1, 0, 0, 0]]"]


@pytest.mark.parametrize("name", FILES)
def test_parser_equals_safe_load_and_files_are_copies(name):
    """Each copied config: byte for byte the reference's, parsed as
    `yaml.safe_load` parses it, and emitted back to the same tree."""
    text = (PORT_CONF / name).read_bytes()
    assert text == (REF_CONF / name).read_bytes()
    tree = yaml_subset.loads(text.decode())
    assert tree == yaml.safe_load(text)
    out = yaml_subset.dumps(tree)
    assert yaml_subset.loads(out) == tree and yaml.safe_load(out) == tree


def test_override_values_and_emitter_match_pyyaml():
    for v in OVERRIDE_VALUES:
        assert yaml_subset.value(v) == yaml.safe_load(v), v
    # scalars that must stay strings, floats without a dot, nesting
    tree = {"a": [1, 2.5, 1e-5, "x y", "true", "", None, [3, [4]], {"k": "v", "z": [1]}],
            "b": {"c": math.inf, "d": "-x", "e": "a: b", "f": "#c", "g": "0755", "h": "it's", "i": "1e-4"}}
    out = yaml_subset.dumps(tree)
    assert yaml_subset.loads(out) == tree and yaml.safe_load(out) == tree
    for bad in ("{a: 1}", "&x 1", "!!str 1", "0x1F"):
        with pytest.raises(ValueError):
            yaml_subset.value(bad)


def fields_equal(port, ref):
    """Every field of the port's config dataclass equals the reference's."""
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), (type(port).__name__, f.name)


CHOICES = (
    [[f"planner={p}"] for p in ("confidence", "confidence_wo_roi", "exploration", "random")]
    + [[f"mapper={m}"] for m in ("incremental", "incremental_ablation")]
    + [[f"scene=synthetic/{s}"] for s in ("boxroom", "boxroom_holes", "tworoom")]
    + [CLI_OVERRIDES, CLI_OVERRIDES + ["mapper.raster.bf16_pairs=true", "mapper.raster.tile_h=8"]]
)


@pytest.mark.parametrize("overrides", CHOICES, ids=lambda o: o[0] if len(o) == 1 else f"cli{len(o)}")
def test_build_components_and_simulator_match_reference(overrides):
    cfg = load_config("main", overrides)
    ref = j_load_config("main", overrides)
    assert cfg.to_dict() == ref.to_dict()
    got, want = build_components(cfg), j_build_components(ref)
    assert set(got) == set(want)
    for k in got:
        fields_equal(got[k], want[k])
    sim, jsim = get_simulator(cfg, device="cpu"), JBoxRoom.from_config(ref)
    assert sim.resolution == tuple(int(x) for x in jsim.resolution)
    assert (sim.scene_name, sim.missing_band, sim.depth_range, sim.depth_noise_co) == (
        jsim.scene_name, jsim.missing_band, jsim.depth_range, jsim.depth_noise_co)
    np.testing.assert_array_equal(sim.mesh_vertices, jsim.mesh_vertices)
    np.testing.assert_allclose(sim.intrinsic.numpy(), np.asarray(jsim.intrinsic), rtol=1e-6)


def test_loader_runs_without_pyyaml(tmp_path):
    """With `yaml` unimportable, the loader, `build_components`, the emitter
    and the entry point's module import and run."""
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "from activegs_torch.config import load_config, build_components, yaml_subset\n"
        "import activegs_torch.apps.main\n"
        f"cfg = load_config('main', {CLI_OVERRIDES + ['mapper.raster.bf16_pairs=true']!r})\n"
        "c = build_components(cfg)\n"
        "assert c['raster_cfg'].bf16_pairs and c['map_cfg'].capacity == 4096\n"
        "assert yaml_subset.loads(yaml_subset.dumps(cfg.to_dict())) == cfg.to_dict()\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def check_experiment(out: str, steps: int):
    """The experiment directory's artifacts, as the reference's CLI test
    checks them. Returns the parsed exp_config.yaml."""
    exp_dirs = glob.glob(os.path.join(out, "*", "*", "*", "*"))
    assert len(exp_dirs) == 1, exp_dirs
    d = exp_dirs[0]
    text = open(os.path.join(d, "exp_config.yaml")).read()
    dumped = yaml_subset.loads(text)
    assert dumped == yaml.safe_load(text)
    lines = [json.loads(x) for x in open(os.path.join(d, "step_stats.jsonl"))]
    assert len(lines) == steps
    assert all("num_dropped" in s and "bucket_occupancy" in s for s in lines)
    assert all(np.isfinite(s["loss"]) for s in lines)
    state, _ = tckpt.load_gaussian_map(os.path.join(d, "map", "map_final.npz"), device="cpu")
    assert int(state.count) > 0
    return dumped


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("planner", ["confidence", "exploration"])
def test_main_flies_a_mission_on_the_cpu(tmp_path, planner, bf16):
    """`main` with `device=cpu` flies 2 steps (the reference's CLI test at
    64x64), in both pair precisions, and writes the reference's artifacts."""
    out = str(tmp_path / "exp")
    argv = ["device=cpu", f"planner={planner}", *CLI_OVERRIDES, f"experiment.output_dir={out}"]
    if bf16:
        argv.append("mapper.raster.bf16_pairs=true")
    mapper = tmain.main(argv)
    assert mapper.device.type == "cpu" and mapper.frame_id == 2
    assert mapper.raster_cfg.bf16_pairs == bf16 and mapper.planner.raster_cfg.bf16_pairs == bf16
    dumped = check_experiment(out, 2)
    assert dumped["device"] == "cpu" and dumped["planner"]["planner_name"] == planner
    assert dumped["mapper"]["raster"].get("bf16_pairs", False) == bf16


def test_python_dash_m_runs_the_entry_point(tmp_path):
    out = str(tmp_path / "exp")
    argv = ["device=cpu", *CLI_OVERRIDES[:-1], "max_steps=1", f"experiment.output_dir={out}",
            "mapper.raster.bf16_pairs=true"]
    r = subprocess.run([sys.executable, "-m", "activegs_torch.apps.main", *argv], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stderr[-2000:]
    assert " step 1: loss" in r.stdout
    check_experiment(out, 1)


def test_main_flies_a_replay_mission_on_the_cpu(tmp_path):
    """`simulator=replay` flies a 1-step mission from a dataset that the
    port's `ReplaySimulator.record` made of its synthetic room."""
    from activegs_torch.planning.paths import rotation_from_z
    from activegs_torch.sim import ReplaySimulator
    from activegs_torch.sim.synthetic import BoxRoomSimulator

    poses = []
    for ang in np.linspace(0, 2 * np.pi, 4, endpoint=False):
        e = np.eye(4, dtype=np.float32)
        e[:3, :3] = rotation_from_z(np.array([np.cos(ang), np.sin(ang), 0.0]))[0]
        e[:3, 3] = [3.0, 2.5, 1.5]
        poses.append(e)
    data = str(tmp_path / "dataset")
    ReplaySimulator.record(data, BoxRoomSimulator(resolution=(64, 64), device="cpu"), poses)
    out = str(tmp_path / "exp")
    argv = ["device=cpu", "simulator=replay", f"simulator.dataset_dir={data}", *CLI_OVERRIDES[:-1], "max_steps=1",
            f"experiment.output_dir={out}"]
    mapper = tmain.main(argv)
    assert isinstance(mapper.simulator, ReplaySimulator) and mapper.simulator.resolution == (64, 64)
    assert mapper.frame_id == 1 and mapper.gm_state.count > 0
    assert check_experiment(out, 1)["simulator"]["dataset_dir"] == data


@pytest.mark.parametrize("override, item", [("use_gui=true", "item 9"), ("dump_views=true", "item 9")])
def test_main_refuses_what_is_not_ported(tmp_path, override, item):
    """The viewers (ROADMAP.md, queue 1 `item`) are ported, so `main`
    refuses neither option any more: a 1-step mission runs with the live
    viewer (on a free port) or the panel dump attached
    (`tests/test_torch_viz.py` checks what they serve and write)."""
    argv = ["device=cpu", override, "gui_port=0", *CLI_OVERRIDES[:-1], "max_steps=1",
            f"experiment.output_dir={tmp_path}"]
    mapper = tmain.main(argv)
    try:
        assert mapper.frame_id == 1
        assert type(mapper.viewer).__name__ == {"use_gui=true": "WebViewer", "dump_views=true": "MissionViewer"}[override]
    finally:
        if hasattr(mapper.viewer, "close"):
            mapper.viewer.close()


def test_main_needs_a_card_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["device=cuda"]):
        with pytest.raises(RuntimeError, match="device=cpu"):
            tmain.main([*argv, *CLI_OVERRIDES, f"experiment.output_dir={tmp_path}"])
    assert not os.listdir(tmp_path)
    assert tcommon.mission_device(load_config("main", ["device=cpu"])).type == "cpu"
