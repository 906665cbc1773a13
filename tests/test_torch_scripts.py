"""The port's measurement and experiment scripts (`activegs_torch/scripts/`:
`bench`, `bench_mission`, `validate_truncation`, `run_sweep`) against the
reference's scripts at small sizes on the CPU: the bench scene field for
field, the bench's JSON line and termination telemetry, the mission
bench's aggregation against the reference's formulas, the truncation rows
against the reference's `render_view` (interpret mode) under the same two
configs, the sweep's summary and a whole CPU sweep, and each script's
refusal to run without a card unless told `device=cpu`.
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from activegs_torch.eval import metrics as tmetrics
from activegs_torch.io import checkpoint as tcheckpoint
from activegs_torch.mapping import gaussians as tgm
from activegs_torch.render.types import RasterConfig as TRasterConfig
from activegs_torch.scripts import bench as tbench
from activegs_torch.scripts import bench_mission as tbench_mission
from activegs_torch.scripts import run_sweep as tsweep
from activegs_torch.scripts import validate_truncation as ttrunc
from activegs_tpu.io import checkpoint as jcheckpoint
from activegs_tpu.mapping import gaussians as jgm
from activegs_tpu.render.renderer import render_view as j_render_view
from activegs_tpu.render.types import Camera as JCamera
from activegs_tpu.render.types import RasterConfig as JRasterConfig

torch.set_num_threads(2)

# the keys of the reference's JSON lines (root `bench.py`, `scripts/bench_mission.py`)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
MISSION_KEYS = {
    "metric", "value", "unit", "mean", "p10", "p90", "spike_steps", "prewarmed", "steady_steps", "phase_s",
    "phase_s_median", "planning_s", "planning_s_median", "plan_phase_s", "n_gaussians_final",
    "capacity_bucket_final", "num_dropped_final", "config",
}
TRUNCATION_KEYS = {
    "metric", "value", "unit", "min_psnr", "mean_depth_mse", "mean_dropped_prod", "mean_dropped_ref", "map",
    "n_gaussians", "prod", "views",
}
# a small CPU mission (the reference's CLI test at 64x64)
SMALL = [
    "device=cpu",
    "simulator.sensor.resolution=[64,64]",
    "mapper.gaussian_map.capacity=4096",
    "mapper.gaussian_map.optimization_steps=2",
    "mapper.keyframe_capacity=8",
    "planner.sample_num=8",
    "planner.max_roi_sample_num=0",
]


def test_build_scene_matches_reference():
    """The same numpy draws in the same order: every state field and every
    keyframe equal, the quaternions (the only float math) within 1e-6."""
    res, n = 32, 512
    t_state, t_buf = tbench.build_scene(res, n, tgm.MapConfig(capacity=1024), device="cpu")
    j_state, j_buf = jbench.build_scene(res, n, jgm.MapConfig(capacity=1024))
    assert t_state.count == int(j_state.count) == n
    for f in tgm.FIELDS:
        got, want = getattr(t_state, f).numpy(), np.asarray(getattr(j_state, f))
        if f == "rotations_raw":
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    assert t_buf.count == int(j_buf.count) == 8
    for f in ("rgb", "depth", "order", "extrinsics", "intrinsics", "performance"):
        np.testing.assert_array_equal(getattr(t_buf, f).numpy(), np.asarray(getattr(j_buf, f)), err_msg=f)


def test_term_probe_matches_reference():
    """The opaque variant's termination telemetry: the same chunks, stops
    and early-stopped tiles as the reference's fwd-only program, the mean
    transmittance within its rounding."""
    res, n = 32, 512
    t_state, t_buf = tbench.build_scene(res, n, tgm.MapConfig(capacity=1024), opacity_raw=5.0, device="cpu")
    j_state, j_buf = jbench.build_scene(res, n, jgm.MapConfig(capacity=1024), opacity_raw=5.0)
    got = tbench.term_probe(t_state, t_buf, tgm.MapConfig(capacity=1024), TRasterConfig(), res)
    want = jbench.term_probe(j_state, j_buf, jgm.MapConfig(capacity=1024), JRasterConfig(interpret=True), res)
    assert got.pop("mean_final_transmittance") == pytest.approx(want.pop("mean_final_transmittance"), abs=1e-4)
    assert got == want


def test_bench_main_on_the_cpu(monkeypatch, capsys):
    """`bench`'s main at 32x32, 512 gaussians and 1 step with `device=cpu`:
    one JSON line on stdout with the reference's keys (the opaque variant
    adds `variant` and `term_stats`), the ray count and buckets on stderr."""
    monkeypatch.setenv("BENCH_RES", "32")
    monkeypatch.setenv("BENCH_GAUSSIANS", "512")
    monkeypatch.setenv("BENCH_STEPS", "1")
    for opaque in ("0", "1"):
        monkeypatch.setenv("BENCH_OPAQUE", opaque)
        line = tbench.main(["device=cpu"])
        out, err = capsys.readouterr()
        assert out.count("\n") == 1 and json.loads(out) == line
        keys = BENCH_KEYS | ({"variant", "term_stats"} if opaque == "1" else set())
        assert set(line) == keys and line["metric"] == "train_rays_per_s_fwd_bwd"
        assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(line["value"] / 2.0e8)
        assert "8192 rays a run" in err and "distinct views a step" in err
    assert line["variant"] == "opaque" and line["term_stats"]["num_tiles"] == 2


def _reference_summary(all_stats, steady_from):
    """`scripts/bench_mission.py`'s aggregation, written out."""
    steady = [s for s in all_stats if s["frame_id"] >= steady_from]
    t_map = [s["t_mapping"] for s in steady]
    med = float(np.median(t_map))
    phases = sorted({k for s in steady for k in s["phase_times"]})
    plan_phases = sorted({k for s in steady for k in s["plan_times"]})
    planning = [sum(v for k, v in s["plan_times"].items() if not k.startswith("utility_")) for s in steady]
    return {
        "metric": "mission_s_per_keyframe",
        "value": med,
        "unit": "s/keyframe (mapping, steady-state median)",
        "mean": round(float(np.mean(t_map)), 3),
        "p10": round(float(np.percentile(t_map, 10)), 3),
        "p90": round(float(np.percentile(t_map, 90)), 3),
        "spike_steps": [s["frame_id"] for s in steady if s["t_mapping"] > 2.0 * med],
        "steady_steps": [s["frame_id"] for s in steady],
        "phase_s": {k: round(float(np.mean([s["phase_times"].get(k, 0.0) for s in steady])), 3) for k in phases},
        "phase_s_median": {k: round(float(np.median([s["phase_times"].get(k, 0.0) for s in steady])), 3)
                           for k in phases},
        "planning_s": round(float(np.mean(planning)), 3),
        "planning_s_median": round(float(np.median(planning)), 3),
        "plan_phase_s": {k: round(float(np.mean([s["plan_times"].get(k, 0.0) for s in steady])), 3)
                         for k in plan_phases},
        "n_gaussians_final": all_stats[-1]["n_gaussians"],
        "capacity_bucket_final": all_stats[-1]["capacity_bucket"],
        "num_dropped_final": all_stats[-1]["num_dropped"],
    }


def test_bench_mission_summary_is_the_reference_s():
    """Medians, percentiles, spikes (above twice the median), phases, and
    planning without the `utility_*` sub-phases, on synthetic step stats
    with a spike, a phase missing from some steps and an unplanned first
    step."""
    rng = np.random.default_rng(0)
    stats = []
    for i in range(1, 13):
        t = float(rng.uniform(0.5, 1.5)) * (3.0 if i in (5, 10) else 1.0)
        phases = {"spawn": float(rng.uniform(0, 0.2)), "train": float(rng.uniform(0.3, 1.0)),
                  "post": float(rng.uniform(0, 0.3)), "voxel": 0.01}
        if i % 3:
            phases["view_stats"] = float(rng.uniform(0, 0.1))
        plan = {} if i == 1 else {"masks": 0.01 * i, "roi_rand": 0.02, "utility": float(rng.uniform(1, 2)),
                                   "astar": 0.003, "utility_stats": 0.4, "utility_batch": 0.9}
        stats.append({"frame_id": i, "t_mapping": t, "phase_times": phases, "plan_times": plan,
                      "n_gaussians": 1000 * i, "capacity_bucket": 32768, "num_dropped": 7 * i})
    for steady_from in (1, tbench_mission.STEADY_FROM, 9):
        got = tbench_mission.summarize(stats, steady_from)
        assert got == _reference_summary(stats, steady_from)
    assert tbench_mission.summarize(stats)["spike_steps"] == [5, 10]


def test_bench_mission_main_on_the_cpu(tmp_path, capsys):
    """A 4-step CPU mission through `bench_mission.main`: the reference's
    keys (every key it reads from `IncrementalMapper.step` is there), the
    steady window from frame 4, and `out=` records the final map."""
    out = str(tmp_path / "bm")
    result = tbench_mission.main([*SMALL, "steps=4", "prewarm=0", f"out={out}"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
    assert set(result) == MISSION_KEYS and result["steady_steps"] == [4]
    assert set(result["phase_s"]) == {"spawn", "view_stats", "train", "post", "voxel"}
    assert {"masks", "roi_rand", "utility", "astar", "utility_stats", "utility_batch"} <= set(result["plan_phase_s"])
    assert result["config"]["resolution"] == [64, 64] and result["config"]["device"] == "cpu"
    assert os.path.exists(os.path.join(out, "map", "map_final.npz"))
    with open(os.path.join(out, "map", "cameras_final.json")) as f:
        assert len(json.load(f)) == 4


def _truncation_map(path):
    """A 64x64-scale map for the truncation check: the bench scene's
    surfels at their largest scale, written by the port's checkpoint."""
    state, _ = tbench.build_scene(8, 2048, tgm.MapConfig(capacity=2048), device="cpu")
    state.scales_raw[:, :2] = math.log(5.0)  # scale_factor 0.01 x 5 = scale_max 0.05
    tcheckpoint.save_gaussian_map(path, state, tgm.MapConfig(capacity=2048))


def _ring(n=3):
    """Cameras inside the bench room, 1 m from its walls, looking at them."""
    from activegs_torch.planning.paths import rotation_from_z

    intr = np.array([[0.8660254, 0, 0.5], [0, 0.8660254, 0.5], [0, 0, 1]], np.float32)
    cams = []
    for ang in np.linspace(0, 2 * np.pi, n, endpoint=False):
        e = np.eye(4, dtype=np.float32)
        look = np.array([np.cos(ang), np.sin(ang), 0.1])
        e[:3, :3] = rotation_from_z(look)[0]
        e[:3, 3] = np.array([3.0, 2.5, 1.5]) + 1.5 * look * np.array([1, 1, 0])
        cams.append((e, intr))
    return cams


def test_truncation_rows_match_reference(tmp_path):
    """Production config max_dup 1 and a small entry budget (so that it
    drops entries) against max_dup 16 and 4x the budget, on a map written
    by the port's checkpoint and read by both packages: each view's
    `num_dropped` equal to the reference's `render_view`'s (interpret
    mode) under each config, the clipped images within 2e-5, depth within
    1e-4, and the PSNR between the two renders within 1e-3 dB."""
    path = str(tmp_path / "map.npz")
    _truncation_map(path)
    t_state, t_cfg = tcheckpoint.load_gaussian_map(path, device="cpu")
    j_state, j_cfg = jcheckpoint.load_gaussian_map(path)
    t_attrs = tgm.attrs_of(tgm.slice_state(t_state, tgm.bucket_capacity(t_state.count, t_cfg.capacity)), t_cfg)
    j_attrs = jgm.attrs_of(jgm.slice_state(j_state, jgm.bucket_capacity(int(j_state.count), j_cfg.capacity)), j_cfg)
    prod = TRasterConfig(max_dup=1, entry_budget_mult=0.05)
    ref = ttrunc.reference_config(prod)
    assert (ref.max_dup, ref.entry_budget_mult) == (16, 0.2)
    j_cfgs = [JRasterConfig(interpret=True, max_dup=c.max_dup, entry_budget_mult=c.entry_budget_mult)
              for c in (prod, ref)]
    shape = (64, 64)
    dropped = []
    for ext, intr in _ring():
        t_ext, t_intr = torch.from_numpy(ext), torch.from_numpy(intr)
        row = ttrunc.truncation_row(t_attrs, t_ext, t_intr, shape, prod, ref)
        t_out = [ttrunc.render_clipped(t_attrs, t_ext, t_intr, shape, c) for c in (prod, ref)]
        j_out = []
        for c in j_cfgs:
            o, aux = j_render_view(j_attrs, JCamera(extrinsic=jnp.asarray(ext), intrinsic=jnp.asarray(intr)), shape, c)
            j_out.append((np.clip(np.asarray(o.rgb), 0.0, 1.0), np.asarray(o.depth), int(aux["num_dropped"])))
        for (t_rgb, t_depth, t_drop), (j_rgb, j_depth, j_drop) in zip(t_out, j_out):
            assert t_drop == j_drop
            np.testing.assert_allclose(t_rgb.numpy(), j_rgb, atol=2e-5, rtol=0)
            np.testing.assert_allclose(t_depth.numpy(), j_depth, atol=1e-4, rtol=0)
        j_psnr = -10.0 * math.log10(float(np.mean((j_out[0][0] - j_out[1][0]) ** 2)) + 1e-12)
        assert ttrunc.psnr_db(t_out[0][0], t_out[1][0]) == pytest.approx(j_psnr, abs=1e-3)
        assert row["psnr_prod_vs_ref"] == round(ttrunc.psnr_db(t_out[0][0], t_out[1][0]), 2)
        assert (row["dropped_prod"], row["dropped_ref"]) == (t_out[0][2], t_out[1][2])
        dropped.append((row["dropped_prod"], row["dropped_ref"]))
    assert all(p > r >= 0 for p, r in dropped), dropped


def test_validate_truncation_main_on_the_cpu(tmp_path, capsys):
    """The check end to end on the CPU: cameras taken evenly from a
    recorder's file, the render size from `shape=`, the reference's result
    keys written to `out=`, and the production drops above the
    reference config's."""
    path, cams, out = str(tmp_path / "map.npz"), str(tmp_path / "cameras.json"), str(tmp_path / "q.json")
    _truncation_map(path)
    with open(cams, "w") as f:
        json.dump([np.concatenate([e.reshape(-1), k.reshape(-1)]).tolist() for e, k in _ring(6)], f)
    result = ttrunc.main(["device=cpu", f"map={path}", f"cams={cams}", "n_views=3", "shape=64x48",
                          "mapper.raster.max_dup=1", f"out={out}"])
    assert set(result) == TRUNCATION_KEYS and len(result["views"]) == 3
    assert result["unit"].startswith("dB (64x48 render") and result["prod"] == {"max_dup": 1, "budget_mult": 2.0}
    assert result["mean_dropped_prod"] > result["mean_dropped_ref"]
    assert result["value"] == round(float(np.mean([r["psnr_prod_vs_ref"] for r in result["views"]])), 2)
    with open(out) as f:
        assert json.load(f) == result
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        k: v for k, v in result.items() if k != "views"}


def test_sweep_summary_is_the_reference_s():
    """Each metric's last snapshot over the runs: mean, population std and
    the runs, runs without a value left out, a metric no run has left out."""
    per_run = {"tworoom": {
        "confidence": [{"mean_psnr": [5.0, 12.0], "mesh_completion_ratio": [1.0, 20.0], "mesh_accuracy": [None]},
                       {"mean_psnr": [6.0, 10.0], "mesh_completion_ratio": [2.0, None]},
                       None],
        "random": [{"mean_psnr": [4.0]}],
    }}
    got = tsweep.summarize(per_run)
    conf = got["tworoom"]["confidence"]
    assert conf["n_runs"] == 3 and got["tworoom"]["random"]["n_runs"] == 1
    assert conf["final"]["mean_psnr"] == {"mean": 11.0, "std": 1.0, "runs": [12.0, 10.0]}
    assert conf["final"]["mesh_completion_ratio"] == {"mean": 20.0, "std": 0.0, "runs": [20.0, None]}
    assert set(conf["final"]) == {"mean_psnr", "mesh_completion_ratio"}
    assert got["tworoom"]["random"]["final"] == {"mean_psnr": {"mean": 4.0, "std": 0.0, "runs": [4.0]}}


def test_sweep_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """boxroom x {confidence, random} x 1 run at 64x64 on a budget of 2 s, 4
    test views, meshes at 64, no warm-up: every run writes its
    `final_result.json`, the summary has both cells with the reference's
    keys, and `merge=1` rebuilds the same cells from disk. The mesh
    metrics run at 5000 samples here (at 500,000 the KD-tree queries alone
    take about a minute on the CPU)."""
    calc = tmetrics.calc_3d_mesh_metric
    monkeypatch.setattr(tmetrics, "calc_3d_mesh_metric", lambda rec, gt, dist_thres, n_samples: calc(
        rec, gt, dist_thres=dist_thres, n_samples=5000))
    out = str(tmp_path / "exp")
    args = [*SMALL, f"experiment.output_dir={out}", "exp_id=sw", "scenes=synthetic/boxroom",
            "planners=confidence,random", "runs=1", "budget=2", "record_interval=100", "num_test_views=4",
            "mesh_resolution=64", "warmup_steps=0"]
    summary = tsweep.main(args)
    for planner in ("confidence", "random"):
        run = os.path.join(out, "sw", "boxroom", planner, "0")
        with open(os.path.join(run, "final_result.json")) as f:
            result = json.load(f)
        assert result["step"] == ["final"] and np.isfinite(result["mean_psnr"][0])
        assert os.path.exists(os.path.join(run, "map", "mesh_final.ply"))
        cell = summary["scenes"]["boxroom"][planner]
        assert cell["n_runs"] == 1 and {"mean_psnr", "mesh_completion_ratio"} <= set(cell["final"])
    assert {"budget_s", "record_interval_s", "runs", "num_test_views", "mesh_resolution", "scenes",
            "wall_clock_s"} <= set(summary)
    assert summary["invocations"] == 1 and summary["card"] is None
    assert summary["package_digest"] == tsweep.package_digest()
    assert [m["planner"] for m in summary["missions"]] == ["confidence", "random"]
    with open(os.path.join(out, "sw", "summary.json")) as f:
        assert json.load(f) == summary
    for planner in ("confidence", "random"):
        with open(os.path.join(out, "sw", "boxroom", planner, "0", "run_info.json")) as f:
            info = json.load(f)
        assert info["package_digest"] == summary["package_digest"] and info["mission"]["planner"] == planner
        assert (info["protocol"]["budget_s"], info["protocol"]["warmup_steps"]) == (2.0, 0)
    # a merge that flies nothing rebuilds the same summary from the runs on disk
    merged = tsweep.main([*args, "run_ids=", "merge=1"])
    assert merged == summary


def test_sweep_merge_refuses_other_runs(tmp_path):
    """`merge=1` joins only runs of this invocation's package and protocol:
    a run flown at another budget, with other overrides or by another
    package, or one without its `run_info.json`, stops the merge."""
    root = tmp_path / "exp" / "sw"
    protocol = {"budget_s": 120.0, "record_interval_s": 40.0, "runs": 3, "num_test_views": 96,
                "mesh_resolution": 512, "warmup_steps": 12, "overrides": ["device=cpu"], "device": "cpu",
                "card": None}
    mission = {"scene": "tworoom", "planner": "random", "run": 0, "steps": 5, "t_mapping_first": 0.1,
               "t_mapping_median_rest": 0.2, "seconds": 10.0}

    def write(run, info):
        d = root / "tworoom" / "random" / str(run)
        d.mkdir(parents=True)
        (d / "final_result.json").write_text(json.dumps({"mean_psnr": [10.0 + run]}))
        if info is not None:
            (d / "run_info.json").write_text(json.dumps(info))

    inv = {"id": "a", "warmup_s": 30.0}
    write(0, {"package_digest": "d", "protocol": protocol, "invocation": inv, "mission": mission})
    write(1, {"package_digest": "d", "protocol": protocol, "invocation": {"id": "b", "warmup_s": 20.0},
              "mission": {**mission, "run": 1}})
    entries = tsweep.runs_on_disk(str(root), 3, "d", protocol)
    summary = tsweep.sweep_summary(entries, protocol, "d")
    assert summary["scenes"]["tworoom"]["random"]["final"]["mean_psnr"]["runs"] == [10.0, 11.0]
    assert (summary["invocations"], summary["wall_clock_s"]) == (2, 70.0)
    with pytest.raises(ValueError, match="package"):
        tsweep.runs_on_disk(str(root), 3, "e", protocol)
    with pytest.raises(ValueError, match="budget_s 120.0 against 20.0"):
        tsweep.runs_on_disk(str(root), 3, "d", {**protocol, "budget_s": 20.0})
    with pytest.raises(ValueError, match="overrides"):
        tsweep.runs_on_disk(str(root), 3, "d", {**protocol, "overrides": ["device=cpu", "max_steps=4"]})
    write(2, None)
    with pytest.raises(ValueError, match="no run_info.json"):
        tsweep.runs_on_disk(str(root), 3, "d", protocol)


def test_sweep_max_steps_ends_missions(tmp_path, monkeypatch):
    """`max_steps=N` ends each recorded mission after N steps when the
    budget has not ended it first, and the run records it."""
    calc = tmetrics.calc_3d_mesh_metric
    monkeypatch.setattr(tmetrics, "calc_3d_mesh_metric", lambda rec, gt, dist_thres, n_samples: calc(
        rec, gt, dist_thres=dist_thres, n_samples=5000))
    out = str(tmp_path / "exp")
    summary = tsweep.main([*SMALL, f"experiment.output_dir={out}", "exp_id=sw", "scenes=synthetic/boxroom",
                           "planners=random", "runs=1", "budget=1000", "record_interval=1000",
                           "num_test_views=2", "mesh_resolution=32", "warmup_steps=0", "max_steps=2"])
    assert [m["steps"] for m in summary["missions"]] == [2]
    assert "max_steps=2" in summary["overrides"]


@pytest.mark.parametrize("script", ["bench", "bench_mission", "validate_truncation", "run_sweep"])
def test_scripts_need_a_card_unless_told_cpu(monkeypatch, tmp_path, script):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = {"bench": tbench, "bench_mission": tbench_mission, "validate_truncation": ttrunc,
              "run_sweep": tsweep}[script]
    for argv in ([], ["device=cuda"]):
        with pytest.raises(RuntimeError, match="device=cpu"):
            module.main([*argv, f"experiment.output_dir={tmp_path}", f"out={tmp_path / 'out'}",
                         f"map={tmp_path / 'm.npz'}", f"cams={tmp_path / 'c.json'}"])
    assert not os.listdir(tmp_path)


def test_bench_scene_is_the_bench_shape():
    """The scene's layout does not depend on the size: the room shell's
    faces, normals facing inward, the flat third scale, the keyframe ring."""
    state, buf = tbench.build_scene(16, 64, tgm.MapConfig(capacity=128), device="cpu")
    means, normals = state.means[:64], tgm.normals_of(state)[:64]
    assert torch.all(state.scales_raw[:64, 2] == tgm.FLAT_SCALE_RAW)
    on_face = [(means[:, a] == s * d) for a, d in enumerate((6.0, 5.0, 3.0)) for s in (0, 1)]
    assert bool(torch.stack(on_face).any(0).all())
    centre = torch.tensor([3.0, 2.5, 1.5])
    assert bool((torch.sum(normals * (centre - means), dim=1) > 0).all())
    assert torch.allclose(buf.extrinsics[:, :3, 3], centre.expand(8, 3))
