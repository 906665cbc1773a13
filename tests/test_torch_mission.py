"""The port's mission loop (`IncrementalMapper` with the confidence planner
and a `MissionRecorder`) and its checkpoints.

- The port alone flies the reference's planner-in-loop gate
  (`tests/test_quality_gate.py`: a 6-step confidence-planner mission at
  64 x 64, seed 3, voxels 0.4 m, capacity 32768, 5 Adam steps, 12
  candidates) and must clear the same bars: held-out PSNR over 4 poses and
  the explored voxel fraction. The same mission, recorded, is held to the
  budget, snapshot and motion checks of `tests/test_mission.py`.
- A map or voxel checkpoint written by either package loads bitwise in the
  other.
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activegs_torch.core import geometry as tgeo
from activegs_torch.io import checkpoint as tck
from activegs_torch.io.recorder import MissionRecorder
from activegs_torch.mapping import gaussians as tgm
from activegs_torch.mapping import voxel_map as tvm
from activegs_torch.mapping.mapper import IncrementalMapper
from activegs_torch.planning import ConfidencePlanner, PlannerConfig, RandomPlanner
from activegs_torch.render import types as tt
from activegs_torch.render.renderer import render_view
from activegs_torch.sim.synthetic import BoxRoomSimulator
from activegs_tpu.io import checkpoint as jck
from activegs_tpu.mapping import gaussians as jgm
from activegs_tpu.mapping import voxel_map as jvm
from activegs_tpu.sim.synthetic import BoxRoomSimulator as JSim
from test_mapping import look_at_pose
from test_quality_gate import PINNED_EXPLORED_FRAC, PINNED_MISSION_PSNR, RASTER
from test_torch_core import t_like
from test_torch_mapping import t_frame, t_state

torch.set_num_threads(2)

RES = 64
T_RASTER = t_like(tt.RasterConfig, RASTER)
VOXCFG = tvm.VoxelConfig(map_resolution=(0.4, 0.4, 0.4))
MAPCFG = tgm.MapConfig(capacity=32768, optimization_steps=5, bilateral_radius=2)
INIT_POSE = ((0.0, 0.0, 1.0, 1.0), (-1.0, 0.0, 0.0, 2.5), (0.0, -1.0, 0.0, 1.5), (0.0, 0.0, 0.0, 1.0))


@pytest.fixture(scope="module")
def mission(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mission"))
    sim = BoxRoomSimulator(resolution=(RES, RES), seed=3, depth_noise_co=0.0, device="cpu")
    planner = ConfidencePlanner(
        PlannerConfig(sample_num=12, max_roi_sample_num=4, radius=1.5, init_pose=INIT_POSE),
        MAPCFG, VOXCFG, T_RASTER, seed=0,
    )
    mapper = IncrementalMapper(MAPCFG, VOXCFG, T_RASTER, keyframe_capacity=16, device="cpu")
    mapper.load_simulator(sim)
    mapper.load_planner(planner)
    recorder = MissionRecorder(out, budget=1e9, record_interval=1e9)
    mapper.load_recorder(recorder)
    mapper.init_map()
    stats = [mapper.step() for _ in range(6)]
    return mapper, recorder, stats, out


def test_mission_quality_planner_in_loop(mission):
    """`test_quality_gate.test_mission_quality_planner_in_loop`, the port
    alone: PSNR > 6.76 dB over 4 held-out poses, explored > 0.76."""
    mapper, _, stats, _ = mission
    assert all(math.isfinite(s["loss"]) for s in stats)
    attrs = tgm.attrs_of(mapper.gm_state, MAPCFG)
    center, z = (3.0, 2.5, 1.5), 1.3
    psnrs = []
    for target in ((5.5, 2.5, z), (0.5, 2.5, z), (3.0, 4.5, z), (3.0, 0.5, z)):
        gt = mapper.simulator.simulate(tgeo.look_at(center, target, device="cpu"), require_gt=True)
        out, _ = render_view(attrs, tt.Camera(gt["extrinsic"], gt["intrinsic"]), (RES, RES), T_RASTER)
        psnrs.append(-10.0 * math.log10(float(torch.mean((out.rgb - gt["rgb"]) ** 2))))
    psnr = float(np.mean(psnrs))
    explored = 1.0 - float(mapper.vm_state.unexplored.float().mean())
    print(f"\nport planner-in-loop gate: psnr={psnr:.3f} dB, explored={explored:.3f}")
    assert psnr > PINNED_MISSION_PSNR - 0.5, f"mission PSNR regressed: {psnr:.2f}"
    assert explored > PINNED_EXPLORED_FRAC - 0.05, f"exploration regressed: {explored:.3f}"


def test_mission_progress_and_telemetry(mission):
    mapper, _, stats, out = mission
    assert stats[-1]["n_gaussians"] > 500
    assert tvm.free_mask(mapper.vm_state, VOXCFG).sum() > 5
    assert set(stats[-1]["phase_times"]) == {"spawn", "view_stats", "train", "post", "voxel"}
    assert {"masks", "roi_rand", "utility", "astar"} <= set(stats[-1]["plan_times"])
    with open(os.path.join(out, "step_stats.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [x["frame_id"] for x in lines] == list(range(1, 7))
    assert all(x["t_mission"] > 0 for x in lines)


def test_mission_budget_accounting(mission):
    _, recorder, _, _ = mission
    assert recorder.time_dict["mapping"] > 0
    assert recorder.time_dict["planning"] > 0
    assert recorder.time_dict["flight"] > 0
    assert recorder.t_mission == pytest.approx(sum(recorder.time_dict.values()))
    info = recorder.log()
    assert 0 < info["mapping_pct"] < 100


def test_planner_moves_robot(mission):
    mapper, recorder, _, _ = mission
    planner = mapper.planner
    assert planner.initialized
    assert not np.allclose(planner.pose[:3, 3], np.asarray(INIT_POSE, np.float32)[:3, 3])
    assert recorder.accum_path_length > 0 and len(recorder.global_path) > 0
    assert len(planner.last_candidates) == 12 and planner.last_scores.shape == (12,)


def test_recorder_snapshots(mission):
    mapper, recorder, _, out = mission
    recorder.save_map(mapper.gm_state, MAPCFG, "001")
    assert os.path.exists(os.path.join(out, "map", "map_001.npz"))
    assert os.path.exists(os.path.join(out, "map", "record_info.txt"))
    state, _ = tck.load_gaussian_map(os.path.join(out, "map", "map_001.npz"), device="cpu")
    assert state.count == mapper.gm_state.count
    ref_state, _ = jck.load_gaussian_map(os.path.join(out, "map", "map_001.npz"))
    assert int(ref_state.count) == mapper.gm_state.count


def test_capacity_saturation_reports_and_prunes(tmp_path):
    """`test_mission.test_capacity_saturation_reports_and_prunes` on the
    port, with the random planner, through `IncrementalMapper.run`: dropped
    spawns are counted and the occupancy trigger forces a prune off the
    cadence."""
    sim = BoxRoomSimulator(resolution=(RES, RES), seed=3, device="cpu")
    cfg = tgm.MapConfig(capacity=1024, optimization_steps=2, bilateral_radius=2, prune_interval=50, prune_occupancy=0.5)
    planner = RandomPlanner(
        PlannerConfig(type="random", sample_num=6, max_roi_sample_num=0, radius=1.5, init_pose=INIT_POSE),
        cfg, VOXCFG, T_RASTER, seed=0,
    )
    mapper = IncrementalMapper(cfg, VOXCFG, T_RASTER, keyframe_capacity=8, device="cpu")
    mapper.load_simulator(sim)
    mapper.load_planner(planner)
    mapper.load_recorder(MissionRecorder(str(tmp_path), budget=1e9, record_interval=1e9))
    mapper.run(max_steps=3)
    with open(tmp_path / "step_stats.jsonl") as f:
        stats = [json.loads(x) for x in f]
    assert len(stats) == 3 and (tmp_path / "map" / "map_final.npz").exists()
    assert all(s["n_gaussians"] <= cfg.capacity for s in stats)
    assert np.isfinite([s["loss"] for s in stats]).all()
    assert any(s["n_spawn_dropped"] > 0 for s in stats)
    assert any(s["early_prune"] for s in stats)
    assert all(0.0 <= s["capacity_occupancy"] <= 1.0 for s in stats)


@pytest.fixture(scope="module")
def ref_maps():
    """A reference surfel map (one spawned frame) and voxel map (two
    frames)."""
    cfg = jgm.MapConfig(capacity=8192, bilateral_radius=2)
    sim = JSim(resolution=(RES, RES), seed=3, depth_noise_co=0.002)
    frames = [sim.simulate(look_at_pose((3.0, 2.5, 1.5), t)) for t in ((5.5, 2.5, 1.2), (5.0, 4.0, 1.0))]
    state, _, _ = jgm.spawn(jgm.init_state(cfg), frames[0], cfg, RASTER)
    grid = jvm.VoxelGrid.create(sim.bbox, jvm.VoxelConfig())
    vstate = jvm.init_state(grid)
    for f in frames:
        vstate = jvm.update(vstate, grid, f)
    return cfg, state, grid, vstate, frames


def test_checkpoints_load_bitwise_across_packages(ref_maps, tmp_path):
    cfg, state, grid, vstate, frames = ref_maps
    n = int(state.count)
    # reference -> port
    jck.save_gaussian_map(str(tmp_path / "ref_map.npz"), state, cfg)
    got, got_cfg = tck.load_gaussian_map(str(tmp_path / "ref_map.npz"), device="cpu")
    assert got.count == n and got_cfg.capacity == jck.load_gaussian_map(str(tmp_path / "ref_map.npz"))[1].capacity
    for f in tgm.FIELDS:
        np.testing.assert_array_equal(getattr(got, f)[:n].numpy(), np.asarray(getattr(state, f))[:n], err_msg=f)
    jck.save_voxel_map(str(tmp_path / "ref_vox.npz"), vstate, grid)
    gv, gg = tck.load_voxel_map(str(tmp_path / "ref_vox.npz"), device="cpu")
    assert (gg.dim, gg.size, gg.bbox_min) == (grid.dim, grid.size, grid.bbox_min)
    for k, v in tvm.voxel_state_to_numpy(gv).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(vstate, k)), err_msg=k)
    # port -> reference
    ts = t_state(state)
    tv = tvm.update(tvm.voxel_state_from_numpy(tvm.voxel_state_to_numpy(gv), "cpu"), gg, t_frame(frames[0]))
    tck.save_gaussian_map(str(tmp_path / "port_map.npz"), ts, t_like(tgm.MapConfig, cfg))
    back, back_cfg = jck.load_gaussian_map(str(tmp_path / "port_map.npz"))
    assert int(back.count) == n and back_cfg.bound == cfg.bound
    for f in tgm.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f))[:n], getattr(ts, f)[:n].numpy(), err_msg=f)
    tck.save_voxel_map(str(tmp_path / "port_vox.npz"), tv, gg)
    bv, bg = jck.load_voxel_map(str(tmp_path / "port_vox.npz"))
    assert bg == grid
    for k, v in tvm.voxel_state_to_numpy(tv).items():
        np.testing.assert_array_equal(np.asarray(getattr(bv, k)), v, err_msg=k)
    assert isinstance(bv.log_odds, jnp.ndarray)
