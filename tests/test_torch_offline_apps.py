"""The port's replay simulator, test-view generation, PNG writer, offline
configs and apps (`data_generation`, `mesh_app`, `eval_app`, `plot`)
against the reference's (`tests/test_apps.py`'s cases), and the three
apps end to end on the CPU after a 2-step 64x64 mission.
"""

import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from activegs_torch.apps import data_generation as tdatagen
from activegs_torch.apps import eval_app as teval_app
from activegs_torch.apps import main as tmain
from activegs_torch.apps import mesh_app as tmesh_app
from activegs_torch.apps import plot as tplot
from activegs_torch.config import load_config
from activegs_torch.eval import metrics as tmetrics
from activegs_torch.io.png import write_png
from activegs_torch.mapping import voxel_map as tvm
from activegs_torch.planning.paths import rotation_from_z
from activegs_torch.sim import ReplaySimulator as TReplay
from activegs_torch.sim.synthetic import BoxRoomSimulator as TBoxRoom
from activegs_tpu.config import load_config as j_load_config
from activegs_tpu.mapping import voxel_map as jvm
from activegs_tpu.sim.replay import ReplaySimulator as JReplay
from activegs_tpu.sim.synthetic import BoxRoomSimulator as JBoxRoom

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# the keys of the reference's final_result.json: its EvaluationTool's
# (`test_torch_eval.py` holds the port's tool to them) and the snapshot index
RESULT_KEYS = {"mean_psnr", "mean_ssim", "mean_lpips", "mean_perceptual", "mean_depth_mse", "mesh_accuracy",
               "mesh_completion", "mesh_completion_ratio", "mesh_chamfer_distance", "step", "time", "path_length"}
# the 2-step CPU mission of `tests/test_torch_apps.py` (the reference's CLI test at 64x64)
MISSION = [
    "device=cpu",
    "simulator.sensor.resolution=[64,64]",
    "mapper.gaussian_map.capacity=4096",
    "mapper.gaussian_map.optimization_steps=2",
    "mapper.gaussian_map.bilateral_radius=2",
    "mapper.keyframe_capacity=8",
    "planner.sample_num=8",
    "planner.max_roi_sample_num=0",
]


def ring_poses(n=4):
    """Poses at the room's centre looking around, as `tests/test_apps.py`
    records them."""
    poses = []
    for ang in np.linspace(0, 2 * np.pi, n, endpoint=False):
        e = np.eye(4, dtype=np.float32)
        e[:3, :3] = rotation_from_z(np.array([np.cos(ang), np.sin(ang), 0.0]))[0]
        e[:3, 3] = [3.0, 2.5, 1.5]
        poses.append(e)
    return poses


def frames_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_replay_datasets_cross_packages(tmp_path):
    """The port records from its simulator and the reference replays it; the
    reference records from its simulator and the port replays it: each
    frame bitwise the other package's reading, and the recording within
    the uint8 quantization of the live simulator's frame."""
    poses = ring_poses()
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    src = TBoxRoom(resolution=(32, 32), seed=0, device="cpu")
    TReplay.record(port_dir, src, poses)
    JReplay.record(ref_dir, JBoxRoom(resolution=(32, 32), seed=0), poses)
    assert json.load(open(os.path.join(port_dir, "meta.json"))) == json.load(open(os.path.join(ref_dir, "meta.json")))
    for d in (port_dir, ref_dir):
        t, j = TReplay(d, depth_noise_co=0.0, device="cpu"), JReplay(d, depth_noise_co=0.0)
        assert (t.scene_name, t.resolution, t.depth_range) == (j.scene_name, tuple(j.resolution), j.depth_range)
        np.testing.assert_array_equal(t.bbox, j.bbox)
        for p in poses:
            frames_equal({k: v.numpy() for k, v in t.simulate(p, require_gt=True).items()},
                         j.simulate(p, require_gt=True))
            np.testing.assert_array_equal(t.simulate(p, valid_mask_only=True).numpy(), j.simulate(p, valid_mask_only=True))
    f_src = src.simulate(poses[1], require_gt=True)
    f_rep = TReplay(port_dir, device="cpu").simulate(torch.from_numpy(poses[1]), require_gt=True)
    np.testing.assert_allclose(f_rep["extrinsic"].numpy(), poses[1], atol=1e-6)
    torch.testing.assert_close(f_rep["rgb"], f_src["rgb"], atol=1 / 255 + 1e-6, rtol=0)
    torch.testing.assert_close(f_rep["depth"], f_src["depth"], atol=1e-5, rtol=0)


def test_replay_nearest_pose_and_noise(tmp_path):
    src = TBoxRoom(resolution=(32, 32), seed=0, device="cpu")
    poses = []
    for x in (1.0, 3.0, 5.0):
        e = np.eye(4, dtype=np.float32)
        e[:3, :3] = rotation_from_z(np.array([0.0, 1.0, 0.0]))[0]
        e[:3, 3] = [x, 2.5, 1.5]
        poses.append(e)
    TReplay.record(str(tmp_path), src, poses)
    replay = TReplay(str(tmp_path), device="cpu")
    assert [replay._nearest(p) for p in poses] == [0, 1, 2]
    q = poses[2].copy()
    q[0, 3] = 4.8  # closest to x=5
    f = replay.simulate(q)
    assert float(f["extrinsic"][0, 3]) == 5.0
    # sensor noise: sigma = depth_noise_co * depth, the sentinels kept
    clean = replay.simulate(q, require_gt=True)["depth"]
    hit = clean > 0
    rel = (f["depth"][hit] - clean[hit]) / clean[hit]
    assert 0.007 < float(rel.std()) < 0.013 and abs(float(rel.mean())) < 0.002
    assert torch.equal(f["depth"][~hit], clean[~hit])


def test_replay_valid_mask_only(tmp_path):
    src = TBoxRoom(resolution=(16, 16), seed=0, device="cpu")
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [3, 2.5, 1.5]
    TReplay.record(str(tmp_path), src, [pose])
    m = TReplay(str(tmp_path), device="cpu").simulate(pose, valid_mask_only=True)
    assert m.dtype == torch.bool and m.shape == (16, 16)


def test_generate_test_views_match_reference():
    """On one voxel state carried across, with the same seed, the reference's
    poses."""
    cfg = jvm.VoxelConfig()
    grid = jvm.VoxelGrid.create((np.zeros(3), np.array([6.0, 5.0, 3.0])), cfg)
    rng = np.random.default_rng(4)
    n = grid.num_voxels
    d = {"log_odds": rng.uniform(-3, 3, n).astype(np.float32), "unexplored": rng.uniform(size=n) < 0.3,
         "roi_mask": np.zeros(n, bool), "voxel_normal": np.zeros((n, 3), np.float32)}
    from activegs_tpu.apps.data_generation import generate_test_views

    want = generate_test_views(jvm.VoxelMapState(**{k: jnp.asarray(v) for k, v in d.items()}), grid, cfg, 30,
                               np.random.default_rng(7))
    tgrid = tvm.VoxelGrid.create((np.zeros(3), np.array([6.0, 5.0, 3.0])), tvm.VoxelConfig())
    got = tdatagen.generate_test_views(tvm.voxel_state_from_numpy(d, "cpu"), tgrid, tvm.VoxelConfig(), 30,
                                       np.random.default_rng(7))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_sample_test_views():
    sim = TBoxRoom(resolution=(32, 32), seed=0, device="cpu")
    views = tdatagen.sample_test_views_from_sim(sim, 25, seed=1)
    assert views.shape == (25, 4, 4)
    pos = views[:, :3, 3]
    assert (pos >= sim.bbox[0] - 0.5).all() and (pos <= sim.bbox[1] + 0.5).all()
    r = views[:, :3, :3]
    rr = np.einsum("nij,nik->njk", r, r)
    np.testing.assert_allclose(rr, np.broadcast_to(np.eye(3), rr.shape), atol=1e-5)


@pytest.mark.parametrize("shape", [(64, 64), (7, 13)])
def test_png_writer(tmp_path, shape):
    """PIL reads back exactly the written array, the same pixels as a PNG
    that PIL writes (the reference's writer)."""
    rgb = np.random.default_rng(sum(shape)).uniform(-0.1, 1.1, (*shape, 3)).astype(np.float32)
    img = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    write_png(str(tmp_path / "port.png"), img)
    Image.fromarray(img).save(str(tmp_path / "pil.png"))
    with Image.open(tmp_path / "port.png") as a, Image.open(tmp_path / "pil.png") as b:
        assert a.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(a), img)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "bad.png"), rgb)


@pytest.mark.parametrize("name", ["data_generation", "eval"])
def test_offline_configs_are_the_reference_s(name):
    port, ref = ROOT / "activegs_torch" / "config" / f"{name}.yaml", ROOT / "activegs_tpu" / "config" / f"{name}.yaml"
    assert port.read_bytes() == ref.read_bytes()
    for overrides in ([], ["planner=random", "num_views=3", "simulator.sensor.resolution=[64,64]"]):
        assert load_config(name, overrides).to_dict() == j_load_config(name, overrides).to_dict()


def test_offline_apps_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """A 2-step mission, then test views, meshes and the evaluation through
    the three apps with `device=cpu`. The mesh metrics run at 5000 samples
    here: at the default 500,000 the KD-tree queries alone take about a
    minute on the CPU."""
    out, data = str(tmp_path / "exp"), str(tmp_path / "datasets")
    tmain.main([*MISSION, "max_steps=2", f"experiment.output_dir={out}"])
    test_dir = tdatagen.main(["device=cpu", "simulator.sensor.resolution=[64,64]", f"dataset_path={data}",
                              "num_views=3", "max_iter=3"])
    assert test_dir == os.path.join(data, "boxroom_test")
    assert np.loadtxt(os.path.join(test_dir, "traj.txt")).shape == (3, 16)
    with Image.open(os.path.join(test_dir, "rgb", "00002.png")) as im:
        assert im.size == (64, 64)
    assert np.load(os.path.join(test_dir, "depth", "00002.npy")).shape == (64, 64)

    meshes = tmesh_app.main([*MISSION, f"experiment.output_dir={out}", "mesh_resolution=64"])
    assert [os.path.basename(p) for p in meshes] == ["mesh_final.ply"]
    exp = os.path.dirname(os.path.dirname(meshes[0]))
    with open(os.path.join(exp, "final_result.json"), "w") as f:
        json.dump({"kept": 1, "mean_psnr": None}, f)
    calc = tmetrics.calc_3d_mesh_metric
    monkeypatch.setattr(tmetrics, "calc_3d_mesh_metric", lambda rec, gt, dist_thres, n_samples: calc(
        rec, gt, dist_thres=dist_thres, n_samples=5000))
    result = teval_app.main([*MISSION, f"experiment.output_dir={out}", f"test_folder={test_dir}"])
    with open(os.path.join(exp, "final_result.json")) as f:
        assert json.load(f) == result
    assert set(result) == RESULT_KEYS | {"kept"} and result["step"] == ["final"]
    assert np.isfinite(result["mean_psnr"][0]) and result["mean_lpips"] == [None]
    assert all(np.isfinite(result[k][0]) for k in RESULT_KEYS - {"mean_lpips", "step"})


def test_plot(tmp_path):
    root = os.path.join(str(tmp_path), "scene")
    for planner in ("confidence", "random"):
        for run in range(2):
            d = os.path.join(root, planner, str(run))
            os.makedirs(d)
            with open(os.path.join(d, "final_result.json"), "w") as f:
                json.dump({"time": [60, 120, 180], "mean_psnr": [20 + run, 22 + run, 24 + run],
                           "mean_ssim": [0.7, 0.8, 0.85], "mean_depth_mse": [0.1, 0.05, 0.03]}, f)
    written = tplot.plot(root, os.path.join(str(tmp_path), "plots"))
    assert len(written) >= 3
    for p in written:
        assert os.path.getsize(p) > 1000


@pytest.mark.parametrize("app", [tdatagen, tmesh_app, teval_app], ids=["data_generation", "mesh_app", "eval_app"])
def test_apps_need_a_card_unless_told_cpu(monkeypatch, tmp_path, app):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["device=cuda"]):
        with pytest.raises(RuntimeError, match="device=cpu"):
            app.main([*argv, f"experiment.output_dir={tmp_path}", f"dataset_path={tmp_path}"])
    assert not os.listdir(tmp_path)
