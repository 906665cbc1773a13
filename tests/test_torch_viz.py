"""The port's viewers against the reference's: `viz/viewer.py` (channel
panel, voxel top view, scene overlay, `MissionViewer`), `viz/webviewer.py`
(every endpoint after a CPU mission step) and `apps/visualize.py`, and the
viewers from `apps.main` (`dump_views`, `use_gui`).

The panels render on one map that the reference spawned and the port
loaded; a render differs by at most 2e-5 between the packages, so a uint8
pixel may round one apart: within 1 at >= 99.9% of values, within 2
everywhere. The colormap and the overlays, given the same float inputs,
are bitwise the reference's. PNGs are read back with PIL here.
"""

import dataclasses
import glob
import io
import json
import os
import sys
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from activegs_torch.apps import main as tmain
from activegs_torch.apps import visualize as tvis
from activegs_torch.io import checkpoint as tckpt
from activegs_torch.mapping import voxel_map as tvm
from activegs_torch.mapping.mapper import IncrementalMapper
from activegs_torch.planning.confidence import ConfidencePlanner
from activegs_torch.planning.planner import PlannerConfig
from activegs_torch.render.types import Camera, RasterConfig
from activegs_torch.sim.synthetic import BoxRoomSimulator
from activegs_torch.viz import viewer as tview
from activegs_torch.viz.webviewer import WebViewer
from activegs_tpu.apps import visualize as jvis
from activegs_tpu.render.types import Camera as JCamera
from activegs_tpu.viz import viewer as jview
from test_torch_apps import CLI_OVERRIDES
from test_torch_core import to_t
from test_torch_mapping import t_state
from test_torch_planning import MAPCFG, POSES, RASTER, T_MAPCFG, T_RASTER, T_VOXCFG, VOXCFG, t_grid, t_vstate, world  # noqa: F401

torch.set_num_threads(2)


def assert_uint8_close(got, want):
    """Within 1 at >= 99.9% of values, within 2 everywhere."""
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 2 and np.mean(d <= 1) >= 0.999, (d.max(), np.mean(d <= 1))


def png(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def test_colormap_and_drawing_are_the_references_bitwise():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 6, (17, 23)).astype(np.float32)
    x[3, 4] = np.nan
    for args in ((), (0.0, 5.0), (0, 1), (2.0, 2.0)):
        np.testing.assert_array_equal(tview._colormap(x, *args), jview._colormap(x, *args))
    a, b = np.zeros((40, 30, 3), np.float32), np.zeros((40, 30, 3), np.float32)
    for p0, p1 in (((1.5, 2.2), (37.9, 28.1)), ((-3, 5), (50, -2)), ((10, 10), (10, 10))):
        tview._draw_line(a, p0, p1, [1.0, 0.5, 0.25])
        jview._draw_line(b, p0, p1, [1.0, 0.5, 0.25])
    for p, r in (((5.2, 7.9), 1), ((0.3, 29.5), 2)):
        tview._draw_dot(a, p, [0.1, 0.9, 0.95], r)
        jview._draw_dot(b, p, [0.1, 0.9, 0.95], r)
    np.testing.assert_array_equal(a, b)


def test_channel_panel_matches_reference(world):
    sim, _, _, _, state = world
    shape = (64, 64)
    want = jview.render_channel_panel(state, MAPCFG, JCamera(jnp.asarray(POSES[0]), sim.intrinsic), shape, RASTER)
    got = tview.render_channel_panel(t_state(state), T_MAPCFG, Camera(to_t(POSES[0]), to_t(sim.intrinsic)), shape,
                                     T_RASTER)
    assert got.shape == (128, 192, 3) and got.max() > 0
    assert_uint8_close(got, want)


def test_voxel_top_view_and_scene_overlay_are_the_references(world):
    sim, frames, grid, vstate, _ = world
    tg, tv = t_grid(grid), t_vstate(vstate)
    np.testing.assert_array_equal(tview.voxel_top_view(tv, tg, T_VOXCFG), jview.voxel_top_view(vstate, grid, VOXCFG))
    rng = np.random.default_rng(1)
    exec_path = np.stack([np.asarray(f["extrinsic"])[:3, 3] for f in frames])
    planned = np.stack(POSES)
    cands = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    cands[:, :3, 3] = exec_path[0] + rng.uniform(-1, 1, (6, 3))
    kw = dict(exec_path=exec_path, planned_path=planned, candidates=cands, nbv=cands[2])
    want = jview.scene_overlay(vstate, grid, VOXCFG, camera=JCamera(jnp.asarray(POSES[1]), sim.intrinsic), **kw)
    got = tview.scene_overlay(tv, tg, T_VOXCFG, camera=Camera(to_t(POSES[1]), to_t(sim.intrinsic)), **kw)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 4


def small_mission(viewer, res=32):
    """A mapper at the reference's web-viewer test sizes, on the CPU."""
    raster = RasterConfig(entry_budget_mult=4.0)
    mapcfg = dataclasses.replace(T_MAPCFG, capacity=4096, optimization_steps=2)
    voxcfg = tvm.VoxelConfig(map_resolution=(0.5, 0.5, 0.5))
    init_pose = ((0.0, 0.0, 1.0, 1.0), (-1.0, 0.0, 0.0, 2.5), (0.0, -1.0, 0.0, 1.5), (0.0, 0.0, 0.0, 1.0))
    planner = ConfidencePlanner(PlannerConfig(sample_num=8, max_roi_sample_num=0, radius=1.5, init_pose=init_pose),
                                mapcfg, voxcfg, raster)
    mapper = IncrementalMapper(mapcfg, voxcfg, raster, keyframe_capacity=8, device="cpu", viewer=viewer)
    mapper.load_simulator(BoxRoomSimulator(resolution=(res, res), seed=1, device="cpu"))
    mapper.load_planner(planner)
    mapper.init_map()
    return mapper, planner


def test_web_viewer_serves_the_mission(tmp_path):
    """`tests/test_apps.py::TestWebViewer` on the port: every endpoint
    after one step, the fly-cam's channels, filter and scale, recorded
    poses, the scene after a planned step, 404s."""
    viewer = WebViewer(port=0, shape=(32, 32))
    try:
        base = f"http://127.0.0.1:{viewer.port}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=30) as r:
                return r.status, r.headers.get("Content-Type"), r.read()

        for path in ("/panel.png", "/fly.png", "/record_pose"):
            with pytest.raises(urllib.error.HTTPError) as e:
                get(path)
            assert e.value.code == 404
        mapper, planner = small_mission(viewer)
        mapper.step()

        code, ctype, body = get("/")
        assert code == 200 and "html" in ctype and b"fly-cam" in body
        code, ctype, body = get("/stats.json")
        stats = json.loads(body)
        assert code == 200 and stats["frame_id"] == 1 and np.isfinite(stats["loss"])
        for path in ("/panel.png", "/voxel.png", "/scene.png"):
            code, ctype, body = get(path)
            assert code == 200 and ctype == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n", path
        assert png(get("/panel.png")[2]).shape == (64, 96, 3)
        for q in ("dx=0.2&yaw=0.3&chan=depth", "chan=rgb", "chan=d2n", "chan=normal", "chan=confidence", "chan=nope"):
            code, ctype, body = get(f"/fly.png?{q}")
            assert code == 200 and png(body).shape == (32, 32, 3), q
        assert np.array_equal(png(get("/fly.png?chan=nope")[2]), png(get("/fly.png?chan=rgb")[2]))
        plain = png(get("/fly.png?chan=opacity")[2])
        hidden = png(get("/fly.png?chan=opacity&conf_min=1.01")[2])
        shrunk = png(get("/fly.png?chan=opacity&scale_mod=0.2")[2])
        assert len(np.unique(hidden.reshape(-1, 3), axis=0)) == 1
        assert not np.array_equal(plain, hidden) and not np.array_equal(plain, shrunk)
        assert json.loads(get("/record_pose?dx=0.1&yaw=0.2")[2])["count"] == 1
        assert json.loads(get("/record_pose?dz=-0.3")[2])["count"] == 2
        poses = np.asarray(json.loads(get("/poses.json")[2]))
        assert poses.shape == (2, 4, 4)
        np.testing.assert_allclose(poses[0, :3, :3] @ poses[0, :3, :3].T, np.eye(3), atol=1e-5)
        mapper.step()
        assert planner.last_candidates is not None and planner.last_nbv is not None
        assert json.loads(get("/stats.json")[2])["frame_id"] == 2
        assert get("/scene.png")[0] == 200
        with pytest.raises(urllib.error.HTTPError) as e:
            get("/nope")
        assert e.value.code == 404
    finally:
        viewer.close()


def test_mission_viewer_writes_the_panels(tmp_path):
    mapper, _ = small_mission(tview.MissionViewer(str(tmp_path / "viewer"), shape=(24, 24)))
    mapper.step()
    mapper.step()
    names = sorted(os.listdir(tmp_path / "viewer"))
    assert names == ["channels_001.png", "channels_002.png", "voxels_001.png", "voxels_002.png"]
    assert np.asarray(Image.open(tmp_path / "viewer" / "channels_002.png")).shape == (48, 72, 3)
    top = tview.voxel_top_view(mapper.vm_state, mapper.grid, mapper.voxel_cfg)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "viewer" / "voxels_002.png")), top)


def test_visualize_writes_the_references_orbit(world, tmp_path, monkeypatch):
    """`python -m activegs_torch.apps.visualize` on a map the reference
    spawned: the reference's orbit poses, PNGs that PIL reads, each within
    the uint8 tolerance of the reference's `visualize` on the same map."""
    _, _, _, _, state = world
    path = str(tmp_path / "map.npz")
    tckpt.save_gaussian_map(path, t_state(state), T_MAPCFG)
    center, radius = np.array([3.0, 2.5, 1.2]), 1.7
    for a, b in zip(tvis.orbit_poses(center, radius, 0.5, 5), jvis.orbit_poses(center, radius, 0.5, 5)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    args = ["--map", path, "--views", "2", "--resolution", "48"]
    written = tvis.main([*args, "--out", str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["visualize", *args, "--out", str(tmp_path / "ref")])
    jvis.main()
    assert [os.path.basename(p) for p in written] == ["view_00.png", "view_01.png"]
    for p in written:
        got = np.asarray(Image.open(p))
        assert got.shape == (96, 144, 3) and got.max() > 0
        assert_uint8_close(got, np.asarray(Image.open(str(tmp_path / "ref" / os.path.basename(p)))))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tvis.main([*args, "--out", str(tmp_path / "none")])


@pytest.mark.parametrize("option", ["dump_views", "use_gui"])
def test_main_runs_the_viewers(tmp_path, option):
    """`apps.main` with `dump_views=true` writes each step's panels under
    `<experiment>/viewer/`; with `use_gui=true` on a free port (`gui_port=0`)
    it serves the finished mission."""
    argv = ["device=cpu", f"{option}=true", "gui_port=0", *CLI_OVERRIDES, f"experiment.output_dir={tmp_path}"]
    mapper = tmain.main(argv)
    if option == "dump_views":
        files = sorted(glob.glob(str(tmp_path / "*" / "*" / "*" / "*" / "viewer" / "*.png")))
        assert [os.path.basename(f) for f in files] == [
            "channels_001.png", "channels_002.png", "voxels_001.png", "voxels_002.png"]
        assert all(np.asarray(Image.open(f)).dtype == np.uint8 for f in files)
        return
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{mapper.viewer.port}/stats.json", timeout=30) as r:
            assert json.loads(r.read())["frame_id"] == 2
        with urllib.request.urlopen(f"http://127.0.0.1:{mapper.viewer.port}/fly.png?chan=depth", timeout=30) as r:
            assert png(r.read()).shape == (256, 256, 3)
    finally:
        mapper.viewer.close()
