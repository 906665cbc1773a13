"""The port's offline evaluation against the reference's: SSIM and PSNR, the
perceptual proxy (at an even and an odd image size, where XLA's 'SAME'
padding is asymmetric), the mesh metrics, TSDF integration, marching
tetrahedra and the cluster filter, PLY files, and `generate_mesh` /
`EvaluationTool.eval` on a map the reference spawned on two frames.

Inputs come from numpy seeds; the reference runs on the CPU with its
Pallas kernels in interpret mode, as its own tests run it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activegs_torch.core import geometry as tgeo
from activegs_torch.core import image_ops as timg
from activegs_torch.eval import evaluation as tevaluation
from activegs_torch.eval import metrics as tmetrics
from activegs_torch.eval import tsdf as ttsdf
from activegs_torch.io import ply as tply
from activegs_torch.mapping import gaussians as tgm
from activegs_torch.render.types import RasterConfig as TRasterConfig
from activegs_torch.sim.synthetic import BoxRoomSimulator as TBoxRoom
from activegs_tpu.core import geometry as jgeo
from activegs_tpu.eval import evaluation as jevaluation
from activegs_tpu.eval import metrics as jmetrics
from activegs_tpu.eval import tsdf as jtsdf
from activegs_tpu.io import ply as jply

torch.set_num_threads(2)

RES = 64
# the meshes of the reference's metric tests: a unit square, and the same
# square 10 cm above it
SQUARE = (np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32), np.array([[0, 1, 2], [0, 2, 3]], np.int32))
LIFTED = (SQUARE[0] + np.float32([0, 0, 0.1]), SQUARE[1])
# every TSDFState field, as numpy
TSDF_FIELDS = ("tsdf", "weight", "color")


def images(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(3, *shape)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(64, 64), (63, 50)])
def test_ssim_psnr_and_perceptual_match_reference(shape):
    a, b = images(shape, seed=sum(shape))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert tmetrics.cal_ssim(ta, tb) == pytest.approx(jmetrics.cal_ssim(jnp.asarray(a), jnp.asarray(b)), abs=1e-6)
    assert float(timg.ssim(ta[None], tb[None])) == pytest.approx(tmetrics.cal_ssim(ta, tb), abs=0)
    # PSNR: within 1e-6 dB of the float64 value of the same formula; the
    # reference's float32 mean rounds 5.3e-7 of the mean (2.3e-6 dB) away
    # from it on the 64x64 pair, so the two packages are held at 1e-5 dB
    exact = -10.0 * np.log10(np.mean((a.astype(np.float64) - b) ** 2) + 1e-8)
    assert tmetrics.cal_psnr(ta, tb) == pytest.approx(exact, abs=1e-6)
    assert tmetrics.cal_psnr(ta, tb) == pytest.approx(jmetrics.cal_psnr(jnp.asarray(a), jnp.asarray(b)), abs=1e-5)
    assert tmetrics.cal_mse(ta, tb, 0.5) == pytest.approx(jmetrics.cal_mse(jnp.asarray(a), jnp.asarray(b), 0.5),
                                                          rel=1e-6)
    got, want = tmetrics.cal_perceptual(ta, tb), jmetrics.cal_perceptual(a, b)
    assert got == pytest.approx(want, rel=1e-5)
    assert tmetrics.cal_perceptual(ta, ta) == pytest.approx(0.0, abs=1e-10)


def test_same_padding_is_xla_s():
    """(before, after) of XLA's 'SAME' at stride 2, window 3: (0, 1) on even
    lengths, (1, 1) on odd ones."""
    assert [tmetrics._same_pad(n) for n in (64, 63, 32, 50, 25, 2, 1)] == [
        (0, 1), (1, 1), (0, 1), (0, 1), (1, 1), (0, 1), (1, 1)]


def test_lpips_is_none_without_local_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    tmetrics._lpips_model.cache_clear()
    img = torch.zeros(3, 8, 8)
    assert not tmetrics.lpips_available()
    assert tmetrics.cal_lpips(img, img) is None
    tmetrics._lpips_model.cache_clear()


@pytest.mark.parametrize("rec, gt", [(SQUARE, SQUARE), (LIFTED, SQUARE)], ids=["identical", "lifted"])
def test_mesh_metrics_are_bitwise_the_reference_s(rec, gt):
    np.testing.assert_array_equal(tmetrics.sample_surface(*rec, 5000), jmetrics.sample_surface(*rec, 5000))
    got = tmetrics.calc_3d_mesh_metric(rec, gt, dist_thres=0.02, n_samples=20000)
    assert got == jmetrics.calc_3d_mesh_metric(rec, gt, dist_thres=0.02, n_samples=20000)
    assert tmetrics.sample_surface(SQUARE[0], SQUARE[1][:0], 10).shape == (0, 3)


def wall_views():
    """The reference's TSDF test views: a fronto-parallel wall at z = 2 seen
    from three x offsets, plus a seeded view of random depth and colour."""
    rng = np.random.default_rng(3)
    views = []
    for dx in (-0.2, 0.0, 0.2):
        e = np.eye(4, dtype=np.float32)
        e[0, 3] = dx
        views.append((np.full((3, RES, RES), 0.5, np.float32), np.full((RES, RES), 2.0, np.float32), e))
    e = np.eye(4, dtype=np.float32)
    e[:3, 3] = (0.1, -0.05, 0.2)
    depth = rng.uniform(1.4, 2.4, (RES, RES)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = -2.0
    views.append((rng.uniform(size=(3, RES, RES)).astype(np.float32), depth, e))
    return views


def as_numpy(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in TSDF_FIELDS}


@pytest.fixture(scope="module")
def fused():
    """The wall views fused by both packages: (grid, reference state, port
    state), each as numpy."""
    k = np.array(jgeo.intrinsics_from_fov(60.0, 60.0))
    grid = jtsdf.TSDFGrid.create((np.array([-1.5, -1.5, 1.0]), np.array([1.5, 1.5, 2.5])), voxel=0.05)
    tgrid = ttsdf.TSDFGrid.create((np.array([-1.5, -1.5, 1.0]), np.array([1.5, 1.5, 2.5])), voxel=0.05)
    assert dataclasses.asdict(tgrid) == dataclasses.asdict(grid)
    j_state, t_state = jtsdf.init_state(grid), ttsdf.init_state(tgrid, "cpu")
    for rgb, depth, e in wall_views():
        j_state = jtsdf.integrate(j_state, grid, jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(e), jnp.asarray(k))
        t_state = ttsdf.integrate(t_state, tgrid, torch.from_numpy(rgb), torch.from_numpy(depth), torch.from_numpy(e),
                                  torch.from_numpy(k))
    return tgrid, as_numpy(j_state), ttsdf.tsdf_state_to_numpy(t_state)


def test_grid_points_are_the_reference_s():
    grid = ttsdf.TSDFGrid.create((np.array([-1.0, -0.5, 0.2]), np.array([1.0, 0.7, 1.1])), voxel=0.03)
    jgrid = jtsdf.TSDFGrid(**dataclasses.asdict(grid))
    np.testing.assert_array_equal(grid.points_on("cpu").numpy(), np.asarray(jtsdf._grid_points(jgrid)))
    assert grid.points_on("cpu") is grid.points_on(torch.device("cpu"))


def test_integrate_matches_reference(fused):
    _, want, got = fused
    np.testing.assert_array_equal(got["weight"], want["weight"])
    assert got["weight"].max() == 4 and (got["weight"] == 0).mean() > 0.1
    np.testing.assert_allclose(got["tsdf"], want["tsdf"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["color"], want["color"], atol=1e-6, rtol=0)


def sphere_state(grid):
    """The reference's analytic sphere TSDF (radius 0.6) on `grid`."""
    pts = np.asarray(jtsdf._grid_points(grid))
    sdf = np.linalg.norm(pts, axis=1) - 0.6
    rgb = np.stack([pts[:, 0] * 0 + 0.25, np.abs(pts[:, 1]), np.abs(pts[:, 2])], 1)
    return {"tsdf": np.clip(sdf / grid.trunc, -1, 1), "weight": np.ones(grid.num), "color": rgb}


@pytest.mark.parametrize("case", ["sphere", "walls"])
def test_extract_mesh_and_filter_are_bitwise_the_reference_s(case, fused):
    if case == "sphere":
        grid = jtsdf.TSDFGrid.create((np.array([-1.0, -1, -1]), np.array([1.0, 1, 1])), voxel=0.05, trunc=0.2)
        d = {k: np.asarray(v, np.float32) for k, v in sphere_state(grid).items()}
    else:
        tgrid, d, _ = fused
        grid = jtsdf.TSDFGrid(**dataclasses.asdict(tgrid))
    tgrid = ttsdf.TSDFGrid(**dataclasses.asdict(grid))
    want = jtsdf.extract_mesh(jtsdf.TSDFState(**{k: jnp.asarray(v) for k, v in d.items()}), grid)
    got = ttsdf.extract_mesh(ttsdf.tsdf_state_from_numpy(d, "cpu"), tgrid)
    assert len(want[1]) > 100
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for min_tris in (5, 10_000):
        for a, b in zip(ttsdf.filter_isolated(*got, min_tris=min_tris), jtsdf.filter_isolated(*want, min_tris=min_tris)):
            np.testing.assert_array_equal(a, b)


def test_ply_files_are_the_reference_s(tmp_path):
    rng = np.random.default_rng(0)
    verts = rng.uniform(size=(20, 3)).astype(np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
    colors = rng.uniform(size=(20, 3)).astype(np.float32)
    for c in (colors, None):
        t_path, j_path = str(tmp_path / "port.ply"), str(tmp_path / "ref.ply")
        tply.save_ply(t_path, verts, faces, c)
        jply.save_ply(j_path, verts, faces, c)
        assert open(t_path, "rb").read() == open(j_path, "rb").read()
        for a, b in zip(tply.load_ply(j_path), jply.load_ply(t_path)):
            np.testing.assert_array_equal(a, b)
    ascii_path = tmp_path / "quad.ply"
    ascii_path.write_text("ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\nproperty float y\n"
                          "property float z\nelement face 1\nproperty list uchar int vertex_indices\nend_header\n"
                          "0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
    for a, b in zip(tply.load_ply(str(ascii_path)), jply.load_ply(str(ascii_path))):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def spawned():
    """A map the reference spawned on two 64x64 frames of its boxroom
    (`tests/test_eval.py`'s setup, spawn only), with its config, frames and
    simulator, and the same map in the port."""
    from activegs_tpu.mapping import gaussians as jgm
    from activegs_tpu.render.types import RasterConfig as JRasterConfig
    from activegs_tpu.sim.synthetic import BoxRoomSimulator as JBoxRoom
    from test_mapping import look_at_pose

    raster = JRasterConfig(interpret=True)
    cfg = jgm.MapConfig(capacity=8192, bilateral_radius=2)
    sim = JBoxRoom(resolution=(RES, RES), seed=5, depth_noise_co=0.0)
    poses = [look_at_pose((3.0, 2.5, 1.5), (5.5, 2.5, 1.2)), look_at_pose((3.0, 2.5, 1.5), (5.5, 3.5, 1.2))]
    state = jgm.init_state(cfg)
    frames = []
    for p in poses:
        f = sim.simulate(p)
        frames.append(f)
        state, _, _ = jgm.spawn(state, f, cfg, raster)
    n = int(state.count)
    t_state = tgm.state_from_numpy({f: np.asarray(getattr(state, f))[:n] for f in tgm.FIELDS}, "cpu", cfg.capacity)
    t_cfg = tgm.MapConfig(capacity=cfg.capacity, bilateral_radius=2)
    cams = [(np.asarray(f["extrinsic"]), np.asarray(f["intrinsic"])) for f in frames]
    return {"state": state, "cfg": cfg, "raster": raster, "sim": sim, "poses": poses, "cams": cams,
            "t_state": t_state, "t_cfg": t_cfg}


MESH_ARGS = dict(resolution=RES, voxel=0.08, trunc=0.3, min_cluster_tris=10)


def test_generate_mesh_matches_reference(spawned):
    """The fused TSDF of the two frames' renders (weights equal at >= 99.9%
    of voxels), and the mesh of each package within the room."""
    s = spawned
    jgm_ = jevaluation.gm
    bucket = jgm_.bucket_capacity(int(s["state"].count), s["cfg"].capacity)
    j_attrs = jgm_.attrs_of(jgm_.slice_state(s["state"], bucket), s["cfg"])
    means = np.asarray(s["state"].means[: int(s["state"].count)])
    bbox = (means.min(0) - 0.1, means.max(0) + 0.1)
    grid = jtsdf.TSDFGrid.create(bbox, voxel=MESH_ARGS["voxel"], trunc=MESH_ARGS["trunc"])
    tgrid = ttsdf.TSDFGrid(**dataclasses.asdict(grid))
    j_st, t_st = jtsdf.init_state(grid), ttsdf.init_state(tgrid, "cpu")
    t_attrs = tgm.attrs_of(tgm.slice_state(s["t_state"], tgm.bucket_capacity(s["t_state"].count, s["t_cfg"].capacity)),
                           s["t_cfg"])
    for ext, intr in s["cams"]:
        j_st = jevaluation._render_and_integrate(j_st, j_attrs, jnp.asarray(ext), jnp.asarray(intr), grid, (RES, RES),
                                                 s["raster"])
        out, _ = tevaluation.render_view(t_attrs, tevaluation.Camera(torch.from_numpy(ext), torch.from_numpy(intr)),
                                         (RES, RES), TRasterConfig())
        t_st = ttsdf.integrate(t_st, tgrid, out.rgb, out.depth[0], torch.from_numpy(ext), torch.from_numpy(intr))
    want, got = as_numpy(j_st), ttsdf.tsdf_state_to_numpy(t_st)
    assert (got["weight"] == want["weight"]).mean() >= 0.999 and want["weight"].max() == 2
    # the reference's jitted render-and-integrate contracts multiply-adds,
    # which moves a few voxels' projections across a pixel edge: the TSDF
    # agrees at 1e-4 on all but those (74 of 74340 voxels here)
    assert (np.abs(got["tsdf"] - want["tsdf"]) <= 1e-4).mean() >= 0.998

    j_mesh = jevaluation.generate_mesh(s["state"], s["cfg"], s["cams"], raster_cfg=s["raster"], **MESH_ARGS)
    t_mesh = tevaluation.generate_mesh(s["t_state"], s["t_cfg"], s["cams"], raster_cfg=TRasterConfig(), **MESH_ARGS)
    for verts, faces, _ in (j_mesh, t_mesh):
        assert len(faces) > 50
        assert (verts >= s["sim"].bbox[0] - 0.3).all() and (verts <= s["sim"].bbox[1] + 0.3).all()
    assert abs(len(t_mesh[1]) - len(j_mesh[1])) <= 0.01 * len(j_mesh[1])


class ReferenceFrames:
    """The reference simulator's ground-truth frames as CPU tensors: both
    tools score against the same frames (the two ray casts flip a few
    pixels on the room's checker lines, `test_torch_mapping.py`)."""

    def __init__(self, sim):
        self.sim = sim

    def simulate(self, pose, require_gt=False):
        return {k: torch.from_numpy(np.array(v)) for k, v in self.sim.simulate(pose, require_gt=require_gt).items()}


def reference_scores(s, pose) -> dict:
    """The reference's per-view scores of one pose computed op by op: its
    `render_view` and its metric functions, outside `jit`."""
    from activegs_tpu.render.renderer import render_view
    from activegs_tpu.render.types import Camera

    f = s["sim"].simulate(pose, require_gt=True)
    out, _ = render_view(jevaluation.gm.attrs_of(s["state"], s["cfg"]), Camera(f["extrinsic"], f["intrinsic"]),
                         (RES, RES), s["raster"], background=jnp.asarray(s["cfg"].background))
    pred = jnp.clip(out.rgb, 0.0, 1.0)
    valid = (f["depth"] > 0).astype(jnp.float32)
    return {"mean_psnr": -10.0 * np.log10(float(jnp.mean((pred - f["rgb"]) ** 2)) + 1e-8),
            "mean_ssim": jmetrics.cal_ssim(pred, f["rgb"]),
            "mean_depth_mse": jmetrics.cal_mse(out.depth, f["depth"], valid),
            "mean_perceptual": jmetrics.cal_perceptual(pred, f["rgb"])}


def test_evaluation_tool_matches_reference(spawned):
    """At each of two test poses: against the reference's scores computed op
    by op, PSNR within 1e-3 dB, SSIM 1e-5, depth MSE and the perceptual
    distance 1e-4 relative; against the reference's `EvaluationTool.eval`,
    PSNR and depth MSE at those tolerances, SSIM at 2e-4 and the
    perceptual distance at 2e-3 relative: its jitted scorer fuses the
    render, which moves its own image by up to 0.0114 at 998 of the 12288
    values at the second pose (the port is within 1.2e-7 of the op-by-op
    render). The mesh metrics of one mesh bitwise."""
    from activegs_tpu.eval.evaluation import EvaluationTool as JTool

    s = spawned
    mesh = jevaluation.generate_mesh(s["state"], s["cfg"], s["cams"], raster_cfg=s["raster"], **MESH_ARGS)[:2]
    gt = (s["sim"].mesh_vertices, s["sim"].mesh_faces)
    frames = ReferenceFrames(s["sim"])
    for pose in s["poses"]:
        want = JTool([(s["state"], s["cfg"])], [mesh], np.stack([pose]), s["sim"], gt, s["raster"]).eval(
            mesh_dist_thres=0.1, mesh_samples=20000)
        got = tevaluation.EvaluationTool([(s["t_state"], s["t_cfg"])], [mesh], np.stack([pose]), frames, gt,
                                         TRasterConfig()).eval(mesh_dist_thres=0.1, mesh_samples=20000)
        assert set(got) == set(want) and got["mean_lpips"] == want["mean_lpips"] == [None]
        eager = reference_scores(s, pose)
        for ref, ssim_tol, perc_tol in ((eager, 1e-5, 1e-4), (want, 2e-4, 2e-3)):
            ref = {k: v[0] if isinstance(v, list) else v for k, v in ref.items()}
            assert got["mean_psnr"][0] == pytest.approx(ref["mean_psnr"], abs=1e-3)
            assert got["mean_ssim"][0] == pytest.approx(ref["mean_ssim"], abs=ssim_tol)
            assert got["mean_depth_mse"][0] == pytest.approx(ref["mean_depth_mse"], rel=1e-4)
            assert got["mean_perceptual"][0] == pytest.approx(ref["mean_perceptual"], rel=perc_tol)
        for k in ("mesh_accuracy", "mesh_completion", "mesh_completion_ratio", "mesh_chamfer_distance"):
            assert got[k] == want[k], k
        assert want["mean_psnr"][0] > 10


def test_score_view_runs_on_the_port_s_geometry():
    """`score_view` of an empty map at one pose: the background render,
    scored as `cal_psnr` / `cal_ssim` / `cal_perceptual` score it."""
    sim = TBoxRoom(resolution=(RES, RES), seed=0, device="cpu")
    frame = sim.simulate(tgeo.look_at((3.0, 2.5, 1.5), (5.0, 2.5, 1.2), device="cpu"), require_gt=True)
    cfg = tgm.MapConfig(capacity=256, background=(0.2, 0.4, 0.6))
    attrs = tgm.attrs_of(tgm.init_state(cfg, "cpu"), cfg)
    bg = torch.tensor(cfg.background)
    p, s, d, pc, rgb = tevaluation.score_view(attrs, bg, frame["extrinsic"], frame["intrinsic"], frame["rgb"],
                                              frame["depth"], (RES, RES), TRasterConfig())
    torch.testing.assert_close(rgb, bg[:, None, None].expand(3, RES, RES))
    assert float(p) == pytest.approx(tmetrics.cal_psnr(rgb, frame["rgb"]), abs=1e-4)
    assert float(s) == pytest.approx(tmetrics.cal_ssim(rgb, frame["rgb"]), abs=1e-6)
    assert float(pc) == pytest.approx(tmetrics.cal_perceptual(rgb, frame["rgb"]), rel=1e-6)
    assert float(d) > 0
