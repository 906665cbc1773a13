"""Parity of the PyTorch port's voxel map and planners with the JAX reference.

Voxel map (update, masks, dilation, ROI / normals), A*, candidate
generation and the per-candidate (explore, exploit) utilities. Both packages
get the same frames, the same surfel map (`state_from_numpy`) and the same
voxel state (`voxel_state_from_numpy`); candidate sampling takes the same
`np.random.default_rng` seed in both. Runs at 64 x 64 on the CPU, the
reference's Pallas kernels in interpret mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activegs_torch.mapping import gaussians as tgm
from activegs_torch.mapping import voxel_map as tvm
from activegs_torch.planning import astar as tastar
from activegs_torch.planning import paths as tpaths
from activegs_torch.planning import confidence as tcf
from activegs_torch.planning import get_planner
from activegs_torch.planning.planner import PlanBase as TPlanBase
from activegs_torch.planning.planner import PlannerConfig as TPlannerConfig
from activegs_torch.planning.planner import resize_nearest
from activegs_torch.render import types as tt
from activegs_torch.sim import synthetic as tsyn
from activegs_tpu.core import geometry as jgeo
from activegs_tpu.mapping import gaussians as jgm
from activegs_tpu.mapping import voxel_map as jvm
from activegs_tpu.planning import astar as jastar
from activegs_tpu.planning import paths as jpaths
from activegs_tpu.planning import confidence as jcf
from activegs_tpu.planning.planner import PlanBase as JPlanBase
from activegs_tpu.planning.planner import PlannerConfig as JPlannerConfig
from activegs_tpu.render.types import RasterConfig
from activegs_tpu.sim.synthetic import BoxRoomSimulator
from test_mapping import look_at_pose
from test_planning import TestAStar
from test_torch_core import t_like, to_t
from test_torch_mapping import t_frame, t_state

torch.set_num_threads(2)

RES = 64
RASTER = RasterConfig(entry_budget_mult=4.0, interpret=True)
MAPCFG = jgm.MapConfig(capacity=8192, bilateral_radius=2)
VOXCFG = jvm.VoxelConfig(min_gaussian_per_voxel=2)
T_RASTER = t_like(tt.RasterConfig, RASTER)
T_VOXCFG = t_like(tvm.VoxelConfig, VOXCFG)
T_MAPCFG = t_like(tgm.MapConfig, MAPCFG)
POSES = [
    look_at_pose((3.0, 2.5, 1.5), (5.5, 2.5, 1.2)),
    look_at_pose((3.0, 2.5, 1.5), (5.0, 4.0, 1.0)),
    look_at_pose((3.2, 2.3, 1.5), (5.5, 2.0, 1.5)),
]
INIT_POSE = ((0.0, 0.0, 1.0, 1.0), (-1.0, 0.0, 0.0, 2.5), (0.0, -1.0, 0.0, 1.5), (0.0, 0.0, 0.0, 1.0))


@pytest.fixture(scope="module")
def world():
    """Reference frames, grid and voxel state after 3 frames, and the
    reference surfel map after spawning frame 0."""
    sim = BoxRoomSimulator(resolution=(RES, RES), seed=3, depth_noise_co=0.002)
    frames = [sim.simulate(p) for p in POSES]
    grid = jvm.VoxelGrid.create(sim.bbox, VOXCFG)
    vstate = jvm.init_state(grid)
    for f in frames:
        vstate = jvm.update(vstate, grid, f)
    state, _, _ = jgm.spawn(jgm.init_state(MAPCFG), frames[0], MAPCFG, RASTER)
    return sim, frames, grid, vstate, state


def t_vstate(vs) -> tvm.VoxelMapState:
    return tvm.voxel_state_from_numpy({f.name: np.asarray(getattr(vs, f.name)) for f in dataclasses.fields(vs)}, "cpu")


def t_grid(grid) -> tvm.VoxelGrid:
    return tvm.VoxelGrid(grid.bbox_min, grid.bbox_max, grid.dim, grid.size)


def near_pixel_edge(grid, frame, tol=1e-4) -> np.ndarray:
    """Voxels in front of the camera whose center projects inside the image
    within `tol` px of a pixel edge."""
    h, w = np.asarray(frame["depth"]).shape[-2:]
    uv, _, front = jgeo.project_points(jnp.asarray(grid.centers), frame["extrinsic"], frame["intrinsic"])
    xy = np.asarray(uv) * np.array([w, h])
    inside = np.asarray(front) & np.all((xy > -tol) & (xy < np.array([w, h]) + tol), axis=-1)
    return inside & np.any(np.abs(xy - np.round(xy)) < tol, axis=-1)


def test_voxel_update_matches_reference(world):
    """3 frames of `update`: log-odds to 1e-5; the hit and unexplored masks
    equal, except at voxels whose center projects within 1e-4 px of a pixel
    edge (the two packages may truncate those to neighbouring pixels)."""
    sim, frames, grid, _, _ = world
    tgrid = tvm.VoxelGrid.create(sim.bbox, T_VOXCFG)
    assert (tgrid.dim, tgrid.size, tgrid.bbox_min) == (grid.dim, grid.size, grid.bbox_min)
    np.testing.assert_array_equal(tgrid.centers, np.asarray(grid.centers))
    sj, st = jvm.init_state(grid), tvm.init_state(tgrid, "cpu")
    edge = np.zeros(grid.num_voxels, bool)
    for f in frames:
        sj, st = jvm.update(sj, grid, f), tvm.update(st, tgrid, t_frame(f))
        edge |= near_pixel_edge(grid, f)
        pts = np.asarray(jgeo.backproject_depth(f["depth"][0], f["extrinsic"], f["intrinsic"])).reshape(-1, 3)
        ok = np.asarray(f["depth"][0]).reshape(-1) >= 0
        ij, inj = grid.voxelize(jnp.asarray(pts))
        it, int_ = tgrid.voxelize(to_t(pts))
        assert np.array_equal(np.asarray(inj) & ok, int_.numpy() & ok)
        np.testing.assert_array_equal(np.asarray(ij)[ok & np.asarray(inj)], it.numpy()[ok & np.asarray(inj)])
    bad = np.asarray(sj.unexplored) != st.unexplored.numpy()
    print(f"\nunexplored mismatches {bad.sum()} (all at pixel edges: {not (bad & ~edge).any()}), "
          f"edge voxels {edge.sum()} of {grid.num_voxels}")
    assert not (bad & ~edge).any() and bad.sum() <= max(1, edge.sum() // 10)
    same = ~bad
    np.testing.assert_allclose(st.log_odds.numpy()[same], np.asarray(sj.log_odds)[same], rtol=0, atol=1e-5)


def test_voxel_masks_match_reference(world):
    _, _, grid, vstate, _ = world
    tgrid, ts = t_grid(grid), t_vstate(vstate)
    for name in ("free_mask", "occ_mask", "unknown_mask"):
        np.testing.assert_array_equal(
            getattr(tvm, name)(ts, T_VOXCFG).numpy(), np.asarray(getattr(jvm, name)(vstate, VOXCFG)), err_msg=name
        )
    for name in ("free_mask_w_margin", "frontier_mask"):
        np.testing.assert_array_equal(
            getattr(tvm, name)(ts, tgrid, T_VOXCFG).numpy(), np.asarray(getattr(jvm, name)(vstate, grid, VOXCFG)),
            err_msg=name,
        )
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.5, 6.5, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tvm.occupied_filter(ts, tgrid, T_VOXCFG, to_t(pts)).numpy(),
        np.asarray(jvm.occupied_filter(vstate, grid, VOXCFG, jnp.asarray(pts))),
    )
    f = world[1][0]
    depth = np.where(np.asarray(f["depth"][0]) == -1.0, 5.0, np.asarray(f["depth"][0]))
    np.testing.assert_array_equal(
        tvm.visible_mask(None, tgrid, to_t(f["extrinsic"]), to_t(f["intrinsic"]), to_t(depth)).numpy(),
        np.asarray(jvm.visible_mask(None, grid, f["extrinsic"], f["intrinsic"], jnp.asarray(depth))),
    )


@pytest.mark.parametrize("radius", [1.0, 1.5, 2.2])
def test_dilate_matches_scipy(world, radius):
    from scipy.ndimage import binary_dilation

    grid = t_grid(world[2])
    mask = np.random.default_rng(int(radius * 10)).uniform(size=grid.num_voxels) > 0.9
    for offs in (tvm.sphere_offsets(radius), tvm.CROSS_OFFSETS):
        r = max(max(abs(c) for c in o) for o in offs)
        elem = np.zeros((2 * r + 1,) * 3, bool)
        for o in offs:
            elem[o[0] + r, o[1] + r, o[2] + r] = True
        want = binary_dilation(mask.reshape(grid.dim), structure=elem).reshape(-1)
        np.testing.assert_array_equal(tvm.dilate(torch.from_numpy(mask), grid, offs).numpy(), want)


def test_paths_and_graph_match_reference():
    """The port's copies of `paths.py` and `graph.py` on the reference's
    inputs: the same camera paths, cone masks, random rotations (one seed)
    and graph bookkeeping."""
    r0 = jpaths.rotation_from_z(np.array([1.0, 0, 0]))[0]
    r1 = jpaths.rotation_from_z(np.array([0.0, 1, 0.3]))[0]
    wps = np.array([[0, 0, 1], [1, 0, 1], [2, 1, 1.5]])
    for args in ((r0, r1, wps), (r0, r1, wps[:1])):
        (pj, lj), (pt, lt) = jpaths.wp2path(*args), tpaths.wp2path(*args)
        np.testing.assert_array_equal(pt, pj)
        assert lt == lj
    rng = np.random.default_rng(2)
    free, pts, nrm = rng.uniform(-3, 3, (400, 3)), rng.uniform(-1, 1, (7, 3)), rng.normal(size=(7, 3))
    for pitch in (None, 0.25):
        for a, b in zip(tpaths.cone_masks_batch(pts, nrm, free, pitch_angle=pitch),
                        jpaths.cone_masks_batch(pts, nrm, free, pitch_angle=pitch)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tpaths.select_points_within_cone(pts[0], nrm[0], free, pitch_angle=pitch),
                        jpaths.select_points_within_cone(pts[0], nrm[0], free, pitch_angle=pitch)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            tpaths.inplace_rotation(pts, pitch, np.random.default_rng(5)),
            jpaths.inplace_rotation(pts, pitch, np.random.default_rng(5)),
        )
    from activegs_torch.planning.graph import VoxelGraph as TGraph
    from activegs_tpu.planning.graph import VoxelGraph as JGraph

    m = rng.uniform(size=(6, 5, 3)) > 0.4
    gt, gj = TGraph((0.2, 0.2, 0.2), m.shape), JGraph((0.2, 0.2, 0.2), m.shape)
    for mask in (m, m & (rng.uniform(size=m.shape) > 0.2)):
        gt.update_graph(mask)
        gj.update_graph(mask)
        assert (gt.num_nodes(), gt.num_edges(), gt.last_added, gt.last_removed) == (
            gj.num_nodes(), gj.num_edges(), gj.last_added, gj.last_removed)
        assert gt.neighbors((2, 2, 1)) == gj.neighbors((2, 2, 1))


def _utility_inputs(state):
    n = state.capacity
    return state.means, jgm.normals_of(state), jnp.zeros(n), jnp.full(n, 0.9), state.alive


def test_update_utility_matches_reference(world):
    """ROI masks equal and per-voxel mean normals to 1e-6, the normals
    summed in a fixed order."""
    _, _, grid, vstate, state = world
    want = jvm.update_utility(vstate, grid, VOXCFG, *_utility_inputs(state))
    args = [to_t(np.asarray(a)) for a in _utility_inputs(state)]
    got = tvm.update_utility(t_vstate(vstate), t_grid(grid), T_VOXCFG, *args)
    assert np.asarray(want.roi_mask).sum() > 0
    np.testing.assert_array_equal(got.roi_mask.numpy(), np.asarray(want.roi_mask))
    np.testing.assert_allclose(got.voxel_normal.numpy(), np.asarray(want.voxel_normal), rtol=0, atol=1e-6)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_astar_matches_reference_python_search(native):
    """The reference's Python search is the reference: equal lengths (1e-9
    relative), the same reachable goals and endpoints, and paths that are
    26-connected walks over traversable voxels of the stated length."""
    trav = TestAStar().make_world()
    bbox_min, size = np.zeros(3), np.array([0.2, 0.2, 0.2])
    rng = np.random.default_rng(0)
    start = bbox_min + (np.array([1, 1, 1]) + 0.5) * size
    gidx = np.concatenate([[[10, 1, 1], [3, 3, 2], [5, 3, 1]], rng.integers(0, [12, 10, 4], size=(20, 3))])
    goals = bbox_min + (gidx + 0.5) * size
    ps_j, ls_j = jastar.search_goal(start, goals, trav, bbox_min, size, use_native=False)
    ps_t, ls_t = tastar.search_goal(start, goals, trav, bbox_min, size, use_native=native)
    np.testing.assert_allclose(ls_t, ls_j, rtol=1e-9)
    for p_t, p_j, length in zip(ps_t, ps_j, ls_t):
        assert (len(p_t) == 0) == (len(p_j) == 0)
        if not p_t:
            continue
        p = np.asarray(p_t)
        assert tuple(p[0]) == tuple(p_j[0]) and tuple(p[-1]) == tuple(p_j[-1])
        assert (np.abs(np.diff(p, axis=0)) <= 1).all() and trav[tuple(p.T)].all()
        assert np.linalg.norm(np.diff(p, axis=0) * size, axis=1).sum() == pytest.approx(length, rel=1e-9)
    idx_t, d_t = tastar.search_range(np.array([0.5, 0.5, 0.1]), 0.5, trav, bbox_min, size)
    idx_j, d_j = jastar.search_range(np.array([0.5, 0.5, 0.1]), 0.5, trav, bbox_min, size)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-12)


def test_candidates_match_reference(world):
    """Cone (ROI) and random candidates from one `default_rng(0)` seed."""
    _, _, grid, vstate, state = world
    vj = jvm.update_utility(vstate, grid, VOXCFG, *_utility_inputs(state))
    vt, tgrid = t_vstate(vj), t_grid(grid)
    kw = dict(sample_num=12, max_roi_sample_num=6, radius=1.5, init_pose=INIT_POSE)
    jp = JPlanBase(JPlannerConfig(**kw), MAPCFG, VOXCFG, RASTER, seed=0)
    tp = TPlanBase(TPlannerConfig(**kw), T_MAPCFG, T_VOXCFG, T_RASTER, seed=0)
    roi_j = jp.generate_roi_candidates(vj, grid, 6)
    roi_t = tp.generate_roi_candidates(vt, tgrid, 6)
    assert len(roi_j) > 0
    np.testing.assert_allclose(roi_t, roi_j, rtol=0, atol=1e-6)
    rnd_j = jp.generate_random_candidates(vj, grid, 6)
    rnd_t = tp.generate_random_candidates(vt, tgrid, 6)
    np.testing.assert_allclose(rnd_t, rnd_j, rtol=0, atol=1e-6)
    u = np.random.default_rng(1).uniform(size=12)
    lengths = np.where(np.arange(12) % 5 == 0, np.inf, np.arange(12) * 0.3)
    np.testing.assert_array_equal(tp.cal_view_scores(u, lengths), jp.cal_view_scores(u, lengths))


def test_candidate_utilities_match_reference(world):
    """Per-candidate (explore, exploit) of `_confidence_utility_batch` on one
    shared map and voxel state, with the reference's measured entry budget
    and subset bucket: explore within 1 voxel over num_voxels, exploit at
    relative error 1e-4."""
    sim, _, grid, vstate, state = world
    cands = np.stack([
        POSES[0], POSES[2],
        look_at_pose((2.0, 2.0, 1.2), (5.5, 3.0, 1.0)),
        look_at_pose((3.0, 2.5, 1.5), (1.0, 1.0, 1.0)),  # away from the map
    ]).astype(np.float32)
    shape = (16, 16)
    ucfg = dataclasses.replace(RASTER, max_dup=2, entry_budget_mult=1.0)
    ents, ivs = (int(x) for x in jcf._candidate_entry_stats(state, jnp.asarray(cands), jnp.asarray(sim.intrinsic),
                                                            shape, MAPCFG, ucfg))
    from activegs_tpu.mapping.trainer import pick_entry_bucket, pick_subset_bucket

    budget, bucket = pick_entry_bucket(ents), pick_subset_bucket(ivs, state.capacity, min_bucket=1024)
    masks = np.ones((len(cands), *shape), bool)
    dr = np.asarray(sim.depth_range, np.float32)
    ej, xj = jcf._confidence_utility_batch(
        state, vstate.unexplored, jnp.asarray(cands), jnp.asarray(sim.intrinsic), jnp.asarray(masks),
        jnp.asarray(dr), grid, shape, MAPCFG, ucfg, entry_budget=budget, subset_bucket=bucket,
    )
    ts = t_state(state)
    t_ucfg = t_like(tt.RasterConfig, ucfg)
    assert tcf._candidate_entry_stats(ts, to_t(cands), to_t(sim.intrinsic), shape, T_MAPCFG, t_ucfg) == (ents, ivs)
    et, xt = tcf._confidence_utility_batch(
        ts, t_vstate(vstate).unexplored, to_t(cands), to_t(sim.intrinsic), torch.from_numpy(masks), to_t(dr),
        t_grid(grid), shape, T_MAPCFG, t_ucfg, entry_budget=budget, subset_bucket=bucket,
    )
    ej, xj = np.asarray(ej), np.asarray(xj)
    print(f"\nexplore {ej} / {et.numpy()}; exploit {xj} / {xt.numpy()}")
    assert ej.max() > 0 and xj.max() > 0
    assert np.abs(et.numpy() - ej).max() * grid.num_voxels <= 1.0
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-4, atol=0)


@pytest.mark.parametrize("src,dst", [((64, 64), (16, 16)), ((48, 64), (12, 16)), ((50, 70), (13, 17)), ((16, 16), (40, 24))])
def test_resize_nearest_matches_cv2(src, dst):
    import cv2

    m = np.random.default_rng(src[0]).uniform(size=src) > 0.5
    want = cv2.resize(m.astype(np.uint8), (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST) > 0
    np.testing.assert_array_equal(resize_nearest(torch.from_numpy(m), dst).numpy(), want)


def test_candidate_valid_masks_match_reference():
    """The missing-surface path: per-candidate valid masks at quarter
    resolution from the two simulators (which may disagree at a triangle
    edge: at most 1% of the pixels)."""
    cands = np.tile(np.eye(4, dtype=np.float32)[None], (3, 1, 1))
    cands[:, :3, 3] = [[1.0, 2.5, 1.5], [2.0, 2.5, 1.5], [3.0, 2.5, 1.5]]
    cands[:, :3, :3] = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], np.float32)
    jsim = BoxRoomSimulator(resolution=(RES, RES), seed=1, missing_band=(1.2, 1.8))
    tsim = tsyn.BoxRoomSimulator(resolution=(RES, RES), seed=1, missing_band=(1.2, 1.8), device="cpu")
    cfg = JPlannerConfig(sample_num=4, max_roi_sample_num=0)
    jm, _ = JPlanBase(cfg, MAPCFG, VOXCFG, RASTER)._candidate_valid_masks(cands, jsim, (16, 16))
    tcfg = TPlannerConfig(sample_num=4, max_roi_sample_num=0)
    tm, t_sim = TPlanBase(tcfg, T_MAPCFG, T_VOXCFG, T_RASTER)._candidate_valid_masks(cands, tsim, (16, 16))
    assert tm.shape == (3, 16, 16) and t_sim > 0 and (~tm).any() and tm.any()
    assert (tm.numpy() != jm).mean() <= 0.01


def test_get_planner_table():
    from activegs_torch.planning import ConfidencePlanner, ExplorationPlanner, RandomPlanner

    for name, cls in (("confidence", ConfidencePlanner), ("exploration", ExplorationPlanner), ("random", RandomPlanner)):
        p = get_planner(TPlannerConfig(type=name), T_MAPCFG, T_VOXCFG, T_RASTER, seed=0)
        assert type(p) is cls
