"""Next-best-view planner framework (port of
`activegs_tpu/planning/planner.py`).

`plan()` runs one planning step on the host: candidate sampling (numpy,
from `np.random.default_rng(seed)` as the reference does, so one seed gives
the same candidates in both packages), utility evaluation on the device
(subclass hook `cal_utility`), native multi-goal A*, score-based NBV
selection and Bezier + SLERP path generation; it returns the dense camera
path. The voxel state and the map stay on the device; the planner pulls the
masks it needs to the host once per step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import torch

from .. import tracing
from ..mapping import gaussians as gm
from ..mapping import voxel_map as vm
from ..render.types import RasterConfig
from . import astar, paths
from .graph import VoxelGraph


def _np(x: torch.Tensor) -> np.ndarray:
    with tracing.host_read("planner.to_host"):
        return x.detach().cpu().numpy()


@dataclasses.dataclass
class PlannerConfig:
    """`activegs_tpu/config/planner/confidence.yaml`."""

    type: str = "confidence"
    radius: float = 0.5  # action-space radius for random candidates
    robot_size: float = 0.3
    pitch_angle: Optional[float] = None
    sample_num: int = 100
    max_roi_sample_num: int = 30
    use_confidence: bool = True
    path_length_factor: float = 0.5
    render_ratio: float = 0.25
    # lighter rasterizer settings for the ~100 utility renders: at quarter
    # resolution the tile span per surfel shrinks ~4x, so a max_dup of 2 and
    # a 1.0x entry budget keep the per-candidate sort/gather sizes half of
    # the training config's with negligible truncation (utilities are
    # scoring heuristics; drops are counted and visible in num_dropped)
    utility_max_dup: int = 2
    utility_budget_mult: float = 1.0
    explore_weight: float = 1000.0
    flight_speed: float = 1.0
    init_pose: tuple = (
        (0.0, 0.0, 1.0, 0.0),
        (-1.0, 0.0, 0.0, 0.0),
        (0.0, -1.0, 0.0, 0.0),
        (0.0, 0.0, 0.0, 1.0),
    )


class PlanBase:
    def __init__(
        self,
        cfg: PlannerConfig,
        map_cfg: gm.MapConfig,
        voxel_cfg: vm.VoxelConfig,
        raster_cfg: RasterConfig = RasterConfig(),
        seed: int = 0,
    ):
        self.cfg = cfg
        self.map_cfg = map_cfg
        self.voxel_cfg = voxel_cfg
        self.raster_cfg = raster_cfg
        self.rng = np.random.default_rng(seed)
        self.pose = np.asarray(cfg.init_pose, np.float32)
        self.graph: Optional[VoxelGraph] = None
        self.initialized = False
        # a parallel.ViewGroup: candidate utilities split over its ranks;
        # set by IncrementalMapper.load_planner when several ranks run
        self.group = None
        # scene-overlay stashes (filled by plan(); viewer-facing)
        self.last_candidates: Optional[np.ndarray] = None
        self.last_scores: Optional[np.ndarray] = None
        self.last_nbv: Optional[np.ndarray] = None
        self.last_plan_times: dict = {}
        self.utility_raster_cfg = dataclasses.replace(
            raster_cfg,
            max_dup=cfg.utility_max_dup,
            entry_budget_mult=cfg.utility_budget_mult,
        )

    # ---- candidate generation (`plan_base.py:131-206`) ----

    def generate_random_candidates(
        self, vstate, grid, num: int, free: np.ndarray | None = None
    ) -> np.ndarray:
        centers = grid.centers
        if free is None:
            free = _np(vm.free_mask_w_margin(vstate, grid, self.voxel_cfg))
        within = (
            np.linalg.norm(centers - self.pose[:3, 3], axis=1) <= self.cfg.radius
        )
        valid = centers[free & within]
        if len(valid) == 0:
            valid = centers[free]
        if len(valid) == 0:
            valid = self.pose[None, :3, 3]
        picks = valid[self.rng.integers(0, len(valid), size=num)]
        return paths.inplace_rotation(picks, self.cfg.pitch_angle, self.rng)

    def generate_roi_candidates(
        self, vstate, grid, num: int, free: np.ndarray | None = None
    ) -> np.ndarray:
        """Cone samples around ROI voxels, nearest ROI first, <= 5 per ROI
        (`plan_base.py:152-206`)."""
        roi = _np(vstate.roi_mask)
        if roi.sum() == 0:
            return np.zeros((0, 4, 4), np.float32)
        centers = grid.centers
        if free is None:
            free = _np(vm.free_mask_w_margin(vstate, grid, self.voxel_cfg))
        free_mask_grid = _np(vm.free_mask(vstate, self.voxel_cfg)).reshape(grid.dim)
        free_points = centers[free]
        if len(free_points) == 0:
            return np.zeros((0, 4, 4), np.float32)
        roi_centers = centers[roi]
        roi_normals = _np(vstate.voxel_normal)[roi].astype(np.float64)
        order = np.argsort(np.linalg.norm(roi_centers - self.pose[:3, 3], axis=1))
        roi_centers = roi_centers[order]
        roi_normals = roi_normals[order]

        # zero-normal ROIs (pure frontiers) get the mean direction to their
        # free 26-neighbors, computed for ALL of them at once
        no_normal = np.linalg.norm(roi_normals, axis=1) < 1e-6
        if no_normal.any():
            fdirs, fvalid = self._frontier_view_directions(
                roi_centers[no_normal], grid, free_mask_grid
            )
            roi_normals[no_normal] = fdirs
            usable = ~no_normal
            usable[no_normal] = fvalid
        else:
            usable = np.ones(len(roi_centers), bool)
        roi_centers, roi_normals = roi_centers[usable], roi_normals[usable]

        out = []
        total = 0
        per_roi = 5
        # nearest-first, chunked: each chunk's cone tests are one (C, F)
        # broadcast (paths.cone_masks_batch); <= 5 random picks per ROI,
        # stop at `num`
        chunk = 64
        for c0 in range(0, len(roi_centers), chunk):
            cc = roi_centers[c0 : c0 + chunk]
            cn = roi_normals[c0 : c0 + chunk]
            mask, views = paths.cone_masks_batch(
                cc, cn, free_points, pitch_angle=self.cfg.pitch_angle
            )
            for i in range(len(cc)):
                hit = np.flatnonzero(mask[i])
                if len(hit) == 0:
                    continue
                if len(hit) > per_roi:
                    hit = hit[self.rng.choice(len(hit), per_roi, replace=False)]
                ts = np.tile(np.eye(4), (len(hit), 1, 1))
                ts[:, :3, 3] = free_points[hit]
                ts[:, :3, :3] = paths.rotation_from_z(views[i, hit])
                out.append(ts)
                total += len(hit)
                if total >= num:
                    break
            if total >= num:
                break
        if not out:
            return np.zeros((0, 4, 4), np.float32)
        return np.concatenate(out)[:num].astype(np.float32)

    def _frontier_view_directions(self, points, grid, free_mask_grid):
        """Mean direction to free 26-neighbors for a BATCH of frontier ROIs
        (`check_visible_direction`, `voxel_map.py:294-322`), vectorized.
        Returns (dirs (R, 3), valid (R,)); dirs rows with valid=False are 0."""
        points = np.atleast_2d(points)
        bbox_min = np.asarray(grid.bbox_min)
        size = np.asarray(grid.size)
        dim = np.asarray(grid.dim)
        idx = np.floor((points - bbox_min) / size).astype(int)  # (R, 3)
        offs = np.array(
            [
                (ox, oy, oz)
                for ox in (-1, 0, 1)
                for oy in (-1, 0, 1)
                for oz in (-1, 0, 1)
                if ox or oy or oz
            ]
        )  # (26, 3)
        nb = idx[:, None, :] + offs[None]  # (R, 26, 3)
        in_bounds = ((nb >= 0) & (nb < dim)).all(axis=-1)
        nb_c = np.clip(nb, 0, dim - 1)
        free = free_mask_grid[nb_c[..., 0], nb_c[..., 1], nb_c[..., 2]] & in_bounds
        c = bbox_min + (nb + 0.5) * size  # (R, 26, 3)
        d = c - points[:, None, :]
        d /= np.clip(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12, None)
        mean = (d * free[..., None]).sum(axis=1) / np.clip(
            free.sum(axis=1)[:, None], 1, None
        )
        n = np.linalg.norm(mean, axis=-1)
        valid = free.any(axis=1) & (n >= 1e-8)
        dirs = np.where(valid[:, None], mean / np.clip(n[:, None], 1e-12, None), 0.0)
        return dirs, valid

    # ---- scoring (`cal_view_scores`, `plan_base.py:216-233`) ----

    def cal_view_scores(self, utilities: np.ndarray, lengths: np.ndarray):
        lengths = np.asarray(lengths, np.float64)
        valid = ~np.isinf(lengths)
        total = lengths[valid].sum()
        norm_len = lengths / total if total > 0 else lengths
        norm_len[~valid] = 1e7
        u = np.asarray(utilities, np.float64)
        u = u / u.sum() if u.sum() > 0 else u
        u[np.isnan(u)] = 0.0
        if np.all(u == 0):
            return self.rng.uniform(size=len(u))
        return u - self.cfg.path_length_factor * norm_len

    # ---- main step (`PlanBase.plan`, `plan_base.py:41-129`) ----

    def plan(self, gm_state, vstate, grid, simulator, recorder=None):
        t_planning = 0.0
        if self.initialized:
            with tracing.span("plan.masks") as masks:
                centers = grid.centers
                robot_space = (
                    np.linalg.norm(centers - self.pose[:3, 3], axis=1)
                    < self.cfg.robot_size
                )
                # one device pull serves traversability and both candidate
                # generators (update_utility annotates ROI fields only, the
                # occupancy-derived free mask is unaffected)
                free_margin = _np(vm.free_mask_w_margin(vstate, grid, self.voxel_cfg))
                traversable = free_margin | robot_space
                if self.graph is None:
                    self.graph = VoxelGraph(grid.size, grid.dim)
                self.graph.update_graph(traversable)

            with tracing.span("plan.candidates") as roi_rand:
                if self.cfg.max_roi_sample_num > 0:
                    vstate = vm.update_utility(
                        vstate,
                        grid,
                        self.voxel_cfg,
                        gm_state.means,
                        gm.normals_of(gm_state),
                        gm.confidences_of(gm_state, self.map_cfg),
                        torch.sigmoid(gm_state.opacities_raw),
                        gm_state.alive,
                        use_confidence=self.cfg.use_confidence,
                    )
                    roi_candidates = self.generate_roi_candidates(
                        vstate, grid, self.cfg.max_roi_sample_num, free=free_margin
                    )
                else:
                    roi_candidates = np.zeros((0, 4, 4), np.float32)

                n_random = self.cfg.sample_num - len(roi_candidates)
                random_candidates = (
                    self.generate_random_candidates(
                        vstate, grid, n_random, free=free_margin
                    )
                    if n_random > 0
                    else np.zeros((0, 4, 4), np.float32)
                )
                candidates = np.concatenate([roi_candidates, random_candidates])
            t_masks, t_roi_rand = masks.seconds, roi_rand.seconds
            t_planning += t_masks + t_roi_rand

            utilities, t_utility = self.cal_utility(
                gm_state, vstate, grid, candidates, simulator
            )
            t_planning += t_utility

            with tracing.span("plan.astar") as search:
                wp_list, lengths = astar.search_goal(
                    self.pose[:3, 3],
                    candidates[:, :3, 3],
                    self.graph.traversable,
                    np.asarray(grid.bbox_min),
                    np.asarray(grid.size),
                )
            t_astar = search.seconds
            t_planning += t_astar
            # phase telemetry for step_stats: candidate generation (with
            # update_utility), utility renders, A*
            self.last_plan_times = {
                "masks": round(t_masks, 3),
                "roi_rand": round(t_roi_rand, 3),
                "utility": round(t_utility, 3),
                "astar": round(t_astar, 3),
                **{
                    f"utility_{k}": v
                    for k, v in getattr(self, "last_utility_times", {}).items()
                },
            }

            scores = self.cal_view_scores(np.asarray(utilities), lengths)
            nbv_id = int(np.argmax(scores))
            nbv = candidates[nbv_id]
            self.last_candidates = candidates
            self.last_scores = np.asarray(scores)
            self.last_nbv = np.asarray(nbv)
            wp = wp_list[nbv_id]
            if len(wp) == 0:  # unreachable best view: stay in place
                waypoints = self.pose[None, :3, 3]
            else:
                waypoints = np.asarray(grid.bbox_min) + (
                    np.asarray(wp) + 0.5
                ) * np.asarray(grid.size)
        else:
            # first step: snap to the containing voxel center
            nbv = np.eye(4, dtype=np.float32)
            nbv[:3, :3] = self.pose[:3, :3]
            idx = np.floor(
                (self.pose[:3, 3] - np.asarray(grid.bbox_min))
                / np.asarray(grid.size)
            ).astype(int)
            idx = np.clip(idx, 0, np.asarray(grid.dim) - 1)
            nbv[:3, 3] = np.asarray(grid.bbox_min) + (idx + 0.5) * np.asarray(
                grid.size
            )
            waypoints = np.stack([self.pose[:3, 3], nbv[:3, 3]])
            self.initialized = True

        camera_path, path_length = paths.wp2path(
            self.pose[:3, :3], nbv[:3, :3], waypoints
        )
        self.pose = np.asarray(nbv, np.float32)

        if recorder is not None:
            recorder.update_time("planning", t_planning)
            recorder.update_time(
                "flight", paths.cal_flight_time(path_length, self.cfg.flight_speed)
            )
            recorder.update_path(camera_path, path_length)
        return camera_path

    def cal_utility(self, gm_state, vstate, grid, candidates, simulator):
        raise NotImplementedError

    def _candidate_valid_masks(self, candidates, simulator, shape):
        """Per-candidate valid masks (N, h, w) bool on the simulator's
        device, for scenes with missing surfaces: the simulator's mask at
        full resolution, resized to `shape` by nearest neighbour, which
        takes source pixel floor(i * scale) as cv2.INTER_NEAREST does.
        Returns (masks, seconds spent)."""
        h, w = shape
        dev = simulator.device
        if not simulator.has_missing_surface:
            return torch.ones((len(candidates), h, w), dtype=torch.bool, device=dev), 0.0
        with tracing.span("plan.valid_masks") as sp:
            masks = []
            for c in candidates:
                m = simulator.simulate(torch.as_tensor(np.asarray(c), device=dev), valid_mask_only=True)
                masks.append(resize_nearest(m, (h, w)))
            masks = torch.stack(masks)
        return masks, sp.seconds


def resize_nearest(mask: torch.Tensor, shape) -> torch.Tensor:
    """(H, W) bool mask resized to `shape` (h, w) by nearest neighbour:
    destination pixel i reads source pixel floor(i * H / h)."""
    m = torch.nn.functional.interpolate(mask[None, None].to(torch.float32), size=tuple(shape), mode="nearest")
    return m[0, 0] > 0
