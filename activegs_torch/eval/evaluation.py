"""Evaluation tool and mesh generation (port of `activegs_tpu/eval/evaluation.py`).

`generate_mesh` renders a map snapshot along the executed trajectory and
TSDF-fuses the RGB-D renders into a mesh; `EvaluationTool` renders every
snapshot at the test poses and scores PSNR, SSIM, masked depth MSE, the
perceptual proxy (and LPIPS where its weights are local), then scores each
snapshot's mesh against the ground-truth mesh. Renders run on the map's
device, through the compositor kernels on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.image_ops import ssim
from ..mapping import gaussians as gm
from ..render.renderer import render_view
from ..render.types import Camera, RasterConfig
from . import metrics, tsdf


@torch.no_grad()
def generate_mesh(
    gm_state: gm.GaussianMapState,
    map_cfg: gm.MapConfig,
    camera_params,
    resolution: int = 1024,
    raster_cfg: RasterConfig = RasterConfig(),
    voxel: float = 0.02,
    trunc: float = 0.1,
    bbox=None,
    min_cluster_tris: int = 50,
):
    """Render the map at each (extrinsic (4, 4), intrinsic (3, 3)) of
    `camera_params` at resolution^2 and fuse the renders into a TSDF over
    `bbox` (default: the live means' bounds + 0.1 m), then extract the mesh
    and drop clusters of fewer than `min_cluster_tris` faces. Returns
    (vertices, faces, colors) as numpy arrays."""
    dev = gm_state.means.device
    n = int(gm_state.count)
    if bbox is None:
        means = gm_state.means[: max(n, 1)].cpu().numpy()
        bbox = (means.min(0) - 0.1, means.max(0) + 0.1)
    grid = tsdf.TSDFGrid.create(bbox, voxel=voxel, trunc=trunc)
    state = tsdf.init_state(grid, dev)
    # the live-prefix capacity bucket: live gaussians fill [0, count)
    attrs = gm.attrs_of(gm.slice_state(gm_state, gm.bucket_capacity(n, map_cfg.capacity)), map_cfg)
    shape = (resolution, resolution)
    for extrinsic, intrinsic in camera_params:
        ext = torch.as_tensor(np.asarray(extrinsic), dtype=torch.float32, device=dev)
        intr = torch.as_tensor(np.asarray(intrinsic), dtype=torch.float32, device=dev)
        out, _ = render_view(attrs, Camera(ext, intr), shape, raster_cfg)
        state = tsdf.integrate(state, grid, out.rgb, out.depth[0], ext, intr)
    verts, faces, colors = tsdf.extract_mesh(state, grid)
    return tsdf.filter_isolated(verts, faces, colors, min_tris=min_cluster_tris)


def score_view(attrs, bg, extrinsic, intrinsic, rgb_gt, depth_gt, shape, raster_cfg):
    """Render one map at one test pose and score it. Returns 0-d tensors
    (psnr, ssim, depth_mse, perceptual) and the clipped render."""
    out, _ = render_view(attrs, Camera(extrinsic, intrinsic), shape, raster_cfg, background=bg)
    rgb_pred = torch.clamp(out.rgb, 0.0, 1.0)
    valid = (depth_gt > 0).to(torch.float32)
    mse = torch.mean((rgb_pred - rgb_gt) ** 2)
    psnr = -10.0 * torch.log10(mse + 1e-8)
    s = ssim(rgb_pred[None], rgb_gt[None])
    depth_mse = torch.mean(((out.depth - depth_gt) * valid) ** 2)
    return psnr, s, depth_mse, metrics.perceptual_distance(rgb_pred, rgb_gt), rgb_pred


class EvaluationTool:
    """Scores map snapshots against test views and a ground-truth mesh."""

    def __init__(
        self,
        maps,  # list of (GaussianMapState, MapConfig)
        meshes,  # list of (vertices, faces) or None
        test_poses: np.ndarray,  # (V, 4, 4)
        gt_provider,  # simulator with simulate(pose, require_gt=True)
        mesh_gt=None,  # (vertices, faces)
        raster_cfg: RasterConfig = RasterConfig(),
    ):
        self.maps = maps
        self.meshes = meshes
        self.test_poses = np.asarray(test_poses)
        self.gt_provider = gt_provider
        self.mesh_gt = mesh_gt
        self.raster_cfg = raster_cfg

    @torch.no_grad()
    def eval(self, mode: str = "complete", mesh_dist_thres: float = 0.02, mesh_samples: int = 500_000) -> dict:
        """Mean scores per snapshot over the test poses (mode complete or
        rendering) and mesh scores per snapshot (complete or mesh)."""
        out = {}
        if mode in ("complete", "rendering"):
            n_maps = len(self.maps)
            psnr = np.zeros(n_maps)
            ssim_ = np.zeros(n_maps)
            lpips = np.zeros(n_maps)
            lpips_n = np.zeros(n_maps)
            perceptual = np.zeros(n_maps)
            depth_mse = np.zeros(n_maps)

            # every snapshot sliced to one shared capacity bucket (the
            # largest), as the reference does
            bucket = max(gm.bucket_capacity(int(state.count), cfg.capacity) for state, cfg in self.maps)
            renderers = [
                (gm.attrs_of(gm.slice_state(state, bucket), cfg),
                 torch.tensor(cfg.background, dtype=torch.float32, device=state.means.device))
                for state, cfg in self.maps
            ]
            want_lpips = metrics.lpips_available()

            for pose in self.test_poses:
                frame = self.gt_provider.simulate(pose, require_gt=True)
                h, w = frame["rgb"].shape[-2:]
                for i, (attrs, bg) in enumerate(renderers):
                    dev = attrs.means.device
                    rgb_gt = frame["rgb"].to(dev)
                    p, s, d, pc, rgb_pred = score_view(
                        attrs, bg, frame["extrinsic"].to(dev), frame["intrinsic"].to(dev), rgb_gt,
                        frame["depth"].to(dev), (int(h), int(w)), self.raster_cfg,
                    )
                    psnr[i] += float(p)
                    ssim_[i] += float(s)
                    depth_mse[i] += float(d)
                    perceptual[i] += float(pc)
                    if want_lpips:
                        lp = metrics.cal_lpips(rgb_pred, rgb_gt)
                        if lp is not None:
                            lpips[i] += lp
                            lpips_n[i] += 1

            v = len(self.test_poses)
            out["mean_psnr"] = (psnr / v).tolist()
            out["mean_ssim"] = (ssim_ / v).tolist()
            out["mean_lpips"] = [(lpips[i] / lpips_n[i]) if lpips_n[i] else None for i in range(n_maps)]
            out["mean_perceptual"] = (perceptual / v).tolist()
            out["mean_depth_mse"] = (depth_mse / v).tolist()

        if mode in ("complete", "mesh") and self.mesh_gt is not None:
            acc, comp, ratio, chamfer = [], [], [], []
            for mesh in self.meshes:
                if mesh is None or len(mesh[1]) == 0:
                    acc.append(None), comp.append(None)
                    ratio.append(None), chamfer.append(None)
                    continue
                a, c, r, ch = metrics.calc_3d_mesh_metric(
                    (mesh[0], mesh[1]), self.mesh_gt, dist_thres=mesh_dist_thres, n_samples=mesh_samples
                )
                acc.append(a), comp.append(c), ratio.append(r), chamfer.append(ch)
            out["mesh_accuracy"] = acc
            out["mesh_completion"] = comp
            out["mesh_completion_ratio"] = ratio
            out["mesh_chamfer_distance"] = chamfer
        return out
