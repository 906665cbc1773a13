"""Rendering and mesh quality metrics (port of `activegs_tpu/eval/metrics.py`).

PSNR, SSIM, masked MSE and a perceptual proxy as torch ops on the images'
device; LPIPS through torchmetrics' AlexNet when its weights are already in
the local torch hub cache, else None (nothing is downloaded). The mesh
metrics (accuracy, completion, completion ratio, chamfer) are host numpy +
`scipy.spatial.cKDTree` with the reference's seeds.
"""

from __future__ import annotations

import functools
import glob
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy.spatial import cKDTree

from ..core.image_ops import ssim


def cal_mse(pred: torch.Tensor, gt: torch.Tensor, mask=1.0) -> float:
    return float(torch.mean(((pred - gt) * mask) ** 2))


def cal_psnr(rgb_pred: torch.Tensor, rgb_gt: torch.Tensor) -> float:
    return -10.0 * math.log10(cal_mse(rgb_pred, rgb_gt) + 1e-8)


def cal_ssim(rgb_pred: torch.Tensor, rgb_gt: torch.Tensor) -> float:
    return float(ssim(rgb_pred[None], rgb_gt[None]))


def _hub_checkpoints() -> str:
    return os.path.join(torch.hub.get_dir(), "checkpoints")


def lpips_available() -> bool:
    """True when AlexNet weights for LPIPS are in the local torch hub cache."""
    return bool(glob.glob(os.path.join(_hub_checkpoints(), "alexnet*")))


@functools.cache
def _lpips_model():
    """torchmetrics' LPIPS (AlexNet), or None without local weights or
    without torchmetrics. Built only from local weights: constructing it
    without them would try to download them."""
    if not lpips_available():
        return None
    try:
        from torchmetrics.image.lpip import LearnedPerceptualImagePatchSimilarity
    except ImportError:
        return None
    return LearnedPerceptualImagePatchSimilarity(net_type="alex", normalize=True)


def cal_lpips(rgb_pred: torch.Tensor, rgb_gt: torch.Tensor) -> Optional[float]:
    """LPIPS of two (3, h, w) images, or None where `_lpips_model` is None."""
    model = _lpips_model()
    if model is None:
        return None
    p = rgb_pred.detach().float().cpu()[None].clamp(0, 1)
    g = rgb_gt.detach().float().cpu()[None].clamp(0, 1)
    with torch.no_grad():
        return float(model(p, g))


@functools.cache
def _perceptual_weights() -> tuple[np.ndarray, ...]:
    """The three stages' fixed He-scaled filters, OIHW float32, drawn from
    `np.random.default_rng(0)` in the reference's order."""
    rng = np.random.default_rng(0)
    return tuple(
        np.asarray(rng.normal(size=(cout, cin, 3, 3)) * np.sqrt(2.0 / (cin * 9)), np.float32)
        for cin, cout in ((3, 16), (16, 32), (32, 64))
    )


def _same_pad(n: int, k: int = 3, s: int = 2) -> tuple[int, int]:
    """XLA's 'SAME' padding (before, after) of one axis of length n: the
    total that gives ceil(n / s) outputs, the smaller half before."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _perceptual_features(x: torch.Tensor) -> list[torch.Tensor]:
    """3-stage fixed random-conv feature pyramid of (N, 3, h, w) images
    (stride 2, 'SAME' padding, ReLU), each stage unit-normalized over its
    channels."""
    feats = []
    for w in _perceptual_weights():
        (top, bottom), (left, right) = _same_pad(x.shape[-2]), _same_pad(x.shape[-1])
        x = F.conv2d(F.pad(x, (left, right, top, bottom)), torch.from_numpy(w).to(x.device), stride=2)
        x = torch.clamp(x, min=0.0)
        norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + 1e-10)
        feats.append(x / norm)
    return feats


def perceptual_distance(rgb_pred: torch.Tensor, rgb_gt: torch.Tensor) -> torch.Tensor:
    """Mean squared distance between the channel-normalized features of two
    (3, h, w) images, averaged over the 3 scales (a 0-d tensor)."""
    fp = _perceptual_features(torch.clamp(rgb_pred.float()[None], 0, 1))
    fg = _perceptual_features(torch.clamp(rgb_gt.float()[None], 0, 1))
    d = [torch.mean(torch.sum((a - b) ** 2, dim=1)) for a, b in zip(fp, fg)]
    return sum(d) / len(d)


def cal_perceptual(rgb_pred: torch.Tensor, rgb_gt: torch.Tensor) -> float:
    """Offline stand-in for LPIPS, reported beside it so that results always
    carry a perceptual channel. Not comparable to published LPIPS values:
    use it to compare runs of this system only."""
    return float(perceptual_distance(rgb_pred, rgb_gt))


# ---------------------------------------------------------------------------
# mesh metrics
# ---------------------------------------------------------------------------


def sample_surface(vertices: np.ndarray, faces: np.ndarray, n: int, seed=0):
    """Area-weighted uniform surface sampling of n points."""
    rng = np.random.default_rng(seed)
    v = vertices[faces]  # (F, 3, 3)
    cross = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=1)
    total = area.sum()
    if total <= 0:
        return np.zeros((0, 3), np.float32)
    probs = area / total
    tri = rng.choice(len(faces), size=n, p=probs)
    r1 = np.sqrt(rng.uniform(size=n))
    r2 = rng.uniform(size=n)
    a = 1 - r1
    b = r1 * (1 - r2)
    c = r1 * r2
    pts = a[:, None] * v[tri, 0] + b[:, None] * v[tri, 1] + c[:, None] * v[tri, 2]
    return pts.astype(np.float32)


def accuracy(gt_points, rec_points) -> float:
    """Mean distance rec -> gt."""
    d, _ = cKDTree(gt_points).query(rec_points, workers=-1)
    return float(np.mean(d))


def completion(gt_points, rec_points) -> float:
    """Mean distance gt -> rec."""
    d, _ = cKDTree(rec_points).query(gt_points, workers=-1)
    return float(np.mean(d))


def completion_ratio(gt_points, rec_points, dist_th=0.01) -> float:
    d, _ = cKDTree(rec_points).query(gt_points, workers=-1)
    return float(np.mean((d < dist_th).astype(np.float32)))


def calc_3d_mesh_metric(mesh_rec: tuple, mesh_gt: tuple, dist_thres=0.05, n_samples=500_000):
    """(accuracy cm, completion cm, completion ratio %, chamfer m) of two
    (vertices, faces) meshes."""
    rec_pc = sample_surface(*mesh_rec, n_samples, seed=0)
    gt_pc = sample_surface(*mesh_gt, n_samples, seed=1)
    acc = accuracy(gt_pc, rec_pc)
    comp = completion(gt_pc, rec_pc)
    chamfer = (acc + comp) / 2.0
    ratio = completion_ratio(gt_pc, rec_pc, dist_th=dist_thres)
    return acc * 100.0, comp * 100.0, ratio * 100.0, chamfer
