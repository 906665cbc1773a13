"""Per-gaussian view preprocessing: projection, EWA covariance, surfel plane
(port of `activegs_tpu/render/preprocess.py`).

Plain differentiable torch ops on flat (N,) components, in the reference's
op order; autograd transposes it, so only the tile compositor needs a
hand-written backward. Also holds the per-(entry, pixel) alpha/depth math
shared by the compositor's plain versions and the dense oracle; the CUDA
kernels (`csrc/*.cu`) repeat it line for line, with IEEE division.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..core import geometry as geo
from .types import PARAM_DIM, Camera, GaussianAttrs, RasterConfig


@tracing.span("render.preprocess")
def preprocess(
    attrs: GaussianAttrs,
    camera: Camera,
    image_shape: tuple[int, int],
    cfg: RasterConfig,
    front_only: bool = False,
):
    """Project all gaussians into one view.

    Returns params2d (N, PARAM_DIM) float32 entry parameters (zero rows for
    gaussians out of view), radius (N,) screen bbox radius in pixels,
    depth_z (N,) camera z, in_view (N,) bool."""
    h, w = image_shape
    k = camera.intrinsic
    fx = k[0, 0] * w
    fy = k[1, 1] * h
    cx = k[0, 2] * w
    cy = k[1, 2] * h

    w2c = geo.invert_rigid(camera.extrinsic)
    r00, r01, r02 = w2c[0, 0], w2c[0, 1], w2c[0, 2]
    r10, r11, r12 = w2c[1, 0], w2c[1, 1], w2c[1, 2]
    r20, r21, r22 = w2c[2, 0], w2c[2, 1], w2c[2, 2]
    t0, t1, t2 = w2c[0, 3], w2c[1, 3], w2c[2, 3]

    mx = attrs.means[:, 0]
    my = attrs.means[:, 1]
    mz = attrs.means[:, 2]
    px = r00 * mx + r01 * my + r02 * mz + t0
    py = r10 * mx + r11 * my + r12 * mz + t1
    pz = r20 * mx + r21 * my + r22 * mz + t2

    in_front = pz > cfg.near
    zs = torch.where(in_front, pz, 1.0)
    inv_z = 1.0 / zs

    mean_x = fx * px * inv_z + cx
    mean_y = fy * py * inv_z + cy

    qw = attrs.rotations[:, 0]
    qx = attrs.rotations[:, 1]
    qy = attrs.rotations[:, 2]
    qz = attrs.rotations[:, 3]
    R00 = 1 - 2 * (qy * qy + qz * qz)
    R01 = 2 * (qx * qy - qw * qz)
    R02 = 2 * (qx * qz + qw * qy)
    R10 = 2 * (qx * qy + qw * qz)
    R11 = 1 - 2 * (qx * qx + qz * qz)
    R12 = 2 * (qy * qz - qw * qx)
    R20 = 2 * (qx * qz - qw * qy)
    R21 = 2 * (qy * qz + qw * qx)
    R22 = 1 - 2 * (qx * qx + qy * qy)

    s0 = attrs.scales[:, 0] ** 2
    s1 = attrs.scales[:, 1] ** 2
    s2 = attrs.scales[:, 2] ** 2

    # cov3d = R diag(s^2) R^T, 6 unique world-frame entries
    c00 = s0 * R00 * R00 + s1 * R01 * R01 + s2 * R02 * R02
    c01 = s0 * R00 * R10 + s1 * R01 * R11 + s2 * R02 * R12
    c02 = s0 * R00 * R20 + s1 * R01 * R21 + s2 * R02 * R22
    c11 = s0 * R10 * R10 + s1 * R11 * R11 + s2 * R12 * R12
    c12 = s0 * R10 * R20 + s1 * R11 * R21 + s2 * R12 * R22
    c22 = s0 * R20 * R20 + s1 * R21 * R21 + s2 * R22 * R22

    # frustum-clamped Jacobian point
    lim_x = cfg.tan_clamp * (0.5 * w / fx)
    lim_y = cfg.tan_clamp * (0.5 * h / fy)
    tx = torch.clamp(px * inv_z, -lim_x, lim_x) * zs
    ty = torch.clamp(py * inv_z, -lim_y, lim_y) * zs

    j00 = fx * inv_z
    j02 = -fx * tx * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z * inv_z
    a0 = j00 * r00 + j02 * r20
    a1 = j00 * r01 + j02 * r21
    a2 = j00 * r02 + j02 * r22
    b0 = j11 * r10 + j12 * r20
    b1 = j11 * r11 + j12 * r21
    b2 = j11 * r12 + j12 * r22

    # cov2d = T cov3d T^T + pixel low-pass
    ca0 = a0 * c00 + a1 * c01 + a2 * c02
    ca1 = a0 * c01 + a1 * c11 + a2 * c12
    ca2 = a0 * c02 + a1 * c12 + a2 * c22
    cov_a = ca0 * a0 + ca1 * a1 + ca2 * a2 + cfg.lowpass
    cov_b = ca0 * b0 + ca1 * b1 + ca2 * b2
    cb0 = b0 * c00 + b1 * c01 + b2 * c02
    cb1 = b0 * c01 + b1 * c11 + b2 * c12
    cb2 = b0 * c02 + b1 * c12 + b2 * c22
    cov_c = cb0 * b0 + cb1 * b1 + cb2 * b2 + cfg.lowpass

    det = cov_a * cov_c - cov_b * cov_b
    inv_det = 1.0 / torch.clamp(det, min=1e-12)
    conic_a = cov_c * inv_det
    conic_b = -cov_b * inv_det
    conic_c = cov_a * inv_det

    # screen extents carry no gradient (binning only)
    with torch.no_grad():
        mid = 0.5 * (cov_a + cov_c)
        eig_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.0))
        radius = torch.ceil(cfg.sigma_extent * torch.sqrt(eig_max))
        ext_x = torch.ceil(cfg.sigma_extent * torch.sqrt(torch.clamp(cov_a, min=0.0)))
        ext_y = torch.ceil(cfg.sigma_extent * torch.sqrt(torch.clamp(cov_c, min=0.0)))

    # surfel plane for per-pixel depth; the composited normal channel is
    # camera-space
    nwx, nwy, nwz = R02, R12, R22
    ncx = r00 * nwx + r01 * nwy + r02 * nwz
    ncy = r10 * nwx + r11 * nwy + r12 * nwz
    ncz = r20 * nwx + r21 * nwy + r22 * nwz
    plane_dot = ncx * px + ncy * py + ncz * pz
    pa = ncx / fx
    pb = ncy / fy
    pc = ncz - pa * cx - pb * cy
    pd = plane_dot

    in_view = (
        attrs.valid
        & in_front
        & (det > 1e-12)
        & (mean_x + radius > 0)
        & (mean_x - radius < w)
        & (mean_y + radius > 0)
        & (mean_y - radius < h)
    )
    if front_only:
        in_view = in_view & (plane_dot < 0)

    zero = torch.zeros_like(mean_x)
    rows = [
        mean_x, mean_y, conic_a, conic_b, conic_c, attrs.opacities,
        attrs.colors[:, 0], attrs.colors[:, 1], attrs.colors[:, 2],
        ncx, ncy, ncz, pa, pb, pc, pd, attrs.confidences, pz, ext_x, ext_y,
    ]
    rows += [zero] * (PARAM_DIM - len(rows))
    params2d = torch.stack(rows, dim=1).to(torch.float32)
    params2d = torch.where(in_view[:, None], params2d, 0.0)
    return params2d, torch.where(in_view, radius, 0.0), pz, in_view


# exp(power) is floored at exp(-80) < 1e-34: alpha there is far below any
# alpha_cut either way, so outputs are unchanged, and the CPU's exp stays off
# its slow underflow path (the kernels apply the same floor)
POWER_FLOOR = -80.0

_COL_NAMES = (
    "mean_x", "mean_y", "ca", "cb", "cc", "op", "cr", "cg", "cb_col",
    "nx", "ny", "nz", "pa", "pb", "pc", "pd", "conf", "dz",
)


def entry_cols(entries_t: torch.Tensor) -> dict:
    """Split (..., K, PARAM_DIM) entry rows into named (..., K, 1) columns."""
    return {n: entries_t[..., i : i + 1] for i, n in enumerate(_COL_NAMES)}


def pair_dtype(cfg: RasterConfig) -> torch.dtype:
    """The dtype of the per-(entry, pixel) alpha terms: bfloat16 under
    `cfg.bf16_pairs`, else float32."""
    return torch.bfloat16 if cfg.bf16_pairs else torch.float32


def effective_alpha_max(cfg: RasterConfig) -> float:
    """The value alpha saturates at: cfg.alpha_max rounded to the pair
    dtype (0.99 -> 0.98828125 in bfloat16). The backward `active` mask
    compares against it, or clamped pairs would leak gradient."""
    if cfg.bf16_pairs:
        return float(torch.tensor(cfg.alpha_max, dtype=torch.bfloat16))
    return cfg.alpha_max


def _cut(alpha: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """alpha zeroed below alpha_cut; the test runs on a float32 upcast."""
    return torch.where(alpha.float() >= cfg.alpha_cut, alpha, 0.0)


def _alpha_terms(cols: dict, dx: torch.Tensor, dy: torch.Tensor, cfg: RasterConfig):
    """(alpha, exp(power), dx, dy) in the pair dtype. Under bf16 pair math
    dx/dy (formed in float32) and the conic/opacity columns are rounded to
    bfloat16 and every product and sum rounds there; exp runs on the
    bfloat16 power and rounds once."""
    ca, cb, cc, op = cols["ca"], cols["cb"], cols["cc"], cols["op"]
    if cfg.bf16_pairs:
        b = torch.bfloat16
        dx, dy, ca, cb, cc, op = (x.to(b) for x in (dx, dy, ca, cb, cc, op))
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    ex = torch.exp(torch.clamp(power, min=POWER_FLOOR, max=0.0))
    alpha = _cut(torch.clamp(op * ex, max=effective_alpha_max(cfg)), cfg)
    return alpha, ex, dx, dy


def eval_alpha_depth_cols(cols: dict, px: torch.Tensor, py: torch.Tensor, cfg: RasterConfig):
    """Per-(entry, pixel) alpha = min(alpha_max, op * exp(min(0, power)))
    zeroed below alpha_cut, in the pair dtype, and surfel-plane depth
    (float32) clamped to [depth_lo, depth_hi] * dz (falls back to dz when
    the plane is edge-on). cols hold (..., K, 1) columns, px/py (..., 1, P)
    pixel centers."""
    alpha, _, _, _ = _alpha_terms(cols, px - cols["mean_x"], py - cols["mean_y"], cfg)

    denom = cols["pa"] * px + cols["pb"] * py + cols["pc"]
    ok = torch.abs(denom) > 1e-8
    denom_safe = torch.where(ok, denom, 1.0)
    t = torch.where(ok, cols["pd"] * (1.0 / denom_safe), cols["dz"])
    t = torch.minimum(torch.maximum(t, cfg.depth_lo * cols["dz"]), cfg.depth_hi * cols["dz"])
    return alpha, t


def eval_pair_terms_bwd(cols: dict, px: torch.Tensor, py: torch.Tensor, cfg: RasterConfig) -> dict:
    """The alpha/depth evaluation plus the intermediates the backward chains
    need (dx, dy, exp(power), 1/denom, raw plane depth, clamp masks); alpha,
    ex, dx and dy come in the pair dtype, the depth-plane terms in float32."""
    alpha, ex, dx, dy = _alpha_terms(cols, px - cols["mean_x"], py - cols["mean_y"], cfg)

    denom = cols["pa"] * px + cols["pb"] * py + cols["pc"]
    ok = torch.abs(denom) > 1e-8
    inv_denom = 1.0 / torch.where(ok, denom, 1.0)
    t_raw = cols["pd"] * inv_denom
    lo = cfg.depth_lo * cols["dz"]
    hi = cfg.depth_hi * cols["dz"]
    t = torch.where(ok, torch.minimum(torch.maximum(t_raw, lo), hi), cols["dz"])
    inside = ok & (t_raw > lo) & (t_raw < hi)
    return {
        "alpha": alpha, "t": t, "dx": dx, "dy": dy, "ex": ex,
        "inv_denom": inv_denom, "t_raw": t_raw, "ok": ok, "inside": inside,
    }
