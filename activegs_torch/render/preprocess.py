"""Per-gaussian view preprocessing: projection, EWA covariance, surfel plane
(port of `activegs_tpu/render/preprocess.py`).

`preprocess` is one autograd function with a hand-written forward and
backward: on the card, one launch of `csrc/preprocess.cu`'s forward kernel
and one of its backward kernel; on the CPU, their plain PyTorch versions
(`preprocess_fwd_plain`, the reference's op order on flat (N,) components,
and `preprocess_bwd_plain`, the chain rule written out in the backward
kernel's order). The choice depends only on the device. The forward kernel
repeats `_project` op for op with no contraction, so its outputs are
bitwise those of `preprocess_fwd_plain` on the card; the gradients are
autograd's through it, within rounding. Also holds the per-(entry, pixel)
alpha/depth math shared by the compositor's plain versions and the dense
oracle; the CUDA kernels (`csrc/*.cu`) repeat it line for line, with IEEE
division.
"""

from __future__ import annotations

import ctypes
import types

import torch

from .. import tracing
from ..core import geometry as geo
from ._build import CudaKernel
from .types import PARAM_DIM, USED_ROWS, Camera, GaussianAttrs, RasterConfig


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
    depth_z (N,) camera z, in_view (N,) bool. params2d and depth_z are
    differentiable in the means, scales, rotations, opacities, colors and
    confidences (not in the camera); radius and in_view are not."""
    return _Preprocess.apply(
        attrs.means, attrs.scales, attrs.rotations, attrs.opacities, attrs.colors, attrs.confidences,
        attrs.valid, camera.extrinsic, camera.intrinsic, tuple(image_shape), cfg, front_only,
    )


# the leaves that take gradients, in `_Preprocess`'s argument order
GRAD_FIELDS = ("means", "scales", "rotations", "opacities", "colors", "confidences")


class _Preprocess(torch.autograd.Function):
    @staticmethod
    def forward(ctx, means, scales, rotations, opacities, colors, confidences, valid, extrinsic, intrinsic,
                image_shape, cfg, front_only):
        attrs = GaussianAttrs(means, scales, rotations, opacities, colors, confidences, valid)
        camera = Camera(extrinsic, intrinsic)
        if means.device.type == "cpu":
            out = preprocess_fwd_plain(attrs, camera, image_shape, cfg, front_only)
        else:
            out = preprocess_kernel(attrs, camera, image_shape, cfg, front_only)
        ctx.save_for_backward(means, scales, rotations, opacities, colors, confidences, valid, extrinsic, intrinsic)
        ctx.image_shape, ctx.cfg, ctx.front_only = image_shape, cfg, front_only
        ctx.mark_non_differentiable(out[1], out[3])
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, d_params2d, _d_radius, d_depth_z, _d_in_view):
        need = ctx.needs_input_grad[: len(GRAD_FIELDS)]
        grads = (None,) * len(GRAD_FIELDS)
        if any(need) and (d_params2d is not None or d_depth_z is not None):
            *fields, extrinsic, intrinsic = ctx.saved_tensors
            attrs, camera = GaussianAttrs(*fields), Camera(extrinsic, intrinsic)
            bwd = preprocess_bwd_plain if extrinsic.device.type == "cpu" else preprocess_bwd_kernel
            grads = bwd(attrs, camera, ctx.image_shape, ctx.cfg, ctx.front_only, d_params2d, d_depth_z, need)
        return (*grads, None, None, None, None, None, None)


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------


def _project(attrs: GaussianAttrs, camera: Camera, image_shape: tuple[int, int], cfg: RasterConfig,
             front_only: bool) -> types.SimpleNamespace:
    """Every intermediate of the projection, by name: the view's constants
    (0-d tensors) and the (N,) components, in the reference's op order,
    which the kernels repeat. The screen extents carry no gradient."""
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

    fpx = fx * px
    fpy = fy * py
    mean_x = fpx * inv_z + cx
    mean_y = fpy * inv_z + cy

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
    vx = px * inv_z
    vy = py * inv_z
    clx = torch.clamp(vx, -lim_x, lim_x)
    cly = torch.clamp(vy, -lim_y, lim_y)
    tx = clx * zs
    ty = cly * zs

    j00 = fx * inv_z
    u1x = -fx * tx
    u2x = u1x * inv_z
    j02 = u2x * inv_z
    j11 = fy * inv_z
    u1y = -fy * ty
    u2y = u1y * inv_z
    j12 = u2y * inv_z
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
    return types.SimpleNamespace(**locals())


def preprocess_fwd_plain(
    attrs: GaussianAttrs,
    camera: Camera,
    image_shape: tuple[int, int],
    cfg: RasterConfig,
    front_only: bool = False,
):
    """`preprocess` as plain torch ops, differentiable by autograd: the
    kernel's version on the CPU, and the dense oracle's on any device."""
    t = _project(attrs, camera, image_shape, cfg, front_only)
    zero = torch.zeros_like(t.mean_x)
    rows = [
        t.mean_x, t.mean_y, t.conic_a, t.conic_b, t.conic_c, attrs.opacities,
        attrs.colors[:, 0], attrs.colors[:, 1], attrs.colors[:, 2],
        t.ncx, t.ncy, t.ncz, t.pa, t.pb, t.pc, t.pd, attrs.confidences, t.pz, t.ext_x, t.ext_y,
    ]
    rows += [zero] * (PARAM_DIM - len(rows))
    params2d = torch.stack(rows, dim=1).to(torch.float32)
    params2d = torch.where(t.in_view[:, None], params2d, 0.0)
    return params2d, torch.where(t.in_view, t.radius, 0.0), t.pz, t.in_view


@torch.no_grad()
def preprocess_bwd_plain(
    attrs: GaussianAttrs,
    camera: Camera,
    image_shape: tuple[int, int],
    cfg: RasterConfig,
    front_only: bool,
    d_params2d: torch.Tensor | None,
    d_depth_z: torch.Tensor | None,
    need=(True,) * 6,
):
    """The backward kernel's algorithm in plain torch ops: the gradients of
    the GRAD_FIELDS leaves (None where `need` says not) from the cotangents
    of params2d (rows 0..17, masked to the in-view gaussians; ext_x, ext_y
    and the pad carry none) and depth_z, either of them None for zero.
    Autograd's conventions: zs = where(in_front, pz, 1); the tan clamps
    pass gradient where lo <= x <= hi, clamp(det, 1e-12) where det >=
    1e-12. Each line is one of the backward kernel's
    (`csrc/preprocess.cu::preprocess_bwd_kernel`), in its order."""
    t = _project(attrs, camera, image_shape, cfg, front_only)
    r = [[t.r00, t.r01, t.r02], [t.r10, t.r11, t.r12], [t.r20, t.r21, t.r22]]
    R = [[t.R00, t.R01, t.R02], [t.R10, t.R11, t.R12], [t.R20, t.R21, t.R22]]
    a, b, s = [t.a0, t.a1, t.a2], [t.b0, t.b1, t.b2], [t.s0, t.s1, t.s2]
    ca, cb = [t.ca0, t.ca1, t.ca2], [t.cb0, t.cb1, t.cb2]
    nc = [t.ncx, t.ncy, t.ncz]
    fx, fy, cx, cy = t.fx, t.fy, t.cx, t.cy
    zero = torch.zeros_like(t.pz)
    if d_params2d is None:
        g = [zero] * USED_ROWS
    else:
        g = list(torch.where(t.in_view[:, None], d_params2d[:, :USED_ROWS], 0.0).unbind(1))
    g_pz = g[17] if d_depth_z is None else g[17] + d_depth_z

    # surfel plane: pc = (ncz - pa cx) - pb cy, pa = ncx / fx, pb = ncy / fy
    g_pc = g[14]
    g_pa = g[12] + (-g_pc) * cx
    g_pb = g[13] + (-g_pc) * cy
    g_pd = g[15]
    g_ncx = (g[9] + g_pa / fx) + g_pd * t.px
    g_ncy = (g[10] + g_pb / fy) + g_pd * t.py
    g_ncz = (g[11] + g_pc) + g_pd * t.pz
    g_px = g_pd * nc[0]
    g_py = g_pd * nc[1]
    g_pz = g_pz + g_pd * nc[2]
    gR = [[zero, zero, g_ncx * r[0][k] + g_ncy * r[1][k] + g_ncz * r[2][k]] for k in range(3)]

    # conic = (cov_c, -cov_b, cov_a) / clamp(det, 1e-12)
    g_inv_det = (g[2] * t.cov_c - g[3] * t.cov_b) + g[4] * t.cov_a
    g_cov_a = g[4] * t.inv_det
    g_cov_b = -(g[3] * t.inv_det)
    g_cov_c = g[2] * t.inv_det
    g_det = torch.where(t.det >= 1e-12, -(g_inv_det * (t.inv_det * t.inv_det)), 0.0)
    g_cov_a = g_cov_a + g_det * t.cov_c
    g_cov_c = g_cov_c + g_det * t.cov_a
    g_cov_b = g_cov_b - 2.0 * (g_det * t.cov_b)

    # cov2d: cov_a = ca . a, cov_b = ca . b, cov_c = cb . b; ca = C a, cb = C b
    g_ca = [g_cov_a * a[k] + g_cov_b * b[k] for k in range(3)]
    g_cb = [g_cov_c * b[k] for k in range(3)]
    g_a = [g_cov_a * ca[k] for k in range(3)]
    g_b = [g_cov_b * ca[k] + g_cov_c * cb[k] for k in range(3)]
    C = [[t.c00, t.c01, t.c02], [t.c01, t.c11, t.c12], [t.c02, t.c12, t.c22]]
    for k in range(3):
        g_a[k] = g_a[k] + (g_ca[0] * C[0][k] + g_ca[1] * C[1][k] + g_ca[2] * C[2][k])
        g_b[k] = g_b[k] + (g_cb[0] * C[0][k] + g_cb[1] * C[1][k] + g_cb[2] * C[2][k])
    g_c = [
        g_ca[x] * a[x] + g_cb[x] * b[x] if x == y
        else (g_ca[x] * a[y] + g_ca[y] * a[x]) + (g_cb[x] * b[y] + g_cb[y] * b[x])
        for x, y in _COV_PAIRS
    ]

    # T = J W: a_k = j00 r0k + j02 r2k, b_k = j11 r1k + j12 r2k
    g_j00 = g_a[0] * r[0][0] + g_a[1] * r[0][1] + g_a[2] * r[0][2]
    g_j02 = g_a[0] * r[2][0] + g_a[1] * r[2][1] + g_a[2] * r[2][2]
    g_j11 = g_b[0] * r[1][0] + g_b[1] * r[1][1] + g_b[2] * r[1][2]
    g_j12 = g_b[0] * r[2][0] + g_b[1] * r[2][1] + g_b[2] * r[2][2]
    # J: j00 = fx inv_z, j02 = ((-fx tx) inv_z) inv_z
    g_u2x = g_j02 * t.inv_z
    g_u1x = g_u2x * t.inv_z
    g_tx = g_u1x * -fx
    g_u2y = g_j12 * t.inv_z
    g_u1y = g_u2y * t.inv_z
    g_ty = g_u1y * -fy
    g_inv_z = ((g_j00 * fx + g_j02 * t.u2x) + g_u2x * t.u1x) + ((g_j11 * fy + g_j12 * t.u2y) + g_u2y * t.u1y)
    # tx = clamp(px inv_z, -lim_x, lim_x) zs: gradient where lo <= x <= hi
    g_zs = g_tx * t.clx + g_ty * t.cly
    g_vx = torch.where((t.vx >= -t.lim_x) & (t.vx <= t.lim_x), g_tx * t.zs, 0.0)
    g_vy = torch.where((t.vy >= -t.lim_y) & (t.vy <= t.lim_y), g_ty * t.zs, 0.0)
    g_px = g_px + g_vx * t.inv_z
    g_py = g_py + g_vy * t.inv_z
    g_inv_z = g_inv_z + (g_vx * t.px + g_vy * t.py)
    # mean = (f p) inv_z + c
    g_fpx = g[0] * t.inv_z
    g_fpy = g[1] * t.inv_z
    g_px = g_px + g_fpx * fx
    g_py = g_py + g_fpy * fy
    g_inv_z = g_inv_z + (g[0] * t.fpx + g[1] * t.fpy)
    # inv_z = 1 / zs, zs = where(in_front, pz, 1)
    g_zs = g_zs - g_inv_z * (t.inv_z * t.inv_z)
    g_pz = g_pz + torch.where(t.in_front, g_zs, 0.0)
    g_means = torch.stack([g_px * r[0][j] + g_py * r[1][j] + g_pz * r[2][j] for j in range(3)], dim=1)

    # cov3d: c_xy = sum_k (s_k R_xk) R_yk
    g_s = [zero, zero, zero]
    for p, (x, y) in enumerate(_COV_PAIRS):
        for k in range(3):
            gw = g_c[p] * R[y][k]
            gR[y][k] = gR[y][k] + g_c[p] * (s[k] * R[x][k])
            g_s[k] = g_s[k] + gw * R[x][k]
            gR[x][k] = gR[x][k] + gw * s[k]
    sc = attrs.scales
    g_scales = torch.stack([g_s[k] * (2.0 * sc[:, k]) for k in range(3)], dim=1)

    # R(q): diagonal R_kk = 1 - 2 (..), off-diagonal 2 (..)
    qw, qx, qy, qz = attrs.rotations.unbind(1)
    e00, e11, e22 = -2.0 * gR[0][0], -2.0 * gR[1][1], -2.0 * gR[2][2]
    h01, h02, h10 = 2.0 * gR[0][1], 2.0 * gR[0][2], 2.0 * gR[1][0]
    h12, h20, h21 = 2.0 * gR[1][2], 2.0 * gR[2][0], 2.0 * gR[2][1]
    g_rot = torch.stack([
        (h02 * qy + h10 * qz + h21 * qx) - (h01 * qz + h12 * qx + h20 * qy),
        (2.0 * (e11 * qx) + 2.0 * (e22 * qx)) + (h01 * qy + h02 * qz + h10 * qy + h20 * qz + h21 * qw) - h12 * qw,
        (2.0 * (e00 * qy) + 2.0 * (e22 * qy)) + (h01 * qx + h02 * qw + h10 * qx + h12 * qz + h21 * qz) - h20 * qw,
        (2.0 * (e00 * qz) + 2.0 * (e11 * qz)) + (h02 * qx + h10 * qw + h12 * qy + h20 * qx + h21 * qy) - h01 * qw,
    ], dim=1)
    grads = (g_means, g_scales, g_rot, g[5], torch.stack(g[6:9], dim=1), g[16])
    return tuple(x if want else None for x, want in zip(grads, need))


# the six unique entries of cov3d as (x, y) of R's rows, in the order the
# backward visits them
_COV_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# shared head: the seven fields, their row strides (a host array), the
# extrinsic and intrinsic, N, h, w, near, tan_clamp, lowpass, sigma_extent,
# front_only
_HEAD = [_P] * 7 + [ctypes.POINTER(_LL), _P, _P, _LL, _I, _I, _F, _F, _F, _F, _I]
fwd_kernel = CudaKernel("preprocess", _HEAD + [_P, _P, _P, _P, _P], name="preprocess_fwd")
bwd_kernel = CudaKernel("preprocess", _HEAD + [_P] * 9, name="preprocess_bwd")
KERNELS = (fwd_kernel, bwd_kernel)
_WIDTHS = (3, 3, 4, 1, 3, 1)  # of the GRAD_FIELDS


def _kernel_head(attrs: GaussianAttrs, camera: Camera, image_shape, cfg: RasterConfig, front_only: bool):
    """(the head of both kernels' arguments, the tensors and host array it
    points into, which the caller keeps until the launch returns),
    after checking what the kernels take: float32 fields of N rows on one
    CUDA device, a bool `valid`, a (4, 4) extrinsic and a (3, 3)
    intrinsic. A field whose rows are not unit-stride inside is made
    contiguous; rows may lie any stride apart (views of a packed array)."""
    n = attrs.means.shape[0]
    dev = attrs.means.device
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, got {dev}")
    fields = []
    for name, width in zip(GRAD_FIELDS, _WIDTHS):
        x = getattr(attrs, name)
        shape = (n, width) if width > 1 else (n,)
        if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        fields.append(x.contiguous() if width > 1 and x.stride(1) != 1 else x)
    valid = attrs.valid
    if valid.dtype != torch.bool or tuple(valid.shape) != (n,) or valid.device != dev:
        raise ValueError(f"valid must be bool ({n},) on {dev}, got {valid.dtype} {tuple(valid.shape)}")
    cams = []
    for name, x, shape in (("extrinsic", camera.extrinsic, (4, 4)), ("intrinsic", camera.intrinsic, (3, 3))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        cams.append(x.contiguous())
    strides = (_LL * 7)(*(x.stride(0) for x in (*fields, valid)))
    h, w = image_shape
    keep = (*fields, valid, *cams, strides)
    head = [*(x.data_ptr() for x in (*fields, valid)), strides, *(x.data_ptr() for x in cams), n, h, w,
            cfg.near, cfg.tan_clamp, cfg.lowpass, cfg.sigma_extent, int(front_only)]
    return head, keep


@tracing.span("render.preprocess_kernel")
def preprocess_kernel(attrs: GaussianAttrs, camera: Camera, image_shape, cfg: RasterConfig, front_only: bool = False):
    """`preprocess_fwd_plain`'s outputs, bitwise, from one launch of
    csrc/preprocess.cu's forward kernel (no autograd)."""
    head, _keep = _kernel_head(attrs, camera, image_shape, cfg, front_only)
    n, dev = attrs.means.shape[0], attrs.means.device
    params2d = torch.empty((n, PARAM_DIM), dtype=torch.float32, device=dev)
    radius = torch.empty(n, dtype=torch.float32, device=dev)
    depth_z = torch.empty(n, dtype=torch.float32, device=dev)
    in_view = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        fwd_kernel.launch(*head, params2d.data_ptr(), radius.data_ptr(), depth_z.data_ptr(), in_view.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    return params2d, radius, depth_z, in_view


@tracing.span("render.preprocess_bwd")
def preprocess_bwd_kernel(attrs: GaussianAttrs, camera: Camera, image_shape, cfg: RasterConfig, front_only: bool,
                          d_params2d, d_depth_z, need=(True,) * 6):
    """`preprocess_bwd_plain`'s gradients from one launch of
    csrc/preprocess.cu's backward kernel."""
    head, _keep = _kernel_head(attrs, camera, image_shape, cfg, front_only)
    n, dev = attrs.means.shape[0], attrs.means.device
    cots = []
    for name, x, shape in (("d_params2d", d_params2d, (n, PARAM_DIM)), ("d_depth_z", d_depth_z, (n,))):
        if x is not None and (x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != dev):
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got {x.dtype} {tuple(x.shape)}")
        cots.append(None if x is None else x.contiguous())
    grads = [torch.empty_like(getattr(attrs, f), memory_format=torch.contiguous_format) if want else None
             for f, want in zip(GRAD_FIELDS, need)]
    if n:
        bwd_kernel.launch(*head, *(0 if x is None else x.data_ptr() for x in (*cots, *grads)),
                          torch.cuda.current_stream(dev).cuda_stream)
    return tuple(grads)


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
