"""The 4-term mapping loss of one view (the per-view part of
`activegs_tpu/mapping/trainer.py::_view_loss`): masked L1 colour, 0.8
masked L1 depth, 0.1 consistency between the rendered normals and those of
`core/image_ops.py::depth_to_normal`, 0.1 edge-aware normal TV.

`view_loss` computes the loss as four per-pixel maps (`view_loss_maps_plain`:
rgb + 0.8 depth + 0.1 consistency and rgb + depth (h, w), the TV's two axis
terms (h, w - 1) and (h - 1, w)) that `reduce_maps` sums. On the CPU it is
that plain formula under autograd. On the card it is one autograd function:
one launch of `csrc/view_loss.cu`'s forward kernel writes the four maps,
bitwise those of the plain ops on the card, and the same `reduce_maps`
sums them, so loss_v and err_v are bitwise those of the plain formula; one
launch of its backward kernel writes the gradients of rgb, depth and
normal, bitwise autograd's through the plain formula: each pixel gathers
its terms in the order autograd accumulates them (`view_loss_bwd_plain`
is that gather written in torch, for the CPU tests). Bitwise matters
here: a leaf's gradient sums these over many pixels with much
cancellation, so last-bit differences in the depth gradient moved a
leaf's gradient norm by 7.7e-5 on the bench scene (an H100). The choice
depends only on the device. The opacity gets no gradient (it only
masks), the TV sees the depth detached, and err_v is not
differentiable.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import tracing
from ..core.image_ops import _pad_replicate, depth_to_normal
from ..core.quaternions import cross
from ..render._build import CudaKernel
from . import losses

CSRC = Path(__file__).resolve().parent / "csrc"
VISIBLE = 1e-3  # a pixel whose opacity is above this is visible
INV_TWO_SIGMA_SQ = 1.0 / (2.0 * losses.TV_SIGMA**2)


def view_loss(rgb, depth, normal, opacity, rgb_gt, depth_gt, intrinsic):
    """(loss_v, err_v) of one rendered view against its frame: loss_v =
    rgb + 0.8 depth + 0.1 consistency + 0.1 normal-TV, err_v = rgb + depth
    (the sampler's error). rgb, normal, rgb_gt (3, h, w); depth, opacity,
    depth_gt (1, h, w); intrinsic (3, 3)."""
    if rgb.device.type == "cpu":
        return reduce_maps(*view_loss_maps_plain(rgb, depth, normal, opacity, rgb_gt, depth_gt, intrinsic))
    return _ViewLoss.apply(rgb, depth, normal, opacity, rgb_gt, depth_gt, intrinsic)


def reduce_maps(map_loss, map_err, tv_x, tv_y):
    """(loss_v, err_v) from the four maps: the pixel terms' means, and the
    TV's two axis sums over 4 h w."""
    h, w = map_loss.shape
    inv_px = 1.0 / (h * w)
    tv = (torch.sum(tv_x) + torch.sum(tv_y)) / (4 * h * w)
    return torch.sum(map_loss) * inv_px + losses.W_TV * tv, torch.sum(map_err) * inv_px


def view_loss_maps_plain(rgb, depth, normal, opacity, rgb_gt, depth_gt, intrinsic):
    """The four maps of `reduce_maps` as plain torch ops: (rgb_px + 0.8
    depth_px + 0.1 cons_px, rgb_px + depth_px) (h, w), and the TV's axis
    terms (h, w - 1) and (h - 1, w)."""
    mask_vis = opacity.detach() > VISIBLE
    mask_depth = depth_gt > 0.0
    rgb_px = torch.sum(losses.l1_masked(rgb, rgb_gt, mask_vis), dim=0) / 3.0
    depth_px = losses.l1_masked(depth, depth_gt, mask_depth)[0]
    d2n = depth_to_normal(depth[0], mask_vis[0], intrinsic).permute(2, 0, 1)
    cons_px = losses.consistency_loss(normal[None], d2n[None])[0] * mask_vis[0]
    tv_x, tv_y = losses.normal_tv_maps(normal[None], depth.detach()[None], mask_depth[None])
    return rgb_px + losses.W_DEPTH * depth_px + losses.W_CONS * cons_px, rgb_px + depth_px, tv_x[0], tv_y[0]


class _ViewLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rgb, depth, normal, opacity, rgb_gt, depth_gt, intrinsic):
        ins = kernel_inputs(rgb, depth, normal, opacity, rgb_gt, depth_gt, intrinsic)
        loss_v, err_v = reduce_maps(*view_loss_kernel(*ins))
        ctx.save_for_backward(*ins)
        ctx.mark_non_differentiable(err_v)
        ctx.set_materialize_grads(False)
        return loss_v, err_v

    @staticmethod
    def backward(ctx, g_loss, _g_err):
        need = ctx.needs_input_grad[:3]
        if g_loss is None or not any(need):
            return (None,) * 7
        grads = view_loss_bwd_kernel(*ctx.saved_tensors, g_loss)
        return (*(g if want else None for g, want in zip(grads, need)), None, None, None, None)


# --------------------------------------------------------------------------
# the backward kernel's gather, as plain torch ops
# --------------------------------------------------------------------------


def _tv_pair_bwd(na, nb, da, db, ma, mb, gt):
    """A TV pair's cotangent on n_a (3, ...) (n_b gets its negation): the
    pair's weight gt times its mask, through term = (gate e) nd."""
    diff = na - nb
    nd = torch.sum(diff * diff, dim=0)
    gate = ((da - db) * (da - db) <= 1e-4).to(nd.dtype)
    e = torch.exp(-nd * INV_TWO_SIGMA_SQ)
    dterm = gt * (ma | mb).to(nd.dtype)
    dnd = dterm * (gate * e) + -((((dterm * nd) * gate) * e) * INV_TWO_SIGMA_SQ)
    return diff * (dnd * 2.0)


@torch.no_grad()
def view_loss_bwd_plain(rgb, depth, normal, opacity, rgb_gt, depth_gt, intrinsic, g_loss):
    """(d rgb, d depth, d normal) of loss_v for the upstream gradient
    `g_loss` (0-d), in the backward kernel's form: every pixel's
    depth-to-normal stencil works out what it sends back to its own point
    and to the four it read (replicate-padded), and each pixel gathers what
    is sent to it; each pixel sums its TV pairs likewise. Every sum runs
    in the order in which autograd accumulates the same terms through the
    plain formula (`view_loss_maps_plain`, `reduce_maps`), so the
    gradients are bitwise autograd's."""
    h, w = depth.shape[-2:]
    g1 = g_loss * (1.0 / (h * w))
    g_cons = g1 * losses.W_CONS
    mv, md = opacity[0] > VISIBLE, depth_gt[0] > 0.0
    mvf, mdf = mv.to(rgb.dtype), md.to(rgb.dtype)

    d_rgb = ((g1 / 3.0) * torch.sgn((rgb - rgb_gt) * mvf)) * mvf
    g_l1 = ((g1 * losses.W_DEPTH) * torch.sgn((depth[0] - depth_gt[0]) * mdf)) * mdf

    # depth_to_normal's stencil at every pixel at once: (h, w, 3) points,
    # their masks, and the four neighbours through the replicate padding
    k = intrinsic
    fx, fy, cx, cy = k[0, 0] * w, k[1, 1] * h, k[0, 2] * w, k[1, 2] * h
    ax = ((torch.arange(w, dtype=depth.dtype, device=depth.device) + 0.5) - cx) / fx
    ay = ((torch.arange(h, dtype=depth.dtype, device=depth.device) + 0.5) - cy) / fy
    d = depth[0]
    p = torch.stack([ax[None, :] * d, ay[:, None] * d, d], dim=-1)
    m = mvf[..., None]
    pp, mp = _pad_replicate(p, 1), _pad_replicate(m, 1)
    pc = p * m
    slot = {s: (pp[1 + di : 1 + di + h, 1 + dj : 1 + dj + w], mp[1 + di : 1 + di + h, 1 + dj : 1 + dj + w])
            for s, (di, dj) in {"u": (-1, 0), "l": (0, -1), "b": (1, 0), "r": (0, 1)}.items()}
    pu, pl, pb, pr = ((ps - pc) * ms for ps, ms in slot.values())
    n = cross(pu, pl) + cross(pr, pu) + cross(pb, pr) + cross(pl, pb)
    n2 = torch.sum(n * n, dim=-1, keepdim=True)
    r = torch.rsqrt(torch.clamp(n2, min=1e-24))
    d2n = (n * r) * m

    # what each stencil sends back: the consistency's cotangent on d2n
    # through (n r) m, the rsqrt and clamp, n . n (its two factors' terms
    # added one after the other) and the cross products
    dnn = (normal.permute(1, 2, 0) * -(g_cons * m)) * m
    t = dnn * n
    dr = ((t[..., 0] + t[..., 1]) + t[..., 2])[..., None]
    dn2 = torch.where(n2 >= 1e-24, (-0.5 * dr) * ((r * r) * r), 0.0)
    dn = (dnn * r + dn2 * n) + dn2 * n
    send = {
        "u": (cross(pl, dn) + cross(dn, pr)) * slot["u"][1],
        "l": (cross(dn, pu) + cross(pb, dn)) * slot["l"][1],
        "b": (cross(pr, dn) + cross(dn, pl)) * slot["b"][1],
        "r": (cross(pu, dn) + cross(dn, pb)) * slot["r"][1],
    }
    c0 = -(((send["r"] + send["b"]) + send["l"]) + send["u"]) * m

    # each pixel gathers what its neighbours' slots that read it send (the
    # left one's right slot, the upper's lower, the right's left, the
    # lower's upper), then its own point's, then what its own slots send
    # where the padding points them back at it (right, left, below, above)
    dp = torch.zeros_like(p)
    dp[:, 1:] += send["r"][:, :-1]
    dp[1:] += send["b"][:-1]
    dp[:, :-1] += send["l"][:, 1:]
    dp[:-1] += send["u"][1:]
    dp += c0
    dp[:, -1] += send["r"][:, -1]
    dp[:, 0] += send["l"][:, 0]
    dp[-1] += send["b"][-1]
    dp[0] += send["u"][0]
    d_depth = g_l1 + ((dp[..., 2] + dp[..., 1] * ay[:, None]) + dp[..., 0] * ax[None, :])

    # normal: the consistency's, and the TV pairs it is the second of
    # (above, left) and the first of (below, right)
    gt = (g_loss * losses.W_TV) / (4 * h * w)
    tvx = _tv_pair_bwd(normal[:, :, :-1], normal[:, :, 1:], d[:, :-1], d[:, 1:], md[:, :-1], md[:, 1:], gt)
    tvy = _tv_pair_bwd(normal[:, :-1], normal[:, 1:], d[:-1], d[1:], md[:-1], md[1:], gt)
    d_tv = torch.zeros_like(normal)
    d_tv[:, 1:] -= tvy
    d_tv[:, :-1] += tvy
    d_tv[:, :, 1:] -= tvx
    d_tv[:, :, :-1] += tvx
    return d_rgb, d_depth[None], (d2n * -(g_cons * m)).permute(2, 0, 1) + d_tv


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# shared head: rgb, depth, normal, opacity, rgb_gt, depth_gt, intrinsic, h,
# w, W_DEPTH, W_CONS, W_TV, 1 / (2 sigma^2), 1 / (h w)
_HEAD = [_P] * 7 + [_I, _I] + [_F] * 5
fwd_kernel = CudaKernel("view_loss", _HEAD + [_P] * 5, csrc=CSRC, name="view_loss_fwd")
bwd_kernel = CudaKernel("view_loss", _HEAD + [_P] * 5, csrc=CSRC, name="view_loss_bwd")
KERNELS = (fwd_kernel, bwd_kernel)
_CHANNELS = {"rgb": 3, "depth": 1, "normal": 3, "opacity": 1, "rgb_gt": 3, "depth_gt": 1}


def kernel_inputs(rgb, depth, normal, opacity, rgb_gt, depth_gt, intrinsic) -> tuple:
    """The kernels' inputs, contiguous, after checking what they take:
    float32 rgb, normal, rgb_gt (3, h, w), depth, opacity, depth_gt (1, h,
    w) and intrinsic (3, 3), all on one CUDA device."""
    if rgb.dim() != 3:
        raise ValueError(f"rgb must be (3, h, w), got {tuple(rgb.shape)}")
    h, w = rgb.shape[-2:]
    dev = rgb.device
    named = zip((*_CHANNELS, "intrinsic"), (rgb, depth, normal, opacity, rgb_gt, depth_gt, intrinsic))
    for name, x in named:
        shape = (3, 3) if name == "intrinsic" else (_CHANNELS[name], h, w)
        if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, got {dev}")
    return tuple(x.contiguous() for x in (rgb, depth, normal, opacity, rgb_gt, depth_gt, intrinsic))


def _head(ins) -> list:
    h, w = ins[0].shape[-2:]
    return [*(x.data_ptr() for x in ins), h, w, losses.W_DEPTH, losses.W_CONS, losses.W_TV, INV_TWO_SIGMA_SQ,
            1.0 / (h * w)]


@tracing.span("train.view_loss_kernel")
def view_loss_kernel(*ins):
    """`view_loss_maps_plain`'s four maps, bitwise, from one launch of
    csrc/view_loss.cu's forward kernel (no autograd); `ins` as
    `kernel_inputs` returns them."""
    h, w = ins[0].shape[-2:]
    maps = [torch.empty(shape, dtype=torch.float32, device=ins[0].device)
            for shape in ((h, w), (h, w), (h, w - 1), (h - 1, w))]
    fwd_kernel.launch(*_head(ins), *(m.data_ptr() for m in maps), torch.cuda.current_stream(ins[0].device).cuda_stream)
    return tuple(maps)


@tracing.span("train.view_loss_bwd")
def view_loss_bwd_kernel(*ins_and_g):
    """`view_loss_bwd_plain`'s gradients (d rgb, d depth, d normal) from one
    launch of csrc/view_loss.cu's backward kernel; the inputs as
    `kernel_inputs` returns them, then the upstream gradient of loss_v, a
    0-d float32 tensor on their device, read there."""
    *ins, g_loss = ins_and_g
    dev = ins[0].device
    if g_loss.dtype != torch.float32 or g_loss.dim() != 0 or g_loss.device != dev:
        raise ValueError(f"the gradient of loss_v must be a 0-d float32 tensor on {dev}, got {g_loss.dtype} "
                         f"{tuple(g_loss.shape)} on {g_loss.device}")
    grads = [torch.empty_like(x, memory_format=torch.contiguous_format) for x in ins[:3]]
    bwd_kernel.launch(*_head(ins), g_loss.contiguous().data_ptr(), *(g.data_ptr() for g in grads),
                      torch.cuda.current_stream(dev).cuda_stream)
    return tuple(grads)
