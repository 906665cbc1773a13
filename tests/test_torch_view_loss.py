"""The 4-term view loss of `activegs_torch/mapping/view_loss.py`.

On the CPU: the plain maps reduce bitwise to the unfused terms (the loss as
`trainer._view_loss` wrote it before the kernels), value and gradients, and
`view_loss_bwd_plain`, the backward kernel's gather written in torch, holds
against autograd through that formula; the wrapper's checks. On the card
(marked `cuda`, skipped without one): the kernels against the plain
versions at the bench's 512 x 512 and at sizes that are not tile-aligned,
run to run, without host reads, one launch each way a view. This file
imports no JAX.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from activegs_torch.core import geometry as geo
from activegs_torch.core.image_ops import depth_to_normal
from activegs_torch.mapping import losses, trainer
from activegs_torch.mapping import view_loss as vl
from activegs_torch.render.types import RenderOutput

torch.set_num_threads(2)

SIZES = [(64, 48), (37, 29)]
TINY = [(1, 5), (4, 1), (2, 3)]


def frame(h, w, seed=0, device="cpu"):
    """A rendered view and its frame that reach every branch: depth a tilted
    plane (steps within the TV's flat gate) with a raised block (beyond
    it), normals that vary smoothly with noise, opacity under, at (float32
    1e-3, not visible) and over the visibility cut in bands that cross the
    stencils and the edges (at 8 pixels a side and more), and depth_gt zero
    in a corner and along an edge."""
    g = torch.Generator().manual_seed(seed)
    ii, jj = torch.meshgrid(torch.arange(h, dtype=torch.float32), torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    depth = 1.5 + 0.004 * ii - 0.003 * jj + 0.002 * torch.rand(h, w, generator=g)
    depth[h // 3 : h // 2 + 1, w // 4 : w // 2 + 1] += 0.4
    n = torch.stack([0.2 * torch.sin(ii / 5), 0.1 * torch.cos(jj / 4), -torch.ones(h, w)])
    n = n + 0.05 * torch.randn(3, h, w, generator=g)
    normal = n / torch.linalg.vector_norm(n, dim=0, keepdim=True)
    opacity = torch.rand(h, w, generator=g)
    if min(h, w) >= 8:
        opacity[:, (2 * w) // 3] = 1e-4
        opacity[h // 4] = 1e-3
        opacity[0, : w // 2] = 0.0
        opacity[-1, w // 3 :] = 1e-3
    rgb = torch.rand(3, h, w, generator=g)
    rgb_gt = torch.rand(3, h, w, generator=g)
    rgb_gt[:, -1, :2] = rgb[:, -1, :2]  # |e| = 0: abs's subgradient 0
    depth_gt = depth + 0.02 * torch.randn(h, w, generator=g)
    depth_gt[: h // 3, : w // 3] = 0.0
    depth_gt[:, -1] = 0.0
    intr = geo.intrinsics_from_fov(60.0, 50.0, device="cpu")
    intr[0, 2], intr[1, 2] = 0.47, 0.53
    f = {"rgb": rgb, "depth": depth[None], "normal": normal, "opacity": opacity[None], "rgb_gt": rgb_gt,
         "depth_gt": depth_gt[None], "intrinsic": intr}
    return {k: v.to(device) for k, v in f.items()}


def args(f, leaves=None):
    f = {**f, **(leaves or {})}
    return f["rgb"], f["depth"], f["normal"], f["opacity"], f["rgb_gt"], f["depth_gt"], f["intrinsic"]


def leaves_of(f):
    return {k: f[k].clone().requires_grad_(True) for k in ("rgb", "depth", "normal")}


def unfused(o, rgb_gt, depth_gt, intrinsic):
    """The view loss as `trainer._view_loss` computed it before the kernels:
    the four terms by the loss functions, the TV by `normal_tv_loss`."""
    h, w = rgb_gt.shape[-2:]
    mask_vis = o.opacity.detach() > 1e-3
    mask_depth = depth_gt > 0.0
    rgb_px = torch.sum(losses.l1_masked(o.rgb, rgb_gt, mask_vis), dim=0) / 3.0
    depth_px = losses.l1_masked(o.depth, depth_gt, mask_depth)[0]
    d2n = depth_to_normal(o.depth[0], mask_vis[0], intrinsic).permute(2, 0, 1)
    cons_px = losses.consistency_loss(o.normal[None], d2n[None])[0] * mask_vis[0]
    tv = losses.normal_tv_loss(o.normal[None], o.depth.detach()[None], mask_depth[None])
    inv_px = 1.0 / (h * w)
    loss_v = (
        torch.sum(rgb_px + losses.W_DEPTH * depth_px + losses.W_CONS * cons_px) * inv_px
        + losses.W_TV * tv
    )
    err_v = torch.sum(rgb_px + depth_px) * inv_px
    return loss_v, err_v


def output(f, leaves):
    return RenderOutput(rgb=leaves["rgb"], depth=leaves["depth"], normal=leaves["normal"], opacity=f["opacity"],
                        confidence=f["opacity"])


def rel(a, b) -> float:
    """Relative L2 gap; 0 where the two are equal (zero gradients too)."""
    return 0.0 if torch.equal(a, b) else float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("size", SIZES + TINY, ids=str)
def test_maps_reduce_bitwise_to_the_unfused_terms(size):
    """On the CPU `_view_loss` is the plain maps and their sums: loss_v,
    err_v and the gradients of rgb, depth and normal bitwise those of the
    unfused formula."""
    f = frame(*size)
    la, lb = leaves_of(f), leaves_of(f)
    got = trainer._view_loss(output(f, la), f["rgb_gt"], f["depth_gt"], f["intrinsic"])
    want = unfused(output(f, lb), f["rgb_gt"], f["depth_gt"], f["intrinsic"])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ga = torch.autograd.grad(got[0], list(la.values()))
    gb = torch.autograd.grad(want[0], list(lb.values()))
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
    assert got[0].grad_fn.name() != "_ViewLossBackward"
    # the maps' shapes; where opacity is exactly 1e-3 only the depth term
    maps = vl.view_loss_maps_plain(*args(f))
    h, w = size
    assert [tuple(m.shape) for m in maps] == [(h, w), (h, w), (h, w - 1), (h - 1, w)]
    if h > 4:
        depth_px = torch.abs((f["depth"] - f["depth_gt"]) * (f["depth_gt"] > 0))[0, h // 4]
        assert torch.equal(maps[1][h // 4], depth_px)
        assert torch.equal(maps[0][h // 4], losses.W_DEPTH * depth_px)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("size", SIZES + TINY, ids=str)
def test_bwd_plain_matches_autograd(size, seed):
    """The backward kernel's gather, in torch, bitwise autograd's gradients
    through the unfused formula, at an upstream gradient other than 1:
    every sum runs in the order autograd accumulates its terms. The
    stencil's and the TV's parts are a real share of the depth's and the
    normal's gradients."""
    f = frame(*size, seed=seed)
    leaves = leaves_of(f)
    g = torch.tensor(0.37)
    loss_v, _ = unfused(output(f, leaves), f["rgb_gt"], f["depth_gt"], f["intrinsic"])
    want = torch.autograd.grad(loss_v, list(leaves.values()), g)
    got = vl.view_loss_bwd_plain(*args(f), g)
    for name, a, b in zip(leaves, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b), (name, rel(a, b))
    if min(size) < 4:
        return
    h, w = size
    mdf = (f["depth_gt"] > 0).float()
    l1_only = ((g / (h * w) * losses.W_DEPTH) * torch.sgn((f["depth"] - f["depth_gt"]) * mdf)) * mdf
    assert rel(l1_only, got[1]) > 1e-2
    # without the TV (a mask of no depth anywhere) the normal's gradient moves
    f0 = {**f, "depth_gt": torch.zeros_like(f["depth_gt"])}
    assert rel(vl.view_loss_bwd_plain(*args(f0), g)[2], got[2]) > 1e-2


def test_opacity_gets_no_gradient():
    """The opacity only masks: autograd through the loss leaves it out, as
    the backward kernel returns nothing for it."""
    f = frame(*SIZES[1])
    op = f["opacity"].clone().requires_grad_(True)
    loss_v, _ = vl.view_loss(*args(f, {"opacity": op, "rgb": f["rgb"].clone().requires_grad_(True)}))
    assert torch.autograd.grad(loss_v, op, allow_unused=True)[0] is None


def test_wrapper_refuses_what_the_kernels_cannot_take():
    """Wrong shapes, dtypes or devices, and any CPU tensor, raise before a
    launch; the CPU path launches nothing."""
    f = frame(*SIZES[1])
    n0 = [k.launches for k in vl.KERNELS]
    bad = {
        "rgb": f["rgb"][:2],
        "depth": f["depth"][:, 1:],
        "normal": f["normal"].double(),
        "opacity": f["opacity"].to("meta"),
        "depth_gt": f["depth_gt"][0],
        "intrinsic": f["intrinsic"][:2],
    }
    for name, x in bad.items():
        with pytest.raises(ValueError, match=name):
            vl.kernel_inputs(*args(f, {name: x}))
    with pytest.raises(ValueError, match="CUDA"):
        vl.kernel_inputs(*args(f))
    vl.view_loss(*args(f))
    assert [k.launches for k in vl.KERNELS] == n0


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


CARD_SIZES = [(512, 512), (37, 29), (64, 48), (1, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("size", CARD_SIZES, ids=str)
def test_kernel_maps_are_bitwise_the_plain_ones(cuda, size):
    """The forward kernel's four maps bitwise `view_loss_maps_plain`'s on the
    card, and loss_v, err_v bitwise the unfused formula's."""
    f = frame(*size, device=cuda)
    ins = vl.kernel_inputs(*args(f))
    got, want = vl.view_loss_kernel(*ins), vl.view_loss_maps_plain(*args(f))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.equal(a, b), float((a - b).abs().max())
    lk = vl.view_loss(*args(f))
    lp = unfused(output(f, f), f["rgb_gt"], f["depth_gt"], f["intrinsic"])
    assert torch.equal(lk[0], lp[0]) and torch.equal(lk[1], lp[1])


@pytest.mark.cuda
@pytest.mark.parametrize("size", CARD_SIZES, ids=str)
def test_bwd_kernel_matches_autograd(cuda, size):
    """The backward kernel bitwise `view_loss_bwd_plain` on the card, and
    both bitwise autograd's gradients through the unfused formula (well
    within the 1e-6 relative that the loss's gradients may move)."""
    f = frame(*size, device=cuda)
    g = torch.tensor(0.37, device=cuda)
    leaves = leaves_of(f)
    loss_v, _ = unfused(output(f, leaves), f["rgb_gt"], f["depth_gt"], f["intrinsic"])
    want = torch.autograd.grad(loss_v, list(leaves.values()), g)
    got = vl.view_loss_bwd_kernel(*vl.kernel_inputs(*args(f)), g)
    plain = vl.view_loss_bwd_plain(*args(f), g)
    torch.cuda.synchronize()
    for name, a, p, b in zip(leaves, got, plain, want):
        assert torch.equal(a, p), (name, float((a - p).abs().max()))
        assert rel(a, b) <= 1e-6, (name, rel(a, b))
        assert torch.equal(a, b), (name, rel(a, b))
    # the autograd function's backward is the kernel's
    leaves = leaves_of(f)
    loss_k, err_k = vl.view_loss(*args(f, leaves))
    assert not err_k.requires_grad
    assert all(torch.equal(a, b) for a, b in zip(torch.autograd.grad(loss_k, list(leaves.values()), g), got))


@pytest.mark.cuda
def test_kernels_are_bitwise_run_to_run(cuda):
    f = frame(512, 512, seed=3, device=cuda)
    g = torch.tensor(1.25, device=cuda)

    def once():
        leaves = leaves_of(f)
        loss_v, err_v = vl.view_loss(*args(f, leaves))
        return (loss_v.detach(), err_v, *torch.autograd.grad(loss_v, list(leaves.values()), g))

    first = once()
    for _ in range(4):
        assert all(torch.equal(a, b) for a, b in zip(first, once()))


@pytest.mark.cuda
def test_view_loss_makes_no_host_read(cuda):
    """Under torch's sync debug mode "error" the loss of a view on the card,
    forward and backward, makes the host wait for nothing; each kernel runs
    once, inside its span."""
    from activegs_torch import tracing

    f = frame(512, 512, device=cuda)
    leaves = leaves_of(f)
    n0 = [k.launches for k in vl.KERNELS]
    tracing.clear()
    torch.cuda.synchronize()
    with tracing.recording():
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss_v, _ = vl.view_loss(*args(f, leaves))
            grads = torch.autograd.grad(loss_v, list(leaves.values()))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(vl.KERNELS, n0)] == [1, 1]
    names = [r.name for r in tracing.spans()]
    assert names.count("train.view_loss_kernel") == names.count("train.view_loss_bwd") == 1
    assert not [n for n in names if n.startswith("sync.")]
    assert all(torch.isfinite(x).all() for x in grads)


@pytest.mark.cuda
def test_wrapper_refuses_on_the_card(cuda):
    f = frame(*SIZES[1], device=cuda)
    for name, x in {"rgb_gt": f["rgb_gt"].cpu(), "normal": f["normal"].half(), "depth": f["depth"][None]}.items():
        with pytest.raises(ValueError, match=name):
            vl.kernel_inputs(*args(f, {name: x}))
    ins = vl.kernel_inputs(*args(f))
    with pytest.raises(ValueError, match="gradient"):
        vl.view_loss_bwd_kernel(*ins, torch.ones(1, device=cuda))


@pytest.mark.cuda
def test_keyframe_runs_one_launch_each_way_a_view(cuda):
    """A 10-step `train_keyframe` on a small map (per-view subsets, frozen
    bins): one forward and one backward launch a view and a step, and the
    last loss within 4 float32 ulps of the plain path's (the plain loss
    under autograd on the card)."""
    from unittest import mock

    from test_torch_gpu import card_keyframe

    cfg, rcfg, state, buf = card_keyframe(cuda, capacity=32768)
    cfg = dataclasses.replace(cfg, optimization_steps=10)
    views = trainer.draw_batch(buf, cfg, torch.Generator().manual_seed(3))
    max_iv, max_e = trainer.keyframe_view_stats(state, buf, views[0], cfg, rcfg)
    bucket, budget = trainer.pick_subset_bucket(max_iv, state.capacity), trainer.pick_entry_bucket(max_e)

    def keyframe():
        b = dataclasses.replace(buf, performance=buf.performance.clone())
        return trainer.train_keyframe(state, b, views, cfg, rcfg, subset_bucket=bucket, entry_budget=budget)

    for k in vl.KERNELS:
        k.launches = 0
    got = keyframe()
    n = 10 * len(views[0])
    assert vl.fwd_kernel.launches == vl.bwd_kernel.launches == n

    def plain(*a):
        return vl.reduce_maps(*vl.view_loss_maps_plain(*a))

    with mock.patch.object(trainer, "view_loss", plain):
        want = keyframe()
    assert vl.fwd_kernel.launches == n
    lk, lp = float(got[2]), float(want[2])
    assert math.isfinite(lk)
    assert abs(lk - lp) <= 4 * float(np.spacing(np.float32(lp))), (lk, lp)
