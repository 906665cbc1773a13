"""The preprocess function's own algorithm on the CPU: `preprocess_bwd_plain`
(the backward kernel's chain rule, written in its order) against autograd
through `preprocess_fwd_plain`, on inputs that reach every branch, and the
autograd function `preprocess` against the JAX reference's `preprocess`
and its `jax.vjp`. The kernels themselves run in `tests/test_torch_gpu.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activegs_torch.core import geometry as geo
from activegs_torch.render import preprocess as tpp
from activegs_torch.render import types as tt
from activegs_tpu.render import preprocess as jpp
from test_render import CFG, make_attrs, make_camera
from test_torch_core import assert_close, assert_scaled, t_attrs, t_cam, to_t
from test_torch_render import SHAPE, tcfg, tilted_camera

torch.set_num_threads(2)

FIELDS = tpp.GRAD_FIELDS


def branch_scene(n=160, seed=3):
    """Seeded gaussians and a tilted camera that reach every branch of the
    backward: in view, out of the image, behind `near` and behind the
    camera, invalid slots, and the tan clamps exceeded on both sides by
    large surfels still in view."""
    rng = np.random.default_rng(seed)
    z = np.concatenate([rng.uniform(0.3, 4.0, n - 40), rng.uniform(-1.0, 0.05, 20), np.full(20, 1.5)])
    xy = rng.uniform(-1.2, 1.2, (n, 2)) * np.abs(z)[:, None]
    xy[-20:, 0] = rng.choice([-1.0, 1.0], 20) * rng.uniform(1.6, 3.0, 20)  # beyond the clamp
    means = np.concatenate([xy, z[:, None]], 1)
    scales = np.exp(rng.uniform(np.log(1e-3), np.log(0.4), (n, 3)))
    scales[-20:] = rng.uniform(0.8, 1.6, (20, 3))  # large enough to stay in view
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    attrs = tt.GaussianAttrs(
        means=f32(means), scales=f32(scales), rotations=f32(q), opacities=f32(rng.uniform(0.05, 1.0, n)),
        colors=f32(rng.uniform(0, 1, (n, 3))), confidences=f32(rng.uniform(0, 1, n)),
        valid=torch.as_tensor(rng.uniform(size=n) > 0.1),
    )
    intr = geo.intrinsics_from_fov(60.0, 60.0, device="cpu")
    ext = geo.look_at((0.1, -0.2, -0.3), (0.0, 0.05, 2.0), device="cpu")
    return attrs, tt.Camera(ext, intr)


def clamp_scene(cfg):
    """The identity camera and surfels at exactly +-lim_x and +-lim_y (and
    one beyond each), at depth 1, large enough to be in view (the identity
    camera gives vx = mx there, so mx = +-lim_x is at the clamp); and one
    behind the camera."""
    intr = geo.intrinsics_from_fov(60.0, 60.0, device="cpu")
    h, w = SHAPE
    lim_x = float(cfg.tan_clamp * (0.5 * w / (intr[0, 0] * w)))
    lim_y = float(cfg.tan_clamp * (0.5 * h / (intr[1, 1] * h)))
    means = torch.tensor([[lim_x, 0.1, 1.0], [-lim_x, -0.1, 1.0], [0.1, lim_y, 1.0], [-0.1, -lim_y, 1.0],
                          [1.5 * lim_x, 0.0, 1.0], [0.0, -1.5 * lim_y, 1.0], [0.2, 0.1, 1.0], [0.0, 0.0, -1.0]])
    n = len(means)
    rng = np.random.default_rng(5)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    attrs = tt.GaussianAttrs(
        means=means, scales=f32(rng.uniform(0.3, 0.5, (n, 3))), rotations=f32(q),
        opacities=f32(rng.uniform(0.2, 1, n)), colors=f32(rng.uniform(0, 1, (n, 3))),
        confidences=f32(rng.uniform(0, 1, n)), valid=torch.ones(n, dtype=torch.bool),
    )
    return attrs, tt.Camera(torch.eye(4), intr)


def det_floor_scene():
    """Without the low-pass, a surfel of zero scales has det = 0, below the
    floor of 1e-12; another of tiny scales sits just above or below it."""
    attrs, cam = clamp_scene(tt.RasterConfig())
    scales = attrs.scales.clone()
    scales[0] = 0.0
    scales[1] = torch.tensor([1e-4, 1e-4, 0.0])
    return dataclasses.replace(attrs, scales=scales), cam


CASES = {
    "branches": (branch_scene, tt.RasterConfig(), False),
    "branches_front_only": (branch_scene, tt.RasterConfig(), True),
    "at_the_clamp": (lambda: clamp_scene(tt.RasterConfig()), tt.RasterConfig(), False),
    "det_floor": (det_floor_scene, tt.RasterConfig(lowpass=0.0), False),
}
# on every row of params2d, on depth_z, on both, and on the conic rows
# alone (there the means' gradient comes through the Jacobian, where the tan
# clamps act, and not straight from the projected center)
COTANGENTS = ("params2d", "depth_z", "both", "conic")


def cotangents(n, which, seed=0):
    rng = np.random.default_rng(seed)
    d_p = torch.as_tensor(rng.normal(size=(n, tt.PARAM_DIM)).astype(np.float32))
    d_z = torch.as_tensor(rng.normal(size=n).astype(np.float32))
    if which == "conic":
        d_p[:, : tt.P_CONIC_A] = 0.0
        d_p[:, tt.P_CONIC_C + 1 :] = 0.0
    return (None if which == "depth_z" else d_p), (None if which in ("params2d", "conic") else d_z)


def autograd_grads(attrs, cam, cfg, front_only, d_p, d_z):
    leaves = {f: getattr(attrs, f).clone().requires_grad_(True) for f in FIELDS}
    p2d, _, dz, _ = tpp.preprocess_fwd_plain(dataclasses.replace(attrs, **leaves), cam, SHAPE, cfg, front_only)
    outs = [(o, d) for o, d in ((p2d, d_p), (dz, d_z)) if d is not None]
    got = torch.autograd.grad([o for o, _ in outs], list(leaves.values()), [d for _, d in outs], allow_unused=True)
    return [torch.zeros_like(leaves[f]) if g is None else g for f, g in zip(FIELDS, got)]


def rel_l2(got, want) -> float:
    den = float(torch.linalg.vector_norm(want))
    return float(torch.linalg.vector_norm(got - want)) / den if den else float(torch.linalg.vector_norm(got))


@pytest.mark.parametrize("cot", COTANGENTS)
@pytest.mark.parametrize("case", list(CASES))
def test_bwd_plain_matches_autograd(case, cot):
    """Each leaf's gradient within relative L2 1e-5 of autograd's through
    the plain forward, for cotangents on params2d, on depth_z and on both."""
    make, cfg, front_only = CASES[case]
    attrs, cam = make()
    iv = tpp.preprocess_fwd_plain(attrs, cam, SHAPE, cfg, front_only)[3]
    assert 0 < int(iv.sum()) < attrs.num  # some in view, some not
    d_p, d_z = cotangents(attrs.num, cot)
    want = autograd_grads(attrs, cam, cfg, front_only, d_p, d_z)
    got = tpp.preprocess_bwd_plain(attrs, cam, SHAPE, cfg, front_only, d_p, d_z)
    for f, g, w in zip(FIELDS, got, want):
        assert g.shape == w.shape, f
        assert torch.isfinite(g).all(), f
        assert rel_l2(g, w) <= 1e-5, (f, rel_l2(g, w))
    # the gradient that only depth_z carries reaches the means of gaussians out of view
    if d_z is not None and d_p is None:
        assert bool(got[0][~iv].abs().sum(1).gt(0).any())


def test_scenes_reach_every_branch():
    """The scenes above do reach what they are meant to: in view beyond the
    tan clamps and exactly at them, behind `near`, and det at or below the
    floor."""
    cfg = tt.RasterConfig()
    attrs, cam = branch_scene()
    t = tpp._project(attrs, cam, SHAPE, cfg, False)
    assert bool((~t.in_front).any()) and bool((t.in_view & (t.vx.abs() > t.lim_x)).any())
    attrs, cam = clamp_scene(cfg)
    t = tpp._project(attrs, cam, SHAPE, cfg, False)
    assert int((t.in_view & ((t.vx.abs() == t.lim_x) | (t.vy.abs() == t.lim_y))).sum()) == 4
    attrs, cam = det_floor_scene()
    t = tpp._project(attrs, cam, SHAPE, tt.RasterConfig(lowpass=0.0), False)
    assert bool((t.det <= 1e-12).any())


def test_function_dispatches_to_the_plain_versions_on_the_cpu():
    """On CPU tensors `preprocess` gives `preprocess_fwd_plain`'s outputs
    bitwise, launches no kernel, and its gradients are
    `preprocess_bwd_plain`'s bitwise; radius and in_view take none."""
    attrs, cam = branch_scene()
    cfg = tt.RasterConfig()
    launches = [k.launches for k in tpp.KERNELS]
    leaves = {f: getattr(attrs, f).clone().requires_grad_(True) for f in FIELDS}
    out = tpp.preprocess(dataclasses.replace(attrs, **leaves), cam, SHAPE, cfg)
    want = tpp.preprocess_fwd_plain(attrs, cam, SHAPE, cfg)
    for o, w in zip(out, want):
        assert torch.equal(o, w)
    assert not out[1].requires_grad and not out[3].requires_grad
    d_p, d_z = cotangents(attrs.num, "both", seed=1)
    got = torch.autograd.grad([out[0], out[2]], list(leaves.values()), [d_p, d_z])
    for g, w in zip(got, tpp.preprocess_bwd_plain(attrs, cam, SHAPE, cfg, False, d_p, d_z)):
        assert torch.equal(g, w)
    assert [k.launches for k in tpp.KERNELS] == launches


def test_kernel_wrappers_refuse_cpu_tensors():
    attrs, cam = branch_scene(n=48)
    with pytest.raises(ValueError, match="CUDA"):
        tpp.preprocess_kernel(attrs, cam, SHAPE, tt.RasterConfig())
    with pytest.raises(ValueError, match="CUDA"):
        tpp.preprocess_bwd_kernel(attrs, cam, SHAPE, tt.RasterConfig(), False, None, None)


@pytest.mark.parametrize("front_only", [False, True], ids=["all", "front"])
@pytest.mark.parametrize("camera", ["eye", "tilted"])
def test_function_matches_reference_values_and_vjp(camera, front_only):
    """`preprocess` (the autograd function) against the reference's
    `preprocess` and its `jax.vjp` with cotangents on params2d and depth_z:
    params2d at the image tolerance 2e-5, radius and in_view exactly, the
    six leaves' gradients at 3e-4 after scaling."""
    attrs = make_attrs(96, seed=7)
    cam = make_camera() if camera == "eye" else tilted_camera()
    rng = np.random.default_rng(2)
    cot_p = rng.normal(size=(attrs.num, tt.PARAM_DIM)).astype(np.float32)
    cot_z = rng.normal(size=attrs.num).astype(np.float32)

    def jfn(*leaves):
        out = jpp.preprocess(dataclasses.replace(attrs, **dict(zip(FIELDS, leaves))), cam, SHAPE, CFG,
                             front_only=front_only)
        return out[0], out[2]

    (w_p2d, w_dz), vjp = jax.vjp(jfn, *[getattr(attrs, f) for f in FIELDS])
    want_g = vjp((jnp.asarray(cot_p), jnp.asarray(cot_z)))
    w_out = jax.jit(jpp.preprocess, static_argnums=(2, 3), static_argnames=("front_only",))(
        attrs, cam, SHAPE, CFG, front_only=front_only)

    ta = t_attrs(attrs)
    leaves = [getattr(ta, f).clone().requires_grad_(True) for f in FIELDS]
    out = tpp.preprocess(dataclasses.replace(ta, **dict(zip(FIELDS, leaves))), t_cam(cam), SHAPE, tcfg(CFG),
                         front_only=front_only)
    assert_close(out[0], w_p2d, rtol=0, atol=2e-5)
    assert_close(out[1], w_out[1], rtol=0, atol=0)
    assert_close(out[2], w_dz, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(w_out[3]))
    got_g = torch.autograd.grad([out[0], out[2]], leaves, [to_t(cot_p), to_t(cot_z)])
    for f, g, w in zip(FIELDS, got_g, want_g):
        assert_scaled(g, w, msg=f)
