"""Parity of the PyTorch port's rasterizer with the JAX reference.

The same seeded scenes (`tests/test_render.py` inputs) go through the
reference (Pallas kernels in interpret mode) and the port on the CPU, where
the compositor wrappers run their plain PyTorch versions. Tolerances are the
reference's own: images 2e-5, depth 1e-4, gradients 3e-4 after scaling by
the largest reference gradient, binning equal as integers. The kernels
themselves run only on a GPU (`tests/test_torch_gpu.py`).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activegs_torch.render import binning as tbin
from activegs_torch.render import composite as tcp
from activegs_torch.render import dense as tdense
from activegs_torch.render import preprocess as tpp
from activegs_torch.render import renderer as tr
from activegs_torch.render import types as tt
from activegs_tpu.render import binning as jbin
from activegs_tpu.render import composite_pallas as jcp
from activegs_tpu.render import preprocess as jpp
from activegs_tpu.render import renderer as jr
from activegs_tpu.render import types as jt
from test_render import CFG, CFG_SMALL_CHUNK, _loss_fn, make_attrs, make_camera
from test_torch_core import assert_close, assert_scaled, t_attrs, t_cam, t_like, to_t

torch.set_num_threads(2)

SHAPE = (64, 64)
CFGS = {"k128": CFG, "k8": CFG_SMALL_CHUNK}
GRAD_NAMES = ("means", "scales", "rotations", "opacities", "colors")
IMAGE_KEYS = ("rgb", "normal", "opacity", "confidence")


# The reference runs under jit, as in its own pipeline: one compile per shape
# and config, where eager dispatch of its interpret-mode kernels and sorts
# takes seconds per call on the CPU.
j_preprocess = jax.jit(jpp.preprocess, static_argnums=(2, 3), static_argnames=("front_only",))
j_bin_entries = jax.jit(jbin.bin_entries, static_argnums=(3, 4), static_argnames=("entry_budget",))
j_entry_count = jax.jit(jbin.entry_count, static_argnums=(2, 3))
j_candidate_tiles = jax.jit(jbin.candidate_tiles, static_argnums=(2, 3))
j_prepare_entries = jax.jit(jr._prepare_entries, static_argnums=(2, 3, 4))
j_render_view = jax.jit(jr.render_view, static_argnums=(2, 3), static_argnames=("front_only",))
j_render_stats = jax.jit(
    jr.render_stats, static_argnums=(2, 3), static_argnames=("subset_bucket", "entry_budget")
)
j_composite_stats = jax.jit(jcp.composite_stats, static_argnums=(4, 5, 6, 7))


@functools.partial(jax.jit, static_argnums=(3,))
def j_composite_vjp(entries, tile_start, tile_len, static, gout):
    """composite_tiled's output and its entry cotangent for `gout`."""
    out, vjp = jax.vjp(lambda e: jcp.composite_tiled(e, tile_start, tile_len, static), entries)
    return out, vjp(gout)[0]


def tcfg(cfg) -> tt.RasterConfig:
    return t_like(tt.RasterConfig, cfg)


def tilted_camera():
    from test_mapping import look_at_pose

    ext = look_at_pose((0.2, -0.3, -0.5), (0.0, 0.1, 2.0))
    return jt.Camera(extrinsic=jnp.asarray(ext), intrinsic=make_camera().intrinsic)


def assert_images(out_t, out_j):
    for k in IMAGE_KEYS:
        assert_close(getattr(out_t, k), getattr(out_j, k), rtol=0, atol=2e-5, msg=k)
    assert_close(out_t.depth, out_j.depth, rtol=0, atol=1e-4, msg="depth")


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------


def test_layout_and_config_defaults_match():
    names = [n for n in dir(jt) if n[:2] in ("P_", "O_") or n in ("PARAM_DIM", "OUT_DIM", "OUT_ROWS", "FEAT_DIM")]
    assert names
    for n in names:
        if hasattr(tt, n):
            assert getattr(tt, n) == getattr(jt, n), n
    for n in ("P_DEPTH_Z", "P_EXT_Y", "O_TRANS", "PARAM_DIM", "FEAT_DIM"):
        assert getattr(tt, n) == getattr(jt, n), n
    # the compositor's own output rows
    assert (tt.O_DEPTH, tt.O_CONF, tt.O_TRANS, tt.O_STOP) == (jcp.ROW_DEPTH, jcp.ROW_CONF, jcp.ROW_TRANS, jcp.ROW_STOP)
    assert tt.OUT_ROWS == jcp.OUT_ROWS
    ref = jt.RasterConfig()
    for f in dataclasses.fields(tt.RasterConfig):
        assert getattr(tt.RasterConfig(), f.name) == getattr(ref, f.name), f.name
    assert (tt.RasterConfig().tile_h, tt.RasterConfig().tile_w, tt.RasterConfig().chunk) == (16, 32, 128)


# ---------------------------------------------------------------------------
# preprocess
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("front_only", [False, True], ids=["all", "front"])
@pytest.mark.parametrize("camera", ["eye", "tilted"])
def test_preprocess_values(camera, front_only):
    attrs = make_attrs(96, seed=1)
    cam = make_camera() if camera == "eye" else tilted_camera()
    want = j_preprocess(attrs, cam, SHAPE, CFG, front_only=front_only)
    got = tpp.preprocess(t_attrs(attrs), t_cam(cam), SHAPE, tcfg(CFG), front_only=front_only)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert_close(got[0], want[0], atol=2e-6)
    assert_close(got[1], want[1], rtol=0, atol=0)
    assert_close(got[2], want[2])


def test_preprocess_vjp():
    attrs = make_attrs(64, seed=4)
    cam = tilted_camera()
    names = GRAD_NAMES + ("confidences",)
    cot = np.random.default_rng(0).normal(size=(attrs.num, tt.PARAM_DIM)).astype(np.float32)

    def jfn(*leaves):
        a = dataclasses.replace(attrs, **dict(zip(names, leaves)))
        return jpp.preprocess(a, cam, SHAPE, CFG)[0]

    want = jax.jit(lambda *x: jax.vjp(jfn, *x)[1](jnp.asarray(cot)))(*[getattr(attrs, n) for n in names])
    ta = t_attrs(attrs)
    leaves = [getattr(ta, n).clone().requires_grad_(True) for n in names]
    p2d = tpp.preprocess(dataclasses.replace(ta, **dict(zip(names, leaves))), t_cam(cam), SHAPE, tcfg(CFG))[0]
    got = torch.autograd.grad(p2d, leaves, to_t(cot))
    for n, g, w in zip(names, got, want):
        assert_scaled(g, w, msg=n)


def test_pair_terms_match_reference():
    """`eval_alpha_depth_cols` / `eval_pair_terms_bwd` on one view's entry
    rows: the per-(entry, pixel) math shared by compositor and oracle."""
    attrs = make_attrs(96, seed=1)
    p2d = np.asarray(jpp.preprocess(attrs, make_camera(), SHAPE, CFG)[0])
    px = (np.arange(64, dtype=np.float32) + 0.5)[None, :]
    py = np.full((1, 64), 20.5, np.float32)
    jcols = jpp.entry_cols(jnp.asarray(p2d))
    tcols = tpp.entry_cols(to_t(p2d))
    for jv, tv in zip(
        jpp.eval_alpha_depth_cols(jcols, jnp.asarray(px), jnp.asarray(py), CFG),
        tpp.eval_alpha_depth_cols(tcols, to_t(px), to_t(py), tcfg(CFG)),
    ):
        assert_close(tv, jv, atol=1e-6)
    jterms = jpp.eval_pair_terms_bwd(jcols, jnp.asarray(px), jnp.asarray(py), CFG)
    tterms = tpp.eval_pair_terms_bwd(tcols, to_t(px), to_t(py), tcfg(CFG))
    assert set(jterms) == set(tterms)
    for k in jterms:
        assert_close(tterms[k], jterms[k], atol=1e-6, msg=k)
    assert jpp.effective_alpha_max(CFG) == tcfg(CFG).alpha_max


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------

BIN_CASES = {
    # TestBinning inputs
    "bruteforce": ((96, 96), 48, 3, CFG, None),
    "alignment": ((64, 64), 32, 5, CFG_SMALL_CHUNK, None),
    # entry-budget overflow (TestPrebinnedRender)
    "overflow": ((64, 64), 128, 6, jt.RasterConfig(sigma_extent=3.5, max_dup=16, entry_budget_mult=0.5, chunk=8), None),
    # production caps: max_dup 4 span truncation, K = 128, explicit budget
    "caps": ((80, 72), 160, 7, jt.RasterConfig(), None),
    "budget": ((80, 72), 160, 7, jt.RasterConfig(chunk=8), 400),
}


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_binning_matches_reference(case):
    shape, n, seed, cfg, budget = BIN_CASES[case]
    attrs = make_attrs(n, seed=seed)
    p2d, _, dz, iv = j_preprocess(attrs, make_camera(), shape, cfg)
    want = j_bin_entries(p2d, dz, iv, shape, cfg, entry_budget=budget)
    tp2d, tdz, tiv = to_t(p2d), to_t(dz), to_t(iv)
    got = tbin.bin_entries(tp2d, tdz, tiv, shape, tcfg(cfg), entry_budget=budget)
    np.testing.assert_array_equal(got.gid.numpy(), np.asarray(want.gid))
    np.testing.assert_array_equal(got.tile_start.numpy(), np.asarray(want.tile_start))
    np.testing.assert_array_equal(got.tile_len.numpy(), np.asarray(want.tile_len))
    assert int(got.num_dropped) == int(want.num_dropped)
    assert int(tbin.entry_count(tp2d, tiv, shape, tcfg(cfg))) == int(j_entry_count(p2d, iv, shape, cfg))
    for g, w in zip(tbin.candidate_tiles(tp2d, tiv, shape, tcfg(cfg)), j_candidate_tiles(p2d, iv, shape, cfg)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "caps":
        assert int(want.num_dropped) > 0  # the span cap is exercised
    if case in ("overflow", "budget"):
        assert int(got.num_dropped) > 0


def test_tile_image_layout_matches_reference():
    cfg = CFG
    shape = (40, 70)  # ragged edge tiles
    rng = np.random.default_rng(8)
    img = rng.uniform(size=shape).astype(np.float32)
    want = jr._image_to_tiles(jnp.asarray(img), shape, cfg, rows=8)
    got = tr.image_to_tiles(to_t(img), shape, tcfg(cfg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, 0])
    tiles = rng.uniform(size=(got.shape[0], 5, cfg.tile_pixels)).astype(np.float32)
    np.testing.assert_array_equal(
        tr.tiles_to_image(to_t(tiles), shape, tcfg(cfg)).numpy(), np.asarray(jr._tiles_to_image(jnp.asarray(tiles), shape, cfg))
    )


# ---------------------------------------------------------------------------
# dense oracle against the committed golden fixture
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    import os

    return np.load(os.path.join(os.path.dirname(__file__), "fixtures", "golden_render.npz"))


def _loss_weights():
    """The weights `test_render._loss_fn` draws for rgb, depth, normal and
    opacity of a 64x64 render, drawn on the JAX side."""
    rng = jax.random.split(jax.random.PRNGKey(0), 5)
    return [to_t(jax.random.normal(rng[i], (c,) + SHAPE)) for i, c in enumerate((3, 1, 3, 1))]


def _weighted_loss(out, wts):
    rgb, depth, normal, opacity = (out[k] if isinstance(out, dict) else getattr(out, k) for k in ("rgb", "depth", "normal", "opacity"))
    return (
        torch.sum(rgb * wts[0]) + torch.sum(depth * wts[1]) + 0.3 * torch.sum(normal * wts[2]) + torch.sum(opacity * wts[3])
    )


def _attr_grads(render, attrs_t, wts):
    leaves = {n: getattr(attrs_t, n).clone().requires_grad_(True) for n in GRAD_NAMES}
    out = render(dataclasses.replace(attrs_t, **leaves))
    return torch.autograd.grad(_weighted_loss(out, wts), list(leaves.values()))


def test_dense_oracle_matches_golden(golden):
    attrs, cam = t_attrs(make_attrs(96, seed=1)), t_cam(make_camera())
    cfg = tcfg(CFG)
    ref = tdense.render_dense(attrs, cam, SHAPE, cfg)
    for k in IMAGE_KEYS:
        assert_close(ref[k], golden[k], rtol=0, atol=2e-5, msg=k)
    assert_close(ref["depth"], golden["depth"], rtol=0, atol=1e-4)
    st = tdense.render_dense(attrs, cam, SHAPE, cfg, render_mask=to_t(golden["mask"]))
    assert_close(st["importance"], golden["importance"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(st["count"].numpy(), golden["count"])
    wts = _loss_weights()
    grads = _attr_grads(lambda a: tdense.render_dense(a, cam, SHAPE, cfg), attrs, wts)
    for n, g in zip(GRAD_NAMES, grads):
        assert_scaled(g, golden[f"grad_{n}"], msg=n)


# ---------------------------------------------------------------------------
# compositor: plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def opaque_wall():
    """A fronto-parallel wall of opaque surfels that covers the whole view in
    front of a random scene: every tile stops early."""
    from activegs_tpu.core import quaternions as jquat

    g = np.linspace(-0.9, 0.9, 16, dtype=np.float32)
    gx, gy = np.meshgrid(g, g)
    n = gx.size
    wall = jt.GaussianAttrs(
        means=jnp.asarray(np.stack([gx.ravel(), gy.ravel(), np.full(n, 1.0, np.float32)], 1)),
        scales=jnp.asarray(np.tile(np.float32([[0.12, 0.12, 1e-6]]), (n, 1))),
        rotations=jquat.normal_to_quaternion(jnp.asarray(np.tile(np.float32([[0.0, 0.0, -1.0]]), (n, 1))))[0],
        opacities=jnp.full((n,), 0.95),
        colors=jnp.asarray(np.random.default_rng(0).uniform(0, 1, (n, 3)).astype(np.float32)),
        confidences=jnp.full((n,), 0.5),
        valid=jnp.ones(n, bool),
    )
    back = make_attrs(96, seed=2, z_range=(1.5, 3.0))
    return jax.tree.map(lambda a, c: jnp.concatenate([a, c]), wall, back)


SCENES = {"random": lambda: make_attrs(96, seed=1), "opaque": opaque_wall}


def _entries(scene, cfg):
    attrs = SCENES[scene]()
    entries, b, _, _, _ = j_prepare_entries(attrs, make_camera(), SHAPE, cfg, False)
    num_tiles, ntx = jr._kernel_static(SHAPE, cfg)
    return entries, b, num_tiles, ntx


@pytest.mark.parametrize("cfg_id", list(CFGS))
@pytest.mark.parametrize("scene", list(SCENES))
def test_composite_plain_matches_pallas(scene, cfg_id):
    cfg = CFGS[cfg_id]
    entries, b, num_tiles, ntx = _entries(scene, cfg)
    static = (num_tiles, ntx, cfg)
    gout = np.random.default_rng(3).normal(size=(num_tiles, tt.OUT_ROWS, cfg.tile_pixels)).astype(np.float32)
    gout[:, tt.O_TRANS + 1 :] = 0.0
    out_j, dent_j = j_composite_vjp(entries, b.tile_start, b.tile_len, static, jnp.asarray(gout))
    ent, ts, tl = to_t(entries), to_t(b.tile_start), to_t(b.tile_len)
    out_t = tcp.composite_fwd(ent, ts, tl, ntx, tcfg(cfg))
    assert out_t.shape == out_j.shape
    out_j = np.asarray(out_j)
    rows = [r for r in range(tt.O_TRANS + 1) if r != tt.O_DEPTH]
    assert_close(out_t[:, rows], out_j[:, rows], rtol=0, atol=2e-5)
    assert_close(out_t[:, tt.O_DEPTH], out_j[:, tt.O_DEPTH], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out_t[:, tt.O_STOP:].numpy(), out_j[:, tt.O_STOP:])
    if scene == "opaque":  # the tile-wide early stop cuts some tiles short
        nch = -(-np.asarray(b.tile_len) // cfg.chunk)
        assert (out_j[:, tt.O_STOP, 0] < nch).any()

    dent_t = tcp.composite_bwd(ent, ts, tl, out_t, to_t(gout), ntx, tcfg(cfg))
    dent_j = np.asarray(dent_j)
    for r in range(tt.USED_ROWS):
        assert_scaled(dent_t[r], dent_j[r], msg=f"entry grad row {r}")
    assert not dent_t[tt.USED_ROWS :].any()

    mask = (np.random.default_rng(4).uniform(size=SHAPE) > 0.3).astype(np.float32)
    mask_j = jr._image_to_tiles(jnp.asarray(mask), SHAPE, cfg, rows=8)
    imp_j, cnt_j = j_composite_stats(entries, b.tile_start, b.tile_len, mask_j, num_tiles, ntx, cfg, 0.03)
    imp_t, cnt_t = tcp.composite_stats(ent, ts, tl, tr.image_to_tiles(to_t(mask), SHAPE, tcfg(cfg)), 0.03, ntx, tcfg(cfg))
    # the reference leaves the budget's tail past the last segment unwritten
    seg = np.zeros(entries.shape[1], bool)
    for s0, n in zip(np.asarray(b.tile_start), np.asarray(b.tile_len)):
        seg[s0 : s0 + -(-n // cfg.chunk) * cfg.chunk] = True
    imp_j = np.asarray(imp_j)[:, seg]
    assert_close(imp_t[:, seg], imp_j, rtol=0, atol=1e-5 * np.abs(imp_j).max())
    np.testing.assert_array_equal(cnt_t[:, seg].numpy(), np.asarray(cnt_j)[:, seg])
    assert not imp_t[:, ~seg].any() and not cnt_t[:, ~seg].any()


def test_wrappers_refuse_cpu_tensors_for_kernels():
    e = torch.zeros((tt.PARAM_DIM, 128))
    t = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tcp._check(e, t, t, tt.RasterConfig())


# ---------------------------------------------------------------------------
# renderer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def view_refs():
    """Reference render_view outputs and attribute grads per config."""
    attrs, cam = make_attrs(96, seed=1), make_camera()
    key = jax.random.PRNGKey(0)
    out = {}
    for cid, cfg in CFGS.items():
        o, aux = j_render_view(attrs, cam, SHAPE, cfg)

        def loss(*leaves, cfg=cfg):
            a = dataclasses.replace(attrs, **dict(zip(GRAD_NAMES, leaves)))
            return _loss_fn(lambda a_: jr.render_view(a_, cam, SHAPE, cfg), a, key)

        grads = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(*[getattr(attrs, n) for n in GRAD_NAMES])
        out[cid] = (o, int(aux["num_dropped"]), grads)
    return attrs, cam, out


@pytest.mark.parametrize("cfg_id", list(CFGS))
def test_render_view_matches_reference(view_refs, cfg_id):
    attrs, cam, refs = view_refs
    o_j, dropped_j, _ = refs[cfg_id]
    o_t, aux = tr.render_view(t_attrs(attrs), t_cam(cam), SHAPE, tcfg(CFGS[cfg_id]))
    assert_images(o_t, o_j)
    assert int(aux["num_dropped"]) == dropped_j


@pytest.mark.parametrize("cfg_id", list(CFGS))
def test_render_view_grads_match_reference(view_refs, cfg_id):
    attrs, cam, refs = view_refs
    wts = _loss_weights()
    tc = t_cam(cam)
    grads = _attr_grads(lambda a: tr.render_view(a, tc, SHAPE, tcfg(CFGS[cfg_id]))[0], t_attrs(attrs), wts)
    for n, g, w in zip(GRAD_NAMES, grads, refs[cfg_id][2]):
        assert_scaled(g, w, msg=n)


def test_render_view_background_front_only_and_frozen_bins():
    attrs, cam = make_attrs(96, seed=4), tilted_camera()
    bg = np.asarray([0.2, 0.5, 0.1], np.float32)
    o_j, _ = j_render_view(attrs, cam, SHAPE, CFG, front_only=True, background=jnp.asarray(bg))
    ta, tc, cfg = t_attrs(attrs), t_cam(cam), tcfg(CFG)
    o_t, _ = tr.render_view(ta, tc, SHAPE, cfg, front_only=True, background=to_t(bg))
    assert_images(o_t, o_j)
    # frozen bins reproduce a fresh render exactly
    bins = tr.prepare_view_bins(ta, tc, SHAPE, cfg)
    fresh, _ = tr.render_view(ta, tc, SHAPE, cfg)
    frozen, _ = tr.render_view(ta, tc, SHAPE, cfg, bin_result=bins)
    assert torch.equal(fresh.rgb, frozen.rgb) and torch.equal(fresh.depth, frozen.depth)


@pytest.mark.parametrize("variant", ["full", "subset"])
def test_render_stats_matches_reference(variant):
    attrs, cam = make_attrs(96, seed=1), tilted_camera()
    mask = (np.random.default_rng(5).uniform(size=SHAPE) > 0.3).astype(np.float32)
    kw = dict(subset_bucket=64, entry_budget=2048) if variant == "subset" else {}
    imp_j, cnt_j = j_render_stats(attrs, cam, SHAPE, CFG_SMALL_CHUNK, render_mask=jnp.asarray(mask), **kw)
    imp_t, cnt_t = tr.render_stats(
        t_attrs(attrs), t_cam(cam), SHAPE, tcfg(CFG_SMALL_CHUNK), render_mask=to_t(mask), **kw
    )
    assert cnt_t.dtype == torch.int32
    imp_j = np.asarray(imp_j)
    assert_close(imp_t, imp_j, rtol=0, atol=1e-5 * np.abs(imp_j).max())
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert (np.asarray(cnt_j) > 0).sum() > 10


def test_compact_subset_and_pack_match_reference():
    attrs = make_attrs(100, seed=9)
    iv = np.random.default_rng(0).uniform(size=100) > 0.6
    for bucket in (64, 32):  # roomy, and too small for every in-view gaussian
        want = jr.compact_in_view(jnp.asarray(iv), bucket)
        got = tr.compact_in_view(to_t(iv), bucket)
        sel_j, selv_j, inv_j, n_j = (np.asarray(x) for x in want)
        selv = got[1].numpy()
        np.testing.assert_array_equal(selv, selv_j)
        np.testing.assert_array_equal(got[0].numpy()[selv], sel_j[selv_j])
        np.testing.assert_array_equal(got[2].numpy(), inv_j)
        assert int(got[3]) == int(n_j)
    packed_j = jr.pack_attrs(attrs)
    packed_t = tr.pack_attrs(t_attrs(attrs))
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    sub_j = jr.subset_view(packed_j, want[:3])
    sub_t = tr.subset_view(packed_t, got[:3])
    for f in dataclasses.fields(tt.GaussianAttrs):
        np.testing.assert_array_equal(getattr(sub_t, f.name).numpy(), np.asarray(getattr(sub_j, f.name)), err_msg=f.name)
