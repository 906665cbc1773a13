"""bf16 pair math (`RasterConfig.bf16_pairs`) of the port against the
reference, on the CPU (the compositor's plain versions).

The rounding contract (`activegs_torch/render/composite.py`) keeps every
point where the reference rounds to bfloat16, and forms the in-chunk
exclusive product as a float32 running product rounded once where used,
where the reference's kernels use a bf16 Hillis-Steele doubling scan.

The reference runs here in Pallas interpret mode under XLA, which by
default keeps the bf16 intermediates of a fused expression in float32
(`xla_allow_excess_precision`): its interpret-mode bf16 is then partly
float32. `strict` compiles it with that off, so that every bf16 operation
rounds, as its kernels do on the TPU. Against that:

(a) with the reference's own doubling scan put in place of the port's
    running product, the port's plain fwd, bwd and stats meet the
    reference's float32 tolerances (images 2e-5, depth 1e-4, gradients
    3e-4 scaled, importance 1e-5): every other rounding point is the
    reference's. With the port's running product they differ by what the
    two groupings give: on these scenes each chunk's excl is within one
    bf16 rounding (2^-8 relative) of the exact product in the port, and
    up to about 1% in the scan (`test_pair_terms_bitwise_and_excl_...`),
    so the two weights of a pair differ by at most EPS = 1.5e-2 relative
    (1% + 2^-8, rounded up): images within EPS, depth within EPS times the
    largest depth, importance within EPS of its largest, the reference's
    counts between the port's at the threshold moved by EPS either way,
    and gradients within 3e-2 scaled, the bound of the reference's own
    bf16 gate;
(b) the port passes the reference's three `TestBf16` gates
    (`tests/test_render.py:690-819`) against its own float32 path;
(c) `effective_alpha_max` and the backward `active` mask at the bf16
    clamp.
The invariant the kernels' culls rest on (a pair with bf16 alpha 0 adds
exactly nothing) is held by the `bf16` cases of `test_torch_fwd_cull.py`
and `test_torch_bwd_cull.py`.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activegs_torch.mapping import gaussians as tgm
from activegs_torch.mapping import keyframes as tkf
from activegs_torch.mapping import trainer as ttr
from activegs_torch.render import composite as tcp
from activegs_torch.render import dense as tdense
from activegs_torch.render import preprocess as tpp
from activegs_torch.render import renderer as tr
from activegs_torch.render import types as tt
from activegs_tpu.render import composite_pallas as jcp
from activegs_tpu.render import preprocess as jpp
from activegs_tpu.render import renderer as jr
from test_render import CFG, CFG_SMALL_CHUNK, make_attrs, make_camera
from test_torch_core import assert_close, assert_scaled, t_attrs, t_cam, to_t
from test_torch_render import SCENES, SHAPE, _attr_grads, _loss_weights, j_prepare_entries, tcfg

torch.set_num_threads(2)

B16 = {"k128": dataclasses.replace(CFG, bf16_pairs=True), "k8": dataclasses.replace(CFG_SMALL_CHUNK, bf16_pairs=True)}


def strict(fn, *args):
    """`fn(*args)` compiled with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)


def scan_excl_total(alpha, k: int):
    """`composite._excl_total` with the reference's grouping: the bf16
    doubling scan over the chunk's K entries (`composite_pallas.py:58-67,
    104-116`; the pad entries past the tile's last real one are 1 - 0)."""
    one_m = 1.0 - alpha
    n = one_m.shape[1]
    x = torch.cat([one_m, torch.ones_like(one_m[:, :1]).expand(-1, k - n, -1)], dim=1)
    s = 1
    while s < k:
        x = x * torch.cat([torch.ones_like(x[:, :s]), x[:, :-s]], dim=1)
        s *= 2
    excl = torch.cat([torch.ones_like(x[:, :1]), x[:, :-1]], dim=1)[:, :n]
    return one_m, excl, x[:, -1:].float()


@functools.lru_cache(maxsize=None)
def reference(scene: str, cfg_id: str):
    """The scene's entries and the reference's strict bf16 fwd output,
    entry cotangent and stats, with the inputs that gave them."""
    cfg = B16[cfg_id]
    entries, b, _, _, _ = j_prepare_entries(SCENES[scene](), make_camera(), SHAPE, cfg, False)
    num_tiles, ntx = jr._kernel_static(SHAPE, cfg)
    gout = np.random.default_rng(3).normal(size=(num_tiles, tt.OUT_ROWS, cfg.tile_pixels)).astype(np.float32)
    gout[:, tt.O_TRANS + 1 :] = 0.0
    mask = (np.random.default_rng(4).uniform(size=SHAPE) > 0.3).astype(np.float32)
    mask_j = jr._image_to_tiles(jnp.asarray(mask), SHAPE, cfg, rows=8)

    def run(e, ts, tl, g, m):
        out, vjp = jax.vjp(lambda e: jcp.composite_tiled(e, ts, tl, (num_tiles, ntx, cfg)), e)
        imp, cnt = jcp.composite_stats(e, ts, tl, m, num_tiles, ntx, cfg, 0.03)
        return out, vjp(g)[0], imp, cnt

    ref = strict(run, entries, b.tile_start, b.tile_len, jnp.asarray(gout), mask_j)
    # the reference writes no segment past the last tile's
    seg = np.zeros(entries.shape[1], bool)
    for s0, n in zip(np.asarray(b.tile_start), np.asarray(b.tile_len)):
        seg[s0 : s0 + -(-n // cfg.chunk) * cfg.chunk] = True
    return (entries, b, ntx, gout, mask), tuple(np.asarray(x) for x in ref), seg


EPS = 1.5e-2
# grouping -> (images, depth relative to the largest (None: 1e-4
# absolute), scaled gradients, importance relative to its max, relative
# band of the count threshold)
TOLERANCES = {"scan": (2e-5, None, 3e-4, 1e-5, 1e-5), "running": (EPS, EPS, 3e-2, EPS, EPS)}


@pytest.mark.parametrize("grouping", list(TOLERANCES))
@pytest.mark.parametrize("cfg_id", list(B16))
@pytest.mark.parametrize("scene", list(SCENES))
def test_plain_bf16_matches_pallas(scene, cfg_id, grouping):
    (entries, b, ntx, gout, mask), (out_j, dent_j, imp_j, cnt_j), seg = reference(scene, cfg_id)
    cfg = tcfg(B16[cfg_id])
    ent, ts, tl = to_t(entries), to_t(b.tile_start), to_t(b.tile_len)
    t_img, t_dep, t_grad, t_imp, band = TOLERANCES[grouping]
    excl = functools.partial(scan_excl_total, k=cfg.chunk) if grouping == "scan" else tcp._excl_total
    with mock.patch.object(tcp, "_excl_total", excl):
        out_t = tcp.composite_fwd(ent, ts, tl, ntx, cfg)
        dent_t = tcp.composite_bwd(ent, ts, tl, out_t, to_t(gout), ntx, cfg)
        mask_t = tr.image_to_tiles(to_t(mask), SHAPE, cfg)
        imp_t, _ = tcp.composite_stats(ent, ts, tl, mask_t, 0.03, ntx, cfg)
        c_lo, c_hi = (tcp.composite_stats(ent, ts, tl, mask_t, 0.03 * (1 + d), ntx, cfg)[1] for d in (band, -band))
    rows = [r for r in range(tt.O_TRANS + 1) if r != tt.O_DEPTH]
    assert_close(out_t[:, rows], out_j[:, rows], rtol=0, atol=t_img)
    t_dep = 1e-4 if t_dep is None else t_dep * float(np.abs(out_j[:, tt.O_DEPTH]).max())
    assert_close(out_t[:, tt.O_DEPTH], out_j[:, tt.O_DEPTH], rtol=0, atol=t_dep)
    np.testing.assert_array_equal(out_t[:, tt.O_STOP :].numpy(), out_j[:, tt.O_STOP :])
    for r in range(tt.USED_ROWS):
        assert_scaled(dent_t[r, seg], dent_j[r, seg], atol=t_grad, msg=f"entry grad row {r}")
    imp_j, cnt_j = imp_j[:, seg], cnt_j[:, seg]
    assert_close(imp_t[:, seg], imp_j, rtol=0, atol=t_imp * np.abs(imp_j).max())
    assert bool(((c_lo[:, seg].numpy() <= cnt_j) & (cnt_j <= c_hi[:, seg].numpy())).all())


def test_pair_terms_bitwise_and_excl_stays_inside_the_scans_envelope():
    """On every chunk of the opaque scene at K = 128: the bf16 alpha, exp,
    dx and dy of `eval_pair_terms_bwd` equal the reference's bitwise
    (strict); the port's excl (float32 running product, rounded once) lies
    within one bf16 rounding, 2^-8 relative, of the exact product of the
    chunk's bf16 1 - alpha, and never further from it than the reference's
    doubling scan."""
    cfg_j = B16["k128"]
    cfg = tcfg(cfg_j)
    (entries, b, ntx, _, _), _, _ = reference("opaque", "k128")
    k, ent = cfg.chunk, np.asarray(entries)
    starts = [s + c * k for s, n in zip(np.asarray(b.tile_start), np.asarray(b.tile_len)) for c in range(-(-n // k))]
    tiles = [t for t, n in enumerate(np.asarray(b.tile_len)) for _ in range(-(-n // k))]
    px, py = tcp.tile_pixel_coords(len(b.tile_start), ntx, cfg, "cpu")
    chunks = np.stack([ent[:, s : s + k] for s in starts])  # (C, PARAM_DIM, K)
    pxc, pyc = px[tiles][:, 0].numpy(), py[tiles][:, 0].numpy()  # (C, P)

    def ref_terms(e, x, y):
        def one(e, x, y):
            t = jpp.eval_pair_terms_bwd(jpp.entry_cols(e.T), x[None], y[None], cfg_j)
            excl, _ = jcp._excl_cumprod_total(1.0 - t["alpha"], k)
            return [t[n].astype(jnp.float32) for n in ("alpha", "ex", "dx", "dy")] + [excl.astype(jnp.float32)]

        return jax.vmap(one)(e, x, y)

    want = [np.asarray(x) for x in strict(ref_terms, jnp.asarray(chunks), jnp.asarray(pxc), jnp.asarray(pyc))]
    cols = tpp.entry_cols(torch.from_numpy(chunks[:, : tt.USED_ROWS]).transpose(1, 2))
    got = tpp.eval_pair_terms_bwd(cols, torch.from_numpy(pxc)[:, None], torch.from_numpy(pyc)[:, None], cfg)
    # the port floors the power at -80 (`preprocess.POWER_FLOOR`), where
    # alpha is 0 either way
    floor = float(torch.exp(torch.tensor(tpp.POWER_FLOOR)).to(torch.bfloat16))
    want[1] = np.maximum(want[1], floor)
    for i, n in enumerate(("alpha", "ex", "dx", "dy")):
        assert got[n].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[n].float().numpy(), want[i], err_msg=n)
    one_m, excl, _ = tcp._excl_total(got["alpha"])
    om = one_m.float().numpy().astype(np.float64)
    exact = np.cumprod(np.concatenate([np.ones_like(om[:, :1]), om[:, :-1]], 1), 1)
    live = exact > 1e-30
    err_port = np.abs(excl.float().numpy() - exact)[live] / exact[live]
    err_scan = np.abs(want[4] - exact)[live] / exact[live]
    assert err_port.max() <= 2.0**-8 * (1 + 1e-5)
    assert err_port.max() <= err_scan.max() and err_scan.max() > 2.0**-8


# ---------------------------------------------------------------------------
# (b) the reference's TestBf16 gates, applied to the port
# ---------------------------------------------------------------------------


def test_forward_tracks_f32_oracle():
    attrs, cam = t_attrs(make_attrs(96, seed=1)), t_cam(make_camera())
    ref = tdense.render_dense(attrs, cam, SHAPE, tcfg(CFG))
    out, _ = tr.render_view(attrs, cam, SHAPE, tcfg(B16["k128"]))
    assert_close(out.rgb, ref["rgb"].numpy(), rtol=0, atol=3e-2)
    assert_close(out.opacity, ref["opacity"].numpy(), rtol=0, atol=3e-2)
    mask = ref["opacity"][0] > 0.3
    assert float((out.depth - ref["depth"])[0][mask].abs().max()) < 5e-2


def test_grads_track_f32():
    attrs, cam = t_attrs(make_attrs(48, seed=7)), t_cam(make_camera())
    wts = _loss_weights()

    def grad_means(cfg):
        return _attr_grads(lambda a: tr.render_view(a, cam, SHAPE, tcfg(cfg))[0], attrs, wts)[0].numpy()

    g16, g32 = grad_means(B16["k128"]), grad_means(CFG)
    err = np.abs(g16 - g32) / (np.abs(g32).max() + 1e-8)
    assert np.quantile(err, 0.98) < 3e-2
    assert err.max() < 0.25
    cos = np.sum(g16 * g32) / (np.linalg.norm(g16) * np.linalg.norm(g32) + 1e-12)
    assert cos > 0.995


def test_training_converges_like_f32():
    """PSNR after 12 Adam steps on the reference's setup (48 target surfels
    at 32x32, perturbed init) within 0.5 dB of the float32 run. Both runs
    start from the same perturbed state and draw the same batch."""
    res = 32
    cfg = tgm.MapConfig(capacity=128, batch_size=2, optimization_steps=12, active_size=2)
    target = t_attrs(make_attrs(48, seed=11, z_range=(1.5, 2.5)))
    cam = t_cam(make_camera())
    ref = tdense.render_dense(target, cam, (res, res), tcfg(CFG))
    jitter = torch.from_numpy(np.random.default_rng(3).normal(0, 0.01, (48, 3)).astype(np.float32))

    def run(raster_cfg):
        s = tgm.init_state(cfg, "cpu")
        put = lambda x, v: torch.cat([v, x[48:]])  # noqa: E731
        state = dataclasses.replace(
            s,
            means=put(s.means, target.means + jitter),
            rotations_raw=put(s.rotations_raw, target.rotations),
            scales_raw=put(s.scales_raw, torch.log(torch.clamp(target.scales / cfg.scale_factor, min=1e-8))),
            opacities_raw=put(s.opacities_raw, torch.full((48,), 2.0)),
            colors=put(s.colors, torch.clamp(target.colors + 0.1, 0, 1)),
            count=48,
        )
        buf = tkf.init_buffer(4, res, res, "cpu")
        frame = {"rgb": ref["rgb"], "depth": ref["depth"], "extrinsic": cam.extrinsic, "intrinsic": cam.intrinsic,
                 "depth_range": torch.tensor([0.0, 5.0])}
        buf = tkf.add_frame(tkf.add_frame(buf, frame), frame)
        views = ttr.draw_batch(buf, cfg, torch.Generator().manual_seed(0), sampler="uniform")
        state, _, loss, _ = ttr.train_keyframe(state, buf, views, cfg, tcfg(raster_cfg))
        assert np.isfinite(float(loss))
        out, _ = tr.render_view(tgm.attrs_of(state, cfg), cam, (res, res), tcfg(CFG))
        return -10.0 * np.log10(float(torch.mean((out.rgb - ref["rgb"]) ** 2)) + 1e-10)

    psnr32, psnr16 = run(CFG), run(B16["k128"])
    assert psnr16 > psnr32 - 0.5, (psnr16, psnr32)


# ---------------------------------------------------------------------------
# (c) the clamp
# ---------------------------------------------------------------------------


def test_effective_alpha_max():
    assert tpp.effective_alpha_max(tt.RasterConfig()) == 0.99
    assert tpp.effective_alpha_max(tt.RasterConfig(bf16_pairs=True)) == 0.98828125
    for a in (0.99, 0.5, 0.9, 1.0):
        want = jpp.effective_alpha_max(dataclasses.replace(B16["k8"], alpha_max=a))
        assert tpp.effective_alpha_max(tt.RasterConfig(alpha_max=a, bf16_pairs=True)) == want


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_backward_mask_at_the_clamp(bf16):
    """One 16x32 tile, K = 8: flat surfels (zero conic: exp(power) = 1 at
    every pixel) of opacity at the clamp, just above it and just below it.
    Alpha saturates at the clamp in the pair dtype (0.98828125 in bf16),
    where dalpha is masked: the opacity and conic gradients of those
    entries are exactly 0 while their colour gradients are not; the entry
    below the clamp keeps them."""
    cfg = tt.RasterConfig(chunk=8, bf16_pairs=bf16)
    top = tpp.effective_alpha_max(cfg)
    below = 0.984375 if bf16 else 0.98  # the next bf16 value under the clamp; in f32 one under 0.99
    ops = [1.0, top, below, 0.5, 0.0, 0.0, 0.0, 0.0]  # the back entry 0.5, then pad rows
    e = torch.zeros((tt.PARAM_DIM, 8))
    for j, op in enumerate(ops[:4]):
        e[tt.P_MEAN_X, j], e[tt.P_MEAN_Y, j] = 16.0, 8.0
        e[tt.P_OPACITY, j] = op
        e[tt.P_COLOR_R : tt.P_COLOR_B + 1, j] = torch.tensor([0.2, 0.5, 0.8]) * (j + 1) / 4
        e[tt.P_PLANE_C, j], e[tt.P_PLANE_D, j], e[tt.P_DEPTH_Z, j] = 1.0, 1.0 + j, 1.0 + j
    ts, tl = torch.zeros(1, dtype=torch.int32), torch.full((1,), 4, dtype=torch.int32)
    # one entry at a time in front, so that each sees T = 1
    for j in range(3):
        ent = e.clone()
        ent[:, :3] = 0.0
        ent[:, 0] = e[:, j]
        ent[:, 1] = e[:, 3]
        out = tcp.composite_fwd(ent, ts, tl, 1, cfg)
        alpha, _ = tpp.eval_alpha_depth_cols(tpp.entry_cols(ent[: tt.USED_ROWS, :1].T[None]), *[
            c[:1] for c in tcp.tile_pixel_coords(1, 1, cfg, "cpu")], cfg)
        g = torch.from_numpy(np.random.default_rng(j).normal(size=out.shape).astype(np.float32))
        g[:, tt.O_TRANS + 1 :] = 0.0
        d = tcp.composite_bwd(ent, ts, tl, out, g, 1, cfg)
        masked = [float(d[r, 0]) for r in (tt.P_OPACITY, tt.P_CONIC_A, tt.P_CONIC_C)]
        if ops[j] >= top:
            assert bool((alpha.float() == top).all())
            assert masked == [0.0, 0.0, 0.0]
        else:
            assert bool((alpha.float() < top).all())
            assert 0.0 not in masked
        assert bool((d[tt.P_COLOR_R : tt.P_COLOR_B + 1, 0] != 0.0).all())
