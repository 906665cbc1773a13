"""Tile shapes other than the default 16x32, the port against the reference.

The reference takes any `RasterConfig.tile_h` x `tile_w`; its former
default was 32x32 and its `scripts/tile_scan.py` scans 32x32, 16x32, 16x16
and 8x16. The port's kernels take tiles of up to 1024 pixels, a multiple
of 32 (`composite._check`). Here, on the CPU, at 32x32, 16x16 and 8x16 on
the reference's 64x64 scenes, with the reference's Pallas kernels in
interpret mode:

- the plain fwd, bwd and stats against the reference's `composite_tiled`
  and `composite_stats` (images 2e-5, depth 1e-4, entry gradients 3e-4
  after scaling, the chunks done equal, importance 1e-5 of its largest,
  counts equal);
- `render_view` (images, `num_dropped`, attribute gradients 3e-4 scaled);
- one `train_keyframe` step from the same state and drawn ids (the loss
  1e-5 relative, the sampler's errors, the truncation telemetry).

The kernels at these tiles run only on a card (`tests/test_torch_gpu.py`,
`chip_smoke.py` path 8); the lane-by-lane emulations of their culls at
32x32 and 8x16 are in `test_torch_{fwd,bwd,stats}_cull.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activegs_torch.mapping import trainer as ttr
from activegs_torch.render import composite as tcp
from activegs_torch.render import renderer as tr
from activegs_torch.render import types as tt
from activegs_tpu.mapping import trainer as jtr
from activegs_tpu.render import renderer as jr
from test_render import CFG, _loss_fn, make_attrs, make_camera
from test_torch_core import assert_close, assert_scaled, t_attrs, t_cam, t_like, to_t
from test_torch_mapping import MAPCFG, RASTER, T_MAPCFG, frames, mapped, ref_batch_ids, t_buffer, t_state  # noqa: F401
from test_torch_render import (
    GRAD_NAMES,
    SHAPE,
    _attr_grads,
    _loss_weights,
    assert_images,
    j_composite_stats,
    j_composite_vjp,
    j_prepare_entries,
    j_render_view,
    opaque_wall,
)

torch.set_num_threads(2)

TILES = {"32x32": (32, 32), "16x16": (16, 16), "8x16": (8, 16)}
# the compositor's chunk at each tile: at 16x16 and 8x16 a tile of these
# scenes holds fewer than 128 entries, so K = 8 gives the tile-wide stop
# chunks to cut
CHUNK = {"32x32": 128, "16x16": 8, "8x16": 8}


def tiled(cfg, tile: str):
    th, tw = TILES[tile]
    return dataclasses.replace(cfg, tile_h=th, tile_w=tw)


@pytest.mark.parametrize("tile", list(TILES))
def test_composite_plain_matches_pallas(tile):
    """The opaque wall over a random scene (tiles that stop early, others
    that run on): fwd, bwd and stats against the reference's kernels."""
    cfg = dataclasses.replace(tiled(CFG, tile), chunk=CHUNK[tile])
    tc = t_like(tt.RasterConfig, cfg)
    entries, b, _, _, _ = j_prepare_entries(opaque_wall(), make_camera(), SHAPE, cfg, False)
    num_tiles, ntx = jr._kernel_static(SHAPE, cfg)
    assert num_tiles == (SHAPE[0] // cfg.tile_h) * (SHAPE[1] // cfg.tile_w)
    gout = np.random.default_rng(3).normal(size=(num_tiles, tt.OUT_ROWS, cfg.tile_pixels)).astype(np.float32)
    gout[:, tt.O_TRANS + 1 :] = 0.0
    out_j, dent_j = j_composite_vjp(entries, b.tile_start, b.tile_len, (num_tiles, ntx, cfg), jnp.asarray(gout))
    ent, ts, tl = to_t(entries), to_t(b.tile_start), to_t(b.tile_len)
    out_t = tcp.composite_fwd(ent, ts, tl, ntx, tc)
    out_j = np.asarray(out_j)
    assert out_t.shape == out_j.shape == (num_tiles, tt.OUT_ROWS, cfg.tile_pixels)
    rows = [r for r in range(tt.O_TRANS + 1) if r != tt.O_DEPTH]
    assert_close(out_t[:, rows], out_j[:, rows], rtol=0, atol=2e-5)
    assert_close(out_t[:, tt.O_DEPTH], out_j[:, tt.O_DEPTH], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out_t[:, tt.O_STOP :].numpy(), out_j[:, tt.O_STOP :])
    nch = -(-np.asarray(b.tile_len) // cfg.chunk)
    assert (out_j[:, tt.O_STOP, 0] < nch).any()  # the tile-wide stop cuts some tiles short

    dent_t = tcp.composite_bwd(ent, ts, tl, out_t, to_t(gout), ntx, tc)
    dent_j = np.asarray(dent_j)
    for r in range(tt.USED_ROWS):
        assert_scaled(dent_t[r], dent_j[r], msg=f"entry grad row {r}")
    assert not dent_t[tt.USED_ROWS :].any()

    mask = (np.random.default_rng(4).uniform(size=SHAPE) > 0.3).astype(np.float32)
    mask_j = jr._image_to_tiles(jnp.asarray(mask), SHAPE, cfg, rows=8)
    imp_j, cnt_j = j_composite_stats(entries, b.tile_start, b.tile_len, mask_j, num_tiles, ntx, cfg, 0.03)
    imp_t, cnt_t = tcp.composite_stats(ent, ts, tl, tr.image_to_tiles(to_t(mask), SHAPE, tc), 0.03, ntx, tc)
    # the reference leaves the budget's tail past the last segment unwritten
    seg = np.zeros(entries.shape[1], bool)
    for s0, n in zip(np.asarray(b.tile_start), np.asarray(b.tile_len)):
        seg[s0 : s0 + -(-n // cfg.chunk) * cfg.chunk] = True
    imp_j = np.asarray(imp_j)[:, seg]
    assert_close(imp_t[:, seg], imp_j, rtol=0, atol=1e-5 * np.abs(imp_j).max())
    np.testing.assert_array_equal(cnt_t[:, seg].numpy(), np.asarray(cnt_j)[:, seg])
    assert (np.asarray(cnt_j)[:, seg] > 0).sum() > 10


@pytest.mark.parametrize("tile", list(TILES))
def test_render_view_matches_reference(tile):
    cfg = tiled(CFG, tile)
    attrs, cam = make_attrs(96, seed=1), make_camera()
    o_j, aux_j = j_render_view(attrs, cam, SHAPE, cfg)
    tc = t_like(tt.RasterConfig, cfg)
    o_t, aux_t = tr.render_view(t_attrs(attrs), t_cam(cam), SHAPE, tc)
    assert_images(o_t, o_j)
    assert int(aux_t["num_dropped"]) == int(aux_j["num_dropped"])

    def loss(*leaves):
        a = dataclasses.replace(attrs, **dict(zip(GRAD_NAMES, leaves)))
        return _loss_fn(lambda a_: jr.render_view(a_, cam, SHAPE, cfg), a, jax.random.PRNGKey(0))

    want = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(*[getattr(attrs, n) for n in GRAD_NAMES])
    tcam = t_cam(cam)
    got = _attr_grads(lambda a: tr.render_view(a, tcam, SHAPE, tc)[0], t_attrs(attrs), _loss_weights())
    for n, g, w in zip(GRAD_NAMES, got, want):
        assert_scaled(g, w, msg=n)


@pytest.mark.parametrize("tile", list(TILES))
def test_train_keyframe_step_matches_reference(mapped, tile):  # noqa: F811
    """One Adam step from the same state and ids at the tile: the loss,
    the sampler's errors and the truncation telemetry (none dropped)."""
    state, buf = mapped
    raster = tiled(RASTER, tile)
    key = jax.random.PRNGKey(9)
    ids = ref_batch_ids(buf, key)
    _, want_b, want_l, want_aux = jtr.train_keyframe(state, buf, key, MAPCFG, raster, steps=1)
    views = ttr.batch_views(to_t(ids).long())
    got_s, got_b, got_l, got_aux = ttr.train_keyframe(
        t_state(state), t_buffer(buf), views, T_MAPCFG, t_like(tt.RasterConfig, raster), steps=1
    )
    assert_close(got_l, want_l, rtol=1e-5, atol=0)
    assert_close(got_b.performance, want_b.performance, rtol=1e-5, atol=1e-7)
    for k in ("num_dropped", "num_entries"):
        assert int(got_aux[k]) == int(want_aux[k]), k
    assert int(got_aux["num_entries"]) > 0
    assert float((got_s.means - t_state(state).means).abs().max()) > 0
