"""Parity of the port's multi-view compositor path with the JAX reference.

Several views composite through one launch when their tile tables and
entry streams are concatenated and the compositor is told the tiles per
view (`tpv`): tile t is tile t % tpv of its view's grid. This file holds,
on the reference's 64x64 scenes on the CPU (the port's compositor wrappers
run their plain versions there, the reference's Pallas kernels run in
interpret mode):

- the plain forward and backward versions with `tpv` against the
  reference's `composite_tiled` with a 4-tuple static, on 3 views of
  unequal tiles;
- `render_views_batched` against the reference's, images and parameter
  gradients, and its refusal of unequal entry budgets;
- a keyframe trained with `MapConfig.fused_view_kernel` against the
  reference's, and the warning where the option is not honored;
- a plan step's batched candidate utilities against the per-candidate ones
  and the reference's;
- `tpv == T` leaving the plain versions bitwise as they were.

Tolerances are the reference's: images 2e-5, depth 1e-4, gradients 3e-4
after scaling, the chunks done equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activegs_torch.mapping import gaussians as tgm
from activegs_torch.mapping import keyframes as tkf
from activegs_torch.mapping import trainer as ttr
from activegs_torch.planning import confidence as tcf
from activegs_torch.render import composite as tcp
from activegs_torch.render import renderer as tr
from activegs_torch.render import types as tt
from activegs_tpu.mapping import trainer as jtr
from activegs_tpu.planning import confidence as jcf
from activegs_tpu.render import composite_pallas as jcp
from activegs_tpu.render import renderer as jr
from activegs_tpu.render import types as jt
from test_render import CFG, make_attrs, make_camera
from test_torch_core import assert_close, assert_scaled, t_attrs, t_cam, t_like, to_t
import test_torch_planning as tpl
from test_torch_mapping import T_MAPCFG, T_RASTER, frames, mapped, t_buffer, t_state  # noqa: F401
from test_torch_planning import t_grid, t_vstate, world  # noqa: F401
from test_torch_render import CFGS, SHAPE, IMAGE_KEYS, GRAD_NAMES, opaque_wall, tilted_camera

torch.set_num_threads(2)


def other_camera():
    from test_mapping import look_at_pose

    return jt.Camera(extrinsic=jnp.asarray(look_at_pose((0.3, 0.2, -0.4), (-0.1, 0.0, 2.0))),
                     intrinsic=make_camera().intrinsic)


# three views of unequal tiles: a random scene, an opaque wall that stops
# tiles early, and a random scene seen from a tilted camera
VIEWS = [
    (lambda: make_attrs(96, seed=1), make_camera),
    (opaque_wall, make_camera),
    (lambda: make_attrs(96, seed=4), tilted_camera),
]
# render_views_batched needs one entry budget: views of as many gaussians
BATCH_VIEWS = [
    (lambda: make_attrs(96, seed=1), make_camera),
    (lambda: make_attrs(96, seed=4), tilted_camera),
    (lambda: make_attrs(96, seed=6, z_range=(0.8, 2.0)), other_camera),
]

j_prepare_entries = jax.jit(jr._prepare_entries, static_argnums=(2, 3, 4, 6))


@functools.partial(jax.jit, static_argnums=(3,))
def j_composite_vjp(entries, tile_start, tile_len, static, gout):
    out, vjp = jax.vjp(lambda e: jcp.composite_tiled(e, tile_start, tile_len, static), entries)
    return out, vjp(gout)[0]


def concat_views(cfg):
    """The reference's entry streams of VIEWS concatenated, each view's
    tile starts offset by the entries before it. Returns (entries,
    tile_start, tile_len, tiles per view, ntx, each stream's offset)."""
    streams = [j_prepare_entries(make(), cam(), SHAPE, cfg, False, None, None)[:2] for make, cam in VIEWS]
    offs = np.cumsum([0] + [s[0].shape[1] for s in streams])
    entries = np.concatenate([np.asarray(s[0]) for s in streams], axis=1)
    starts = np.concatenate([np.asarray(s[1].tile_start) + o for o, s in zip(offs, streams)]).astype(np.int32)
    lens = np.concatenate([np.asarray(s[1].tile_len) for s in streams]).astype(np.int32)
    tpv, ntx = jr._kernel_static(SHAPE, cfg)
    return entries, starts, lens, tpv, ntx, offs


# ---------------------------------------------------------------------------
# (a) the plain versions with tpv against composite_tiled's 4-tuple static
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_id", list(CFGS))
def test_tpv_plain_matches_pallas(cfg_id):
    cfg = CFGS[cfg_id]
    entries, starts, lens, tpv, ntx, offs = concat_views(cfg)
    t_n = len(starts)
    assert t_n == 3 * tpv
    gout = np.random.default_rng(7).normal(size=(t_n, tt.OUT_ROWS, cfg.tile_pixels)).astype(np.float32)
    gout[:, tt.O_TRANS + 1 :] = 0.0
    out_j, dent_j = j_composite_vjp(jnp.asarray(entries), jnp.asarray(starts), jnp.asarray(lens),
                                    (t_n, ntx, cfg, tpv), jnp.asarray(gout))
    out_j, dent_j = np.asarray(out_j), np.asarray(dent_j)
    ent, ts, tl, c = to_t(entries), to_t(starts), to_t(lens), t_like(tt.RasterConfig, cfg)
    out_t = tcp.composite_fwd(ent, ts, tl, ntx, c, tpv)
    rows = [r for r in range(tt.O_TRANS + 1) if r != tt.O_DEPTH]
    assert_close(out_t[:, rows], out_j[:, rows], rtol=0, atol=2e-5)
    assert_close(out_t[:, tt.O_DEPTH], out_j[:, tt.O_DEPTH], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out_t[:, tt.O_STOP :].numpy(), out_j[:, tt.O_STOP :])
    # the views' tiles differ, and the wall's stop early
    lv = lens.reshape(3, tpv)
    assert not (lv[0] == lv[1]).all() and not (lv[0] == lv[2]).all()
    assert (out_j[:, tt.O_STOP, 0].reshape(3, tpv)[1] < -(-lv[1] // cfg.chunk)).any()
    dent_t = tcp.composite_bwd(ent, ts, tl, out_t, to_t(gout), ntx, c, tpv)
    for r in range(tt.USED_ROWS):
        assert_scaled(dent_t[r], dent_j[r], msg=f"entry grad row {r}")
    assert not dent_t[tt.USED_ROWS :].any()
    # each view's tiles shaded at its own pixels: its single-view grid
    # gives its images
    for i in range(3):
        o, t0 = int(offs[i]), i * tpv
        one = tcp.composite_fwd(ent[:, o : offs[i + 1]].contiguous(), ts[t0 : t0 + tpv] - o, tl[t0 : t0 + tpv], ntx, c)
        assert_close(out_t[t0 : t0 + tpv, rows], one[:, rows].numpy(), rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# (b) render_views_batched
# ---------------------------------------------------------------------------


def _batched_loss(outs, wts):
    """Seeded weights on every image channel of every view."""
    return sum(
        torch.sum(getattr(outs, k) * w) if isinstance(outs.rgb, torch.Tensor) else jnp.sum(getattr(outs, k) * w)
        for k, w in zip(("rgb", "depth", "normal", "opacity", "confidence"), wts)
    )


@pytest.mark.parametrize("cfg_id", list(CFGS))
def test_render_views_batched_matches_reference(cfg_id):
    cfg = CFGS[cfg_id]
    attrs = [make() for make, _ in BATCH_VIEWS]
    cams = [cam() for _, cam in BATCH_VIEWS]
    v = len(attrs)
    bg = np.asarray([0.1, 0.3, 0.2], np.float32)
    rng = np.random.default_rng(11)
    wts = [rng.normal(size=(v, c) + SHAPE).astype(np.float32) for c in (3, 1, 3, 1, 1)]

    def j_loss(leaves):
        a = [dataclasses.replace(x, **dict(zip(GRAD_NAMES, lv))) for x, lv in zip(attrs, leaves)]
        out, aux = jr.render_views_batched(a, cams, SHAPE, cfg, background=jnp.asarray(bg))
        return _batched_loss(out, [jnp.asarray(w) for w in wts]), (out, aux)

    leaves_j = [[getattr(a, n) for n in GRAD_NAMES] for a in attrs]
    (_, (out_j, aux_j)), g_j = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(leaves_j)

    tc = t_like(tt.RasterConfig, cfg)
    t_leaves = [{n: to_t(getattr(a, n)).requires_grad_(True) for n in GRAD_NAMES} for a in attrs]
    t_views = [dataclasses.replace(t_attrs(a), **lv) for a, lv in zip(attrs, t_leaves)]
    n0 = tcp.fwd_kernel.launches
    out_t, aux_t = tr.render_views_batched(t_views, [t_cam(c) for c in cams], SHAPE, tc, background=to_t(bg))
    assert tcp.fwd_kernel.launches == n0  # CPU tensors: the plain version
    assert out_t.rgb.shape == (v, 3) + SHAPE and out_t.depth.shape == (v, 1) + SHAPE
    for k in IMAGE_KEYS:
        assert_close(getattr(out_t, k), getattr(out_j, k), rtol=0, atol=2e-5, msg=k)
    assert_close(out_t.depth, out_j.depth, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(aux_t["num_dropped"].numpy(), np.asarray(aux_j["num_dropped"]))
    assert set(aux_t) == {"num_dropped"}
    loss = _batched_loss(out_t, [to_t(w) for w in wts])
    grads = torch.autograd.grad(loss, [lv[n] for lv in t_leaves for n in GRAD_NAMES])
    for i in range(v):
        for j, n in enumerate(GRAD_NAMES):
            assert_scaled(grads[i * len(GRAD_NAMES) + j], g_j[i][j], msg=f"view {i} {n}")
    # each view as render_view renders it
    for i in range(v):
        o, _ = tr.render_view(t_views[i], t_cam(cams[i]), SHAPE, tc, background=to_t(bg))
        assert_close(out_t.rgb[i], o.rgb.detach().numpy(), rtol=0, atol=2e-5)
        assert_close(out_t.depth[i], o.depth.detach().numpy(), rtol=0, atol=1e-4)


def test_render_views_batched_refuses_unequal_budgets():
    tc = t_like(tt.RasterConfig, CFG)
    views = [t_attrs(make_attrs(96, seed=1)), t_attrs(make_attrs(80, seed=2))]
    cams = [t_cam(make_camera())] * 2
    with pytest.raises(ValueError, match="one budget"):
        tr.render_views_batched(views, cams, SHAPE, tc)
    # frozen bins of unequal budgets too
    bins = [tr.prepare_view_bins(views[0], cams[0], SHAPE, tc, entry_budget=b) for b in (1024, 2048)]
    with pytest.raises(ValueError, match="one budget"):
        tr.render_views_batched([views[0]] * 2, cams, SHAPE, tc, bin_results=bins)
    # one shared budget renders
    out, aux = tr.render_views_batched(views, cams, SHAPE, tc, entry_budget=1024)
    assert out.rgb.shape == (2, 3) + SHAPE and aux["num_dropped"].shape == (2,)


# ---------------------------------------------------------------------------
# (c) MapConfig.fused_view_kernel
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fused_keyframes():
    """On the reference's own fused-keyframe setup
    (`test_mapping.TestSubsetTraining`: 64 gaussians, 4 views of 32x32,
    subset bucket 128, 2 Adam steps): the reference's keyframe with
    fused_view_kernel (its batched-subset path), and the port's with and
    without it, from the same state and the reference's drawn ids."""
    from activegs_tpu.mapping import keyframes as jkf
    from test_mapping import TestSubsetTraining

    cfg, raster, state, buf = TestSubsetTraining()._setup()
    key = jax.random.PRNGKey(11)
    ids = jkf.sample_weighted(buf, jax.random.split(key)[1], cfg.batch_size, cfg.active_size)
    cfg_j = dataclasses.replace(cfg, fused_view_kernel=True)
    want = jtr.train_keyframe(state, buf, key, cfg_j, raster, subset_bucket=128)
    views = ttr.batch_views(to_t(ids).long())
    t_raster = t_like(tt.RasterConfig, raster)
    got = {}
    for fused in (True, False):
        cfg_t = t_like(tgm.MapConfig, dataclasses.replace(cfg, fused_view_kernel=fused))
        got[fused] = ttr.train_keyframe(t_state(state), t_buffer(buf), views, cfg_t, t_raster, subset_bucket=128)
    return want, got, state


def test_fused_view_kernel_keyframe_matches_reference(fused_keyframes):
    """Loss at relative 1e-5 and means at 1e-5 after scaling, as the
    reference holds its fused keyframe to its per-view one."""
    want, got, _ = fused_keyframes
    want_s, want_b, want_l, want_aux = want
    got_s, got_b, got_l, got_aux = got[True]
    assert_close(got_l, want_l, rtol=1e-5, atol=0)
    assert_close(got_b.performance, want_b.performance, rtol=1e-5, atol=1e-7)
    for k in ("num_dropped", "num_entries"):
        assert int(got_aux[k]) == int(want_aux[k]), k
    n = int(want_s.count)
    b = np.asarray(want_s.means)[:n]
    scale = np.abs(b).max() + 1e-12
    np.testing.assert_allclose(got_s.means[:n].numpy() / scale, b / scale, rtol=0, atol=1e-5)


def test_fused_view_kernel_keyframe_matches_per_view(fused_keyframes):
    """The port's fused keyframe against its per-view one (the reference's
    `test_train_fused_view_kernel_matches_unrolled`)."""
    _, got, state = fused_keyframes
    (s_f, _, l_f, _), (s_v, _, l_v, _) = got[True], got[False]
    assert_close(l_f, l_v.numpy(), rtol=1e-5, atol=0)
    n = int(state.count)
    scale = float(s_v.means[:n].abs().max()) + 1e-12
    assert_close(s_f.means[:n] / scale, (s_v.means[:n] / scale).numpy(), rtol=0, atol=1e-5)
    assert float((s_f.means - t_state(state).means).abs().max()) > 0


def test_fused_view_kernel_warns_without_subsets(mapped):
    """Without compacted subsets the option is not honored: the reference's
    warning, then the per-view renders."""
    state, buf = mapped
    t_st, t_buf = t_state(state), t_buffer(buf)
    ids = torch.tensor([0, 1])
    batch = tkf.decode_frames(t_buf, ids)
    bins, _ = ttr.prepare_views(t_st, batch, T_MAPCFG, T_RASTER)
    params = {k: getattr(t_st, k).clone().requires_grad_(True) for k in ttr.PARAM_FIELDS}
    counts = torch.ones(2, dtype=torch.int64)
    cfg_f = dataclasses.replace(T_MAPCFG, fused_view_kernel=True)
    with pytest.warns(UserWarning, match="only honored on the batched-subset path"):
        l_f, _ = ttr.batch_loss(params, t_st, batch, counts, cfg_f, T_RASTER, bins)
    l_v, _ = ttr.batch_loss(params, t_st, batch, counts, T_MAPCFG, T_RASTER, bins)
    assert torch.equal(l_f, l_v)


# ---------------------------------------------------------------------------
# (d) a plan step's candidates, batched
# ---------------------------------------------------------------------------


def test_batched_candidate_utilities(world, monkeypatch):
    """`_confidence_utility_batch` (all candidates through one
    render_views_batched call) against `candidate_view_stats` one
    candidate at a time, and against the reference's
    `_confidence_utility_batch`: explore equal, exploit at relative error
    1e-4; with GROUP_BYTES cut to two candidates' streams, the candidates go
    in groups of two and score the same."""
    from activegs_tpu.mapping.trainer import pick_entry_bucket, pick_subset_bucket
    from test_mapping import look_at_pose

    sim, _, grid, vstate, state = world
    cands = np.stack([
        tpl.POSES[0], tpl.POSES[2],
        look_at_pose((2.0, 2.0, 1.2), (5.5, 3.0, 1.0)),
        look_at_pose((3.0, 2.5, 1.5), (1.0, 1.0, 1.0)),  # away from the map
        look_at_pose((3.5, 2.0, 1.4), (5.5, 1.0, 1.2)),
    ]).astype(np.float32)
    shape = (16, 16)
    ucfg = dataclasses.replace(tpl.RASTER, max_dup=2, entry_budget_mult=1.0)
    ents, ivs = (int(x) for x in jcf._candidate_entry_stats(state, jnp.asarray(cands), jnp.asarray(sim.intrinsic),
                                                            shape, tpl.MAPCFG, ucfg))
    budget, bucket = pick_entry_bucket(ents), pick_subset_bucket(ivs, state.capacity, min_bucket=1024)
    masks = np.ones((len(cands), *shape), bool)
    masks[1, :4] = False
    dr = np.asarray(sim.depth_range, np.float32)
    ej, xj = (np.asarray(x) for x in jcf._confidence_utility_batch(
        state, vstate.unexplored, jnp.asarray(cands), jnp.asarray(sim.intrinsic), jnp.asarray(masks),
        jnp.asarray(dr), grid, shape, tpl.MAPCFG, ucfg, entry_budget=budget, subset_bucket=bucket,
    ))
    ts, tu, tgr = t_state(state), t_vstate(vstate).unexplored, t_grid(grid)
    t_ucfg = t_like(tt.RasterConfig, ucfg)
    args = (ts, tu, to_t(cands), to_t(sim.intrinsic), torch.from_numpy(masks), to_t(dr), tgr, shape, tpl.T_MAPCFG, t_ucfg)
    calls = []
    batched = tcf.render_views_batched

    def counted(views, *a, **k):
        calls.append(len(views))
        return batched(views, *a, **k)

    monkeypatch.setattr(tcf, "render_views_batched", counted)
    et, xt = tcf._confidence_utility_batch(*args, entry_budget=budget, subset_bucket=bucket)
    assert calls == [len(cands)]
    from activegs_torch.render.renderer import pack_attrs

    attrs = tgm.attrs_of(ts, tpl.T_MAPCFG)
    one = [
        tcf.candidate_view_stats(attrs, to_t(c), to_t(sim.intrinsic), torch.from_numpy(m), tu, to_t(dr), tgr, shape,
                                 t_ucfg, budget, False, bucket, pack_attrs(attrs))
        for c, m in zip(cands, masks)
    ]
    e1, x1 = (torch.stack(x).numpy() for x in zip(*one))
    assert ej.max() > 0 and xj.max() > 0
    np.testing.assert_array_equal(et.numpy(), e1)
    np.testing.assert_allclose(xt.numpy(), x1, rtol=1e-4, atol=0)
    np.testing.assert_array_equal(et.numpy(), ej)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-4, atol=0)
    # groups of two candidates' streams
    from activegs_torch.render import binning as tbin

    stream = tbin.stream_length(bucket if bucket is not None else ts.capacity, shape, t_ucfg, budget)
    assert tcf.utility_groups(len(cands), ts.capacity, shape, t_ucfg, budget, bucket) == [range(len(cands))]
    monkeypatch.setattr(tcf, "GROUP_BYTES", 2 * tt.PARAM_DIM * 4 * stream + 1)
    assert [len(g) for g in tcf.utility_groups(len(cands), ts.capacity, shape, t_ucfg, budget, bucket)] == [2, 2, 1]
    calls.clear()
    eg, xg = tcf._confidence_utility_batch(*args, entry_budget=budget, subset_bucket=bucket)
    assert calls == [2, 2, 1]
    np.testing.assert_array_equal(eg.numpy(), et.numpy())
    np.testing.assert_allclose(xg.numpy(), xt.numpy(), rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# (e) one view: tpv == T leaves the plain versions as they were
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_id", list(CFGS))
def test_tpv_of_one_view_changes_no_bit(cfg_id):
    cfg = CFGS[cfg_id]
    entries, b, _, _, _ = j_prepare_entries(opaque_wall(), make_camera(), SHAPE, cfg, False, None, None)
    t_n, ntx = jr._kernel_static(SHAPE, cfg)
    ent, ts, tl, c = to_t(entries), to_t(b.tile_start), to_t(b.tile_len), t_like(tt.RasterConfig, cfg)
    out = tcp.composite_fwd_plain(ent, ts, tl, ntx, c)
    out_v = tcp.composite_fwd_plain(ent, ts, tl, ntx, c, tpv=t_n)
    assert torch.equal(out.view(torch.int32), out_v.view(torch.int32))
    gout = torch.from_numpy(np.random.default_rng(2).normal(size=out.shape).astype(np.float32))
    d = tcp.composite_bwd_plain(ent, ts, tl, out, gout, ntx, c)
    d_v = tcp.composite_bwd_plain(ent, ts, tl, out, gout, ntx, c, tpv=t_n)
    assert torch.equal(d.view(torch.int32), d_v.view(torch.int32))
    assert cp_coords_equal(t_n, ntx, c)
    for bad in (3, 0, 2 * t_n):
        with pytest.raises(ValueError, match="does not divide"):
            tcp.composite_fwd_plain(ent, ts, tl, ntx, c, tpv=bad)


def cp_coords_equal(t_n, ntx, cfg) -> bool:
    """tile_pixel_coords of one view, with and without tpv; and a grid of
    two views repeats the first view's coordinates."""
    one = tcp.tile_pixel_coords(t_n, ntx, cfg, "cpu")
    same = all(torch.equal(a, b) for a, b in zip(one, tcp.tile_pixel_coords(t_n, ntx, cfg, "cpu", t_n)))
    two = tcp.tile_pixel_coords(2 * t_n, ntx, cfg, "cpu", t_n)
    return same and all(torch.equal(torch.cat([a, a]), b) for a, b in zip(one, two))
