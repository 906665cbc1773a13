"""Parity of the PyTorch port's mapping layer with the JAX reference.

Keyframe buffer, surfel map (spawn, confidence, prune, state I/O), trainer
(view loss, batch loss, view stats, post_process) and the synthetic
simulator. Both packages get the same state through `state_from_numpy` /
`buffer_from_numpy`, and the same view batch: ids drawn by the reference's
`jax.random` sampler are handed to the port, whose samplers take a
`torch.Generator` and are held to the reference's distributions instead.
Runs at 64 x 64 on the CPU, with the reference's Pallas kernels in interpret
mode.
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
from activegs_torch.render import types as tt
from activegs_torch.render.binning import BinResult
from activegs_torch.sim import synthetic as tsyn
from activegs_tpu.mapping import gaussians as jgm
from activegs_tpu.mapping import keyframes as jkf
from activegs_tpu.mapping import trainer as jtr
from activegs_tpu.render.types import Camera, RasterConfig, RenderOutput
from activegs_tpu.sim import synthetic as jsyn
from test_mapping import look_at_pose
from test_torch_core import assert_close, assert_scaled, t_like, to_t

torch.set_num_threads(2)

RES = 64
RASTER = RasterConfig(entry_budget_mult=4.0, interpret=True)
MAPCFG = jgm.MapConfig(capacity=8192, bilateral_radius=2)
T_RASTER = t_like(tt.RasterConfig, RASTER)
T_MAPCFG = t_like(tgm.MapConfig, MAPCFG)
POSES = [
    look_at_pose((3.0, 2.5, 1.5), (5.5, 2.5, 1.2)),
    look_at_pose((3.0, 2.5, 1.5), (5.0, 4.0, 1.0)),
    look_at_pose((3.2, 2.3, 1.5), (5.5, 2.0, 1.5)),
    look_at_pose((3.0, 2.5, 1.5), (1.0, 1.0, 1.0)),  # away from frames 0-2
]


# ---------------------------------------------------------------------------
# reference objects -> port objects
# ---------------------------------------------------------------------------


def ref_backproject(depth, f):
    from activegs_tpu.core import geometry as jgeo

    return jgeo.backproject_depth(jnp.asarray(depth), f["extrinsic"], f["intrinsic"])


def t_frame(f) -> dict:
    return {k: to_t(v) for k, v in f.items()}


def t_state(s, capacity=None) -> tgm.GaussianMapState:
    n = int(s.count)
    return tgm.state_from_numpy({k: np.asarray(getattr(s, k))[:n] for k in tgm.FIELDS}, "cpu", capacity or s.capacity)


def t_buffer(b) -> tkf.KeyframeBuffer:
    return tkf.buffer_from_numpy({f.name: np.asarray(getattr(b, f.name)) for f in dataclasses.fields(b)}, "cpu")


def ref_batch_ids(buf, key, cfg=MAPCFG):
    """The view batch the reference's train_keyframe draws from `key`."""
    _, k1 = jax.random.split(key)
    return jkf.sample_weighted(buf, k1, cfg.batch_size, cfg.active_size)


def assert_state_close(got: tgm.GaussianMapState, want, atol=1e-6):
    n = int(want.count)
    assert got.count == n
    for f in tgm.FIELDS:
        assert_close(getattr(got, f)[:n], np.asarray(getattr(want, f))[:n], atol=atol, msg=f)


@pytest.fixture(scope="module")
def frames():
    sim = jsyn.BoxRoomSimulator(resolution=(RES, RES), seed=3, depth_noise_co=0.0)
    return [sim.simulate(p, require_gt=True) for p in POSES]


@pytest.fixture(scope="module")
def mapped(frames):
    """Reference state and buffer after spawning frames 0 and 1."""
    state = jgm.init_state(MAPCFG)
    buf = jkf.init_buffer(8, RES, RES)
    for f in frames[:2]:
        state, _, _ = jgm.spawn(state, f, MAPCFG, RASTER)
        buf = jkf.add_frame(buf, f)
    return state, buf


# ---------------------------------------------------------------------------
# simulator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pose", range(len(POSES)))
def test_simulator_frames_match_reference(pose):
    """Noise-free frames. Depth, and rgb away from the 20 cm checker lines,
    may differ at no more than 0.1% of the pixels (triangle edges, where
    the two ray casters round the hit test apart). Walls sit exactly on
    checker lines, so there a one-ulp difference in the surface point flips
    the checker tint: such pixels must hit the same surface (equal depth)
    at a point on a checker line."""
    ref = jsyn.BoxRoomSimulator(resolution=(RES, RES), seed=11, depth_noise_co=0.0)
    port = tsyn.BoxRoomSimulator(resolution=(RES, RES), seed=11, depth_noise_co=0.0, device="cpu")
    f_j = ref.simulate(POSES[pose], require_gt=True)
    f_t = port.simulate(torch.from_numpy(POSES[pose]), require_gt=True)
    for k in ("extrinsic", "intrinsic", "depth_range"):
        np.testing.assert_array_equal(f_t[k].numpy(), np.asarray(f_j[k]), err_msg=k)
    depth_j = np.asarray(f_j["depth"][0])
    depth_bad = np.abs(f_t["depth"][0].numpy() - depth_j) > 1e-5
    assert depth_bad.mean() <= 1e-3, depth_bad.sum()
    rgb_bad = np.abs(f_t["rgb"].numpy() - np.asarray(f_j["rgb"])).max(axis=0) > 1e-5
    pts = np.asarray(ref_backproject(depth_j, f_j))
    on_line = np.any(np.abs(pts / 0.2 - np.round(pts / 0.2)) < 1e-4, axis=-1) & ~depth_bad
    assert (rgb_bad & ~on_line).mean() <= 1e-3, (rgb_bad & ~on_line).sum()
    assert port.simulate(torch.from_numpy(POSES[pose]), valid_mask_only=True).dtype == torch.bool


def test_sensor_model_noise_and_sentinels():
    """Sentinels exactly as the reference (-1 out of range, -2 no return);
    the noise is N(0, (0.01 d)^2) from the port's own generator."""
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 6.0, (200, 200)).astype(np.float32)
    depth[:20] = 0.0
    ref = jsyn.BoxRoomSimulator(resolution=(8, 8), depth_noise_co=0.01)
    port = tsyn.BoxRoomSimulator(resolution=(8, 8), depth_noise_co=0.01, device="cpu")
    want, valid_j = ref.apply_sensor_model(depth.copy(), np.random.default_rng(1))
    got, valid_t = port.apply_sensor_model(to_t(depth), torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(valid_t.numpy(), valid_j)
    for s in (-1.0, -2.0):
        np.testing.assert_array_equal(got.numpy() == s, want == s)
    ok = want > 0
    rel = (got.numpy()[ok] - depth[ok]) / depth[ok]
    assert abs(rel.mean()) < 1e-3 and abs(rel.std() - 0.01) < 5e-4


# ---------------------------------------------------------------------------
# keyframe buffer and samplers
# ---------------------------------------------------------------------------


def _toy_frame(i, res=8):
    return {
        "rgb": np.full((3, res, res), (i % 10) / 10.0, np.float32),
        "depth": np.full((1, res, res), 1.0 + i, np.float32),
        "extrinsic": (np.eye(4) * (1.0 + i)).astype(np.float32),
        "intrinsic": np.eye(3, dtype=np.float32),
        "depth_range": np.asarray([0.0, 5.0], np.float32),
    }


def test_keyframe_add_evict_decode_match_reference():
    cap = 4
    jb, tb = jkf.init_buffer(cap, 8, 8), tkf.init_buffer(cap, 8, 8, device="cpu")
    perfs = [[5.0, 0.1, 7.0, 3.0], [2.0, 9.0, 1.0, 4.0]]
    for i in range(cap + 2):
        if i >= cap:  # give each round a different eviction victim
            p = np.asarray(perfs[i - cap], np.float32)
            jb = jkf.update_performance(jb, jnp.arange(cap), jnp.asarray(p))
            tb = tkf.update_performance(tb, torch.arange(cap), to_t(p))
        f = _toy_frame(i)
        jb = jkf.add_frame(jb, {k: jnp.asarray(v) for k, v in f.items()})
        tb = tkf.add_frame(tb, t_frame(f))
    assert tb.count == int(jb.count) == cap
    for f in dataclasses.fields(jb):
        np.testing.assert_array_equal(np.asarray(getattr(tb, f.name)), np.asarray(getattr(jb, f.name)), err_msg=f.name)
    ids = np.asarray([3, 0, 2, 2])
    for g, w in zip(tkf.decode_frames(tb, to_t(ids)), jkf.decode_frames(jb, jnp.asarray(ids))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the buffer carries over: identical leaves after a round trip
    tb2 = t_buffer(jb)
    for f in dataclasses.fields(jb):
        np.testing.assert_array_equal(np.asarray(getattr(tb2, f.name)), np.asarray(getattr(jb, f.name)))


def _filled(n, cap=16):
    jb, tb = jkf.init_buffer(cap, 4, 4), tkf.init_buffer(cap, 4, 4, device="cpu")
    for i in range(n):
        f = _toy_frame(0, res=4)
        jb = jkf.add_frame(jb, {k: jnp.asarray(v) for k, v in f.items()})
        tb = tkf.add_frame(tb, t_frame(f))
    return jb, tb


@pytest.mark.parametrize("n_frames", [1, 3, 4])
def test_samplers_deterministic_part_matches_reference(n_frames):
    """With at most one rest frame the draw is fully determined: the
    active window, the rest frame, then repeats of the latest."""
    jb, tb = _filled(n_frames)
    g = torch.Generator().manual_seed(0)
    for jfn, tfn in ((jkf.sample_weighted, tkf.sample_weighted), (jkf.sample_uniform, tkf.sample_uniform)):
        want = np.asarray(jfn(jb, jax.random.PRNGKey(0), 8, 3))
        np.testing.assert_array_equal(tfn(tb, g, 8, 3).numpy(), want)


def _rest_histogram(sample, buf, gen, draws=300, batch=8, active=3):
    counts = np.zeros(buf.count, np.int64)
    for _ in range(draws):
        counts += np.bincount(sample(buf, gen, batch, active).numpy()[active:], minlength=buf.count)
    return counts


def test_uniform_sampler_distribution():
    _, tb = _filled(12)
    counts = _rest_histogram(tkf.sample_uniform, tb, torch.Generator().manual_seed(0))
    n_rest, expected = 9, 300 * 5 / 9
    assert counts[n_rest:].sum() == 0
    assert counts[:n_rest].min() > 0.5 * expected and counts[:n_rest].max() < 2.0 * expected
    ids = tkf.sample_uniform(tb, torch.Generator().manual_seed(7), 8, 3).numpy()
    assert len(set(ids[3:].tolist())) == 5  # without replacement


def test_weighted_sampler_distribution():
    _, tb = _filled(12)
    perf = np.ones(16, np.float32)
    perf[2] = 10.0
    tkf.update_performance(tb, torch.arange(16), to_t(perf))
    counts = _rest_histogram(tkf.sample_weighted, tb, torch.Generator().manual_seed(0))
    others = np.delete(counts[:9], 2)
    assert counts[9:].sum() == 0
    assert counts[2] > 1.8 * others.mean() and others.min() > 0


# ---------------------------------------------------------------------------
# surfel map
# ---------------------------------------------------------------------------


def test_state_checkpoint_roundtrip(mapped, tmp_path):
    """A map saved by the reference's checkpoint writer loads into the port
    (`state_from_numpy` takes its keys) and comes back unchanged."""
    from activegs_tpu.io.checkpoint import save_gaussian_map

    state, _ = mapped
    path = str(tmp_path / "map.npz")
    save_gaussian_map(path, state, MAPCFG)
    d = np.load(path)
    port = tgm.state_from_numpy(d, "cpu", capacity=8192)
    assert port.capacity == 8192 and port.count == int(state.count)
    back = tgm.state_to_numpy(port)
    assert set(back) == set(tgm.FIELDS)
    for k in tgm.FIELDS:
        np.testing.assert_array_equal(back[k], d[k])
    assert not port.opacities_raw[port.count :].any()
    assert torch.equal(port.rotations_raw[port.count :, 0], torch.ones(8192 - port.count))


def test_init_state_and_buckets_match_reference():
    ref, port = jgm.init_state(MAPCFG), tgm.init_state(T_MAPCFG, device="cpu")
    for k in tgm.FIELDS:
        np.testing.assert_array_equal(getattr(port, k).numpy(), np.asarray(getattr(ref, k)))
    for count in (0, 1000, 30000, 40000, 100000, 600000):
        assert tgm.bucket_capacity(count, 1 << 19) == jgm.bucket_capacity(count, 1 << 19)
        assert tgm.bucket_capacity(count, 1 << 19, min_cap=1024) == jgm.bucket_capacity(count, 1 << 19, min_cap=1024)
    for need in (1, 5000, 8193, 12289, 40000, 300000):
        assert ttr.pick_entry_bucket(need) == jtr.pick_entry_bucket(need)
        for cap in (16384, 1 << 19):
            assert ttr.pick_subset_bucket(need, cap) == jtr.pick_subset_bucket(need, cap)


def test_slice_and_write_back(mapped):
    state, _ = mapped
    full = t_state(state, capacity=8192)
    sub = tgm.slice_state(full, 2048)
    assert sub.capacity == 2048 and sub.count == full.count
    sub = dataclasses.replace(sub, colors=sub.colors + 1.0, count=sub.count - 5)
    merged = tgm.write_back(full, sub)
    assert merged.count == full.count - 5
    assert torch.equal(merged.colors[:2048], sub.colors)
    j_sub = jgm.slice_state(state, 2048)
    np.testing.assert_array_equal(tgm.slice_state(t_state(state), 2048).means.numpy(), np.asarray(j_sub.means))


def _random_state(seed=0, n=300, cap=512):
    rng = np.random.default_rng(seed)
    d = {
        "means": rng.uniform(0, 5, (n, 3)),
        "scales_raw": rng.normal(0, 1, (n, 3)),
        "rotations_raw": rng.normal(size=(n, 4)),
        "opacities_raw": rng.normal(size=n),
        "colors": rng.uniform(size=(n, 3)),
        "view_scores": rng.uniform(0, 2, n),
        "view_supports": rng.integers(0, 4, n).astype(np.float64),
        "view_means": rng.normal(0, 0.5, (n, 3)),
    }
    d = {k: v.astype(np.float32) for k, v in d.items()}
    ref = jgm.init_state(dataclasses.replace(MAPCFG, capacity=cap))
    ref = dataclasses.replace(
        ref, count=jnp.int32(n), **{k: getattr(ref, k).at[:n].set(jnp.asarray(v)) for k, v in d.items()}
    )
    return ref, tgm.state_from_numpy(d, "cpu", capacity=cap)


@pytest.mark.parametrize("use_view_distribution", [True, False])
def test_activations_match_reference(use_view_distribution):
    ref, port = _random_state()
    cfg_j = dataclasses.replace(MAPCFG, use_view_distribution=use_view_distribution)
    cfg_t = t_like(tgm.MapConfig, cfg_j)
    a_j, a_t = jgm.attrs_of(ref, cfg_j), tgm.attrs_of(port, cfg_t)
    for f in dataclasses.fields(tt.GaussianAttrs):
        assert_close(getattr(a_t, f.name), getattr(a_j, f.name), msg=f.name)
    assert_close(tgm.normals_of(port), jgm.normals_of(ref))


def test_update_confidence_and_prune_match_reference():
    ref, port = _random_state(seed=1)
    rng = np.random.default_rng(2)
    vis = rng.integers(0, 3, ref.capacity).astype(np.int32)
    cam = np.asarray([3.0, 2.5, 1.5], np.float32)
    want = jgm.update_confidence(ref, MAPCFG, jnp.asarray(cam), jnp.float32(5.0), jnp.asarray(vis))
    got = tgm.update_confidence(port, T_MAPCFG, to_t(cam), torch.tensor(5.0), to_t(vis))
    assert_state_close(got, want, atol=2e-6)
    vis_any = rng.uniform(size=ref.capacity) > 0.3
    want_s, want_n = jgm.prune(want, MAPCFG, jnp.asarray(vis_any))
    got_s, got_n = tgm.prune(got, T_MAPCFG, to_t(vis_any))
    assert got_n == int(want_n) > 0
    assert_state_close(got_s, want_s, atol=2e-6)


@pytest.mark.parametrize("start", ["empty", "carried"])
def test_spawn_matches_reference(frames, mapped, start):
    """Same frame, same state: equal spawn counts and new surfels. The
    carried case renders its error mask on a sliced capacity bucket."""
    if start == "empty":
        ref, frame, bucket = jgm.init_state(MAPCFG), frames[0], None
    else:
        ref, frame = mapped[0], frames[3]
        bucket = jgm.bucket_capacity(int(ref.count), MAPCFG.capacity, min_cap=1024)
    want, n_j, drop_j = jgm.spawn(ref, frame, MAPCFG, RASTER, render_bucket=bucket)
    got, n_t, drop_t = tgm.spawn(t_state(ref), t_frame(frame), T_MAPCFG, T_RASTER, render_bucket=bucket)
    assert (n_t, drop_t) == (int(n_j), int(drop_j))
    assert n_t > 100
    # quaternions come from normals of the smoothed depth through cross
    # products, where summation order moves them by ~1e-6
    assert_state_close(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------


def test_view_loss_matches_reference(frames):
    """`_view_loss` on identical render outputs: value and its gradient with
    respect to every output channel."""
    f = frames[1]
    rng = np.random.default_rng(3)
    out = {
        "rgb": rng.uniform(0, 1, (3, RES, RES)),
        "depth": np.asarray(f["depth"]) + rng.normal(0, 0.05, (1, RES, RES)),
        "normal": rng.normal(size=(3, RES, RES)),
        "opacity": rng.uniform(0, 1, (1, RES, RES)),
        "confidence": rng.uniform(0, 1, (1, RES, RES)),
    }
    out = {k: v.astype(np.float32) for k, v in out.items()}
    out["opacity"][0, :10] = 0.0  # invisible rows leave the masks
    out["depth"][0, 20:30, 20:30] = 2.0  # a flat patch for the TV gate

    def jloss(o):
        return jtr._view_loss(RenderOutput(**o), f["rgb"], f["depth"], f["intrinsic"])

    @jax.jit
    def value_and_vjp(o):
        value, vjp = jax.vjp(jloss, o)
        return value, vjp((jnp.float32(1.0), jnp.float32(0.0)))[0]

    (want_l, want_e), want_g = value_and_vjp({k: jnp.asarray(v) for k, v in out.items()})
    leaves = {k: to_t(v).requires_grad_(True) for k, v in out.items()}
    got_l, got_e = ttr._view_loss(tt.RenderOutput(**leaves), to_t(f["rgb"]), to_t(f["depth"]), to_t(f["intrinsic"]))
    assert_close(got_l, want_l, rtol=1e-5)
    assert_close(got_e, want_e, rtol=1e-5)
    grads = torch.autograd.grad(got_l, [leaves[k] for k in ("rgb", "depth", "normal")])
    for k, g in zip(("rgb", "depth", "normal"), grads):
        assert_scaled(g, want_g[k], msg=k)


@functools.partial(jax.jit, static_argnums=(3,))
def _ref_views(state, buf, ids, subset_bucket):
    """The reference's frozen bins and subsets for `ids`, built as its
    train_keyframe builds them."""
    from activegs_tpu.render import preprocess as rp
    from activegs_tpu.render.renderer import compact_in_view, pack_attrs, prepare_view_bins, subset_view

    batch = jkf.decode_frames(buf, ids)
    attrs0 = jgm.attrs_of(state, MAPCFG)

    def one(c):
        cam = Camera(extrinsic=c[0], intrinsic=c[1])
        if subset_bucket is None:
            return prepare_view_bins(attrs0, cam, (RES, RES), RASTER)
        _, _, _, iv = rp.preprocess(attrs0, cam, (RES, RES), RASTER)
        sel, selv, inv, _ = compact_in_view(iv, subset_bucket)
        b = prepare_view_bins(subset_view(pack_attrs(attrs0), (sel, selv, inv)), cam, (RES, RES), RASTER)
        return sel, selv, inv, b

    out = jax.lax.map(one, (batch[2], batch[3]))
    if subset_bucket is None:
        return batch, out, None
    return batch, out[3], out[:3]


@pytest.mark.parametrize("subset_bucket", [None, 2048], ids=["full", "subset"])
def test_batch_loss_matches_reference(mapped, subset_bucket):
    """batch_loss value (rel 1e-5) and parameter grads (3e-4 scaled) with
    the reference's drawn ids injected and bins frozen from the same state."""
    state, buf = mapped
    ids = ref_batch_ids(buf, jax.random.PRNGKey(5))
    batch, bins, subsets = _ref_views(state, buf, ids, subset_bucket)
    params = {k: getattr(state, k) for k in ttr.PARAM_FIELDS}
    (want_l, want_e), want_g = jax.jit(jax.value_and_grad(jtr.batch_loss, has_aux=True), static_argnums=(3, 4))(
        params, state, batch, MAPCFG, RASTER, bins, subsets
    )
    t_st, t_buf = t_state(state), t_buffer(buf)
    t_batch = tkf.decode_frames(t_buf, to_t(ids).long())
    # the reference's frozen bins and subsets, injected: the port's own
    # preprocess rounds depth keys apart by an ulp, which may swap two
    # equal-depth entries (binning itself is held integer-equal elsewhere)
    t_bins = [
        BinResult(to_t(bins.gid[i]).long(), to_t(bins.tile_start[i]), to_t(bins.tile_len[i]), to_t(bins.num_dropped[i]))
        for i in range(len(ids))
    ]
    t_subsets = None
    if subsets is not None:
        t_subsets = [(to_t(subsets[0][i]).long(), to_t(subsets[1][i]), to_t(subsets[2][i]).long()) for i in range(len(ids))]
    t_params = {k: getattr(t_st, k).clone().requires_grad_(True) for k in ttr.PARAM_FIELDS}
    ones = torch.ones(len(ids), dtype=torch.int64)  # every drawn copy rendered
    got_l, got_e = ttr.batch_loss(t_params, t_st, t_batch, ones, T_MAPCFG, T_RASTER, t_bins, t_subsets)
    got_g = torch.autograd.grad(got_l, list(t_params.values()))
    assert_close(got_l, want_l, rtol=1e-5, atol=0)
    assert_close(got_e, want_e, rtol=1e-5, atol=1e-7)
    for k, g in zip(ttr.PARAM_FIELDS, got_g):
        assert_scaled(g, want_g[k], msg=k)


def test_repeated_views_render_once(mapped):
    """A frame drawn c times weighs c / V: the loss over the batch's
    distinct views (`batch_views`) equals the mean over every drawn copy,
    grads included."""
    state, buf = mapped
    t_st, t_buf = t_state(state), t_buffer(buf)
    ids = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1])

    def loss_grads(view_ids, counts):
        batch = tkf.decode_frames(t_buf, view_ids)
        bins, _ = ttr.prepare_views(t_st, batch, T_MAPCFG, T_RASTER)
        params = {k: getattr(t_st, k).clone().requires_grad_(True) for k in ttr.PARAM_FIELDS}
        loss, _ = ttr.batch_loss(params, t_st, batch, counts, T_MAPCFG, T_RASTER, bins)
        return loss, torch.autograd.grad(loss, list(params.values()))

    l_all, g_all = loss_grads(ids, torch.ones(len(ids), dtype=torch.int64))
    uniq, counts = ttr.batch_views(ids)
    assert uniq.tolist() == [0, 1] and counts.tolist() == [2, 6]
    l_uniq, g_uniq = loss_grads(uniq, counts)
    assert_close(l_uniq, l_all.detach(), rtol=1e-6, atol=0)
    for a, b in zip(g_uniq, g_all):
        assert_scaled(a, b, atol=1e-5)


def test_view_stats_and_budgets_match_reference(mapped):
    state, buf = mapped
    key = jax.random.PRNGKey(5)
    want = [int(x) for x in jtr.keyframe_view_stats(state, buf, key, MAPCFG, RASTER)]
    ids = to_t(ref_batch_ids(buf, key)).long()
    t_st, t_buf = t_state(state), t_buffer(buf)
    assert list(ttr.keyframe_view_stats(t_st, t_buf, ids, T_MAPCFG, T_RASTER)) == want
    for prune in (False, True):
        want = [int(x) for x in jtr.stats_view_budgets(state, buf, MAPCFG, RASTER, require_prune=prune)]
        assert list(ttr.stats_view_budgets(t_st, t_buf, T_MAPCFG, T_RASTER, prune)) == want


@pytest.mark.parametrize("require_prune", [False, True], ids=["confidence", "prune"])
def test_post_process_matches_reference(mapped, require_prune):
    state, buf = mapped
    n = int(state.count)
    # a third of the map transparent: the prune removes at least those
    state = dataclasses.replace(state, opacities_raw=state.opacities_raw.at[: n // 3].set(-5.0))
    far = jnp.float32(5.0)
    want, n_j = jtr.post_process(state, buf, far, MAPCFG, RASTER, require_prune=require_prune)
    got, n_t = ttr.post_process(t_state(state), t_buffer(buf), torch.tensor(5.0), T_MAPCFG, T_RASTER, require_prune)
    assert n_t == int(n_j)
    if require_prune:
        assert n_t >= n // 3
    assert_state_close(got, want, atol=2e-6)
    sup = got.view_supports[: got.count]
    assert float(sup.max()) >= 1.0


@pytest.mark.parametrize("entry_budget", [None, 1024], ids=["no_drop", "truncated"])
def test_train_keyframe_step_matches_reference(mapped, entry_budget):
    """One Adam step from the same state and ids: the same loss, sampler
    errors and truncation telemetry, summed over every drawn copy of a
    view (the batch of 8 repeats the buffer's 2 frames). (With eps = 1e-15
    the first update is ~lr * sign(g), so the parameters after it are
    compared through the loss, not elementwise.)"""
    state, buf = mapped
    key = jax.random.PRNGKey(9)
    ids = ref_batch_ids(buf, key)
    want_s, want_b, want_l, want_aux = jtr.train_keyframe(
        state, buf, key, MAPCFG, RASTER, steps=1, entry_budget=entry_budget
    )
    views = ttr.batch_views(to_t(ids).long())
    assert len(views[0]) < len(ids)
    got_s, got_b, got_l, got_aux = ttr.train_keyframe(
        t_state(state), t_buffer(buf), views, T_MAPCFG, T_RASTER, steps=1, entry_budget=entry_budget
    )
    assert_close(got_l, want_l, rtol=1e-5, atol=0)
    assert_close(got_b.performance, want_b.performance, rtol=1e-5, atol=1e-7)
    for k in ("num_dropped", "num_entries"):
        assert int(got_aux[k]) == int(want_aux[k]), k
    assert (int(got_aux["num_dropped"]) > 0) == (entry_budget is not None)
    moved = (got_s.means - t_state(state).means).abs().max()
    assert 0 < float(moved) <= 1.01 * MAPCFG.mean_lr
    opt = ttr.make_optimizer({k: torch.zeros(1, requires_grad=True) for k in ttr.PARAM_FIELDS}, T_MAPCFG)
    assert [g["lr"] for g in opt.param_groups] == [5e-4, 1e-2, 5e-4, 1e-2, 1e-4]
    assert all(g["eps"] == 1e-15 for g in opt.param_groups)

