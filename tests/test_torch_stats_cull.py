"""The stats kernel's reductions, emulated on the CPU.

`render/csrc/composite_stats.cu` replays the forward pass per tile with a
render mask and sums, per entry over the tile's pixels, the importance
w * mask and the count of w * mask >= weight_thres. Its first design took
both sums per (entry, 32-pixel row), one warp, with a five-step shuffle
butterfly each and then summed the 16 warps' partials in warp order. The
redesign
- counts by ballot: the popcount of each warp's vote, summed as integers;
- sums importance by halving transposes, folded as a binary counter over
  rounds of 32 entries (offset 16 pairs neighbouring entries, 8 pairs the
  pairs, ...; a group of 4 entries folds to level 2 at once), lane L
  ending with the sum of entry brev5(L) of the round;
- culls a warp's round where its 32 sums are all +-0: it stores no partial
  and the cross-warp sum, in warp order from +0, reads only live warps;
- does not evaluate pad entries (the zero rows past a tile's length): they
  get importance +0 and a count of every pixel where the threshold is <= 0.
(The order in which its blocks take the tiles changes no output; the card
test `test_stats_tile_order_puts_the_longest_tiles_first` holds it.)
The kernel cannot run here, so this file emulates both algorithms lane by
lane in PyTorch on the same masked weights (the kernel's op order: alpha
from `eval_alpha_depth_cols`, a float32 running product per entry) and
shows, on the 64x64 scenes of `test_torch_fwd_cull.py` at K = 128, K = 8,
under bf16 pair math, for a 1024-pixel tile (32x32: 32 warps, a block of
1024 threads) and for a tile 16 pixels wide (8x16: a warp spans two pixel
rows), with a mask that zeroes whole warps (some with -0.0) and thresholds
0.03, 0 and -1:

(a) the redesign's outputs are the first design's bit for bit;
(b) they agree with `composite.composite_stats_plain` (importance 1e-5 of
    its max, counts equal except where some w * mask lies within 1e-6 of
    the threshold), and `stats_live_rows` counts the rounds the cull keeps;
(c) at K = 128 and 8 they agree with the reference's `composite_stats`
    (Pallas in interpret mode, under `jax.jit`) at
    `test_torch_render.py`'s tolerances: importance 1e-5 of its max,
    counts equal, on the segments the reference writes. Under bf16 the
    reference's interpret mode keeps bf16 intermediates in float32, so bf16
    is held against the reference in `test_torch_bf16.py` instead.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activegs_torch.render import composite as cp
from activegs_torch.render import preprocess as pp
from activegs_tpu.render import composite_pallas as jcp
from test_render import CFG, CFG_SMALL_CHUNK
from test_torch_fwd_cull import CASES, CFGS, case_entries, same_bits

THRESHOLDS = (0.03, 0.0, -1.0)
LANES = torch.arange(32)
COL = torch.tensor([int(f"{lane:05b}"[::-1], 2) for lane in range(32)])  # brev5: lane L's entry
JAX_CFGS = {"k128": CFG, "k8": CFG_SMALL_CHUNK}
j_composite_stats = jax.jit(jcp.composite_stats, static_argnums=(4, 5, 6, 7))


def warp_mask(num_tiles: int, p: int, seed: int = 4):
    """(T, P) render mask: pixels kept at random, and whole 32-pixel rows
    (warps) masked, some with +0.0 and some with -0.0."""
    rng = np.random.default_rng(seed)
    m = (rng.uniform(size=(num_tiles, p // 32, 32)) > 0.3).astype(np.float32)
    dead = rng.uniform(size=(num_tiles, p // 32))
    m[dead < 0.2] = 0.0
    m[(dead >= 0.2) & (dead < 0.3)] = -0.0
    return torch.from_numpy(m.reshape(num_tiles, p))


@functools.lru_cache(maxsize=None)
def masked_weights(case: str, cfg_id: str):
    """The stats replay of the kernel, pixel by pixel: per chunk the tiles
    that run it (the forward pass's tile-wide stop), the chunk's K entry
    indices (A, K), which of them are real (not pad rows past the tile's
    length) and the masked weights wm (A, K, P), each formed as the
    kernel forms it: alpha * excl (bf16: bf16(alpha * bf16(excl))) times T
    times the mask in float32, excl a float32 running product in entry
    order. Also returns (the wrapper's arguments, the mask)."""
    args, ntx, cfg = case_entries(case, cfg_id)
    entries, tile_start, tile_len = args
    t_n, k, p = tile_start.shape[0], cfg.chunk, cfg.tile_pixels
    mask = warp_mask(t_n, p)
    px, py = cp.tile_pixel_coords(t_n, ntx, cfg, entries.device)
    nch = (tile_len.to(torch.int64) + k - 1) // k
    trans = torch.ones((t_n, p))
    chunks = []
    for c in range(int(nch.max())):
        act = torch.nonzero((c < nch) & (trans > cfg.term_eps).any(-1)).squeeze(1)
        if act.numel() == 0:
            break
        e, idx = cp._chunk(entries, tile_start, tile_len, act, c, k, cut=False)  # pad rows included
        alpha, _ = pp.eval_alpha_depth_cols(pp.entry_cols(e), px[act], py[act], cfg)
        dt = alpha.dtype
        t_a, m_a = trans[act], mask[act]
        excl = torch.ones_like(t_a)
        wm = []
        for j in range(k):
            al = alpha[:, j]
            wm.append((al * excl.to(dt)).float() * t_a * m_a)
            excl = excl * (1.0 - al).float()
        trans[act] = t_a * excl.to(dt).float()
        real = idx - tile_start[act, None] < tile_len[act, None]
        chunks.append((act, idx, real, torch.stack(wm, dim=1)))
    return chunks, (args, ntx, cfg, mask)


def butterfly(v):
    """The five-step shuffle tree over the last axis (32 lanes): every lane
    adds lane ^ o's value, o = 16 .. 1; returns lane 0's sum."""
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., LANES ^ o]
    return v[..., 0]


def fold(a, b, o: int):
    """The kernel's `fold` over the last axis (lanes)."""
    up = (LANES & o) != 0
    return torch.where(up, b, a) + torch.where(up, a, b)[..., LANES ^ o]


def first_design(chunks, e_total: int, thres: float):
    """Per (entry, warp) a butterfly of wm and of the 0/1 test, then the
    warps' partials summed in warp order from +0."""
    imp, cnt = torch.zeros(e_total), torch.zeros(e_total)
    for _, idx, _, wm in chunks:
        a, k, p = wm.shape
        w = wm.reshape(a, k, p // 32, 32)
        part, cpart = butterfly(w), butterfly((w >= thres).float())
        s, c = torch.zeros(a, k), torch.zeros(a, k)
        for wi in range(p // 32):
            s, c = s + part[..., wi], c + cpart[..., wi]
        imp[idx.reshape(-1)], cnt[idx.reshape(-1)] = s.reshape(-1), c.reshape(-1)
    return imp, cnt


def redesign(chunks, e_total: int, thres: float):
    """Counts as integer sums of each warp's ballot popcount; importance by
    the kernel's folds (groups of 4 entries to level 2, then a binary
    counter over the groups for levels 2..4), each warp's round stored
    only where one of its 32 sums is not +-0, the live warps' partials
    summed in warp order from +0. Pad entries are not evaluated: they are
    zero columns of the folds, with importance +0 and a count of every
    pixel where thres <= 0. Returns (importance, count, the live (round,
    warp) pairs, all of them)."""
    imp, cnt = torch.zeros(e_total), torch.zeros(e_total)
    live = rounds = 0
    for _, idx, real, wm in chunks:
        a, k, p = wm.shape
        nw = p // 32
        w = torch.where(real[..., None, None], wm.reshape(a, k, nw, 32), 0.0)
        c = (w >= thres).sum(-1).sum(-1)  # int64: exact in any order
        c = torch.where(real, c, p if thres <= 0.0 else 0)
        nround = -(-k // 32)
        w = torch.cat([w, w.new_zeros((a, nround * 32 - k, nw, 32))], dim=1)
        s = torch.zeros(a, nround * 32)
        for r in range(nround):
            pend = {}
            for g in range(8):
                v = [w[:, r * 32 + 4 * g + u] for u in range(4)]  # (A, warps, lanes)
                x = fold(fold(v[0], v[1], 16), fold(v[2], v[3], 16), 8)
                for lvl in range(2, 5):
                    if not (g >> (lvl - 2)) & 1:
                        pend[lvl] = x
                        break
                    x = fold(pend[lvl], x, 16 >> lvl)
            alive = (x != 0.0).any(-1)  # (A, warps)
            ran = r * 32 < real.sum(1)  # the tiles with real entries in the round run it
            live, rounds = live + int((alive & ran[:, None]).sum()), rounds + int(ran.sum()) * nw
            part = x[..., COL]  # (A, warps, entries of the round)
            acc = torch.zeros(a, 32)
            for wi in range(nw):
                acc = torch.where(alive[:, wi, None], acc + part[:, wi], acc)
            s[:, r * 32 : (r + 1) * 32] = acc
        imp[idx.reshape(-1)], cnt[idx.reshape(-1)] = s[:, :k].reshape(-1), c.float().reshape(-1)
    return imp, cnt, live, rounds


@pytest.mark.parametrize("thres", THRESHOLDS)
@pytest.mark.parametrize("cfg_id", list(CFGS))
@pytest.mark.parametrize("case", list(CASES))
def test_redesign_is_the_first_design_bit_for_bit(case, cfg_id, thres):
    chunks, (args, _, cfg, _) = masked_weights(case, cfg_id)
    e_total = args[0].shape[1]
    imp_0, cnt_0 = first_design(chunks, e_total, thres)
    imp_1, cnt_1, live, rounds = redesign(chunks, e_total, thres)
    assert same_bits(imp_1, imp_0) and same_bits(cnt_1, cnt_0)
    assert 0 < live < rounds  # the cull has rounds to skip and rounds to keep
    if thres <= 0.0:  # every pixel counts, pad entries included
        reached = torch.cat([idx.reshape(-1) for _, idx, _, _ in chunks])
        assert bool((cnt_1[reached] == cfg.tile_pixels).all())


@pytest.mark.parametrize("cfg_id", list(CFGS))
@pytest.mark.parametrize("case", list(CASES))
def test_redesign_matches_plain(case, cfg_id):
    chunks, (args, ntx, cfg, mask) = masked_weights(case, cfg_id)
    e_total = args[0].shape[1]
    for thres in THRESHOLDS:
        imp, cnt, live, rounds = redesign(chunks, e_total, thres)
        imp_p, cnt_p = cp.composite_stats_plain(*args, mask, thres, ntx, cfg)
        assert float((imp - imp_p[0]).abs().max()) <= 1e-5 * float(imp_p.abs().max()), thres
        # counts may differ only where some w * mask lies within 1e-6 of thres
        _, lo = cp.composite_stats_plain(*args, mask, thres + 1e-6, ntx, cfg)
        _, hi = cp.composite_stats_plain(*args, mask, thres - 1e-6, ntx, cfg)
        assert bool(((cnt == cnt_p[0]) | ((cnt >= lo[0]) & (cnt <= hi[0]))).all()), thres
    rows = cp.stats_live_rows(*args, mask, ntx, cfg)
    assert (rows["live_rounds"], rows["rounds"]) == (live, rounds)
    assert 0 < rows["live_pairs"] < rows["pairs"]
    # the real entries of the chunks each tile reached
    real = sum(int(real.sum()) for _, _, real, _ in chunks)
    assert int(rows["reached"].sum()) == real


@pytest.mark.parametrize("cfg_id", list(JAX_CFGS))
@pytest.mark.parametrize("case", list(CASES))
def test_redesign_matches_reference(case, cfg_id):
    chunks, (args, ntx, cfg, mask) = masked_weights(case, cfg_id)
    entries, tile_start, tile_len = (a.numpy() for a in args)
    t_n = len(tile_start)
    mask_j = np.concatenate([mask.numpy()[:, None], np.zeros((t_n, 7, cfg.tile_pixels), np.float32)], axis=1)
    imp_j, cnt_j = j_composite_stats(jnp.asarray(entries), jnp.asarray(tile_start), jnp.asarray(tile_len),
                                     jnp.asarray(mask_j), t_n, ntx, JAX_CFGS[cfg_id], 0.03)
    imp, cnt, _, _ = redesign(chunks, entries.shape[1], 0.03)
    # the reference leaves the budget's tail past the last segment unwritten
    seg = np.zeros(entries.shape[1], bool)
    for s0, n in zip(tile_start, tile_len):
        seg[s0 : s0 + -(-n // cfg.chunk) * cfg.chunk] = True
    imp_j = np.asarray(imp_j)[0, seg]
    np.testing.assert_allclose(imp[seg].numpy(), imp_j, rtol=0, atol=1e-5 * np.abs(imp_j).max())
    np.testing.assert_array_equal(cnt[seg].numpy(), np.asarray(cnt_j)[0, seg])
