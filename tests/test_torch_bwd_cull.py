"""The invariant the backward kernel's warp cull rests on, on the CPU.

`render/csrc/composite_bwd.cu` skips an (entry, 32-pixel row) pair, one
warp of the kernel, where no pixel of the row has alpha > 0, in both of its
passes. That is exact only if each of the 18 per-pair terms that
`composite.composite_bwd_plain` sums over a tile's pixels is then exactly
+-0. The kernel cannot run here, so this file rebuilds those terms from
`preprocess.eval_pair_terms_bwd` and the plain version's expressions
(checking that their sums give the plain version's gradients), and shows on
the reference's 64x64 scenes and on a scene made to corner the cull
(`test_torch_gpu.small_surfel_scene`, which the card test also runs):

- where every alpha of a row is 0, every term is +-0 at every pixel of it;
- at alpha == alpha_max, where dalpha is masked, the feature terms are not
  zero, so the cull must test alpha > 0 and not the dalpha mask.

Both hold for bf16 pair math too (`bf16`: K = 128, `bf16_pairs`; the terms
are rebuilt in the rounding contract of `render/composite.py`, and the
clamp is alpha_max rounded to bf16), for a 1024-pixel tile (`t32x32`) and
for a tile 16 pixels wide (`t8x16`), where a 32-pixel row of the kernel
(one warp) spans two pixel rows of the tile.
"""

import dataclasses

import numpy as np
import pytest
import torch

from activegs_torch.render import composite as cp
from activegs_torch.render import preprocess as pp
from activegs_torch.render import types as tt
from test_render import CFG, CFG_SMALL_CHUNK
from test_torch_core import t_attrs, t_like
from test_torch_gpu import scene_entries, small_surfel_scene
from test_torch_render import SCENES

CFGS = {"k128": t_like(tt.RasterConfig, CFG), "k8": t_like(tt.RasterConfig, CFG_SMALL_CHUNK)}
CFGS["bf16"] = dataclasses.replace(CFGS["k128"], bf16_pairs=True)
# a 1024-pixel tile (32x32: 32 warps, a block of 1024 threads) and a
# tile 16 pixels wide (8x16: a warp spans two pixel rows)
CFGS["t32x32"] = dataclasses.replace(CFGS["k128"], tile_h=32, tile_w=32)
CFGS["t8x16"] = dataclasses.replace(CFGS["k128"], tile_h=8, tile_w=16)
CASES = {
    "random": lambda: t_attrs(SCENES["random"]()),
    "opaque": lambda: t_attrs(SCENES["opaque"]()),
    "small_surfels": lambda: small_surfel_scene(torch.device("cpu")),
}
FEATURE_TERMS = [6, 7, 8, 9, 10, 11, 16]


def pair_terms(entries, tile_start, tile_len, out_fwd, gout, ntx: int, cfg):
    """`composite_bwd_plain`'s replay, chunk by chunk, stopped before its
    pixel sums. Yields per replayed chunk the entry ids (A, n), alpha and
    op * exp(power) (A, n, P), t_k (A, n, P) and the 18 per-pair terms
    (A, n, 18, P) in the kernel's column order, with the entries' columns;
    all as float32 (alpha, op * exp(power) and t_k hold pair-dtype values)."""
    t_n, k = tile_start.shape[0], cfg.chunk
    dt = pp.pair_dtype(cfg)
    px, py = cp.tile_pixel_coords(t_n, ntx, cfg, entries.device)
    stop = out_fwd[:, tt.O_STOP, 0].to(torch.int64)
    g_feat = torch.cat([gout[:, 0:6], gout[:, tt.O_CONF : tt.O_CONF + 1]], dim=1).to(dt).float()
    g_depth = gout[:, tt.O_DEPTH : tt.O_DEPTH + 1]
    t_final = out_fwd[:, tt.O_TRANS : tt.O_TRANS + 1]
    gtf = (gout[:, tt.O_TRANS : tt.O_TRANS + 1] * t_final).to(dt)
    t_after = t_final.clone()
    s_q = torch.zeros_like(t_final)
    for r in range(int(stop.max())):
        ci = stop - 1 - r
        act = torch.nonzero(ci >= 0).squeeze(1)
        e, idx = cp._chunk(entries, tile_start, tile_len, act, ci[act], k)
        cols = pp.entry_cols(e)
        pxa, pya, gfa, gda = px[act], py[act], g_feat[act], g_depth[act]
        terms = pp.eval_pair_terms_bwd(cols, pxa, pya, cfg)
        alpha = terms["alpha"]
        one_m, excl, total = cp._excl_total(alpha)
        t_before = t_after[act] / torch.clamp(total, min=1e-30)
        t_k = t_before.to(dt) * excl
        wgt = alpha * t_k
        q = torch.bmm(cp._feats(e).to(dt).float(), gfa) + terms["t"] * gda
        q_d = q.to(dt)
        wq = (wgt * q_d).float()
        tot_wq = torch.sum(wq, dim=1, keepdim=True)
        suffix = s_q[act].to(dt) + (tot_wq - torch.cumsum(wq, dim=1)).to(dt)
        dalpha = t_k * q_d - (suffix + gtf[act]) * (1.0 / torch.clamp(one_m, min=0.01))
        af = alpha.float()
        dalpha = torch.where((af > 0.0) & (af < pp.effective_alpha_max(cfg)), dalpha, 0.0)
        dx, dy = terms["dx"], terms["dy"]
        dpow = dalpha * alpha
        t1, t2 = dpow * dx, dpow * dy
        wgt = wgt.float()
        wgd = wgt * gda
        inside = terms["inside"]
        com = torch.where(inside, wgd * terms["inv_denom"], 0.0)
        u = com * terms["t_raw"]
        gf = [gfa[:, c : c + 1] for c in range(7)]
        per_pair = [
            t1, t2, t1 * dx, t1 * dy, t2 * dy, dalpha * terms["ex"],
            *(wgt * gf[c] for c in range(6)),
            -(u * pxa), -(u * pya), -u, com, wgt * gf[6],
            torch.where(inside, 0.0, wgd * terms["t"]),
        ]
        raw = (cols["op"].to(dt) * terms["ex"]).float()
        yield idx, af, raw, t_k.float(), torch.stack([x.float() for x in per_pair], dim=2), cols
        t_after[act] = t_before
        s_q[act] = s_q[act] + tot_wq


def epilogue(s, cols):
    """The 18 gradient columns (A, n, 18) from the terms' pixel sums."""
    ca, cb, cc, dz = (cols[n][..., 0] for n in ("ca", "cb", "cc", "dz"))
    sx, sy = s[..., 0], s[..., 1]
    out = s.clone()
    out[..., 0] = ca * sx + cb * sy
    out[..., 1] = cb * sx + cc * sy
    out[..., 2] = -0.5 * s[..., 2]
    out[..., 3] = -s[..., 3]
    out[..., 4] = -0.5 * s[..., 4]
    out[..., 17] = s[..., 17] / torch.clamp(dz, min=1e-30)
    return out


@pytest.mark.parametrize("cfg_id", list(CFGS))
@pytest.mark.parametrize("case", list(CASES))
def test_culled_rows_add_nothing(case, cfg_id):
    cfg = CFGS[cfg_id]
    args, ntx = scene_entries(CASES[case](), cfg, torch.device("cpu"))
    out = cp.composite_fwd(*args, ntx, cfg)
    gout = torch.from_numpy(np.random.default_rng(3).normal(size=out.shape).astype(np.float32))
    gout[:, tt.O_TRANS + 1 :] = 0.0
    want = cp.composite_bwd_plain(*args, out, gout, ntx, cfg)

    got = torch.zeros_like(want)
    dead_rows = live_rows = at_max = 0
    near_cut = [0, 0]  # alpha kept within 5% above the cut; op * exp cut within 5% below it
    for idx, alpha, raw, t_k, terms, cols in pair_terms(*args, out, gout, ntx, cfg):
        got[: tt.USED_ROWS, idx.reshape(-1)] = epilogue(terms.sum(-1), cols).reshape(-1, tt.USED_ROWS).T
        rows = alpha.shape[:2] + (-1, 32)
        dead = ~(alpha > 0.0).reshape(rows).any(-1)  # (A, n, rows of 32 pixels)
        by_row = terms.reshape(*alpha.shape[:2], tt.USED_ROWS, *rows[2:]).permute(0, 1, 3, 2, 4)
        assert not by_row[dead].any(), "a row with no alpha > 0 has a nonzero per-pair term"
        dead_rows += int(dead.sum())
        live_rows += int((~dead).sum())
        # at alpha_max dalpha is masked (terms 0..5 vanish), w is not
        top = (alpha == pp.effective_alpha_max(cfg)) & (t_k > 0.0)
        at_max += int(top.sum())
        assert not terms.permute(0, 1, 3, 2)[top][:, :6].any()
        assert bool((terms.permute(0, 1, 3, 2)[top][:, FEATURE_TERMS] != 0.0).all())
        near_cut[0] += int(((alpha >= cfg.alpha_cut) & (alpha < 1.05 * cfg.alpha_cut)).sum())
        near_cut[1] += int(((raw < cfg.alpha_cut) & (raw >= 0.95 * cfg.alpha_cut)).sum())
    # the rebuilt terms are the ones the plain version sums
    for r in range(tt.USED_ROWS):
        assert float((got[r] - want[r]).abs().max()) <= 1e-5 * float(want[r].abs().max()) + 1e-12, r
    assert dead_rows > 0 and live_rows > 0
    assert cp.live_warp_rows(*args, out[:, tt.O_STOP, 0], ntx, cfg)[0] == live_rows
    assert min(near_cut) > 0
    if case == "small_surfels":
        # what the scene is for: most rows culled, alpha at alpha_max, tiles
        # that stop early, and pad entries in the chunks replayed
        stop, tile_len = out[:, tt.O_STOP, 0], args[2].to(torch.int64)
        assert dead_rows > live_rows and at_max > 0
        assert bool((stop < (tile_len + cfg.chunk - 1) // cfg.chunk).any())
        assert bool((tile_len < stop * cfg.chunk).any())
