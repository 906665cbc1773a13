"""Tile compositor: the three hand-written CUDA kernels of `csrc/`, their
plain PyTorch versions, and the autograd function around fwd/bwd (port of
`activegs_tpu/render/composite_pallas.py`).

Layouts (shared by kernels and plain versions):
  entries   (PARAM_DIM, E) f32, per-tile K-aligned depth-sorted segments
            [tile_start, tile_start + tile_len); pad entries are zero rows;
  fwd out   (T, OUT_ROWS, P) f32, rows [r g b nx ny nz depth conf T stop 0..];
  bwd out   (PARAM_DIM, E) f32 per-entry gradients;
  stats out importance and count, each (1, E) f32.

A tile composites front to back in chunks of K entries and stops, for the
whole tile, once every pixel's transmittance is <= term_eps (checked only
between chunks); row `O_STOP` records the chunks done, which the backward
and stats replays depend on.

The forward and backward passes also take several views at once (`tpv`,
tiles per view, as the reference's static tuple has it): their tile tables
and entry streams concatenated, tile t is tile t % tpv of its view's grid.
`tpv=None` means one view (tpv = T). The stats kernel stays single-view, as
in the reference.

Each wrapper takes the plain version only for a CPU tensor. For a CUDA
tensor it launches its kernel (counted in `<kernel>.launches`) or raises.
Under `RasterConfig.bf16_pairs` it launches the kernel's bf16 instance
(`<kernel>_bf16`, exported by the same source).

Rounding contract of bf16 pair math (`cfg.bf16_pairs`), kept by the plain
versions and the kernels alike. It keeps every rounding point at which the
reference (`activegs_tpu/render/composite_pallas.py`) chooses bfloat16:
  alpha     dx, dy formed in float32, then they and the conic and opacity
            columns rounded to bf16; every product and sum of the power,
            exp (float32 exp of the bf16 power, rounded once), op * exp
            and the clamp at alpha_max (0.98828125 in bf16) rounded to
            bf16; the alpha_cut test on a float32 upcast;
  1 - alpha rounded to bf16;
  excl      the exclusive product of the chunk's 1 - alpha, run in float32
            in entry order and rounded to bf16 where used; the chunk's
            total product likewise rounded to bf16, then used in float32;
  fwd       w = bf16(bf16(alpha * excl) * bf16(T)); the 7 features rounded
            to bf16; the feature sums accumulate w * f in float32 (exact
            products), depth w * t in float32; T across chunks float32;
  bwd       the 7 feature cotangents and g_T * T_final rounded to bf16;
            t_k = bf16(bf16(T_before) * excl), w = bf16(alpha * t_k);
            q in float32 (bf16 features times bf16 cotangents plus t *
            g_depth), q_d = bf16(q); wq = bf16(w * q_d), summed in float32
            (the suffix over later entries is formed in float32 as total -
            inclusive sum, then rounded to bf16, and added to bf16(S) in
            bf16); dalpha, dpow = dalpha * alpha, dpow * dx, dpow * dy, the
            moment products and dalpha * exp all bf16, each reduced over
            the pixels in float32; the feature gradients sum w * g in
            float32; the depth-plane chain (w * g_depth onwards) float32;
  stats     w = float32(bf16(alpha * excl)) * T, then float32.
The reference forms excl by a Hillis-Steele doubling scan in bf16, a
grouping chosen for the TPU: its 7 levels round 7 times. A running product
rounded after every step would round up to K = 128 times (up to 128 x 2^-8
relative); the float32 running product rounded once at each use (within
2^-8) stays within the scan's envelope (`tests/test_torch_bf16.py`).
"""

from __future__ import annotations

import ctypes

import torch

from .. import tracing
from . import preprocess as pp
from ._build import CudaKernel
from .types import O_CONF, O_DEPTH, O_STOP, O_TRANS, OUT_ROWS, PARAM_DIM, USED_ROWS, RasterConfig

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
INT32_MAX = 2**31 - 1  # tile_start is int32, as in the reference
# the most pixels a tile may have: the backward and stats kernels run one
# thread a pixel in one block, and a block holds at most 1024 threads
MAX_TILE_PIXELS = 1024
# the most threads a block of the forward kernel takes (its launch bounds)
FWD_BLOCK_THREADS = 512
# common tail: ntx, tile_w, tile_h, K, alpha_cut, alpha_max, term_eps,
# depth_lo, depth_hi, stream
_TAIL = [_I, _I, _I, _I, _F, _F, _F, _F, _F, _P]
# the forward and backward kernels take the tiles per view after the tile
# count, the forward kernel then the cluster size
_FWD_ARGS = [_P, _LL, _P, _P, _P, _I, _I, _I] + _TAIL
_BWD_ARGS = [_P, _LL, _P, _P, _P, _P, _P, _P, _I, _I] + _TAIL
_STATS_ARGS = [_P, _LL, _P, _P, _P, _F, _P, _P, _P, _I] + _TAIL
fwd_kernel = CudaKernel("composite_fwd", _FWD_ARGS)
bwd_kernel = CudaKernel("composite_bwd", _BWD_ARGS)
stats_kernel = CudaKernel("composite_stats", _STATS_ARGS)
KERNELS = (fwd_kernel, bwd_kernel, stats_kernel)
# the bf16 pair-math instances (cfg.bf16_pairs), exported by the same sources
fwd_bf16_kernel = CudaKernel("composite_fwd", _FWD_ARGS, name="composite_fwd_bf16")
bwd_bf16_kernel = CudaKernel("composite_bwd", _BWD_ARGS, name="composite_bwd_bf16")
stats_bf16_kernel = CudaKernel("composite_stats", _STATS_ARGS, name="composite_stats_bf16")
BF16_KERNELS = (fwd_bf16_kernel, bwd_bf16_kernel, stats_bf16_kernel)


def _tail(ntx: int, cfg: RasterConfig, device) -> list:
    return [
        ntx, cfg.tile_w, cfg.tile_h, cfg.chunk, cfg.alpha_cut, pp.effective_alpha_max(cfg),
        cfg.term_eps, cfg.depth_lo, cfg.depth_hi,
        torch.cuda.current_stream(device).cuda_stream,
    ]


def views_tpv(num_tiles: int, tpv: int | None) -> int:
    """Tiles per view of a grid of `num_tiles` tiles: `tpv`, or `num_tiles`
    for None (one view). Refuses a `tpv` that does not divide the grid."""
    if tpv is None:
        return num_tiles
    if tpv <= 0 or num_tiles % tpv:
        raise ValueError(f"tiles per view {tpv} does not divide the {num_tiles} tiles of the grid")
    return tpv


def check_tile(cfg: RasterConfig) -> None:
    """Raises ValueError for a tile the kernels do not take: more than
    MAX_TILE_PIXELS pixels, a count that is not a multiple of 32, or one
    that the forward kernel cannot split (`fwd_cluster_size`), which leaves
    no forward pass for the other two to replay."""
    p = cfg.tile_pixels
    if p % 32 or p > MAX_TILE_PIXELS:
        raise ValueError(
            f"tile of {cfg.tile_h}x{cfg.tile_w} = {p} pixels: the kernels take a multiple of 32 pixels, "
            f"at most {MAX_TILE_PIXELS}"
        )
    fwd_cluster_size(cfg)


def _check(entries, tile_start, tile_len, cfg: RasterConfig, tpv: int | None = None, **tensors) -> tuple[int, int, int]:
    """Validate the kernels' inputs; returns (E, T, tiles per view)."""
    if entries.device.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, got {entries.device}")
    check_tile(cfg)
    p = cfg.tile_pixels
    if entries.dtype != torch.float32 or entries.dim() != 2 or entries.shape[0] != PARAM_DIM:
        raise ValueError(f"entries must be float32 ({PARAM_DIM}, E), got {entries.dtype} {tuple(entries.shape)}")
    e = entries.shape[1]
    if e % cfg.chunk:
        raise ValueError(f"entry count {e} is not a multiple of the chunk {cfg.chunk}")
    if e > INT32_MAX:
        raise ValueError(f"entry count {e}: the int32 tile_start offsets reach at most {INT32_MAX}")
    t = tile_start.shape[0]
    for name, x in (("tile_start", tile_start), ("tile_len", tile_len)):
        if x.dtype != torch.int32 or x.shape != (t,):
            raise ValueError(f"{name} must be int32 ({t},), got {x.dtype} {tuple(x.shape)}")
    shapes = {"out_fwd": (t, OUT_ROWS, p), "gout": (t, OUT_ROWS, p), "mask": (t, p)}
    for name, x in tensors.items():
        if x.dtype != torch.float32 or tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name} must be float32 {shapes[name]}, got {x.dtype} {tuple(x.shape)}")
    for x in (entries, tile_start, tile_len, *tensors.values()):
        if x.device != entries.device:
            raise ValueError("all inputs must be on one device")
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")
    return e, t, views_tpv(t, tpv)


# --------------------------------------------------------------------------
# plain PyTorch versions, vectorized over (tiles, K entries, P pixels)
# --------------------------------------------------------------------------


def tile_pixel_coords(num_tiles: int, ntx: int, cfg: RasterConfig, device, tpv: int | None = None):
    """Pixel-center coordinates (T, 1, P) of every tile; with `tpv`, tile t
    is tile t % tpv of its view's grid."""
    t = torch.arange(num_tiles, device=device)[:, None]
    if tpv is not None:
        t = t % views_tpv(num_tiles, tpv)
    pix = torch.arange(cfg.tile_pixels, device=device)[None, :]
    px = ((t % ntx) * cfg.tile_w + pix % cfg.tile_w).to(torch.float32) + 0.5
    py = ((t // ntx) * cfg.tile_h + pix // cfg.tile_w).to(torch.float32) + 0.5
    return px[:, None, :], py[:, None, :]


def _chunk(entries, tile_start, tile_len, tiles, chunk_idx, k: int, cut: bool = True):
    """Entry rows (A, n, USED_ROWS) and indices (A, n) of chunk `chunk_idx`
    (A,) of the tiles `tiles` (A,). With `cut`, n is the most real entries
    any of these tiles has in its chunk, not K: the entries past a tile's
    length are zero pad rows, which composite to alpha = 0 and add exactly
    nothing (and get zero gradients)."""
    first = tile_start[tiles].to(torch.int64) + chunk_idx * k
    n = k
    if cut:
        n = int(torch.clamp(tile_len[tiles].to(torch.int64) - chunk_idx * k, max=k).max())
    idx = first[:, None] + torch.arange(n, device=entries.device)
    return entries[:USED_ROWS, idx].permute(1, 2, 0), idx


def _feats(e):
    """(A, n, 7) composited features: colors, normals, confidence."""
    return torch.cat([e[..., 6:12], e[..., 16:17]], dim=-1)


def _running_product(x):
    """Inclusive product along dim 1, one float32 multiply per entry in
    entry order, as the kernels form it (`torch.cumprod` of float32 on the
    CPU accumulates in float64)."""
    out = torch.empty_like(x)
    run = torch.ones_like(x[:, 0])
    for j in range(x.shape[1]):
        run = run * x[:, j]
        out[:, j] = run
    return out


def _excl_total(alpha):
    """1 - alpha, the exclusive product of the chunk's 1 - alpha in entry
    order, and the chunk's total product (float32). Under bf16 pair math
    the product runs in float32 and excl and the total are rounded to bf16
    once (the rounding contract)."""
    one_m = 1.0 - alpha
    if alpha.dtype == torch.float32:
        cum = torch.cumprod(one_m, dim=1)
    else:
        cum = _running_product(one_m.float())
    excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1).to(alpha.dtype)
    return one_m, excl, cum[:, -1:].to(alpha.dtype).float()


def _live_tiles(c: int, nch, trans, cfg: RasterConfig):
    """Tiles that composite chunk c: c < nch and not yet stopped."""
    return torch.nonzero((c < nch) & (trans.amax(dim=(1, 2)) > cfg.term_eps)).squeeze(1)


def composite_fwd_plain(entries, tile_start, tile_len, ntx: int, cfg: RasterConfig, tpv: int | None = None):
    t_n, k = tile_start.shape[0], cfg.chunk
    dev = entries.device
    px, py = tile_pixel_coords(t_n, ntx, cfg, dev, tpv)
    nch = (tile_len.to(torch.int64) + k - 1) // k
    trans = torch.ones((t_n, 1, cfg.tile_pixels), device=dev)
    acc = torch.zeros((t_n, 8, cfg.tile_pixels), device=dev)
    done = torch.zeros(t_n, dtype=torch.int64, device=dev)
    for c in range(int(nch.max()) if t_n else 0):
        act = _live_tiles(c, nch, trans, cfg)
        if act.numel() == 0:
            break
        e, _ = _chunk(entries, tile_start, tile_len, act, c, k)
        alpha, tdep = pp.eval_alpha_depth_cols(pp.entry_cols(e), px[act], py[act], cfg)
        _, excl, total = _excl_total(alpha)
        wgt = (alpha * excl * trans[act].to(alpha.dtype)).float()
        ch = torch.bmm(_feats(e).to(alpha.dtype).float().transpose(1, 2), wgt)  # (A, 7, P)
        dsum = torch.sum(wgt * tdep, dim=1, keepdim=True)
        acc[act] = acc[act] + torch.cat([ch, dsum], dim=1)
        trans[act] = trans[act] * total
        done[act] += 1
    stop = done.to(torch.float32)[:, None, None].expand_as(trans)
    zeros = torch.zeros((t_n, OUT_ROWS - 10, cfg.tile_pixels), device=dev)
    return torch.cat([acc[:, 0:6], acc[:, 7:8], acc[:, 6:7], trans, stop, zeros], dim=1)


def composite_bwd_plain(
    entries, tile_start, tile_len, out_fwd, gout, ntx: int, cfg: RasterConfig, tpv: int | None = None
):
    t_n, k = tile_start.shape[0], cfg.chunk
    dev = entries.device
    px, py = tile_pixel_coords(t_n, ntx, cfg, dev, tpv)
    dt = pp.pair_dtype(cfg)
    stop = out_fwd[:, O_STOP, 0].to(torch.int64)
    # (T, 7, P) in the pair dtype's values
    g_feat = torch.cat([gout[:, 0:6], gout[:, O_CONF : O_CONF + 1]], dim=1).to(dt).float()
    g_depth = gout[:, O_DEPTH : O_DEPTH + 1]
    t_final = out_fwd[:, O_TRANS : O_TRANS + 1]
    gtf = (gout[:, O_TRANS : O_TRANS + 1] * t_final).to(dt)
    t_after = t_final.clone()
    s_q = torch.zeros_like(t_final)
    dentries = torch.zeros_like(entries)
    for r in range(int(stop.max()) if t_n else 0):
        ci = stop - 1 - r
        act = torch.nonzero(ci >= 0).squeeze(1)
        e, idx = _chunk(entries, tile_start, tile_len, act, ci[act], k)
        cols = pp.entry_cols(e)
        pxa, pya, gfa, gda = px[act], py[act], g_feat[act], g_depth[act]
        terms = pp.eval_pair_terms_bwd(cols, pxa, pya, cfg)
        alpha = terms["alpha"]
        one_m, excl, total = _excl_total(alpha)
        t_before = t_after[act] / torch.clamp(total, min=1e-30)
        t_k = t_before.to(dt) * excl
        wgt = alpha * t_k
        q = torch.bmm(_feats(e).to(dt).float(), gfa) + terms["t"] * gda  # (A, n, P) f32
        q_d = q.to(dt)
        wq = (wgt * q_d).float()
        tot_wq = torch.sum(wq, dim=1, keepdim=True)
        suffix = s_q[act].to(dt) + (tot_wq - torch.cumsum(wq, dim=1)).to(dt)  # entries after k
        dalpha = t_k * q_d - (suffix + gtf[act]) * (1.0 / torch.clamp(one_m, min=0.01))
        af = alpha.float()
        dalpha = torch.where((af > 0.0) & (af < pp.effective_alpha_max(cfg)), dalpha, 0.0)

        dx, dy = terms["dx"], terms["dy"]
        dpow = dalpha * alpha
        t1 = dpow * dx
        t2 = dpow * dy
        s_x, s_y = t1.float().sum(-1), t2.float().sum(-1)
        s_xx, s_xy, s_yy = ((t1 * dx).float().sum(-1), (t1 * dy).float().sum(-1), (t2 * dy).float().sum(-1))
        ca, cb, cc = cols["ca"][..., 0], cols["cb"][..., 0], cols["cc"][..., 0]
        wgt = wgt.float()
        dfeat = torch.bmm(wgt, gfa.transpose(1, 2))  # (A, n, 7)
        wgd = wgt * gda
        inside = terms["inside"]
        com = torch.where(inside, wgd * terms["inv_denom"], 0.0)
        u = com * terms["t_raw"]
        ddz = torch.where(inside, 0.0, wgd * terms["t"]).sum(-1) / torch.clamp(
            cols["dz"][..., 0], min=1e-30
        )
        dcols = torch.stack(
            [
                ca * s_x + cb * s_y,
                cb * s_x + cc * s_y,
                -0.5 * s_xx,
                -s_xy,
                -0.5 * s_yy,
                (dalpha * terms["ex"]).float().sum(-1),
                *dfeat[..., 0:6].unbind(-1),
                -(u * pxa).sum(-1),
                -(u * pya).sum(-1),
                -u.sum(-1),
                com.sum(-1),
                dfeat[..., 6],
                ddz,
            ],
            dim=-1,
        )  # (A, n, 18)
        dentries[:USED_ROWS, idx.reshape(-1)] = dcols.reshape(-1, USED_ROWS).T
        t_after[act] = t_before
        s_q[act] = s_q[act] + tot_wq
    return dentries


def live_warp_rows(
    entries, tile_start, tile_len, stop, ntx: int, cfg: RasterConfig, tpv: int | None = None
) -> tuple[int, int]:
    """What the forward and backward kernels' culls keep, in plain PyTorch:
    of the (entry, 32-pixel row) pairs of each tile's real entries in the
    chunks it reached (`stop`, (T,)), how many have some alpha > 0. A
    32-pixel row is one warp of the kernels. Returns (live, all)."""
    t_n, k = tile_start.shape[0], cfg.chunk
    px, py = tile_pixel_coords(t_n, ntx, cfg, entries.device, tpv)
    stop = stop.to(torch.int64)
    live = 0
    for c in range(int(stop.max()) if t_n else 0):
        act = torch.nonzero(stop > c).squeeze(1)
        e, _ = _chunk(entries, tile_start, tile_len, act, c, k)
        alpha, _ = pp.eval_alpha_depth_cols(pp.entry_cols(e), px[act], py[act], cfg)
        live += int((alpha > 0.0).reshape(*alpha.shape[:2], -1, 32).any(-1).sum())
    real = int(torch.minimum(tile_len.to(torch.int64), stop * k).sum())
    return live, real * cfg.tile_pixels // 32


def _stats_chunks(entries, tile_start, tile_len, mask, ntx: int, cfg: RasterConfig, cut: bool = True):
    """The stats replay, chunk by chunk, with the forward pass's tile-wide
    stop: yields the tiles (A,) that composite each chunk, the chunk's
    entry indices (A, n) and the masked weights w * mask of its pairs
    (A, n, P), float32. With `cut`, n is the most real entries any of
    these tiles has in the chunk, else K."""
    t_n, k = tile_start.shape[0], cfg.chunk
    dev = entries.device
    px, py = tile_pixel_coords(t_n, ntx, cfg, dev)
    nch = (tile_len.to(torch.int64) + k - 1) // k
    trans = torch.ones((t_n, 1, cfg.tile_pixels), device=dev)
    m = mask[:, None, :]
    for c in range(int(nch.max()) if t_n else 0):
        act = _live_tiles(c, nch, trans, cfg)
        if act.numel() == 0:
            break
        e, idx = _chunk(entries, tile_start, tile_len, act, c, k, cut=cut)
        alpha, _ = pp.eval_alpha_depth_cols(pp.entry_cols(e), px[act], py[act], cfg)
        _, excl, total = _excl_total(alpha)
        yield act, idx, (alpha * excl).float() * trans[act] * m[act]
        trans[act] = trans[act] * total


def composite_stats_plain(entries, tile_start, tile_len, mask, weight_thres: float, ntx: int, cfg: RasterConfig):
    imp = torch.zeros((1, entries.shape[1]), device=entries.device)
    cnt = torch.zeros((1, entries.shape[1]), device=entries.device)
    # a threshold <= 0 counts the zero weights of pad entries too
    for _, idx, wm in _stats_chunks(entries, tile_start, tile_len, mask, ntx, cfg, cut=weight_thres > 0):
        imp[0, idx.reshape(-1)] = wm.sum(-1).reshape(-1)
        cnt[0, idx.reshape(-1)] = (wm >= weight_thres).to(torch.float32).sum(-1).reshape(-1)
    return imp, cnt


STATS_ROUND = 32  # entries of a round of the stats kernel's warp sums


def stats_live_rows(entries, tile_start, tile_len, mask, ntx: int, cfg: RasterConfig) -> dict:
    """What the stats kernel's replay reaches and what its warp cull keeps,
    in plain PyTorch. Returns {"reached": the real entries each tile's
    replay reaches (T,), min(tile_len, chunks done * K); "live_pairs",
    "pairs": the (entry, 32-pixel row) pairs of those entries with some
    w * mask != 0, and all of them; "live_rounds", "rounds": the (round,
    32-pixel row) pairs with some w * mask != 0, and all of them, where a
    chunk's real entries go in rounds of STATS_ROUND}. The kernel culls a
    (round, row) whose sums are all +-0: the same pairs where w * mask >= 0."""
    t_n, k, p = tile_start.shape[0], cfg.chunk, cfg.tile_pixels
    nround = -(-k // STATS_ROUND)
    done = torch.zeros(t_n, dtype=torch.int64, device=entries.device)
    live_pairs = live_rounds = rounds = 0
    for act, idx, wm in _stats_chunks(entries, tile_start, tile_len, mask, ntx, cfg, cut=False):
        done[act] += 1
        nz = (wm != 0.0).reshape(len(act), k, p // 32, 32).any(-1)  # (A, K, rows); pad entries never
        live_pairs += int(nz.sum())
        nz = torch.cat([nz, nz.new_zeros((len(act), nround * STATS_ROUND - k, p // 32))], dim=1)
        live_rounds += int(nz.reshape(len(act), nround, STATS_ROUND, -1).any(2).sum())
        real = (idx - tile_start[act, None] < tile_len[act, None]).sum(1)
        rounds += int((-(-real // STATS_ROUND)).sum()) * (p // 32)
    reached = torch.minimum(tile_len.to(torch.int64), done * k)
    return {"reached": reached, "live_pairs": live_pairs, "pairs": int(reached.sum()) * (p // 32),
            "live_rounds": live_rounds, "rounds": rounds}


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def fwd_cluster_size(cfg: RasterConfig) -> int:
    """Blocks of the thread-block cluster that renders one tile in the
    forward kernel, each taking P / C consecutive pixels of the tile's
    row-major P: the largest C of 4, 2, 1 that leaves a multiple of 32
    pixels a block and at most FWD_BLOCK_THREADS. Raises ValueError for a
    tile none of them splits so (more than 512 pixels in an odd number of
    warps)."""
    p = cfg.tile_pixels
    for c in (4, 2, 1):
        if p % c == 0 and (p // c) % 32 == 0 and p // c <= FWD_BLOCK_THREADS:
            return c
    raise ValueError(
        f"tile of {cfg.tile_h}x{cfg.tile_w} = {p} pixels: the forward kernel splits a tile over a cluster of 4, 2 "
        f"or 1 blocks of whole warps and at most {FWD_BLOCK_THREADS} threads, and none splits {p // 32} warps so"
    )


@tracing.span("render.composite_fwd")
def composite_fwd(entries, tile_start, tile_len, ntx: int, cfg: RasterConfig, tpv: int | None = None):
    """Forward composite -> (T, OUT_ROWS, P), over views of `tpv` tiles
    each (None: one view). Kernel: csrc/composite_fwd.cu (its bf16 instance
    under cfg.bf16_pairs), launched as one cluster of
    `fwd_cluster_size(cfg)` blocks per tile."""
    if entries.device.type == "cpu":
        return composite_fwd_plain(entries, tile_start, tile_len, ntx, cfg, tpv)
    e, t, tpv = _check(entries, tile_start, tile_len, cfg, tpv)
    out = torch.empty((t, OUT_ROWS, cfg.tile_pixels), dtype=torch.float32, device=entries.device)
    (fwd_bf16_kernel if cfg.bf16_pairs else fwd_kernel).launch(
        entries.data_ptr(), e, tile_start.data_ptr(), tile_len.data_ptr(), out.data_ptr(), t, tpv,
        fwd_cluster_size(cfg), *_tail(ntx, cfg, entries.device),
    )
    return out


def composite_bwd(entries, tile_start, tile_len, out_fwd, gout, ntx: int, cfg: RasterConfig, tpv: int | None = None):
    """Per-entry gradients (PARAM_DIM, E) from the output cotangent `gout`,
    over views of `tpv` tiles each. Kernel: csrc/composite_bwd.cu."""
    if entries.device.type == "cpu":
        return composite_bwd_plain(entries, tile_start, tile_len, out_fwd, gout, ntx, cfg, tpv)
    e, t, tpv = _check(entries, tile_start, tile_len, cfg, tpv, out_fwd=out_fwd, gout=gout)
    # zeros: the kernel writes rows 0..17 of the chunks the forward pass
    # reached; unreached chunks, rows 18..23 and the budget's tail stay zero
    dentries = torch.zeros_like(entries)
    # scratch: the order in which the kernel's blocks take the tiles
    order = torch.empty(t, dtype=torch.int32, device=entries.device)
    (bwd_bf16_kernel if cfg.bf16_pairs else bwd_kernel).launch(
        entries.data_ptr(), e, tile_start.data_ptr(), tile_len.data_ptr(), out_fwd.data_ptr(),
        gout.data_ptr(), dentries.data_ptr(), order.data_ptr(), t, tpv, *_tail(ntx, cfg, entries.device),
    )
    return dentries


@tracing.span("render.composite_stats")
def composite_stats(entries, tile_start, tile_len, mask, weight_thres: float, ntx: int, cfg: RasterConfig):
    """Per-entry (importance, count), each (1, E): importance = sum over the
    tile's pixels of w * mask, count = #pixels with w * mask >= weight_thres.
    `mask` is (T, P). Kernel: csrc/composite_stats.cu."""
    if entries.device.type == "cpu":
        return composite_stats_plain(entries, tile_start, tile_len, mask, weight_thres, ntx, cfg)
    e, _, _ = _check(entries, tile_start, tile_len, cfg, mask=mask)
    # zeros: the kernel writes only the chunks its replay reaches
    imp = torch.zeros((1, e), dtype=torch.float32, device=entries.device)
    cnt = torch.zeros((1, e), dtype=torch.float32, device=entries.device)
    # scratch: the order in which the kernel's blocks take the tiles
    order = torch.empty(len(tile_start), dtype=torch.int32, device=entries.device)
    (stats_bf16_kernel if cfg.bf16_pairs else stats_kernel).launch(
        entries.data_ptr(), e, tile_start.data_ptr(), tile_len.data_ptr(), mask.data_ptr(), weight_thres,
        imp.data_ptr(), cnt.data_ptr(), order.data_ptr(), len(tile_start), *_tail(ntx, cfg, entries.device),
    )
    return imp, cnt


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, entries, tile_start, tile_len, ntx, cfg, tpv):
        out = composite_fwd(entries, tile_start, tile_len, ntx, cfg, tpv)
        ctx.save_for_backward(entries, tile_start, tile_len, out)
        ctx.ntx, ctx.cfg, ctx.tpv = ntx, cfg, tpv
        return out

    @staticmethod
    @tracing.span("render.composite_bwd")
    def backward(ctx, gout):
        entries, tile_start, tile_len, out = ctx.saved_tensors
        dentries = composite_bwd(
            entries, tile_start, tile_len, out, gout.contiguous(), ctx.ntx, ctx.cfg, ctx.tpv
        )
        return dentries, None, None, None, None, None


def composite(entries, tile_start, tile_len, ntx: int, cfg: RasterConfig, tpv: int | None = None):
    """Differentiable tile composite (fwd kernel forward, bwd kernel
    backward), over views of `tpv` tiles each (None: one view)."""
    return _Composite.apply(entries, tile_start, tile_len, ntx, cfg, tpv)
