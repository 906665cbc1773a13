"""The compositor kernels' rooflines, counted from the work their inputs
need: the live (entry, pixel) pairs of each call, from the same entries
that were handed to the kernel, by this benchmark's own frozen alpha and
transmittance math (`reference/raster.py`), so that a kernel that culls
more work does not raise its own share.

A pair is live where its alpha > 0 and its entry lies in a chunk that its
tile composites (before the tile-wide stop). Operations a live pair needs,
from the method's plain math (counting each add, multiply, compare or
select, divide and exp as one):

- forward, 43: dx, dy (2); the power -0.5 (ca dx^2 + cc dy^2) - cb dx dy
  (9); its clamp, exp, times opacity, min with alpha_max, the cut (5); the
  plane depth pa px + pb py + pc, its reciprocal, times pd, clamped to two
  bounds (8); 1 - alpha, the running transmittance, alpha T (3); seven
  features and the depth, each w * f added up (16);
- backward, 94: the forward's alpha, depth and transmittance again (26);
  the cotangent q = sum of feature * cotangent plus depth * cotangent
  (16); dalpha from T q, the suffix sum and 1 - alpha (7); the active mask
  (2); dpow = dalpha alpha, dpow dx, dpow dy and the five moments with
  their sums (15); dopacity (2); seven feature gradients w g added up
  (14); the plane chain: w g_depth, times 1/denom, times t, and the sums
  of u px, u py, u, com and the depth fallback (12).

Bytes: each real entry's 18 compositor rows read once (the backward also
writes its 18 gradient rows), the tile tables, and each output pixel once:
10 values written by the forward; 9 cotangents and the final transmittance
and stop read by the backward. Peaks: NVIDIA's data sheet for the H100 SXM,
67 TFLOP/s FP32 (outside the tensor cores) and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import torch

from reference import raster

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FWD_OPS, BWD_OPS = 43, 94
ROWS = 18


def _raster_of(cfg) -> raster.Raster:
    return raster.Raster(tile_h=cfg.tile_h, tile_w=cfg.tile_w, chunk=cfg.chunk, alpha_cut=cfg.alpha_cut,
                         alpha_max=cfg.alpha_max, term_eps=cfg.term_eps, depth_lo=cfg.depth_lo,
                         depth_hi=cfg.depth_hi)


@torch.no_grad()
def live_pairs(entries, tile_start, tile_len, ntx: int, cfg, tpv=None, block_pairs: int = 1 << 23) -> dict:
    """{"live": live (entry, pixel) pairs, "real": real entries, "reached":
    real entries in the chunks composited, "tiles": T} of one call."""
    rc = _raster_of(cfg)
    k, pt = rc.chunk, rc.tile_h * rc.tile_w
    t_n = tile_start.shape[0]
    tpv = tpv or t_n
    lens = tile_len.to(torch.int64)
    starts = tile_start.to(torch.int64)
    order = torch.argsort(lens, descending=True)
    lens_s = lens[order].tolist()
    live = reached = 0
    i = 0
    dev = entries.device
    while i < t_n and lens_s[i] > 0:
        n = -(-lens_s[i] // k) * k
        tiles = order[i : i + max(1, block_pairs // (n * pt))]
        tiles = tiles[lens[tiles] > 0]
        ar = torch.arange(n, device=dev)[None, :]
        real = ar < lens[tiles, None]
        idx = torch.where(real, starts[tiles, None] + ar, 0)
        e = torch.where(real[..., None], entries[:ROWS, idx].permute(1, 2, 0), 0.0)
        px, py = raster.pixel_centres(tiles % tpv, ntx, rc)
        alpha, _ = raster.alpha_depth(e, px, py, rc)
        nch = -(-lens[tiles] // k)
        _, _, done = raster.weights(alpha, nch, rc)
        in_done = (ar // k) < done[:, None]
        live += int(((alpha > 0) & in_done[..., None]).sum())
        reached += int((real & in_done).sum())
        i += len(tiles)
    return {"live": live, "real": int(lens.sum()), "reached": reached, "tiles": t_n}


def least_seconds(kind: str, work: dict, pixels_per_tile: int) -> float:
    """The least time the chip needs for one call's work: the larger of its
    operations over the FP32 peak and its bytes over the HBM peak."""
    tiles_px = work["tiles"] * pixels_per_tile
    if kind == "fwd":
        ops = FWD_OPS * work["live"]
        nbytes = 4 * ROWS * work["real"] + 8 * work["tiles"] + 4 * 10 * tiles_px
    else:
        ops = BWD_OPS * work["live"]
        nbytes = 2 * 4 * ROWS * work["reached"] + 8 * work["tiles"] + 4 * 11 * tiles_px
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def flops(kind: str, work: dict) -> float:
    return (FWD_OPS if kind == "fwd" else BWD_OPS) * work["live"]
