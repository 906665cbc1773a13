"""The compositor kernels' fixed cost a tile (port of
`scripts/kernel_overhead.py`).

    python -m activegs_torch.scripts.kernel_overhead
    BENCH_RES=32 BENCH_GAUSSIANS=512 python -m activegs_torch.scripts.kernel_overhead device=cpu

Runs the forward kernel, and the forward and backward kernels together, on
the bench's keyframe-0 entry stream (the bench scene of BENCH_RES^2 and
BENCH_GAUSSIANS surfels at capacity 2^18, all of it, binned at the default
budget, as the reference builds it), twice: with the real `tile_len`, and
with `tile_len` zero everywhere, where no tile runs a chunk. The empty
tiles' time is what a tile costs whatever its entries (its launch share,
its block's set-up, the ordering kernel's share and its output's writes);
the difference is the pair work. The backward's cotangent is that of
sum(out[:, :9]) * 1e-3, the reference's readout.

Times: CUDA events around each call, the median of ITERS = 20 after a
warm-up; there is no dispatch time to subtract (the reference
subtracted the TPU's fixed 31 ms a jit call). Checks that the empty tiles
composite to transmittance 1 and zero colours, normals, depth and
confidence. Runs on the card unless given `device=cpu` (then the plain
versions, timed by the host clock). Prints the reference's lines and ends
with one JSON line: the fixed cost in µs a tile of the forward kernel
(`value`) and of both, and each time in ms a view.
"""

from __future__ import annotations

import torch

from ..mapping import gaussians as gm
from ..render import binning
from ..render import composite as cp
from ..render.renderer import _view_entries
from ..render.types import O_TRANS, Camera, RasterConfig
from . import bench, probe, profiling

ITERS = 20


@torch.no_grad()
def view_stream(res: int, n_gauss: int, device, rcfg: RasterConfig):
    """(entries, tile_start, tile_len, ntx) of the bench scene's keyframe 0,
    all of the map binned at its default budget."""
    cfg = gm.MapConfig(capacity=1 << 18, batch_size=bench.BATCH)
    state, buf = bench.build_scene(res, n_gauss, cfg, device=device)
    attrs = gm.attrs_of(state, cfg)
    cam = Camera(extrinsic=buf.extrinsics[0], intrinsic=buf.intrinsics[0])
    entries, b, _, _ = _view_entries(attrs, cam, (res, res), rcfg, False, None, None)
    _, _, ntx, _ = binning.bin_tile_dims((res, res), rcfg)
    return entries.contiguous(), b.tile_start, b.tile_len, ntx


@torch.no_grad()
def run_overhead(res: int, n_gauss: int, device) -> dict:
    """The four times (ms a view) and what they give a tile, and the empty
    tiles' outputs (`empty_*`: min and max transmittance, largest |value|
    of the other composited rows)."""
    rcfg = RasterConfig()
    ent, ts, tl, ntx = view_stream(res, n_gauss, device, rcfg)
    zeros = torch.zeros_like(tl)
    num_tiles = len(ts)

    def fwd(lens):
        return cp.composite_fwd(ent, ts, lens, ntx, rcfg)

    def fwd_bwd(lens):
        out = fwd(lens)
        gout = torch.zeros_like(out)
        gout[:, : O_TRANS + 1] = 1e-3  # d/d out of sum(out[:, :9]) * 1e-3
        return cp.composite_bwd(ent, ts, lens, out, gout, ntx, rcfg)

    empty = fwd(zeros)
    trans = empty[:, O_TRANS]
    rec = {
        "num_tiles": num_tiles, "entries": ent.shape[1], "real_entries": int(tl.sum()), "iters": ITERS,
        "empty_trans_min": float(trans.min()), "empty_trans_max": float(trans.max()),
        "empty_rows_abs_max": float(empty[:, :O_TRANS].abs().max()),
    }
    if rec["empty_trans_min"] != 1.0 or rec["empty_trans_max"] != 1.0 or rec["empty_rows_abs_max"] != 0.0:
        raise RuntimeError(f"empty tiles did not composite to transmittance 1 and zeros: {rec}")
    for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        rec[f"{name}_ms"] = probe.time_ms(lambda f=fn: f(tl), ITERS, device)
        rec[f"{name}_empty_ms"] = probe.time_ms(lambda f=fn: f(zeros), ITERS, device)
        rec[f"{name}_us_per_tile"] = rec[f"{name}_empty_ms"] / num_tiles * 1e3
    return rec


def main(argv: list[str] | None = None) -> dict:
    _, _, device = profiling.parse(argv)
    res, n_gauss, _ = profiling.bench_shape()
    rec = run_overhead(res, n_gauss, device)
    print(f"tiles={rec['num_tiles']} entries=({cp.PARAM_DIM}, {rec['entries']}) sum(len)={rec['real_entries']}")
    print(f"fwd real  {rec['fwd_ms']:7.3f} ms/view")
    print(f"fwd empty {rec['fwd_empty_ms']:7.3f} ms/view  ({rec['fwd_us_per_tile']:.2f} us/tile fixed)")
    print(f"fwd+bwd real  {rec['fwd_bwd_ms']:7.3f} ms/view")
    print(f"fwd+bwd empty {rec['fwd_bwd_empty_ms']:7.3f} ms/view ({rec['fwd_bwd_us_per_tile']:.2f} us/tile fixed both)")
    return profiling.emit({
        "metric": "composite_fixed_us_per_tile",
        "value": rec["fwd_us_per_tile"],
        "unit": "us/tile",
        **rec,
        "timing": profiling.event_timing(device, ITERS),
        "res": res, "gaussians": n_gauss,
        "device": profiling.card() if device.type == "cuda" else "cpu",
    })


if __name__ == "__main__":
    main()
