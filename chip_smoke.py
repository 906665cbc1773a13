"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the three tile-compositor kernels of `activegs_torch/render/csrc/`
(one nvcc per source, all started together), then:

1. drives the mapping step (spawn -> keyframe view stats -> train_keyframe
   -> stats budgets -> post_process -> write back) for 5 keyframes of the
   boxroom simulator at 512 x 512 with the default `MapConfig` (capacity
   2^19, 8 views x 10 Adam steps) and `RasterConfig`; keyframe 5 prunes.
   The launch counters are zeroed just before and read just after;
2. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (keyframe-5 state), and a whole `batch_loss` value
   and its gradients, kernel path against plain path;
3. times each kernel and its plain version with CUDA events.

It prints a `kernels` JSON line, the card's name and power limit, and ends
with one JSON line {"ok": true, "device": {...}}. It exits non-zero, with no
result, when there is no CUDA device, when the port is not beside it, or
when any check fails. It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

KEYFRAMES = 5
RES = 512
POS = (3.0, 2.5, 1.5)
YAW_DEG = (-40.0, -20.0, 0.0, 20.0, 40.0)  # turning around POS, +x wall first
SEED = 0
TIMED_LAUNCHES = 25
PLAIN_RUNS = 5

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 operations per (entry, pixel) pair the function needs, counted from
# the kernels' arithmetic (a multiply-add is 2, expf and a division 1 each);
# recomputation and reduction trees that a design adds are not counted
OPS_PER_PAIR = {"composite_fwd": 50, "composite_bwd": 105, "composite_stats": 25}
REPLACES = {
    "composite_fwd": "activegs_tpu/render/composite_pallas.py:179",
    "composite_bwd": "activegs_tpu/render/composite_pallas.py:297",
    "composite_stats": "activegs_tpu/render/composite_pallas.py:522",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    return -10.0 * math.log10(float(torch.mean((a - b) ** 2)) + 1e-8)


def poses(dev):
    from activegs_torch.core import geometry as geo

    out = []
    for yaw in YAW_DEG:
        r = math.radians(yaw)
        target = (POS[0] + 2.5 * math.cos(r), POS[1] + 2.5 * math.sin(r), POS[2] - 0.3)
        out.append(geo.look_at(POS, target, device=dev))
    return out


def main_path(dev):
    """Phase 2: KEYFRAMES mapping steps at full width. Returns (state, buf,
    {kernel: launches in the run}, map config, raster config)."""
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import keyframes as kf
    from activegs_torch.mapping.mapper import mapping_step
    from activegs_torch.render import composite as cp
    from activegs_torch.render.renderer import render_view
    from activegs_torch.render.types import Camera, RasterConfig
    from activegs_torch.sim.synthetic import BoxRoomSimulator

    cfg, rcfg = gm.MapConfig(), RasterConfig()
    sim = BoxRoomSimulator(resolution=(RES, RES), seed=SEED, device=dev)
    frames = [sim.simulate(p) for p in poses(dev)]

    def render_psnr(state, f):
        o, _ = render_view(gm.attrs_of(state, cfg), Camera(f["extrinsic"], f["intrinsic"]), (RES, RES), rcfg)
        return psnr(o.rgb, f["rgb"])

    # keyframe 1's map before any training: its spawn alone
    spawned, _, _ = gm.spawn(gm.init_state(cfg, dev), frames[0], cfg, rcfg)
    psnr_before = render_psnr(spawned, frames[0])
    del spawned

    state = gm.init_state(cfg, dev)
    buf = kf.init_buffer(256, RES, RES, device=dev)
    gen = torch.Generator().manual_seed(SEED)
    counts = []
    for k in cp.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        state, buf, st = mapping_step(state, buf, f, cfg, rcfg, gen)
        counts.append(st["n_gaussians"])
        pt = " ".join(f"{k} {v:.3f}s" for k, v in st["phase_times"].items())
        print(
            f"keyframe {i + 1}: loss {st['loss']:.5f} gaussians {st['n_gaussians']} "
            f"(+{st['n_new']}/-{st['n_pruned']}) num_dropped {st['num_dropped']} "
            f"entry_budget {st['entry_budget']} subset_bucket {st['subset_bucket']} | {pt}"
        )
        check(math.isfinite(st["loss"]), f"keyframe {i + 1}: loss {st['loss']}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.source: k.launches for k in cp.KERNELS}
    print(f"main path: {KEYFRAMES} keyframes in {wall:.2f} s, launches {launches}")
    check(all(b > a for a, b in zip(counts[:-2], counts[1:-1])), f"gaussian count did not grow: {counts}")
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched on the main path: {launches}")
    psnr_after = render_psnr(state, frames[0])
    print(f"keyframe-1 pose PSNR: spawn only {psnr_before:.3f} dB, after the run {psnr_after:.3f} dB")
    check(psnr_after > psnr_before, "training did not raise PSNR at keyframe 1's pose")
    return state, buf, launches, cfg, rcfg


def real_pairs(tile_len: torch.Tensor, stop: torch.Tensor, k: int, p: int) -> int:
    """(entry, pixel) pairs the function needs: each tile's real entries in
    the chunks it reached, min(tile_len, stop * K), times its P pixels (the
    zero pad rows that fill a tile's last chunk are not counted)."""
    return int(torch.minimum(tile_len.to(torch.int64), stop.to(torch.int64) * k).sum()) * p


def scaled_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))


def compare(state, buf, cfg, rcfg):
    """Phase 3: kernels against plain versions at the main path's shapes.
    Returns ({kernel: max abs error}, {kernel: (kernel call, plain call,
    (entry, pixel) pairs reached, bytes moved)})."""
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import keyframes as kf
    from activegs_torch.mapping import trainer
    from activegs_torch.render import binning, renderer
    from activegs_torch.render import composite as cp
    from activegs_torch.render import preprocess as pp
    from activegs_torch.render.types import O_DEPTH, O_STOP, O_TRANS, Camera

    dev = state.means.device
    sub = gm.slice_state(state, gm.bucket_capacity(state.count, cfg.capacity))
    attrs = gm.attrs_of(sub, cfg)
    latest = buf.count - 1
    _, depth, ext, intr = kf.decode_frames(buf, torch.tensor([latest], device=dev))
    cam = Camera(ext[0], intr[0])
    shape = (RES, RES)
    _, _, ntx, _ = binning.bin_tile_dims(shape, rcfg)
    plain = (
        mock.patch.object(cp, "composite_fwd", cp.composite_fwd_plain),
        mock.patch.object(cp, "composite_bwd", cp.composite_bwd_plain),
    )
    res = {}

    # forward, on the training render's entry stream
    p2d, _, dz, iv = pp.preprocess(attrs, cam, shape, rcfg)
    budget = trainer.pick_entry_bucket(int(binning.entry_count(p2d, iv, shape, rcfg)))
    b = binning.bin_entries(p2d.detach(), dz.detach(), iv, shape, rcfg, budget)
    ent = renderer.gather_entries(p2d.detach(), b.gid)
    o_k = cp.composite_fwd(ent, b.tile_start, b.tile_len, ntx, rcfg)
    o_p = cp.composite_fwd_plain(ent, b.tile_start, b.tile_len, ntx, rcfg)
    img_rows = [r for r in range(O_TRANS + 1) if r != O_DEPTH]
    e_img = float((o_k[:, img_rows] - o_p[:, img_rows]).abs().max())
    e_dep = float((o_k[:, O_DEPTH] - o_p[:, O_DEPTH]).abs().max())
    print(f"fwd: E {ent.shape[1]} tiles {len(b.tile_start)} image err {e_img:.3g} depth err {e_dep:.3g}")
    check(e_img <= 2e-5 and e_dep <= 1e-4, "fwd kernel disagrees with its plain version")
    check(torch.equal(o_k[:, O_STOP], o_p[:, O_STOP]), "fwd kernel stops at other chunks than its plain version")
    res["composite_fwd"] = max(e_img, e_dep)

    # backward, through the autograd function: parameter grads of a loss
    # with seeded random weights on every output channel
    g = torch.Generator(device=dev).manual_seed(SEED)
    wts = [torch.randn((c, RES, RES), generator=g, device=dev) for c in (3, 1, 3, 1)]
    names = ("means", "scales", "rotations", "opacities", "colors")

    def attr_grads():
        leaves = {n: getattr(attrs, n).detach().clone().requires_grad_(True) for n in names}
        o, _ = renderer.render_view(dataclasses.replace(attrs, **leaves), cam, shape, rcfg, bin_result=b)
        loss = sum(torch.sum(x * w) for x, w in zip((o.rgb, o.depth, o.normal, o.opacity), wts))
        return torch.autograd.grad(loss, list(leaves.values()))

    gk = attr_grads()
    with plain[0], plain[1]:
        gp = attr_grads()
    errs = [scaled_err(a, p) for a, p in zip(gk, gp)]
    print("bwd: scaled grad err " + " ".join(f"{n} {e:.3g}" for n, e in zip(names, errs)))
    check(max(errs) <= 3e-4, "bwd kernel disagrees with its plain version")
    gout = torch.randn(o_k.shape, generator=g, device=dev)
    gout[:, O_TRANS + 1 :] = 0.0
    d_k = cp.composite_bwd(ent, b.tile_start, b.tile_len, o_k, gout, ntx, rcfg)
    d_p = cp.composite_bwd_plain(ent, b.tile_start, b.tile_len, o_k, gout, ntx, rcfg)
    res["composite_bwd"] = float((d_k - d_p).abs().max())
    print(f"bwd: per-entry grads max abs err {res['composite_bwd']:.3g} (scaled {scaled_err(d_k, d_p):.3g})")
    check(scaled_err(d_k, d_p) <= 3e-4, "bwd kernel per-entry grads disagree with its plain version")

    # stats, on post_process's front-only stream with its depth mask
    p2s, _, dzs, ivs = pp.preprocess(attrs, cam, shape, rcfg, front_only=True)
    bs_budget = trainer.pick_entry_bucket(int(binning.entry_count(p2s, ivs, shape, rcfg)))
    bs = binning.bin_entries(p2s, dzs, ivs, shape, rcfg, bs_budget)
    ent_s = renderer.gather_entries(p2s, bs.gid)
    mask = renderer.image_to_tiles((depth[0, 0] > 0.0).to(torch.float32), shape, rcfg)
    thr = 0.03
    i_k, c_k = cp.composite_stats(ent_s, bs.tile_start, bs.tile_len, mask, thr, ntx, rcfg)
    i_p, c_p = cp.composite_stats_plain(ent_s, bs.tile_start, bs.tile_len, mask, thr, ntx, rcfg)
    # counts may differ only where some w * mask lies within 1e-6 of thr
    _, c_lo = cp.composite_stats_plain(ent_s, bs.tile_start, bs.tile_len, mask, thr + 1e-6, ntx, rcfg)
    _, c_hi = cp.composite_stats_plain(ent_s, bs.tile_start, bs.tile_len, mask, thr - 1e-6, ntx, rcfg)
    e_imp = scaled_err(i_k, i_p)
    cnt_ok = bool(torch.all((c_k == c_p) | ((c_k >= c_lo) & (c_k <= c_hi))))
    print(f"stats: E {ent_s.shape[1]} importance err (rel to max) {e_imp:.3g}, "
          f"count mismatches {int((c_k != c_p).sum())} (at threshold {int((c_lo != c_hi).sum())})")
    check(e_imp <= 1e-5 and cnt_ok, "stats kernel disagrees with its plain version")
    res["composite_stats"] = float((i_k - i_p).abs().max())
    s_stop = cp.composite_fwd(ent_s, bs.tile_start, bs.tile_len, ntx, rcfg)[:, O_STOP, 0]

    # one whole batch_loss value and its grads, kernel path against plain
    ids, counts = trainer.draw_batch(buf, cfg, torch.Generator().manual_seed(SEED))
    batch = kf.decode_frames(buf, ids)
    max_iv, max_e = trainer.keyframe_view_stats(sub, buf, ids, cfg, rcfg)
    bins, subsets = trainer.prepare_views(
        sub, batch, cfg, rcfg, trainer.pick_subset_bucket(max_iv, sub.capacity), trainer.pick_entry_bucket(max_e)
    )

    def loss_grads():
        params = {k: getattr(sub, k).detach().clone().requires_grad_(True) for k in trainer.PARAM_FIELDS}
        loss, _ = trainer.batch_loss(params, sub, batch, counts, cfg, rcfg, bins, subsets)
        return loss, torch.autograd.grad(loss, list(params.values()))

    lk, gk = loss_grads()
    with plain[0], plain[1]:
        lp, gp = loss_grads()
    lk, lp = float(lk.detach()), float(lp.detach())
    e_loss = abs(lk - lp) / abs(lp)
    # the L1 terms switch sign where a rendered pixel meets its target within
    # rounding, so a few pixels' cotangents may differ between the two
    # paths: the grads are held in relative L2 norm, the max is printed
    errs = [float(torch.linalg.vector_norm(a - p) / torch.linalg.vector_norm(p)) for a, p in zip(gk, gp)]
    print(f"batch_loss: kernel {lk:.7f} plain {lp:.7f} rel err {e_loss:.3g}; grad rel L2 err (max scaled) "
          + " ".join(f"{n} {e:.3g} ({scaled_err(a, p):.3g})" for n, e, a, p in zip(trainer.PARAM_FIELDS, errs, gk, gp)))
    check(e_loss <= 1e-5 and max(errs) <= 1e-3, "batch_loss through the kernels disagrees with the plain path")

    k_chunk, p_tile = rcfg.chunk, rcfg.tile_pixels
    inputs = {
        "composite_fwd": (
            lambda: cp.composite_fwd(ent, b.tile_start, b.tile_len, ntx, rcfg),
            lambda: cp.composite_fwd_plain(ent, b.tile_start, b.tile_len, ntx, rcfg),
            real_pairs(b.tile_len, o_k[:, O_STOP, 0], k_chunk, p_tile),
            18 * ent.shape[1] * 4 + o_k.numel() * 4,
        ),
        "composite_bwd": (
            lambda: cp.composite_bwd(ent, b.tile_start, b.tile_len, o_k, gout, ntx, rcfg),
            lambda: cp.composite_bwd_plain(ent, b.tile_start, b.tile_len, o_k, gout, ntx, rcfg),
            real_pairs(b.tile_len, o_k[:, O_STOP, 0], k_chunk, p_tile),
            18 * ent.shape[1] * 4 + 2 * o_k.numel() * 4 + d_k.numel() * 4,
        ),
        "composite_stats": (
            lambda: cp.composite_stats(ent_s, bs.tile_start, bs.tile_len, mask, thr, ntx, rcfg),
            lambda: cp.composite_stats_plain(ent_s, bs.tile_start, bs.tile_len, mask, thr, ntx, rcfg),
            real_pairs(bs.tile_len, s_stop, k_chunk, p_tile),
            18 * ent_s.shape[1] * 4 + mask.numel() * 4 + 2 * ent_s.shape[1] * 4,
        ),
    }
    return res, inputs


def time_ms(fn, n: int) -> float:
    """Median device time of one call, from CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU")
    try:
        from activegs_torch.render import _build
        from activegs_torch.render import composite as cp
    except ImportError as e:
        fail(f"the activegs_torch package is not beside this script ({e})")
    card = smi()
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({len(logs)} compiled)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    dev = torch.device("cuda")
    state, buf, launches, cfg, rcfg = main_path(dev)
    errs, inputs = compare(state, buf, cfg, rcfg)

    kernels = []
    for name, (kfn, pfn, pairs, nbytes) in inputs.items():
        ms = time_ms(kfn, TIMED_LAUNCHES)
        plain_ms = time_ms(pfn, PLAIN_RUNS)
        t_ops = pairs * OPS_PER_PAIR[name] / PEAK_FP32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"activegs_torch/render/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
        print(f"{name}: {ms:.4f} ms (plain {plain_ms:.3f} ms), bound {bound:.4f} ms "
              f"({pairs} pairs), {launches[name] / KEYFRAMES:.1f} launches per keyframe")
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
