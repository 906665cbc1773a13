"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels of the port (the three tile-compositor
kernels of `activegs_torch/render/csrc/`, each with its bf16 pair-math
instance exported by the same source, the preprocess kernels beside them,
and the two elementwise-rate probes
of `activegs_torch/scripts/csrc/`; one nvcc per source, all started
together), then drives eight paths, each with the launch counters zeroed
just before it and read just after:

1. the mapping step (spawn -> keyframe view stats -> train_keyframe -> stats
   budgets -> post_process -> write back) for 5 keyframes of the boxroom
   simulator from fixed poses, at 512 x 512 with the default `MapConfig`
   (capacity 2^19, 8 views x 10 Adam steps) and `RasterConfig`; keyframe 5
   prunes. Then it holds each compositor kernel against its plain PyTorch
   version on the card at the main path's shapes (keyframe-5 state), a
   whole `batch_loss` value and its gradients kernel path against plain
   path, checks that two gradient computations are bitwise equal, and
   times each kernel and its plain version with CUDA events. Then the
   batched path on keyframe 5's drawn batch of 8 views: one forward and
   one backward launch over the 8 x 512 tiles (`tpv`), each held against
   its plain version and, view by view, bitwise against that view's own
   launch, and timed against one launch a view, with the backward
   launch's tile ordering; and `MapConfig.fused_view_kernel`: one
   `batch_loss` step whose per-view entry gradients must be bitwise those
   of the per-view step (1 fwd and 1 bwd launch against V of each), and a
   keyframe trained each way, its parameters within 1e-5 scaled;
2. the probe entry points (`python -m activegs_torch.scripts.microbench_vpu`
   and `... microbench_bf16`) at the reference's sizes, then holds every
   probe op bitwise against its plain version at those sizes and rounds on
   distinct inputs, reads each probe loop's instructions per round from its
   SASS, and turns the measured rates into a second bound for each
   compositor kernel;
3. a 6-step confidence-planner mission through `IncrementalMapper` (boxroom
   at 512 x 512, `MapConfig()`, `VoxelConfig()`, `PlannerConfig()`: 100
   candidates rendered at 128 x 128), recorded by a `MissionRecorder` into
   the git-ignored `build/mission/`; it checks the losses, that exploration
   rises, that the robot moves, that planning launches the forward kernel
   once per group of candidates (all 100 in one group at these sizes), and
   holds one plan step's candidate utilities through the kernel against
   those through the plain forward version, and says whether they are
   bitwise those of the per-candidate path. It holds the stats kernel (f32
   and bf16) against its plain version on a second view, post_process's
   call on the mission's final map (latest keyframe, front only, its depth
   mask). Then it builds the entry
   streams of that plan step's candidates, holds the forward kernel
   against its plain version on the candidate with the most reached
   (entry, pixel) pairs and times it there, holds one forward and one
   backward launch over all candidates' tiles as the keyframe batch is
   held, and times the plan step's forward work as one launch against one
   launch a candidate. Last, a torch.profiler breakdown of one plan step,
   the per-candidate path against the batched one: host time, device busy
   time and idle share. Then the bf16 instances (`RasterConfig.bf16_pairs`)
   on the same inputs: fwd, bwd and stats on the keyframe-5 view and fwd
   on the plan step's grid, each held against its plain version and timed
   against its f32 instance in turns;
4. a mission from the command line's entry point,
   `activegs_torch.apps.main.main()` with `mapper.raster.bf16_pairs=true`
   and the port's own YAML configs at full width (512 x 512, capacity
   2^19, 100 candidates at 128 x 128), for CLI_STEPS steps into the
   git-ignored `build/cli_mission/`: it checks the losses, that
   exploration rises, and that the training, post_process and candidate
   paths launched the bf16 instances, and no f32 instance;
5. the offline evaluation: `activegs_torch.apps.data_generation.main()`
   at the config's defaults (200 test views of the boxroom at 512 x 512,
   explored with the random planner) into the git-ignored
   `build/datasets/`, each PNG read back with zlib against its frame; a
   replay dataset of 8 of those views recorded and read back on the card
   bitwise; `activegs_torch.apps.mesh_app.main()` on path 4's experiment
   (1024 x 1024 renders along its cameras with the f32 raster config, a
   2 cm / 10 cm TSDF over the boxroom's 12,055,125 voxels, marching
   tetrahedra, the cluster filter), each stage timed, with the renders'
   `num_dropped`; and `activegs_torch.apps.eval_app.main()` on those test
   views (every snapshot scored at 512 x 512, mesh metrics at 500,000
   samples against the room's mesh). It checks the scores finite, LPIPS
   None without local weights, and that the path launched the forward
   kernel and no other. Then it holds the forward kernel against its
   plain version on one of the 1024 x 1024 mesh renders (2048 tiles) and
   times it, scores the final snapshot at 4 test poses on the card and on
   the CPU (PSNR within 1e-3 dB, SSIM 1e-5, depth MSE and the perceptual
   distance 1e-4 relative), and fuses one 1024 x 1024 render into the
   TSDF on both (weights equal at >= 99.99% of voxels, TSDF within 1e-5);
6. the last modules: (a) path 1's five keyframes with
   `MapConfig.resample_per_step=True` (a fresh draw binned in each render
   at every step): each keyframe's losses fall, aux reads -1, forward and
   backward launch once per distinct view of each step's draw; one such
   step's `batch_loss` and gradients kernel path against plain path; a
   resampled keyframe timed against a frozen one in turns; (b) view
   sharding on the one card: P6_RANKS ranks sharing it over gloo
   (`torch.multiprocessing`, a free localhost port, a timeout on the
   join), each running a `sharded_train_step` on path 1's keyframe-5 batch
   against the single-process `batch_loss` (1e-5), path 3's last plan step
   with its 100 candidates split over the ranks against the single-process
   utilities (1e-6), and a 2-step confidence-planner mission at full width
   whose maps and paths must be bitwise equal on every rank; then one rank
   over NCCL, whose step must be bitwise the single-process one; (c) the
   viewers: `apps.main.main()` with `dump_views=true` for 2 steps,
   `apps.visualize.main()` on path 4's final map (8 views at 512x512), a
   `WebViewer` on a free port during a 1-step mission with every endpoint
   fetched; the viewers must launch the forward kernel and no other, and
   one 512x512 panel through the kernel must be within 1 in uint8 at >=
   99.9% of values (2 everywhere) of the plain version's; (d) path 3's
   final map through `state_to_reference`, `convert` and
   `load_gaussian_map`, bitwise. (b)'s inputs are kept from paths 1 and 3
   in the git-ignored `build/path6/`, and (d) runs right after path 3;
7. the measurement and experiment scripts of `activegs_torch/scripts/`:
   `bench.run_bench` at the reference's shape (200,000 surfels, 8 views x
   10 steps, 512 x 512: rays/s, the subset bucket and the entry budget,
   fwd and bwd launches), one train step of the bench scene through the
   kernels against the plain versions (as path 1's step), and the opaque
   scene's `term_stats`; `bench_mission.main` for P7_MISSION_STEPS steps
   with no prewarm (its JSON line), recorded into the git-ignored
   `build/path7/`; the two preprocess kernels (`render/csrc/preprocess.cu`)
   at the bench scene's subset bucket, each held against its plain
   version (forward bitwise, backward bitwise and within 1e-5 of
   autograd) and timed beside it, and a forward and backward through them
   against the plain path under autograd, with each one's device busy
   time and device operations; `validate_truncation.main` on that mission's final map
   and its 8 cameras at 512 x 512 and 1024 x 1024 (the reference config
   must drop no more entries than production on any view); and a sweep
   smoke, `run_sweep.main` on tworoom with the confidence planner, one
   seed, a 20 s budget, 16 test views and a 2-step warm-up (the run's
   `final_result.json` and the summary's cell checked).

8. tiles other than the default 16x32, and the profiling scripts: on
   keyframe 5's view (kept from path 1) at 32x32 (1024 pixels: the
   forward kernel's 4 blocks of 256 threads, the backward and stats
   kernels' 1024-thread blocks), 16x16 and 8x16 tiles (16 pixels wide: a warp
   spans two pixel rows), fwd and bwd, f32 and bf16, and at 32x32 stats
   too, each held against its plain version at paths 1 and 3's
   tolerances and timed, each 32x32 kernel with its bounds; a mission
   from `apps.main.main()` with `mapper.raster.tile_h=32
   mapper.raster.tile_w=32` for P8_CLI_STEPS steps (every f32 kernel
   launched); and each profiling script (`tile_scan`, `kernel_overhead`,
   `profile_bwd`, `profile_step` with its op ledger, `profile_planner`,
   `profile_mission_train`, `bench scaling=1` over one NCCL rank) once at
   full width with BENCH_STEPS=P8_SCRIPT_STEPS (the planner's over
   P8_PLANNER_CANDIDATES candidates), each closing JSON line checked.

After the bf16 phase the stats kernel's two instances are timed in turns
on both stats views, by CUDA events and by device time (`stats in turns,
...`). Every phase's seconds are printed (`phase seconds: ...`), and each
kernel's `launches_by_path` adds the parts of paths 6-8. The preprocess
kernels are counted on every path: each path that renders must launch
the forward one, each that trains the backward one too, and each that
does not, never.

Paths 1 and 3 print, for the keyframe-5 view and the heaviest candidate,
the share of (entry, 32-pixel row) pairs that the kernels' warp culls keep
(a plain PyTorch pass on the same inputs) and the real entries each tile's
composite reaches; for both stats views, the share of (entry, 32-pixel
row) pairs with some w * mask != 0, the share of (round, row) partials the
stats kernel keeps, and the real entries reached per tile (mean, max).
Each kernel with an occupancy query prints its build (`composite_fwd
build`, `composite_stats build`, `composite_stats_bf16 build`), and the
stats launch its two kernels' device times on both views. With `--parent
DIR` (a `git archive` of the parent commit in a git-ignored directory) it
then imports DIR's compositor beside this one, finds which of the three
compositor kernels' sources differ (by the digest their libraries are
named by), and for each that does (each with its bf16 instance beside
its f32 one): calls both wrappers on that kernel's views and
checks their outputs bitwise equal, prints what each build gives (and the
innermost loop with an expf in its SASS) and each call's device time by
kernel, and times the two in turns (parent, change, change, parent, 4
times) in this process.

It prints a `kernels` JSON line, the card's name and power limit, and ends
with one JSON line {"ok": true, "device": {...}}. It exits non-zero, with no
result, when there is no CUDA device, when the port is not beside it, or
when any check fails. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib
import importlib.util
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import torch

KEYFRAMES = 5
MISSION_STEPS = 6
RES = 512
POS = (3.0, 2.5, 1.5)
YAW_DEG = (-40.0, -20.0, 0.0, 20.0, 40.0)  # turning around POS, +x wall first
SEED = 0
TIMED_LAUNCHES = 25
PLAIN_RUNS = 5
PROFILE_PAD_S = 2.5
KF_VIEW = f"{RES}x{RES} keyframe-{KEYFRAMES} view"
KF_STATS_VIEW = f"{KF_VIEW}, front only"

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 operations per (entry, pixel) pair the function needs, counted from
# the kernels' arithmetic (a multiply-add is 2, expf and a division 1 each);
# recomputation and reduction trees that a design adds are not counted
OPS_PER_PAIR = {"composite_fwd": 50, "composite_bwd": 105, "composite_stats": 25}
# of those, expf and IEEE divisions per pair (each also counted as 1 above)
EXP_DIV_PER_PAIR = {"composite_fwd": (1, 1), "composite_bwd": (1, 1), "composite_stats": (1, 0)}
# of the forward's, alpha's (the conic, clamps, expf, the cut): the rest
# (depth with its division, weight, accumulations) is live work only on
# pairs of 32-pixel rows with some alpha > 0
FWD_ALPHA_OPS = 17
# of those, the operations that the bf16 instances do in bf16, counted
# from their arithmetic (conversions not counted): alpha's 10 (the power's
# 9, op * exp) in every kernel; fwd 3 more (1 - alpha, the two products of
# w), bwd 16 more (1 - alpha, t_k, w, w q, 5 of dalpha, dpow and the 6
# products of dpow), stats 2 more (1 - alpha, alpha * excl)
BF16_OPS_PER_PAIR = {"composite_fwd": 13, "composite_bwd": 26, "composite_stats": 12}
# H100 SXM bf16 peak (NVIDIA data sheet, dense, tensor cores); the bf16
# instances run on the CUDA cores, so their measured-rate bound, at the
# bf16 probe's rate, is the one to read
PEAK_BF16_FLOPS = 989e12
CLI_STEPS = 3
# path 5: the CLI mission's experiment, where the test views go, and how
# many of them the card-against-CPU scoring and the replay check take
OFFLINE_EXP = ["experiment.output_dir=build/cli_mission", "experiment.exp_id=chip_smoke"]
OFFLINE_DIR = "build/datasets"
OFFLINE_VIEWS = 200
REPLAY_FRAMES = 8
CARD_CPU_POSES = 4
REPLACES = {
    "composite_fwd": "activegs_tpu/render/composite_pallas.py:179",
    "composite_bwd": "activegs_tpu/render/composite_pallas.py:297",
    "composite_stats": "activegs_tpu/render/composite_pallas.py:522",
    "composite_fwd_bf16": "activegs_tpu/render/composite_pallas.py:179",
    "composite_bwd_bf16": "activegs_tpu/render/composite_pallas.py:297",
    "composite_stats_bf16": "activegs_tpu/render/composite_pallas.py:522",
    # no Pallas kernel: the reference leaves its preprocess to XLA's fusion
    "preprocess_fwd": "none (activegs_tpu/render/preprocess.py:23, fused by XLA)",
    "preprocess_bwd": "none (its transpose by XLA)",
    "microbench_vpu": "scripts/microbench_vpu.py:37",
    "microbench_bf16": "scripts/microbench_bf16.py:30",
}
# instructions each probe loop must still hold (nvcc must not fold the chain)
SASS_NEEDS = {
    "fma": ("FMUL", "FADD"), "fma_fused": ("FFMA",), "mul": ("FMUL",), "add": ("FADD",),
    "cmpsel": ("FSETP", "FMUL"), "exp": ("MUFU.EX2",), "div": ("MUFU.RCP",),
    "float32": ("FMUL", "FADD"), "bfloat16": ("HMUL2.BF16", "HADD2.BF16"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def _kernels() -> tuple:
    """The renderer's kernels: the compositor's f32 and bf16 instances and
    the two preprocess kernels, which every path that renders launches."""
    from activegs_torch.render import composite as cp
    from activegs_torch.render import preprocess as pp

    return (*cp.KERNELS, *cp.BF16_KERNELS, *pp.KERNELS)


def _launches() -> dict:
    return {k.name: k.launches for k in _kernels()}


def _zero_launches() -> None:
    for k in _kernels():
        k.launches = 0


def check_preprocess(path: str, launches: dict, trains: bool) -> None:
    """A path that renders launches the preprocess forward kernel; one that
    trains launches its backward too (at most once a forward), and one
    that does not, never."""
    fwd, bwd = launches["preprocess_fwd"], launches["preprocess_bwd"]
    check(fwd >= bwd > 0 if trains else fwd > 0 and bwd == 0,
          f"{path}: preprocess kernel launches fwd {fwd} bwd {bwd}")


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
    """Path 1: KEYFRAMES mapping steps at full width. Returns (state, buf,
    {kernel: launches in the run}, map config, raster config, the
    keyframe-1 pose's PSNR after the run)."""
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
    _zero_launches()
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
    launches = _launches()
    print(f"main path: {KEYFRAMES} keyframes in {wall:.2f} s, launches {launches}")
    check(all(b > a for a, b in zip(counts[:-2], counts[1:-1])), f"gaussian count did not grow: {counts}")
    check(all(launches[k.name] > 0 for k in cp.KERNELS), f"a kernel was not launched on the main path: {launches}")
    check_preprocess("main path", launches, trains=True)
    psnr_after = render_psnr(state, frames[0])
    print(f"keyframe-1 pose PSNR: spawn only {psnr_before:.3f} dB, after the run {psnr_after:.3f} dB")
    check(psnr_after > psnr_before, "training did not raise PSNR at keyframe 1's pose")
    return state, buf, launches, cfg, rcfg, psnr_after


def real_pairs(tile_len: torch.Tensor, stop: torch.Tensor, k: int, p: int) -> int:
    """(entry, pixel) pairs the function needs: each tile's real entries in
    the chunks it reached, min(tile_len, stop * K), times its P pixels (the
    zero pad rows that fill a tile's last chunk are not counted)."""
    return int(torch.minimum(tile_len.to(torch.int64), stop.to(torch.int64) * k).sum()) * p


def scaled_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))


def cull_line(kernels: str, view: str, fwd_args, stop: torch.Tensor) -> tuple[int, int]:
    """Prints what the warp cull of `kernels` keeps on a view (the forward
    wrapper's arguments `fwd_args` and the chunks reached, `stop`), and the
    real entries reached per tile. Returns (live, all) (entry, 32-pixel
    row) pairs."""
    from activegs_torch.render import composite as cp

    ent, tile_start, tile_len, ntx, rcfg = fwd_args
    live, rows = cp.live_warp_rows(ent, tile_start, tile_len, stop, ntx, rcfg)
    reached = torch.minimum(tile_len.long(), stop.long() * rcfg.chunk)
    print(f"cull ({kernels}), {view}: {live} of {rows} (entry, 32-pixel row) pairs of the real entries in the "
          f"reached chunks have some alpha > 0 (share {live / rows:.4f}; plain PyTorch on the same inputs); real "
          f"entries reached per tile: mean {float(reached.float().mean()):.1f}, max {int(reached.max())} "
          f"({len(tile_len)} tiles)")
    return live, rows


def stats_view(state, buf, cfg, rcfg):
    """The stats wrapper's arguments for post_process's call on the latest
    keyframe of `buf` with the map `state` (sliced to its bucket): the
    front-only entry stream, binned at its own budget, and the render mask
    depth > 0, at the threshold render_stats uses."""
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import keyframes as kf
    from activegs_torch.mapping import trainer
    from activegs_torch.render import binning, renderer
    from activegs_torch.render import preprocess as pp
    from activegs_torch.render.types import Camera

    dev = state.means.device
    attrs = gm.attrs_of(gm.slice_state(state, gm.bucket_capacity(state.count, cfg.capacity)), cfg)
    _, depth, ext, intr = kf.decode_frames(buf, torch.tensor([buf.count - 1], device=dev))
    shape = tuple(buf.rgb.shape[-2:])
    _, _, ntx, _ = binning.bin_tile_dims(shape, rcfg)
    p2s, _, dzs, ivs = pp.preprocess(attrs, Camera(ext[0], intr[0]), shape, rcfg, front_only=True)
    bs = binning.bin_entries(p2s, dzs, ivs, shape, rcfg, trainer.pick_entry_bucket(int(binning.entry_count(
        p2s, ivs, shape, rcfg))))
    mask = renderer.image_to_tiles((depth[0, 0] > 0.0).to(torch.float32), shape, rcfg)
    return renderer.gather_entries(p2s, bs.gid), bs.tile_start, bs.tile_len, mask, 0.03, ntx, rcfg


def check_stats(view: str, args) -> float:
    """Holds the stats kernel (the instance `args`' config selects) against
    its plain version on one view: importance within 1e-5 of its largest,
    counts equal except where some w * mask lies within 1e-6 of the
    threshold. Returns the importance's max abs error."""
    from activegs_torch.render import composite as cp

    i_k, c_k = cp.composite_stats(*args)
    i_p, c_p = cp.composite_stats_plain(*args)
    thr = args[4]
    _, c_lo = cp.composite_stats_plain(*args[:4], thr + 1e-6, *args[5:])
    _, c_hi = cp.composite_stats_plain(*args[:4], thr - 1e-6, *args[5:])
    e_imp = scaled_err(i_k, i_p)
    cnt_ok = bool(torch.all((c_k == c_p) | ((c_k >= c_lo) & (c_k <= c_hi))))
    name = "stats_bf16" if args[-1].bf16_pairs else "stats"
    print(f"{name}, {view}: E {args[0].shape[1]} importance err (rel to max) {e_imp:.3g}, "
          f"count mismatches {int((c_k != c_p).sum())} (at threshold {int((c_lo != c_hi).sum())})")
    check(e_imp <= 1e-5 and cnt_ok, f"{name} kernel disagrees with its plain version on the {view}")
    return float((i_k - i_p).abs().max())


def stats_cull_line(view: str, args) -> dict:
    """Prints what the stats kernel's replay reaches on a view and what its
    warp cull keeps (`composite.stats_live_rows`, plain PyTorch on the same
    inputs). Returns the shares and the reached entries per tile."""
    from activegs_torch.render import composite as cp

    ent, tile_start, tile_len, mask, _, ntx, rcfg = args
    rows = cp.stats_live_rows(ent, tile_start, tile_len, mask, ntx, rcfg)
    reached = rows["reached"].float()
    rec = {"live_row_share": rows["live_pairs"] / rows["pairs"], "live_round_share": rows["live_rounds"] / rows["rounds"],
           "reached_mean": float(reached.mean()), "reached_max": int(reached.max())}
    print(f"cull (stats kernel), {view}: {rows['live_pairs']} of {rows['pairs']} (entry, 32-pixel row) pairs of the "
          f"real entries in the reached chunks have some w * mask != 0 (share {rec['live_row_share']:.4f}); the "
          f"kernel keeps {rows['live_rounds']} of {rows['rounds']} (round of {cp.STATS_ROUND} entries, 32-pixel row) "
          f"partials (share {rec['live_round_share']:.4f}; plain PyTorch on the same inputs); real entries reached "
          f"per tile: mean {rec['reached_mean']:.1f}, max {rec['reached_max']} (max/mean "
          f"{rec['reached_max'] / rec['reached_mean']:.2f}, {len(tile_len)} tiles)")
    return rec


def compare(state, buf, cfg, rcfg):
    """Path 1, checks: kernels against plain versions at the main path's shapes.
    Returns ({kernel: max abs error}, {kernel: (kernel call, plain call,
    (entry, pixel) pairs reached, bytes moved)}, the (live, all) (entry,
    32-pixel row) pairs of the kernels' culls, {kernel: {view: the
    wrapper's arguments}})."""
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
    _, _, ext, intr = kf.decode_frames(buf, torch.tensor([latest], device=dev))
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
    fwd_args = (ent, b.tile_start, b.tile_len, ntx, rcfg)
    cull = cull_line("fwd and bwd kernels", KF_VIEW, fwd_args, o_k[:, O_STOP, 0])

    # stats, on post_process's front-only stream with its depth mask
    stats_args = stats_view(state, buf, cfg, rcfg)
    ent_s, s_start, s_len = stats_args[:3]
    res["composite_stats"] = check_stats(KF_STATS_VIEW, stats_args)
    s_stop = cp.composite_fwd(ent_s, s_start, s_len, ntx, rcfg)[:, O_STOP, 0]

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
    lk2, gk2 = loss_grads()
    same = float(lk2.detach()) == lk and all(torch.equal(a, b) for a, b in zip(gk, gk2))
    print(f"determinism: two batch_loss gradient computations bitwise equal: {same}")
    check(same, "two computations of the same batch_loss gradients differ")

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
            lambda: cp.composite_stats(*stats_args),
            lambda: cp.composite_stats_plain(*stats_args),
            real_pairs(s_len, s_stop, k_chunk, p_tile),
            18 * ent_s.shape[1] * 4 + stats_args[3].numel() * 4 + 2 * ent_s.shape[1] * 4,
        ),
    }
    views = {
        "composite_fwd": {KF_VIEW: fwd_args},
        "composite_bwd": {KF_VIEW: (ent, b.tile_start, b.tile_len, o_k, gout, ntx, rcfg)},
        "composite_stats": {KF_STATS_VIEW: stats_args},
    }
    return res, inputs, cull, views


def time_ms(fn, n: int) -> float:
    """Median device time of one call, from CUDA events around each call."""
    from activegs_torch.scripts import probe

    return probe.time_ms(fn, n, "cuda")


def probe_phase(dev):
    """Path 2: the probe entry points at the reference's sizes (counters
    zeroed before, read after), each probe op bitwise against its plain
    version at the same sizes, plain times, and each probe loop's
    instructions per round from its SASS with the bound they give.
    Returns ({kernel: record}, {op: measured Tops/s})."""
    from activegs_torch.scripts import microbench_bf16 as bf
    from activegs_torch.scripts import microbench_vpu as vpu
    from activegs_torch.scripts import probe

    for k in (*vpu.KERNELS, *bf.KERNELS):
        k.launches = 0
    vres = vpu.main([])
    bres = bf.main([])
    torch.cuda.synchronize()
    launches = {k.source: k.launches for k in (*vpu.KERNELS, *bf.KERNELS)}
    print(f"probe path: launches {launches}")
    check(all(n > 0 for n in launches.values()), f"a probe kernel was not launched on the probe path: {launches}")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = probe.sm_clock_mhz()
    print(f"probe bounds at {sms} SMs x {clock:.0f} MHz (maximum SM clock), per-SM rates of compute capability 9.0")

    def loop_counts(kern, name_part):
        funcs = probe.sass(kern.library)
        name = next(n for n in funcs if name_part in n)
        return probe.per_round(probe.loop_opcodes(funcs[name]), vpu.UNROLL)

    # held at the path's shapes and rounds, on distinct inputs; -fmad=false
    # makes every op bitwise equal to its plain version
    per_op, errs = {}, []
    x = torch.linspace(0.25, 2.0, vpu.GRID * vpu.SUB * vpu.LANE, device=dev).reshape(vpu.GRID, vpu.SUB, vpu.LANE)
    xf = torch.full_like(x, 0.5)  # the timing input of `vpu.run`
    for i, op in enumerate(vpu.OPS):
        k, p = vpu.chain(x, op), vpu.chain_plain(x, op)
        errs.append(float((k - p).abs().max()))
        moved = float((p != x).float().mean())
        check(torch.equal(k, p), f"probe {op}: kernel differs from plain, max abs err {errs[-1]}")
        counts = loop_counts(vpu.kernel, f"chainILi{i}E")
        check(all(any(o.startswith(r) for o in counts) for r in SASS_NEEDS[op]),
              f"probe {op}: its loop lost one of {SASS_NEEDS[op]}: {counts}")
        cyc, limit = probe.cycles_per_round(counts)
        bound = probe.bound_ms(xf.numel(), vpu.ROUNDS, cyc, sms, clock)
        plain_ms = time_ms(lambda: vpu.chain_plain(xf, op), 1)
        per_op[op] = {**vres[op], "plain_ms": plain_ms, "bound_ms": bound, "bound_by": limit,
                      "instructions_per_round": counts}
        mix = " ".join(f"{o} {n:g}" for o, n in counts.items())
        print(f"  {op:9s}: equal ({moved:.1%} of elements moved); SASS per round: {mix}; bound {bound:.4f} ms "
              f"({limit}), kernel {vres[op]['ms']:.4f} ms = {bound / vres[op]['ms']:.1%} of bound; "
              f"plain {plain_ms:.2f} ms")

    # from the reference's input of ones the bf16 chain is the identity (c1
    # rounds to 1.0, c0 is under half an ulp), so it is held on values of
    # the band where every round moves every bf16 value
    per_dt = {}
    g = torch.Generator(device=dev).manual_seed(SEED)
    lo, hi = bf.MOVING_BAND
    xb = lo + (hi - lo) * torch.rand((bf.GRID, bf.SUB, bf.LANE), generator=g, device=dev)
    xbf = torch.ones_like(xb)  # the timing input of `bf.run`
    for dt, part, threads in (("float32", "chain_f32", xb.numel()), ("bfloat16", "chain_bf16", xb.numel() // 2)):
        k, p = bf.chain(xb, dt), bf.chain_plain(xb, dt)
        check(torch.equal(k, p), f"probe bf16 ({dt}): kernel differs from plain")
        short = bf.chain_plain(xb, dt, bf.ROUNDS - bf.UNROLL)
        start = xb.to(getattr(torch, dt)).float()
        moved, bites = float((p != start).float().mean()), float((p != short).float().mean())
        check(moved == 1.0 and bites == 1.0, f"probe bf16 ({dt}): the check input does not move every element "
              f"in every round ({moved:.1%} moved, {bites:.1%} differ from {bf.UNROLL} rounds fewer)")
        counts = loop_counts(bf.kernel, part)
        check(all(any(o.startswith(r) for o in counts) for r in SASS_NEEDS[dt]),
              f"probe {dt}: its loop lost one of {SASS_NEEDS[dt]}: {counts}")
        cyc, limit = probe.cycles_per_round(counts)
        bound = probe.bound_ms(threads, bf.ROUNDS, cyc, sms, clock)
        plain_ms = time_ms(lambda: bf.chain_plain(xbf, dt), 1)
        per_dt[dt] = {**bres[dt], "plain_ms": plain_ms, "bound_ms": bound, "bound_by": limit,
                      "instructions_per_round": counts}
        mix = " ".join(f"{o} {n:g}" for o, n in counts.items())
        print(f"  {dt:9s}: equal (every element moved, and differs from {bf.UNROLL} rounds fewer); "
              f"SASS per round ({'pair' if dt == 'bfloat16' else 'element'}): {mix}; "
              f"bound {bound:.4f} ms ({limit}), kernel {bres[dt]['ms']:.4f} ms; plain {plain_ms:.2f} ms")
    print(f"probe ratio f32/bf16 = {bres['ratio']:.3f}")

    records = {
        "microbench_vpu": dict(
            route="cuda", source="activegs_torch/scripts/csrc/microbench_vpu.cu", launches=launches["microbench_vpu"],
            max_abs_err=max(errs), ms=per_op["fma"]["ms"], plain_ms=per_op["fma"]["plain_ms"],
            bound_ms=per_op["fma"]["bound_ms"], bound_by="operations", library_ms=None, per_op=per_op,
        ),
        "microbench_bf16": dict(
            route="cuda", source="activegs_torch/scripts/csrc/microbench_bf16.cu", launches=launches["microbench_bf16"],
            max_abs_err=0.0, ms=per_dt["bfloat16"]["ms"], plain_ms=per_dt["bfloat16"]["plain_ms"],
            bound_ms=per_dt["bfloat16"]["bound_ms"], bound_by="operations", library_ms=None, per_dtype=per_dt,
            ratio_f32_bf16=bres["ratio"],
        ),
    }
    return records, {**{op: r["tops"] for op, r in vres.items()}, "bf16": bres["bfloat16"]["tops"]}


def rate_ms(pairs: int, ops: int, n_exp: int, n_div: int, tops: dict, n_bf16: int = 0) -> float:
    """Least time for `ops` operations on each of `pairs` pairs at the
    probe's measured rates: `n_exp` expf at the exp round's rate (exp,
    negate, add: 3 ops), `n_div` divisions at the div round's rate (2 ops),
    `n_bf16` at the bf16 probe's rate (`tops["bf16"]`, packed two elements
    an instruction), and the rest at the rate of a multiply then an add as
    the kernels compile them (-fmad=false)."""
    rest = ops - 3 * n_exp - 2 * n_div - n_bf16
    per_pair = rest / tops["fma"] + 3 * n_exp / tops["exp"] + 2 * n_div / tops["div"]  # ps at Tops/s
    if n_bf16:
        per_pair += n_bf16 / tops["bf16"]
    return pairs * per_pair * 1e-12 * 1e3


def measured_rate_bound_ms(name: str, pairs: int, tops: dict) -> float:
    """Least time for a compositor kernel's pairs at the probe's measured rates."""
    return rate_ms(pairs, OPS_PER_PAIR[name], *EXP_DIV_PER_PAIR[name], tops)


def live_work_bound_ms(pairs: int, live_pairs: int, tops: dict) -> float:
    """The forward kernel's live-work bound at the probe's measured rates:
    alpha on every real pair, the other operations (depth with its
    division, weight, accumulations) only on the `live_pairs` (entry,
    pixel) pairs of 32-pixel rows with some alpha > 0."""
    return rate_ms(pairs, FWD_ALPHA_OPS, 1, 0, tops) + rate_ms(
        live_pairs, OPS_PER_PAIR["composite_fwd"] - FWD_ALPHA_OPS, 0, 1, tops)


def ptxas_usage(log: str) -> dict[str, tuple[int, int]]:
    """{kernel function: (registers a thread, spill bytes stored)} from a
    build log of nvcc -Xptxas -v."""
    usage, name, spills = {}, None, 0
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name, spills = m.group(1), 0
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spills = int(m.group(1))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            usage[name] = (int(m.group(1)), spills)
    return usage


def import_composite(root: Path, package: str):
    """`render.composite` of the port checked out at `root`, imported as
    package `package` beside this checkout's, with its own kernel builds."""
    pkg_dir = Path(root).resolve() / "activegs_torch"
    spec = importlib.util.spec_from_file_location(package, pkg_dir / "__init__.py",
                                                  submodule_search_locations=[str(pkg_dir)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[package] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{package}.render.composite")


def kernel_build(comp, name: str, rcfg) -> str:
    """What the build of compositor kernel `name` (a kernel or its bf16
    instance) that `comp` (a composite module) launches gives at these
    shapes: from the library's own occupancy query where it exports one
    (the forward kernel: registers and local bytes a thread, shared bytes a
    block, clusters the GPU holds at once at the launched cluster size; the
    backward and stats kernels: the same with blocks per SM), else
    registers and spills from its ptxas log."""
    kern = {k.name: k for k in (*comp.KERNELS, *comp.BF16_KERNELS)}[name]
    lib = ctypes.CDLL(str(kern.library))
    if not hasattr(lib, f"{name}_occupancy"):
        usage = ptxas_usage(kern.library.with_suffix(".log").read_text())
        return "; ".join(f"{f}: {r} registers, {sp} bytes spilled (ptxas)" for f, (r, sp) in usage.items()) + \
            "; occupancy not measured (the build exports no occupancy query)"
    fn = getattr(lib, f"{name}_occupancy")
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(4)]
    if name == "composite_fwd":
        c = comp.fwd_cluster_size(rcfg)
        code = fn(rcfg.tile_w, rcfg.tile_h, rcfg.chunk, c, *(ctypes.byref(v) for v in vals))
    else:
        code = fn(rcfg.tile_pixels, rcfg.chunk, *(ctypes.byref(v) for v in vals))
    check(code == 0, f"{name}_occupancy: CUDA error {code}")
    regs, local, smem, n = (v.value for v in vals)
    head = f"{regs} registers and {local} local bytes a thread, {smem} bytes of shared memory a block, "
    if name == "composite_fwd":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        return head + (f"{n} clusters of {c} blocks of {rcfg.tile_pixels // c} threads at once on the GPU, "
                       f"{n * c / sms:.2f} blocks per SM on {sms} SMs (the library's CUDA occupancy query)")
    return head + f"{n} blocks of {rcfg.tile_pixels} threads per SM (the library's CUDA occupancy query)"


def exp_loops(comp, name: str) -> str:
    """The innermost loop that evaluates expf in each kernel function of
    the library of compositor kernel `name` that `comp` (a composite
    module) launches, from its SASS (`probe.exp_loop_opcodes`): its
    instructions, the expf among them and its shuffles."""
    from collections import Counter

    from activegs_torch.scripts import probe

    kern = {k.name: k for k in (*comp.KERNELS, *comp.BF16_KERNELS)}[name]
    parts = []
    for fn, text in probe.sass(kern.library).items():
        try:
            ops = Counter(probe.exp_loop_opcodes(text))
        except ValueError:  # a function without such a loop (the tile ordering)
            continue
        n, n_exp = sum(ops.values()), ops["MUFU.EX2"]
        shfl = sum(v for op, v in ops.items() if op.startswith("SHFL"))
        parts.append(f"{re.sub(r'^_ZN9composite[0-9]+', '', fn.split('EEv')[0])}: {n} instructions for {n_exp} expf "
                     f"({n / n_exp:.1f} each), {shfl} shuffles")
    return "; ".join(parts)


def device_ops(prof) -> list:
    """The device operations (kernels, copies, fills) of a torch.profiler trace."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def profiled(fn, n: int) -> list:
    """The device operations of `n` calls of `fn` after a warm-up call,
    under torch.profiler (CPU and CUDA), the work padded by PROFILE_PAD_S
    of idle on each side. On the card's machine a trace shorter than a few
    seconds may lack some or all of its device operations (the first ones
    go first), so the window is padded, and a duration is the mean of the
    recorded operations (`kernel_device_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    return device_ops(prof)


def device_times(fn, n: int) -> list[tuple[str, float, int]]:
    """(name, mean device time of one recorded operation (ms), operations
    recorded) of each device operation `fn` launches, most time first."""
    by_name = {}
    for e in profiled(fn, n):
        t, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, k + 1)
    return sorted(((name, t / k / 1e3, k) for name, (t, k) in by_name.items()), key=lambda x: -x[1] * x[2])


def device_ms_by_kernel(fn, n: int) -> str:
    times = device_times(fn, n)
    if not times:
        return "not measured (the trace holds no device operation)"
    return ", ".join(f"{name} {t:.4f} ms x {k} recorded" for name, t, k in times)


def kernel_device_ms(fn, n: int, kernel, *parts: str) -> list[tuple[float, int, int]]:
    """Device time per call of `fn` in each kernel whose profiler name
    holds one of `parts`, each launched once per launch that `kernel` (a
    wrapper's counter) counts: the mean of its recorded launches times the
    launches a call. Returns [(ms, launches recorded, launches made in the
    profiled calls)] by part; up to 3 traces until one records them all."""
    for _ in range(3):
        n0 = kernel.launches
        ops = profiled(fn, n)
        per_call = (kernel.launches - n0) / (n + 1)
        found = [[e for e in ops if part in e.name and not (part == "bwd_kernel" and "tile_order" in e.name)]
                 for part in parts]
        if all(found):
            return [(sum(e.time_range.end - e.time_range.start for e in f) / len(f) / 1e3 * per_call, len(f),
                     round(per_call * n)) for f in found]
    fail(f"three torch.profiler traces recorded no launch of one of {parts}")


def fwd_device_ms(fn, n: int) -> float:
    """Device time per call of the forward compositor kernel in `fn`."""
    from activegs_torch.render import composite as cp

    return kernel_device_ms(fn, n, cp.fwd_kernel, "fwd_kernel")[0][0]


def same_bits(a, b) -> bool:
    """Whether two outputs (a tensor or a tuple of them) are bitwise equal."""
    pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in pairs)


def parent_in_turns(views, parent: str, rounds: int = 4) -> None:
    """The compositor kernels of the checkout `parent` (a `git archive` of
    the parent commit) against this checkout's: finds which kernels'
    sources differ (fails unless one does), and for each that does, calls
    each side's own wrapper on that kernel's views (`views`, {kernel or
    bf16 instance (`<kernel>_bf16`: the same source and wrapper): {view:
    the wrapper's arguments}}), checks the two outputs bitwise
    equal, prints what each build gives and each call's device time by
    kernel, then times them in turns, parent, change, change, parent,
    `rounds` times, each a median of TIMED_LAUNCHES calls."""
    from activegs_torch.render import _build
    from activegs_torch.render import composite as cp

    csrc = Path(parent) / "activegs_torch" / "render" / "csrc"
    check(csrc.is_dir(), f"no compositor kernel sources under {parent}")
    # a library is named by the digest of its sources, taken the same way on both sides
    source = {n: n.removesuffix("_bf16") for n in views}
    changed = [n for n in views if _build.source_digest(source[n], csrc) != _build.source_digest(source[n])]
    print(f"parent A/B: kernels whose sources differ from the parent's: {', '.join(changed) or 'none'}")
    check(bool(changed), "no compositor kernel source differs from the parent's")
    comp = {"parent": import_composite(Path(parent), "_parent_activegs_torch"), "change": cp}
    for name in changed:
        short = name.removeprefix("composite_")
        calls = {}
        for view, args in views[name].items():
            calls[view] = {side: (lambda m=m, a=args: getattr(m, source[name])(*a)) for side, m in comp.items()}
            outs = {side: call() for side, call in calls[view].items()}
            same = same_bits(outs["parent"], outs["change"])
            print(f"{short} A/B, {view}: the two kernels' outputs bitwise equal: {same}")
            check(same, f"the {short} kernel's output differs from the parent kernel's on the {view}")
        rcfg = next(iter(views[name].values()))[-1]
        for side in comp:
            print(f"{short} A/B {side} build: {kernel_build(comp[side], name, rcfg)}")
            print(f"{short} A/B {side} SASS, innermost loop with an expf: {exp_loops(comp[side], name)}")
        for view, call in calls.items():
            for side in comp:
                print(f"{short} A/B {side}, {view}, device time a call: "
                      f"{device_ms_by_kernel(call[side], TIMED_LAUNCHES)}")
            times = {"parent": [], "change": []}
            for _ in range(rounds):
                for side in ("parent", "change", "change", "parent"):
                    times[side].append(time_ms(call[side], TIMED_LAUNCHES))
            for side, ts in times.items():
                print(f"{short} A/B {side}, {view}: median {statistics.median(ts):.4f} ms over {len(ts)} turns "
                      f"(each a median of {TIMED_LAUNCHES} calls), range {min(ts):.4f}-{max(ts):.4f} ms, in order "
                      + " ".join(f"{t:.4f}" for t in ts))


# the stats kernel's scheduling, and the source edits that undo each part:
# the tile ranking (block b replays tile b) and the cap of 2 blocks an SM
# (the registers then allow 3)
STATS_SCHEDULES = {
    "tile order, 3 blocks an SM": (("const int tile = order[blockIdx.x];", "const int tile = blockIdx.x;"),
                                   ("per_sm / (blocks + 1) - reserved + 1", "0")),
    "tile order, 2 blocks an SM": (("const int tile = order[blockIdx.x];", "const int tile = blockIdx.x;"),),
    "ranked, 3 blocks an SM": (("per_sm / (blocks + 1) - reserved + 1", "0"),),
}


def stats_schedule_phase(views, rounds: int = 2) -> dict:
    """The stats kernel against builds of its source without its tile
    ranking, without its cap of 2 blocks an SM, and without both
    (STATS_SCHEDULES; each under build/stats_schedules/, all nvcc processes
    started together): on each stats view (`views`, {view: the wrapper's
    arguments}) each build's output must be bitwise the kernel's, and each
    is timed in turns against it (kernel, build, build, kernel, `rounds`
    times; CUDA events, each a median of TIMED_LAUNCHES calls) and by
    device time (torch.profiler). Returns {view: {schedule: ms}}."""
    from activegs_torch.render import _build
    from activegs_torch.render import composite as cp

    builds = {}
    for name, edits in STATS_SCHEDULES.items():
        src = (_build.CSRC / "composite_stats.cu").read_text()
        for old, new in edits:
            check(old in src, f"stats schedule {name!r}: the source no longer holds {old!r}")
            src = src.replace(old, new)
        d = Path("build/stats_schedules") / re.sub(r"\W+", "_", name)
        d.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cuh"):
            (d / f.name).write_text(f.read_text())
        (d / "composite_stats.cu").write_text(src)
        builds[name] = _build.CudaKernel("composite_stats", cp._STATS_ARGS, csrc=d)
    _build.build_all([(k.csrc, k.source) for k in builds.values()])

    def call(kern, ent, ts, tl, mask, thr, ntx, rcfg):
        imp = torch.zeros((1, ent.shape[1]), device=ent.device)
        cnt = torch.zeros_like(imp)
        order = torch.empty(len(ts), dtype=torch.int32, device=ent.device)
        kern.launch(ent.data_ptr(), ent.shape[1], ts.data_ptr(), tl.data_ptr(), mask.data_ptr(), thr,
                    imp.data_ptr(), cnt.data_ptr(), order.data_ptr(), len(ts), *cp._tail(ntx, rcfg, ent.device))
        return imp, cnt

    res = {}
    for view, args in views.items():
        ref = cp.composite_stats(*args)
        res[view] = {}
        for name, kern in {"ranked, 2 blocks an SM (the kernel)": cp.stats_kernel, **builds}.items():
            fn = lambda k=kern, a=args: call(k, *a)  # noqa: E731
            check(same_bits(fn(), ref), f"stats schedule {name!r} changed the output on the {view}")
            times = {"kernel": [], name: []}
            for _ in range(rounds):
                for side in ("kernel", name, name, "kernel"):
                    times[side].append(time_ms(lambda s=side: (cp.composite_stats(*args) if s == "kernel" else fn()),
                                               TIMED_LAUNCHES))
            dev_ms = kernel_device_ms(fn, TIMED_LAUNCHES, kern, "stats_kernel<")[0][0]
            res[view][name] = {"ms": statistics.median(times[name]), "kernel_ms": statistics.median(times["kernel"]),
                               "device_ms": dev_ms}
            print(f"stats schedule, {view}: {name}: {statistics.median(times[name]):.4f} ms against the kernel's "
                  f"{statistics.median(times['kernel']):.4f} in turns (CUDA events, each a median of "
                  f"{TIMED_LAUNCHES}); replay device time {dev_ms:.4f} ms")
    return res


def mission_phase(dev):
    """Path 3: a confidence-planner mission of MISSION_STEPS steps through
    `IncrementalMapper`, the compositor counters zeroed before and read
    after. Returns ({kernel: launches}, the mapper)."""
    from activegs_torch.io.recorder import MissionRecorder
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import voxel_map as vm
    from activegs_torch.mapping.mapper import IncrementalMapper
    from activegs_torch.planning import ConfidencePlanner, PlannerConfig
    from activegs_torch.planning import confidence as cf
    from activegs_torch.render import composite as cp
    from activegs_torch.render.types import RasterConfig
    from activegs_torch.sim.synthetic import BoxRoomSimulator

    map_cfg, voxel_cfg, raster_cfg = gm.MapConfig(), vm.VoxelConfig(), RasterConfig()
    planner = ConfidencePlanner(PlannerConfig(), map_cfg, voxel_cfg, raster_cfg, seed=SEED)
    plan_launches, plan_groups = [], []
    plan, groups_of = planner.plan, cf.utility_groups

    def counted_groups(*args, **kwargs):
        groups = groups_of(*args, **kwargs)
        plan_groups[-1] += len(groups)
        return groups

    def counted_plan(*args, **kwargs):
        # the groups that the planner's batched utilities render, as
        # `utility_groups` returns them during the plan step
        n0 = cp.fwd_kernel.launches
        plan_groups.append(0)
        cf.utility_groups = counted_groups
        try:
            path = plan(*args, **kwargs)
        finally:
            cf.utility_groups = groups_of
        plan_launches.append(cp.fwd_kernel.launches - n0)
        return path

    planner.plan = counted_plan
    mapper = IncrementalMapper(map_cfg, voxel_cfg, raster_cfg, seed=SEED, device=dev)
    mapper.load_simulator(BoxRoomSimulator(resolution=(RES, RES), seed=SEED, device=dev))
    mapper.load_planner(planner)
    mapper.load_recorder(MissionRecorder("build/mission", budget=1e9, record_interval=1e9))
    mapper.init_map()
    _zero_launches()
    explored, positions, n_cands, t0 = [], [], [], time.perf_counter()
    for i in range(MISSION_STEPS):
        st = mapper.step()
        explored.append(1.0 - float(mapper.vm_state.unexplored.float().mean()))
        positions.append(tuple(float(v) for v in planner.pose[:3, 3]))
        n_cand = 0 if planner.last_candidates is None or i == 0 else len(planner.last_candidates)
        n_cands.append(n_cand)
        ph = " ".join(f"{k} {v:.3f}s" for k, v in st["phase_times"].items())
        pl = " ".join(f"{k} {v:.3f}s" for k, v in st["plan_times"].items())
        print(f"mission step {i + 1}: loss {st['loss']:.5f} gaussians {st['n_gaussians']} "
              f"(+{st['n_new']}/-{st['n_pruned']}) | map {ph} | plan {pl or '-'} | explored {explored[-1]:.4f} "
              f"| planning fwd launches {plan_launches[-1]} for {n_cand} candidates in {plan_groups[-1]} "
              f"group(s) | pose {positions[-1]}")
        check(math.isfinite(st["loss"]), f"mission step {i + 1}: loss {st['loss']}")
        # one forward launch per group of candidates (render_views_batched)
        check(plan_launches[-1] == plan_groups[-1] and (n_cand == 0) == (plan_groups[-1] == 0),
              f"mission step {i + 1}: {plan_launches[-1]} fwd launches in planning for {n_cand} candidates in "
              f"{plan_groups[-1]} groups")
    torch.cuda.synchronize()
    launches = _launches()
    print(f"mission: {MISSION_STEPS} steps in {time.perf_counter() - t0:.2f} s, launches {launches}, "
          f"recorder {mapper.recorder.log()}")
    check(explored[-1] > explored[0], f"exploration did not rise: {explored}")
    check(len(set(positions[1:])) > 1, f"the robot did not move: {positions}")
    check(all(n > 0 for n in plan_launches[1:]), f"planning launched no fwd kernel: {plan_launches}")
    check(all(g < n for g, n in zip(plan_groups[1:], n_cands[1:])), f"planning launched per candidate: {plan_groups}")
    check(all(launches[k.name] > 0 for k in cp.KERNELS), f"a kernel was not launched on the mission path: {launches}")
    check_preprocess("mission", launches, trains=True)
    return launches, mapper


def utility_check(mapper) -> None:
    """One plan step's candidate utilities (the mission's last candidates on
    its final map): the batched path through the kernel (one forward launch
    per group of candidates) against the same through the plain forward
    version, explore within 1 voxel over num_voxels, exploit at relative
    error (max over candidates, to the largest) at most 1e-4; and whether
    they are bitwise those of the per-candidate path (one launch a
    candidate)."""
    from activegs_torch.planning import confidence as cf
    from activegs_torch.render import composite as cp

    state, cands, (h, w), rcfg, budget, bucket = plan_step_views(mapper)
    batched, per_candidate = plan_step_utilities(mapper)
    groups = cf.utility_groups(len(cands), state.capacity, (h, w), rcfg, budget, bucket)
    n0 = cp.fwd_kernel.launches
    ek, xk = batched()
    check(cp.fwd_kernel.launches - n0 == len(groups), "the utility check did not launch the kernel once per group")
    with mock.patch.object(cp, "composite_fwd", cp.composite_fwd_plain):
        ep, xp = batched()
    e_err = float((ek - ep).abs().max()) * mapper.grid.num_voxels
    x_err = float((xk - xp).abs().max() / xp.abs().max().clamp(min=1e-12))
    n0 = cp.fwd_kernel.launches
    e1, x1 = per_candidate()
    check(cp.fwd_kernel.launches - n0 == len(cands), "the per-candidate path did not launch once a candidate")
    same = same_bits((ek, xk), (e1, x1))
    print(f"utility check: {len(cands)} candidates at {h}x{w} in {len(groups)} group(s) of at most "
          f"{cf.GROUP_BYTES} bytes of entry streams, {len(groups)} fwd launch(es); kernel against plain: explore "
          f"max diff {e_err:.3g} voxels, exploit rel err {x_err:.3g} (max exploit {float(xp.max()):.4g}); "
          f"bitwise equal to the per-candidate path ({len(cands)} launches): {same} (explore max diff "
          f"{float((ek - e1).abs().max()) * mapper.grid.num_voxels:.3g} voxels, exploit "
          f"{float((xk - x1).abs().max()):.3g})")
    check(e_err <= 1.0 and x_err <= 1e-4, "candidate utilities through the kernel disagree with the plain path")


def plan_step_utilities(mapper):
    """Two ways to score the mission's last plan step's candidates, each a
    function returning (explore, exploit) on the card: the batched path
    (`_confidence_utility_batch`, one `render_views_batched` per group) and
    the per-candidate path (`candidate_view_stats` one candidate after
    another, one forward launch each, as the port scored them before)."""
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.planning import confidence as cf
    from activegs_torch.render.renderer import pack_attrs

    planner, sim, grid = mapper.planner, mapper.simulator, mapper.grid
    state, cands, shape, rcfg, budget, bucket = plan_step_views(mapper)
    masks, _ = planner._candidate_valid_masks(planner.last_candidates, sim, shape)
    dr = torch.tensor(sim.depth_range, dtype=torch.float32, device=mapper.device)
    unexplored = mapper.vm_state.unexplored

    def batched():
        return cf._confidence_utility_batch(
            state, unexplored, cands, sim.intrinsic, masks, dr, grid, shape, planner.map_cfg, rcfg,
            entry_budget=budget, subset_bucket=bucket,
        )

    @torch.no_grad()
    def per_candidate():
        attrs = gm.attrs_of(state, planner.map_cfg)
        packed = pack_attrs(attrs) if bucket is not None else None
        stats = [
            cf.candidate_view_stats(attrs, ext, sim.intrinsic, valid, unexplored, dr, grid, shape, rcfg, budget,
                                    False, bucket, packed)
            for ext, valid in zip(cands, masks)
        ]
        explore, exploit = (torch.stack(x) for x in zip(*stats))
        return torch.nan_to_num(explore, nan=0.0), torch.nan_to_num(exploit, nan=0.0)

    return batched, per_candidate


def plan_step_views(mapper):
    """The mission's last plan step as the utility renders see it: (the
    map sliced to its bucket, the candidate poses, the render shape, the
    utility raster config, the entry budget, the subset bucket)."""
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping.trainer import pick_entry_bucket, pick_subset_bucket
    from activegs_torch.planning import confidence as cf

    planner, sim = mapper.planner, mapper.simulator
    state = gm.slice_state(mapper.gm_state, gm.bucket_capacity(mapper.gm_state.count, mapper.map_cfg.capacity))
    shape = tuple(int(round(planner.cfg.render_ratio * r)) for r in sim.resolution)
    cands = torch.as_tensor(planner.last_candidates, device=mapper.device)
    rcfg = planner.utility_raster_cfg
    ents, ivs = cf._candidate_entry_stats(state, cands, sim.intrinsic, shape, planner.map_cfg, rcfg)
    return state, cands, shape, rcfg, pick_entry_bucket(ents), pick_subset_bucket(ivs, state.capacity)


@torch.no_grad()
def candidate_streams(mapper):
    """The forward wrapper's arguments of each candidate render of the
    mission's last plan step, built as `confidence.candidate_view_stats`
    builds them (the map compacted to the candidate's in-view gaussians,
    then binned at the utility renders' budget). Returns (shape, streams)."""
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.render import binning, renderer
    from activegs_torch.render import preprocess as pp
    from activegs_torch.render.types import Camera

    state, cands, shape, rcfg, budget, bucket = plan_step_views(mapper)
    attrs = gm.attrs_of(state, mapper.planner.map_cfg)
    packed = renderer.pack_attrs(attrs)
    _, _, ntx, _ = binning.bin_tile_dims(shape, rcfg)
    streams = []
    for ext in cands:
        cam = Camera(ext, mapper.simulator.intrinsic)
        view = attrs
        if bucket is not None:
            _, _, _, iv = pp.preprocess(attrs, cam, shape, rcfg)
            sel, selv, inv, _ = renderer.compact_in_view(iv, bucket)
            view = renderer.subset_view(packed, (sel, selv, inv))
        p2d, _, dz, iv = pp.preprocess(view, cam, shape, rcfg)
        b = binning.bin_entries(p2d, dz, iv, shape, rcfg, budget)
        streams.append((renderer.gather_entries(p2d, b.gid), b.tile_start, b.tile_len, ntx, rcfg))
    return shape, streams


def fwd_bounds(args, out, tops: dict, live_rows: int) -> dict:
    """Bounds of one forward launch on `args` with output `out`: the data
    sheet's (and what sets it), at the probe's measured rates, and the
    live-work bound at those rates (`live_rows` live (entry, 32-pixel row)
    pairs)."""
    from activegs_torch.render.types import O_STOP

    ent, _, tile_len, _, rcfg = args
    pairs = real_pairs(tile_len, out[:, O_STOP, 0], rcfg.chunk, rcfg.tile_pixels)
    t_ops = pairs * OPS_PER_PAIR["composite_fwd"] / PEAK_FP32_FLOPS * 1e3
    t_bytes = (18 * ent.shape[1] * 4 + out.numel() * 4) / PEAK_BYTES_PER_S * 1e3
    return {"pairs": pairs, "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "measured_rate_bound_ms": measured_rate_bound_ms("composite_fwd", pairs, tops),
            "live_work_bound_ms": live_work_bound_ms(pairs, 32 * live_rows, tops)}


def candidate_phase(mapper, tops: dict):
    """Path 3, the forward kernel on the mission's last plan step's
    candidate renders: holds it against its plain version on the candidate
    with the most reached (entry, pixel) pairs, prints the cull there and
    over the plan step, and times it there (CUDA events and device time,
    median / mean of TIMED_LAUNCHES) and over one launch per candidate
    (device time, after a warm-up). Returns (the record's candidate keys,
    {view: the heaviest candidate's arguments}, (the plan step's grid as
    forward-wrapper arguments, its tiles per view)."""
    from activegs_torch.render import composite as cp
    from activegs_torch.render.types import O_DEPTH, O_STOP, O_TRANS

    shape, streams = candidate_streams(mapper)
    view = f"heaviest {shape[0]}x{shape[1]} candidate"
    outs = [cp.composite_fwd(*a) for a in streams]
    culls = [cp.live_warp_rows(*a[:3], o[:, O_STOP, 0], *a[3:]) for a, o in zip(streams, outs)]
    bounds = [fwd_bounds(a, o, tops, live) for a, o, (live, _) in zip(streams, outs, culls)]
    h = max(range(len(streams)), key=lambda i: bounds[i]["pairs"])
    heavy, o_k = streams[h], outs[h]
    o_p = cp.composite_fwd_plain(*heavy)
    img_rows = [r for r in range(O_TRANS + 1) if r != O_DEPTH]
    e_img = float((o_k[:, img_rows] - o_p[:, img_rows]).abs().max())
    e_dep = float((o_k[:, O_DEPTH] - o_p[:, O_DEPTH]).abs().max())
    print(f"candidate fwd: {len(streams)} candidates at {shape[0]}x{shape[1]}, the heaviest #{h}: E "
          f"{heavy[0].shape[1]} tiles {len(heavy[1])} pairs {bounds[h]['pairs']}; image err {e_img:.3g} "
          f"depth err {e_dep:.3g}")
    check(e_img <= 2e-5 and e_dep <= 1e-4, "fwd kernel disagrees with its plain version on the candidate")
    check(torch.equal(o_k[:, O_STOP], o_p[:, O_STOP]), "fwd kernel stops at other chunks than its plain version "
          "on the candidate")
    live, rows = cull_line("fwd kernel", view, heavy, o_k[:, O_STOP, 0])
    step_live, step_rows = (sum(c[i] for c in culls) for i in (0, 1))
    print(f"cull (fwd kernel), one plan step ({len(streams)} candidates): {step_live} of {step_rows} (entry, "
          f"32-pixel row) pairs have some alpha > 0 (share {step_live / step_rows:.4f})")

    # the plan step's candidates as one grid: one tpv launch
    bat = batched_check(f"one plan step's {len(streams)} {shape[0]}x{shape[1]} candidates", streams)
    grid, tpv = bat["grid"], bat["tpv"]
    calls = {"single": lambda: [cp.composite_fwd(*a) for a in streams], "tpv": lambda: cp.composite_fwd(*grid, tpv)}
    events = {k: [] for k in calls}
    for k in ("single", "tpv", "tpv", "single"):
        events[k].append(time_ms(calls[k], 5))
    device = {k: fwd_device_ms(fn, 3) for k, fn in calls.items()}
    live_g, _ = cp.live_warp_rows(*grid[:3], bat["out"][:, O_STOP, 0], *grid[3:], tpv)
    grid_bounds = fwd_bounds(grid, bat["out"], tops, live_g)

    rec = {
        "candidate_view": view,
        "candidate_ms": time_ms(lambda: cp.composite_fwd(*heavy), TIMED_LAUNCHES),
        "candidate_device_ms": fwd_device_ms(lambda: cp.composite_fwd(*heavy), TIMED_LAUNCHES),
        "candidate_plain_ms": time_ms(lambda: cp.composite_fwd_plain(*heavy), PLAIN_RUNS),
        **{f"candidate_{k}": v for k, v in bounds[h].items()},
        "candidate_live_row_share": live / rows,
        "plan_step_fwd_ms": device["single"],
        "plan_step_fwd_plain_ms": time_ms(lambda: [cp.composite_fwd_plain(*a) for a in streams], 1),
        **{f"plan_step_fwd_{k}": sum(b[k] for b in bounds)
           for k in ("bound_ms", "measured_rate_bound_ms", "live_work_bound_ms")},
        "plan_step_live_row_share": step_live / step_rows,
        "plan_step_tpv_device_ms": device["tpv"],
        "plan_step_tpv_ms": statistics.median(events["tpv"]),
        "plan_step_single_events_ms": statistics.median(events["single"]),
        "plan_step_turns_events_ms": events,
        "plan_step_tpv_plain_ms": time_ms(lambda: cp.composite_fwd_plain(*grid, tpv), 1),
        "plan_step_tpv_tiles": len(grid[1]),
        "plan_step_tpv_entries": grid[0].shape[1],
        "plan_step_tpv_max_abs_err": max(bat["e_img"], bat["e_dep"]),
        **{f"plan_step_tpv_{k}": v for k, v in grid_bounds.items()},
    }
    print(f"composite_fwd, {view}: {rec['candidate_ms']:.4f} ms (CUDA events; device time "
          f"{rec['candidate_device_ms']:.4f} ms; plain {rec['candidate_plain_ms']:.3f} ms), bound "
          f"{rec['candidate_bound_ms']:.4f} ms data sheet, {rec['candidate_measured_rate_bound_ms']:.4f} ms at the "
          f"probe's measured rates, live-work bound {rec['candidate_live_work_bound_ms']:.4f} ms at those rates")
    print(f"composite_fwd, one plan step ({len(streams)} launches, one a candidate): device time "
          f"{rec['plan_step_fwd_ms']:.4f} ms (plain {rec['plan_step_fwd_plain_ms']:.2f} ms), bound "
          f"{rec['plan_step_fwd_bound_ms']:.4f} ms data sheet, {rec['plan_step_fwd_measured_rate_bound_ms']:.4f} ms "
          f"at the measured rates, live-work bound {rec['plan_step_fwd_live_work_bound_ms']:.4f} ms")
    print(f"composite_fwd, one plan step as one tpv launch ({rec['plan_step_tpv_tiles']} tiles, "
          f"{cp.fwd_cluster_size(grid[4]) * len(grid[1])} blocks): kernel device time "
          f"{rec['plan_step_tpv_device_ms']:.4f} ms against {rec['plan_step_fwd_ms']:.4f} ms for the {len(streams)} "
          f"single launches (torch.profiler, mean of the recorded launches of 3 calls); CUDA events around the "
          f"calls (median of 5) {rec['plan_step_tpv_ms']:.4f} ms against "
          f"{rec['plan_step_single_events_ms']:.4f} ms (in turns: "
          + ", ".join(f"{k} " + " ".join(f"{t:.4f}" for t in v) for k, v in events.items())
          + f"); plain {rec['plan_step_tpv_plain_ms']:.2f} ms; bound "
          f"{rec['plan_step_tpv_bound_ms']:.4f} ms data sheet, {rec['plan_step_tpv_measured_rate_bound_ms']:.4f} ms "
          f"at the measured rates, live-work bound {rec['plan_step_tpv_live_work_bound_ms']:.4f} ms over the grid")
    return rec, {view: heavy}, (grid, tpv)


def concat_streams(streams):
    """Views' forward-wrapper arguments (entries, tile_start, tile_len, ntx,
    rcfg) as one grid, concatenated as `render_views_batched` concatenates
    them. Returns (the grid's arguments, tiles per view, each stream's
    offset)."""
    offs = [0]
    for a in streams:
        offs.append(offs[-1] + a[0].shape[1])
    grid = (
        torch.cat([a[0] for a in streams], dim=1),
        torch.cat([a[1] + o for a, o in zip(streams, offs)]),
        torch.cat([a[2] for a in streams]),
        streams[0][3],
        streams[0][4],
    )
    return grid, len(streams[0][1]), offs


def batched_check(view: str, streams) -> dict:
    """One forward and one backward launch over the views `streams` as one
    grid (`tpv`), the backward under a seeded random cotangent: each held
    against its plain version with tpv (images 2e-5, depth 1e-4, the same
    stop rows; gradients 3e-4 scaled), and each view's slice of the
    outputs and of the entry gradients bitwise against that view's own
    single-view launch. Returns what the timing needs."""
    from activegs_torch.render import composite as cp
    from activegs_torch.render.types import O_DEPTH, O_STOP, O_TRANS

    grid, tpv, offs = concat_streams(streams)
    ent, ts, tl, ntx, rcfg = grid
    dev = ent.device
    n0 = (cp.fwd_kernel.launches, cp.bwd_kernel.launches)
    out = cp.composite_fwd(*grid, tpv)
    gout = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    gout[:, O_TRANS + 1 :] = 0.0
    dent = cp.composite_bwd(ent, ts, tl, out, gout, ntx, rcfg, tpv)
    torch.cuda.synchronize()
    check((cp.fwd_kernel.launches, cp.bwd_kernel.launches) == (n0[0] + 1, n0[1] + 1),
          f"batched {view}: not one fwd and one bwd launch")
    o_p = cp.composite_fwd_plain(*grid, tpv)
    img_rows = [r for r in range(O_TRANS + 1) if r != O_DEPTH]
    e_img = float((out[:, img_rows] - o_p[:, img_rows]).abs().max())
    e_dep = float((out[:, O_DEPTH] - o_p[:, O_DEPTH]).abs().max())
    stops = torch.equal(out[:, O_STOP], o_p[:, O_STOP])
    del o_p
    d_p = cp.composite_bwd_plain(ent, ts, tl, out, gout, ntx, rcfg, tpv)
    e_bwd, e_bwd_abs = scaled_err(dent, d_p), float((dent - d_p).abs().max())
    del d_p
    torch.cuda.empty_cache()
    fwd_same, bwd_same = True, True
    for i, a in enumerate(streams):
        alone = cp.composite_fwd(*a)
        fwd_same &= same_bits(out[i * tpv : (i + 1) * tpv], alone)
        d_alone = cp.composite_bwd(*a[:3], alone, gout[i * tpv : (i + 1) * tpv].contiguous(), *a[3:])
        bwd_same &= same_bits(dent[:, offs[i] : offs[i + 1]], d_alone)
    v = len(streams)
    print(f"batched fwd, {view}: one launch over {v} views x {tpv} tiles = {len(ts)} tiles (tpv {tpv}), E "
          f"{ent.shape[1]} ({' + '.join(str(offs[i + 1] - offs[i]) for i in range(min(v, 3)))}"
          f"{' + ...' if v > 3 else ''}), {ent.numel() * 4} bytes of entries; against plain with tpv: image err "
          f"{e_img:.3g} depth err {e_dep:.3g}, stop rows equal {stops}; each view's slice bitwise equal to its own "
          f"single-view launch: {fwd_same}")
    print(f"batched bwd, {view}: one launch over {len(ts)} tiles; against plain with tpv: per-entry grads max abs err "
          f"{e_bwd_abs:.3g} (scaled {e_bwd:.3g}); each view's slice bitwise equal to its own single-view launch: "
          f"{bwd_same}")
    check(e_img <= 2e-5 and e_dep <= 1e-4 and stops, f"batched fwd kernel disagrees with its plain version ({view})")
    check(e_bwd <= 3e-4, f"batched bwd kernel disagrees with its plain version ({view})")
    check(fwd_same and bwd_same, f"a view's slice of the batched launch differs from its own launch ({view})")
    return {"grid": grid, "tpv": tpv, "out": out, "gout": gout, "e_img": e_img, "e_dep": e_dep, "e_bwd": e_bwd_abs,
            "pairs": real_pairs(tl, out[:, O_STOP, 0], rcfg.chunk, rcfg.tile_pixels)}


@torch.no_grad()
def keyframe_batch_streams(state, buf, cfg, rcfg):
    """The forward wrapper's arguments of each view of keyframe 5's drawn
    batch of `batch_size` views (repeats kept, as drawn), built as
    `trainer.batch_loss` builds them from `prepare_views`' frozen bins and
    subsets. Returns (streams, subset bucket, entry budget)."""
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import keyframes as kf
    from activegs_torch.mapping import trainer
    from activegs_torch.render import binning, renderer
    from activegs_torch.render import preprocess as pp
    from activegs_torch.render.types import Camera

    sub = gm.slice_state(state, gm.bucket_capacity(state.count, cfg.capacity))
    ids = kf.sample_weighted(buf, torch.Generator().manual_seed(SEED), cfg.batch_size, cfg.active_size)
    batch = kf.decode_frames(buf, ids)
    max_iv, max_e = trainer.keyframe_view_stats(sub, buf, ids, cfg, rcfg)
    bucket, budget = trainer.pick_subset_bucket(max_iv, sub.capacity), trainer.pick_entry_bucket(max_e)
    bins, subsets = trainer.prepare_views(sub, batch, cfg, rcfg, bucket, budget)
    attrs0 = gm.attrs_of(sub, cfg)
    packed = renderer.pack_attrs(attrs0) if subsets is not None else None
    _, _, ntx, _ = binning.bin_tile_dims((RES, RES), rcfg)
    streams = []
    for i, b in enumerate(bins):
        view = attrs0 if subsets is None else renderer.subset_view(packed, subsets[i])
        p2d = pp.preprocess(view, Camera(batch[2][i], batch[3][i]), (RES, RES), rcfg)[0]
        streams.append((renderer.gather_entries(p2d, b.gid), b.tile_start, b.tile_len, ntx, rcfg))
    return streams, bucket, budget


def keyframe_batched_phase(state, buf, cfg, rcfg) -> dict:
    """The batched launches on keyframe 5's drawn batch of 512x512 views
    (`batched_check`), then their device times: the tpv forward and
    backward launches against one launch a view, in turns, and the
    backward launch's kernels, the tile ordering among them. Returns the
    record's keys."""
    from activegs_torch.render import composite as cp

    streams, bucket, budget = keyframe_batch_streams(state, buf, cfg, rcfg)
    b = batched_check(f"{RES}x{RES} keyframe-{KEYFRAMES} batch", streams)
    grid, tpv, out, gout = b["grid"], b["tpv"], b["out"], b["gout"]
    ent, ts, tl, ntx, _ = grid
    v = len(streams)
    sl = [slice(i * tpv, (i + 1) * tpv) for i in range(v)]
    calls = {
        "fwd single": lambda: [cp.composite_fwd(*a) for a in streams],
        "fwd tpv": lambda: cp.composite_fwd(*grid, tpv),
        "bwd single": lambda: [cp.composite_bwd(*a[:3], out[t], gout[t], *a[3:]) for a, t in zip(streams, sl)],
        "bwd tpv": lambda: cp.composite_bwd(ent, ts, tl, out, gout, ntx, rcfg, tpv),
    }
    events = {k: [] for k in calls}
    for kern in ("fwd", "bwd"):
        for side in ("single", "tpv", "tpv", "single"):
            events[f"{kern} {side}"].append(time_ms(calls[f"{kern} {side}"], 5))
    device = {k: kernel_device_ms(calls[k], 3, cp.fwd_kernel, "fwd_kernel")[0][0] for k in ("fwd single", "fwd tpv")}
    device["bwd single"] = kernel_device_ms(calls["bwd single"], 3, cp.bwd_kernel, "bwd_kernel")[0][0]
    (replay, n_rec, n_made), (order, n_order, _) = kernel_device_ms(
        calls["bwd tpv"], 5, cp.bwd_kernel, "bwd_kernel", "tile_order_kernel")
    device["bwd tpv"] = replay
    rec = {
        "kf_batch_views": v, "kf_batch_tiles": len(ts), "kf_batch_entries": ent.shape[1],
        "kf_batch_subset_bucket": bucket, "kf_batch_entry_budget": budget, "kf_batch_pairs": b["pairs"],
        "kf_batch_device_ms": device,
        "kf_batch_events_ms": {k: statistics.median(x) for k, x in events.items()},
        "kf_batch_turns_events_ms": events,
        "kf_batch_bwd_replay_device_ms": replay, "kf_batch_tile_order_device_ms": order,
        "kf_batch_tile_order_share": order / replay,
        "kf_batch_bwd_max_abs_err": b["e_bwd"],
    }
    med, ev = rec["kf_batch_device_ms"], rec["kf_batch_events_ms"]
    print(f"keyframe-{KEYFRAMES} batch, {v} views x {tpv} tiles: CUDA events around the calls (median of 5, in "
          f"turns single/tpv/tpv/single, 2 each): fwd {ev['fwd tpv']:.4f} ms as one tpv launch against "
          f"{ev['fwd single']:.4f} ms for {v} single launches, bwd {ev['bwd tpv']:.4f} against {ev['bwd single']:.4f} "
          f"ms; kernel device time (torch.profiler, mean of the recorded launches): fwd {med['fwd tpv']:.4f} against "
          f"{med['fwd single']:.4f} ms, bwd replay {med['bwd tpv']:.4f} against {med['bwd single']:.4f} ms; "
          f"tile_order_kernel {order:.4f} ms ({n_order} of {n_made} launches recorded) = {order / replay:.2%} of "
          f"the replay kernel's {replay:.4f} ms ({n_rec} of {n_made} recorded)")
    return rec


def fused_check(state, buf, cfg, rcfg) -> dict:
    """`MapConfig.fused_view_kernel` on keyframe 5's drawn batch of distinct
    views, from the keyframe-5 state: one `batch_loss` step fused and per
    view, whose per-view entry gradients (the bwd kernel's output, sliced
    per view) must be bitwise equal, with 1 fwd and 1 bwd launch against V
    of each; then one keyframe trained each way from the same state and
    batch, whose parameters must agree within 1e-5 scaled by the largest
    (bitwise equality is printed: autograd may add the views' gradients
    into the shared map rows in another order)."""
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import keyframes as kf
    from activegs_torch.mapping import trainer
    from activegs_torch.render import composite as cp

    sub = gm.slice_state(state, gm.bucket_capacity(state.count, cfg.capacity))
    ids, counts = trainer.draw_batch(buf, cfg, torch.Generator().manual_seed(SEED))
    batch = kf.decode_frames(buf, ids)
    max_iv, max_e = trainer.keyframe_view_stats(sub, buf, ids, cfg, rcfg)
    bucket, budget = trainer.pick_subset_bucket(max_iv, sub.capacity), trainer.pick_entry_bucket(max_e)
    how = "as the mapping step picks it"
    if bucket is None:  # the option is honored only on compacted subsets
        bucket, how = trainer._half_step_bucket(max_iv, 8192), "forced: the mapping step would not compact here"
    bins, subsets = trainer.prepare_views(sub, batch, cfg, rcfg, bucket, budget)
    fused = dataclasses.replace(cfg, fused_view_kernel=True)
    v = len(ids)

    def step(c):
        calls, bwd = [], cp.composite_bwd

        def recorded(*args, **kwargs):
            d = bwd(*args, **kwargs)
            calls.append((args[1].data_ptr(), d))
            return d

        params = {k: getattr(sub, k).detach().clone().requires_grad_(True) for k in trainer.PARAM_FIELDS}
        n0 = (cp.fwd_kernel.launches, cp.bwd_kernel.launches)
        with mock.patch.object(cp, "composite_bwd", recorded):
            loss, _ = trainer.batch_loss(params, sub, batch, counts, c, rcfg, bins, subsets)
            grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        return loss.detach(), grads, calls, (cp.fwd_kernel.launches - n0[0], cp.bwd_kernel.launches - n0[1])

    l_f, g_f, calls_f, n_f = step(fused)
    l_v, g_v, calls_v, n_v = step(cfg)
    e = bins[0].gid.shape[0]
    by_view = dict(calls_v)  # a view's backward call, by its tile_start tensor
    same_entries = len(calls_f) == 1 and all(
        same_bits(calls_f[0][1][:, i * e : (i + 1) * e], by_view[b.tile_start.data_ptr()]) for i, b in enumerate(bins)
    )
    same_grads = all(torch.equal(a, b) for a, b in zip(g_f, g_v))
    g_err = max(scaled_err(a, b) for a, b in zip(g_f, g_v))
    print(f"fused_view_kernel step, keyframe-5 batch of {v} distinct views (subset bucket {bucket}, {how}; entry "
          f"budget {budget}, E {e}): launches fwd/bwd fused {n_f[0]}/{n_f[1]} against per view {n_v[0]}/{n_v[1]}; "
          f"per-view entry gradients bitwise equal: {same_entries}; loss {float(l_f):.7f} / {float(l_v):.7f}; "
          f"parameter grads bitwise equal: {same_grads} (max scaled err {g_err:.3g})")
    check(n_f == (1, 1) and n_v == (v, v), f"fused step launches {n_f}, per-view {n_v}, for {v} views")
    check(same_entries, "the fused step's per-view entry gradients differ from the per-view step's")

    def clone(b):
        return dataclasses.replace(b, **{f.name: getattr(b, f.name).clone() for f in dataclasses.fields(b)
                                         if isinstance(getattr(b, f.name), torch.Tensor)})

    res, times = {}, {}
    for name, c in (("fused", fused), ("per-view", cfg)):
        n0 = (cp.fwd_kernel.launches, cp.bwd_kernel.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[name] = trainer.train_keyframe(sub, clone(buf), (ids, counts), c, rcfg, subset_bucket=bucket,
                                           entry_budget=budget)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0, cp.fwd_kernel.launches - n0[0], cp.bwd_kernel.launches - n0[1])
    s_f, s_v = res["fused"][0], res["per-view"][0]
    errs = {k: scaled_err(getattr(s_f, k), getattr(s_v, k)) for k in trainer.PARAM_FIELDS}
    bitwise = all(torch.equal(getattr(s_f, k), getattr(s_v, k)) for k in trainer.PARAM_FIELDS)
    print(f"fused_view_kernel keyframe ({cfg.optimization_steps} steps): parameters against the per-view keyframe, "
          f"max scaled err " + " ".join(f"{k} {x:.3g}" for k, x in errs.items()) + f"; bitwise equal: {bitwise}; "
          f"loss {float(res['fused'][2]):.7f} / {float(res['per-view'][2]):.7f}; host time (one run each, after "
          f"warm-up) fused {times['fused'][0]:.3f} s, per view {times['per-view'][0]:.3f} s; launches fwd/bwd fused "
          f"{times['fused'][1]}/{times['fused'][2]}, per view {times['per-view'][1]}/{times['per-view'][2]}")
    check(max(errs.values()) <= 1e-5, "the fused keyframe's parameters disagree with the per-view keyframe's")
    return {"views": v, "bitwise_entry_grads": same_entries, "keyframe_bitwise": bitwise,
            "keyframe_max_scaled_err": max(errs.values())}


def device_busy(fn) -> dict:
    """One call of `fn` under torch.profiler (after a warm-up call, padded
    as in `profiled`; the CUDA activity alone, which records the runtime's
    launch calls too and costs far less to trace and parse than with the
    CPU activity on a plan step's 100,000 operations): the device's busy
    time (the union of the
    recorded kernels', copies' and fills' intervals), the device
    operations recorded against those the host launched (its runtime calls
    that launch a kernel, copy or fill; where fewer are recorded, the busy
    time is a lower bound), and the 4 device operations with the most
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    dev = device_ops(prof)
    launched = sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
                   and re.search(r"LaunchKernel|Memcpy|Memset", e.name))
    check(launched > 0, "device_busy: the trace holds no runtime launch call")
    busy, end = 0.0, -math.inf
    for s0, s1 in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"busy_ms": busy / 1e3, "device_ops": len(dev), "launched": launched,
            "top": [(k[:60], t / 1e3) for k, t in top]}


def plan_step_profile(mapper) -> dict:
    """One plan step's candidate utilities on the mission's final map, the
    per-candidate path against the batched one (the same candidates,
    budget and bucket): host time in turns (per-candidate, batched,
    batched, per-candidate, each after a sync), then each
    one's device busy time under torch.profiler (`device_busy`), and the
    idle share = 1 - busy / the median host time; the same for the
    candidate entry stats, which both paths run first."""
    from activegs_torch.planning import confidence as cf

    planner, sim = mapper.planner, mapper.simulator
    batched, per_candidate = plan_step_utilities(mapper)
    state, cands, shape, rcfg, _, _ = plan_step_views(mapper)
    paths = {"per-candidate": per_candidate, "batched": batched}
    for fn in paths.values():
        fn()  # warm-up
    walls = {k: [] for k in paths}
    for k in ("per-candidate", "batched", "batched", "per-candidate"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths[k]()
        torch.cuda.synchronize()
        walls[k].append((time.perf_counter() - t0) * 1e3)
    prof = {k: device_busy(fn) for k, fn in paths.items()}
    entry_stats = lambda: cf._candidate_entry_stats(state, cands, sim.intrinsic, shape, planner.map_cfg, rcfg)  # noqa: E731
    entry_stats()  # warm-up
    hosts = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        entry_stats()
        torch.cuda.synchronize()
        hosts.append((time.perf_counter() - t0) * 1e3)
    stats = {"host_ms": statistics.median(hosts), **device_busy(entry_stats)}
    rec = {}
    for k in paths:
        p, host = prof[k], statistics.median(walls[k])
        rec[k] = {"host_ms_median": host, "host_ms": walls[k], "idle_share": 1.0 - p["busy_ms"] / host, **p}
        print(f"plan step profile, {k} path ({len(cands)} candidates): host {host:.1f} ms (median of "
              f"{len(walls[k])}, unprofiled: " + " ".join(f"{t:.1f}" for t in walls[k]) + f"); device busy "
              f"{p['busy_ms']:.2f} ms (torch.profiler, {p['device_ops']} of {p['launched']} launched device "
              f"operations recorded), idle share {rec[k]['idle_share']:.4f}; most device time: "
              + ", ".join(f"{n} {t:.2f} ms" for n, t in p["top"]))
    stats["idle_share"] = 1.0 - stats["busy_ms"] / stats["host_ms"]
    rec["entry_stats"] = stats
    print(f"plan step profile, candidate entry stats (run first by both paths): host {stats['host_ms']:.1f} ms, "
          f"device busy {stats['busy_ms']:.2f} ms ({stats['device_ops']} of {stats['launched']} recorded), idle "
          f"share {stats['idle_share']:.4f}")
    return rec


def bf16_bounds(name: str, pairs: int, nbytes: int, tops: dict) -> dict:
    """The bf16 instance's bounds for `pairs` (entry, pixel) pairs moving
    `nbytes`: the data sheet's (its f32 operations at the FP32 rate, its
    bf16 ones at PEAK_BF16_FLOPS) and at the probe's measured rates (its
    bf16 operations at the packed bf16 probe's)."""
    n_b = BF16_OPS_PER_PAIR[name]
    t_ops = pairs * ((OPS_PER_PAIR[name] - n_b) / PEAK_FP32_FLOPS + n_b / PEAK_BF16_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "measured_rate_bound_ms": rate_ms(pairs, OPS_PER_PAIR[name], *EXP_DIV_PER_PAIR[name], tops, n_b)}


def bf16_phase(views, grid, tops: dict, stats_turns: dict) -> dict:
    """The bf16 instances (`RasterConfig.bf16_pairs`) on the f32 checks'
    inputs: fwd, bwd and stats on the keyframe-5 view (`views`, as
    `compare` returns them; the backward on the bf16 forward's output) and
    fwd on the plan step's grid (`grid`, its arguments and tiles per view).
    Each is held against its plain version at the card tests' tolerances
    (fwd images 2e-5, depth 1e-4, the same stop rows; bwd each row 2e-3 of
    its largest; stats importance 1e-5, counts only where a weight meets
    the threshold within 1e-6). Fwd and bwd are timed against their f32
    instances in turns (f32, bf16, bf16, f32, twice; CUDA events, each a
    median of TIMED_LAUNCHES calls); stats takes both instances' device
    times from `stats_turns` (`stats_turns_phase`). Returns {kernel:
    record keys}."""
    from activegs_torch.render import composite as cp
    from activegs_torch.render.types import O_DEPTH, O_STOP, O_TRANS

    def as_bf16(args):
        return (*args[:-1], dataclasses.replace(args[-1], bf16_pairs=True))

    fwd_args = views["composite_fwd"][KF_VIEW]
    stats_args = views["composite_stats"][KF_STATS_VIEW]
    ent, ts, tl, _, gout, ntx, rcfg = views["composite_bwd"][KF_VIEW]
    rb = dataclasses.replace(rcfg, bf16_pairs=True)
    grid_args, tpv = grid
    o_b = cp.composite_fwd(*as_bf16(fwd_args))
    cases = {
        ("composite_fwd", KF_VIEW): (fwd_args, ()),
        ("composite_fwd", "plan step grid"): (grid_args, (tpv,)),
        ("composite_bwd", KF_VIEW): ((ent, ts, tl, o_b, gout, ntx, rcfg), ()),
        ("composite_stats", KF_STATS_VIEW): (stats_args, ()),
    }
    img_rows = [r for r in range(O_TRANS + 1) if r != O_DEPTH]
    recs = {}
    for (name, view), (args, extra) in cases.items():
        k_f32 = lambda a=args, x=extra: getattr(cp, name)(*a, *x)  # noqa: E731
        k_b16 = lambda a=as_bf16(args), x=extra: getattr(cp, name)(*a, *x)  # noqa: E731
        p_b16 = lambda a=as_bf16(args), x=extra: getattr(cp, f"{name}_plain")(*a, *x)  # noqa: E731
        got, want = k_b16(), p_b16()
        torch.cuda.synchronize()
        extra = {}
        if name == "composite_fwd":
            e_img = float((got[:, img_rows] - want[:, img_rows]).abs().max())
            e_dep = float((got[:, O_DEPTH] - want[:, O_DEPTH]).abs().max())
            err, ok = max(e_img, e_dep), e_img <= 2e-5 and e_dep <= 1e-4 and torch.equal(got[:, O_STOP], want[:, O_STOP])
            stop = got[:, O_STOP, 0]
            what = f"image err {e_img:.3g} depth err {e_dep:.3g}, stop rows equal"
            nbytes = 18 * args[0].shape[1] * 4 + got.numel() * 4
        elif name == "composite_bwd":
            rows = [float((got[r] - want[r]).abs().max() / want[r].abs().max().clamp(min=1e-12)) for r in range(18)]
            err, ok = float((got - want).abs().max()), max(rows) <= 2e-3
            stop = o_b[:, O_STOP, 0]
            what = f"per-entry grads max abs err {err:.3g}, worst row {max(rows):.3g} of its largest"
            nbytes = 18 * ent.shape[1] * 4 + 2 * o_b.numel() * 4 + got.numel() * 4
        else:
            (i_k, c_k), (i_p, c_p) = got, want
            mask, thr = args[3], args[4]
            _, c_lo = cp.composite_stats_plain(*args[:4], thr + 1e-6, *as_bf16(args)[5:])
            _, c_hi = cp.composite_stats_plain(*args[:4], thr - 1e-6, *as_bf16(args)[5:])
            e_imp = scaled_err(i_k, i_p)
            err = float((i_k - i_p).abs().max())
            ok = e_imp <= 1e-5 and bool(torch.all((c_k == c_p) | ((c_k >= c_lo) & (c_k <= c_hi))))
            stop = cp.composite_fwd(*as_bf16(args[:3] + args[5:]))[:, O_STOP, 0]
            what = f"importance err (rel to max) {e_imp:.3g}, count mismatches {int((c_k != c_p).sum())}"
            nbytes = 18 * args[0].shape[1] * 4 + mask.numel() * 4 + 2 * args[0].shape[1] * 4
            b_args = as_bf16(args)
            rows = cp.stats_live_rows(*b_args[:4], *b_args[5:])
            extra["live_row_share"] = rows["live_pairs"] / rows["pairs"]
        del got, want
        check(ok, f"{name}_bf16 disagrees with its plain version on the {view}")
        if name == "composite_stats":
            med, how = stats_turns[view]["device_ms"], "device time in turns, stats in turns"
        else:
            times = {"f32": [], "bf16": []}
            for _ in range(2):
                for side in ("f32", "bf16", "bf16", "f32"):
                    times[side].append(time_ms(k_f32 if side == "f32" else k_b16, TIMED_LAUNCHES))
            med = {k: statistics.median(v) for k, v in times.items()}
            how = (f"CUDA events in turns f32/bf16/bf16/f32, twice, each a median of {TIMED_LAUNCHES}: f32 "
                   + " ".join(f"{t:.4f}" for t in times["f32"]) + ", bf16 "
                   + " ".join(f"{t:.4f}" for t in times["bf16"]))
        plain_ms = time_ms(p_b16, PLAIN_RUNS if view == KF_VIEW or name == "composite_stats" else 1)
        pairs = real_pairs(args[2], stop, rcfg.chunk, rcfg.tile_pixels)
        bounds = bf16_bounds(name, pairs, nbytes, tops)
        rec = {"view": view, "max_abs_err": err, "ms": med["bf16"], "f32_ms": med["f32"],
               "ratio_bf16_f32": med["bf16"] / med["f32"], "plain_ms": plain_ms, "pairs": pairs, **bounds, **extra}
        if name != "composite_stats":
            rec["turns_ms"] = times
        recs.setdefault(f"{name}_bf16", []).append(rec)
        print(f"{name}_bf16, {view}: against plain, {what}; {med['bf16']:.4f} ms against f32 {med['f32']:.4f} ms "
              f"(x{rec['ratio_bf16_f32']:.3f}; {how}); plain {plain_ms:.2f} ms; bound "
              f"{bounds['bound_ms']:.4f} ms data sheet ({bounds['bound_by']}), {bounds['measured_rate_bound_ms']:.4f} "
              f"ms at the probe's measured rates ({pairs} pairs)")
    return recs


def cli_mission_phase() -> dict:
    """Path 4: `activegs_torch.apps.main.main()` with
    `mapper.raster.bf16_pairs=true` and the port's own YAML configs at full
    width, CLI_STEPS steps into `build/cli_mission/`, every kernel's counter
    zeroed before and read after. Checks the losses, that exploration
    rises, and that training (bwd), post_process (stats) and the candidate
    renders (fwd while planning) launched the bf16 instances, and that no
    f32 instance ran. Returns {kernel: launches}."""
    from activegs_torch.apps import main as app
    from activegs_torch.mapping.mapper import IncrementalMapper
    from activegs_torch.render import composite as cp

    step, new_frame = IncrementalMapper.step, IncrementalMapper.get_new_dataframe
    explored, losses, plan_fwd = [], [], []

    def counted_step(mapper):
        st = step(mapper)
        explored.append(1.0 - float(mapper.vm_state.unexplored.float().mean()))
        losses.append(st["loss"])
        print(f"cli mission step {st['frame_id']}: loss {st['loss']:.5f} gaussians {st['n_gaussians']} "
              f"(+{st['n_new']}/-{st['n_pruned']}) explored {explored[-1]:.4f} planning fwd_bf16 launches "
              f"{plan_fwd[-1]}")
        return st

    def counted_frame(mapper):
        n0 = cp.fwd_bf16_kernel.launches
        out = new_frame(mapper)
        plan_fwd.append(cp.fwd_bf16_kernel.launches - n0)
        return out

    argv = ["mapper.raster.bf16_pairs=true", f"max_steps={CLI_STEPS}", *OFFLINE_EXP]
    _zero_launches()
    t0 = time.perf_counter()
    with mock.patch.object(IncrementalMapper, "step", counted_step), \
            mock.patch.object(IncrementalMapper, "get_new_dataframe", counted_frame):
        mapper = app.main(argv)
    torch.cuda.synchronize()
    launches = _launches()
    print(f"cli mission (python -m activegs_torch.apps.main {' '.join(argv)}): {len(losses)} steps in "
          f"{time.perf_counter() - t0:.2f} s on {mapper.device}, bf16_pairs {mapper.raster_cfg.bf16_pairs}, "
          f"{mapper.simulator.resolution[0]}x{mapper.simulator.resolution[1]}, capacity {mapper.map_cfg.capacity}, "
          f"{mapper.planner.cfg.sample_num} candidates; launches {launches}")
    check(len(losses) == CLI_STEPS and all(math.isfinite(x) for x in losses), f"cli mission losses {losses}")
    check(explored[-1] > explored[0], f"cli mission: exploration did not rise: {explored}")
    check(mapper.raster_cfg.bf16_pairs and mapper.device.type == "cuda", "cli mission: not bf16 on the card")
    check(all(n > 0 for n in plan_fwd[1:]), f"cli mission: planning launched no fwd_bf16 kernel: {plan_fwd}")
    check(all(launches[k.name] > 0 for k in cp.BF16_KERNELS), f"cli mission: a bf16 instance was not launched: "
          f"{launches}")
    check(all(launches[k.name] == 0 for k in cp.KERNELS), f"cli mission: an f32 instance ran under bf16_pairs: "
          f"{launches}")
    check_preprocess("cli mission", launches, trains=True)
    return launches


class FramesOn:
    """A simulator's ground-truth frames moved to `device`: the card's and
    the CPU's evaluation score against the same frames."""

    def __init__(self, sim, device):
        self.sim, self.device = sim, device

    def simulate(self, pose, require_gt=False):
        return {k: v.to(self.device) for k, v in self.sim.simulate(pose, require_gt=require_gt).items()}


def png_pixels(path: str):
    """(H, W, 3) uint8 pixels of an 8-bit RGB PNG whose rows all have filter
    type 0, the form `activegs_torch.io.png.write_png` writes, read with
    zlib; fails on any other form."""
    import struct
    import zlib

    import numpy as np

    data = Path(path).read_bytes()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos : pos + 4]), data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        check(zlib.crc32(kind + body) == struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])[0], f"{path}: CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = header[:4]
    check((depth, color) == (8, 2), f"{path}: not 8-bit RGB")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), f"{path}: a row with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def offline_eval_phase(dev, tops: dict) -> tuple[dict, dict, dict]:
    """Path 5, the offline evaluation at full size, every kernel's counter
    zeroed before and read after: `data_generation.main()` at the config's
    defaults (OFFLINE_VIEWS test views at 512x512) into `build/datasets/`,
    a replay dataset of REPLAY_FRAMES of them recorded and read back,
    `mesh_app.main()` on the CLI mission's experiment (1024x1024 renders
    along its cameras, the 2 cm TSDF over the boxroom, f32 raster config)
    and `eval_app.main()` on the test views (every snapshot, mesh metrics
    at 500,000 samples). Then, outside the counted run: one of the
    1024x1024 renders through the forward kernel against its plain version
    and timed, the final snapshot scored on the card and on the CPU at
    CARD_CPU_POSES test poses, and one TSDF integration of a 1024x1024
    render on both. Returns (the fwd kernel's 1024x1024 record, {kernel:
    launches}, the path's record)."""
    import glob
    import os

    import numpy as np

    from activegs_torch.apps import data_generation, eval_app, mesh_app
    from activegs_torch.apps.common import experiment_path
    from activegs_torch.config import load_config
    from activegs_torch.eval import evaluation, metrics, tsdf
    from activegs_torch.io import checkpoint, ply
    from activegs_torch.render import composite as cp
    from activegs_torch.render import renderer
    from activegs_torch.render.types import O_DEPTH, O_STOP, O_TRANS, RasterConfig
    from activegs_torch.sim import ReplaySimulator, get_simulator

    rec = {}
    _zero_launches()
    t_path = time.perf_counter()

    # test views
    t0 = time.perf_counter()
    test_dir = data_generation.main([f"dataset_path={OFFLINE_DIR}"])
    rec["data_generation_s"] = time.perf_counter() - t0
    poses = np.loadtxt(os.path.join(test_dir, "traj.txt")).reshape(-1, 4, 4).astype(np.float32)
    pngs = sorted(glob.glob(os.path.join(test_dir, "rgb", "*.png")))
    depths = sorted(glob.glob(os.path.join(test_dir, "depth", "*.npy")))
    check(len(poses) == len(pngs) == len(depths) == OFFLINE_VIEWS,
          f"data generation: {len(poses)} poses, {len(pngs)} PNGs, {len(depths)} depth arrays")
    sim = get_simulator(load_config("data_generation"), device=dev)
    for pose, png, dep in zip(poses, pngs, depths):
        f = sim.simulate(pose, require_gt=True)
        want = (torch.clamp(f["rgb"], 0, 1) * 255).to(torch.uint8).permute(1, 2, 0).cpu().numpy()
        check(np.array_equal(png_pixels(png), want), f"data generation: {png} holds other pixels than its frame")
        check(np.array_equal(np.load(dep), f["depth"][0].cpu().numpy()), f"data generation: {dep} differs")
    print(f"data generation (python -m activegs_torch.apps.data_generation dataset_path={OFFLINE_DIR}): "
          f"{OFFLINE_VIEWS} test views at {sim.resolution[0]}x{sim.resolution[1]} in {rec['data_generation_s']:.2f} s "
          f"into {test_dir}; every PNG's pixels (read with zlib) and depth array are its frame's")

    # replay
    replay_dir = os.path.join(OFFLINE_DIR, "replay_check")
    ReplaySimulator.record(replay_dir, sim, poses[:REPLAY_FRAMES])
    replay = ReplaySimulator(replay_dir, device=dev)
    with np.load(os.path.join(replay_dir, "frames.npz")) as data:
        stored = {k: data[k] for k in ("extrinsics", "rgbs", "depths")}
    for i, pose in enumerate(poses[:REPLAY_FRAMES]):
        check(replay._nearest(pose) == i, f"replay: the nearest recorded pose of pose {i} is {replay._nearest(pose)}")
        f = replay.simulate(torch.from_numpy(pose).to(dev), require_gt=True)
        d = torch.from_numpy(stored["depths"][i]).to(dev)
        same = (f["rgb"].device.type == dev.type
                and torch.equal(f["rgb"], torch.from_numpy(stored["rgbs"][i]).to(dev).float() / 255.0)
                and torch.equal(f["depth"][0], torch.where(d > 0, d, -2.0))
                and torch.equal(f["extrinsic"].cpu(), torch.from_numpy(stored["extrinsics"][i])))
        check(same, f"replay: frame {i} read back on the card differs from the recorded arrays")
    print(f"replay: {REPLAY_FRAMES} frames recorded from the synthetic simulator and read back on the card, bitwise "
          f"the recorded arrays; each pose's nearest recorded pose is its own")

    # meshes of the CLI mission's snapshots, each stage timed
    stages, dropped, renders = {"render_integrate": [], "extract": [], "filter": [], "save": []}, [], []
    gen, render, extract, filt, save = (mesh_app.generate_mesh, evaluation.render_view, tsdf.extract_mesh,
                                        tsdf.filter_isolated, ply.save_ply)
    marks = {}

    def timed_gen(*a, **kw):
        marks["gen"] = time.perf_counter()
        return gen(*a, **kw)

    def counted_render(attrs, camera, shape, cfg, **kw):
        out, aux = render(attrs, camera, shape, cfg, **kw)
        dropped.append(int(aux["num_dropped"]))
        renders.append((attrs, camera, shape, cfg, out.rgb, out.depth[0]))
        return out, aux

    def timed(stage, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            stages[stage].append(time.perf_counter() - t)
            return out
        return call

    def timed_extract(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        stages["render_integrate"].append(t - marks["gen"])
        out = extract(*a, **kw)
        stages["extract"].append(time.perf_counter() - t)
        return out

    mesh_argv = [*OFFLINE_EXP]
    with mock.patch.object(mesh_app, "generate_mesh", timed_gen), \
            mock.patch.object(evaluation, "render_view", counted_render), \
            mock.patch.object(tsdf, "extract_mesh", timed_extract), \
            mock.patch.object(tsdf, "filter_isolated", timed("filter", filt)), \
            mock.patch.object(ply, "save_ply", timed("save", save)):
        t0 = time.perf_counter()
        mesh_files = mesh_app.main(mesh_argv)
        rec["mesh_app_s"] = time.perf_counter() - t0
    check(len(mesh_files) > 0, "mesh_app wrote no mesh")
    bbox = sim.bbox
    meshes = []
    for path, *times in zip(mesh_files, *stages.values()):
        verts, faces = ply.load_ply(path)
        meshes.append({"file": path, "vertices": len(verts), "faces": len(faces)})
        print(f"mesh_app, {os.path.basename(path)}: {len(verts)} vertices, {len(faces)} faces; "
              + ", ".join(f"{k} {t:.2f} s" for k, t in zip(stages, times)))
        check(len(faces) > 0 and bool((verts >= bbox[0] - 0.3).all()) and bool((verts <= bbox[1] + 0.3).all()),
              f"mesh_app: {path} has no faces or leaves the bbox + 0.3 m")
    grid = tsdf.TSDFGrid.create(bbox)
    shape = renders[0][2]
    rec.update(meshes=meshes, mesh_stage_s=stages, mesh_renders=len(renders), mesh_render_shape=list(shape),
               mesh_num_dropped=dropped, tsdf_voxels=grid.num)
    print(f"mesh_app (python -m activegs_torch.apps.mesh_app {' '.join(mesh_argv)}): {len(mesh_files)} snapshot(s), "
          f"{len(renders)} renders at {shape[0]}x{shape[1]}, TSDF over {grid.num} voxels {grid.dims}, in "
          f"{rec['mesh_app_s']:.2f} s; num_dropped of the renders {dropped}")

    # the evaluation (test views x snapshots, then mesh metrics)
    scores, mesh_metric_s = [], []
    score, calc = evaluation.score_view, metrics.calc_3d_mesh_metric

    def timed_score(*a, **kw):
        out = score(*a, **kw)
        scores.append(time.perf_counter())
        return out

    def timed_calc(*a, **kw):
        t = time.perf_counter()
        out = calc(*a, **kw)
        mesh_metric_s.append(time.perf_counter() - t)
        return out

    eval_argv = [*OFFLINE_EXP, f"test_folder={test_dir}"]
    with mock.patch.object(evaluation, "score_view", timed_score), \
            mock.patch.object(metrics, "calc_3d_mesh_metric", timed_calc):
        t0 = time.perf_counter()
        result = eval_app.main(eval_argv)
        rec["eval_app_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = _launches()
    rec["path_s"] = time.perf_counter() - t_path
    n_maps = len(result["step"])
    # a scoring's time: from one score_view's return to the next (the next
    # pose's ground truth, the render, the metrics, the host reads)
    per_score = statistics.median(b - a for a, b in zip(scores, scores[1:])) if len(scores) > 1 else float("nan")
    rec.update(eval_scorings=len(scores), eval_score_ms=per_score * 1e3, mesh_metrics_s=mesh_metric_s,
               result={k: v for k, v in result.items()})
    print(f"eval_app (python -m activegs_torch.apps.eval_app {' '.join(eval_argv)}): {len(poses)} test views x "
          f"{n_maps} snapshot(s) = {len(scores)} scorings at {sim.resolution[0]}x{sim.resolution[1]} in {rec['eval_app_s']:.2f} s, "
          f"{rec['eval_score_ms']:.2f} ms a (view, map) (median); mesh metrics (500000 samples) "
          + ", ".join(f"{t:.2f} s" for t in mesh_metric_s))
    for k in ("mean_psnr", "mean_ssim", "mean_perceptual", "mean_depth_mse", "mean_lpips", "mesh_accuracy",
              "mesh_completion", "mesh_completion_ratio", "mesh_chamfer_distance"):
        print(f"  {k}: {result[k]}")
    finite = all(v is not None and math.isfinite(v) for k in ("mean_psnr", "mean_ssim", "mean_perceptual",
                                                              "mean_depth_mse") + tuple(k for k in result
                                                                                        if k.startswith("mesh_"))
                 for v in result[k])
    check(finite and len(result["mean_psnr"]) == n_maps, f"eval_app: a score is not finite: {result}")
    check(result["mean_lpips"] == [None] * n_maps, f"eval_app: mean_lpips {result['mean_lpips']} without weights")
    check(launches["composite_fwd"] > 0, f"offline eval: the fwd kernel was not launched: {launches}")
    check(all(n == 0 for k, n in launches.items() if k not in ("composite_fwd", "preprocess_fwd")),
          f"offline eval launched another kernel than the forward ones: {launches}")
    check_preprocess("offline eval", launches, trains=False)
    print(f"offline eval path: {rec['path_s']:.2f} s; launches {launches}")

    # outside the counted run: the fwd kernel against its plain version on
    # the last 1024x1024 mesh render
    attrs, camera, shape, rcfg, rgb_1024, depth_1024 = renders[-1]
    ent, b, _, _ = renderer._view_entries(attrs, camera, shape, rcfg, False, None, None)
    ntx = -(-shape[1] // rcfg.tile_w)
    args = (ent.detach(), b.tile_start, b.tile_len, ntx, rcfg)
    o_k, o_p = cp.composite_fwd(*args), cp.composite_fwd_plain(*args)
    img_rows = [r for r in range(O_TRANS + 1) if r != O_DEPTH]
    e_img = float((o_k[:, img_rows] - o_p[:, img_rows]).abs().max())
    e_dep = float((o_k[:, O_DEPTH] - o_p[:, O_DEPTH]).abs().max())
    view = f"{shape[0]}x{shape[1]} mesh render (last camera, snapshot {result['step'][-1]})"
    print(f"fwd, {view}: E {ent.shape[1]} tiles {len(b.tile_start)} (ntx {ntx}) num_dropped {int(b.num_dropped)}; "
          f"image err {e_img:.3g} depth err {e_dep:.3g}")
    check(e_img <= 2e-5 and e_dep <= 1e-4, f"fwd kernel disagrees with its plain version on the {view}")
    check(torch.equal(o_k[:, O_STOP], o_p[:, O_STOP]), f"fwd kernel stops at other chunks than its plain version "
          f"on the {view}")
    live, _ = cull_line("fwd kernel", view, args, o_k[:, O_STOP, 0])
    fwd = {"view": view, "tiles": len(b.tile_start), "entries": ent.shape[1], "num_dropped": int(b.num_dropped),
           "max_abs_err": max(e_img, e_dep), "ms": time_ms(lambda: cp.composite_fwd(*args), TIMED_LAUNCHES),
           "device_ms": fwd_device_ms(lambda: cp.composite_fwd(*args), TIMED_LAUNCHES),
           "plain_ms": time_ms(lambda: cp.composite_fwd_plain(*args), PLAIN_RUNS),
           **fwd_bounds(args, o_k, tops, live)}
    print(f"composite_fwd, {view}: {fwd['ms']:.4f} ms (CUDA events; device time {fwd['device_ms']:.4f} ms; plain "
          f"{fwd['plain_ms']:.3f} ms), bound {fwd['bound_ms']:.4f} ms data sheet ({fwd['bound_by']}), "
          f"{fwd['measured_rate_bound_ms']:.4f} ms at the probe's measured rates, live-work bound "
          f"{fwd['live_work_bound_ms']:.4f} ms at those rates ({fwd['pairs']} pairs)")

    # the card against the CPU: the final snapshot at CARD_CPU_POSES test
    # poses (the same ground-truth frames), and one TSDF integration
    final = os.path.join(experiment_path(load_config("eval", eval_argv)), "map", f"map_{result['step'][-1]}.npz")
    rcfg32 = RasterConfig()
    got = {}
    t0 = time.perf_counter()
    for d in (dev.type, "cpu"):
        state, mcfg = checkpoint.load_gaussian_map(final, device=d)
        got[d] = evaluation.EvaluationTool([(state, mcfg)], [None], poses[:CARD_CPU_POSES], FramesOn(sim, d), None,
                                           rcfg32).eval(mode="rendering")
    rec["card_cpu_eval_s"] = time.perf_counter() - t0
    card, host = got[dev.type], got["cpu"]
    diffs = {"psnr_db": abs(card["mean_psnr"][0] - host["mean_psnr"][0]),
             "ssim": abs(card["mean_ssim"][0] - host["mean_ssim"][0]),
             **{f"{k}_rel": abs(card[f"mean_{k}"][0] / host[f"mean_{k}"][0] - 1) for k in ("depth_mse", "perceptual")}}
    print(f"card against CPU, snapshot {result['step'][-1]} at {CARD_CPU_POSES} test poses ({rec['card_cpu_eval_s']:.1f}"
          f" s): card " + " ".join(f"{k} {v[0]:.6g}" for k, v in card.items() if v[0] is not None)
          + "; cpu " + " ".join(f"{k} {v[0]:.6g}" for k, v in host.items() if v[0] is not None)
          + "; differences " + " ".join(f"{k} {v:.3g}" for k, v in diffs.items()))
    check(diffs["psnr_db"] <= 1e-3 and diffs["ssim"] <= 1e-5 and diffs["depth_mse_rel"] <= 1e-4
          and diffs["perceptual_rel"] <= 1e-4, f"the card's scores disagree with the CPU's: {diffs}")
    ext, intr = camera.extrinsic, camera.intrinsic
    fused = {}
    for d in (dev.type, "cpu"):
        st = tsdf.integrate(tsdf.init_state(grid, d), grid, rgb_1024.to(d), depth_1024.to(d), ext.to(d), intr.to(d))
        fused[d] = tsdf.tsdf_state_to_numpy(st)
    same = fused[dev.type]["weight"] == fused["cpu"]["weight"]
    t_err = float(np.abs(fused[dev.type]["tsdf"][same] - fused["cpu"]["tsdf"][same]).max())
    print(f"TSDF integrate of the {view}, card against CPU: weights equal at {same.mean():.6f} of {grid.num} voxels "
          f"({int((fused['cpu']['weight'] > 0).sum())} observed), TSDF max err {t_err:.3g} where equal")
    check(same.mean() >= 0.9999 and t_err <= 1e-5, "TSDF integration on the card disagrees with the CPU's")
    rec.update(card_cpu=diffs, tsdf_weight_equal=float(same.mean()), tsdf_max_err=t_err)
    return fwd, launches, rec


P6_DIR = Path("build/path6")
P6_RANKS = 2
P6_MISSION_STEPS = 2
P6_JOIN_S = 600
VIEWER_EXP = ["experiment.output_dir=build/viewer_mission", "experiment.exp_id=chip_smoke"]


def uint8_close(got, want) -> tuple[int, float]:
    """(max |difference|, share within 1) of two uint8 images."""
    import numpy as np

    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(d.max()), float(np.mean(d <= 1))


def map_digest(state) -> str:
    import hashlib

    from activegs_torch.mapping import gaussians as gm

    return hashlib.sha256(b"".join(v.tobytes() for v in gm.state_to_numpy(state).values())).hexdigest()


@torch.no_grad()
def export_keyframe_batch(state, buf, cfg, rcfg) -> None:
    """Path 6 (b)'s first input, kept from path 1: keyframe 5's map (sliced
    to its bucket), its drawn batch (seed SEED), decoded, and the batch's
    subset bucket and entry budget, into P6_DIR/keyframe.pt."""
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import keyframes as kf
    from activegs_torch.mapping import trainer

    sub = gm.slice_state(state, gm.bucket_capacity(state.count, cfg.capacity))
    ids, counts = trainer.draw_batch(buf, cfg, torch.Generator().manual_seed(SEED))
    max_iv, max_e = trainer.keyframe_view_stats(sub, buf, ids, cfg, rcfg)
    P6_DIR.mkdir(parents=True, exist_ok=True)
    torch.save({
        "state": gm.state_to_numpy(sub), "capacity": sub.capacity, "cfg": cfg, "rcfg": rcfg,
        "batch": [x.cpu() for x in kf.decode_frames(buf, ids)], "counts": counts.cpu(),
        "subset_bucket": trainer.pick_subset_bucket(max_iv, sub.capacity),
        "entry_budget": trainer.pick_entry_bucket(max_e),
    }, P6_DIR / "keyframe.pt")


@torch.no_grad()
def export_plan_step(mapper) -> None:
    """Path 6 (b)'s second input, kept from path 3: the mission's last plan
    step as its utility renders see it (`plan_step_views`), into
    P6_DIR/plan_step.pt."""
    from activegs_torch.mapping import gaussians as gm

    state, cands, shape, rcfg, budget, bucket = plan_step_views(mapper)
    planner, sim = mapper.planner, mapper.simulator
    masks, _ = planner._candidate_valid_masks(planner.last_candidates, sim, shape)
    torch.save({
        "state": gm.state_to_numpy(state), "capacity": state.capacity, "cands": cands.cpu(), "shape": shape,
        "rcfg": rcfg, "budget": budget, "bucket": bucket, "masks": masks.cpu(), "map_cfg": planner.map_cfg,
        "intrinsic": sim.intrinsic.cpu(), "depth_range": list(sim.depth_range), "grid": mapper.grid,
        "unexplored": mapper.vm_state.unexplored.cpu(),
    }, P6_DIR / "plan_step.pt")


def checkpoint_phase(mapper) -> dict:
    """Path 6 (d): the mission's final map written as a checkpoint of the
    original system (`state_to_reference`), converted back to npz
    (`convert`) and loaded on the card (`load_gaussian_map`): every field
    bitwise the map's. No kernel runs."""
    from activegs_torch.io import checkpoint, convert_reference

    P6_DIR.mkdir(parents=True, exist_ok=True)
    state, th, npz = mapper.gm_state, P6_DIR / "map_final.th", P6_DIR / "map_final.npz"
    t0 = time.perf_counter()
    convert_reference.state_to_reference(state, mapper.map_cfg, str(th))
    n = convert_reference.convert(str(th), str(npz))
    back, _ = checkpoint.load_gaussian_map(str(npz), device=state.means.device)
    same = n == state.count == back.count and all(
        torch.equal(getattr(back, f)[:n], getattr(state, f)[:n]) for f in ("means", "scales_raw", "rotations_raw",
                                                                             "opacities_raw", "colors", "view_scores",
                                                                             "view_supports", "view_means"))
    dt = time.perf_counter() - t0
    print(f"reference checkpoint: mission final map ({n} gaussians) -> {th.name} ({th.stat().st_size} bytes) -> "
          f"{npz.name} -> load_gaussian_map on {back.means.device} in {dt:.2f} s; every field bitwise: {same}")
    check(same, "the reference checkpoint round trip changed the map")
    return {"gaussians": n, "seconds": dt}


def resample_phase(dev, psnr_frozen: float) -> dict:
    """Path 6 (a): path 1's five fixed-pose keyframes with
    `MapConfig.resample_per_step=True`, every kernel's counter zeroed
    before and read after. Checks that each keyframe's step losses fall,
    that aux reads -1, and that each keyframe launched forward and backward
    once per distinct view of each step's draw. Then, outside the counted
    run: one resampled step's `batch_loss` value and gradients on the final
    map, kernel path against plain path; a resampled keyframe timed
    against a frozen one in turns; the keyframe-1 pose PSNR against path
    1's. Returns the path's record."""
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import keyframes as kf
    from activegs_torch.mapping import trainer
    from activegs_torch.mapping.mapper import mapping_step
    from activegs_torch.render import composite as cp
    from activegs_torch.render.renderer import render_view
    from activegs_torch.render.types import Camera, RasterConfig
    from activegs_torch.sim.synthetic import BoxRoomSimulator

    cfg, rcfg = gm.MapConfig(resample_per_step=True), RasterConfig()
    sim = BoxRoomSimulator(resolution=(RES, RES), seed=SEED, device=dev)
    frames = [sim.simulate(p) for p in poses(dev)]
    state, buf = gm.init_state(cfg, dev), kf.init_buffer(256, RES, RES, device=dev)
    gen = torch.Generator().manual_seed(SEED)
    train, draw, loss_fn = trainer.train_keyframe, trainer.draw_batch, trainer.batch_loss
    draws, losses, per_kf = [], [], []

    def counted_train(*a, **k):
        draws.clear()
        losses.clear()
        n0 = (cp.fwd_kernel.launches, cp.bwd_kernel.launches)
        out = train(*a, **k)
        per_kf.append({"fwd": cp.fwd_kernel.launches - n0[0], "bwd": cp.bwd_kernel.launches - n0[1],
                       "views": list(draws), "losses": [float(x) for x in losses]})
        return out

    def counted_draw(*a, **k):
        ids, counts = draw(*a, **k)
        draws.append(len(ids))
        return ids, counts

    def counted_loss(*a, **k):
        out = loss_fn(*a, **k)
        losses.append(out[0].detach())
        return out

    _zero_launches()
    t0 = time.perf_counter()
    with mock.patch.object(trainer, "train_keyframe", counted_train), \
            mock.patch.object(trainer, "draw_batch", counted_draw), mock.patch.object(trainer, "batch_loss", counted_loss):
        for i, f in enumerate(frames):
            state, buf, st = mapping_step(state, buf, f, cfg, rcfg, gen)
            rec = per_kf[-1]
            print(f"resampled keyframe {i + 1}: loss {rec['losses'][0]:.5f} -> {st['loss']:.5f} gaussians "
                  f"{st['n_gaussians']} num_dropped {st['num_dropped']} views a step {rec['views']} launches fwd "
                  f"{rec['fwd']} bwd {rec['bwd']} | "
                  + " ".join(f"{k} {v:.3f}s" for k, v in st["phase_times"].items()))
            check(math.isfinite(st["loss"]) and st["num_dropped"] == -1 and st["num_entries"] == -1,
                  f"resampled keyframe {i + 1}: loss {st['loss']}, aux {st['num_dropped']} {st['num_entries']}")
            check(len(rec["views"]) == cfg.optimization_steps and rec["fwd"] == rec["bwd"] == sum(rec["views"]),
                  f"resampled keyframe {i + 1}: launches fwd {rec['fwd']} bwd {rec['bwd']} for draws {rec['views']}")
            check(rec["losses"][-1] < rec["losses"][0], f"resampled keyframe {i + 1}: losses did not fall "
                  f"{rec['losses']}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    print(f"resampled path: {KEYFRAMES} keyframes in {wall:.2f} s, launches {launches}")
    check(all(launches[k.name] > 0 for k in cp.KERNELS), f"resampled path: a kernel was not launched: {launches}")
    check_preprocess("resampled path", launches, trains=True)

    # one resampled step, kernel path against plain path
    sub = gm.slice_state(state, gm.bucket_capacity(state.count, cfg.capacity))
    ids, counts = trainer.draw_batch(buf, cfg, torch.Generator().manual_seed(SEED))
    batch = kf.decode_frames(buf, ids)

    def loss_grads():
        params = {k: getattr(sub, k).detach().clone().requires_grad_(True) for k in trainer.PARAM_FIELDS}
        loss, _ = trainer.batch_loss(params, sub, batch, counts, cfg, rcfg)
        return float(loss.detach()), torch.autograd.grad(loss, list(params.values()))

    lk, gk = loss_grads()
    with mock.patch.object(cp, "composite_fwd", cp.composite_fwd_plain), \
            mock.patch.object(cp, "composite_bwd", cp.composite_bwd_plain):
        lp, gp = loss_grads()
    e_loss = abs(lk - lp) / abs(lp)
    errs = [float(torch.linalg.vector_norm(a - p) / torch.linalg.vector_norm(p)) for a, p in zip(gk, gp)]
    print(f"resampled batch_loss ({len(ids)} views, binned in each render): kernel {lk:.7f} plain {lp:.7f} rel err "
          f"{e_loss:.3g}; grad rel L2 err " + " ".join(f"{n} {e:.3g}" for n, e in zip(trainer.PARAM_FIELDS, errs)))
    check(e_loss <= 1e-5 and max(errs) <= 1e-3, "the resampled batch_loss through the kernels disagrees with plain")

    # a resampled keyframe against a frozen one, in turns, on the final map
    frozen_cfg = dataclasses.replace(cfg, resample_per_step=False)
    perf = buf.performance.clone()

    def keyframe(resample: bool) -> float:
        buf.performance.copy_(perf)
        g = torch.Generator().manual_seed(SEED)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if resample:
            trainer.train_keyframe(sub, buf, None, cfg, rcfg, generator=g)
        else:
            views = trainer.draw_batch(buf, frozen_cfg, g)
            max_iv, max_e = trainer.keyframe_view_stats(sub, buf, views[0], frozen_cfg, rcfg)
            trainer.train_keyframe(sub, buf, views, frozen_cfg, rcfg,
                                   subset_bucket=trainer.pick_subset_bucket(max_iv, sub.capacity),
                                   entry_budget=trainer.pick_entry_bucket(max_e))
        torch.cuda.synchronize()
        return time.perf_counter() - t

    times = {True: [], False: []}
    for resample in (False, True, True, False, False, True):
        times[resample].append(keyframe(resample))
    t_res, t_frz = statistics.median(times[True]), statistics.median(times[False])
    buf.performance.copy_(perf)

    o, _ = render_view(gm.attrs_of(state, cfg), Camera(frames[0]["extrinsic"], frames[0]["intrinsic"]), (RES, RES), rcfg)
    psnr_res = psnr(o.rgb, frames[0]["rgb"])
    print(f"resampled keyframe (10 steps, a fresh draw binned each step) {t_res:.3f} s against frozen (view stats + "
          f"one binning) {t_frz:.3f} s, median of 3 in turns (x{t_res / t_frz:.2f}); keyframe-1 pose PSNR after "
          f"the run {psnr_res:.3f} dB (frozen path 1: {psnr_frozen:.3f} dB)")
    return {"launches": launches, "wall_s": wall, "keyframes": per_kf, "keyframe_s": {"resampled": t_res,
            "frozen": t_frz}, "psnr_db": psnr_res, "psnr_frozen_db": psnr_frozen,
            "batch_loss_rel_err": e_loss, "grad_rel_l2_err": max(errs)}


def sharded_rank(rank: int, port: int) -> None:
    """Path 6 (b), one of P6_RANKS ranks sharing the card over gloo (run by
    `torch.multiprocessing`): joins the group through
    `runtime.init_distributed`, then on path 1's keyframe-5 batch one
    `sharded_train_step` (bins built for its share only) against the
    single-process `batch_loss`; on path 3's last plan step
    `sharded_candidate_utility` against `_confidence_utility_batch`; then a
    P6_MISSION_STEPS-step confidence-planner mission at full width through
    `IncrementalMapper`, whose map digest it compares with rank 0's.
    Writes its record to P6_DIR/rank<rank>.json."""
    import os

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(P6_RANKS), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port), ACTIVEGS_DIST_BACKEND="gloo")
    import torch.distributed as dist

    from activegs_torch import runtime
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import trainer
    from activegs_torch.mapping import voxel_map as vm
    from activegs_torch.mapping.mapper import IncrementalMapper
    from activegs_torch.parallel import sharded
    from activegs_torch.planning import ConfidencePlanner, PlannerConfig
    from activegs_torch.planning import confidence as cf
    from activegs_torch.render.types import RasterConfig
    from activegs_torch.sim.synthetic import BoxRoomSimulator

    check(runtime.init_distributed(), "init_distributed refused the environment")
    dev = torch.device("cuda")
    group = sharded.make_view_group()
    rec = {"rank": rank, "world": dist.get_world_size(), "backend": dist.get_backend()}

    launches = _launches

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    # one sharded step on keyframe 5's batch
    d = torch.load(P6_DIR / "keyframe.pt", weights_only=False)
    state = gm.state_from_numpy(d["state"], dev, capacity=d["capacity"])
    batch, counts, cfg, rcfg = [x.to(dev) for x in d["batch"]], d["counts"].to(dev), d["cfg"], d["rcfg"]
    share = sharded.view_share(len(counts), group)
    leaves = lambda: {k: getattr(state, k).clone().requires_grad_(True) for k in trainer.PARAM_FIELDS}  # noqa: E731
    bins, subsets = trainer.prepare_views(state, batch, cfg, rcfg, d["subset_bucket"], d["entry_budget"], only=share)
    n0 = launches()
    (loss, grads, per_frame), step_ms = timed(
        lambda: sharded.sharded_train_step(leaves(), state, batch, counts, group, cfg, rcfg, bins, subsets))
    step_launches = {k: v - n0[k] for k, v in launches().items()}
    all_bins, all_subsets = trainer.prepare_views(state, batch, cfg, rcfg, d["subset_bucket"], d["entry_budget"])
    p = leaves()
    (loss1, pf1), single_ms = timed(lambda: trainer.batch_loss(p, state, batch, counts, cfg, rcfg, all_bins,
                                                                all_subsets))
    g1 = torch.autograd.grad(loss1, list(p.values()))
    loss1 = loss1.detach()
    scaled = max(float((grads[k] - g).abs().max() / g.abs().max().clamp(min=1e-12))
                 for k, g in zip(trainer.PARAM_FIELDS, g1))
    rec["step"] = {"views": len(counts), "share": [share.start, share.stop], "ms": step_ms, "single_ms": single_ms,
                   "loss": float(loss), "loss_rel_err": abs(float(loss) - float(loss1)) / abs(float(loss1)),
                   "grad_scaled_err": scaled, "per_frame_err": float((per_frame - pf1).abs().max()),
                   "launches": step_launches}
    del d, state, batch, bins, subsets, all_bins, all_subsets, grads, g1, p

    # one plan step's candidates, split over the ranks
    d = torch.load(P6_DIR / "plan_step.pt", weights_only=False)
    state = gm.state_from_numpy(d["state"], dev, capacity=d["capacity"])
    args = (state, d["unexplored"].to(dev), d["cands"].to(dev), d["intrinsic"].to(dev), d["masks"].to(dev),
            torch.tensor(d["depth_range"], dtype=torch.float32, device=dev))
    rest = (d["grid"], d["shape"], d["map_cfg"], d["rcfg"])
    opts = {"entry_budget": d["budget"], "subset_bucket": d["bucket"]}
    n0 = launches()
    (e_s, x_s), util_ms = timed(lambda: sharded.sharded_candidate_utility(*args, group, *rest, **opts))
    util_launches = {k: v - n0[k] for k, v in launches().items()}
    e_1, x_1 = cf._confidence_utility_batch(*args, *rest, **opts)
    rec["utility"] = {"candidates": len(d["cands"]), "share": len(sharded.view_share(len(d["cands"]), group)),
                      "ms": util_ms, "explore_err": float((e_s - e_1).abs().max()),
                      "exploit_err": float((x_s - x_1).abs().max()), "launches": util_launches}
    del d, state, args

    # a mission on every rank
    map_cfg, voxel_cfg, raster_cfg = gm.MapConfig(), vm.VoxelConfig(), RasterConfig()
    planner = ConfidencePlanner(PlannerConfig(), map_cfg, voxel_cfg, raster_cfg, seed=SEED)
    mapper = IncrementalMapper(map_cfg, voxel_cfg, raster_cfg, seed=SEED, device=dev)
    mapper.load_simulator(BoxRoomSimulator(resolution=(RES, RES), seed=SEED, device=dev))
    mapper.load_planner(planner)
    mapper.init_map()
    check(mapper.group is not None and planner.group is mapper.group, "the mapper built no view group")
    n0, explored, steps_s, poses_ = launches(), [], [], []
    for _ in range(P6_MISSION_STEPS):
        _, ms = timed(mapper.step)
        steps_s.append(ms / 1e3)
        explored.append(1.0 - float(mapper.vm_state.unexplored.float().mean()))
        poses_.append([float(v) for v in planner.pose[:3, 3]])
    digest = map_digest(mapper.gm_state)
    mine = torch.tensor(list(bytes.fromhex(digest)), dtype=torch.int32, device=dev)
    rank0 = sharded.all_reduce_sum(mine.clone() if rank == 0 else torch.zeros_like(mine), group)
    rec["mission"] = {"steps_s": steps_s, "explored": explored, "poses": poses_, "digest": digest[:16],
                      "gaussians": mapper.gm_state.count, "same_map_as_rank0": bool(torch.equal(mine, rank0)),
                      "launches": {k: v - n0[k] for k, v in launches().items()}}
    (P6_DIR / f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def sharded_phase(card: str) -> dict:
    """Path 6 (b): P6_RANKS ranks sharing the card over gloo
    (`sharded_rank`, spawned with `torch.multiprocessing` on a free
    localhost port, joined with a timeout), then one rank over NCCL in this
    process: the keyframe-5 step through `sharded_train_step` must be
    bitwise the single-process step. Returns the path's record."""
    import socket

    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import trainer
    from activegs_torch.parallel import sharded
    from activegs_torch.render import composite as cp

    for r in range(P6_RANKS):
        (P6_DIR / f"rank{r}.json").unlink(missing_ok=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    ctx = tmp.spawn(sharded_rank, args=(port,), nprocs=P6_RANKS, join=False)
    try:
        while not ctx.join(timeout=5):
            check(time.perf_counter() - t0 < P6_JOIN_S, f"the sharded ranks did not finish in {P6_JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    wall = time.perf_counter() - t0
    recs = [json.loads((P6_DIR / f"rank{r}.json").read_text()) for r in range(P6_RANKS)]
    for r in recs:
        st, ut, mi = r["step"], r["utility"], r["mission"]
        print(f"sharded rank {r['rank']} of {r['world']} ({r['backend']}, {P6_RANKS} ranks sharing one card: no "
              f"speed-up; {card}): step over views {st['share']} of {st['views']} in {st['ms']:.1f} ms (single "
              f"process {st['single_ms']:.1f} ms for the loss), loss rel err {st['loss_rel_err']:.3g}, grads "
              f"{st['grad_scaled_err']:.3g} scaled, launches {st['launches']}; utilities {ut['share']} of "
              f"{ut['candidates']} candidates in {ut['ms']:.1f} ms, explore err {ut['explore_err']:.3g} exploit "
              f"{ut['exploit_err']:.3g}, launches {ut['launches']}; mission steps {mi['steps_s']} s, explored "
              f"{mi['explored']}, pose {mi['poses'][-1]}, map {mi['digest']} ({mi['gaussians']} gaussians), same "
              f"as rank 0 {mi['same_map_as_rank0']}, launches {mi['launches']}")
        check(st["loss_rel_err"] <= 1e-5 and st["grad_scaled_err"] <= 1e-5,
              f"rank {r['rank']}: the sharded step disagrees with the single-process one")
        check(ut["explore_err"] <= 1e-6 and ut["exploit_err"] <= 1e-6,
              f"rank {r['rank']}: the sharded utilities disagree with the single-process ones")
        check(mi["same_map_as_rank0"] and mi["poses"] == recs[0]["mission"]["poses"],
              f"rank {r['rank']}: the mission's map or path differs from rank 0's")
        check(mi["explored"][-1] > mi["explored"][0], f"rank {r['rank']}: exploration did not rise {mi['explored']}")
        check(all(mi["launches"][k.name] > 0 for k in cp.KERNELS), f"rank {r['rank']}: a kernel was not launched "
              f"in the sharded mission: {mi['launches']}")
        check_preprocess(f"rank {r['rank']}'s sharded mission", mi["launches"], trains=True)
    check(len({r["step"]["loss"] for r in recs}) == 1, "the ranks disagree on the step's loss")

    # one rank over NCCL: bitwise the single-process step
    d = torch.load(P6_DIR / "keyframe.pt", weights_only=False)
    dev = torch.device("cuda")
    state = gm.state_from_numpy(d["state"], dev, capacity=d["capacity"])
    batch, counts, cfg, rcfg = [x.to(dev) for x in d["batch"]], d["counts"].to(dev), d["cfg"], d["rcfg"]
    bins, subsets = trainer.prepare_views(state, batch, cfg, rcfg, d["subset_bucket"], d["entry_budget"])
    leaves = lambda: {k: getattr(state, k).clone().requires_grad_(True) for k in trainer.PARAM_FIELDS}  # noqa: E731
    p = leaves()
    loss1, pf1 = trainer.batch_loss(p, state, batch, counts, cfg, rcfg, bins, subsets)
    g1 = torch.autograd.grad(loss1, list(p.values()))
    n0 = _launches()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, grads, pf = sharded.sharded_train_step(leaves(), state, batch, counts, sharded.ViewGroup(None, 0, 1),
                                                     cfg, rcfg, bins, subsets)
        torch.cuda.synchronize()
        nccl_ms = (time.perf_counter() - t) * 1e3
    finally:
        dist.destroy_process_group()
    nccl_launches = {k: v - n0[k] for k, v in _launches().items()}
    bitwise = torch.equal(loss, loss1.detach()) and torch.equal(pf, pf1) and all(
        torch.equal(grads[k], g) for k, g in zip(trainer.PARAM_FIELDS, g1))
    print(f"sharded step over one NCCL rank ({len(counts)} views, {nccl_ms:.1f} ms, launches {nccl_launches}): "
          f"bitwise the single-process step: {bitwise}")
    check(bitwise, "one NCCL rank's step is not bitwise the single-process step")
    total = {k: sum(r[part]["launches"][k] for r in recs for part in ("step", "utility", "mission"))
             for k in nccl_launches}
    return {"ranks": recs, "wall_s": wall, "nccl_ms": nccl_ms, "nccl_bitwise": bitwise,
            "launches": {k: total[k] + nccl_launches[k] for k in total}}


def viewer_phase(dev) -> dict:
    """Path 6 (c): the viewers at full width, every kernel's counter zeroed
    before and read after, the viewers' own launches counted apart from
    the missions': a 2-step mission from `apps.main.main()` with
    `dump_views=true` (panels read back with zlib); `apps.visualize.main()`
    on path 4's final map (8 orbit views at 512x512); a `WebViewer` on a
    free localhost port during a 1-step mission (`use_gui=true
    gui_port=0`), every endpoint fetched with urllib. Checks that the
    viewers launched the forward kernel and no other. Then one 512x512
    panel through the kernel against the same through the plain version.
    Returns the path's record."""
    import glob
    import urllib.request

    import numpy as np

    from activegs_torch.apps import main as app
    from activegs_torch.apps import visualize
    from activegs_torch.core import geometry as geo
    from activegs_torch.io import checkpoint
    from activegs_torch.render import composite as cp
    from activegs_torch.render.types import Camera, RasterConfig
    from activegs_torch.viz import viewer as tview
    from activegs_torch.viz.webviewer import WebViewer

    counts = _launches
    viewer_launches = dict.fromkeys(counts(), 0)

    def counted(fn):
        def run(*a, **k):
            n0 = counts()
            out = fn(*a, **k)
            for name, v in counts().items():
                viewer_launches[name] += v - n0[name]
            return out
        return run

    _zero_launches()
    t0 = time.perf_counter()
    with mock.patch.object(tview.MissionViewer, "on_step", counted(tview.MissionViewer.on_step)), \
            mock.patch.object(WebViewer, "on_step", counted(WebViewer.on_step)):
        t = time.perf_counter()
        app.main(["dump_views=true", "max_steps=2", *VIEWER_EXP])
        t_dump = time.perf_counter() - t
        panels = sorted(glob.glob("build/viewer_mission/chip_smoke/*/*/*/viewer/*.png"))
        names = [Path(p).name for p in panels]
        check(names == ["channels_001.png", "channels_002.png", "voxels_001.png", "voxels_002.png"],
              f"dump_views wrote {names}")
        shapes = [png_pixels(p).shape for p in panels]
        check(shapes[0] == (512, 768, 3), f"dump_views panel shape {shapes[0]}")

        maps = glob.glob(OFFLINE_EXP[0].split("=")[1] + "/chip_smoke/*/*/*/map/map_final.npz")
        check(len(maps) == 1, f"path 4's final map: {maps}")
        t = time.perf_counter()
        written = counted(visualize.main)(["--map", maps[0], "--out", "build/visualize", "--views", "8",
                                           "--resolution", str(RES)])
        t_vis = time.perf_counter() - t
        check(len(written) == 8 and all(png_pixels(p).shape == (2 * RES, 3 * RES, 3) for p in written),
              f"visualize wrote {written}")

        mapper = app.main(["use_gui=true", "gui_port=0", "max_steps=1", "debug=true"])
        viewer = mapper.viewer
        try:
            base = f"http://127.0.0.1:{viewer.port}"
            fetched = {}

            @counted
            def get(path):
                with urllib.request.urlopen(base + path, timeout=60) as r:
                    fetched[path] = (r.status, r.headers.get("Content-Type"), r.read())
                return fetched[path]

            t = time.perf_counter()
            for path in ("/", "/stats.json", "/panel.png", "/voxel.png", "/scene.png", "/fly.png",
                         "/fly.png?dx=0.3&yaw=0.2&chan=depth", "/fly.png?chan=d2n",
                         "/fly.png?chan=opacity&conf_min=0.5&scale_mod=0.5", "/record_pose?dz=-0.3", "/poses.json"):
                get(path)
            t_web = time.perf_counter() - t
        finally:
            viewer.close()
        stats = json.loads(fetched["/stats.json"][2])
        check(all(c == 200 for c, _, _ in fetched.values()), f"web viewer status {[c for c, _, _ in fetched.values()]}")
        check(all(b[:8] == b"\x89PNG\r\n\x1a\n" for p, (_, _, b) in fetched.items() if ".png" in p),
              "a web viewer image is not a PNG")
        check(stats["frame_id"] == 1 and all(math.isfinite(v) for v in stats.values() if isinstance(v, float)),
              f"web viewer stats {stats}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    print(f"viewers: dump_views mission (2 steps) {t_dump:.2f} s, panels {names}; visualize 8 views at {RES}x{RES} "
          f"{t_vis:.2f} s; web viewer {len(fetched)} endpoints in {t_web:.2f} s (port {viewer.port}, stats frame "
          f"{stats['frame_id']}, loss {stats['loss']:.5f}); launches by the viewers {viewer_launches}, by the whole "
          f"path {launches} ({wall:.2f} s)")
    check(viewer_launches["composite_fwd"] > 0 and all(v == 0 for k, v in viewer_launches.items()
                                                       if k not in ("composite_fwd", "preprocess_fwd")),
          f"the viewers launched other kernels than the forward ones: {viewer_launches}")
    check_preprocess("viewers", viewer_launches, trains=False)
    check_preprocess("viewer path", launches, trains=True)

    # one 512x512 panel, the kernel against the plain version
    state, cfg = checkpoint.load_gaussian_map(maps[0], device=dev)
    means = state.means[: state.count].cpu().numpy()
    radius = 0.6 * float(np.linalg.norm(means.max(0) - means.min(0)))
    pose = visualize.orbit_poses(means.mean(0), radius, 0.3 * radius, 8)[0]  # visualize's first view
    cam = Camera(torch.as_tensor(pose, device=dev), geo.intrinsics_from_fov(60.0, 60.0, device=dev))
    p_k = tview.render_channel_panel(state, cfg, cam, (RES, RES), RasterConfig())
    with mock.patch.object(cp, "composite_fwd", cp.composite_fwd_plain):
        p_p = tview.render_channel_panel(state, cfg, cam, (RES, RES), RasterConfig())
    worst, share = uint8_close(p_k, p_p)
    print(f"viewer panel {RES}x{RES}, kernel against plain: max uint8 diff {worst}, within 1 at {share:.6f} of "
          f"values, bitwise at {float(np.mean(p_k == p_p)):.6f}")
    check(worst <= 2 and share >= 0.999, "the viewer panel through the kernel disagrees with the plain version")
    return {"launches": launches, "viewer_launches": viewer_launches, "wall_s": wall, "dump_views_s": t_dump,
            "visualize_s": t_vis, "web_s": t_web, "panel_max_diff": worst, "panel_within_1": share}


def stats_turns_phase(views: dict) -> dict:
    """The stats kernel's two instances timed in turns on each stats view
    (`views`: {view: the f32 wrapper's arguments}), the one timing of both
    instances: by CUDA events (f32, bf16, bf16, f32, twice, each a median
    of TIMED_LAUNCHES calls; the wrapper's host work and its two fills
    included) and by device time (one torch.profiler trace of calls
    alternating f32, bf16, bf16, f32: each instance's replay kernel the
    mean of its recorded launches, plus the tile ranking kernel, which
    both instances launch alike, the mean of all its recorded launches).
    A call's device time (`device_ms`, replay + ranking) is the `ms` of
    both stats rows of the `kernels` line. Returns {view: record}."""
    from activegs_torch.render import composite as cp

    recs = {}
    for view, args in views.items():
        b_args = (*args[:-1], dataclasses.replace(args[-1], bf16_pairs=True))
        calls = {"f32": lambda a=args: cp.composite_stats(*a), "bf16": lambda a=b_args: cp.composite_stats(*a)}
        events = {"f32": [], "bf16": []}
        for _ in range(2):
            for side in ("f32", "bf16", "bf16", "f32"):
                events[side].append(time_ms(calls[side], TIMED_LAUNCHES))
        by_side, rank = {"f32": [], "bf16": []}, []
        for _ in range(3):
            ops = profiled(lambda: [calls[s]() for s in ("f32", "bf16", "bf16", "f32")], TIMED_LAUNCHES // 2)
            for e in ops:
                ms = (e.time_range.end - e.time_range.start) / 1e3
                if "stats_kernel<" in e.name:
                    side = "bf16" if "true" in e.name.split("stats_kernel<", 1)[1].split(">", 1)[0] else "f32"
                    by_side[side].append(ms)
                elif "tile_rank_kernel" in e.name:
                    rank.append(ms)
            if all(by_side.values()) and rank:
                break
        check(all(by_side.values()) and rank, f"stats in turns, {view}: three traces recorded no replay or "
              f"ranking launch: { {k: len(v) for k, v in by_side.items()} }, ranking {len(rank)}")
        med = {k: statistics.median(v) for k, v in events.items()}
        replay = {k: sum(v) / len(v) for k, v in by_side.items()}
        rank_ms = sum(rank) / len(rank)
        dev_ms = {k: t + rank_ms for k, t in replay.items()}
        recs[view] = {"events_ms": events, "events_median_ms": med, "device_ms": dev_ms, "replay_ms": replay,
                      "rank_ms": rank_ms, "device_recorded": {**{k: len(v) for k, v in by_side.items()},
                                                              "rank": len(rank)},
                      "ratio_events": med["bf16"] / med["f32"], "ratio_device": dev_ms["bf16"] / dev_ms["f32"]}
        print(f"stats in turns, {view}: CUDA events (f32/bf16/bf16/f32, twice, each a median of {TIMED_LAUNCHES}) "
              f"f32 " + " ".join(f"{t:.4f}" for t in events["f32"]) + ", bf16 "
              + " ".join(f"{t:.4f}" for t in events["bf16"]) + f" ms: median bf16 {med['bf16']:.4f} against f32 "
              f"{med['f32']:.4f} ms (x{recs[view]['ratio_events']:.3f}); device time a call bf16 "
              f"{dev_ms['bf16']:.4f} against f32 {dev_ms['f32']:.4f} ms (x{recs[view]['ratio_device']:.3f}): "
              f"replay bf16 {replay['bf16']:.4f} ({len(by_side['bf16'])} recorded), f32 {replay['f32']:.4f} "
              f"({len(by_side['f32'])} recorded), tile ranking {rank_ms:.4f} ms ({len(rank)} recorded)")
    return recs


# path 7: the measurement and experiment scripts of `activegs_torch/scripts/`
P7_DIR = Path("build/path7")
P7_BENCH_GAUSSIANS = 200_000  # the reference bench's surfels
P7_MISSION_STEPS = 8  # steps 4-8 form the steady window; its map keeps 8 cameras
P7_SWEEP_PLANNERS = ("confidence",)  # the smoke checks that run_sweep runs, not the planners' comparison
P7_SWEEP = ["experiment.output_dir=build/path7/experiments", "exp_id=sweep_smoke", "scenes=synthetic/tworoom",
            f"planners={','.join(P7_SWEEP_PLANNERS)}", "runs=1", "budget=20", "num_test_views=16", "warmup_steps=2"]


def bench_phase(dev) -> dict:
    """Path 7 (bench): `scripts.bench.run_bench` at the reference's shape
    (200,000 surfels, 8 views x 10 steps, 512x512), the counters zeroed
    before and read after; then one train step of the bench scene (the
    first timed run's batch, its buckets), `batch_loss` and its gradients
    through the kernels against the plain versions (loss 1e-5 relative,
    gradients 1e-3 in relative L2, as path 1's step); then the opaque
    scene's termination telemetry (`term_probe`). Returns the record."""
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import keyframes as kf
    from activegs_torch.mapping import trainer
    from activegs_torch.render import composite as cp
    from activegs_torch.render.types import RasterConfig
    from activegs_torch.scripts import bench

    _zero_launches()
    t0 = time.perf_counter()
    rec = bench.run_bench(res=RES, n_gauss=P7_BENCH_GAUSSIANS, device=dev)
    wall = time.perf_counter() - t0
    launches = _launches()
    print(f"bench (python -m activegs_torch.scripts.bench, {RES}x{RES}, {P7_BENCH_GAUSSIANS} surfels, 8 views x 10 "
          f"steps): "
          f"{rec['value'] / 1e6:.3f} M rays/s (vs_baseline {rec['vs_baseline']:.4f}); subset bucket "
          f"{rec['subset_bucket']}, entry budget {rec['entry_budget']}; distinct views a step {rec['distinct_views']}; "
          f"warm-up {rec['seconds']['warm_up']:.3f} s, timed " + " ".join(f"{t:.4f}" for t in rec["seconds"]["timed"])
          + f" s; launches fwd {launches['composite_fwd']} bwd {launches['composite_bwd']} ({wall:.2f} s)")
    check(rec["value"] > 0 and math.isfinite(rec["value"]), f"bench: {rec['value']} rays/s")
    check(launches["composite_fwd"] == launches["composite_bwd"] > 0 and launches["composite_stats"] == 0
          and all(launches[k.name] == 0 for k in cp.BF16_KERNELS), f"bench launches {launches}")
    check_preprocess("bench", launches, trains=True)

    cfg, rcfg = gm.MapConfig(capacity=1 << 19, batch_size=bench.BATCH, optimization_steps=10), RasterConfig()
    state, buf = bench.build_scene(RES, P7_BENCH_GAUSSIANS, cfg, device=dev)
    sub = gm.slice_state(state, gm.bucket_capacity(state.count, cfg.capacity))
    ids, counts = trainer.draw_batch(buf, cfg, torch.Generator().manual_seed(bench.BENCH_KEYS[1]))
    batch = kf.decode_frames(buf, ids)
    bins, subsets = trainer.prepare_views(sub, batch, cfg, rcfg, rec["subset_bucket"], rec["entry_budget"])

    def loss_grads():
        params = {k: getattr(sub, k).detach().clone().requires_grad_(True) for k in trainer.PARAM_FIELDS}
        loss, _ = trainer.batch_loss(params, sub, batch, counts, cfg, rcfg, bins, subsets)
        return float(loss.detach()), torch.autograd.grad(loss, list(params.values()))

    lk, gk = loss_grads()
    with mock.patch.object(cp, "composite_fwd", cp.composite_fwd_plain), \
            mock.patch.object(cp, "composite_bwd", cp.composite_bwd_plain):
        lp, gp = loss_grads()
    e_loss = abs(lk - lp) / abs(lp)
    errs = [float(torch.linalg.vector_norm(a - p) / torch.linalg.vector_norm(p)) for a, p in zip(gk, gp)]
    print(f"bench train step ({len(ids)} distinct views): batch_loss kernel {lk:.7f} plain {lp:.7f} rel err "
          f"{e_loss:.3g}; grad rel L2 err (max scaled) " + " ".join(
              f"{n} {e:.3g} ({scaled_err(a, p):.3g})" for n, e, a, p in zip(trainer.PARAM_FIELDS, errs, gk, gp)))
    check(e_loss <= 1e-5 and max(errs) <= 1e-3, "the bench train step through the kernels disagrees with the plain path")
    del state, buf, sub, bins, subsets, gk, gp

    state_o, buf_o = bench.build_scene(RES, P7_BENCH_GAUSSIANS, cfg, opacity_raw=5.0, device=dev)
    term = bench.term_probe(gm.slice_state(state_o, gm.bucket_capacity(state_o.count, cfg.capacity)), buf_o, cfg,
                            rcfg, RES)
    print(f"bench opaque (BENCH_OPAQUE=1) term_stats: {json.dumps(term)}")
    check(0 < term["chunks_processed"] <= term["chunks_available"], f"bench opaque term_stats {term}")
    return {"rays_per_s": rec["value"], "subset_bucket": rec["subset_bucket"], "entry_budget": rec["entry_budget"],
            "distinct_views": rec["distinct_views"], "run_s": rec["seconds"], "train_step_loss_err": e_loss,
            "train_step_grad_rel_l2": max(errs), "term_stats": term, "launches": launches, "seconds": wall}


# bytes a gaussian that the preprocess kernels need to move: the forward
# reads means, scales, rotations, opacity, colors, confidence (60) and valid
# (1) and writes params2d (96), radius, depth_z (8) and in_view (1); the
# backward reads means, scales, rotations (40) and valid (1), which are all
# its recomputation needs, and the cotangent's rows 0..17 (72), and writes
# the gradients of the five trained leaves (56)
PRE_BYTES = {"preprocess_fwd": 61 + 96 + 8 + 1, "preprocess_bwd": 41 + 72 + 56}


def preprocess_phase(dev) -> dict:
    """Path 7 (preprocess): the two preprocess kernels at one subset bucket
    of the bench scene (`train-bench-200k`'s): the first view of the first
    timed draw, compacted as `batch_loss` hands it to `preprocess` (row
    views of the packed subset). The forward kernel is held bitwise against
    `preprocess_fwd_plain`, the backward bitwise against
    `preprocess_bwd_plain` and within 1e-5 relative L2 of autograd through
    the plain forward, with a cotangent on params2d as in training. Each
    kernel and its plain version is timed by CUDA events (median of
    TIMED_LAUNCHES), and so are a forward and backward through `preprocess`
    against the same through the plain forward under autograd (the path
    before the kernels), with their device busy time and device operations
    a call; each kernel's bound is its bytes at the data sheet's 3.35 TB/s.
    Returns the record."""
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import keyframes as kf
    from activegs_torch.mapping import trainer
    from activegs_torch.render import preprocess as pp
    from activegs_torch.render import renderer
    from activegs_torch.render.types import PARAM_DIM, Camera, RasterConfig
    from activegs_torch.scripts import bench

    _zero_launches()
    cfg, rcfg = gm.MapConfig(capacity=1 << 19, batch_size=bench.BATCH, optimization_steps=10), RasterConfig()
    state, buf = bench.build_scene(RES, P7_BENCH_GAUSSIANS, cfg, device=dev)
    sub = gm.slice_state(state, gm.bucket_capacity(P7_BENCH_GAUSSIANS, cfg.capacity))
    ids, _ = trainer.draw_batch(buf, cfg, torch.Generator().manual_seed(bench.BENCH_KEYS[1]))
    bucket = trainer.pick_subset_bucket(trainer.keyframe_view_stats(sub, buf, ids, cfg, rcfg)[0], sub.capacity)
    check(bucket is not None, "preprocess: the bench scene picks no subset bucket")
    batch = kf.decode_frames(buf, ids)
    cam, shape = Camera(batch[2][0], batch[3][0]), (RES, RES)
    attrs0 = gm.attrs_of(sub, cfg)
    subset = renderer.compact_in_view(pp.preprocess(attrs0, cam, shape, rcfg)[3], bucket)[:3]
    view = renderer.subset_view(renderer.pack_attrs(attrs0), subset)
    d_p = torch.randn(bucket, PARAM_DIM, device=dev, generator=torch.Generator(device=dev).manual_seed(0))

    got, want = pp.preprocess_kernel(view, cam, shape, rcfg), pp.preprocess_fwd_plain(view, cam, shape, rcfg)
    check(torch.equal(got[3], want[3]) and same_bits(got[:3], want[:3]),
          "preprocess: the forward kernel is not bitwise its plain version")
    leaves = {f: getattr(view, f).detach().clone().requires_grad_(True) for f in pp.GRAD_FIELDS[:5]}
    lview = dataclasses.replace(view, **leaves)
    want_g = torch.autograd.grad(pp.preprocess_fwd_plain(lview, cam, shape, rcfg)[0], list(leaves.values()), d_p)
    need = (True,) * 5 + (False,)
    got_g = pp.preprocess_bwd_kernel(view, cam, shape, rcfg, False, d_p, None, need)[:5]
    plain_g = pp.preprocess_bwd_plain(view, cam, shape, rcfg, False, d_p, None, need)[:5]
    errs = [float(torch.linalg.vector_norm(k - w) / torch.linalg.vector_norm(w)) for k, w in zip(got_g, want_g)]
    check(all(torch.equal(k, p) for k, p in zip(got_g, plain_g)) and max(errs) <= 1e-5,
          f"preprocess: the backward kernel against its plain version / autograd ({errs})")
    # the phase's own path, before the timing loops: the view statistics,
    # the compaction and the two checked calls
    launches = {k.name: k.launches for k in pp.KERNELS}
    print(f"preprocess phase: launches {launches}")
    check(launches["preprocess_bwd"] == 1 and launches["preprocess_fwd"] > 1,
          f"preprocess phase: launches {launches}")

    def through(fwd):
        def step():
            return torch.autograd.grad(fwd(lview, cam, shape, rcfg)[0], list(leaves.values()), d_p)
        return step

    timed = {
        "preprocess_fwd": (lambda: pp.preprocess_kernel(view, cam, shape, rcfg),
                           lambda: pp.preprocess_fwd_plain(view, cam, shape, rcfg)),
        "preprocess_bwd": (lambda: pp.preprocess_bwd_kernel(view, cam, shape, rcfg, False, d_p, None, need),
                           lambda: pp.preprocess_bwd_plain(view, cam, shape, rcfg, False, d_p, None, need)),
    }
    rec = {"subset_bucket": bucket, "in_view": int(want[3].sum()), "bwd_rel_l2": max(errs), "launches": launches}
    for name, (kfn, pfn) in timed.items():
        ms, plain_ms = time_ms(kfn, TIMED_LAUNCHES), time_ms(pfn, TIMED_LAUNCHES)
        kern = pp.fwd_kernel if name == "preprocess_fwd" else pp.bwd_kernel
        dev_ms = kernel_device_ms(kfn, TIMED_LAUNCHES, kern, f"preprocess::{name}_kernel")
        bound = bucket * PRE_BYTES[name] / PEAK_BYTES_PER_S * 1e3
        rec[name] = {"ms": ms, "device_ms": dev_ms[0][0], "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes"}
        print(f"{name} ({bucket} gaussians, {rec['in_view']} in view): events {ms:.4f} ms, device "
              f"{dev_ms[0][0]:.4f} ms (plain {plain_ms:.3f} ms), bound {bound:.4f} ms at {PRE_BYTES[name]} bytes a "
              "gaussian")
    for name, fwd in (("kernel_path", pp.preprocess), ("plain_path", pp.preprocess_fwd_plain)):
        step = through(fwd)
        rec[name] = {"ms": time_ms(step, TIMED_LAUNCHES), **device_busy(step)}
        print(f"preprocess forward and backward, {name}: events {rec[name]['ms']:.4f} ms, device busy "
              f"{rec[name]['busy_ms']:.4f} ms, {rec[name]['launched']} device operations launched")
    print(f"preprocess backward kernel against autograd: rel L2 {max(errs):.3g}")
    return rec


def bench_mission_phase() -> dict:
    """Path 7 (bench_mission): `scripts.bench_mission.main` for
    P7_MISSION_STEPS steps with no prewarm (the earlier paths have built
    everything), recorded into P7_DIR; checks the steady window and that
    every f32 compositor kernel ran. Returns the record."""
    from activegs_torch.render import composite as cp
    from activegs_torch.scripts import bench_mission

    argv = [f"steps={P7_MISSION_STEPS}", "prewarm=0", f"out={P7_DIR / 'bench_mission'}"]
    _zero_launches()
    t0 = time.perf_counter()
    result = bench_mission.main(argv)
    wall = time.perf_counter() - t0
    launches = _launches()
    print(f"bench_mission (python -m activegs_torch.scripts.bench_mission {' '.join(argv)}): mapping median "
          f"{result['value']:.3f} s, planning median {result['planning_s_median']:.3f} s over steps "
          f"{result['steady_steps']}; launches {launches} ({wall:.2f} s)")
    check(result["value"] is not None and math.isfinite(result["value"])
          and result["steady_steps"] == list(range(bench_mission.STEADY_FROM, P7_MISSION_STEPS + 1)),
          f"bench_mission result {result}")
    check(all(launches[k.name] > 0 for k in cp.KERNELS), f"bench_mission: a kernel was not launched: {launches}")
    check_preprocess("bench_mission", launches, trains=True)
    return {"result": result, "launches": launches, "seconds": wall}


def truncation_phase() -> dict:
    """Path 7 (validate_truncation): `scripts.validate_truncation.main` on
    the bench_mission path's final map and its 8 cameras, at 512x512 and at
    `mesh_app`'s 1024x1024; checks 8 views each and that the reference
    config drops no more entries than production on any view. Returns the
    record."""
    from activegs_torch.scripts import validate_truncation

    map_dir = P7_DIR / "bench_mission" / "map"
    out, launches = {}, {}
    _zero_launches()
    t0 = time.perf_counter()
    for size in (RES, 2 * RES):
        res = validate_truncation.main([f"map={map_dir / 'map_final.npz'}", f"cams={map_dir / 'cameras_final.json'}",
                                        "n_views=8", f"shape={size}", f"out={P7_DIR / f'truncation_{size}.json'}"])
        views = res["views"]
        out[f"{size}x{size}"] = {k: res[k] for k in ("value", "min_psnr", "mean_depth_mse", "mean_dropped_prod",
                                                     "mean_dropped_ref", "n_gaussians")}
        print(f"validate_truncation, {size}x{size}, {len(views)} views of the bench_mission map "
              f"({res['n_gaussians']} gaussians): PSNR production against reference config mean {res['value']:.2f} "
              f"dB, min {res['min_psnr']:.2f} dB; depth MSE mean {res['mean_depth_mse']:.3g}; num_dropped mean "
              f"{res['mean_dropped_prod']} against {res['mean_dropped_ref']}")
        check(len(views) == 8, f"validate_truncation {size}: {len(views)} views")
        check(all(v["dropped_ref"] <= v["dropped_prod"] for v in views),
              f"validate_truncation {size}: the reference config dropped more than production: {views}")
    wall = time.perf_counter() - t0
    launches = _launches()
    check_preprocess("validate_truncation", launches, trains=False)
    return {**out, "launches": launches, "seconds": wall}


def sweep_smoke_phase() -> dict:
    """Path 7 (run_sweep): `scripts.run_sweep.main` with P7_SWEEP (tworoom,
    the confidence planner, one seed, a 20 s budget, 16 test views, a
    2-step warm-up); checks that each run wrote `final_result.json` and
    `run_info.json` and that the summary has each planner's cell. Returns
    the record."""
    from activegs_torch.render import composite as cp
    from activegs_torch.scripts import run_sweep

    _zero_launches()
    t0 = time.perf_counter()
    summary = run_sweep.main(P7_SWEEP)
    wall = time.perf_counter() - t0
    launches = _launches()
    cells = summary["scenes"].get("tworoom", {})
    for planner in P7_SWEEP_PLANNERS:
        run_dir = P7_DIR / "experiments" / "sweep_smoke" / "tworoom" / planner / "0"
        for f in (run_dir / "final_result.json", run_dir / "run_info.json"):
            check(f.exists(), f"sweep smoke: {f} not written")
        check(cells.get(planner, {}).get("n_runs") == 1 and "mean_psnr" in cells[planner]["final"],
              f"sweep smoke: cell {planner}: {cells.get(planner)}")
    finals = {p: {m: cells[p]["final"][m]["mean"] for m in ("mean_psnr", "mesh_completion_ratio")
                  if m in cells[p]["final"]} for p in cells}
    print(f"sweep smoke (python -m activegs_torch.scripts.run_sweep {' '.join(P7_SWEEP)}): finals {finals}; missions "
          + "; ".join(f"{m['planner']} {m['steps']} steps, first step's mapping {m['t_mapping_first']:.2f} s against "
                      f"{m['t_mapping_median_rest']} s" for m in summary["missions"])
          + f"; launches {launches} ({wall:.2f} s)")
    check(all(launches[k.name] > 0 for k in cp.KERNELS), f"sweep smoke: a kernel was not launched: {launches}")
    check_preprocess("sweep smoke", launches, trains=True)
    return {"finals": finals, "missions": summary["missions"], "launches": launches, "seconds": wall}


# path 8: tiles other than the default 16x32, and the profiling scripts
P8_TILES = {"32x32": (32, 32), "16x16": (16, 16), "8x16": (8, 16)}
P8_DIR = Path("build/path8")
P8_CLI_STEPS = 2  # the second step's frame comes from the first plan step
P8_CLI = ["mapper.raster.tile_h=32", "mapper.raster.tile_w=32", f"max_steps={P8_CLI_STEPS}",
          f"experiment.output_dir={P8_DIR / 'cli_mission'}", "experiment.exp_id=chip_smoke"]
P8_SCRIPT_STEPS = 2  # BENCH_STEPS of the scripts' runs: full width, cut depth
P8_TRACED = {"profile_step": "phases", "profile_planner": "timings"}  # the traced scripts' records of phases
P8_PLANNER_CANDIDATES = 25  # profile_planner's candidates here (a plan step's 100 in full runs)


def tile_views(state, buf, cfg) -> dict:
    """Keyframe 5's view at each tile of P8_TILES (`RasterConfig()` but the
    tile), built while path 1's map lives: {tile: (the forward wrapper's
    arguments, as `compare` builds them, and the stats wrapper's,
    `stats_view`)}."""
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import keyframes as kf
    from activegs_torch.mapping import trainer
    from activegs_torch.render import binning, renderer
    from activegs_torch.render import preprocess as pp
    from activegs_torch.render.types import Camera, RasterConfig

    dev = state.means.device
    attrs = gm.attrs_of(gm.slice_state(state, gm.bucket_capacity(state.count, cfg.capacity)), cfg)
    _, _, ext, intr = kf.decode_frames(buf, torch.tensor([buf.count - 1], device=dev))
    cam, shape = Camera(ext[0], intr[0]), (RES, RES)
    views = {}
    for name, (th, tw) in P8_TILES.items():
        rcfg = RasterConfig(tile_h=th, tile_w=tw)
        _, _, ntx, _ = binning.bin_tile_dims(shape, rcfg)
        with torch.no_grad():
            p2d, _, dz, iv = pp.preprocess(attrs, cam, shape, rcfg)
            budget = trainer.pick_entry_bucket(int(binning.entry_count(p2d, iv, shape, rcfg)))
            b = binning.bin_entries(p2d, dz, iv, shape, rcfg, budget)
            ent = renderer.gather_entries(p2d, b.gid)
        views[name] = ((ent, b.tile_start, b.tile_len, ntx, rcfg), stats_view(state, buf, cfg, rcfg))
    return views


def tiles_phase(views: dict, tops: dict) -> dict:
    """Path 8 (kernels): on keyframe 5's view at each tile of P8_TILES
    (`tile_views`), fwd and bwd, f32 and bf16, and at 32x32 stats too, each
    held against its plain version at paths 1 and 3's tolerances (fwd
    images 2e-5, depth 1e-4, the same stop rows; bwd per-entry gradients
    3e-4 scaled, bf16 each row 2e-3 of its largest; stats `check_stats`)
    and timed (CUDA events, a median of TIMED_LAUNCHES; stats also by
    device time, replay and ranking), with its plain version's time; each
    32x32 kernel gets the bounds of PERF.md section 6 (data sheet, the
    probe's measured rates, and the forward's live work). Returns {kernel
    name: {tile: record}}."""
    from activegs_torch.render import composite as cp
    from activegs_torch.render.types import O_DEPTH, O_STOP, O_TRANS

    img_rows = [r for r in range(O_TRANS + 1) if r != O_DEPTH]
    recs = {}
    for tile, (fwd_args, stats_args) in views.items():
        ent, ts, tl, ntx, rcfg = fwd_args
        for bf16 in (False, True):
            cfg = dataclasses.replace(rcfg, bf16_pairs=bf16)
            sfx = "_bf16" if bf16 else ""
            args = (ent, ts, tl, ntx, cfg)
            o_k, o_p = cp.composite_fwd(*args), cp.composite_fwd_plain(*args)
            e_img = float((o_k[:, img_rows] - o_p[:, img_rows]).abs().max())
            e_dep = float((o_k[:, O_DEPTH] - o_p[:, O_DEPTH]).abs().max())
            stop_ok = torch.equal(o_k[:, O_STOP], o_p[:, O_STOP])
            check(e_img <= 2e-5 and e_dep <= 1e-4 and stop_ok, f"fwd{sfx} at {tile} tiles disagrees with its plain "
                  f"version: image {e_img:.3g} depth {e_dep:.3g} stop rows equal {stop_ok}")
            stop = o_k[:, O_STOP, 0]
            pairs = real_pairs(tl, stop, cfg.chunk, cfg.tile_pixels)
            g = torch.randn(o_k.shape, generator=torch.Generator(device=ent.device).manual_seed(SEED),
                            device=ent.device)
            g[:, O_TRANS + 1 :] = 0.0
            d_k, d_p = cp.composite_bwd(*args[:3], o_k, g, ntx, cfg), cp.composite_bwd_plain(*args[:3], o_k, g, ntx, cfg)
            rows = [float((d_k[r] - d_p[r]).abs().max() / d_p[r].abs().max().clamp(min=1e-12)) for r in range(18)]
            e_bwd = max(rows) if bf16 else scaled_err(d_k, d_p)
            check(e_bwd <= (2e-3 if bf16 else 3e-4), f"bwd{sfx} at {tile} tiles disagrees with its plain version: "
                  f"{e_bwd:.3g}")
            live, all_rows = cp.live_warp_rows(*args[:3], stop, ntx, cfg)
            calls = {
                "composite_fwd": (lambda a=args: cp.composite_fwd(*a), lambda a=args: cp.composite_fwd_plain(*a),
                                  max(e_img, e_dep), 18 * ent.shape[1] * 4 + o_k.numel() * 4),
                "composite_bwd": (lambda a=args, o=o_k, gg=g: cp.composite_bwd(*a[:3], o, gg, *a[3:]),
                                  lambda a=args, o=o_k, gg=g: cp.composite_bwd_plain(*a[:3], o, gg, *a[3:]),
                                  float((d_k - d_p).abs().max()),
                                  18 * ent.shape[1] * 4 + 2 * o_k.numel() * 4 + d_k.numel() * 4),
            }
            s_pairs = None
            if tile == "32x32":
                s_args = (*stats_args[:-1], dataclasses.replace(stats_args[-1], bf16_pairs=bf16))
                e_imp = check_stats(f"{KF_STATS_VIEW} at 32x32 tiles", s_args)
                s_stop = cp.composite_fwd(*s_args[:3], *s_args[5:])[:, O_STOP, 0]
                s_pairs = real_pairs(s_args[2], s_stop, cfg.chunk, cfg.tile_pixels)
                calls["composite_stats"] = (lambda a=s_args: cp.composite_stats(*a),
                                            lambda a=s_args: cp.composite_stats_plain(*a), e_imp,
                                            18 * s_args[0].shape[1] * 4 + s_args[3].numel() * 4
                                            + 2 * s_args[0].shape[1] * 4)
            del o_p, d_k, d_p
            for name, (kfn, pfn, err, nbytes) in calls.items():
                n_pairs = s_pairs if name == "composite_stats" else pairs
                ms = time_ms(kfn, TIMED_LAUNCHES)
                plain_ms = time_ms(pfn, PLAIN_RUNS if tile == "32x32" else 1)
                rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "pairs": n_pairs,
                       "tiles": len(ts), "cluster_blocks": cp.fwd_cluster_size(cfg) if name == "composite_fwd" else None}
                if name == "composite_stats":
                    kern = cp.stats_bf16_kernel if bf16 else cp.stats_kernel
                    parts = kernel_device_ms(kfn, TIMED_LAUNCHES, kern, "stats_kernel<", "tile_rank_kernel")
                    rec["device_ms"] = parts[0][0] + parts[1][0]
                if tile == "32x32":
                    if bf16:
                        rec.update(bf16_bounds(name, n_pairs, nbytes, tops))
                    else:
                        t_ops = n_pairs * OPS_PER_PAIR[name] / PEAK_FP32_FLOPS * 1e3
                        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
                        rec.update(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                                   measured_rate_bound_ms=measured_rate_bound_ms(name, n_pairs, tops))
                    if name == "composite_fwd" and not bf16:
                        rec["live_work_bound_ms"] = live_work_bound_ms(n_pairs, 32 * live, tops)
                if name != "composite_stats":
                    rec["live_row_share"] = live / all_rows
                if tile == "32x32" and (not bf16 or name == "composite_stats"):
                    rec["build"] = kernel_build(cp, name + sfx, cfg)
                    print(f"{name}{sfx} build at 32x32 tiles: {rec['build']}")
                recs.setdefault(name + sfx, {})[tile] = rec
                print(f"{name}{sfx}, {KF_VIEW} at {tile} tiles ({len(ts)} tiles"
                      + (f", clusters of {rec['cluster_blocks']} blocks of {cfg.tile_pixels // rec['cluster_blocks']} "
                         f"threads" if rec["cluster_blocks"] else "")
                      + f"): against plain, max abs err {err:.3g}; {ms:.4f} ms (CUDA events, median of "
                      f"{TIMED_LAUNCHES})" + (f", device {rec['device_ms']:.4f} ms" if "device_ms" in rec else "")
                      + f"; plain {plain_ms:.2f} ms"
                      + (f"; bound {rec['bound_ms']:.4f} ms data sheet ({rec['bound_by']}), "
                         f"{rec['measured_rate_bound_ms']:.4f} ms at the probe's measured rates" if "bound_ms" in rec
                         else "")
                      + (f", live-work bound {rec['live_work_bound_ms']:.4f} ms" if "live_work_bound_ms" in rec else "")
                      + f" ({n_pairs} pairs)")
    return recs


def tile_mission_phase() -> dict:
    """Path 8 (mission): `activegs_torch.apps.main.main()` with 32x32 tiles
    (P8_CLI: the port's own configs at full width otherwise, 512x512,
    capacity 2^19, 100 candidates at 128x128) for P8_CLI_STEPS steps, the
    counters zeroed before and read after: spawn, train, post_process and
    a plan step, every f32 kernel launched and no bf16 instance; the
    losses finite. Returns {kernel: launches}."""
    from activegs_torch.apps import main as app
    from activegs_torch.mapping.mapper import IncrementalMapper
    from activegs_torch.render import composite as cp

    step, losses = IncrementalMapper.step, []

    def counted_step(mapper):
        st = step(mapper)
        losses.append(st["loss"])
        return st

    _zero_launches()
    t0 = time.perf_counter()
    with mock.patch.object(IncrementalMapper, "step", counted_step):
        mapper = app.main(P8_CLI)
    torch.cuda.synchronize()
    launches = _launches()
    rc = mapper.raster_cfg
    print(f"tile mission (python -m activegs_torch.apps.main {' '.join(P8_CLI)}): {len(losses)} steps in "
          f"{time.perf_counter() - t0:.2f} s, tiles {rc.tile_h}x{rc.tile_w}, losses "
          + " ".join(f"{x:.5f}" for x in losses) + f"; launches {launches}")
    check((rc.tile_h, rc.tile_w) == (32, 32), f"tile mission: tiles {rc.tile_h}x{rc.tile_w}")
    check(len(losses) == P8_CLI_STEPS and all(math.isfinite(x) for x in losses), f"tile mission losses {losses}")
    check(all(launches[k.name] > 0 for k in cp.KERNELS) and all(launches[k.name] == 0 for k in cp.BF16_KERNELS),
          f"tile mission launches {launches}")
    check_preprocess("tile mission", launches, trains=True)
    return launches


def scripts_phase() -> dict:
    """Path 8 (scripts): each profiling script of `activegs_torch/scripts/`
    once through its `main`, at full width and BENCH_STEPS=P8_SCRIPT_STEPS
    (`profile_planner` over P8_PLANNER_CANDIDATES candidates), the counters
    zeroed before each and read after; checks each closing JSON line, and
    that each phase that `profile_step` and `profile_planner` trace
    recorded every device operation its runtime calls launched. Returns
    {script: {"line": its figures, "launches"}}."""
    from activegs_torch.render import composite as cp
    from activegs_torch.scripts import bench, kernel_overhead, profile_bwd, profile_mission_train
    from activegs_torch.scripts import profile_planner, profile_step, profiling, tile_scan

    runs = {
        "tile_scan": lambda: tile_scan.main([]),
        "kernel_overhead": lambda: kernel_overhead.main([]),
        "profile_bwd": lambda: profile_bwd.main([]),
        "profile_step": lambda: profile_step.main(["runs=1", f"trace={P8_DIR / 'trace'}"]),
        "profile_planner": lambda: profile_planner.main([f"cands={P8_PLANNER_CANDIDATES}", "runs=1"]),
        "profile_mission_train": lambda: profile_mission_train.main([]),
        "bench_scaling": lambda: bench.main(["scaling=1"]),
    }
    out = {}
    with mock.patch.dict("os.environ", {"BENCH_STEPS": str(P8_SCRIPT_STEPS)}):
        for name, run in runs.items():
            _zero_launches()
            t0 = time.perf_counter()
            line = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches()
            if name == "bench_scaling":  # its ranks run in processes of their own
                launches = line["lines"][0]["launches"]
            out[name] = {"line": line, "launches": launches, "seconds": wall}
            print(f"script {name}: {wall:.2f} s; launches {launches}")
            if name == "tile_scan":
                check(len(line["rows"]) == 4 and line["errors"] == 0 and all(r["rays_per_s"] > 0 for r in line["rows"]),
                      f"tile_scan: {line['rows']}")
            elif name == "kernel_overhead":
                check(line["empty_trans_min"] == line["empty_trans_max"] == 1.0 and line["empty_rows_abs_max"] == 0.0
                      and line["value"] > 0, f"kernel_overhead: {line}")
            elif name == "profile_bwd":
                check(all(t["fwd"] > 0 and t["fwd_bwd"] > 0 for t in line["components"].values()), f"profile_bwd {line}")
            elif name == "profile_step":
                ph = line["phases"]
                check(all(p["device_busy_ms"] > 0 for p in ph.values()) and line["op_ledger"]
                      and all(abs(line["derived"][d]["host_ms"] - (ph[a]["host_ms"] - ph[b]["host_ms"])) < 1e-9
                              for d, (a, b) in profile_step.DERIVED.items()), f"profile_step {line}")
            elif name == "profile_planner":
                check(all(t["device_busy_ms"] > 0 for t in line["timings"].values()), f"profile_planner {line}")
            elif name == "profile_mission_train":
                check(math.isfinite(line["value"]) and line["value"] > 0, f"profile_mission_train {line}")
            else:
                first = line["lines"][0]
                check(first["mesh_devices"] == 1 and first["backend"] == "nccl" and first["grad_max_scaled_err"] <= 1e-5,
                      f"bench scaling: {line['lines']}")
            if name in P8_TRACED:
                lossy = {k: (t["device_ops"], t["launched"]) for k, t in line[P8_TRACED[name]].items()
                         if t["device_ops"] < t["launched"]}
                check(not lossy, f"{name}: traces that recorded fewer device operations than were launched, in "
                      f"{profiling.TRACES} tries (recorded, launched): {lossy}")
            if name in ("tile_scan", "kernel_overhead", "profile_bwd", "profile_step", "profile_mission_train",
                        "bench_scaling"):
                check(launches["composite_fwd"] > 0 and launches["composite_bwd"] > 0, f"{name}: launches {launches}")
            if name in ("profile_bwd", "profile_step", "profile_mission_train", "bench_scaling"):
                check_preprocess(name, launches, trains=True)
            if name == "profile_planner":
                check(launches["composite_fwd"] > 0, f"{name}: launches {launches}")
                check_preprocess(name, launches, trains=False)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", metavar="DIR",
                        help="also hold each compositor kernel whose source differs in the checkout DIR against "
                             "this one's, bitwise, and time the two in turns")
    parser.add_argument("--stats-schedule", action="store_true",
                        help="also time the stats kernel against builds without its tile ranking and without "
                             "its cap of 2 blocks an SM")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU")
    try:
        from activegs_torch.render import _build
        from activegs_torch.render import composite as cp
        from activegs_torch.render import preprocess as pp
        from activegs_torch.scripts import microbench_bf16, microbench_vpu
    except ImportError as e:
        fail(f"the activegs_torch package is not beside this script ({e})")
    card = smi()
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    all_kernels = (*cp.KERNELS, *cp.BF16_KERNELS, *pp.KERNELS, *microbench_vpu.KERNELS, *microbench_bf16.KERNELS)
    logs = _build.build_all(list(dict.fromkeys((k.csrc, k.source) for k in all_kernels)))
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({len(logs)} compiled)")
    for name, log in logs.items():
        for func, (regs, spills) in ptxas_usage(log).items():
            print(f"  {name}: {func}: {regs} registers, {spills} bytes spilled")

    dev = torch.device("cuda")
    phase_s = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        phase_s[name] = time.perf_counter() - t
        return out

    state, buf, map_launches, cfg, rcfg, psnr_kf1 = timed("1 mapping", main_path, dev)
    fwd_build = kernel_build(cp, "composite_fwd", rcfg)
    print(f"composite_fwd build: {fwd_build}")
    errs, inputs, (live, rows), views = timed("1 checks", compare, state, buf, cfg, rcfg)
    p8_views = timed("8 tile views", tile_views, state, buf, cfg)
    stats_cull = {view: stats_cull_line(view, args) for view, args in views["composite_stats"].items()}
    stats_builds = {name: kernel_build(cp, name, rcfg) for name in ("composite_stats", "composite_stats_bf16")}
    for name, build in stats_builds.items():
        print(f"{name} build: {build}")
    kf_batch = timed("1 batched", keyframe_batched_phase, state, buf, cfg, rcfg)
    fused = timed("1 fused", fused_check, state, buf, cfg, rcfg)
    export_keyframe_batch(state, buf, cfg, rcfg)
    del state, buf
    torch.cuda.empty_cache()
    probes, tops = timed("2 probes", probe_phase, dev)
    mission_launches, mapper = timed("3 mission", mission_phase, dev)
    utility_check(mapper)
    # the second stats view: post_process's call on the mission's final map
    m_view = f"mission final map (step {MISSION_STEPS}), latest keyframe, front only"
    m_args = stats_view(mapper.gm_state, mapper.keyframes, mapper.map_cfg, mapper.raster_cfg)
    errs["composite_stats"] = max(errs["composite_stats"], check_stats(m_view, m_args))
    check_stats(m_view, (*m_args[:-1], dataclasses.replace(m_args[-1], bf16_pairs=True)))
    stats_cull[m_view] = stats_cull_line(m_view, m_args)
    views["composite_stats"][m_view] = m_args
    # the bf16 instances on the f32 instances' views (`--parent` holds each against the parent's)
    for name in ("composite_fwd", "composite_bwd", "composite_stats"):
        views[f"{name}_bf16"] = {view: (*a[:-1], dataclasses.replace(a[-1], bf16_pairs=True))
                                 for view, a in views[name].items()}
    candidate, cand_view, plan_grid = timed("3 candidates", candidate_phase, mapper, tops)
    views["composite_fwd"].update(cand_view)
    profile = timed("3 plan step profile", plan_step_profile, mapper)
    stats_turns = timed("3 stats in turns", stats_turns_phase, views["composite_stats"])
    bf16 = timed("3 bf16", bf16_phase, views, plan_grid, tops, stats_turns)
    export_plan_step(mapper)
    p6_checkpoint = checkpoint_phase(mapper)
    del mapper, plan_grid
    torch.cuda.empty_cache()
    cli_launches = timed("4 cli mission", cli_mission_phase)
    fwd_1024, offline_launches, offline = timed("5 offline eval", offline_eval_phase, dev, tops)
    torch.cuda.empty_cache()
    p6 = {"resample": timed("6a resample", resample_phase, dev, psnr_kf1)}
    torch.cuda.empty_cache()
    p6["sharded"] = timed("6b sharded", sharded_phase, card)
    p6["viewers"] = timed("6c viewers", viewer_phase, dev)
    p6["checkpoint"] = p6_checkpoint
    p6_launches = {part: rec["launches"] for part, rec in p6.items() if "launches" in rec}
    torch.cuda.empty_cache()
    p7 = {"bench": timed("7 bench", bench_phase, dev)}
    torch.cuda.empty_cache()
    p7["preprocess"] = timed("7 preprocess", preprocess_phase, dev)
    torch.cuda.empty_cache()
    p7["bench_mission"] = timed("7 bench_mission", bench_mission_phase)
    p7["validate_truncation"] = timed("7 validate_truncation", truncation_phase)
    torch.cuda.empty_cache()
    p7["sweep_smoke"] = timed("7 sweep smoke", sweep_smoke_phase)
    p7_launches = {part: rec["launches"] for part, rec in p7.items()}
    torch.cuda.empty_cache()
    p8_tiles = timed("8 tiles", tiles_phase, p8_views, tops)
    del p8_views
    torch.cuda.empty_cache()
    p8 = {"tile_mission": {"launches": timed("8 tile mission", tile_mission_phase)}}
    torch.cuda.empty_cache()
    p8.update(timed("8 scripts", scripts_phase))
    p8_launches = {part: rec["launches"] for part, rec in p8.items()}
    path_launches = {**p6_launches, **p7_launches, **p8_launches}
    pairs = kf_batch["kf_batch_pairs"]
    kf_batch.update(kf_batch_bwd_bound_ms=pairs * OPS_PER_PAIR["composite_bwd"] / PEAK_FP32_FLOPS * 1e3,
                    kf_batch_bwd_measured_rate_bound_ms=measured_rate_bound_ms("composite_bwd", pairs, tops))
    print(f"composite_bwd, keyframe-{KEYFRAMES} batch as one tpv launch: bound {kf_batch['kf_batch_bwd_bound_ms']:.4f} "
          f"ms data sheet, {kf_batch['kf_batch_bwd_measured_rate_bound_ms']:.4f} ms at the probe's measured rates "
          f"({pairs} pairs)")

    # the stats launch's two kernels, by device time in turns with the bf16 instance
    stats_device = {view: {"replay": rec["replay_ms"]["f32"], "rank": rec["rank_ms"]}
                    for view, rec in stats_turns.items()}
    kernels = []
    for name, (kfn, pfn, pairs, nbytes) in inputs.items():
        # stats: its device time in turns (stats_turns_phase), not its event time, which the host work holds
        if name == "composite_stats":
            ms = stats_turns[KF_STATS_VIEW]["device_ms"]["f32"]
        else:
            ms = time_ms(kfn, TIMED_LAUNCHES)
        plain_ms = time_ms(pfn, PLAIN_RUNS)
        t_ops = pairs * OPS_PER_PAIR[name] / PEAK_FP32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        measured = measured_rate_bound_ms(name, pairs, tops)
        extra = {"live_row_share": live / rows} if name in ("composite_fwd", "composite_bwd") else {}
        if name == "composite_fwd":
            extra.update(live_work_bound_ms=live_work_bound_ms(pairs, 32 * live, tops),
                         cluster_blocks=cp.fwd_cluster_size(rcfg), build=fwd_build, **candidate,
                         plan_step_profile=profile, **{"1024x1024": fwd_1024}, offline_eval=offline)
        if name == "composite_bwd":
            extra.update(**kf_batch, fused_view_kernel=fused)
        extra["tiles"] = p8_tiles[name]
        if name == "composite_stats":
            extra.update(live_row_share=stats_cull[KF_STATS_VIEW]["live_row_share"],
                         build=stats_builds[name], views=stats_cull, device_ms=stats_device,
                         events_ms=stats_turns[KF_STATS_VIEW]["events_median_ms"]["f32"])
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"activegs_torch/render/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": mission_launches[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "measured_rate_bound_ms": measured,
            **extra,
            "launches_by_path": {"mapping": map_launches[name], "mission": mission_launches[name],
                                 "offline_eval": offline_launches[name],
                                 **{part: n.get(name, 0) for part, n in path_launches.items()}},
        })
        print(f"{name}: {ms:.4f} ms (plain {plain_ms:.3f} ms), bound {bound:.4f} ms data sheet, "
              f"{measured:.4f} ms at the probe's measured rates ({pairs} pairs), "
              f"{map_launches[name] / KEYFRAMES:.1f} launches per fixed-pose keyframe, "
              f"{mission_launches[name]} in the {MISSION_STEPS}-step mission, {offline_launches[name]} in the offline "
              f"evaluation"
              + (f"; live-work bound {extra['live_work_bound_ms']:.4f} ms at the measured rates"
                 if "live_work_bound_ms" in extra else ""))
    for kern in cp.BF16_KERNELS:
        recs = bf16[kern.name]  # the keyframe-5 view first
        kernels.append({
            "name": kern.name,
            "route": "cuda",
            "source": f"activegs_torch/render/csrc/{kern.source}.cu",
            "replaces": REPLACES[kern.name],
            "launches": cli_launches[kern.name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            **{k: recs[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            "measured_rate_bound_ms": recs[0]["measured_rate_bound_ms"],
            "f32_ms": recs[0]["f32_ms"],
            "tiles": p8_tiles[kern.name],
            **({"live_row_share": recs[0]["live_row_share"], "build": stats_builds[kern.name],
                "turns": stats_turns} if kern.name in stats_builds else {}),
            "views": recs,
            "launches_by_path": {"cli_mission": cli_launches[kern.name], "offline_eval": offline_launches[kern.name],
                                 **{part: n.get(kern.name, 0) for part, n in path_launches.items()}},
        })
    for kern in pp.KERNELS:
        rec = p7["preprocess"][kern.name]
        kernels.append({"name": kern.name, "route": "cuda", "source": "activegs_torch/render/csrc/preprocess.cu",
                        "replaces": REPLACES[kern.name], "launches": mission_launches[kern.name], **rec,
                        "library_ms": None,
                        "launches_by_path": {"mapping": map_launches[kern.name], "mission": mission_launches[kern.name],
                                             "cli_mission": cli_launches[kern.name],
                                             "offline_eval": offline_launches[kern.name],
                                             **{part: n.get(kern.name, 0) for part, n in path_launches.items()}}})
    for name, rec in probes.items():
        kernels.append({"name": name, "replaces": REPLACES[name], **rec})
    if args.stats_schedule:
        stats_schedule_phase(views["composite_stats"])
    if args.parent:
        parent_in_turns(views, args.parent)
    print("path 6: " + json.dumps({part: {k: v for k, v in rec.items() if k not in ("ranks", "keyframes")}
                                     for part, rec in p6.items()}))
    print("path 7: " + json.dumps({part: {k: v for k, v in rec.items() if k not in ("missions",)}
                                     for part, rec in p7.items()}, default=str))
    print("path 8: " + json.dumps({"tiles": p8_tiles, **p8}, default=str))
    print("phase seconds: " + json.dumps({k: round(v, 2) for k, v in phase_s.items()})
          + f"; all phases {sum(phase_s.values()):.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
