"""The arithmetic the benchmark copied, against the port's originals, and
the roofline's live-pair count against a brute-force count."""

import numpy as np
import pytest
import torch

from activegs_torch.mapping import gaussians as gm
from activegs_torch.mapping import trainer
from activegs_torch.render import composite as cp
from activegs_torch.render.types import O_STOP, PARAM_DIM, RasterConfig
from activegs_torch.scripts import bench, bench_mission
from harness import arith, roofline


def test_planning_matches_bench_mission():
    steps = [{"frame_id": 4 + i, "t_mapping": 1.0 + 0.1 * i, "phase_times": {"train": 0.9},
              "plan_times": {"masks": 0.01 * i, "roi_rand": 0.02, "utility": 1.5 + i, "astar": 0.004,
                             "utility_stats": 0.6, "utility_batch": 0.9 + i},
              "n_gaussians": 10, "capacity_bucket": 16, "num_dropped": 0} for i in range(5)]
    want = bench_mission.summarize(steps)["planning_s"]
    got = round(float(np.mean([arith.planning_s(s["plan_times"]) for s in steps])), 3)
    assert got == want
    assert [arith.planning_s(s["plan_times"]) for s in steps] == [bench_mission._planning(s) for s in steps]


def test_rays_count_matches_bench():
    rec = {"steps": 10, "res": 512}
    assert arith.rays(rec["steps"], bench.BATCH, rec["res"], rec["res"]) == 10 * 8 * 512 * 512


@pytest.mark.parametrize("n", [0, 1, 8191, 8192, 9000, 12289, 70000, 200000, 400000])
def test_buckets_match_the_port(n):
    assert arith.bucket_capacity(n, 1 << 19) == gm.bucket_capacity(n, 1 << 19)
    assert arith.subset_bucket(n, 1 << 18) == trainer.pick_subset_bucket(n, 1 << 18)
    assert arith.entry_budget(n) == trainer.pick_entry_bucket(n)


def _brute_live(entries, tile_start, tile_len, ntx, cfg, stop):
    """Pairs with alpha > 0 of each tile's real entries in the chunks its
    forward pass composited, one tile and one entry at a time."""
    from activegs_torch.render import preprocess as pp

    px_all, py_all = cp.tile_pixel_coords(len(tile_start), ntx, cfg, entries.device)
    live = 0
    for t in range(len(tile_start)):
        n = min(int(tile_len[t]), int(stop[t]) * cfg.chunk)
        for j in range(n):
            e = entries[:18, int(tile_start[t]) + j][None, None, :]
            alpha, _ = pp.eval_alpha_depth_cols(pp.entry_cols(e), px_all[t : t + 1], py_all[t : t + 1], cfg)
            live += int((alpha > 0).sum())
    return live


def test_live_pairs_against_brute_force():
    g = torch.Generator().manual_seed(3)
    cfg = RasterConfig(chunk=8)
    t_n, ntx = 4, 2
    lens = torch.tensor([13, 0, 20, 5], dtype=torch.int32)
    starts = torch.tensor([0, 16, 16, 40], dtype=torch.int32)
    e = torch.zeros((PARAM_DIM, 48))
    for t in range(t_n):
        s, n = int(starts[t]), int(lens[t])
        x0, y0 = (t % ntx) * cfg.tile_w, (t // ntx) * cfg.tile_h
        e[0, s : s + n] = x0 + torch.rand(n, generator=g) * cfg.tile_w
        e[1, s : s + n] = y0 + torch.rand(n, generator=g) * cfg.tile_h
        e[2, s : s + n] = 0.05 + 0.3 * torch.rand(n, generator=g)
        e[4, s : s + n] = 0.05 + 0.3 * torch.rand(n, generator=g)
        e[5, s : s + n] = 0.6 + 0.39 * torch.rand(n, generator=g)
        e[14, s : s + n] = 1.0
        e[15, s : s + n] = 2.0
        e[17, s : s + n] = 2.0
    out = cp.composite_fwd_plain(e, starts, lens, ntx, cfg)
    stop = out[:, O_STOP, 0]
    got = roofline.live_pairs(e, starts, lens, ntx, cfg, block_pairs=512 * 16)
    assert got["live"] == _brute_live(e, starts, lens, ntx, cfg, stop) > 0
    assert got["real"] == int(lens.sum())
    assert got["reached"] == int(torch.minimum(lens.long(), stop.long() * cfg.chunk).sum())
    assert int(stop.min()) < int(((lens.long() + cfg.chunk - 1) // cfg.chunk).max())  # some tile stopped early


def test_least_seconds_bounds():
    w = {"live": 10**7, "real": 10**5, "reached": 10**5, "tiles": 512}
    fwd = roofline.least_seconds("fwd", w, 512)
    assert fwd == max(43e7 / 67e12, (4 * 18 * 1e5 + 8 * 512 + 40 * 512 * 512) / 3.35e12)
    assert roofline.least_seconds("bwd", w, 512) > fwd


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**33 + 7])
def test_train_cell_draws_every_view_of_the_ring_once(seed):
    """At the train cell's sizes (8 keyframes, batch 8, active 3) the
    weighted sampler's draw holds each view of the ring once, whatever the
    tracked errors, so every keyframe of the window does the same work."""
    from activegs_torch.mapping import keyframes as kf
    from harness import cells

    cell = cells.find("train-bench-200k")
    sampler = cell.config["config"]["mapper"]["gaussian_map"]["sampler"]
    n = cell.traffic["keyframes"]
    buf = kf.init_buffer(n, 2, 2, "cpu")
    buf.count = n
    g = torch.Generator().manual_seed(seed)
    for _ in range(4):
        buf.performance = torch.rand(n, generator=g)
        cfg = gm.MapConfig(batch_size=sampler["batch_size"], active_size=sampler["active_size"])
        ids, counts = trainer.draw_batch(buf, cfg, g)
        assert ids.tolist() == list(range(n)) and counts.tolist() == [1] * n
