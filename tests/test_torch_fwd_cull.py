"""The invariants the forward kernel's cull and cluster split rest on, on the CPU.

`render/csrc/composite_fwd.cu` walks a tile's entries in order for each
pixel, keeping a running in-chunk product `excl`, the transmittance `trans`
and 8 accumulators. It skips the depth, weight and accumulations of every
pair with alpha == 0, and it renders a tile with a cluster of C blocks,
each owning P / C consecutive pixels of the tile, that stop together: a chunk runs while
the OR over the C blocks of each block's "some pixel has T > term_eps" is
set. The kernel cannot run here, so this file emulates its algorithm pixel
by pixel in PyTorch (vectorized over tiles and pixels, sequential over
entries, in the kernel's op order) and shows, on the reference's 64x64
scenes, on `test_torch_gpu.small_surfel_scene` and on
`test_torch_gpu.wall_edge_scene` (an opaque wall whose edge crosses tiles
mid-tile, so a tile's row groups disagree at a stop test), at K = 128 and
K = 8:

- skipping every pair with alpha == 0 changes no bit of the output;
- splitting the stop over C = 2 and 4 row groups gives the bits of C = 1;
- the emulation agrees with `composite.composite_fwd_plain` at the
  reference's tolerances, with the same chunks done;
- on a grid of several views (`tpv`, tiles per view), each view gets the
  bits it gets alone.

Each also holds for bf16 pair math (`bf16`: K = 128, `bf16_pairs`), which
the emulation follows in the rounding contract of `render/composite.py`:
a pair whose bf16 alpha is 0 has w = +0 there too; for a 1024-pixel tile
(`t32x32`: 4 blocks of 256 threads); and for a tile 16 pixels wide
(`t8x16`: 4 blocks of one warp, which spans two pixel rows: the cull tests
alpha, not the geometry, so it stays exact).
"""

import dataclasses

import pytest
import torch

from activegs_torch.render import composite as cp
from activegs_torch.render import preprocess as pp
from activegs_torch.render import types as tt
from test_render import CFG, CFG_SMALL_CHUNK
from test_torch_core import t_attrs, t_like
from test_torch_gpu import scene_entries, small_surfel_scene, wall_edge_scene
from test_torch_render import SCENES

CFGS = {"k128": t_like(tt.RasterConfig, CFG), "k8": t_like(tt.RasterConfig, CFG_SMALL_CHUNK)}
CFGS["bf16"] = dataclasses.replace(CFGS["k128"], bf16_pairs=True)
# a 1024-pixel tile (32x32: 4 blocks of 256 threads, 8 pixel rows each) and
# a tile 16 pixels wide (8x16: 4 blocks of one warp, which spans two rows)
CFGS["t32x32"] = dataclasses.replace(CFGS["k128"], tile_h=32, tile_w=32)
CFGS["t8x16"] = dataclasses.replace(CFGS["k128"], tile_h=8, tile_w=16)
CASES = {
    "random": lambda: t_attrs(SCENES["random"]()),
    "opaque": lambda: t_attrs(SCENES["opaque"]()),
    "small_surfels": lambda: small_surfel_scene(torch.device("cpu")),
    "wall_edge": lambda: wall_edge_scene(torch.device("cpu")),
}


def emulate(entries, tile_start, tile_len, ntx: int, cfg, cull: bool, nsplit: int, tpv=None):
    """The forward kernel's algorithm, pixel by pixel, on a grid of views of
    `tpv` tiles each (None: one view). Returns the output (T, OUT_ROWS, P)
    and the number of (tile, chunk) stop tests at which the `nsplit` row
    groups disagreed (some above term_eps, some not)."""
    t_n, k, p = tile_start.shape[0], cfg.chunk, cfg.tile_pixels
    px, py = cp.tile_pixel_coords(t_n, ntx, cfg, entries.device, tpv)
    nch = (tile_len.to(torch.int64) + k - 1) // k
    trans = torch.ones((t_n, p))
    acc = torch.zeros((t_n, 8, p))  # r g b nx ny nz conf depth
    done = torch.zeros(t_n, dtype=torch.int64)
    split = 0
    for c in range(int(nch.max()) if t_n else 0):
        # each block's __syncthreads_or over its rows, then the OR over the cluster
        above = (trans > cfg.term_eps).reshape(t_n, nsplit, p // nsplit).any(-1)
        run = c < nch
        split += int((run & above.any(-1) & ~above.all(-1)).sum())
        act = torch.nonzero(run & above.any(-1)).squeeze(1)
        if act.numel() == 0:
            break
        # the kernel walks all K entries of the chunk, pad rows included
        e, _ = cp._chunk(entries, tile_start, tile_len, act, c, k, cut=False)
        alpha, depth = pp.eval_alpha_depth_cols(pp.entry_cols(e), px[act], py[act], cfg)
        dt = alpha.dtype  # the pair dtype: float32, or bfloat16 under bf16_pairs
        feats = cp._feats(e).to(dt).float()  # (A, K, 7)
        a_acc, a_trans = acc[act], trans[act]
        t_chunk = a_trans.to(dt)
        excl = torch.ones_like(a_trans)
        for j in range(k):
            al = alpha[:, j]
            w = (al * excl.to(dt) * t_chunk).float()
            terms = torch.cat([feats[:, j, :, None] * w[:, None], (w * depth[:, j])[:, None]], dim=1)
            summed = a_acc + terms
            a_acc = torch.where((al > 0.0)[:, None], summed, a_acc) if cull else summed
            excl = excl * (1.0 - al).float()
        acc[act] = a_acc
        trans[act] = a_trans * excl.to(dt).float()
        done[act] += 1
    stop = done.to(torch.float32)[:, None].expand(t_n, p)
    out = torch.zeros((t_n, tt.OUT_ROWS, p))
    out[:, 0:6], out[:, tt.O_DEPTH], out[:, tt.O_CONF] = acc[:, 0:6], acc[:, 7], acc[:, 6]
    out[:, tt.O_TRANS], out[:, tt.O_STOP] = trans, stop
    return out, split


def same_bits(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def case_entries(case, cfg_id):
    cfg = CFGS[cfg_id]
    args, ntx = scene_entries(CASES[case](), cfg, torch.device("cpu"))
    return args, ntx, cfg


@pytest.mark.parametrize("cfg_id", list(CFGS))
@pytest.mark.parametrize("case", list(CASES))
def test_skipping_dead_pairs_changes_no_bit(case, cfg_id):
    args, ntx, cfg = case_entries(case, cfg_id)
    full, _ = emulate(*args, ntx, cfg, cull=False, nsplit=1)
    culled, _ = emulate(*args, ntx, cfg, cull=True, nsplit=1)
    assert same_bits(culled, full)
    # the cull has pairs to skip and pairs to keep
    live, rows = cp.live_warp_rows(*args, full[:, tt.O_STOP, 0], ntx, cfg)
    assert 0 < live < rows


@pytest.mark.parametrize("cfg_id", list(CFGS))
@pytest.mark.parametrize("case", list(CASES))
def test_cluster_stop_matches_the_tile_wide_stop(case, cfg_id):
    args, ntx, cfg = case_entries(case, cfg_id)
    one, split_one = emulate(*args, ntx, cfg, cull=True, nsplit=1)
    assert split_one == 0
    for nsplit in (2, 4):
        out, split = emulate(*args, ntx, cfg, cull=True, nsplit=nsplit)
        assert same_bits(out, one), nsplit
        assert torch.equal(out[:, tt.O_STOP], one[:, tt.O_STOP])
        if case == "wall_edge":
            # row groups that disagree at a chunk boundary: the OR decides
            assert split > 0, nsplit
    if case in ("small_surfels", "wall_edge"):
        tile_len = args[2].to(torch.int64)
        assert bool((one[:, tt.O_STOP, 0] < (tile_len + cfg.chunk - 1) // cfg.chunk).any())


@pytest.mark.parametrize("cfg_id", list(CFGS))
@pytest.mark.parametrize("case", list(CASES))
def test_emulation_matches_plain(case, cfg_id):
    args, ntx, cfg = case_entries(case, cfg_id)
    out, _ = emulate(*args, ntx, cfg, cull=True, nsplit=cp.fwd_cluster_size(cfg))
    want = cp.composite_fwd_plain(*args, ntx, cfg)
    rows = [r for r in range(tt.O_TRANS + 1) if r != tt.O_DEPTH]
    torch.testing.assert_close(out[:, rows], want[:, rows], rtol=0, atol=2e-5)
    torch.testing.assert_close(out[:, tt.O_DEPTH], want[:, tt.O_DEPTH], rtol=0, atol=1e-4)
    assert torch.equal(out[:, tt.O_STOP :], want[:, tt.O_STOP :])


@pytest.mark.parametrize("cfg_id", list(CFGS))
def test_tpv_grid_renders_each_view_as_alone(cfg_id):
    """A grid of the four scenes' views, their entry streams and tile
    tables concatenated (tile t is tile t % tpv of its view): the emulated
    kernel, with its cull and its cluster stop, gives each view the bits of
    that view rendered alone, and agrees with the plain version's tpv
    grid."""
    cfg = CFGS[cfg_id]
    views = [case_entries(case, cfg_id)[0] for case in CASES]
    _, ntx, _ = case_entries("random", cfg_id)
    tpv = len(views[0][1])
    offs = [0]
    for ent, _, _ in views:
        offs.append(offs[-1] + ent.shape[1])
    grid = (
        torch.cat([v[0] for v in views], dim=1),
        torch.cat([v[1] + o for v, o in zip(views, offs)]),
        torch.cat([v[2] for v in views]),
    )
    nsplit = cp.fwd_cluster_size(cfg)
    out, _ = emulate(*grid, ntx, cfg, cull=True, nsplit=nsplit, tpv=tpv)
    for i, args in enumerate(views):
        alone, _ = emulate(*args, ntx, cfg, cull=True, nsplit=nsplit)
        assert same_bits(out[i * tpv : (i + 1) * tpv], alone), i
    want = cp.composite_fwd_plain(*grid, ntx, cfg, tpv=tpv)
    rows = [r for r in range(tt.O_TRANS + 1) if r != tt.O_DEPTH]
    torch.testing.assert_close(out[:, rows], want[:, rows], rtol=0, atol=2e-5)
    torch.testing.assert_close(out[:, tt.O_DEPTH], want[:, tt.O_DEPTH], rtol=0, atol=1e-4)
    assert torch.equal(out[:, tt.O_STOP :], want[:, tt.O_STOP :])
    # without tpv, every view after the first is shaded at other pixels
    wrong, _ = emulate(*grid, ntx, cfg, cull=True, nsplit=nsplit)
    assert not same_bits(wrong[tpv:], out[tpv:])


@pytest.mark.parametrize(
    "tile_h, tile_w, want",
    [(16, 32, 4), (8, 16, 4), (6, 32, 2), (2, 32, 2), (4, 16, 2), (3, 32, 1), (1, 32, 1),
     (32, 32, 4), (16, 16, 4), (1, 1024, 4), (3, 320, 2), (1, 544, None), (31, 32, None)],
)
def test_fwd_cluster_size(tile_h, tile_w, want):
    """The largest of 4, 2, 1 that leaves a multiple of 32 pixels a block
    and at most 512; a tile of more than 512 pixels in an odd number of
    warps has none, and is refused."""
    cfg = tt.RasterConfig(tile_h=tile_h, tile_w=tile_w)
    if want is None:
        with pytest.raises(ValueError, match="none splits"):
            cp.fwd_cluster_size(cfg)
    else:
        assert cp.fwd_cluster_size(cfg) == want
        assert (cfg.tile_pixels // want) % 32 == 0 and cfg.tile_pixels // want <= cp.FWD_BLOCK_THREADS
