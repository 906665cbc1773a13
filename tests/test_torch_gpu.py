"""The port's CUDA kernels on a GPU, against their plain PyTorch versions.

Every test here is marked `cuda` and skips without a CUDA device (the
kernels have no CPU mode; their plain versions are held to the reference by
the other `test_torch_*.py` files). This file imports no JAX, so on a
machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from activegs_torch.core import geometry as geo
from activegs_torch.core import quaternions as quat
from activegs_torch.render import binning, renderer
from activegs_torch.render import composite as cp
from activegs_torch.render import preprocess as pp
from activegs_torch.render import types as tt

SHAPE = (64, 64)
CFGS = {
    "k128": tt.RasterConfig(sigma_extent=3.5, max_dup=16, entry_budget_mult=20.0),
    "k8": tt.RasterConfig(sigma_extent=3.5, max_dup=16, entry_budget_mult=20.0, chunk=8),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def scene(dev, n=256, seed=2):
    """Seeded camera-facing surfels in front of the identity camera, with an
    opaque front layer so that some tiles stop early."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n), rng.uniform(1, 3, n)], 1)
    normals = rng.normal(size=(n, 3))
    normals[np.sum(normals * means, 1) > 0] *= -1
    scales = np.stack([rng.uniform(0.05, 0.15, n), rng.uniform(0.05, 0.15, n), np.full(n, 1e-6)], 1)
    opac = np.where(np.arange(n) < n // 2, 0.95, rng.uniform(0.3, 0.9, n))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    q, _ = quat.normal_to_quaternion(t(normals))
    return tt.GaussianAttrs(
        means=t(means), scales=t(scales), rotations=q, opacities=t(opac),
        colors=t(rng.uniform(0, 1, (n, 3))), confidences=t(rng.uniform(0, 1, n)),
        valid=torch.ones(n, dtype=torch.bool, device=dev),
    )


def small_surfel_scene(dev, n=900, seed=5):
    """Seeded scene that corners the backward kernel's warp cull: an opaque
    wall of opacity-1 surfels over the left tiles (alpha reaches alpha_max
    near their centers, and those tiles stop early), behind it small
    surfels that cover 3-4 pixel rows each (most (entry, 32-pixel row)
    pairs have no alpha > 0), some of opacity just above and just below
    the 1/255 alpha cut."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(-0.95, 0.1, 10), np.linspace(-0.95, 0.95, 17))
    nw = gx.size
    wall = np.stack([gx.ravel(), gy.ravel(), np.ones(nw)], 1)
    small = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n), rng.uniform(1.2, 3.0, n)], 1)
    means = np.concatenate([wall, small])
    normals = np.tile([0.0, 0.0, -1.0], (nw + n, 1))
    normals[nw:] += rng.normal(scale=0.2, size=(n, 3))
    scales = np.concatenate([np.full((nw, 2), 0.12), rng.uniform(0.004, 0.02, (n, 2))])
    scales = np.concatenate([scales, np.full((nw + n, 1), 1e-6)], 1)
    cut = tt.RasterConfig().alpha_cut
    opac = np.concatenate([np.ones(nw), rng.choice([1.0, 0.7, 0.3, 0.05, 1.05 * cut, 0.999 * cut], n)])
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    q, _ = quat.normal_to_quaternion(t(normals))
    return tt.GaussianAttrs(
        means=t(means), scales=t(scales), rotations=q, opacities=t(opac),
        colors=t(rng.uniform(0, 1, (nw + n, 3))), confidences=t(rng.uniform(0, 1, nw + n)),
        valid=torch.ones(nw + n, dtype=torch.bool, device=dev),
    )


def wall_edge_scene(dev, n=5000, seed=7):
    """Seeded scene that corners the forward kernel's cluster stop: an
    opaque wall of opacity-1 surfels at depth 1 over the upper part of the
    view, whose lower edge crosses a row of tiles mid-tile at 64x64 and at
    128x128 (the tile's upper pixel rows go opaque, its lower rows do not),
    and behind it and below it many small surfels at depths 1.2-3. Tiles
    under the wall stop after their first K = 128 chunk, the others run
    late."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(-0.9, 0.91, 0.06), np.arange(-0.9, 0.11, 0.06))
    nw = gx.size
    wall = np.stack([gx.ravel(), gy.ravel(), np.ones(nw)], 1)
    small = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-1.0, 1.0, n), rng.uniform(1.2, 3.0, n)], 1)
    means = np.concatenate([wall, small])
    normals = np.tile([0.0, 0.0, -1.0], (nw + n, 1))
    normals[nw:] += rng.normal(scale=0.2, size=(n, 3))
    scales = np.concatenate([np.full((nw, 2), 0.06), rng.uniform(0.01, 0.03, (n, 2))])
    scales = np.concatenate([scales, np.full((nw + n, 1), 1e-6)], 1)
    opac = np.concatenate([np.ones(nw), rng.uniform(0.3, 0.9, n)])
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    q, _ = quat.normal_to_quaternion(t(normals))
    return tt.GaussianAttrs(
        means=t(means), scales=t(scales), rotations=q, opacities=t(opac),
        colors=t(rng.uniform(0, 1, (nw + n, 3))), confidences=t(rng.uniform(0, 1, nw + n)),
        valid=torch.ones(nw + n, dtype=torch.bool, device=dev),
    )


def scene_entries(attrs, cfg, dev, shape=SHAPE):
    """(entries, tile_start, tile_len), ntx of `attrs` seen by the identity camera."""
    cam = tt.Camera(torch.eye(4, device=dev), geo.intrinsics_from_fov(60.0, 60.0, device=dev))
    p2d, _, dz, iv = pp.preprocess(attrs, cam, shape, cfg)
    b = binning.bin_entries(p2d, dz, iv, shape, cfg)
    _, _, ntx, _ = binning.bin_tile_dims(shape, cfg)
    return (renderer.gather_entries(p2d, b.gid), b.tile_start, b.tile_len), ntx


def assert_bwd_rows_close(d_k, d_p):
    """Each gradient row within 3e-4 of its largest plain value."""
    for r in range(tt.USED_ROWS):
        assert float((d_k[r] - d_p[r]).abs().max()) <= 3e-4 * float(d_p[r].abs().max()) + 1e-12, r
    assert not d_k[tt.USED_ROWS :].any()


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_id", list(CFGS))
def test_kernels_match_plain(cuda, cfg_id):
    cfg = CFGS[cfg_id]
    args, ntx = scene_entries(scene(cuda), cfg, cuda)
    o_k = cp.composite_fwd(*args, ntx, cfg)
    o_p = cp.composite_fwd_plain(*args, ntx, cfg)
    torch.cuda.synchronize()
    rows = [r for r in range(tt.O_TRANS + 1) if r != tt.O_DEPTH]
    torch.testing.assert_close(o_k[:, rows], o_p[:, rows], rtol=0, atol=2e-5)
    torch.testing.assert_close(o_k[:, tt.O_DEPTH], o_p[:, tt.O_DEPTH], rtol=0, atol=1e-4)
    assert torch.equal(o_k[:, tt.O_STOP:], o_p[:, tt.O_STOP:])
    g = torch.randn_like(o_k)
    d_k = cp.composite_bwd(*args, o_k, g, ntx, cfg)
    d_p = cp.composite_bwd_plain(*args, o_k, g, ntx, cfg)
    assert_bwd_rows_close(d_k, d_p)
    m = (torch.rand(len(args[1]), cfg.tile_pixels, device=cuda) > 0.3).float()
    i_k, c_k = cp.composite_stats(*args, m, 0.03, ntx, cfg)
    i_p, c_p = cp.composite_stats_plain(*args, m, 0.03, ntx, cfg)
    assert float((i_k - i_p).abs().max()) <= 1e-5 * float(i_p.abs().max())
    assert int((c_k != c_p).sum()) <= 2  # only where some w * mask meets 0.03 within rounding
    assert all(k.launches > 0 for k in cp.KERNELS)


# the forward kernel at K = 128 and 8, at K = 20 (not a multiple of the
# 8 entries whose alphas it evaluates together: a chunk ends with 4 taken
# one by one), and at tiles for which the wrapper picks each cluster size
# it can: 4 (16x32), 2 (6x32), 1 (3x32)
FWD_CFGS = {
    **CFGS,
    "k20": dataclasses.replace(CFGS["k128"], chunk=20),
    "c2": dataclasses.replace(CFGS["k128"], tile_h=6),
    "c1": dataclasses.replace(CFGS["k128"], tile_h=3),
    # a 1024-pixel tile (4 blocks of 256 threads) and two 16 pixels wide
    "t32x32": dataclasses.replace(CFGS["k128"], tile_h=32, tile_w=32),
    "t16x16": dataclasses.replace(CFGS["k128"], tile_h=16, tile_w=16),
    "t8x16": dataclasses.replace(CFGS["k128"], tile_h=8, tile_w=16),
}
FWD_CLUSTER = {"k128": 4, "k8": 4, "k20": 4, "c2": 2, "c1": 1, "t32x32": 4, "t16x16": 4, "t8x16": 4}
FWD_SCENES = {"small_surfels_64": (small_surfel_scene, SHAPE), "wall_edge_128": (wall_edge_scene, (128, 128))}


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_id", list(FWD_CFGS))
@pytest.mark.parametrize("scene_id", list(FWD_SCENES))
def test_fwd_kernel_matches_plain(cuda, scene_id, cfg_id):
    """The forward kernel, a cluster of blocks per tile, against its plain
    version: on the small-surfel scene (most (entry, 32-pixel row) pairs
    culled) and on a 128x128 view of 32 tiles where an opaque wall stops
    some tiles after one chunk and crosses others mid-tile. Images within
    2e-5, depth 1e-4, the chunks done equal, and five launches bitwise
    equal."""
    cfg = FWD_CFGS[cfg_id]
    make, shape = FWD_SCENES[scene_id]
    args, ntx = scene_entries(make(cuda), cfg, cuda, shape)
    assert cp.fwd_cluster_size(cfg) == FWD_CLUSTER[cfg_id]
    n0 = cp.fwd_kernel.launches
    runs = [cp.composite_fwd(*args, ntx, cfg) for _ in range(5)]
    torch.cuda.synchronize()
    assert cp.fwd_kernel.launches == n0 + 5
    o_k, o_p = runs[0], cp.composite_fwd_plain(*args, ntx, cfg)
    rows = [r for r in range(tt.O_TRANS + 1) if r != tt.O_DEPTH]
    torch.testing.assert_close(o_k[:, rows], o_p[:, rows], rtol=0, atol=2e-5)
    torch.testing.assert_close(o_k[:, tt.O_DEPTH], o_p[:, tt.O_DEPTH], rtol=0, atol=1e-4)
    assert torch.equal(o_k[:, tt.O_STOP :], o_p[:, tt.O_STOP :])
    assert all(torch.equal(runs[0].view(torch.int32), r.view(torch.int32)) for r in runs[1:])
    stop = o_k[:, tt.O_STOP, 0]
    live, all_rows = cp.live_warp_rows(*args, stop, ntx, cfg)
    assert 0 < live < all_rows
    if scene_id == "wall_edge_128" and cfg_id == "k128":
        assert len(args[1]) >= 32
        assert bool((stop == 1).any()) and int(stop.max()) >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_id", list(CFGS))
def test_bwd_kernel_cull_matches_plain(cuda, cfg_id):
    """The backward kernel on a scene where most (entry, 32-pixel row)
    pairs are culled and the rest survive: tiles that stop early, alpha at
    exactly alpha_max and at the 1/255 cut, pad entries. Each gradient row
    within 3e-4 of its largest plain value, and five launches bitwise
    equal."""
    cfg = CFGS[cfg_id]
    args, ntx = scene_entries(small_surfel_scene(cuda), cfg, cuda)
    out = cp.composite_fwd(*args, ntx, cfg)
    stop = out[:, tt.O_STOP, 0]
    live, rows = cp.live_warp_rows(*args, stop, ntx, cfg)
    assert 0 < live < rows // 2
    assert bool((stop < (args[2] + cfg.chunk - 1) // cfg.chunk).any())
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    g[:, tt.O_TRANS + 1 :] = 0.0
    n0 = cp.bwd_kernel.launches
    runs = [cp.composite_bwd(*args, out, g, ntx, cfg) for _ in range(5)]
    torch.cuda.synchronize()
    assert cp.bwd_kernel.launches == n0 + 5
    assert_bwd_rows_close(runs[0], cp.composite_bwd_plain(*args, out, g, ntx, cfg))
    assert all(torch.equal(runs[0], r) for r in runs[1:])


@pytest.mark.cuda
def test_bwd_tile_order_puts_the_most_reached_entries_first(cuda):
    """The backward launch's ordering kernel, on more tiles than one of its
    blocks holds: `order` lists every tile once, by the real entries its
    replay reaches, min(tile_len, stop * K), most first, ties by index."""
    check_tile_order(cuda, 700, 28, 700)


@pytest.mark.cuda
def test_bwd_tile_order_over_a_batched_grid(cuda):
    """The same over 4096 tiles, 8 views of a 512x512 grid (tpv = 512): the
    tiles of a fused 8-view training step at full size."""
    check_tile_order(cuda, 8 * 512, 16, 512)


def check_tile_order(cuda, t_n, ntx, tpv):
    cfg = CFGS["k128"]
    k = cfg.chunk
    gen = torch.Generator().manual_seed(3)
    tile_len = torch.randint(0, 5 * k, (t_n,), generator=gen, dtype=torch.int32)
    tile_len[::7] = 2 * k  # ties
    nch = (tile_len.long() + k - 1) // k
    stop = torch.minimum(torch.randint(0, 6, (t_n,), generator=gen), nch)
    tile_start = torch.cumsum(nch * k, 0) - nch * k
    e = int((nch * k).sum())
    entries = torch.zeros((tt.PARAM_DIM, e), device=cuda)  # opacity 0: no alpha > 0
    out = torch.zeros((t_n, tt.OUT_ROWS, cfg.tile_pixels), device=cuda)
    out[:, tt.O_STOP] = stop.float()[:, None].to(cuda)
    gout = torch.zeros_like(out)
    dentries = torch.zeros_like(entries)
    order = torch.full((t_n,), -1, dtype=torch.int32, device=cuda)
    ts, tl = tile_start.to(cuda, torch.int32), tile_len.to(cuda)
    cp.bwd_kernel.launch(
        entries.data_ptr(), e, ts.data_ptr(), tl.data_ptr(), out.data_ptr(), gout.data_ptr(),
        dentries.data_ptr(), order.data_ptr(), t_n, tpv, *cp._tail(ntx, cfg, cuda),
    )
    torch.cuda.synchronize()
    expect = torch.sort(-torch.minimum(tile_len.long(), stop * k), stable=True).indices
    assert torch.equal(order.cpu().long(), expect)
    assert not dentries.any()


@pytest.mark.cuda
@pytest.mark.parametrize("t_n, ntx", [(512, 16), (700, 28), (4096, 16), (1, 1)])
def test_stats_tile_order_puts_the_longest_tiles_first(cuda, t_n, ntx):
    """The stats launch's ranking kernel, over fewer and more tiles than one
    of its blocks has threads: `order` lists every tile once, by entry
    count, most first, ties by index; the replay then writes nothing for
    entries of opacity 0 at a positive threshold."""
    cfg = CFGS["k128"]
    k = cfg.chunk
    gen = torch.Generator().manual_seed(t_n)
    tile_len = torch.randint(0, 5 * k, (t_n,), generator=gen, dtype=torch.int32)
    tile_len[::7] = 2 * k  # ties
    nch = (tile_len.long() + k - 1) // k
    tile_start = torch.cumsum(nch * k, 0) - nch * k
    e = max(int((nch * k).sum()), k)
    entries = torch.zeros((tt.PARAM_DIM, e), device=cuda)  # opacity 0: w = 0 everywhere
    mask = torch.ones((t_n, cfg.tile_pixels), device=cuda)
    imp = torch.zeros((1, e), device=cuda)
    cnt = torch.zeros_like(imp)
    order = torch.full((t_n,), -1, dtype=torch.int32, device=cuda)
    ts, tl = tile_start.to(cuda, torch.int32), tile_len.to(cuda)
    cp.stats_kernel.launch(entries.data_ptr(), e, ts.data_ptr(), tl.data_ptr(), mask.data_ptr(), 0.03,
                           imp.data_ptr(), cnt.data_ptr(), order.data_ptr(), t_n, *cp._tail(ntx, cfg, cuda))
    torch.cuda.synchronize()
    assert torch.equal(order.cpu().long(), torch.sort(-tile_len.long(), stable=True).indices)
    assert not imp.any() and not cnt.any()


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    cfg = CFGS["k128"]
    ent = torch.zeros((tt.PARAM_DIM, 256), device=cuda)
    ts = torch.zeros(2, dtype=torch.int32, device=cuda)
    for bad in (ent.double(), ent[:, :200], ent.t().contiguous().t(), ent[:, :255]):
        with pytest.raises(ValueError):
            cp.composite_fwd(bad, ts, ts, 1, cfg)
    with pytest.raises(ValueError):
        cp.composite_fwd(ent, ts.long(), ts, 1, cfg)
    with pytest.raises(ValueError):
        cp.composite_stats(ent, ts, ts, torch.zeros((2, 100), device=cuda), 0.03, 1, cfg)
    # the forward launch refuses a cluster size that does not split the
    # tile into blocks of whole warps
    out = torch.empty((2, tt.OUT_ROWS, cfg.tile_pixels), device=cuda)
    for bad in (3, 5, 0):
        with pytest.raises(RuntimeError, match="invalid argument"):
            cp.fwd_kernel.launch(ent.data_ptr(), 256, ts.data_ptr(), ts.data_ptr(), out.data_ptr(), 2, 2, bad,
                                 *cp._tail(1, cfg, cuda))


@pytest.mark.cuda
def test_kernels_refuse_a_tpv_that_does_not_divide_the_grid(cuda):
    """Tiles per view must divide the grid's tiles: the wrappers raise
    ValueError, the launch functions return cudaErrorInvalidValue."""
    cfg = CFGS["k128"]
    ent = torch.zeros((tt.PARAM_DIM, 768), device=cuda)
    ts = torch.zeros(6, dtype=torch.int32, device=cuda)
    out = torch.zeros((6, tt.OUT_ROWS, cfg.tile_pixels), device=cuda)
    for bad in (4, 0, 12):
        with pytest.raises(ValueError, match="does not divide"):
            cp.composite_fwd(ent, ts, ts, 1, cfg, bad)
        with pytest.raises(ValueError, match="does not divide"):
            cp.composite_bwd(ent, ts, ts, out, out, 1, cfg, bad)
        with pytest.raises(RuntimeError, match="invalid argument"):
            cp.fwd_kernel.launch(ent.data_ptr(), 768, ts.data_ptr(), ts.data_ptr(), out.data_ptr(), 6, bad, 4,
                                 *cp._tail(1, cfg, cuda))
        order = torch.empty(6, dtype=torch.int32, device=cuda)
        with pytest.raises(RuntimeError, match="invalid argument"):
            cp.bwd_kernel.launch(ent.data_ptr(), 768, ts.data_ptr(), ts.data_ptr(), out.data_ptr(), out.data_ptr(),
                                 ent.data_ptr(), order.data_ptr(), 6, bad, *cp._tail(1, cfg, cuda))
    for tpv in (1, 2, 3, 6):  # each divides the grid
        cp.composite_fwd(ent, ts, ts, 1, cfg, tpv)
    torch.cuda.synchronize()


# bf16 pair math (`RasterConfig.bf16_pairs`): the kernels' bf16 instances.
# The kernels and the plain versions follow one rounding contract
# (`render/composite.py`), so the forward output meets the float32
# tolerances (2e-5, depth 1e-4, the stop rows equal): nothing it rounds to
# bf16 follows a float32 sum that the two group apart. In the backward, q,
# the per-chunk sum of w q and the suffix are float32 sums that the plain
# version groups otherwise (bmm, sum); where one lies within that
# difference of a bf16 rounding boundary, its bf16 value is one ulp (2^-8
# relative) apart and moves that pair's terms by as much, so each gradient
# row is held within 2e-3 of its largest plain value: half a bf16 ulp of
# the row's largest value.
BF16_CFGS = {f"{k}-bf16": dataclasses.replace(c, bf16_pairs=True) for k, c in CFGS.items()}


def assert_bwd_rows_close_bf16(d_k, d_p):
    for r in range(tt.USED_ROWS):
        assert float((d_k[r] - d_p[r]).abs().max()) <= 2e-3 * float(d_p[r].abs().max()) + 1e-12, r
    assert not d_k[tt.USED_ROWS :].any()


def view_grid(cuda, cfg):
    """Three 64x64 views of unequal tiles (the scene of the kernel tests,
    the small-surfel scene, the wall-edge scene) as one grid: their entry
    streams and tile tables concatenated. Returns ((entries, tile_start,
    tile_len) of the grid, ntx, tiles per view, [each view's arguments],
    [each stream's offset])."""
    views = []
    for make in (scene, small_surfel_scene, wall_edge_scene):
        args, ntx = scene_entries(make(cuda), cfg, cuda)
        views.append(args)
    offs = [0]
    for ent, _, _ in views:
        offs.append(offs[-1] + ent.shape[1])
    grid = (
        torch.cat([v[0] for v in views], dim=1).contiguous(),
        torch.cat([v[1] + o for v, o in zip(views, offs)]),
        torch.cat([v[2] for v in views]),
    )
    return grid, ntx, len(views[0][1]), views, offs


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_id", [*CFGS, *BF16_CFGS])
def test_tpv_kernels_match_plain_and_each_view_alone(cuda, cfg_id):
    """One forward and one backward launch over a grid of three views
    (`tpv`), at K = 128 (the backward kernel's compiled K) and K = 8 (its
    run-time K), f32 and bf16 (`-bf16`): against their plain versions with
    tpv at the kernels' tolerances, and each view's slice of the outputs
    and of the entry gradients bitwise equal to that view's own
    single-view launch."""
    cfg = {**CFGS, **BF16_CFGS}[cfg_id]
    fwd, bwd = (cp.fwd_bf16_kernel, cp.bwd_bf16_kernel) if cfg.bf16_pairs else (cp.fwd_kernel, cp.bwd_kernel)
    grid, ntx, tpv, views, offs = view_grid(cuda, cfg)
    n0 = (fwd.launches, bwd.launches)
    o_k = cp.composite_fwd(*grid, ntx, cfg, tpv)
    g = torch.randn(o_k.shape, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    g[:, tt.O_TRANS + 1 :] = 0.0
    d_k = cp.composite_bwd(*grid, o_k, g, ntx, cfg, tpv)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (n0[0] + 1, n0[1] + 1)
    o_p = cp.composite_fwd_plain(*grid, ntx, cfg, tpv)
    rows = [r for r in range(tt.O_TRANS + 1) if r != tt.O_DEPTH]
    torch.testing.assert_close(o_k[:, rows], o_p[:, rows], rtol=0, atol=2e-5)
    torch.testing.assert_close(o_k[:, tt.O_DEPTH], o_p[:, tt.O_DEPTH], rtol=0, atol=1e-4)
    assert torch.equal(o_k[:, tt.O_STOP :], o_p[:, tt.O_STOP :])
    d_p = cp.composite_bwd_plain(*grid, o_k, g, ntx, cfg, tpv)
    (assert_bwd_rows_close_bf16 if cfg.bf16_pairs else assert_bwd_rows_close)(d_k, d_p)
    for i, args in enumerate(views):
        t = slice(i * tpv, (i + 1) * tpv)
        alone = cp.composite_fwd(*args, ntx, cfg)
        assert torch.equal(o_k[t].view(torch.int32), alone.view(torch.int32)), i
        d_alone = cp.composite_bwd(*args, alone, g[t].contiguous(), ntx, cfg)
        assert torch.equal(d_k[:, offs[i] : offs[i + 1]].view(torch.int32), d_alone.view(torch.int32)), i


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_id", list(BF16_CFGS))
@pytest.mark.parametrize("scene_id", list(FWD_SCENES))
def test_bf16_kernels_match_plain(cuda, scene_id, cfg_id):
    """The three bf16 instances against their plain versions on the
    small-surfel scene (64x64, most rows culled, alpha at the bf16 clamp
    and at the cut) and the wall-edge scene (128x128, tiles stopping after
    one chunk): tolerances above, importance 1e-5 relative, counts at most
    2 apart; five launches of each bitwise equal; the f32 kernels not
    launched."""
    cfg = BF16_CFGS[cfg_id]
    make, shape = FWD_SCENES[scene_id]
    args, ntx = scene_entries(make(cuda), cfg, cuda, shape)
    n0 = [k.launches for k in (*cp.KERNELS, *cp.BF16_KERNELS)]
    outs = [cp.composite_fwd(*args, ntx, cfg) for _ in range(5)]
    o_k = outs[0]
    g = torch.randn(o_k.shape, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    g[:, tt.O_TRANS + 1 :] = 0.0
    grads = [cp.composite_bwd(*args, o_k, g, ntx, cfg) for _ in range(5)]
    m = (torch.rand(len(args[1]), cfg.tile_pixels, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda) > 0.3).float()
    stats = [cp.composite_stats(*args, m, 0.03, ntx, cfg) for _ in range(5)]
    torch.cuda.synchronize()
    assert [k.launches for k in (*cp.KERNELS, *cp.BF16_KERNELS)] == n0[:3] + [n + 5 for n in n0[3:]]
    o_p = cp.composite_fwd_plain(*args, ntx, cfg)
    rows = [r for r in range(tt.O_TRANS + 1) if r != tt.O_DEPTH]
    torch.testing.assert_close(o_k[:, rows], o_p[:, rows], rtol=0, atol=2e-5)
    torch.testing.assert_close(o_k[:, tt.O_DEPTH], o_p[:, tt.O_DEPTH], rtol=0, atol=1e-4)
    assert torch.equal(o_k[:, tt.O_STOP :], o_p[:, tt.O_STOP :])
    assert_bwd_rows_close_bf16(grads[0], cp.composite_bwd_plain(*args, o_k, g, ntx, cfg))
    i_p, c_p = cp.composite_stats_plain(*args, m, 0.03, ntx, cfg)
    assert float((stats[0][0] - i_p).abs().max()) <= 1e-5 * float(i_p.abs().max())
    assert int((stats[0][1] != c_p).sum()) <= 2
    assert all(torch.equal(outs[0].view(torch.int32), o.view(torch.int32)) for o in outs[1:])
    assert all(torch.equal(grads[0].view(torch.int32), d.view(torch.int32)) for d in grads[1:])
    assert all(torch.equal(stats[0][0], i) and torch.equal(stats[0][1], c) for i, c in stats[1:])
    # bf16 rounds where float32 does not: the outputs differ from the f32 kernel's
    f32 = cp.composite_fwd(*args, ntx, dataclasses.replace(cfg, bf16_pairs=False))
    assert not torch.equal(o_k[:, rows], f32[:, rows])
    stop = o_k[:, tt.O_STOP, 0]
    assert 0 < cp.live_warp_rows(*args, stop, ntx, cfg)[0]



@pytest.mark.cuda
@pytest.mark.parametrize("cfg_id", list(CFGS) + list(BF16_CFGS))
@pytest.mark.parametrize("scene_id", list(FWD_SCENES))
def test_stats_kernel_cull_matches_plain(cuda, scene_id, cfg_id):
    """The stats kernel, f32 and bf16 instances at K = 128 and 8, against
    its plain version: on the small-surfel scene (most (entry, 32-pixel
    row) pairs culled) and the wall-edge scene (tiles that stop after one
    chunk), with a mask that masks whole warps, some with -0.0, at
    thresholds 0.03, 0 and -1 (every pixel counts, pad entries included).
    Importance within 1e-5 of its largest, counts at most 2 apart (equal
    at thresholds <= 0), and five launches bitwise equal."""
    cfg = {**CFGS, **BF16_CFGS}[cfg_id]
    make, shape = FWD_SCENES[scene_id]
    args, ntx = scene_entries(make(cuda), cfg, cuda, shape)
    t_n, p = len(args[1]), cfg.tile_pixels
    gen = torch.Generator(device=cuda).manual_seed(2)
    m = (torch.rand(t_n, p, generator=gen, device=cuda) > 0.3).float().reshape(t_n, p // 32, 32)
    dead = torch.rand(t_n, p // 32, 1, generator=gen, device=cuda)
    m = torch.where(dead < 0.2, 0.0, torch.where(dead < 0.3, -0.0, m)).reshape(t_n, p)
    rows = cp.stats_live_rows(*args, m, ntx, cfg)
    assert 0 < rows["live_pairs"] < rows["pairs"] // 2 and 0 < rows["live_rounds"] < rows["rounds"]
    if cfg.chunk == 128:
        assert bool((cp.composite_fwd_plain(*args, ntx, cfg)[:, tt.O_STOP, 0] == 1).any())
    kern = cp.stats_bf16_kernel if cfg.bf16_pairs else cp.stats_kernel
    for thres in (0.03, 0.0, -1.0):
        n0 = kern.launches
        runs = [cp.composite_stats(*args, m, thres, ntx, cfg) for _ in range(5)]
        torch.cuda.synchronize()
        assert kern.launches == n0 + 5
        (i_k, c_k), (i_p, c_p) = runs[0], cp.composite_stats_plain(*args, m, thres, ntx, cfg)
        assert float((i_k - i_p).abs().max()) <= 1e-5 * float(i_p.abs().max()), thres
        assert int((c_k != c_p).sum()) <= (2 if thres > 0.0 else 0), thres
        assert all(torch.equal(i_k.view(torch.int32), i.view(torch.int32)) and torch.equal(c_k, c)
                   for i, c in runs[1:]), thres

# tiles other than the default 16x32: 32x32 (1024 pixels: the backward
# and stats kernels' 1024-thread blocks, the forward's 4 blocks of 256
# threads), 16x16 and 8x16 (16 pixels wide: a warp spans two pixel rows;
# at K = 8, so that their tiles run several chunks and stop early)
TILE_CFGS = {
    "t32x32": dataclasses.replace(CFGS["k128"], tile_h=32, tile_w=32),
    "t16x16": dataclasses.replace(CFGS["k8"], tile_h=16, tile_w=16),
    "t8x16": dataclasses.replace(CFGS["k8"], tile_h=8, tile_w=16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("tile_id", list(TILE_CFGS))
@pytest.mark.parametrize("scene_id", list(FWD_SCENES))
def test_kernels_at_other_tiles_match_plain(cuda, scene_id, tile_id, bf16):
    """The three kernels (f32, and the bf16 instances) at 32x32, 16x16 and
    8x16 tiles against their plain versions, at the tolerances above:
    images 2e-5, depth 1e-4, the chunks done equal, gradient rows 3e-4
    (bf16 2e-3) of their largest, importance 1e-5 of its largest, counts
    at most 2 apart; three launches of each bitwise equal; the forward
    kernel split over a cluster of 4 blocks."""
    cfg = dataclasses.replace(TILE_CFGS[tile_id], bf16_pairs=bf16)
    make, shape = FWD_SCENES[scene_id]
    args, ntx = scene_entries(make(cuda), cfg, cuda, shape)
    assert cp.fwd_cluster_size(cfg) == 4
    kernels = cp.BF16_KERNELS if bf16 else cp.KERNELS
    n0 = [k.launches for k in kernels]
    outs = [cp.composite_fwd(*args, ntx, cfg) for _ in range(3)]
    o_k = outs[0]
    g = torch.randn(o_k.shape, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    g[:, tt.O_TRANS + 1 :] = 0.0
    grads = [cp.composite_bwd(*args, o_k, g, ntx, cfg) for _ in range(3)]
    m = (torch.rand(len(args[1]), cfg.tile_pixels, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda) > 0.3).float()
    stats = [cp.composite_stats(*args, m, 0.03, ntx, cfg) for _ in range(3)]
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [n + 3 for n in n0]
    o_p = cp.composite_fwd_plain(*args, ntx, cfg)
    rows = [r for r in range(tt.O_TRANS + 1) if r != tt.O_DEPTH]
    torch.testing.assert_close(o_k[:, rows], o_p[:, rows], rtol=0, atol=2e-5)
    torch.testing.assert_close(o_k[:, tt.O_DEPTH], o_p[:, tt.O_DEPTH], rtol=0, atol=1e-4)
    assert torch.equal(o_k[:, tt.O_STOP :], o_p[:, tt.O_STOP :])
    (assert_bwd_rows_close_bf16 if bf16 else assert_bwd_rows_close)(
        grads[0], cp.composite_bwd_plain(*args, o_k, g, ntx, cfg)
    )
    i_p, c_p = cp.composite_stats_plain(*args, m, 0.03, ntx, cfg)
    assert float((stats[0][0] - i_p).abs().max()) <= 1e-5 * float(i_p.abs().max())
    assert int((stats[0][1] != c_p).sum()) <= 2
    assert all(torch.equal(outs[0].view(torch.int32), o.view(torch.int32)) for o in outs[1:])
    assert all(torch.equal(grads[0].view(torch.int32), d.view(torch.int32)) for d in grads[1:])
    assert all(torch.equal(stats[0][0], i) and torch.equal(stats[0][1], c) for i, c in stats[1:])
    live, all_rows = cp.live_warp_rows(*args, o_k[:, tt.O_STOP, 0], ntx, cfg)
    assert 0 < live < all_rows


@pytest.mark.cuda
def test_kernels_refuse_tiles_they_cannot_take(cuda):
    """The wrappers raise ValueError for a tile of more than 1024 pixels, of
    pixels that are not whole warps, or that the forward kernel cannot
    split; below them, the launches refuse such a tile (cudaErrorInvalidValue)
    rather than run it some other way."""
    ent = torch.zeros((tt.PARAM_DIM, 256), device=cuda)
    ts = torch.zeros(2, dtype=torch.int32, device=cuda)
    for th, tw in ((32, 64), (17, 32), (1, 16)):
        cfg = tt.RasterConfig(tile_h=th, tile_w=tw)
        out = torch.zeros((2, tt.OUT_ROWS, cfg.tile_pixels), device=cuda)
        with pytest.raises(ValueError, match="tile of"):
            cp.composite_fwd(ent, ts, ts, 1, cfg)
        with pytest.raises(ValueError, match="tile of"):
            cp.composite_bwd(ent, ts, ts, out, out, 1, cfg)
        with pytest.raises(ValueError, match="tile of"):
            cp.composite_stats(ent, ts, ts, torch.zeros((2, cfg.tile_pixels), device=cuda), 0.03, 1, cfg)
    wide = tt.RasterConfig(tile_h=32, tile_w=64)  # 2048 pixels
    out = torch.zeros((2, tt.OUT_ROWS, wide.tile_pixels), device=cuda)
    order = torch.empty(2, dtype=torch.int32, device=cuda)
    imp = torch.zeros((1, 256), device=cuda)
    for kern in (cp.bwd_kernel, cp.bwd_bf16_kernel):
        with pytest.raises(RuntimeError, match="invalid argument"):
            kern.launch(ent.data_ptr(), 256, ts.data_ptr(), ts.data_ptr(), out.data_ptr(), out.data_ptr(),
                        ent.data_ptr(), order.data_ptr(), 2, 2, *cp._tail(1, wide, cuda))
    for kern in (cp.stats_kernel, cp.stats_bf16_kernel):
        with pytest.raises(RuntimeError, match="invalid argument"):
            kern.launch(ent.data_ptr(), 256, ts.data_ptr(), ts.data_ptr(), out.data_ptr(), 0.03, imp.data_ptr(),
                        imp.data_ptr(), order.data_ptr(), 2, *cp._tail(1, wide, cuda))
    # a 32x32 tile in one block would be 1024 threads: the forward kernel
    # refuses that cluster size, and those that do not split the tile,
    # instead of launching past its bounds
    cfg = TILE_CFGS["t32x32"]
    out = torch.zeros((2, tt.OUT_ROWS, cfg.tile_pixels), device=cuda)
    for bad in (1, 3, 5):
        with pytest.raises(RuntimeError, match="invalid argument"):
            cp.fwd_kernel.launch(ent.data_ptr(), 256, ts.data_ptr(), ts.data_ptr(), out.data_ptr(), 2, 2, bad,
                                 *cp._tail(1, cfg, cuda))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_bf16_kernels_refuse_what_the_f32_kernels_refuse(cuda):
    cfg = BF16_CFGS["k128-bf16"]
    ent = torch.zeros((tt.PARAM_DIM, 768), device=cuda)
    ts = torch.zeros(6, dtype=torch.int32, device=cuda)
    for bad in (ent.double(), ent[:, :200], ent.t().contiguous().t(), ent[:, :255]):
        with pytest.raises(ValueError):
            cp.composite_fwd(bad, ts, ts, 1, cfg)
    with pytest.raises(ValueError):
        cp.composite_stats(ent, ts, ts, torch.zeros((6, 100), device=cuda), 0.03, 1, cfg)
    out = torch.zeros((6, tt.OUT_ROWS, cfg.tile_pixels), device=cuda)
    order = torch.empty(6, dtype=torch.int32, device=cuda)
    for bad in (3, 5, 0):  # cluster sizes that do not split the tile
        with pytest.raises(RuntimeError, match="composite_fwd_bf16: CUDA error .*invalid argument"):
            cp.fwd_bf16_kernel.launch(ent.data_ptr(), 768, ts.data_ptr(), ts.data_ptr(), out.data_ptr(), 6, 6, bad,
                                      *cp._tail(1, cfg, cuda))
    for bad in (4, 0, 12):  # tiles per view that do not divide the grid
        with pytest.raises(ValueError, match="does not divide"):
            cp.composite_bwd(ent, ts, ts, out, out, 1, cfg, bad)
        with pytest.raises(RuntimeError, match="invalid argument"):
            cp.fwd_bf16_kernel.launch(ent.data_ptr(), 768, ts.data_ptr(), ts.data_ptr(), out.data_ptr(), 6, bad, 4,
                                      *cp._tail(1, cfg, cuda))
        with pytest.raises(RuntimeError, match="composite_bwd_bf16: CUDA error .*invalid argument"):
            cp.bwd_bf16_kernel.launch(ent.data_ptr(), 768, ts.data_ptr(), ts.data_ptr(), out.data_ptr(),
                                      out.data_ptr(), ent.data_ptr(), order.data_ptr(), 6, bad,
                                      *cp._tail(1, cfg, cuda))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_mapping_step_runs_the_kernels(cuda):
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import keyframes as kf
    from activegs_torch.mapping.mapper import mapping_step
    from activegs_torch.sim.synthetic import BoxRoomSimulator

    cfg, rcfg = gm.MapConfig(capacity=8192, bilateral_radius=2), tt.RasterConfig(entry_budget_mult=4.0)
    sim = BoxRoomSimulator(resolution=SHAPE, seed=11, device=cuda)
    state, buf = gm.init_state(cfg, device=cuda), kf.init_buffer(8, *SHAPE, device=cuda)
    for k in cp.KERNELS:
        k.launches = 0
    gen = torch.Generator().manual_seed(0)
    for target in ((5.5, 2.5, 1.2), (5.0, 4.0, 1.0)):
        frame = sim.simulate(geo.look_at((3.0, 2.5, 1.5), target, device=cuda))
        state, buf, st = mapping_step(state, buf, frame, cfg, rcfg, gen)
        assert math.isfinite(st["loss"]) and st["n_gaussians"] > 0
    assert all(k.launches > 0 for k in cp.KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["fma", "fma_fused", "mul", "add", "cmpsel", "exp", "div"])
def test_vpu_probe_kernel_matches_plain(cuda, op):
    from activegs_torch.scripts import microbench_vpu as vpu

    x = torch.linspace(0.25, 2.0, 2 * 128 * 128, device=cuda).reshape(2, 128, 128)
    n0 = vpu.kernel.launches
    k, p = vpu.chain(x, op), vpu.chain_plain(x, op)
    torch.cuda.synchronize()
    assert vpu.kernel.launches == n0 + 1
    assert torch.equal(k, p)  # -fmad=false: each op rounds as its plain version does
    assert float((p != x).float().mean()) > 0.75
    with pytest.raises(ValueError):
        vpu.chain(x, op, 250)  # not a multiple of the kernel's unroll


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_probe_kernel_matches_plain(cuda, dtype):
    from activegs_torch.scripts import microbench_bf16 as bf

    lo, hi = bf.MOVING_BAND
    x = lo + (hi - lo) * torch.rand((2, 256, 512), generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    k, p = bf.chain(x, dtype), bf.chain_plain(x, dtype)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    # the check bites: every element moved, and a chain of one loop
    # iteration fewer ends elsewhere
    assert bool((p != x.to(getattr(torch, dtype)).float()).all())
    assert bool((p != bf.chain_plain(x, dtype, bf.ROUNDS - bf.UNROLL)).all())


@pytest.mark.cuda
def test_gradient_sums_are_bitwise_repeatable(cuda):
    """The fixed-order sums and the gathers built on them give the same
    bits on every call, where index_add_ may not."""
    from activegs_torch.core.scatter import gather_rows, scatter_sum

    g = torch.Generator(device=cuda).manual_seed(0)
    idx = torch.randint(0, 1000, (200000,), device=cuda, generator=g)
    val = torch.randn(200000, 24, device=cuda, generator=g)
    ok = torch.rand(200000, device=cuda, generator=g) > 0.3
    sums = [scatter_sum(val, idx, 1000, ok) for _ in range(10)]
    assert all(torch.equal(sums[0], s) for s in sums)
    # against a float64 sum: some 140 terms a target, summed in float32
    want = torch.zeros(1000, 24, dtype=torch.float64, device=cuda).index_add_(0, idx[ok], val[ok].double())
    torch.testing.assert_close(sums[0].double(), want, rtol=0, atol=2e-4)
    src = torch.randn(1000, 24, device=cuda, generator=g, requires_grad=True)
    w = torch.randn(200000, 24, device=cuda, generator=g)
    grads = [torch.autograd.grad((gather_rows(src, idx, ok) * w).sum(), src)[0] for _ in range(10)]
    assert all(torch.equal(grads[0], x) for x in grads)
    # a whole render's parameter gradients
    cfg = CFGS["k128"]
    cam = tt.Camera(torch.eye(4, device=cuda), geo.intrinsics_from_fov(60.0, 60.0, device=cuda))
    base = scene(cuda)

    def render_grads():
        leaves = {n: getattr(base, n).clone().requires_grad_(True) for n in ("means", "opacities", "colors")}
        attrs = dataclasses.replace(base, **leaves)
        o, _ = renderer.render_view(attrs, cam, SHAPE, cfg)
        return torch.autograd.grad(o.rgb.sum() + o.depth.sum(), list(leaves.values()))

    first = render_grads()
    for _ in range(5):
        assert all(torch.equal(a, b) for a, b in zip(first, render_grads()))


@pytest.mark.cuda
def test_candidate_utility_kernel_matches_plain(cuda):
    """One candidate's (explore, exploit) through the fwd kernel against the
    plain forward version: explore within 1 voxel, exploit at 1e-4."""
    from unittest import mock

    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import voxel_map as vm
    from activegs_torch.planning import confidence as cf
    from activegs_torch.sim.synthetic import BoxRoomSimulator

    cfg, rcfg = gm.MapConfig(capacity=8192, bilateral_radius=2), tt.RasterConfig(entry_budget_mult=4.0)
    sim = BoxRoomSimulator(resolution=SHAPE, seed=11, depth_noise_co=0.0, device=cuda)
    frame = sim.simulate(geo.look_at((3.0, 2.5, 1.5), (5.5, 2.5, 1.2), device=cuda))
    state, _, _ = gm.spawn(gm.init_state(cfg, device=cuda), frame, cfg, rcfg)
    grid = vm.VoxelGrid.create(sim.bbox, vm.VoxelConfig(map_resolution=(0.4, 0.4, 0.4)))
    vstate = vm.update(vm.init_state(grid, cuda), grid, frame)
    cand = geo.look_at((3.0, 2.5, 1.5), (5.0, 4.0, 1.0), device=cuda)[None]
    args = (state, vstate.unexplored, cand, sim.intrinsic, torch.ones((1, 16, 16), dtype=torch.bool, device=cuda),
            torch.tensor(sim.depth_range, device=cuda), grid, (16, 16), cfg, rcfg)
    n0 = cp.fwd_kernel.launches
    ek, xk = cf._confidence_utility_batch(*args)
    assert cp.fwd_kernel.launches == n0 + 1
    with mock.patch.object(cp, "composite_fwd", cp.composite_fwd_plain):
        ep, xp = cf._confidence_utility_batch(*args)
    assert float(xp[0]) > 0
    assert float((ek - ep).abs().max()) * grid.num_voxels <= 1.0
    assert float((xk - xp).abs().max()) <= 1e-4 * float(xp.abs().max())


@pytest.mark.cuda
def test_fwd_kernel_matches_plain_at_1024(cuda):
    """The forward kernel on a 1024x1024 view (32 x 64 = 2048 tiles, the
    mesh renders' grid) of the wall-edge scene with the default raster
    config, against its plain version at the tolerances above."""
    cfg = tt.RasterConfig()
    args, ntx = scene_entries(wall_edge_scene(cuda), cfg, cuda, (1024, 1024))
    assert ntx == 32 and len(args[1]) == 2048
    o_k, o_p = cp.composite_fwd(*args, ntx, cfg), cp.composite_fwd_plain(*args, ntx, cfg)
    rows = [r for r in range(tt.O_TRANS + 1) if r != tt.O_DEPTH]
    torch.testing.assert_close(o_k[:, rows], o_p[:, rows], rtol=0, atol=2e-5)
    torch.testing.assert_close(o_k[:, tt.O_DEPTH], o_p[:, tt.O_DEPTH], rtol=0, atol=1e-4)
    assert torch.equal(o_k[:, tt.O_STOP :], o_p[:, tt.O_STOP :])


@pytest.mark.cuda
def test_tsdf_integrate_on_the_card_matches_the_cpu(cuda):
    """One TSDF integration of a 1024x1024 boxroom view on the card and on
    the CPU: weights equal at >= 99.99% of voxels, the TSDF within 1e-5
    where they are."""
    from activegs_torch.eval import tsdf
    from activegs_torch.sim.synthetic import BoxRoomSimulator

    sim = BoxRoomSimulator(resolution=(1024, 1024), seed=0, device=cuda)
    frame = sim.simulate(geo.look_at((3.0, 2.5, 1.5), (5.5, 3.0, 1.0), device=cuda), require_gt=True)
    grid = tsdf.TSDFGrid.create(((0.0, 0.0, 0.0), (6.0, 5.0, 3.0)), voxel=0.05, trunc=0.25)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        f = {k: v.to(dev) for k, v in frame.items()}
        out[dev.type] = tsdf.tsdf_state_to_numpy(tsdf.integrate(
            tsdf.init_state(grid, dev), grid, f["rgb"], f["depth"][0], f["extrinsic"], f["intrinsic"]))
    same = out["cuda"]["weight"] == out["cpu"]["weight"]
    assert same.mean() >= 0.9999 and out["cpu"]["weight"].sum() > 1000
    np.testing.assert_allclose(out["cuda"]["tsdf"][same], out["cpu"]["tsdf"][same], atol=1e-5, rtol=0)


def card_keyframe(cuda):
    """A map spawned from two 64x64 boxroom frames and a buffer of three,
    on the card."""
    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import keyframes as kf
    from activegs_torch.sim.synthetic import BoxRoomSimulator

    cfg, rcfg = gm.MapConfig(capacity=8192, bilateral_radius=2, batch_size=4), tt.RasterConfig(entry_budget_mult=4.0)
    sim = BoxRoomSimulator(resolution=SHAPE, seed=11, device=cuda)
    state, buf = gm.init_state(cfg, device=cuda), kf.init_buffer(8, *SHAPE, device=cuda)
    for i, target in enumerate(((5.5, 2.5, 1.2), (5.0, 4.0, 1.0), (5.5, 1.5, 1.4))):
        frame = sim.simulate(geo.look_at((3.0, 2.5, 1.5), target, device=cuda))
        if i < 2:
            state, _, _ = gm.spawn(state, frame, cfg, rcfg)
        buf = kf.add_frame(buf, frame)
    return cfg, rcfg, state, buf


def thread_ranks(n: int, fn):
    """`fn(group)` on `n` ranks sharing the card, one thread each, over
    in-process gloo groups (as `tests/test_torch_parallel.py` runs them)."""
    import threading
    from datetime import timedelta

    import torch.distributed as dist

    from activegs_torch.parallel import ViewGroup

    store, out, errs = dist.HashStore(), [None] * n, []

    def one(r):
        try:
            out[r] = fn(ViewGroup(dist.ProcessGroupGloo(store, r, n, timedelta(seconds=60)), r, n))
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errs.append(e)

    threads = [threading.Thread(target=one, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errs:
        raise errs[0]
    return out


@pytest.mark.cuda
def test_one_nccl_rank_is_bitwise_the_single_process_keyframe(cuda):
    """With one NCCL rank the all-reduce is the identity and every share's
    weight is 1: a sharded keyframe is bitwise the single-process one."""
    import torch.distributed as dist

    from activegs_torch.mapping import gaussians as gm
    from activegs_torch.mapping import trainer
    from activegs_torch.parallel import ViewGroup

    cfg, rcfg, state, buf = card_keyframe(cuda)
    views = trainer.draw_batch(buf, cfg, torch.Generator().manual_seed(3))
    copy = lambda b: dataclasses.replace(b, performance=b.performance.clone())  # noqa: E731
    want = trainer.train_keyframe(state, copy(buf), views, cfg, rcfg, steps=3)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        got = trainer.train_keyframe(state, copy(buf), views, cfg, rcfg, steps=3, group=ViewGroup(None, 0, 1))
    finally:
        dist.destroy_process_group()
    for f in gm.FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    assert torch.equal(got[1].performance, want[1].performance) and torch.equal(got[2], want[2])
    assert [int(got[3][k]) for k in got[3]] == [int(want[3][k]) for k in want[3]]


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_match_the_single_process_step(cuda):
    """Two ranks sharing the card over gloo: the sharded step's loss at
    relative 1e-5 and gradients at 1e-5 scaled of the single-process
    `batch_loss`, the same on both ranks."""
    from activegs_torch.mapping import keyframes as kf
    from activegs_torch.mapping import trainer
    from activegs_torch.parallel import sharded_train_step

    cfg, rcfg, state, buf = card_keyframe(cuda)
    ids, counts = trainer.draw_batch(buf, cfg, torch.Generator().manual_seed(3))
    batch = kf.decode_frames(buf, ids)
    leaves = lambda: {k: getattr(state, k).clone().requires_grad_(True) for k in trainer.PARAM_FIELDS}  # noqa: E731
    p = leaves()
    loss, _ = trainer.batch_loss(p, state, batch, counts, cfg, rcfg)
    grads = torch.autograd.grad(loss, list(p.values()))
    outs = thread_ranks(2, lambda g: sharded_train_step(leaves(), state, batch, counts, g, cfg, rcfg))
    assert torch.equal(outs[0][0], outs[1][0])
    assert float(outs[0][0]) == pytest.approx(float(loss.detach()), rel=1e-5)
    for k, g in zip(trainer.PARAM_FIELDS, grads):
        assert torch.equal(outs[0][1][k], outs[1][1][k]), k
        scale = float(g.abs().max()) + 1e-12
        assert float((outs[0][1][k] - g).abs().max()) / scale <= 1e-5, k


@pytest.mark.cuda
def test_resampled_step_kernel_path_matches_plain_path(cuda):
    """A resampled step's render (no frozen bins, binning inside each
    view's render): `batch_loss` and its gradients through the kernels
    against the plain versions, loss at relative 1e-5, gradients at
    relative L2 1e-3 (the L1 terms' kinks, ROADMAP.md section 3); a
    resampled keyframe launches forward and backward every step."""
    from unittest import mock

    from activegs_torch.mapping import keyframes as kf
    from activegs_torch.mapping import trainer

    cfg, rcfg, state, buf = card_keyframe(cuda)
    ids, counts = trainer.draw_batch(buf, cfg, torch.Generator().manual_seed(3))
    batch = kf.decode_frames(buf, ids)

    def loss_grads():
        p = {k: getattr(state, k).clone().requires_grad_(True) for k in trainer.PARAM_FIELDS}
        loss, _ = trainer.batch_loss(p, state, batch, counts, cfg, rcfg)
        return loss.detach(), torch.autograd.grad(loss, list(p.values()))

    lk, gk = loss_grads()
    with mock.patch.object(cp, "composite_fwd", cp.composite_fwd_plain), \
            mock.patch.object(cp, "composite_bwd", cp.composite_bwd_plain):
        lp, gp = loss_grads()
    assert float(lk) == pytest.approx(float(lp), rel=1e-5)
    for a, b in zip(gk, gp):
        assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)) <= 1e-3
    for k in cp.KERNELS:
        k.launches = 0
    r_cfg = dataclasses.replace(cfg, resample_per_step=True)
    _, _, loss, aux = trainer.train_keyframe(state, buf, None, r_cfg, rcfg, steps=3,
                                             generator=torch.Generator().manual_seed(3))
    assert math.isfinite(float(loss)) and aux == {"num_dropped": -1, "num_entries": -1}
    assert cp.fwd_kernel.launches >= 3 and cp.bwd_kernel.launches == cp.fwd_kernel.launches
