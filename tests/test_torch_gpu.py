"""The port's CUDA kernels on a GPU, against their plain PyTorch versions.

Every test here is marked `cuda` and skips without a CUDA device (the
kernels have no CPU mode; their plain versions are held to the reference by
the other `test_torch_*.py` files). This file imports no JAX, so on a
machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

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


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_id", list(CFGS))
def test_kernels_match_plain(cuda, cfg_id):
    cfg = CFGS[cfg_id]
    cam = tt.Camera(torch.eye(4, device=cuda), geo.intrinsics_from_fov(60.0, 60.0, device=cuda))
    p2d, _, dz, iv = pp.preprocess(scene(cuda), cam, SHAPE, cfg)
    b = binning.bin_entries(p2d, dz, iv, SHAPE, cfg)
    ent = renderer.gather_entries(p2d, b.gid)
    _, _, ntx, _ = binning.bin_tile_dims(SHAPE, cfg)
    args = (ent, b.tile_start, b.tile_len)
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
    for r in range(tt.USED_ROWS):
        assert float((d_k[r] - d_p[r]).abs().max()) <= 3e-4 * float(d_p[r].abs().max()) + 1e-12, r
    assert not d_k[tt.USED_ROWS :].any()
    m = (torch.rand(len(b.tile_start), cfg.tile_pixels, device=cuda) > 0.3).float()
    i_k, c_k = cp.composite_stats(*args, m, 0.03, ntx, cfg)
    i_p, c_p = cp.composite_stats_plain(*args, m, 0.03, ntx, cfg)
    assert float((i_k - i_p).abs().max()) <= 1e-5 * float(i_p.abs().max())
    assert int((c_k != c_p).sum()) <= 2  # only where some w * mask meets 0.03 within rounding
    assert all(k.launches > 0 for k in cp.KERNELS)


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
