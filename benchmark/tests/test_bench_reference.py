"""The plain reference against the port's plain path (its kernels' plain
PyTorch versions) at a tiny size on the CPU."""

import dataclasses

import pytest
import torch

from activegs_torch.mapping import gaussians as gm
from activegs_torch.mapping import keyframes as kf
from activegs_torch.mapping import trainer
from activegs_torch.planning.confidence import _confidence_utility_batch
from activegs_torch.render.renderer import render_stats, render_view
from activegs_torch.render.types import Camera
from harness import cells, check, probe
from reference import planner as rplan
from reference import raster
from reference import train as rtrain

RES = 64


@pytest.fixture(scope="module")
def scene():
    torch.manual_seed(0)
    cell = cells.find("train-bench-200k")
    cell.config["config"]["simulator"]["sensor"]["resolution"] = [RES, RES]
    cell.traffic["surfels"] = 3000
    cell.traffic["keyframes"] = 4
    system = cells.generator(cell).System(cell, 7, torch.device("cpu"))
    state = system.state
    # confidences that vary, so the confidence channel is not all zero
    g = torch.Generator().manual_seed(1)
    state.view_scores[: state.count] = torch.rand(state.count, generator=g)
    state.view_means[: state.count] = 0.3 * torch.rand((state.count, 3), generator=g)
    yield cell, system, state
    system.close()


def test_render_matches(scene):
    cell, system, state = scene
    attrs = gm.attrs_of(state, system.cfg)
    a = raster.activate(probe.raw_map(state), system.cfg.scale_factor, system.cfg.scale_max)
    rc = check.raster_of(cell.config)
    for i in range(system.buf.count):
        ext, intr = system.buf.extrinsics[i], system.buf.intrinsics[i]
        o, aux = render_view(attrs, Camera(ext, intr), (RES, RES), system.rc)
        r, bins = raster.render(a, ext, intr, (RES, RES), rc)
        for c in ("rgb", "depth", "confidence", "opacity", "normal"):
            torch.testing.assert_close(getattr(o, c), r[c], atol=2e-5, rtol=1e-4)
        assert float(r["confidence"].abs().sum()) > 0
        assert int(aux["num_dropped"]) == bins.n_trunc


def test_first_steps_match(scene):
    cell, system, state = scene
    ids, counts = trainer.draw_batch(system.buf, system.cfg, torch.Generator().manual_seed(0))
    batch = kf.decode_frames(system.buf, ids)
    params = {k: getattr(state, k).detach().clone().requires_grad_(True) for k in trainer.PARAM_FIELDS}
    opt = trainer.make_optimizer(params, system.cfg)
    losses = []
    for s in range(3):
        opt.zero_grad(set_to_none=True)
        loss, _ = trainer.batch_loss(params, state, batch, counts, system.cfg, system.rc)
        loss.backward()
        if s == 0:
            grads = {k: p.grad.clone() for k, p in params.items()}
        opt.step()
        losses.append(float(loss.detach()))
    ref = rtrain.follow(probe.raw_map(state), batch, counts, check.map_settings(cell.config), check.raster_of(cell.config))
    assert ref["loss"] == pytest.approx(losses, rel=1e-5)
    for k in trainer.PARAM_FIELDS:
        torch.testing.assert_close(ref["grad"][k], grads[k], atol=1e-6, rtol=1e-3)
    # Adam's eps of 1e-15 moves a leaf's element by about lr whatever the
    # size of its gradient, so rounding flips single elements: the leaves'
    # change agrees in norm, as the check compares it
    raw = probe.raw_map(state)
    gap, _ = check._norm_gap({k: params[k].detach() - raw[k] for k in trainer.PARAM_FIELDS},
                             {k: ref["params"][k] - raw[k] for k in trainer.PARAM_FIELDS}, trainer.PARAM_FIELDS)
    assert gap < 1e-3


def test_stats_match(scene):
    cell, system, state = scene
    attrs = gm.attrs_of(state, system.cfg)
    a = raster.activate(probe.raw_map(state), system.cfg.scale_factor, system.cfg.scale_max)
    _, depth, exts, intrs = kf.decode_frames(system.buf, torch.arange(system.buf.count))
    for i in range(system.buf.count):
        mask = (depth[i, 0] > 1.5).to(torch.float32)
        imp, cnt = render_stats(attrs, Camera(exts[i], intrs[i]), (RES, RES), system.rc, render_mask=mask)
        imp_r, cnt_r = raster.view_stats(a, exts[i], intrs[i], (RES, RES), check.raster_of(cell.config), mask, 0.03)
        torch.testing.assert_close(imp, imp_r, atol=1e-5, rtol=1e-4)
        assert int((cnt.long() - cnt_r).abs().sum()) <= max(1, int(cnt_r.sum()) // 1000)
        assert int(cnt_r.sum()) > 0


def test_utilities_match(scene):
    cell, system, state = scene
    cfg = cell.config
    rc = check.raster_of(cfg, utility=True)
    prc = dataclasses.replace(system.rc, max_dup=rc.max_dup, entry_budget_mult=1.0)
    from activegs_torch.mapping import voxel_map as vm

    grid = vm.VoxelGrid.create(cfg["constants"]["scene_bbox"], vm.VoxelConfig())
    unexplored = torch.rand(grid.num_voxels, generator=torch.Generator().manual_seed(2)) > 0.3
    cands = system.buf.extrinsics[: system.buf.count]
    intr = check.intrinsics(cfg["config"]["simulator"]["sensor"]["fov"], "cpu")
    shape = (16, 16)
    valid = torch.ones((len(cands), *shape), dtype=torch.bool)
    dr = torch.tensor([0.0, 5.0])
    ex_p, xp_p = _confidence_utility_batch(state, unexplored, cands, intr, valid, dr, grid, shape, system.cfg, prc)
    a = raster.activate(probe.raw_map(state), system.cfg.scale_factor, system.cfg.scale_max)
    _, _, _, centres = rplan.voxel_grid(cfg["constants"]["scene_bbox"], (0.2, 0.2, 0.2))
    ex_r, xp_r = rplan.utilities(a, cands, intr, shape, rc, unexplored, torch.as_tensor(centres), (0.0, 5.0))
    torch.testing.assert_close(xp_p, xp_r, atol=1e-6, rtol=1e-5)
    assert torch.equal(ex_p, ex_r) and float(ex_r.sum()) > 0
