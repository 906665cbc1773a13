"""The port's view sharding (`activegs_torch/parallel/`, `runtime.py`)
against its single-process path and the reference's sharded functions.

In one process the ranks are threads, each with its own gloo process group
on one in-process store: the collectives are the real gloo ones. The
reference runs its `shard_map` on the 8-device virtual CPU mesh of
`tests/conftest.py`. A last test spawns two processes that join one group
through `runtime.init_distributed` from the environment: this file run as
`python tests/test_torch_parallel.py <port> <rank>` is the child, which
imports no JAX (the reference is imported inside the tests).
"""

import dataclasses
import hashlib
import os
import socket
import subprocess
import sys
import threading
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from activegs_torch import runtime
from activegs_torch.mapping import gaussians as tgm
from activegs_torch.mapping import trainer as ttr
from activegs_torch.parallel import sharded

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(n: int, fn):
    """`fn(group)` on `n` ranks, one thread each, over in-process gloo
    groups. Returns the results by rank; re-raises a rank's error."""
    store = dist.HashStore()
    out, errs = [None] * n, []

    def one(r):
        try:
            pg = dist.ProcessGroupGloo(store, r, n, timedelta(seconds=60))
            out[r] = fn(sharded.ViewGroup(pg, r, n))
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errs.append(e)

    threads = [threading.Thread(target=one, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    if errs:
        raise errs[0]
    assert not any(t.is_alive() for t in threads), "a rank hung"
    return out


def scaled_close(got, want, atol, msg=""):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g / scale, want / scale, atol=atol, rtol=0, err_msg=msg)


def port_of(cfg, raster, state):
    from test_torch_core import t_like
    from test_torch_mapping import t_state

    from activegs_torch.render import types as tt

    return t_like(tgm.MapConfig, cfg), t_like(tt.RasterConfig, raster), t_state(state)


def leaves(state):
    return {k: getattr(state, k).detach().clone().requires_grad_(True) for k in ttr.PARAM_FIELDS}


# ---------------------------------------------------------------------------
# group size, shares, the mapper's rule
# ---------------------------------------------------------------------------


def test_group_size_and_shares():
    assert [sharded.group_size(w, 8) for w in (1, 2, 3, 4, 5, 8, 16)] == [1, 2, 2, 4, 4, 8, 8]
    assert sharded.group_size(8, 6) == 2
    for v in (0, 1, 3, 5, 8):
        for n in (1, 2, 3, 4, 8):
            shares = [sharded.view_share(v, sharded.ViewGroup(None, r, n)) for r in range(n)]
            assert [i for s in shares for i in s] == list(range(v)), (v, n)
            assert max(map(len, shares)) - min(map(len, shares)) <= 1


@pytest.mark.parametrize("world, ok", [(2, True), (4, True), (8, True), (3, False), (6, False), (16, False)])
def test_mapper_builds_a_group_only_for_powers_of_two_dividing_the_batch(monkeypatch, world, ok):
    from activegs_torch.mapping.mapper import IncrementalMapper
    from activegs_torch.planning.planner import PlanBase, PlannerConfig
    from activegs_torch.mapping.voxel_map import VoxelConfig

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    cfg = tgm.MapConfig(capacity=256, batch_size=8)
    if not ok:
        with pytest.raises(ValueError, match="power of two"):
            IncrementalMapper(cfg, device="cpu")
        return
    m = IncrementalMapper(cfg, device="cpu")
    assert m.group == sharded.ViewGroup(None, 1, world) and not m.writes
    planner = PlanBase(PlannerConfig(), cfg, VoxelConfig())
    m.load_planner(planner)
    assert planner.group is m.group
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    assert IncrementalMapper(cfg, device="cpu").group is None


# ---------------------------------------------------------------------------
# init_distributed
# ---------------------------------------------------------------------------

DIST_ENV = ("ACTIVEGS_DISTRIBUTED", "ACTIVEGS_DIST_BACKEND", *runtime.ENV, "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for k in DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_init_distributed_is_opt_in(clean_env):
    assert runtime.init_distributed() is False
    clean_env.setenv("ACTIVEGS_DISTRIBUTED", "0")
    assert runtime.init_distributed() is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("env", [
    {"ACTIVEGS_DISTRIBUTED": "1"},
    {"RANK": "0", "WORLD_SIZE": "2"},
    {"ACTIVEGS_DISTRIBUTED": "1", "RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "localhost"},
], ids=["opt-in-only", "rank-and-size", "no-port"])
def test_init_distributed_refuses_a_partial_environment(clean_env, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(RuntimeError, match="missing"):
        runtime.init_distributed()
    assert not dist.is_initialized()


def test_init_distributed_refuses_nccl_with_more_ranks_than_cards(clean_env):
    for k, v in {"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}.items():
        clean_env.setenv(k, v)
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    clean_env.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="gloo"):
        runtime.init_distributed(backend="nccl")
    clean_env.setenv("ACTIVEGS_DIST_BACKEND", "nccl")
    with pytest.raises(RuntimeError, match="gloo"):
        runtime.init_distributed()
    # nccl is the default where CUDA is available: still refused, never switched
    clean_env.delenv("ACTIVEGS_DIST_BACKEND")
    with pytest.raises(RuntimeError, match="one rank a card"):
        runtime.init_distributed()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# one sharded step, one sharded keyframe
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """The reference's `tests/test_parallel.py::tiny_setup` (8 views of
    32x32, 64 gaussians) and its sharded step on the 8-device mesh (which
    its own test holds to its single-device step at 1e-5 scaled)."""
    from activegs_tpu.mapping import trainer as jtr
    from activegs_tpu.parallel import make_view_mesh, sharded_train_step as j_sharded_step
    from test_parallel import tiny_setup

    cfg, raster, state, batch = tiny_setup()
    want = j_sharded_step(jtr._params_of(state), state, batch, make_view_mesh(8), cfg, raster)
    return cfg, raster, state, batch, want


@pytest.mark.parametrize("ranks", [8, 2, 3])
def test_sharded_step_matches_single_process_and_reference(tiny, ranks):
    """Loss at relative 1e-5 and gradients at 1e-5 scaled against the
    port's `batch_loss`, the per-frame errors gathered on every rank; loss
    at relative 1e-5 against the reference's sharded step, gradients at the
    port's contract with the reference, 3e-4 scaled (the two packages'
    single-process gradients differ by up to 2.4e-5 scaled here, in
    `rotations_raw`: they round apart). 3 ranks split 8 views 3 / 3 / 2."""
    from test_torch_core import to_t

    cfg, raster, state, batch, (l_j, g_j, pf_j) = tiny
    cfg_t, raster_t, st = port_of(cfg, raster, state)
    batch_t = tuple(to_t(x) for x in batch)
    counts = torch.ones(batch_t[0].shape[0], dtype=torch.int64)
    p = leaves(st)
    loss, per_frame = ttr.batch_loss(p, st, batch_t, counts, cfg_t, raster_t)
    grads = torch.autograd.grad(loss, list(p.values()))

    outs = run_ranks(ranks, lambda g: sharded.sharded_train_step(leaves(st), st, batch_t, counts, g, cfg_t, raster_t))
    for r, (l_s, g_s, pf_s) in enumerate(outs):
        assert torch.equal(l_s, outs[0][0]) and torch.equal(pf_s, outs[0][2]), r
        for k in ttr.PARAM_FIELDS:
            assert torch.equal(g_s[k], outs[0][1][k]), (r, k)
    l_s, g_s, pf_s = outs[0]
    assert float(l_s) == pytest.approx(float(loss.detach()), rel=1e-5)
    assert float(l_s) == pytest.approx(float(l_j), rel=1e-5)
    np.testing.assert_allclose(pf_s.numpy(), per_frame.numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(pf_s.numpy(), np.asarray(pf_j), rtol=1e-5, atol=1e-7)
    for k, g in zip(ttr.PARAM_FIELDS, grads):
        scaled_close(g_s[k], g.numpy(), 1e-5, k)
        scaled_close(g_s[k], g_j[k], 3e-4, k)


def test_sharded_step_with_fewer_views_than_ranks(tiny):
    """2 views on 4 ranks: two ranks render nothing, join every collective,
    and the result is the single-process one."""
    from test_torch_core import to_t

    cfg, raster, state, batch, _ = tiny
    cfg_t, raster_t, st = port_of(cfg, raster, state)
    batch_t = tuple(to_t(x)[:2] for x in batch)
    counts = torch.tensor([3, 5])
    p = leaves(st)
    loss, per_frame = ttr.batch_loss(p, st, batch_t, counts, cfg_t, raster_t)
    grads = torch.autograd.grad(loss, list(p.values()))
    l_s, g_s, pf_s = run_ranks(4, lambda g: sharded.sharded_train_step(
        leaves(st), st, batch_t, counts, g, cfg_t, raster_t))[3]
    assert float(l_s) == pytest.approx(float(loss.detach()), rel=1e-5)
    np.testing.assert_allclose(pf_s.numpy(), per_frame.numpy(), rtol=1e-6, atol=0)
    for k, g in zip(ttr.PARAM_FIELDS, grads):
        scaled_close(g_s[k], g.numpy(), 1e-5, k)


@pytest.fixture(scope="module")
def keyframe_setup():
    """The reference's `TestShardedMission._keyframe_setup` (batch 4, 2
    steps, 8 frames of 32x32) and its keyframe trained on a 4-device mesh
    from key 7 (which its own test holds to its single-device keyframe)."""
    import jax

    from activegs_tpu.mapping import trainer as jtr
    from activegs_tpu.parallel import make_view_mesh
    from test_parallel import TestShardedMission
    from test_torch_mapping import ref_batch_ids

    cfg, raster, state, buf = TestShardedMission()._keyframe_setup()
    key = jax.random.PRNGKey(7)
    mesh = jtr.train_keyframe(state, buf, key, cfg, raster, mesh=make_view_mesh(4))
    return cfg, raster, state, buf, ref_batch_ids(buf, key, cfg), mesh


@pytest.mark.parametrize("subset_bucket", [None, 64], ids=["bins", "subsets"])
def test_sharded_keyframe_matches_single_process_and_reference(keyframe_setup, subset_bucket):
    """`train_keyframe` with a 4-rank group: parameters within 1e-4 scaled
    and performance within 1e-5 of the single-process keyframe and of the
    reference's sharded one (its own tolerances,
    `tests/test_parallel.py:112-130`); every rank's map bitwise the same."""
    from test_torch_core import to_t
    from test_torch_mapping import t_buffer

    cfg, raster, state, buf, ids, (s_m, b_m, l_m, _) = keyframe_setup
    cfg_t, raster_t, st = port_of(cfg, raster, state)
    views = ttr.batch_views(to_t(ids).long())
    s1, b1, l1, aux1 = ttr.train_keyframe(st, t_buffer(buf), views, cfg_t, raster_t, subset_bucket=subset_bucket)
    outs = run_ranks(4, lambda g: ttr.train_keyframe(
        st, t_buffer(buf), views, cfg_t, raster_t, subset_bucket=subset_bucket, group=g))
    for s_r, b_r, l_r, aux_r in outs:
        for f in tgm.FIELDS:
            assert torch.equal(getattr(s_r, f), getattr(outs[0][0], f)), f
        assert torch.equal(b_r.performance, outs[0][1].performance)
        assert [int(aux_r[k]) for k in aux_r] == [int(aux1[k]) for k in aux1]
    s_s, b_s, l_s, _ = outs[0]
    assert float(l_s) == pytest.approx(float(l1), rel=1e-4)
    assert float(l_s) == pytest.approx(float(l_m), rel=1e-4)
    n = st.count
    for f in ("means", "scales_raw", "colors"):
        got = getattr(s_s, f)[:n]
        scaled_close(got, getattr(s1, f)[:n].numpy(), 1e-4, f)
        scaled_close(got, np.asarray(getattr(s_m, f))[:n], 1e-4, f)
    for want in (b1.performance.numpy(), np.asarray(b_m.performance)):
        np.testing.assert_allclose(b_s.performance.numpy(), want, atol=1e-5, rtol=0)


def test_sharded_view_bins_hold_only_the_ranks_share(keyframe_setup):
    from test_torch_core import to_t
    from test_torch_mapping import t_buffer

    from activegs_torch.mapping import keyframes as tkf

    cfg, raster, state, buf, ids, _ = keyframe_setup
    cfg_t, raster_t, st = port_of(cfg, raster, state)
    batch = tkf.decode_frames(t_buffer(buf), torch.unique(to_t(ids).long()))
    want, _ = ttr.prepare_views(st, batch, cfg_t, raster_t)
    attrs = tgm.attrs_of(st, cfg_t)
    outs = run_ranks(3, lambda g: sharded.sharded_view_bins(attrs, batch[2], batch[3], g, (32, 32), raster_t))
    for r, bins in enumerate(outs):
        share = sharded.view_share(len(want), sharded.ViewGroup(None, r, 3))
        for i, b in enumerate(bins):
            assert (b is None) == (i not in share)
            if b is not None:
                for f in dataclasses.fields(b):
                    assert torch.equal(getattr(b, f.name), getattr(want[i], f.name)), f.name


# ---------------------------------------------------------------------------
# candidate utilities
# ---------------------------------------------------------------------------


UTILITY_OPTS = ({}, {"explore_only": True}, {"subset_bucket": 64})


@pytest.fixture(scope="module")
def utility_setup(keyframe_setup):
    """The reference's `test_sharded_candidate_utility_matches_batch`
    inputs (8 candidates at 16x16 around the origin, random valid masks)
    and its sharded utilities on the 8-device mesh for each of
    UTILITY_OPTS."""
    import jax.numpy as jnp

    from activegs_tpu.core import geometry as jgeo
    from activegs_tpu.mapping import voxel_map as jvm
    from activegs_tpu.parallel import make_view_mesh
    from activegs_tpu.parallel.sharded import sharded_candidate_utility as j_sharded

    cfg, raster, state, _, _, _ = keyframe_setup
    vcfg = jvm.VoxelConfig(map_resolution=(0.5, 0.5, 0.5))
    grid = jvm.VoxelGrid.create((np.array([-2.0, -2.0, -1.0]), np.array([2.0, 2.0, 3.0])), vcfg)
    vstate = jvm.init_state(grid)
    rng = np.random.default_rng(0)
    v, res = 8, 16
    cands = np.tile(np.eye(4, dtype=np.float32)[None], (v, 1, 1))
    cands[:, :3, 3] = rng.uniform(-0.3, 0.3, (v, 3)).astype(np.float32)
    intr = np.asarray(jgeo.intrinsics_from_fov(60.0, 60.0))
    masks = rng.uniform(size=(v, res, res)) > 0.2
    dr = np.asarray([0.0, 5.0], np.float32)
    j_args = (state, vstate.unexplored, jnp.asarray(cands), jnp.asarray(intr), jnp.asarray(masks), jnp.asarray(dr))
    want = [
        [np.asarray(x) for x in j_sharded(*j_args, make_view_mesh(8), grid, (res, res), cfg, raster, **opts)]
        for opts in UTILITY_OPTS
    ]
    return (cands, intr, masks, dr, grid, vstate, res), want


@pytest.mark.parametrize("ranks", [8, 3])
def test_sharded_candidate_utility_matches_batch_and_reference(keyframe_setup, utility_setup, ranks):
    """The reference's `test_sharded_candidate_utility_matches_batch` on
    the port: plain, `explore_only` and `subset_bucket` = 64, within 1e-6
    of the port's batch path and of the reference's sharded utilities
    (which its own test holds to its batch path at 1e-6); every rank gets
    the same vectors. 3 ranks pad the 8 candidates to 9."""
    from test_torch_core import to_t
    from test_torch_planning import t_grid, t_vstate

    from activegs_torch.planning.confidence import _confidence_utility_batch

    cfg, raster, state, _, _, _ = keyframe_setup
    (cands, intr, masks, dr, grid, vstate, res), want = utility_setup
    cfg_t, raster_t, st = port_of(cfg, raster, state)
    t_args = (st, t_vstate(vstate).unexplored, to_t(cands), to_t(intr), torch.from_numpy(masks), to_t(dr))
    tg = t_grid(grid)
    for opts, want_m in zip(UTILITY_OPTS, want):
        batch = [x.numpy() for x in _confidence_utility_batch(*t_args, tg, (res, res), cfg_t, raster_t, **opts)]
        outs = run_ranks(ranks, lambda g: sharded.sharded_candidate_utility(
            *t_args, g, tg, (res, res), cfg_t, raster_t, **opts))
        assert all(torch.equal(o[i], outs[0][i]) for o in outs for i in (0, 1))
        got = [x.numpy() for x in outs[0]]
        assert got[0].shape == (len(cands),) and want_m[0].max() > 0
        for g_, b_, m_ in zip(got, batch, want_m):
            np.testing.assert_allclose(g_, b_, atol=1e-6, rtol=0, err_msg=str(opts))
            np.testing.assert_allclose(g_, m_, atol=1e-6, rtol=0, err_msg=str(opts))
        if opts.get("explore_only"):
            assert float(np.abs(got[1]).max()) == 0.0


# ---------------------------------------------------------------------------
# two processes over gloo, from the environment
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_over_gloo(tmp_path):
    """Two processes join one group through `runtime.init_distributed` from
    torchrun's variables; each runs one sharded step across the process
    boundary against its own single-process result, then a 2-step mission
    through `apps.main` on the CPU. Both print the same loss and the same
    digest of the final map; rank 0 alone writes the experiment."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(port), str(r), str(tmp_path)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for r in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    ok = [line for out in outs for line in out.splitlines() if line.startswith("MP_OK")]
    assert len(ok) == 2 and ok[0] == ok[1], ok
    exps = [d for d, _, files in os.walk(tmp_path / "exp") if "step_stats.jsonl" in files]
    assert len(exps) == 1, exps


def _child(port: str, rank: str, out_dir: str) -> None:
    """One rank of `test_two_processes_over_gloo` (no JAX here)."""
    os.environ.update(RANK=rank, WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=port,
                      ACTIVEGS_DIST_BACKEND="gloo")
    torch.set_num_threads(2)
    assert runtime.init_distributed() and dist.get_world_size() == 2

    from activegs_torch.apps import main as tmain
    from activegs_torch.core import geometry as geo
    from activegs_torch.render.types import RasterConfig

    # a deterministic tiny problem, the same on both ranks
    rng = np.random.default_rng(0)
    v, res, n = 4, 16, 32
    cfg, raster = tgm.MapConfig(capacity=64), RasterConfig()
    state = tgm.init_state(cfg, "cpu")
    state.means[:n] = torch.from_numpy(rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)) + torch.tensor([0.0, 0, 2])
    state.opacities_raw[:n] = 0.5
    state.colors[:n] = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    state = dataclasses.replace(state, count=n)
    batch = (
        torch.from_numpy(rng.uniform(0, 1, (v, 3, res, res)).astype(np.float32)),
        torch.from_numpy(rng.uniform(1, 3, (v, 1, res, res)).astype(np.float32)),
        torch.eye(4).repeat(v, 1, 1),
        geo.intrinsics_from_fov(60.0, 60.0, device="cpu").repeat(v, 1, 1),
    )
    counts = torch.tensor([1, 2, 1, 4])
    p = leaves(state)
    loss_ref, _ = ttr.batch_loss(p, state, batch, counts, cfg, raster)
    g_ref = torch.autograd.grad(loss_ref, list(p.values()))
    loss_ref = loss_ref.detach()
    group = sharded.make_view_group()
    loss, grads, per_frame = sharded.sharded_train_step(leaves(state), state, batch, counts, group, cfg, raster)
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * max(1.0, abs(float(loss_ref))), (float(loss), float(loss_ref))
    for k, g in zip(ttr.PARAM_FIELDS, g_ref):
        scaled_close(grads[k], g.numpy(), 1e-5, k)
    assert per_frame.shape == (v,)

    mapper = tmain.main([
        "device=cpu", "simulator.sensor.resolution=[64,64]", "mapper.gaussian_map.capacity=4096",
        "mapper.gaussian_map.optimization_steps=2", "mapper.gaussian_map.bilateral_radius=2",
        "mapper.keyframe_capacity=8", "planner.sample_num=8", "planner.max_roi_sample_num=0",
        "mapper.raster.entry_budget_mult=4.0", "max_steps=2", f"experiment.output_dir={out_dir}/exp",
    ])
    assert mapper.group is not None and mapper.planner.group is mapper.group and mapper.frame_id == 2
    digest = hashlib.sha256(b"".join(x.tobytes() for x in tgm.state_to_numpy(mapper.gm_state).values())).hexdigest()
    print(f"MP_OK loss={float(loss):.6f} map={digest[:16]} count={mapper.gm_state.count}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    _child(*sys.argv[1:4])
