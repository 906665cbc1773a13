"""The port's tracer (`activegs_torch/tracing.py`): spans, their buffer, the
clock they share with torch.profiler, and the mission timers built on them.

The two tests marked `cuda` hold the spans against the card: every call of
the training and post-processing path that makes the host wait for the
device sits in a `sync.*` span (torch's sync debug mode raises at any other),
and each compositor kernel's launch lies inside its `render.composite_*`
span. This file imports no JAX, so on a machine with a card it runs alone:

    python -m pytest --noconftest -q tests/test_torch_tracing.py
"""

import re
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from activegs_torch import tracing
from activegs_torch.mapping import gaussians as gm
from activegs_torch.mapping import trainer
from activegs_torch.mapping import voxel_map as vm
from activegs_torch.mapping.mapper import IncrementalMapper
from activegs_torch.planning import ConfidencePlanner, PlannerConfig
from activegs_torch.render.types import RasterConfig
from activegs_torch.sim.synthetic import BoxRoomSimulator

INIT_POSE = ((0.0, 0.0, 1.0, 1.0), (-1.0, 0.0, 0.0, 2.5), (0.0, -1.0, 0.0, 1.5), (0.0, 0.0, 0.0, 1.0))


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the compositor kernels have no CPU mode")
    return torch.device("cuda")


def tiny_mission(device, steps: int, res: int = 32, map_cfg: gm.MapConfig | None = None):
    """A confidence-planner mission of `steps` steps on the boxroom at
    `res` x `res`, small enough for a test. Returns (mapper, step stats)."""
    map_cfg = map_cfg or gm.MapConfig(capacity=8192, optimization_steps=2, bilateral_radius=2)
    voxel_cfg = vm.VoxelConfig(map_resolution=(0.4, 0.4, 0.4))
    raster_cfg = RasterConfig()
    planner = ConfidencePlanner(
        PlannerConfig(sample_num=4, max_roi_sample_num=2, radius=1.5, init_pose=INIT_POSE),
        map_cfg, voxel_cfg, raster_cfg, seed=0,
    )
    mapper = IncrementalMapper(map_cfg, voxel_cfg, raster_cfg, keyframe_capacity=8, seed=0, device=device)
    mapper.load_simulator(BoxRoomSimulator(resolution=(res, res), seed=3, depth_noise_co=0.0, device=device))
    mapper.load_planner(planner)
    mapper.init_map()
    return mapper, [mapper.step() for _ in range(steps)]


def test_nesting_and_parent_indices():
    with tracing.recording():
        with tracing.span("a"):
            with tracing.span("b"):
                with tracing.span("c"):
                    pass
            with tracing.host_read("site"):
                pass
        with tracing.span("d"):
            pass
    got = tracing.spans()
    assert [r.name for r in got] == ["a", "b", "c", "sync.site", "d"]
    idx = {r.name: r.index for r in got}
    assert [r.parent for r in got] == [-1, idx["a"], idx["b"], idx["a"], -1]
    for r in got:
        assert r.end_ns >= r.start_ns
        if r.parent >= 0:
            p = got[[x.index for x in got].index(r.parent)]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert tracing.spans(got[1].start_ns, got[1].end_ns) == [got[1], got[2]]


def test_recording_off_keeps_nothing_but_times_the_span():
    assert not tracing.is_recording()
    with tracing.span("off") as s:
        time.sleep(0.002)
    assert tracing.spans() == []
    assert 0.002 <= s.seconds < 1.0
    assert s.seconds == (s.end_ns - s.start_ns) / 1e9


@pytest.mark.parametrize("switch", ["recording", "profiler"])
def test_recording_and_profiler_turn_recording_on(switch):
    ctx = tracing.recording() if switch == "recording" else profile(activities=[ProfilerActivity.CPU])
    with ctx:
        assert tracing.is_recording()
        with tracing.span("on"):
            pass
    assert not tracing.is_recording()
    with tracing.span("after"):
        pass
    assert [r.name for r in tracing.spans()] == ["on"]


def test_buffer_bound_and_dropped_count(monkeypatch):
    """A full buffer lets its oldest spans go, so a long profiling session
    keeps recording the newest."""
    monkeypatch.setattr(tracing, "CAPACITY", 5)
    with tracing.recording():
        for i in range(8):
            with tracing.span(f"s{i}") as s:
                pass
            assert s.seconds >= 0
    got = tracing.spans()
    assert [r.name for r in got] == [f"s{i}" for i in range(3, 8)]
    assert [r.index - got[0].index for r in got] == list(range(5))
    assert tracing.dropped() == 3
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0
    with tracing.recording(), tracing.span("next") as s:
        pass
    assert [(r.name, r.index) for r in tracing.spans()] == [("next", got[-1].index + 1)]


def test_span_as_a_decorator_opens_one_span_a_call():
    @tracing.span("f")
    def f(n):
        """f's doc"""
        return f(n - 1) + 1 if n else 0

    assert f.__name__ == "f" and f.__doc__ == "f's doc"
    with tracing.recording():
        assert f(2) == 2
    got = tracing.spans()
    assert [r.name for r in got] == ["f"] * 3
    assert [r.parent for r in got] == [-1, got[0].index, got[1].index]
    assert f(1) == 1 and len(tracing.spans()) == 3


def test_profiler_ops_share_the_span_clock():
    """torch.profiler stamps an op on the clock of `time.time_ns()`: the op
    starts and ends inside the span around it."""
    x = torch.ones(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("around") as s:
            torch.mm(x, x)
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert ops
    for e in ops:
        assert s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s.end_ns
    rec = [r for r in tracing.spans() if r.name == "around"]
    assert [(r.start_ns, r.end_ns) for r in rec] == [(s.start_ns, s.end_ns)]


def test_mission_timers_keep_their_keys():
    """A tiny CPU mission's timers, now read from spans: the same keys as
    before, `phase_times` sums to `t_mapping` within rounding, and the spans
    recorded meanwhile nest as the timers say."""
    with tracing.recording():
        mapper, stats = tiny_mission("cpu", steps=3)
    for st in stats:
        assert list(st["phase_times"]) == ["spawn", "view_stats", "train", "post", "voxel"]
        assert all(v == round(v, 3) >= 0 for v in st["phase_times"].values())
        assert abs(sum(st["phase_times"].values()) - st["t_mapping"]) <= 5 * 0.0005 + 0.005
    assert stats[0]["plan_times"] == {}
    for st in stats[1:]:
        assert list(st["plan_times"]) == ["masks", "roi_rand", "utility", "astar", "utility_stats", "utility_batch"]
        assert all(v == round(v, 3) >= 0 for v in st["plan_times"].values())
        pt = st["plan_times"]
        assert pt["utility_stats"] + pt["utility_batch"] <= pt["utility"] + 0.0015
    assert set(mapper.planner.last_utility_times) == {"stats", "batch"}
    assert not hasattr(mapper.planner, "last_utility_groups")
    rec = tracing.spans()
    by_index = {r.index: r for r in rec}
    names = [r.name for r in rec]
    assert names.count("map.step") == 3 and names.count("train.keyframe") == 3
    for r in rec:
        if r.name in ("map.spawn", "map.view_stats", "map.train", "map.post", "map.voxel"):
            assert by_index[r.parent].name == "map.step"
        if r.name in ("train.prepare", "train.forward", "train.backward", "train.update"):
            assert by_index[r.parent].name == "train.keyframe"
        if r.name in ("plan.utility_stats", "plan.utility_batch"):
            assert by_index[r.parent].name == "plan.utility"
    # 2 Adam steps a keyframe: a forward and a backward span each, and two
    # update spans, the gradients cleared before the forward and Adam after
    assert names.count("train.forward") == names.count("train.backward") == 6
    assert names.count("train.update") == 12


def _training_calls(mapper):
    """The training and post-processing path of one mission step, on the
    mapper's state: the batch draw, its view stats, train_keyframe, the
    stats budgets and post_process with the prune. Returns (loss, aux, the
    subset bucket)."""
    cfg, rc = mapper.map_cfg, mapper.raster_cfg
    state = gm.slice_state(mapper.gm_state, gm.bucket_capacity(mapper.gm_state.count, cfg.capacity))
    buf = mapper.keyframes
    views = trainer.draw_batch(buf, cfg, mapper.generator)
    max_iv, max_e = trainer.keyframe_view_stats(state, buf, views[0], cfg, rc)
    bucket = trainer.pick_subset_bucket(max_iv, state.capacity)
    state, buf, loss, aux = trainer.train_keyframe(
        state, buf, views, cfg, rc, subset_bucket=bucket, entry_budget=trainer.pick_entry_bucket(max_e),
    )
    stats_iv, stats_e = trainer.stats_view_budgets(state, buf, cfg, rc, True)
    state, n_pruned = trainer.post_process(
        state, buf, 5.0, cfg, rc, True, stats_bucket=trainer.pick_subset_bucket(stats_iv, state.capacity),
        stats_entry_budget=trainer.pick_entry_bucket(stats_e),
    )
    return loss, aux, bucket


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_every_host_wait_of_training_sits_in_a_sync_span(cuda, fused):
    """Under torch's sync debug mode "error", which raises at a call that
    makes the host wait for the device, the training and post-processing
    path raises nothing: every such call sits in a `sync.*` span."""
    # a capacity of 32768 leaves room for the per-view subsets, as on the main path
    cfg = gm.MapConfig(capacity=32768, optimization_steps=2, bilateral_radius=2, fused_view_kernel=fused)
    mapper, _ = tiny_mission(cuda, steps=2, res=64, map_cfg=cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, aux, bucket = _training_calls(mapper)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(loss) and int(aux["num_entries"]) > 0
    assert bucket is not None  # the per-view subsets of the main path


KERNEL_SPAN = {"fwd_kernel": "render.composite_fwd", "bwd_kernel": "render.composite_bwd",
               "tile_order_kernel": "render.composite_bwd", "stats_kernel": "render.composite_stats",
               "tile_rank_kernel": "render.composite_stats"}


@pytest.mark.cuda
def test_compositor_launches_lie_inside_their_spans(cuda):
    """In a profiled stretch of training and post-processing, each launch of
    a compositor kernel (the runtime call that the kernel's correlation id
    names) lies inside a span of its wrapper, `render.composite_*`."""
    mapper, _ = tiny_mission(cuda, steps=2, res=64, map_cfg=gm.MapConfig(capacity=32768, optimization_steps=2))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _training_calls(mapper)
        torch.cuda.synchronize()
    evs = list(prof.profiler.kineto_results.events())
    host = {e.correlation_id(): e for e in evs if e.device_type() != torch.autograd.DeviceType.CUDA}
    spans = {}
    for r in tracing.spans():
        spans.setdefault(r.name, []).append((r.start_ns, r.end_ns))
    seen = {}
    for e in evs:
        m = re.search(r"composite::(\w+_kernel)\b", e.name())
        if e.device_type() != torch.autograd.DeviceType.CUDA or m is None:
            continue
        launch = host.get(e.correlation_id())
        assert launch is not None, f"no runtime launch with correlation id {e.correlation_id()} for {e.name()}"
        t0, t1 = launch.start_ns(), launch.start_ns() + launch.duration_ns()
        want = KERNEL_SPAN[m.group(1)]
        assert any(s <= t0 and t1 <= end for s, end in spans.get(want, [])), (m.group(1), launch.name(), want)
        seen[m.group(1)] = seen.get(m.group(1), 0) + 1
    assert set(seen) == set(KERNEL_SPAN), seen
