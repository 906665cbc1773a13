"""The readers of the program's own spans (`harness/program.py` and its seven
metrics): their arithmetic on made-up spans and device intervals, and a
traced run of the train cell at a tiny size on the CPU, with the program's
recording on and off."""

import pytest
import torch

import run
from activegs_torch import tracing
from harness import program

SPAN_METRICS = ["train_prepare_ms.train", "train_forward_ms.train", "train_backward_ms.train",
                "train_update_ms.train", "render_ms.train", "host_syncs.train"]
MS = 1_000_000


def spans(*rows):
    """Records from (name, start_ms, end_ms) rows, parents left out."""
    return [tracing.Record(i, n, -1, s * MS, e * MS) for i, (n, s, e) in enumerate(rows)]


KEYFRAMES = spans(
    ("train.keyframe", 0, 100), ("train.prepare", 0, 20), ("render.bins", 2, 18), ("render.preprocess", 3, 6),
    ("sync.bin_entries.nonzero", 7, 8), ("train.forward", 20, 50), ("render.view", 21, 40),
    ("render.composite_fwd", 30, 35), ("sync.batch_loss.background", 20, 21), ("train.backward", 50, 80),
    ("render.composite_bwd", 60, 70), ("train.update", 80, 99),
    ("train.keyframe", 200, 260), ("train.prepare", 200, 210), ("train.forward", 210, 230),
    ("render.view", 211, 229), ("train.backward", 230, 250), ("render.composite_bwd", 235, 255),
    ("train.update", 250, 260), ("sync.batch_views.unique", 262, 263),
)


@pytest.mark.parametrize("name,want", [
    ("train.prepare", (20 + 10) / 2), ("train.forward", (30 + 20) / 2), ("train.backward", (30 + 20) / 2),
    ("train.update", (19 + 10) / 2), ("train.keyframe", (100 + 60) / 2),
])
def test_phase_ms_sums_each_phase(name, want):
    assert program.host_ms(KEYFRAMES, name, 2) == pytest.approx(want)


def test_render_ms_counts_each_instant_once():
    """Nested renderer spans count once (render.preprocess inside
    render.bins), and so do overlapping ones on two threads (the backward's
    render.composite_bwd past the end of render.view's neighbour)."""
    # 2-18, 21-40, 60-70, 211-229, 235-255
    assert program.host_ms(KEYFRAMES, "render.*", 2) == pytest.approx((16 + 19 + 10 + 18 + 20) / 2)
    assert program.union([(5, 9), (1, 3), (2, 4), (9, 12), (20, 20)]) == [(1, 4), (5, 12)]


def test_sync_count():
    assert program.count(KEYFRAMES, "sync.*", 2) == 1.5
    assert program.count(KEYFRAMES, "sync.batch_views.unique", 1) == 1


def test_idle_inside_spans_with_ops_that_overlap_and_straddle():
    """Device operations that overlap each other count once, and one that
    straddles a span's edge is cut at it; time outside every span is not
    counted, however idle."""
    ops = [("a", 10 * MS, 30 * MS), ("b", 20 * MS, 40 * MS),  # overlap: busy 10-40
           ("c", 90 * MS, 110 * MS),  # straddles the first keyframe's end
           ("d", 150 * MS, 205 * MS),  # straddles the second one's start
           ("e", 300 * MS, 400 * MS)]  # outside both
    # first keyframe 0-100: busy 10-40 and 90-100, idle 60; second 200-260: busy 200-205, idle 55
    assert program.idle_ms(KEYFRAMES, ops, "train.keyframe", 1) == pytest.approx(115.0)
    assert program.idle_ms(KEYFRAMES, [], "train.keyframe", 2) == pytest.approx(80.0)
    assert program.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10


def test_readers_need_spans_and_units():
    ctx = {"trace": {"t0": 0, "t1": 10**18, "ops": []}, "work": {"units": 3}}
    tracing.clear()
    assert program.read(ctx, program.host_ms, "train.prepare") is None
    assert program.read({"trace": None, "work": None}, program.count, "sync.*") is None
    assert program.read_idle(ctx, "train.keyframe") is None


TINY = {"simulator.sensor.resolution": [32, 32], "mapper.gaussian_map.capacity": 4096,
        "traffic.surfels": 1500, "traffic.keyframes": 4}


@pytest.fixture
def cpu_run(monkeypatch):
    """run.run of the train cell with --trace 1 at a tiny size on the CPU;
    the generator's synchronise, meant for the card, does nothing here."""
    torch.set_num_threads(4)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    tracing.clear()
    yield lambda: run.run("train-bench-200k", 2**31 + 4321, 0.01, True, device="cpu", overrides=dict(TINY))
    tracing.clear()


def test_traced_run_reports_the_span_metrics(cpu_run):
    with tracing.recording():
        out = cpu_run()
    m = out["metrics"]
    assert out["correct"] is True, out["checks"]
    for name in SPAN_METRICS:
        assert name in m and m[name]["value"] > 0, (name, m.get(name))
    assert "trainer_idle_ms.train" not in m  # no device operations on the CPU
    assert m["host_syncs.train"]["value"] == int(m["host_syncs.train"]["value"])
    assert m["host_syncs.train"]["unit"] == "syncs" and m["render_ms.train"]["unit"] == "ms"
    phases = sum(m[f"train_{p}_ms.train"]["value"] for p in ("prepare", "forward", "backward", "update"))
    assert m["render_ms.train"]["value"] < phases


def test_untraced_program_reports_none_of_them(cpu_run):
    out = cpu_run()
    assert not set(out["metrics"]) & set(SPAN_METRICS + ["trainer_idle_ms.train"])
