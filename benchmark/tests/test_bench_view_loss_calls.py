"""The reader of `view_loss_kernel_calls.train`: its count on made-up spans,
its silence for a program without the view-loss kernel, and a traced and an
untraced run of the train cell at a tiny size on the CPU."""

import pytest
import torch

import run
from activegs_torch import tracing
from activegs_torch.mapping import view_loss
from harness import cells, program

METRIC = "view_loss_kernel_calls.train"
MS = 1_000_000
TINY = {"simulator.sensor.resolution": [32, 32], "mapper.gaussian_map.capacity": 4096,
        "traffic.surfels": 1500, "traffic.keyframes": 4}


def spans(*rows):
    """Records from (name, start_ms, end_ms) rows, parents left out."""
    return [tracing.Record(i, n, -1, s * MS, e * MS) for i, (n, s, e) in enumerate(rows)]


def test_counts_the_kernel_spans(monkeypatch):
    """Two views' losses reached the forward kernel in one keyframe, one
    more in the other; the backward's spans and a span outside the window
    are not counted; a program without the view-loss kernel reads
    nothing."""
    read = cells.metric_reader(METRIC)
    rows = spans(("train.keyframe", 0, 100), ("train.view_loss_kernel", 3, 4), ("train.view_loss_kernel", 5, 6),
                 ("train.view_loss_bwd", 50, 51), ("train.keyframe", 100, 200), ("train.view_loss_kernel", 103, 104),
                 ("train.view_loss_kernel", 250, 251))
    monkeypatch.setattr(tracing, "spans", lambda t0=0, t1=None: [r for r in rows if t1 is None or r.end_ns <= t1])
    ctx = {"trace": {"t0": 0, "t1": 200 * MS, "ops": []}, "work": {"units": 2}}
    assert read(ctx) == 1.5
    assert program.read(ctx, program.count, "train.view_loss_bwd") == 0.5
    monkeypatch.delattr(view_loss, "view_loss_kernel")
    assert read(ctx) is None


@pytest.fixture
def cpu_run(monkeypatch):
    """run.run of the train cell at a tiny size on the CPU; the generator's
    synchronise, meant for the card, does nothing here."""
    torch.set_num_threads(4)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    tracing.clear()
    yield lambda trace: run.run("train-bench-200k", 2**31 + 8765, 0.01, trace, device="cpu", overrides=dict(TINY))
    tracing.clear()


def test_traced_run_reads_no_kernel_on_the_cpu(cpu_run):
    """On the CPU the loss runs its plain formula: the traced line carries
    the metric, at 0 calls."""
    with tracing.recording():
        out = cpu_run(True)
    assert out["correct"] is True, out["checks"]
    assert out["metrics"][METRIC]["value"] == 0
    assert out["metrics"][METRIC]["unit"] == "calls"


def test_untraced_run_leaves_it_out(cpu_run):
    assert METRIC not in cpu_run(False)["metrics"]
