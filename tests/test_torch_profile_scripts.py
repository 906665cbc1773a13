"""The port's profiling scripts on the CPU (`activegs_torch/scripts/`:
`tile_scan`, `kernel_overhead`, `profile_bwd`, `profile_step`,
`profile_planner`, `profile_mission_train`, and `bench scaling=1`), each
run through its `main` with `device=cpu` at BENCH_RES=32,
BENCH_GAUSSIANS=512, BENCH_STEPS=1: each prints its lines and ends with
its JSON line on stdout, and what each line says holds:

- `tile_scan` gives the reference's four default configs a row each, none
  with `error`, and an `error` row for a tile the kernels do not take;
- `kernel_overhead`'s empty tiles composite to transmittance 1 and zeros;
- `profile_step`'s derived lines are the differences of its phases;
- `bench scaling=1` at 1 and 2 gloo ranks gives summed sharded gradients
  within 1e-5 scaled of the single process's, and the reference's keys;
- each script refuses `device=cuda` (and no `device=`) where no card is
  present;
- `profiling.device_busy` takes a trace again while it records fewer
  device operations than were launched (a stand-in profiler here).

The CPU runs time the plain versions, so no figure here is a device
figure: every device busy time reads None.
"""

import json
import types

import pytest
import torch
from torch.autograd import DeviceType

from activegs_torch.scripts import bench as tbench
from activegs_torch.scripts import kernel_overhead, profile_bwd, profile_mission_train, profile_planner
from activegs_torch.scripts import profile_step, profiling, tile_scan

torch.set_num_threads(2)


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setenv("BENCH_RES", "32")
    monkeypatch.setenv("BENCH_GAUSSIANS", "512")
    monkeypatch.setenv("BENCH_STEPS", "1")


def last_line(capsys, line):
    """The script's stdout ends with its JSON line, the returned one."""
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == json.loads(json.dumps(line))
    return out


def test_tile_scan_on_the_cpu(small, capsys):
    line = tile_scan.main(["device=cpu"])
    out = last_line(capsys, line)
    rows = [json.loads(r) for r in out[:-1]]
    assert rows == line["rows"] and len(rows) == 4 and line["errors"] == 0
    assert [r["tile"] for r in rows] == [[32, 32], [16, 32], [16, 16], [8, 16]]
    keys = {"tile", "chunk", "max_dup", "subset_bucket", "rays_per_s", "ms_per_step", "num_dropped", "loss", "runs_s",
            "build_s"}
    for r in rows:
        assert set(r) == keys and r["rays_per_s"] > 0 and r["num_dropped"] == 0
        assert len(r["runs_s"]) == len(tile_scan.TIMED_KEYS) and r["ms_per_step"] == pytest.approx(1e3 * min(r["runs_s"]))
    # one scene, one batch: every tile shape trains to the same loss up to rounding
    assert max(r["loss"] for r in rows) == pytest.approx(min(r["loss"] for r in rows), rel=1e-5)
    assert line["value"] == max(r["rays_per_s"] for r in rows) and line["device"] == "cpu"

    line = tile_scan.main(["device=cpu", "[[17, 32, 128, 4], [32, 64, 128, 4]]"])
    assert line["errors"] == 2 and line["value"] is None
    assert all("ValueError" in r["error"] for r in line["rows"])


def test_kernel_overhead_on_the_cpu(small, capsys):
    line = kernel_overhead.main(["device=cpu"])
    out = last_line(capsys, line)
    assert out[0].startswith(f"tiles={line['num_tiles']} entries=(24, ")
    assert line["empty_trans_min"] == line["empty_trans_max"] == 1.0 and line["empty_rows_abs_max"] == 0.0
    assert line["num_tiles"] == 2 and line["real_entries"] > 0 and line["iters"] == 20
    assert line["value"] == pytest.approx(line["fwd_empty_ms"] / line["num_tiles"] * 1e3)
    assert line["timing"].startswith("host clock (CPU)")


def test_profile_bwd_on_the_cpu(small, capsys):
    line = profile_bwd.main(["device=cpu"])
    out = last_line(capsys, line)
    assert set(line["components"]) == set(profile_bwd.LABELS)
    assert all(t["fwd"] > 0 and t["fwd_bwd"] > 0 for t in line["components"].values())
    assert len(out) == 2 + 2 * len(profile_bwd.LABELS) and line["subset_bucket"] == 8192


def test_profile_step_derived_lines_are_differences(small, capsys):
    line = profile_step.main(["device=cpu", "runs=1"])
    last_line(capsys, line)
    ph = line["phases"]
    assert set(ph) == {"prep", "full_step", "value_and_grad", "loss_fwd", "render_fwd", "render_fwd_bwd"}
    for name, (a, b) in profile_step.DERIVED.items():
        assert line["derived"][name]["host_ms"] == ph[a]["host_ms"] - ph[b]["host_ms"]
        assert line["derived"][name]["device_busy_ms"] is None
    assert all(p["device_busy_ms"] is None and p["host_ms"] > 0 for p in ph.values())
    assert line["value"] == ph["full_step"]["host_ms"] and line["op_ledger"] is None
    assert line["full_step_after_traces_ms"] > 0


def test_profile_planner_on_the_cpu(small, capsys):
    line = profile_planner.main(["device=cpu", "cands=3", "runs=1"])
    last_line(capsys, line)
    assert set(line["timings"]) == set(profile_planner.LABELS)
    assert line["candidates"] == 3 and line["shape"] == [8, 8] and line["entry_budget"] >= line["max_entries"]
    assert all(t["device_busy_ms"] is None and t["host_ms"] > 0 for t in line["timings"].values())


def test_profile_mission_train_on_the_cpu(small, capsys):
    line = profile_mission_train.main(["device=cpu"])
    out = last_line(capsys, line)
    small_buf, big_buf = line["buffers"]["kf_cap=8"], line["buffers"]["kf_cap=256"]
    assert out[0].startswith("kf_cap=8: subset=") and out[1].startswith("kf_cap=256: subset=")
    assert big_buf["buffer_bytes"] == 32 * small_buf["buffer_bytes"]
    assert line["value"] == pytest.approx(big_buf["train_ms"] / small_buf["train_ms"])


def test_bench_scaling_matches_the_single_process(small, capsys):
    """Two gloo ranks, each rendering half the 8 views: the summed
    gradients within 1e-5 scaled of one process's, the loss within 1e-6."""
    rec = tbench.main(["scaling=1", "device=cpu", "ranks=1,2"])
    out = capsys.readouterr().out.strip().splitlines()
    lines = [json.loads(x) for x in out]
    assert lines[-1] == json.loads(json.dumps(rec["summary"])) and lines[:-1] == json.loads(json.dumps(rec["lines"]))
    keys = {"metric", "mesh_devices", "value", "unit", "efficiency_vs_1dev", "backend"}
    for line, n in zip(rec["lines"], (1, 2)):
        assert keys <= set(line) and line["metric"] == "scaling_train_rays_per_s"
        assert line["mesh_devices"] == n and line["backend"] == "gloo" and line["value"] > 0
        assert line["grad_max_scaled_err"] <= 1e-5, n
        assert line["loss"] == pytest.approx(line["loss_single"], rel=1e-6)
    assert rec["lines"][0]["efficiency_vs_1dev"] == 1.0


SCRIPTS = {
    "tile_scan": tile_scan.main, "kernel_overhead": kernel_overhead.main, "profile_bwd": profile_bwd.main,
    "profile_step": profile_step.main, "profile_planner": profile_planner.main,
    "profile_mission_train": profile_mission_train.main,
    "bench_scaling": lambda argv: tbench.main(["scaling=1", *argv]),
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_scripts_need_a_card_unless_told_cpu(monkeypatch, script):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["device=cuda"]):
        with pytest.raises(RuntimeError, match="device=cpu"):
            SCRIPTS[script](argv)


@pytest.mark.parametrize("recorded", [[3, 5], [5], [4] * profiling.TRACES])
def test_device_busy_retakes_a_lossy_trace(monkeypatch, recorded):
    """Traces recording `recorded[i]` of 5 launched operations in turn: the
    first complete one is kept, or the last of TRACES lossy ones, and its
    busy time is the union of the recorded intervals."""
    traces = iter(recorded)

    def event(device_type, name, start, end):
        return types.SimpleNamespace(device_type=device_type, name=name, is_user_annotation=False,
                                     time_range=types.SimpleNamespace(start=start, end=end))

    class Profile:
        def __init__(self, activities):
            n = next(traces)
            launches = [event(DeviceType.CPU, "cudaLaunchKernel", 10 * i, 10 * i + 1) for i in range(5)]
            # kernels of 1000 us each, the second overlapping the first by half
            ops = [event(DeviceType.CUDA, f"k{i % 2}", 500 * i, 500 * i + 1000) for i in range(n)]
            self._events = [event(DeviceType.CPU, "cudaStreamSynchronize", 0, 1), *launches, *ops]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return self._events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(profiling, "PAD_S", 0.0)
    calls = []
    rec = profiling.device_busy(lambda: calls.append(1), "cuda")
    n = next((i + 1 for i, r in enumerate(recorded) if r == 5), profiling.TRACES)
    assert rec["traces"] == n == len(calls) and rec["launched"] == 5 and rec["device_ops"] == recorded[n - 1]
    assert rec["busy_ms"] == pytest.approx((500 * (recorded[n - 1] - 1) + 1000) / 1e3)
    assert sum(rec["by_name"].values()) == pytest.approx(recorded[n - 1])
