"""A torch.profiler session over the traced laps (CUDA activity only) and
what the harness reads from it: the device's busy seconds as the union of
the device operations' intervals inside the traced window, each kernel's
device time by launch, the operations that took most time, and the longest
idle gaps, each labelled by the innermost harness span open at its start.

On the card's machine a short trace loses its first device operations, so
the session is padded by PAD_S of idle on each side (the arithmetic of the
port's `scripts/profiling.py`), and it records how many device operations
it kept against the runtime calls that launched one.
"""

from __future__ import annotations

import re
import time

import torch

PAD_S = 2.5
NAME_CHARS = 120  # of an operation's name in the breakdown


def _events(prof):
    """[(name, is_device, start_ns, end_ns)] of the session, read from the
    raw kineto events (a million of them take seconds this way, where
    `prof.events()` builds a tree), on the host's wall clock."""
    return [(e.name(), e.device_type() == torch.autograd.DeviceType.CUDA, e.start_ns(),
             e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()]


def session(fn, device) -> dict:
    """Run `fn()` (which returns its host spans, [(name, start_ns,
    end_ns)], on `time.time_ns`) inside a padded profiler session. Returns
    {"window_s", "busy_s", "ops" [(name, start_ns, end_ns)] in start order,
    "launched", "spans", "t0", "t1"}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        t0 = time.time_ns()
        spans = fn()
        torch.cuda.synchronize(device)
        t1 = time.time_ns()
        time.sleep(PAD_S)
    evs = _events(prof)
    ops = sorted(((n, s, e) for n, dev, s, e in evs if dev and e > s), key=lambda x: x[1])
    launched = sum(1 for n, dev, _, _ in evs if not dev and re.search(r"LaunchKernel|Memcpy|Memset", n))
    busy, end = 0, None
    for _, s, e in ops:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if end is None or s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return {"window_s": (t1 - t0) / 1e9, "busy_s": busy / 1e9, "ops": ops, "launched": launched,
            "spans": spans, "t0": t0, "t1": t1}


def kernel_times(tr: dict, pattern: str) -> list[float]:
    """Device seconds of each recorded launch of the kernels whose name
    matches `pattern`, in launch order."""
    rx = re.compile(pattern)
    return [(e - s) / 1e9 for n, s, e in tr["ops"] if rx.search(n)]


def breakdown(tr: dict, top: int = 10) -> dict:
    """{"device_ops": the `top` operation names by summed device seconds,
    "idle_gaps": the `top` longest gaps between device operations inside
    the window, each named by the innermost span open at its start}."""
    by_name: dict[str, int] = {}
    for n, s, e in tr["ops"]:
        by_name[n] = by_name.get(n, 0) + (e - s)
    dev = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], tr["t0"]
    for _, s, e in tr["ops"]:
        if s > end:
            gaps.append((s - end, end))
        end = max(end, e)
    if tr["t1"] > end:
        gaps.append((tr["t1"] - end, end))
    gaps.sort(reverse=True)

    def label(t):
        best = None
        for name, s, e in tr["spans"]:
            if s <= t < e and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else "harness"

    return {"device_ops": [[n[:NAME_CHARS], ns / 1e9] for n, ns in dev],
            "idle_gaps": [[label(t), g / 1e9] for g, t in gaps[:top]]}
