"""What the readers of the program's own spans share (`metrics/train_*_ms`,
`render_ms`, `host_syncs`, `trainer_idle_ms`): the spans that
`activegs_torch.tracing` recorded inside the profiled lap, and the
arithmetic on them.

The program records its spans while a torch.profiler session records, so
the traced lap (`harness/trace.py`) leaves them in its buffer, stamped on
`time.time_ns()`, the clock of the trace's device operations. A reader
takes the spans that began and ended inside the profiled window
(`ctx["trace"]["t0"]`..`["t1"]`) and divides by the keyframes it ran
(`ctx["work"]["units"]`). A name that ends in `.*` selects every span
under that prefix. Time is the union of the selected spans' intervals, so
an instant under nested or overlapping spans counts once. Each reader
returns None where the window holds no span: a program without the tracer,
or a run without the traced lap.
"""

from __future__ import annotations

try:
    from activegs_torch import tracing
except ImportError:  # a program without the tracer
    tracing = None


def window_spans(ctx) -> list:
    """The program's spans inside the profiled window, in start order."""
    tr = ctx.get("trace")
    if tracing is None or not tr:
        return []
    return tracing.spans(tr["t0"], tr["t1"])


def select(spans, name: str) -> list:
    """The spans called `name`, or under its prefix where it ends in `.*`."""
    if name.endswith(".*"):
        return [s for s in spans if s.name.startswith(name[:-1])]
    return [s for s in spans if s.name == name]


def union(intervals) -> list[tuple[int, int]]:
    """The union of (start, end) intervals as disjoint ones, in order."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(disjoint) -> int:
    return sum(e - s for s, e in disjoint)


def overlap(a, b) -> int:
    """The length of the intersection of two lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_ms(spans, name: str, units: int) -> float:
    """Milliseconds a unit under the spans `name`."""
    return length(union((s.start_ns, s.end_ns) for s in select(spans, name))) / 1e6 / units


def count(spans, name: str, units: int) -> float:
    """The spans `name` a unit."""
    return len(select(spans, name)) / units


def idle_ms(spans, ops, name: str, units: int) -> float:
    """Milliseconds a unit under the spans `name` in which no device
    operation ran: their union minus its overlap with the union of the
    operations' (name, start_ns, end_ns) intervals."""
    under = union((s.start_ns, s.end_ns) for s in select(spans, name))
    busy = union((s, e) for _, s, e in ops)
    return (length(under) - overlap(under, busy)) / 1e6 / units


def read(ctx, fn, name: str):
    """fn(spans, name, units) over the profiled window, or None where it
    holds no span."""
    spans = window_spans(ctx)
    units = (ctx.get("work") or {}).get("units")
    if not spans or not units:
        return None
    return fn(spans, name, units)


def read_idle(ctx, name: str):
    """`idle_ms` of the spans `name` over the profiled window, or None where
    it holds no span or no device operation."""
    ops = (ctx.get("trace") or {}).get("ops")
    if not ops:
        return None
    return read(ctx, lambda spans, n, units: idle_ms(spans, ops, n, units), name)
