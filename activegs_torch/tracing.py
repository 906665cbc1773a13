"""Spans on the host's wall clock: the mission's billed phase timers and the
trace of where a step's host time goes, from one primitive.

`span(name)` is a context manager that takes `time.time_ns()` at entry and
at exit, whether or not anything records it: `.seconds` is the span's
length once it has closed. `@span(name)` on a function opens a fresh span
around each call. While recording is on, each span is also kept in a
buffer of the newest CAPACITY spans as a `Record`: its number (spans are
numbered in the order they open), the number of the span it opened inside
on the same thread (-1 at the top), its start and its end.
Recording is on inside `recording()`, and while a `torch.profiler` session
records. The profiler stamps its host and device events on the same clock
as `time.time_ns()`, so the spans of a profiled stretch and its device
operations can be laid side by side: an idle gap of the device belongs to
the spans open at its start. A span opened in a backward pass runs on
autograd's thread for the device, so its parent there is -1.

`host_read(site)` is the span `sync.<site>`, placed around each call that
makes the host wait for the device: a read of a device value (`int()`,
`float()`, `.item()`, `.cpu()`), `torch.nonzero`, a boolean mask,
`torch.unique`, `torch.bincount`, or a blocking copy between host and
device (`torch.tensor(..., device=)` too). Inside it, and only there,
torch's CUDA sync debug mode is off, so that a run under
`torch.cuda.set_sync_debug_mode("error")` raises at every synchronising
call that lacks such a span.

`spans(t0_ns, t1_ns)` returns the recorded spans that began and ended in a
window of that clock, in start order; `dropped()` counts the oldest spans
that a full buffer let go since the last `clear()`.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _profiler
from torch import _C

CAPACITY = 65536  # the newest spans the buffer keeps

# torch's sync debug mode, as the C functions that `torch.cuda`'s getter and
# setter call (which would initialise CUDA first); absent from CPU builds
_get_sync_mode = getattr(_C, "_cuda_get_sync_debug_mode", None)
_set_sync_mode = getattr(_C, "_cuda_set_sync_debug_mode", None)


class Record(NamedTuple):
    index: int  # the span's number, in the order spans open
    name: str
    parent: int  # number of the enclosing span on the same thread, -1 for none
    start_ns: int
    end_ns: int  # 0 while the span is open


class _Buffer:
    def __init__(self):
        self.lock = threading.Lock()
        self.rows: collections.deque[list] = collections.deque()  # [index, name, parent, start_ns, end_ns]
        self.opened = 0  # spans recorded so far: the next span's number
        self.dropped = 0
        self.forced = 0  # open recording() contexts
        self.local = threading.local()  # .stack: numbers of this thread's open spans


_BUF = _Buffer()


def is_recording() -> bool:
    return _BUF.forced > 0 or _profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_BUF.local, "stack", None)
    if stack is None:
        stack = _BUF.local.stack = []
    return stack


class span:
    """`with span(name) as s:` times its body; `s.seconds` after it.
    `@span(name)` on a function: a span of its own around each call."""

    __slots__ = ("name", "start_ns", "end_ns", "_row")

    def __init__(self, name: str):
        self.name = name
        self._row = None

    def __enter__(self):
        self.start_ns = time.time_ns()
        if is_recording():
            stack = _stack()
            with _BUF.lock:
                row = [_BUF.opened, self.name, stack[-1] if stack else -1, self.start_ns, 0]
                _BUF.opened += 1
                while len(_BUF.rows) >= CAPACITY:
                    _BUF.rows.popleft()
                    _BUF.dropped += 1
                _BUF.rows.append(row)
            stack.append(row[0])
            self._row = row
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._row is not None:
            self._row[4] = self.end_ns
            _stack().pop()
            self._row = None
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class host_read(span):
    """The span `sync.<site>` around a call that waits for the device, with
    torch's CUDA sync debug mode off inside it."""

    __slots__ = ("_mode",)

    def __init__(self, site: str):
        super().__init__("sync." + site)
        self._mode = 0

    def __enter__(self):
        if _get_sync_mode is not None:
            self._mode = _get_sync_mode()
            if self._mode:
                _set_sync_mode(0)
        return super().__enter__()

    def __exit__(self, *exc) -> bool:
        super().__exit__(*exc)
        if self._mode:
            _set_sync_mode(self._mode)
        return False


@contextlib.contextmanager
def recording():
    """Record spans inside this context, profiler or not."""
    with _BUF.lock:
        _BUF.forced += 1
    try:
        yield
    finally:
        with _BUF.lock:
            _BUF.forced -= 1


def spans(t0_ns: int = 0, t1_ns: int | None = None) -> list[Record]:
    """The recorded spans that began at or after `t0_ns` and ended at or
    before `t1_ns` (None: any closed span), in start order."""
    with _BUF.lock:
        rows = [Record(*r) for r in _BUF.rows]
    return sorted((r for r in rows if r.end_ns and r.start_ns >= t0_ns and (t1_ns is None or r.end_ns <= t1_ns)),
                  key=lambda r: (r.start_ns, r.index))


def dropped() -> int:
    """The oldest spans that a full buffer let go since the last `clear()`."""
    return _BUF.dropped


def clear() -> None:
    """Empty the buffer; span numbers go on from where they were."""
    with _BUF.lock:
        _BUF.rows.clear()
        _BUF.dropped = 0
