"""The share of the profiled window in which no operation ran on the
device, in %: 1 - busy / window, busy the union of the device
operations' intervals in the trace."""

from harness import readers


def read(ctx):
    return readers.idle_share(ctx)
