"""The forward compositor kernel's share of its roofline, in %, over its
launches in the profiled window: the least time of the work its inputs
needed (`harness/roofline.py`) over its device time in the trace."""

from harness import readers


def read(ctx):
    return readers.roofline_share(ctx, "fwd")
