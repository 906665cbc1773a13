"""Sensing seconds a mission step: the harness's host clock around
`simulator.simulate`, the device synchronised before and after, the mean
over the window's calls."""

from harness import readers


def read(ctx):
    return readers.sensing(ctx)
