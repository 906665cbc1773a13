"""Mapping seconds a mission step: the mean over the window's steps of
`t_mapping`, the mapper's host clock with the device synchronised at each
phase mark (`IncrementalMapper.step`)."""

from harness import readers


def read(ctx):
    return readers.step_mean(ctx, lambda s: s["t_mapping"])
