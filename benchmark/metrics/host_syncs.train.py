"""Calls that made the host wait for the device, a keyframe: the `sync.*`
spans (`tracing.host_read`: reads of device values, `nonzero`, boolean
masks, `unique`, `bincount`, blocking copies) in the profiled lap, each
call site once a call. A count of events, which the host's load does not
spread."""

from harness import program


def read(ctx):
    return program.read(ctx, program.count, "sync.*")
