"""Host milliseconds a keyframe under any renderer span (`render.*`: view
renders, bins, preprocess, binning, the compositor calls; each instant
counted once, the union of the outermost ones) in the profiled lap: the
program's own spans, `harness/program.py`."""

from harness import program


def read(ctx):
    return program.read(ctx, program.host_ms, "render.*")
