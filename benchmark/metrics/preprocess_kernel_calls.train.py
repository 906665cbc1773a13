"""Preprocess calls a keyframe that ran the forward kernel: the
`render.preprocess_kernel` spans in the profiled lap (`harness/program.py`),
to be read beside the `render.preprocess` calls around them (96 a keyframe
in the train cell: 80 differentiated view renders and 16 no-grad calls for
the frozen bins). On the card every call should reach the kernel; a count
of events, which the host's load does not spread. None for a program
without the preprocess kernel."""

from harness import program

try:
    from activegs_torch.render import preprocess
except ImportError:  # a program without the renderer
    preprocess = None


def read(ctx):
    if not hasattr(preprocess, "preprocess_kernel"):
        return None
    return program.read(ctx, program.count, "render.preprocess_kernel")
