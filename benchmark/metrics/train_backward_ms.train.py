"""Host milliseconds a keyframe in the trainer's `train.backward` spans (each
Adam step's `loss.backward()`, the compositor's backward launches among
them) in the profiled lap: the program's own spans, `harness/program.py`."""

from harness import program


def read(ctx):
    return program.read(ctx, program.host_ms, "train.backward")
