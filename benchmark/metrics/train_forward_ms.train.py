"""Host milliseconds a keyframe in the trainer's `train.forward` spans (each
Adam step's `batch_loss`: the views' renders and the four-term loss) in the
profiled lap: the program's own spans, `harness/program.py`."""

from harness import program


def read(ctx):
    return program.read(ctx, program.host_ms, "train.forward")
