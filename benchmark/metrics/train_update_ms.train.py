"""Host milliseconds a keyframe in the trainer's `train.update` spans (each
Adam step's `opt.step()`, the sampler's performance update, `zero_grad`) in
the profiled lap: the program's own spans, `harness/program.py`."""

from harness import program


def read(ctx):
    return program.read(ctx, program.host_ms, "train.update")
