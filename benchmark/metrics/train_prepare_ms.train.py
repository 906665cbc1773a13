"""Host milliseconds a keyframe in the trainer's `train.prepare` spans (the
fresh leaves and Adam, `decode_frames`, `prepare_views`: preprocess,
compaction and binning of the batch's views) in the profiled lap: the
program's own spans (`activegs_torch.tracing`), `harness/program.py`."""

from harness import program


def read(ctx):
    return program.read(ctx, program.host_ms, "train.prepare")
