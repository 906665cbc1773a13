"""Training seconds a mission step: the mean over the window's steps of
`phase_times["train"]` (`mapping_step`'s synchronised marks around
`trainer.train_keyframe`)."""

from harness import readers


def read(ctx):
    return readers.step_mean(ctx, lambda s: s["phase_times"]["train"])
