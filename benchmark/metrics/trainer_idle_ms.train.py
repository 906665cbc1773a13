"""Device-idle milliseconds a keyframe inside the trainer's `train.keyframe`
spans: their intervals minus the union of the device operations of the
profiled lap's trace, on the clock both share (`time.time_ns`), so the
idle time that the trainer's host work leaves the device;
`harness/program.py`. None without device operations (a CPU run)."""

from harness import program


def read(ctx):
    return program.read_idle(ctx, "train.keyframe")
