"""The window's share of the chip's FP32 peak, in %: the operations that
the compositor calls' inputs needed (forward and backward live pairs,
`harness/roofline.py`) a unit of work, counted in the profiled stretch,
times the window's units, over the window's wall seconds (host clock, the
window before the profiler) times 67 TFLOP/s."""

from harness import readers


def read(ctx):
    return readers.step_mfu(ctx)
