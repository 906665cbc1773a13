"""View losses a keyframe that ran the loss's forward kernel: the
`train.view_loss_kernel` spans in the profiled lap (`harness/program.py`),
one a view and a step (80 a keyframe in the train cell: 8 views x 10
steps). On the card every view's loss should reach the kernel; a count of
events, which the host's load does not spread. None for a program
without the view-loss kernel."""

from harness import program

try:
    from activegs_torch.mapping import view_loss
except ImportError:  # a program without the view-loss kernel
    view_loss = None


def read(ctx):
    if not hasattr(view_loss, "view_loss_kernel"):
        return None
    return program.read(ctx, program.count, "train.view_loss_kernel")
