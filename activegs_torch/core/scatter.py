"""Sums by index in a fixed order, and the row gather whose adjoint uses
them.

`index_add_` on the card adds with atomics in an order that changes from run
to run, so two runs of the same training step end a few ulps apart and the
prune decisions at the opacity threshold, and later the planner's choice of
view, drift apart. `scatter_sum` adds in one order on every run and device:
a stable sort of the target ids, then a segmented sum that walks each
target's values in the order they come. The segmented sum gives each
target one thread, so a long run of one id would serialise: the entries a
caller masks out (the pad entries of an entry budget, say) are dropped by
spreading them over PAD_ROWS scratch targets instead of one.
"""

from __future__ import annotations

import torch

PAD_ROWS = 1024


def scatter_sum(values: torch.Tensor, index: torch.Tensor, n: int, valid: torch.Tensor | None = None) -> torch.Tensor:
    """out[i] = sum of values[j] over index[j] == i (and valid[j]), for i in
    [0, n); index (M,) int64 in [0, n) where valid, values (M, ...).
    Deterministic, and it does not wait for the device (the segment offsets
    come from searchsorted: bincount would read its size back to the host)."""
    m = n
    if valid is not None:
        m = n + PAD_ROWS
        spread = n + torch.arange(index.shape[0], device=index.device) % PAD_ROWS
        index = torch.where(valid, index, spread)
    ids, order = torch.sort(index, stable=True)
    offsets = torch.searchsorted(ids, torch.arange(m + 1, device=index.device))
    return torch.segment_reduce(values[order], "sum", offsets=offsets, unsafe=True)[:n]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, index, valid):
        ctx.save_for_backward(index, valid)
        ctx.n = src.shape[0]
        return torch.where(valid[:, None], src.index_select(0, index), 0.0)

    @staticmethod
    def backward(ctx, grad):
        index, valid = ctx.saved_tensors
        return scatter_sum(grad, index, ctx.n, valid), None, None


def gather_rows(src: torch.Tensor, index: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(M, C) rows src[index] where `valid`, zero rows elsewhere (index int64
    in [0, len(src)) everywhere), with the adjoint summed by `scatter_sum`."""
    return _GatherRows.apply(src, index, valid)
