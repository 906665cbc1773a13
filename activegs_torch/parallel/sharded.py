"""View sharding over ranks (port of `activegs_tpu/parallel/sharded.py`).

The view axis is split over the ranks of a `torch.distributed` process
group, which takes the place of the reference's device mesh: each rank
renders its contiguous share of a keyframe's training views, or of a plan
step's candidates, with the whole map replicated, and the ranks combine
gradients and per-view results with `all_reduce`. Every rank ends a step
with the same values, so every rank runs the whole mission loop
(`IncrementalMapper` builds the group, `train_keyframe` and the planners
take it).

gloo reduces and broadcasts CUDA tensors but has no `all_gather` for them,
so every gather here is an `all_reduce` of a zero-filled vector in which
each rank writes its own slice: adding zeros is exact.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .. import tracing
from ..mapping import gaussians as gm
from ..render.types import Camera, RasterConfig


@dataclasses.dataclass(frozen=True)
class ViewGroup:
    """The ranks a view axis is split over: the process group (None for the
    default group), this process's rank in it, and its size."""

    group: object
    rank: int
    size: int


def group_size(world: int, batch_size: int) -> int:
    """The largest power of two that is at most `world` and divides
    `batch_size`: the reference's rule for the size of its view mesh."""
    n = 1
    while n * 2 <= world and batch_size % (n * 2) == 0:
        n *= 2
    return n


def make_view_group(n: int | None = None) -> ViewGroup | None:
    """A group of the first `n` ranks (default: all) of the initialized
    default group, or None on a rank outside it. Every rank must call it
    (`new_group` is collective). The ranks of one host are consecutive
    already, so there is no separate hybrid layout to build."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n is None else n
    if not 1 <= n <= world:
        raise ValueError(f"a view group of {n} ranks in a world of {world}")
    pg = None if n == world else dist.new_group(list(range(n)))
    return ViewGroup(pg, rank, n) if rank < n else None


def view_share(v: int, group: ViewGroup) -> range:
    """The contiguous share of `v` views that this rank takes: the first
    v % size ranks take one more than the others, so with fewer views than
    ranks some ranks take none (they still join every collective)."""
    base, extra = divmod(v, group.size)
    lo = group.rank * base + min(group.rank, extra)
    return range(lo, lo + base + (group.rank < extra))


def all_reduce_sum(x: torch.Tensor, group: ViewGroup) -> torch.Tensor:
    """`x` summed over the group's ranks, in place."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group.group)
    return x


def gather_views(local: torch.Tensor, share: range, v: int, group: ViewGroup) -> torch.Tensor:
    """(v, ...) values on every rank, of which this rank holds the rows
    `share` (`local`)."""
    out = torch.zeros((v, *local.shape[1:]), dtype=local.dtype, device=local.device)
    out[share.start : share.stop] = local
    return all_reduce_sum(out, group)


def broadcast_flag(flag: bool, group: ViewGroup, device) -> bool:
    """Rank 0's `flag` on every rank of the group."""
    t = torch.tensor([int(flag) if group.rank == 0 else 0], dtype=torch.int32, device=device)
    return bool(all_reduce_sum(t, group).item())


def sharded_train_step(
    params: dict,
    state: gm.GaussianMapState,
    batch: tuple,
    counts: torch.Tensor,
    group: ViewGroup,
    cfg: gm.MapConfig,
    raster_cfg: RasterConfig,
    bins: list | None = None,
    subsets: list | None = None,
):
    """One loss and gradient over the view batch `batch` (V distinct views,
    drawn `counts` times each), its views split over the group: each rank
    renders its share, scales its part of the loss so that the ranks' parts
    sum to the whole batch's `batch_loss`, and the gradients (one buffer,
    in `PARAM_FIELDS` order) and the loss are summed over the ranks.
    `bins` / `subsets` are per-view lists of which only this rank's share
    is read. Returns (loss, grads {field: tensor}, per_frame (V,)), the
    same on every rank."""
    from ..mapping.trainer import PARAM_FIELDS, batch_loss

    v = counts.shape[0]
    share = view_share(v, group)
    sl = slice(share.start, share.stop)
    leaves = [params[k] for k in PARAM_FIELDS]
    if len(share):
        with tracing.span("train.forward"):
            loss, per_frame = batch_loss(
                params, state, tuple(x[sl] for x in batch), counts[sl], cfg, raster_cfg,
                None if bins is None else bins[sl], None if subsets is None else subsets[sl],
            )
            # batch_loss is the mean over this rank's draws: weigh it by their
            # share of the batch's draws (the reference's loss * n_local / n_total)
            w = counts.to(torch.float32)
            loss = loss * (torch.sum(w[sl]) / torch.sum(w))
    else:
        loss = torch.zeros((), device=state.means.device)
        per_frame = torch.zeros(0, device=state.means.device)
    with tracing.span("train.backward"):
        grads = torch.autograd.grad(loss, leaves) if len(share) else [torch.zeros_like(p) for p in leaves]
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
        loss = all_reduce_sum(loss.detach().reshape(1).clone(), group)[0]
    parts = flat.split([p.numel() for p in leaves])
    grads = {k: g.view_as(p) for k, g, p in zip(PARAM_FIELDS, parts, leaves)}
    return loss, grads, gather_views(per_frame, share, v, group)


@torch.no_grad()
def sharded_view_bins(
    attrs,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    group: ViewGroup,
    shape: tuple[int, int],
    raster_cfg: RasterConfig,
    entry_budget: int | None = None,
) -> list:
    """Frozen bins of this rank's share of the views: a per-view list with
    None at the other ranks' views (no rank needs them, so none are
    gathered)."""
    from ..render.renderer import prepare_view_bins

    share = view_share(extrinsics.shape[0], group)
    return [
        prepare_view_bins(attrs, Camera(extrinsics[i], intrinsics[i]), shape, raster_cfg, entry_budget=entry_budget)
        if i in share else None
        for i in range(extrinsics.shape[0])
    ]


@torch.no_grad()
def sharded_candidate_utility(
    gm_state: gm.GaussianMapState,
    unexplored: torch.Tensor,
    candidates: torch.Tensor,
    intrinsic: torch.Tensor,
    valid_masks: torch.Tensor,
    depth_range: torch.Tensor,
    group: ViewGroup,
    grid,
    shape: tuple[int, int],
    map_cfg: gm.MapConfig,
    raster_cfg: RasterConfig,
    entry_budget: int | None = None,
    explore_only: bool = False,
    subset_bucket: int | None = None,
):
    """Planner candidate utilities with the candidates split over the
    group: padded to a multiple of its size by repeating the last one, each
    rank scores its contiguous share through the single-process path's own
    `planning.confidence._confidence_utility_batch` (so the two cannot
    diverge), NaN -> 0, and the shares are gathered. Returns (explore (N,),
    exploit (N,)), the same on every rank."""
    from ..planning.confidence import _confidence_utility_batch

    n = candidates.shape[0]
    pad = (-n) % group.size
    if pad:
        candidates = torch.cat([candidates, candidates[-1:].expand(pad, -1, -1)])
        valid_masks = torch.cat([valid_masks, valid_masks[-1:].expand(pad, -1, -1)])
    share = view_share(n + pad, group)
    sl = slice(share.start, share.stop)
    explore, exploit = _confidence_utility_batch(
        gm_state, unexplored, candidates[sl], intrinsic, valid_masks[sl], depth_range, grid, shape, map_cfg,
        raster_cfg, entry_budget=entry_budget, explore_only=explore_only, subset_bucket=subset_bucket,
    )
    return tuple(gather_views(x, share, n + pad, group)[:n] for x in (explore, exploit))
