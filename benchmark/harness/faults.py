"""Faults a cell can have, planted in the timed path underneath the
harness, for the tests (`tests/test_bench_faults.py`) and for the fault
readings on the card (`control.py --fault <name>`): each must turn
`correct` false. `plant(name)` returns a function that takes it out."""

from __future__ import annotations

import torch

from activegs_torch.mapping import trainer
from activegs_torch.planning.planner import PlanBase
from activegs_torch.render import composite as cp


def unchanged():
    """A step that returns its state unchanged: Adam's moments update, the
    leaves do not."""
    make = trainer.make_optimizer

    def frozen(params, cfg):
        opt = make(params, cfg)
        step = opt.step

        def no_step(*a, **k):
            saved = [p.detach().clone() for g in opt.param_groups for p in g["params"]]
            step(*a, **k)
            with torch.no_grad():
                for p, s in zip((p for g in opt.param_groups for p in g["params"]), saved):
                    p.copy_(s)

        opt.step = no_step
        return opt

    return trainer, "make_optimizer", frozen


def half_batch():
    """Half of the view batch left out of the loss, the mean taken over the
    rest."""
    loss_fn = trainer.batch_loss

    def half(params, state, batch, counts, cfg, raster_cfg, bins=None, subsets=None):
        h = max(1, len(counts) // 2)
        loss, err = loss_fn(params, state, tuple(x[:h] for x in batch), counts[:h], cfg, raster_cfg,
                            None if bins is None else bins[:h], None if subsets is None else subsets[:h])
        return loss, torch.cat([err, err.new_zeros(len(counts) - h)])

    return trainer, "batch_loss", half


def altered_choice():
    """The planner's answer altered where it is produced: the view it picks
    by the negated scores."""
    scores = PlanBase.cal_view_scores
    return PlanBase, "cal_view_scores", lambda self, u, lengths: -scores(self, u, lengths)


def altered_tile():
    """A rendered answer altered where it is produced: the first tile's
    colours of every forward composite brightened."""
    fwd = cp.composite_fwd

    def bright(entries, tile_start, tile_len, ntx, cfg, tpv=None):
        out = fwd(entries, tile_start, tile_len, ntx, cfg, tpv).clone()
        out[0, 0:3] = out[0, 0:3] * 1.5 + 0.05
        return out

    return cp, "composite_fwd", bright


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered_choice": altered_choice,
          "altered_tile": altered_tile}


def plant(name: str):
    """Plant fault `name`; returns the function that takes it out."""
    owner, attr, new = FAULTS[name]()
    old = getattr(owner, attr)
    setattr(owner, attr, new)
    return lambda: setattr(owner, attr, old)
