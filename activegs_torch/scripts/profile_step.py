"""The bench's train step split into phases (port of `scripts/profile_step.py`,
with the op ledger of `scripts/trace_step.py` and `parse_profile.py`).

    python -m activegs_torch.scripts.profile_step [runs=3] [trace=<dir>]
    BENCH_RES=32 BENCH_GAUSSIANS=512 BENCH_STEPS=1 python -m activegs_torch.scripts.profile_step device=cpu

On the bench's train step (`profiling.bench_step`: the bench scene of
BENCH_RES^2 and BENCH_GAUSSIANS surfels in its capacity bucket, the batch
drawn with key 0, its subset bucket and entry budget), each phase:

- `prep`: the 8 views' subsets and frozen bins (`trainer.prepare_views`,
  once a keyframe);
- `full_step`: one optimization step as `train_keyframe` takes it
  (`batch_loss`, backward, Adam);
- `value_and_grad`: `batch_loss` and its gradients;
- `loss_fwd`: `batch_loss` alone;
- `render_fwd`: the views rendered as `batch_loss` renders them, no loss;
- `render_fwd_bwd`: their gradients for the readout sum(rgb + depth +
  normal) * 1e-6;

gets its host ms (the median of `runs` calls after a warm-up, each fenced
by a synchronize; every phase's before the first trace) and, on the card,
its device busy ms from torch.profiler (`profiling.device_busy`) and the
idle share of its host time. Last, the full step's host ms again, after
the traces (`full_step_after_traces_ms`): what a profiler session costs
the launches that follow it in the process. The derived lines are the
reference's differences, of host ms and of device busy ms alike:
`loss_pipeline_fwd` = loss_fwd - render_fwd, `loss_pipeline_fwd_bwd` =
value_and_grad - render_fwd_bwd, `adam` = full_step - value_and_grad (the
optimizer's step and zeroing, and `backward` against `autograd.grad`),
`render_bwd` = render_fwd_bwd - render_fwd.

`trace=<dir>` writes the full step's Chrome trace to
`<dir>/full_step.json` and prints its TOP device operations by self time
(their summed device ms and share of the busy time). Runs on the card
unless given `device=cpu` (device figures then "not measured"). Ends with
one JSON line: the full step's host ms (`value`), each phase's and each
derived figure.
"""

from __future__ import annotations

import dataclasses
import os
import statistics

import torch

from ..mapping import gaussians as gm
from ..mapping import trainer
from ..render.renderer import pack_attrs, render_view, subset_view
from ..render.types import Camera
from . import profiling

TOP = 15  # the op ledger's rows
DERIVED = {
    "loss_pipeline_fwd": ("loss_fwd", "render_fwd"),
    "loss_pipeline_fwd_bwd": ("value_and_grad", "render_fwd_bwd"),
    "adam": ("full_step", "value_and_grad"),
    "render_bwd": ("render_fwd_bwd", "render_fwd"),
}


def phases(st: profiling.BenchStep) -> dict:
    """{phase: call} on the bench step `st`."""
    cfg, rcfg, state = st.cfg, st.raster_cfg, st.state
    params = {k: getattr(state, k).detach().clone().requires_grad_(True) for k in trainer.PARAM_FIELDS}
    opt = trainer.make_optimizer(params, cfg)
    shape = tuple(st.batch[0].shape[-2:])
    cams = [Camera(extrinsic=st.batch[2][i], intrinsic=st.batch[3][i]) for i in range(len(st.ids))]
    background = torch.tensor(cfg.background, dtype=torch.float32, device=state.means.device)

    def loss():
        return trainer.batch_loss(params, state, st.batch, st.counts, cfg, rcfg, st.bins, st.subsets)[0]

    def full_step():
        opt.zero_grad(set_to_none=True)
        loss().backward()
        opt.step()

    def render():
        attrs = gm.attrs_of(dataclasses.replace(state, **params), cfg)
        packed = pack_attrs(attrs) if st.subsets is not None else None
        outs = [render_view(attrs if st.subsets is None else subset_view(packed, st.subsets[i]), cam, shape, rcfg,
                            background=background, bin_result=st.bins[i])[0] for i, cam in enumerate(cams)]
        return sum(torch.sum(o.rgb) + torch.sum(o.depth) + torch.sum(o.normal) for o in outs) * 1e-6

    leaves = list(params.values())
    return {
        "prep": lambda: trainer.prepare_views(state, st.batch, cfg, rcfg, st.subset_bucket, st.entry_budget),
        "full_step": full_step,
        "value_and_grad": lambda: torch.autograd.grad(loss(), leaves),
        "loss_fwd": torch.no_grad()(loss),
        "render_fwd": torch.no_grad()(render),
        "render_fwd_bwd": lambda: torch.autograd.grad(render(), leaves),
    }


def derived(recs: dict) -> dict:
    """The reference's derived lines: host ms and device busy ms (None on
    the CPU) of each difference of two phases."""
    out = {}
    for name, (a, b) in DERIVED.items():
        dev = None
        if recs[a]["device_busy_ms"] is not None:
            dev = recs[a]["device_busy_ms"] - recs[b]["device_busy_ms"]
        out[name] = {"host_ms": recs[a]["host_ms"] - recs[b]["host_ms"], "device_busy_ms": dev}
    return out


def main(argv: list[str] | None = None) -> dict:
    args, _, device = profiling.parse(argv)
    res, n_gauss, steps = profiling.bench_shape()
    runs = int(args.get("runs", 3))
    trace_dir = args.get("trace")
    st = profiling.bench_step(res, n_gauss, steps, device)
    print(f"capacity bucket {st.capacity_bucket}, subset bucket {st.subset_bucket}, entry budget "
          f"{st.entry_budget}, distinct views {len(st.ids)}")
    fns = phases(st)
    recs = profiling.timed(fns, device, runs,
                           {"full_step": os.path.join(trace_dir, "full_step.json")} if trace_dir else None)
    for name, rec in recs.items():
        print(f"{name + ':':16s}host {rec['host_ms']:9.2f} ms/step; {profiling.fmt_device(rec)}")
    # the same step again after the traces: what a profiler session leaves behind
    after = profiling.host_ms(fns["full_step"], device, runs)
    after_ms = statistics.median(after)
    print(f"full_step again after the traces: host {after_ms:9.2f} ms/step (runs "
          + " ".join(f"{t:.2f}" for t in after) + ")")
    print("---- derived ----")
    der = derived(recs)
    for name, d in der.items():
        dev = "not measured" if d["device_busy_ms"] is None else f"{d['device_busy_ms']:.3f} ms"
        print(f"{name + ':':24s}host {d['host_ms']:9.2f} ms/step; device busy {dev}")
    ledger = None
    full = recs["full_step"]
    if trace_dir:
        if full["device_busy_ms"] is None:
            print("op ledger: not measured (CPU run: no device operations)")
        else:
            ledger = [{"name": k[:120], "ms": t, "share": t / full["device_busy_ms"]}
                      for k, t in list(full["by_name"].items())[:TOP]]
            print(f"op ledger, full step ({os.path.join(trace_dir, 'full_step.json')}), top {TOP} device operations "
                  f"by self time:")
            for row in ledger:
                print(f"  {row['ms']:9.3f} ms  {100 * row['share']:5.1f}%  {row['name']}")
    for rec in recs.values():
        rec.pop("by_name", None)
    return profiling.emit({
        "metric": "train_step_host_ms",
        "value": full["host_ms"],
        "unit": "ms/step",
        "phases": recs,
        "derived": der,
        "full_step_after_traces_ms": after_ms,
        "op_ledger": ledger,
        "subset_bucket": st.subset_bucket, "entry_budget": st.entry_budget, "distinct_views": len(st.ids),
        "res": res, "gaussians": n_gauss,
        "device": profiling.card() if device.type == "cuda" else "cpu",
    })


if __name__ == "__main__":
    main()
