"""The render's components at the bench's shapes, forward and forward plus
backward (port of `scripts/profile_bwd.py`).

    python -m activegs_torch.scripts.profile_bwd
    BENCH_RES=32 BENCH_GAUSSIANS=512 BENCH_STEPS=1 python -m activegs_torch.scripts.profile_bwd device=cpu

On the first view of the bench's train step (`profiling.bench_step`: the
bench scene in its capacity bucket, the batch drawn with key 0, its subset
bucket and entry budget, the view's frozen bins on its compacted subset),
times each component of the training render, forward (`fwd`) and forward
plus the gradient of a readout (`fwd_bwd`):

- `kernel`: the compositor (`composite.composite`) on the view's entry
  stream, readout sum(out[:, :9]);
- `entry_gather`: `renderer.gather_entries` of the preprocessed subset
  (params2d (B, 24) -> (24, E)), readout the sum of squares (so the
  cotangent depends on the input);
- `subset`: `core.scatter.gather_rows` of the packed map (N, 16) -> (B,
  16), what `renderer.subset_view` gathers, the sum of squares;
- `subset_preprocess`: `subset_view` then `preprocess.preprocess`, the sum
  of squares of params2d;
- `render_view`: the view rendered from the packed map through its subset
  and frozen bins with the map's background, readout sum(rgb + depth +
  normal);
- `gather_kernel_image`: params2d -> gather -> compositor -> image,
  readout the image's first 9 rows.

Each readout is scaled by 1e-6 (1e-3 for the kernel's rows). Times: ms a
view, CUDA events around each call, the median of ITERS = 20 after a warm-up
(the reference subtracted the TPU's dispatch). Runs on the card unless
given `device=cpu` (the host clock). Prints the reference's lines and ends
with one JSON line: render_view's fwd_bwd ms (`value`) and every
component's two times.
"""

from __future__ import annotations

import torch

from ..core.scatter import gather_rows
from ..mapping import gaussians as gm
from ..render import binning
from ..render import composite as cp
from ..render import preprocess as pp
from ..render.renderer import gather_entries, pack_attrs, render_view, subset_view, tiles_to_image
from ..render.types import O_TRANS, Camera
from . import probe, profiling

ITERS = 20


def components(st: profiling.BenchStep) -> dict:
    """{component: (forward call, forward + backward call)} on the first
    view of the bench step `st`."""
    rcfg, shape = st.raster_cfg, tuple(st.batch[0].shape[-2:])
    cam = Camera(extrinsic=st.batch[2][0], intrinsic=st.batch[3][0])
    bins, subset = st.bins[0], st.subsets[0] if st.subsets is not None else None
    if subset is None:
        raise ValueError("profile_bwd times the subset path: the bench step picked no subset bucket")
    sel, selv, _ = subset
    packed0 = pack_attrs(gm.attrs_of(st.state, st.cfg)).detach()
    with torch.no_grad():
        p2d0 = pp.preprocess(subset_view(packed0, subset), cam, shape, rcfg)[0]
        ent0 = gather_entries(p2d0, bins.gid)
    _, _, ntx, _ = binning.bin_tile_dims(shape, rcfg)
    ts, tl = bins.tile_start, bins.tile_len
    background = torch.tensor(st.cfg.background, dtype=torch.float32, device=packed0.device)

    def grad(readout, x):
        x = x.detach().requires_grad_(True)
        return torch.autograd.grad(readout(x), x)[0]

    def sq(y):
        return torch.sum(y * y) * 1e-6

    def render(x):
        o, _ = render_view(subset_view(x, subset), cam, shape, rcfg, background=background, bin_result=bins)
        return o

    def pipeline(x):
        out = cp.composite(gather_entries(x, bins.gid), ts, tl, ntx, rcfg)
        return tiles_to_image(out[:, : O_TRANS + 1], shape, rcfg)

    no_grad = torch.no_grad()
    return {
        "kernel": (lambda: cp.composite_fwd(ent0, ts, tl, ntx, rcfg),
                   lambda: grad(lambda x: torch.sum(cp.composite(x, ts, tl, ntx, rcfg)[:, :9]) * 1e-3, ent0)),
        "entry_gather": (no_grad(lambda: gather_entries(p2d0, bins.gid)),
                         lambda: grad(lambda x: sq(gather_entries(x, bins.gid)), p2d0)),
        "subset": (no_grad(lambda: gather_rows(packed0, sel, selv)),
                   lambda: grad(lambda x: sq(gather_rows(x, sel, selv)), packed0)),
        "subset_preprocess": (no_grad(lambda: pp.preprocess(subset_view(packed0, subset), cam, shape, rcfg)[0]),
                              lambda: grad(lambda x: sq(pp.preprocess(subset_view(x, subset), cam, shape, rcfg)[0]),
                                           packed0)),
        "render_view": (no_grad(lambda: render(packed0).rgb),
                        lambda: grad(lambda x: (lambda o: (torch.sum(o.rgb) + torch.sum(o.depth)
                                                           + torch.sum(o.normal)) * 1e-6)(render(x)), packed0)),
        "gather_kernel_image": (no_grad(lambda: pipeline(p2d0)),
                                lambda: grad(lambda x: torch.sum(pipeline(x)[:9]) * 1e-6, p2d0)),
    }


LABELS = {
    "kernel": "kernel", "entry_gather": "entry gather", "subset": "subset", "subset_preprocess": "subset+preproc",
    "render_view": "render_view", "gather_kernel_image": "gather+kern+img",
}


def main(argv: list[str] | None = None) -> dict:
    _, _, device = profiling.parse(argv)
    res, n_gauss, steps = profiling.bench_shape()
    st = profiling.bench_step(res, n_gauss, steps, device)
    bins = st.bins[0]
    real = int(bins.tile_len.sum())
    print(f"bucket={st.subset_bucket} E={bins.gid.shape[0]} real_entries={real}")
    times = {}
    for name, (fwd, fwd_bwd) in components(st).items():
        times[name] = {"fwd": probe.time_ms(fwd, ITERS, device), "fwd_bwd": probe.time_ms(fwd_bwd, ITERS, device)}
        print(f"{LABELS[name] + ' fwd:':20s}{times[name]['fwd']:7.3f} ms/view")
        print(f"{LABELS[name] + ' f+b:':20s}{times[name]['fwd_bwd']:7.3f} ms/view")
    return profiling.emit({
        "metric": "render_view_fwd_bwd_ms_per_view",
        "value": times["render_view"]["fwd_bwd"],
        "unit": "ms/view",
        "components": times,
        "subset_bucket": st.subset_bucket, "entry_budget": st.entry_budget, "entries": bins.gid.shape[0],
        "real_entries": real, "timing": profiling.event_timing(device, ITERS), "res": res, "gaussians": n_gauss,
        "device": profiling.card() if device.type == "cuda" else "cpu",
    })


if __name__ == "__main__":
    main()
