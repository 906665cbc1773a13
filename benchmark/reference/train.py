"""Plain reference of the first optimisation steps of one keyframe's
training: per-view renders over bins frozen at the first step, the 4-term
loss weighted by each view's draw count, and Adam (eps 1e-15, the method's
per-group learning rates), written out here."""

from __future__ import annotations

import torch

from . import raster
from .loss import view_loss

PARAMS = ("means", "scales_raw", "rotations_raw", "opacities_raw", "colors")
LR_KEYS = {"means": "mean_lr", "scales_raw": "scale_lr", "rotations_raw": "rotation_lr",
           "opacities_raw": "opacity_lr", "colors": "harmonic_lr"}
BETA1, BETA2, EPS = 0.9, 0.999, 1e-15


def follow(raw: dict, batch: tuple, counts: torch.Tensor, m: dict, rc: raster.Raster, steps: int = 3) -> dict:
    """Follow `steps` Adam steps of one keyframe from the raw map `raw`
    (fields, `count`) on the view batch (rgb, depth, extrinsics,
    intrinsics) with draw `counts`; `m` holds the map settings (learning
    rates, scale_factor, scale_max, background, use_view_distribution).
    Returns {"loss": [per step], "errors": first step's per-view errors,
    "images": first step's per-view rgb / depth / confidence (detached),
    "grad": first step's gradient per leaf, "params": the leaves after
    `steps`, "n_trunc": entries the span cap left out, per view}."""
    rgb_gt, depth_gt, exts, intrs = batch
    v = rgb_gt.shape[0]
    shape = tuple(rgb_gt.shape[-2:])
    params = {k: raw[k].detach().clone().requires_grad_(True) for k in PARAMS}
    fixed = {k: val for k, val in raw.items() if k not in PARAMS}
    bg = torch.tensor(m["background"], dtype=torch.float32, device=rgb_gt.device)
    wts = counts.to(torch.float32) / counts.to(torch.float32).sum()
    with torch.no_grad():
        a0 = raster.activate({**fixed, **params}, m["scale_factor"], m["scale_max"], m["use_view_distribution"])
        bins = []
        for i in range(v):
            p, iv = raster.project(a0, exts[i], intrs[i], shape, rc)
            bins.append(raster.bin_view(p, iv, shape, rc))
    mom = {k: torch.zeros_like(x) for k, x in params.items()}
    vel = {k: torch.zeros_like(x) for k, x in params.items()}
    out = {"loss": [], "n_trunc": [b.n_trunc for b in bins]}
    for s in range(steps):
        for x in params.values():
            x.grad = None
        total = 0.0
        errs, imgs = [], []
        for i in range(v):
            a = raster.activate({**fixed, **params}, m["scale_factor"], m["scale_max"], m["use_view_distribution"])
            o, _ = raster.render(a, exts[i], intrs[i], shape, rc, bins=bins[i], background=bg)
            lv, ev = view_loss(o, rgb_gt[i], depth_gt[i], intrs[i])
            (lv * wts[i]).backward()
            total += float(lv.detach()) * float(wts[i])
            errs.append(ev)
            if s == 0:
                imgs.append({k: o[k].detach() for k in ("rgb", "depth", "confidence")})
        out["loss"].append(total)
        if s == 0:
            out["errors"] = torch.stack(errs)
            out["images"] = imgs
            out["grad"] = {k: x.grad.detach().clone() for k, x in params.items()}
        t = s + 1
        with torch.no_grad():
            for k, x in params.items():
                g = x.grad
                mom[k] = BETA1 * mom[k] + (1 - BETA1) * g
                vel[k] = BETA2 * vel[k] + (1 - BETA2) * g * g
                mhat = mom[k] / (1 - BETA1**t)
                vhat = vel[k] / (1 - BETA2**t)
                x -= m[LR_KEYS[k]] * mhat / (torch.sqrt(vhat) + EPS)
    out["params"] = {k: x.detach() for k, x in params.items()}
    return out
