"""The comparison that decides `correct`: what the window's sampled step
produced, against the plain reference (`reference/`) worked out again from
the step's inputs. Every number is a gap, 0 where the two agree, held
against its limit in `limits/<workload>.json`.

- Training (the sampled keyframe's first three Adam steps, as the window
  ran them): `image` the worst view and channel (rgb, depth, confidence)
  of sum |program - reference| / sum |reference| on the first step;
  `loss` the worst step's relative loss gap; `grad` the worst leaf's gap
  of the first gradient's norm, the program's read from Adam's first
  moment after step 1 (m / (1 - beta1)); `update` the worst leaf's gap of
  the norm of the leaves' change after three steps. A leaf's norm gap is
  |norm(program) - norm(reference)| over the larger of the reference's
  norm of that leaf and of the median leaf; leaves whose reference
  gradient is under a thousandth of the median leaf's are left out of
  `update` (round-off moves them under Adam).
- Stats (the sampled step's first stats render, the latest keyframe):
  `stats_importance` and `stats_count`, sum |program - reference| over
  the reference's sum, over the surfels.
- Planner (the sampled step's candidates): `exploit` the worst candidate's
  |program - reference| over the larger of the reference's |exploit| and
  the median candidate's; `explore` the worst candidate's gap in voxels;
  `choice` how far the program's chosen view falls below the reference's
  best by the reference's scores, over the spread of those scores.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import planner as rplan
from reference import raster
from reference import train as rtrain

BETA1 = 0.9


def raster_of(config: dict, utility: bool = False) -> raster.Raster:
    """The reference's raster settings from a configuration file."""
    c = config["constants"]["raster"]
    r = config["config"]["mapper"].get("raster", {})
    md = config["constants"]["utility_max_dup"] if utility else r.get("max_dup", 4)
    return raster.Raster(tile_h=r.get("tile_h", 16), tile_w=r.get("tile_w", 32), max_dup=md, **c)


def map_settings(config: dict) -> dict:
    g = config["config"]["mapper"]["gaussian_map"]
    return {**g["optimizer"], "scale_factor": g["scale_factor"], "scale_max": config["constants"]["scale_max"],
            "background": g["background"][:3], "use_view_distribution": g["use_view_distribution"]}


def _norm_gap(prog: dict, ref: dict, keys) -> tuple[float, dict]:
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keys}
    med = float(np.median(list(rn.values())))
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}
    return max(gaps.values()), gaps


def _rel_l1(p: torch.Tensor, r: torch.Tensor) -> float:
    den = float(r.double().abs().sum())
    num = float((p.double() - r.double()).abs().sum())
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return num / den


def training(t: dict, config: dict, info: list) -> dict:
    m = map_settings(config)
    rc = raster_of(config)
    ref = rtrain.follow(t["raw"], t["batch"], t["counts"], m, rc, steps=3)
    loss_p = [float(x) for x in t["loss"]]
    out = {"loss": max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(loss_p, ref["loss"]))}
    out["image"] = max(_rel_l1(pv[c], rv[c]) for pv, rv in zip(t["images"], ref["images"])
                       for c in ("rgb", "depth", "confidence"))
    keys = rtrain.PARAMS
    grad_p = {k: t["exp_avg"][k] / (1 - BETA1) for k in keys}
    out["grad"], _ = _norm_gap(grad_p, ref["grad"], keys)
    gn = {k: float(torch.linalg.vector_norm(ref["grad"][k].double())) for k in keys}
    med = float(np.median(list(gn.values())))
    moved = [k for k in keys if gn[k] >= 1e-3 * med]
    d_p = {k: t["params"][k] - t["raw"][k] for k in moved}
    d_r = {k: ref["params"][k] - t["raw"][k] for k in moved}
    out["update"], _ = _norm_gap(d_p, d_r, moved)
    info.append(f"training: loss program {loss_p} reference {ref['loss']}; leaves compared for update {moved}; "
                f"span-cap entries left out by the reference {sum(ref['n_trunc'])} a view set, "
                f"the program's num_dropped {t.get('num_dropped')}")
    return out


def stats(s_in: dict, s_out, config: dict, info: list) -> dict:
    rc = raster_of(config)
    g = config["config"]["mapper"]["gaussian_map"]
    a = raster.activate(s_in["raw"], g["scale_factor"], config["constants"]["scale_max"],
                        g["use_view_distribution"])
    depth = s_in["depth"]
    imp, cnt = raster.view_stats(a, s_in["ext"], s_in["intr"], tuple(depth.shape), rc,
                                 (depth > 0.0).to(torch.float32), config["constants"]["stats_weight_thres"])
    imp_p, cnt_p = s_out
    info.append(f"stats: importance sum program {float(imp_p.double().sum()):.6g} reference "
                f"{float(imp.double().sum()):.6g}; counts program {int(cnt_p.sum())} reference {int(cnt.sum())}")
    return {"stats_importance": _rel_l1(imp_p, imp), "stats_count": _rel_l1(cnt_p.to(torch.float64), cnt.double())}


def plan(rec: dict, config: dict, info: list) -> dict:
    c = config["config"]
    rc = raster_of(config, utility=True)
    g = c["mapper"]["gaussian_map"]
    dev = rec["plan"]["unexplored"].device
    a = raster.activate(rec["plan"]["raw"], g["scale_factor"], config["constants"]["scale_max"],
                        g["use_view_distribution"])
    sensor = c["simulator"]["sensor"]
    shape = tuple(int(round(c["planner"]["render_ratio"] * r)) for r in sensor["resolution"])
    intr = intrinsics(sensor["fov"], dev)
    _, _, _, centres = rplan.voxel_grid(config["constants"]["scene_bbox"], c["mapper"]["voxel_map"]["map_resolution"])
    cands = torch.as_tensor(rec["plan"]["candidates"], device=dev)
    ex, xp = rplan.utilities(a, cands, intr, shape, rc, rec["plan"]["unexplored"], torch.as_tensor(centres, device=dev),
                             sensor["depth_range"])
    ex, xp = ex.double().cpu().numpy(), xp.double().cpu().numpy()
    n_vox = centres.shape[0]
    med = float(np.median(np.abs(xp)))
    out = {"exploit": float(np.max(np.abs(rec["exploit"] - xp) / np.maximum(np.maximum(np.abs(xp), med), 1e-30))),
           "explore": float(np.max(np.abs(rec["explore"] - ex)) * n_vox)}
    s = rplan.scores(c["planner"]["explore_weight"] * ex + xp, rec["lengths"], c["planner"]["path_length_factor"])
    spread = float(s.max() - s.min())
    out["choice"] = float(s.max() - s[rec["choice"]]) / spread if spread > 0 else 0.0
    info.append(f"planner: {len(cands)} candidates at {shape[0]}x{shape[1]}; chosen view program #{rec['choice']} "
                f"reference #{int(np.argmax(s))}")
    return out


def intrinsics(fov, device) -> torch.Tensor:
    """Normalised pinhole intrinsics of a (vertical, horizontal) field of
    view in degrees, in float32 host math."""
    f32 = np.float32
    fx = f32(0.5) / np.tan(f32(np.deg2rad(f32(fov[1]))) / f32(2.0))
    fy = f32(0.5) / np.tan(f32(np.deg2rad(f32(fov[0]))) / f32(2.0))
    return torch.tensor([[fx, 0.0, 0.5], [0.0, fy, 0.5], [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def numbers(rec: dict, config: dict, info: list) -> dict:
    """Every gap the captured record allows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    if "train" in rec:
        out.update(training({**rec["train"], "num_dropped": _int(rec.get("num_dropped"))}, config, info))
    if "stats" in rec:
        out.update(stats(rec["stats_in"], rec["stats"], config, info))
    if "explore" in rec and "lengths" in rec:
        out.update(plan(rec, config, info))
    return out


def _int(x):
    return None if x is None else int(x)


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: [number, limit]}): every limited number present,
    finite and at most its limit."""
    table = {k: [nums.get(k), lim] for k, lim in limits.items()}
    ok = all(v is not None and np.isfinite(v) and v <= lim for v, lim in table.values())
    return ok, table
