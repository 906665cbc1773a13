"""What entry truncation costs in image quality on a mission-scale map (port
of `scripts/validate_truncation.py`).

    python -m activegs_torch.scripts.validate_truncation map=<map_XXX.npz> cams=<cameras_XXX.json> \
        [n_views=8] [shape=512] [out=<file.json>]

The rasterizer caps each gaussian's tile span at `max_dup` tiles and the
binned entry stream at a static budget (`render/binning.py`), as the
reference does; the original system's per-tile lists are exact. This
renders a saved map under the production `RasterConfig` (the port's
`build_components` of the default config: so the default
`entry_budget_mult`, which `build_components` drops, as the reference's
does) and under a reference config (max_dup 16, 4x the entry budget, the
same math), at `n_views` cameras taken evenly from a recorder's
`cameras_*.json`, and reports per view the PSNR between the two clipped RGB
renders, the depth MSE, and both renders' `num_dropped`. `shape` is the
render size (`512`, the reference's, or `HxW`; `mesh_app` renders at
1024). The map may come from either package's checkpoint
(`io/checkpoint.py`). Other `key=value` arguments go to the config loader
(`device=cpu` runs on the CPU).

Prints the rows, then ONE JSON line with the reference's keys; `out=`
also writes the result there with the rows.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys

import numpy as np
import torch

from ..apps.common import mission_device
from ..config import build_components
from ..config.loader import load_config
from ..io import checkpoint
from ..mapping import gaussians as gm
from ..render.renderer import render_view
from ..render.types import Camera, RasterConfig

REFERENCE_MAX_DUP = 16
REFERENCE_BUDGET_FACTOR = 4.0


def reference_config(prod: RasterConfig) -> RasterConfig:
    """The untruncated-in-practice config the production one is held to."""
    return dataclasses.replace(
        prod, max_dup=REFERENCE_MAX_DUP, entry_budget_mult=REFERENCE_BUDGET_FACTOR * prod.entry_budget_mult
    )


@torch.no_grad()
def render_clipped(attrs, ext, intr, shape, rcfg: RasterConfig):
    """(RGB clipped to [0, 1], depth, num_dropped) of one view."""
    o, aux = render_view(attrs, Camera(extrinsic=ext, intrinsic=intr), shape, rcfg)
    return torch.clamp(o.rgb, 0.0, 1.0), o.depth, int(aux["num_dropped"])


def psnr_db(a: torch.Tensor, b: torch.Tensor) -> float:
    """-10 log10(MSE + 1e-12), the reference's formula."""
    return -10.0 * math.log10(float(torch.mean((a - b) ** 2)) + 1e-12)


def truncation_row(attrs, ext, intr, shape, prod_cfg: RasterConfig, ref_cfg: RasterConfig) -> dict:
    """One view under both configs, in the reference's row keys."""
    rgb_p, depth_p, drop_p = render_clipped(attrs, ext, intr, shape, prod_cfg)
    rgb_r, depth_r, drop_r = render_clipped(attrs, ext, intr, shape, ref_cfg)
    return {
        "psnr_prod_vs_ref": round(psnr_db(rgb_p, rgb_r), 2),
        "depth_mse": float(torch.mean((depth_p - depth_r) ** 2)),
        "dropped_prod": drop_p,
        "dropped_ref": drop_r,
    }


def load_cameras(cam_file: str, n_views: int, device) -> list:
    """`n_views` (extrinsic, intrinsic) pairs taken evenly from a recorder's
    cameras file (rows of 16 + 9 floats)."""
    with open(cam_file) as f:
        rows = json.load(f)
    rows = rows[:: max(1, len(rows) // n_views)][:n_views]
    return [
        (torch.tensor(np.asarray(r[:16], np.float32).reshape(4, 4), device=device),
         torch.tensor(np.asarray(r[16:], np.float32).reshape(3, 3), device=device))
        for r in rows
    ]


def parse_shape(s: str) -> tuple[int, int]:
    """`512` or `HxW`."""
    h, _, w = str(s).partition("x")
    return int(h), int(w or h)


def main(argv: list[str] | None = None) -> dict:
    """Run the check that the `key=value` arguments (default: the command
    line) describe. Returns the result, rows included."""
    argd = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    map_file = argd.pop("map")
    cam_file = argd.pop("cams")
    n_views = int(argd.pop("n_views", 8))
    shape = parse_shape(argd.pop("shape", "512"))
    out = argd.pop("out", None)
    cfg = load_config("main", [f"{k}={v}" for k, v in argd.items()])
    device = mission_device(cfg)

    prod_cfg = build_components(cfg)["raster_cfg"]
    ref_cfg = reference_config(prod_cfg)
    state, mcfg = checkpoint.load_gaussian_map(map_file, device=device)
    attrs = gm.attrs_of(gm.slice_state(state, gm.bucket_capacity(state.count, mcfg.capacity)), mcfg)

    rows = []
    for ext, intr in load_cameras(cam_file, n_views, device):
        rows.append(truncation_row(attrs, ext, intr, shape, prod_cfg, ref_cfg))
        print(rows[-1])

    result = {
        "metric": "truncation_psnr_prod_vs_ref",
        "value": round(float(np.mean([r["psnr_prod_vs_ref"] for r in rows])), 2),
        "unit": f"dB ({shape[0]}x{shape[1]} render, production max_dup/budget vs max_dup=16/4x budget)",
        "min_psnr": min(r["psnr_prod_vs_ref"] for r in rows),
        "mean_depth_mse": float(np.mean([r["depth_mse"] for r in rows])),
        "mean_dropped_prod": int(np.mean([r["dropped_prod"] for r in rows])),
        "mean_dropped_ref": int(np.mean([r["dropped_ref"] for r in rows])),
        "map": map_file,
        "n_gaussians": state.count,
        "prod": {"max_dup": prod_cfg.max_dup, "budget_mult": prod_cfg.entry_budget_mult},
        "views": rows,
    }
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items() if k != "views"}))
    return result


if __name__ == "__main__":
    main()
