"""Checkpoints of the original ActiveGS system: convert its torch `.th` map
snapshots into the port's npz checkpoints, and back (port of
`activegs_tpu/io/convert_reference.py`).

The original saves its gaussian map with `torch.save` as a flat dict: raw
parameter tensors (means, log scales, SH0 harmonics, opacity logits,
quaternions), the Welford view statistics and a few scalars. Its fields
map one to one onto `GaussianMapState` (both hold raw, pre-activation
values; colors are the SH0 band), so only the container changes.

    python -m activegs_torch.io.convert_reference map_final.th out.npz
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..mapping import gaussians as gm
from . import checkpoint


def load_reference_map(path: str) -> dict:
    """The `.th` checkpoint's dict, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def reference_to_state(d: dict, capacity: int | None = None, device="cuda") -> tuple[gm.GaussianMapState, gm.MapConfig]:
    """The dict of a `.th` checkpoint as (GaussianMapState on `device`,
    MapConfig); the capacity defaults to the smallest capacity bucket that
    holds the map."""
    means = _f32(d["means"])
    n = means.shape[0]
    cap = capacity or gm.bucket_capacity(n, 1 << 22)
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} gaussians")
    cfg = gm.MapConfig(
        capacity=cap,
        scale_factor=float(d.get("scale_factor", 0.01)),
        background=tuple(np.asarray(d.get("background_color", (0, 0, 0))).tolist()),
    )
    harmonics = _f32(d["harmonics"])
    fields = {
        "means": means,
        "scales_raw": _f32(d["scales"]),
        "rotations_raw": _f32(d["rotations"]),
        "opacities_raw": _f32(d["opacities"]).reshape(n, -1)[:, 0],
        "colors": harmonics[:, 0, :] if harmonics.ndim == 3 else harmonics,
        "view_scores": _f32(d["view_scores"]),
        "view_supports": _f32(d["view_supports"]),
        "view_means": _f32(d["view_means"]),
    }
    state = gm.init_state(cfg, device)
    for k, v in fields.items():
        getattr(state, k)[:n] = v.to(device)
    return gm.GaussianMapState(**{k: getattr(state, k) for k in gm.FIELDS}, count=n), cfg


def convert(src_th: str, dst_npz: str, capacity: int | None = None) -> int:
    """`.th` -> npz checkpoint (through the CPU). Returns the live gaussian
    count."""
    state, cfg = reference_to_state(load_reference_map(src_th), capacity, device="cpu")
    checkpoint.save_gaussian_map(dst_npz, state, cfg)
    return state.count


def state_to_reference(state: gm.GaussianMapState, cfg: gm.MapConfig, path: str) -> None:
    """Write a map as a `.th` checkpoint of the original system, with the
    keys and shapes it saves."""
    n = state.count
    t = lambda x: x[:n].detach().to("cpu").clone()  # noqa: E731
    torch.save(
        {
            "means": t(state.means),
            "scales": t(state.scales_raw),
            "harmonics": t(state.colors)[:, None, :],
            "opacities": t(state.opacities_raw)[:, None],
            "rotations": t(state.rotations_raw),
            "view_scores": t(state.view_scores),
            "view_supports": t(state.view_supports),
            "view_means": t(state.view_means),
            "near": 0.0,
            "far": 5.0,
            "use_view_direction": cfg.use_view_distribution,
            "background_color": list(cfg.background),
            "scale_factor": cfg.scale_factor,
        },
        path,
    )


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) < 2:
        print("usage: python -m activegs_torch.io.convert_reference in.th out.npz")
        return 1
    n = convert(args[0], args[1])
    print(f"converted {n} gaussians: {args[0]} -> {args[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
