"""Result plotting (port of `activegs_tpu/apps/plot.py`).

Aggregates final_result.json across runs and planners and draws
metric-against-mission-time curves (PSNR, SSIM, depth MSE, mesh completion
ratio, accuracy, completion) with mean +- sd bands. numpy, with matplotlib
imported when plotting: without matplotlib `plot` raises its ImportError.

    python -m activegs_torch.apps.plot --root ./experiments/test/boxroom \
        --out ./experiments/plots
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict

import numpy as np

METRICS = [
    ("mean_psnr", "PSNR [dB]"),
    ("mean_ssim", "SSIM"),
    ("mean_depth_mse", "Depth MSE [m^2]"),
    ("mesh_completion_ratio", "Completion ratio [%]"),
    ("mesh_accuracy", "Accuracy [cm]"),
    ("mesh_completion", "Completion [cm]"),
]


def collect(root: str) -> dict:
    """{planner: [(times, {metric: values}), ...]} over runs."""
    out = defaultdict(list)
    for result in sorted(glob.glob(os.path.join(root, "*", "*", "final_result.json"))):
        planner = os.path.basename(os.path.dirname(os.path.dirname(result)))
        with open(result) as f:
            data = json.load(f)
        if "time" not in data:
            continue
        out[planner].append(data)
    return out


def plot(root: str, out_dir: str) -> list[str]:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    runs = collect(root)
    if not runs:
        print(f"no final_result.json under {root}")
        return []
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for metric, label in METRICS:
        if not any(metric in d for ds in runs.values() for d in ds):
            continue
        fig, ax = plt.subplots(figsize=(5, 3.5), dpi=120)
        for planner, datas in sorted(runs.items()):
            curves = []
            times = None
            for d in datas:
                if metric not in d or d[metric] is None:
                    continue
                vals = [v for v in d[metric] if v is not None]
                if not vals:
                    continue
                times = np.asarray(d["time"][: len(vals)], float)
                curves.append(np.asarray(vals, float))
            if not curves or times is None:
                continue
            m = min(len(c) for c in curves)
            arr = np.stack([c[:m] for c in curves])
            mean = arr.mean(0)
            sd = arr.std(0)
            ax.plot(times[:m], mean, label=planner, marker="o", ms=3)
            ax.fill_between(times[:m], mean - sd, mean + sd, alpha=0.2)
        ax.set_xlabel("mission time [s]")
        ax.set_ylabel(label)
        ax.legend(fontsize=8)
        ax.grid(alpha=0.3)
        fig.tight_layout()
        path = os.path.join(out_dir, f"{metric}.png")
        fig.savefig(path)
        plt.close(fig)
        written.append(path)
    print(f"wrote {len(written)} plots to {out_dir}")
    return written


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="experiments/<exp_id>/<scene> dir")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    plot(args.root, args.out or os.path.join(args.root, "plots"))


if __name__ == "__main__":
    main()
