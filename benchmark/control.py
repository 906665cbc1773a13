"""The readings that the limits of `limits/<workload>.json` are set from:
several seeds of one cell in one process, each a set-up, a short window
(its sampled step) and the comparison, printing each seed's compared
numbers as one JSON line. `--fault <name>` plants one of
`harness/faults.py`'s faults for the fault readings. `--bf16 1` runs the control: the program with its
bf16 pair math (`mapper.raster.bf16_pairs`) switched on, the nearest
precision below the float32 that the configuration states; `correct` has to
come out false there. The benchmark's own runs do not run this.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--bf16 1] [--seconds 1]
"""

from __future__ import annotations

import argparse
import json
import sys

import run
from harness import faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--bf16", type=int, choices=(0, 1), default=0)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), help="plant this fault in the timed path")
    args = ap.parse_args(argv)
    overrides = {"mapper.raster.bf16_pairs": True} if args.bf16 else {}
    undo = faults.plant(args.fault) if args.fault else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            out = run.run(args.workload, seed, args.seconds, False, overrides=dict(overrides))
            line = {"workload": args.workload, "seed": seed, "bf16": bool(args.bf16), "fault": args.fault,
                    "correct": out["correct"], "readings": out["readings"], "window": out["window"]}
            print(json.dumps(line), flush=True)
    finally:
        if undo:
            undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
