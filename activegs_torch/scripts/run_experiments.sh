#!/usr/bin/env bash
# The planner-comparison sweep of the port (port of scripts/run_experiments.sh):
# scenes x planners x seeds -> mission -> mesh -> eval -> plots -> summary.
#
# Runs everything in one process (python -m activegs_torch.scripts.run_sweep):
# a process per run would bill each process's first uses (kernel builds, the
# CUDA context) to its mission's budget. run_sweep warms once, flies every
# recorded mission warm, and writes experiments/$EXP_ID/summary.json.
# EXTRA holds further key=value arguments (device=cpu, run_ids=0,1 merge=1, ...).
set -euo pipefail
cd "$(dirname "$0")/../.."

SCENES=${SCENES:-"synthetic/boxroom,synthetic/tworoom"}
PLANNERS=${PLANNERS:-"confidence,confidence_wo_roi,exploration,random"}
RUNS=${RUNS:-3}
EXP_ID=${EXP_ID:-sweep}
BUDGET=${BUDGET:-150}

# shellcheck disable=SC2086
python -m activegs_torch.scripts.run_sweep \
  exp_id="$EXP_ID" budget="$BUDGET" runs="$RUNS" \
  scenes="$SCENES" planners="$PLANNERS" ${EXTRA:-}
