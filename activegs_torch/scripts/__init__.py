"""Entry points of the port that are not part of the mission: the
elementwise-rate probes (`microbench_vpu`, `microbench_bf16`) and the
measurement and experiment scripts (`bench`, `bench_mission`,
`validate_truncation`, `run_sweep` with `run_experiments.sh`)."""
