"""Entry points of the port that are not part of the mission: the
elementwise-rate probes (`microbench_vpu`, `microbench_bf16`)."""
