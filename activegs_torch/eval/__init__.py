"""Offline evaluation: rendering and mesh metrics, TSDF fusion, the
evaluation tool (port of `activegs_tpu/eval/`)."""
