"""Map checkpoints and the mission recorder (port of `activegs_tpu/io/`)."""
