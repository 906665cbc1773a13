"""Map checkpoints, the mission recorder, PLY meshes and PNG images (port of
`activegs_tpu/io/`)."""
