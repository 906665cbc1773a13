"""The benchmark's plain reference of ActiveGS's surfel rasterizer, mapping
loss, Adam step, view statistics and candidate utilities, in plain
PyTorch. It imports nothing of the measured program and reads only the
inputs it is handed; `correct` is decided against it."""
