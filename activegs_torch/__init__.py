"""PyTorch + CUDA port of the active Gaussian-surfel reconstruction system.

`activegs_tpu/` is the frozen JAX reference; this package mirrors its layout
(`core/`, `render/`, `mapping/`, `sim/`) and is held to its outputs by the
`tests/test_torch_*.py` parity tests. The three tile-compositor kernels are
hand-written CUDA C++ for Hopper (`render/csrc/`), built on first use by
`render/_build.py`. Entry points default to `device="cuda"`; pass
`device="cpu"` explicitly to run the plain PyTorch versions on the CPU.
"""

import torch as _torch

# strict float32 wherever a product or a convolution runs on the card: TF32
# would break the port's 2e-5 contract with the reference
_torch.backends.cudnn.allow_tf32 = False
_torch.backends.cuda.matmul.allow_tf32 = False
