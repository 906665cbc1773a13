"""bf16 against f32 elementwise multiply-add throughput on one NVIDIA GPU
(port of `scripts/microbench_bf16.py`).

    python -m activegs_torch.scripts.microbench_bf16

Decides whether bf16 pair math in the compositor would pay. Every element
of a (GRID, 256, 512) float32 array of ones runs ROUNDS serial rounds of
v * c1 + c0, in f32 or in bf16 (`csrc/microbench_bf16.cu`: a rounded
multiply then an add, packed `__hmul2` / `__hadd2` in bf16), and the output
is f32. Times are CUDA events, the median of TIMED launches; the ratio
f32/bf16 is the answer.

`chain` launches the kernel for a CUDA tensor and takes the plain PyTorch
version, `chain_plain`, only for a CPU tensor.
"""

from __future__ import annotations

import argparse
import ctypes
from pathlib import Path

import torch

from ..render._build import CudaKernel
from . import probe

CSRC = Path(__file__).resolve().parent / "csrc"
ROUNDS = 512
SUB, LANE = 256, 512
GRID = 512
TIMED = 5
UNROLL = 8  # rounds per iteration of the kernel's loop
C1, C0 = 1.000001, 1e-7
DTYPES = ("float32", "bfloat16")
OPS_PER_ROUND = 2  # mul + add
# Inputs on which ROUNDS rounds of the bf16 chain move every value in every
# round. With c1 rounded to 1.0 a round only adds c0 (1.0012e-7 in bf16),
# which moves a bf16 value only while its magnitude is below 2^-15; from
# this band the chain climbs through 0 and is still short of 2^-15 after
# ROUNDS rounds. From the timing input of ones the chain is the identity.
MOVING_BAND = (-3.05e-5, -2.7e-5)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
kernel = CudaKernel("microbench_bf16", [_P, _P, _LL, _I, _I, _F, _F, _P], CSRC)
KERNELS = (kernel,)


def chain_plain(x: torch.Tensor, dtype: str, rounds: int = ROUNDS) -> torch.Tensor:
    """`rounds` rounds of v * c1 + c0 in `dtype` from float32 `x`, each
    operation rounding to `dtype` (c1 and c0 too: in bf16, c1 is 1.0);
    returns float32."""
    dt = getattr(torch, dtype)
    c1, c0 = (torch.tensor(c, dtype=dt, device=x.device) for c in (C1, C0))
    v = x.to(dt)
    for _ in range(rounds):
        v = v * c1 + c0
    return v.to(torch.float32)


def chain(x: torch.Tensor, dtype: str, rounds: int = ROUNDS) -> torch.Tensor:
    """`chain_plain` through the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return chain_plain(x, dtype, rounds)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32, got {x.dtype}")
    if dtype not in DTYPES or rounds % UNROLL or x.numel() % 2:
        raise ValueError(f"dtype {dtype!r}, rounds {rounds}, {x.numel()} elements: dtypes are {DTYPES}, "
                         f"rounds a multiple of {UNROLL}, the elements even")
    y = torch.empty_like(x)
    kernel.launch(
        x.data_ptr(), y.data_ptr(), x.numel(), rounds, DTYPES.index(dtype), C1, C0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return y


def run(dtype: str, device="cuda", grid: int = GRID, rounds: int = ROUNDS, timed: int = TIMED) -> dict:
    """Time the chain in `dtype` on a (grid, 256, 512) array of ones and
    print its rate. Returns {ms, tops}."""
    x = torch.ones((grid, SUB, LANE), device=device)
    ms = probe.time_ms(lambda: chain(x, dtype, rounds), timed, device)
    tops = x.numel() * rounds * OPS_PER_ROUND / (ms * 1e-3) / 1e12
    print(f"{dtype}: {ms:.3f} ms  {tops:.2f} Tops/s")
    return {"ms": ms, "tops": tops}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cpu runs the plain version")
    args = ap.parse_args(argv)
    res = {dt: run(dt, args.device) for dt in DTYPES}
    res["ratio"] = res["float32"]["ms"] / res["bfloat16"]["ms"]
    print(f"ratio f32/bf16 = {res['ratio']:.2f}")
    return res


if __name__ == "__main__":
    main()
