"""Sustained FP32 elementwise rate per primitive on one NVIDIA GPU (port of
`scripts/microbench_vpu.py`).

    python -m activegs_torch.scripts.microbench_vpu

The compositor kernels are mostly FP32 multiplies and adds with an expf and
a division per (entry, pixel) pair; the rates printed here turn their
operation counts into a measured bound beside the data-sheet one. Every
element of a (GRID, 128, 128) float32 array runs ROUNDS serial rounds of
one operation (`csrc/microbench_vpu.cu`, built with the compositor's
flags). For `fma` there are two variants: `fma`, v * c1 + c0 as the
compositor writes it (a rounded multiply, then an add), and `fma_fused`,
one fused multiply-add; both count 2 operations per round. Times are CUDA
events, the median of TIMED launches.

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
SUB, LANE = 128, 128
ROUNDS = 4096
GRID = 256
TIMED = 5
UNROLL = 8  # rounds per iteration of the kernel's loop
C1, C0 = 1.000001, 1e-7
OPS = ("fma", "fma_fused", "mul", "add", "cmpsel", "exp", "div")
OPS_PER_ROUND = {"fma": 2, "fma_fused": 2, "mul": 1, "add": 1, "cmpsel": 3, "exp": 3, "div": 2}
_C1_F32, _C0_F32 = (float(torch.tensor(c, dtype=torch.float32)) for c in (C1, C0))  # what the kernel gets

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
kernel = CudaKernel("microbench_vpu", [_P, _P, _LL, _I, _I, _F, _F, _P], CSRC)
KERNELS = (kernel,)


def step_plain(v: torch.Tensor, op: str) -> torch.Tensor:
    """One round of `op` on float32 `v`, one rounding per operation (the
    fused variant rounds the exact v * c1 + c0 once)."""
    if op == "fma":
        return v * C1 + C0
    if op == "fma_fused":
        return (v.double() * _C1_F32 + _C0_F32).float()
    if op == "mul":
        return v * C1
    if op == "add":
        return v + C0
    if op == "cmpsel":
        return torch.where(v > C0, v * C1, v)
    if op == "exp":
        return torch.exp(-v) + C0
    if op == "div":
        # a tensor numerator: `C1 / t` would multiply by a rounded reciprocal
        return torch.full_like(v, C1) / (v + C0)
    raise ValueError(op)


def chain_plain(x: torch.Tensor, op: str, rounds: int = ROUNDS) -> torch.Tensor:
    """`rounds` serial rounds of `op` on every element of float32 `x`."""
    v = x
    for _ in range(rounds):
        v = step_plain(v, op)
    return v


def chain(x: torch.Tensor, op: str, rounds: int = ROUNDS) -> torch.Tensor:
    """`chain_plain` through the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return chain_plain(x, op, rounds)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32, got {x.dtype}")
    if op not in OPS or rounds % UNROLL:
        raise ValueError(f"op {op!r}, rounds {rounds}: ops are {OPS}, rounds a multiple of {UNROLL}")
    y = torch.empty_like(x)
    kernel.launch(
        x.data_ptr(), y.data_ptr(), x.numel(), rounds, OPS.index(op), C1, C0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return y


def run(op: str, device="cuda", grid: int = GRID, rounds: int = ROUNDS, timed: int = TIMED) -> dict:
    """Time `op` on a (grid, 128, 128) array of 0.5 and print its rate.
    Returns {ms, tops}."""
    x = torch.full((grid, SUB, LANE), 0.5, device=device)
    ms = probe.time_ms(lambda: chain(x, op, rounds), timed, device)
    tops = x.numel() * rounds * OPS_PER_ROUND[op] / (ms * 1e-3) / 1e12
    print(f"{op:9s}: {ms:9.3f} ms, {tops:6.2f} Tops/s ({OPS_PER_ROUND[op]} ops/el/round)")
    return {"ms": ms, "tops": tops}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cpu runs the plain version")
    args = ap.parse_args(argv)
    return {op: run(op, args.device) for op in OPS}


if __name__ == "__main__":
    main()
