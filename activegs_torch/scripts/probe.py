"""What the elementwise-rate probes share: CUDA-event timing, and the least
time an instruction mix can take on the card, read from the SASS of a
probe's loop.

The bound of a probe is an issue-rate bound: each round of the loop issues
the instructions `cuobjdump -sass` shows for it, and every SM retires them
no faster than the per-SM rates of the arithmetic-instruction throughput
table of the CUDA C++ Programming Guide for compute capability 9.0, at the
SM clock that `nvidia-smi` reports.
"""

from __future__ import annotations

import re
import shutil
import statistics
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch

# results per clock per SM, compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput). A packed bf16x2 instruction
# gives 2 of the 256 16-bit results, so 128 instructions per clock.
PIPE_RATE = {
    "fp32": 128,  # FADD, FMUL, FFMA
    "bf16x2": 128,  # HADD2, HMUL2, HFMA2 on packed pairs
    "compare": 64,  # FP and integer compare, select, min, max
    "int": 64,  # integer add, logic, shift, multiply-add
    "mufu": 16,  # reciprocal, exp2, log2 and the other special functions
    "convert": 16,  # type conversions
}
ISSUE_RATE = 128  # 4 schedulers x one warp instruction (32 threads) a clock

_PIPE_OF = {
    "FADD": "fp32", "FMUL": "fp32", "FFMA": "fp32",
    "HADD2": "bf16x2", "HMUL2": "bf16x2", "HFMA2": "bf16x2",
    "FSETP": "compare", "FSEL": "compare", "FMNMX": "compare", "FSET": "compare", "FCHK": "compare",
    "ISETP": "compare", "SEL": "compare", "IMNMX": "compare",
    "IADD3": "int", "IMAD": "int", "LOP3": "int", "SHF": "int", "LEA": "int", "IABS": "int",
    "MUFU": "mufu",
    "F2F": "convert", "F2I": "convert", "I2F": "convert", "F2FP": "convert",
}

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"BRA\s+(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)")


def time_ms(fn, n: int, device) -> float:
    """Median time of one call of `fn` over `n` calls after one warm-up:
    CUDA events for work on a CUDA `device`, the host clock on the CPU."""
    fn()
    cuda = torch.device(device).type == "cuda"
    times = []
    for _ in range(n):
        if cuda:
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def cuobjdump() -> str:
    for cand in (Path("/usr/local/cuda/bin/cuobjdump"), shutil.which("cuobjdump")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("cuobjdump not found: the SASS is read only where the CUDA toolkit is installed")


def sass(library: Path) -> dict[str, str]:
    """{mangled kernel name: its SASS text} of a built library."""
    out = subprocess.run([cuobjdump(), "-sass", str(library)], capture_output=True, text=True, check=True).stdout
    funcs, name, lines = {}, None, []
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                funcs[name] = "\n".join(lines)
            name, lines = m.group(1), []
        elif name:
            lines.append(line)
    if name:
        funcs[name] = "\n".join(lines)
    return funcs


def loop_opcodes(text: str) -> list[str]:
    """Opcodes of the largest loop of one kernel's SASS: the instructions
    from the target of its widest backward branch to that branch."""
    insns, labels = [], {}
    pending = []
    for line in text.splitlines():
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for p in pending:
            labels[p] = addr
        pending = []
        insns.append((addr, m.group(2)))
    best = None
    for addr, body in insns:
        t = _TARGET.search(body)
        if not t:
            continue
        tgt = t.group(1)
        tgt = int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt)
        if tgt is not None and tgt <= addr and (best is None or addr - tgt > best[1] - best[0]):
            best = (tgt, addr)
    if best is None:
        raise ValueError("no loop in this kernel's SASS")
    ops = []
    for addr, body in insns:
        if best[0] <= addr <= best[1]:
            words = body.split()
            ops.append(words[1] if words[0].startswith("@") else words[0])
    return ops


def exp_loop_opcodes(text: str) -> list[str]:
    """Opcodes of the innermost loop of one kernel's SASS that evaluates an
    exponential (holds MUFU.EX2): the instructions from the target of a
    backward branch to that branch, the shortest such stretch."""
    insns, labels, pending = [], {}, []
    for line in text.splitlines():
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for p in pending:
            labels[p] = addr
        pending = []
        words = m.group(2).split()
        insns.append((addr, m.group(2), words[1] if words[0].startswith("@") else words[0]))
    best = None
    for addr, body, _ in insns:
        t = _TARGET.search(body)
        if not t:
            continue
        tgt = t.group(1)
        tgt = int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt)
        if tgt is None or tgt > addr or (best is not None and addr - tgt >= best[1] - best[0]):
            continue
        if any(op == "MUFU.EX2" for a, _, op in insns if tgt <= a <= addr):
            best = (tgt, addr)
    if best is None:
        raise ValueError("no loop with an exponential in this kernel's SASS")
    return [op for a, _, op in insns if best[0] <= a <= best[1]]


def per_round(ops: list[str], unroll: int) -> dict[str, float]:
    """Instructions per round of each opcode in a loop that holds `unroll`
    rounds."""
    return {op: n / unroll for op, n in sorted(Counter(ops).items())}


def cycles_per_round(counts: dict[str, float]) -> tuple[float, str]:
    """(SM clocks per 1 element-round on one SM, the limiting pipe): the
    slowest of the pipes and instruction issue."""
    pipes = Counter()
    for op, n in counts.items():
        pipe = _PIPE_OF.get(op.split(".")[0])
        if pipe:
            pipes[pipe] += n
    cyc = {p: n / PIPE_RATE[p] for p, n in pipes.items()}
    cyc["issue"] = sum(counts.values()) / ISSUE_RATE
    limit = max(cyc, key=cyc.get)
    return cyc[limit], limit


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, as `nvidia-smi` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout
    return float(out.strip().splitlines()[0])


def bound_ms(elements: int, rounds: int, cycles: float, sms: int, clock_mhz: float) -> float:
    """Least time for `elements` x `rounds` element-rounds at `cycles` SM
    clocks each, spread over `sms` SMs."""
    return elements * rounds * cycles / (sms * clock_mhz * 1e6) * 1e3
