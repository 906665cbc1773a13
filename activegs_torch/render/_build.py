"""Build the hand-written CUDA kernels of `csrc/` into shared libraries.

Each `csrc/<name>.cu` is compiled on its own by nvcc for sm_90a, strict
fp32 (no --use_fast_math, no FMA contraction), into `<repo>/build/kernels/<name>-<digest>.so`,
where the digest covers the sources and flags, so an edited source
rebuilds and an unchanged one is reused. The libraries have a plain C
interface (`<name>_launch`, `<name>_errstr`) and are loaded with ctypes.
Nothing is built at import time: `load` builds what is missing at first use,
and `build_all` builds every kernel at once, one nvcc process per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("composite_fwd", "composite_bwd", "composite_stats")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    # no mul+add contraction: each product rounds on its own, as in the
    # plain torch versions, so alpha and its 1/255 cutoff match them bitwise
    "-fmad=false",
    "-Xptxas", "-v",  # registers / spills into the build log
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library, all nvcc processes started together.
    Returns {name: ptxas log} for the sources compiled now; raises with the
    compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        logs[name] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if missing."""
    if name not in _loaded:
        path = lib_path(name)
        if not path.exists():
            build_all((name,))
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
