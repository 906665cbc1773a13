"""Build the hand-written CUDA kernels of a `csrc/` directory into shared
libraries, and bind them.

Each `<csrc>/<name>.cu` is compiled on its own by nvcc for sm_90a, strict
fp32 (no --use_fast_math, no FMA contraction, IEEE division and expf), into
`<repo>/build/kernels/<name>-<digest>.so`, where the digest covers the
source, the headers of its directory that it includes, and the flags, so
an edited source rebuilds and an unchanged one is reused. The libraries have a plain C interface
(`<name>_launch`, `<name>_errstr`) and are loaded with ctypes. Nothing is
built at import time: `load` builds what is missing at first use, and
`build_all` builds a set of kernels at once, one nvcc process per source.
The compositor kernels live in `render/csrc/` (`CSRC`); other packages of
the port pass their own directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    # no mul+add contraction: each product rounds on its own, as in the
    # plain torch versions, so alpha and its 1/255 cutoff match them bitwise
    "-fmad=false",
    "-Xptxas", "-v",  # registers / spills into the build log
)

_loaded: dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def sources(name: str, csrc: Path = CSRC) -> list[Path]:
    """`<csrc>/<name>.cu` and the headers of `csrc` it includes (with
    `#include "..."`, followed into those headers), in a fixed order."""
    found, todo = set(), [Path(csrc) / f"{name}.cu"]
    while todo:
        src = todo.pop()
        if src in found:
            continue
        found.add(src)
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', src.read_text(), re.M):
            if (Path(csrc) / inc).exists():
                todo.append(Path(csrc) / inc)
    return sorted(found)


def source_digest(name: str, csrc: Path = CSRC) -> str:
    """Digest of what kernel `name` of `csrc` is compiled from: its sources
    (`sources`) and the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(name, csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str, csrc: Path = CSRC) -> Path:
    return BUILD_DIR / f"{name}-{source_digest(name, csrc)}.so"


def build_all(sources) -> dict[str, str]:
    """Compile every missing library of `sources`, (csrc dir, name) pairs,
    all nvcc processes started together. Returns {name: ptxas log} for the
    sources compiled now; raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for csrc, name in sources:
        out = lib_path(name, csrc)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(Path(csrc) / f"{name}.cu")]
        # keyed by library: two directories may hold sources of one name
        jobs[out] = (name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    logs = {}
    failed = []
    for out, (name, proc, tmp) in jobs.items():
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


def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The loaded library of kernel `name` of `csrc`, built first if missing."""
    path = lib_path(name, csrc)
    if path not in _loaded:
        if not path.exists():
            build_all([(csrc, name)])
        _loaded[path] = ctypes.CDLL(str(path))
    return _loaded[path]


class CudaKernel:
    """One kernel of `<csrc>/<source>.cu`, launched through its exported
    `<name>_launch` (`name` defaults to the source's; a source may export
    several instances), built and bound through ctypes at first launch.
    `launches` counts the launches made through `launch`, and nothing
    else."""

    def __init__(self, source: str, argtypes: list, csrc: Path = CSRC, name: str | None = None):
        self.source = source
        self.name = name or source
        self.csrc = Path(csrc)
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._errstr = None

    @property
    def library(self) -> Path:
        return lib_path(self.source, self.csrc)

    def launch(self, *args) -> None:
        if self._fn is None:
            lib = load(self.source, self.csrc)
            fn = getattr(lib, f"{self.name}_launch")
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.source}_errstr")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._errstr = fn, err
        code = self._fn(*args)
        if code != 0:
            raise RuntimeError(
                f"{self.name}: CUDA error {code} ({self._errstr(code).decode()})"
            )
        self.launches += 1
