"""ctypes loader for the native planning runtime (`csrc/astar.cpp`).

The shared library is built with g++ into the git-ignored
`<repo>/build/native/` at first use (named by a digest of the source and
flags, written atomically, so concurrent first uses agree), and loaded with
ctypes. A failed build raises: the pure-Python search in `astar.py` runs
only when a caller asks for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "astar.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libastar-{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The loaded A* library, built first if missing."""
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not path.exists():
                gxx = shutil.which("g++")
                if gxx is None:
                    raise RuntimeError("g++ not found: the native A* builds only where a C++ compiler is installed")
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                r = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)], capture_output=True, text=True)
                if r.returncode != 0:
                    raise RuntimeError(f"g++ failed to build {SRC.name}:\n{r.stderr}")
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            lib.astar_multi_goal.restype = ctypes.c_int
            _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def native_search_goal(start, goals, traversable, voxel_size):
    """Multi-goal A* from voxel `start` (3,) to voxels `goals` (N, 3).
    Returns (paths, lengths) as `astar.search_goal` does."""
    lib = load()
    trav = np.ascontiguousarray(traversable.astype(np.uint8))
    dx, dy, dz = trav.shape
    start = np.ascontiguousarray(np.asarray(start, np.int64))
    goals = np.ascontiguousarray(np.asarray(goals, np.int64))
    vs = np.ascontiguousarray(np.asarray(voxel_size, np.float64))
    n = len(goals)
    path_cap = int(dx + dy + dz) * 3
    lengths = np.empty(n, np.float64)
    paths = np.zeros((n, path_cap, 3), np.int64)
    path_len = np.zeros(n, np.int64)
    i64 = ctypes.c_int64
    lib.astar_multi_goal(
        _ptr(trav), i64(dx), i64(dy), i64(dz), _ptr(start), _ptr(goals), i64(n), _ptr(vs),
        _ptr(lengths), _ptr(paths), i64(path_cap), _ptr(path_len),
    )
    out_paths = [[tuple(p) for p in paths[g, : path_len[g]]] if path_len[g] else [] for g in range(n)]
    return out_paths, lengths.tolist()
