"""8-bit RGB PNG writer on the standard library (`zlib`, `struct`), so that
the port writes images without PIL: one IDAT chunk, every row with filter
type 0 (none)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def png_bytes(rgb: np.ndarray) -> bytes:
    """`rgb`, an (H, W, 3) uint8 array, as the bytes of an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"a PNG takes an (H, W, 3) uint8 array, not {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write `rgb`, an (H, W, 3) uint8 array, as an 8-bit RGB PNG."""
    data = png_bytes(rgb)
    with open(path, "wb") as f:
        f.write(data)
