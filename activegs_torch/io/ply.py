"""Minimal PLY mesh IO: a binary little-endian writer and an ascii / binary
reader (port of `activegs_tpu/io/ply.py`, host numpy; the files it writes
are byte for byte the reference's, so each package loads the other's).
Enough to persist reconstructed meshes (`mesh_XXX.ply`) and load
ground-truth meshes for evaluation.
"""

from __future__ import annotations

import numpy as np


def save_ply(path: str, vertices: np.ndarray, faces: np.ndarray, colors=None):
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    has_color = colors is not None
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0"]
        header.append(f"element vertex {len(vertices)}")
        header += ["property float x", "property float y", "property float z"]
        if has_color:
            header += [
                "property uchar red",
                "property uchar green",
                "property uchar blue",
            ]
        header.append(f"element face {len(faces)}")
        header.append("property list uchar int vertex_indices")
        header.append("end_header")
        f.write(("\n".join(header) + "\n").encode())
        if has_color:
            c8 = np.clip(np.asarray(colors) * 255 + 0.5, 0, 255).astype(np.uint8)
            vdt = np.dtype(
                [("xyz", np.float32, 3), ("rgb", np.uint8, 3)]
            )
            buf = np.empty(len(vertices), vdt)
            buf["xyz"] = vertices
            buf["rgb"] = c8
        else:
            vdt = np.dtype([("xyz", np.float32, 3)])
            buf = np.empty(len(vertices), vdt)
            buf["xyz"] = vertices
        f.write(buf.tobytes())
        fdt = np.dtype([("n", np.uint8), ("idx", np.int32, 3)])
        fb = np.empty(len(faces), fdt)
        fb["n"] = 3
        fb["idx"] = faces
        f.write(fb.tobytes())


def load_ply(path: str):
    """Returns (vertices (V,3) f32, faces (F,3) i32). Supports the binary
    little-endian layout written above plus common ascii/binary variants
    with float vertex properties and uchar-count int-index face lists."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n_vert = int(next(l.split()[2] for l in header if l.startswith("element vertex")))
        n_face = int(next(l.split()[2] for l in header if l.startswith("element face")))
        vprops = []
        in_vertex = False
        for l in header:
            if l.startswith("element"):
                in_vertex = l.startswith("element vertex")
            elif l.startswith("property") and in_vertex:
                parts = l.split()
                vprops.append((parts[-1], parts[1]))

        type_map = {
            "float": np.float32,
            "float32": np.float32,
            "double": np.float64,
            "uchar": np.uint8,
            "uint8": np.uint8,
            "int": np.int32,
            "uint": np.uint32,
            "short": np.int16,
            "ushort": np.uint16,
        }
        if fmt == "ascii":
            vals = []
            for _ in range(n_vert):
                vals.append(
                    [float(x) for x in f.readline().split()[: len(vprops)]]
                )
            varr = np.asarray(vals)
            names = [p[0] for p in vprops]
            verts = varr[:, [names.index("x"), names.index("y"), names.index("z")]]
            faces = []
            for _ in range(n_face):
                parts = f.readline().split()
                k = int(parts[0])
                idx = [int(x) for x in parts[1 : 1 + k]]
                for i in range(1, k - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
            return verts.astype(np.float32), np.asarray(faces, np.int32)

        vdt = np.dtype([(name, type_map[t]) for name, t in vprops])
        vbuf = np.frombuffer(f.read(vdt.itemsize * n_vert), vdt)
        verts = np.stack(
            [vbuf["x"], vbuf["y"], vbuf["z"]], axis=1
        ).astype(np.float32)
        # face lists: assume uchar count + int32 indices, triangulated fan
        raw = f.read()
        faces = []
        off = 0
        for _ in range(n_face):
            k = raw[off]
            off += 1
            idx = np.frombuffer(raw, np.int32, count=k, offset=off)
            off += 4 * k
            for i in range(1, k - 1):
                faces.append([idx[0], idx[i], idx[i + 1]])
        return verts, np.asarray(faces, np.int32)
