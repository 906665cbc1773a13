"""TSDF fusion (torch, on the device) and marching-tetrahedra mesh extraction
(host numpy / scipy), port of `activegs_tpu/eval/tsdf.py`.

Integration blends one posed RGB-D view into every voxel of a dense grid
(2 cm voxels and 10 cm truncation by default); extraction runs marching
tetrahedra (6 tets a cube) on the host copy of the state, then the
isolated-cluster filter drops small disconnected pieces.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from ..core import geometry as geo


@dataclasses.dataclass(frozen=True)
class TSDFGrid:
    origin: tuple[float, float, float]
    dims: tuple[int, int, int]
    voxel: float
    trunc: float

    @classmethod
    def create(cls, bbox, voxel=0.02, trunc=0.1, margin=0.04):
        bmin = np.asarray(bbox[0], np.float64) - margin
        bmax = np.asarray(bbox[1], np.float64) + margin
        dims = np.ceil((bmax - bmin) / voxel).astype(int) + 1
        return cls(
            origin=tuple(bmin.tolist()),
            dims=tuple(int(d) for d in dims),
            voxel=float(voxel),
            trunc=float(trunc),
        )

    @property
    def num(self):
        return int(np.prod(self.dims))

    def points_on(self, device) -> torch.Tensor:
        """(num, 3) float32 voxel positions, origin + index * voxel rounded
        from float64 as the reference rounds them, in (i, j, k) C order;
        cached per device."""
        cache = self.__dict__.setdefault("_points_on", {})
        key = str(torch.device(device))
        if key not in cache:
            axes = [
                (o + torch.arange(d, dtype=torch.float64, device=device) * self.voxel).float()
                for o, d in zip(self.origin, self.dims)
            ]
            cache[key] = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)
        return cache[key]


@dataclasses.dataclass(frozen=True)
class TSDFState:
    tsdf: torch.Tensor  # (N,) normalized signed distance in [-1, 1]
    weight: torch.Tensor  # (N,)
    color: torch.Tensor  # (N, 3)


def init_state(grid: TSDFGrid, device="cuda") -> TSDFState:
    n = grid.num
    return TSDFState(
        tsdf=torch.ones(n, device=device),
        weight=torch.zeros(n, device=device),
        color=torch.zeros((n, 3), device=device),
    )


def tsdf_state_from_numpy(d, device="cuda") -> TSDFState:
    """State from arrays named like the `TSDFState` fields."""
    return TSDFState(**{f.name: torch.tensor(np.asarray(d[f.name], np.float32), device=device)
                        for f in dataclasses.fields(TSDFState)})


def tsdf_state_to_numpy(state: TSDFState) -> dict:
    return {f.name: getattr(state, f.name).cpu().numpy() for f in dataclasses.fields(state)}


@torch.no_grad()
def integrate(
    state: TSDFState,
    grid: TSDFGrid,
    rgb: torch.Tensor,  # (3, h, w)
    depth: torch.Tensor,  # (h, w), <= 0 invalid
    extrinsic: torch.Tensor,
    intrinsic: torch.Tensor,
    depth_trunc: float = 10.0,
    max_weight: int = 200,
) -> TSDFState:
    """Weighted-average TSDF integration of one posed RGB-D view, on the
    state's device."""
    h, w = depth.shape
    uv, z, front = geo.project_points(grid.points_on(depth.device), extrinsic, intrinsic)
    x = uv[:, 0] * w
    y = uv[:, 1] * h
    ok = front & (x >= 0) & (x < w) & (y >= 0) & (y < h)
    # truncation toward zero, as XLA's float -> int32 conversion
    xi = torch.clamp(x.to(torch.int32), 0, w - 1).long()
    yi = torch.clamp(y.to(torch.int32), 0, h - 1).long()
    d = depth[yi, xi]
    ok &= (d > 0) & (d < depth_trunc)
    sdf = d - z
    ok &= sdf > -grid.trunc
    t_new = torch.clamp(sdf / grid.trunc, -1.0, 1.0)
    c_new = rgb[:, yi, xi].T  # (N, 3)

    w_old = state.weight
    w_add = ok.to(torch.float32)
    w_new = torch.clamp(w_old + w_add, max=max_weight)
    denom = torch.clamp(w_old + w_add, min=1.0)
    tsdf = torch.where(ok, (state.tsdf * w_old + t_new) / denom, state.tsdf)
    color = torch.where(ok[:, None], (state.color * w_old[:, None] + c_new) / denom[:, None], state.color)
    return TSDFState(tsdf=tsdf, weight=w_new, color=color)


# ---------------------------------------------------------------------------
# marching tetrahedra extraction
# ---------------------------------------------------------------------------

# cube corners in (i, j, k) offsets, and a 6-tet decomposition around the
# 0-6 diagonal
_CORNERS = np.array(
    [
        (0, 0, 0),
        (1, 0, 0),
        (1, 1, 0),
        (0, 1, 0),
        (0, 0, 1),
        (1, 0, 1),
        (1, 1, 1),
        (0, 1, 1),
    ]
)
_TETS = np.array(
    [(0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6)]
)
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_EDGE_IDX = {frozenset(e): i for i, e in enumerate(_TET_EDGES)}


def _make_tet_table():
    """Triangles per 4-bit inside-mask, as triples of tet-edge indices —
    derived, not hand-written: 1 or 3 inside vertices give one triangle on
    the three incident crossing edges; 2 inside give a quad split in two.
    (Orientation is not made consistent; the mesh metrics sample points.)"""
    table = {}
    for case in range(1, 15):
        inside = [v for v in range(4) if case >> v & 1]
        outside = [v for v in range(4) if not case >> v & 1]
        if len(inside) == 1:
            v = inside[0]
            table[case] = [tuple(_EDGE_IDX[frozenset((v, o))] for o in outside)]
        elif len(inside) == 3:
            v = outside[0]
            table[case] = [tuple(_EDGE_IDX[frozenset((v, i))] for i in inside)]
        else:
            v, u = inside
            a, b = outside
            e_va = _EDGE_IDX[frozenset((v, a))]
            e_vb = _EDGE_IDX[frozenset((v, b))]
            e_ub = _EDGE_IDX[frozenset((u, b))]
            e_ua = _EDGE_IDX[frozenset((u, a))]
            table[case] = [(e_va, e_vb, e_ub), (e_va, e_ub, e_ua)]
    return table


_TET_TRIS = _make_tet_table()


def extract_mesh(state: TSDFState, grid: TSDFGrid, min_weight: float = 1.0):
    """Marching-tetrahedra iso-surface of tsdf = 0. Returns
    (vertices (V, 3) f32, faces (F, 3) i32, colors (V, 3) f32)."""
    dims = grid.dims
    host = tsdf_state_to_numpy(state)
    tsdf = host["tsdf"].reshape(dims)
    weight = host["weight"].reshape(dims)
    color = host["color"].reshape(dims + (3,))

    # candidate cubes: all 8 corners observed
    valid = weight >= min_weight
    cs = valid[:-1, :-1, :-1]
    for dx, dy, dz in _CORNERS[1:]:
        cs = cs & valid[
            dx : dims[0] - 1 + dx, dy : dims[1] - 1 + dy, dz : dims[2] - 1 + dz
        ]
    base = np.argwhere(cs)  # (C, 3)
    if len(base) == 0:
        return (
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.int32),
            np.zeros((0, 3), np.float32),
        )

    corner_vals = np.stack(
        [tsdf[base[:, 0] + c[0], base[:, 1] + c[1], base[:, 2] + c[2]] for c in _CORNERS],
        axis=1,
    )  # (C, 8)
    # skip cubes with no sign change
    sign = corner_vals < 0
    active = sign.any(1) & (~sign).any(1)
    base = base[active]
    corner_vals = corner_vals[active]
    if len(base) == 0:
        return (
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.int32),
            np.zeros((0, 3), np.float32),
        )

    corner_pos = (
        base[:, None, :] + _CORNERS[None]
    ) * grid.voxel + np.asarray(grid.origin)
    corner_col = np.stack(
        [
            color[base[:, 0] + c[0], base[:, 1] + c[1], base[:, 2] + c[2]]
            for c in _CORNERS
        ],
        axis=1,
    )

    verts_out, cols_out = [], []
    for tet in _TETS:
        vals = corner_vals[:, tet]  # (C, 4)
        pos = corner_pos[:, tet]
        col = corner_col[:, tet]
        inside = (vals < 0).astype(np.int32)
        case = inside[:, 0] | (inside[:, 1] << 1) | (inside[:, 2] << 2) | (
            inside[:, 3] << 3
        )
        # edge crossing points, lazily per case
        for c, tris in _TET_TRIS.items():
            m = case == c
            if not m.any():
                continue
            vals_m, pos_m, col_m = vals[m], pos[m], col[m]
            edge_pts = {}
            edge_cols = {}
            for ei, (a, b) in enumerate(_TET_EDGES):
                va = vals_m[:, a]
                vb = vals_m[:, b]
                denom = va - vb
                t = np.where(np.abs(denom) > 1e-12, va / np.where(denom == 0, 1, denom), 0.5)
                t = np.clip(t, 0.0, 1.0)[:, None]
                edge_pts[ei] = pos_m[:, a] * (1 - t) + pos_m[:, b] * t
                edge_cols[ei] = col_m[:, a] * (1 - t) + col_m[:, b] * t
            for tri in tris:
                verts_out.append(
                    np.stack([edge_pts[tri[0]], edge_pts[tri[1]], edge_pts[tri[2]]], 1)
                )
                cols_out.append(
                    np.stack([edge_cols[tri[0]], edge_cols[tri[1]], edge_cols[tri[2]]], 1)
                )

    tri_verts = np.concatenate(verts_out).reshape(-1, 3).astype(np.float32)
    tri_cols = np.concatenate(cols_out).reshape(-1, 3).astype(np.float32)

    # weld duplicate vertices (quantized to 1/8 voxel)
    q = np.round(tri_verts / (grid.voxel / 8)).astype(np.int64)
    _, idx, inv = np.unique(q, axis=0, return_index=True, return_inverse=True)
    vertices = tri_verts[idx]
    colors = tri_cols[idx]
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return vertices, faces[good], colors


def filter_isolated(vertices, faces, colors=None, min_tris: int = 50):
    """Remove the faces of connected triangle clusters with fewer than
    `min_tris` faces."""
    if len(faces) == 0:
        return vertices, faces, colors
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    n = len(vertices)
    adj = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    face_label = labels[faces[:, 0]]
    counts = np.bincount(face_label, minlength=labels.max() + 1)
    keep = counts[face_label] >= min_tris
    return vertices, faces[keep], colors
