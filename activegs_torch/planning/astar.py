"""Multi-goal A* / Dijkstra over the traversability voxel grid, host side
(port of `activegs_tpu/planning/astar.py`).

Shortest paths on the dense free-space mask with implicit 26-connectivity.
The C++ search (`csrc/astar.cpp`, built and loaded by `native.py`) is the
path the planner takes; the pure numpy + heapq search runs only when the
caller passes `use_native=False`, and is the tests' reference.
"""

from __future__ import annotations

import heapq

import numpy as np

from .native import native_search_goal

_OFFSETS = np.array(
    [
        (x, y, z)
        for x in (-1, 0, 1)
        for y in (-1, 0, 1)
        for z in (-1, 0, 1)
        if (x, y, z) != (0, 0, 0)
    ],
    np.int32,
)


def search_goal(
    start_xyz: np.ndarray,
    goals_xyz: np.ndarray,
    traversable: np.ndarray,  # (dx, dy, dz) bool
    bbox_min: np.ndarray,
    voxel_size: np.ndarray,
    use_native: bool = True,
):
    """Single-source multi-goal A* (`planning/utils.py:80-150`).

    Heuristic: straight-line distance to the nearest goal. Returns
    (paths, lengths): per goal a list of ijk waypoints (empty + inf when
    unreachable).
    """
    dim = np.asarray(traversable.shape)
    start = np.floor((start_xyz - bbox_min) / voxel_size).astype(np.int64)
    goals = np.floor((goals_xyz - bbox_min) / voxel_size).astype(np.int64)

    if use_native:
        return native_search_goal(start, goals, traversable, voxel_size)

    step_len = np.linalg.norm(_OFFSETS * voxel_size, axis=1)
    centers = lambda ijk: bbox_min + (np.asarray(ijk) + 0.5) * voxel_size

    def in_bounds(ijk):
        return np.all(ijk >= 0) and np.all(ijk < dim)

    start_t = tuple(int(v) for v in start)
    if not in_bounds(start) or not traversable[start_t]:
        return [[] for _ in goals], [float("inf")] * len(goals)

    goal_set = {
        tuple(int(v) for v in g)
        for g in goals
        if in_bounds(g) and traversable[tuple(int(v) for v in g)]
    }
    goal_centers = centers(goals)

    dist = {start_t: 0.0}
    parents = {start_t: None}
    found = {}
    pq = [(0.0, 0.0, start_t)]
    while pq and goal_set:
        f, g_at_push, node = heapq.heappop(pq)
        base = dist[node]
        if g_at_push > base:  # stale entry: node relaxed since this push
            continue
        if node in goal_set:
            goal_set.remove(node)
            found[node] = base
            if not goal_set:
                break
        narr = np.asarray(node) + _OFFSETS
        ok = np.all(narr >= 0, 1) & np.all(narr < dim, 1)
        for off_i in np.nonzero(ok)[0]:
            nb = tuple(int(v) for v in narr[off_i])
            if not traversable[nb]:
                continue
            g = base + step_len[off_i]
            if g < dist.get(nb, np.inf):
                dist[nb] = g
                parents[nb] = node
                c = centers(nb)
                h = float(np.min(np.linalg.norm(goal_centers - c, axis=1)))
                heapq.heappush(pq, (g + h, g, nb))

    paths, lengths = [], []
    for g in goals:
        gt = tuple(int(v) for v in g)
        if gt in found:
            path = []
            node = gt
            while node is not None:
                path.append(node)
                node = parents[node]
            paths.append(path[::-1])
            lengths.append(found[gt])
        else:
            paths.append([])
            lengths.append(float("inf"))
    return paths, lengths


def search_range(
    start_xyz: np.ndarray,
    plan_range: float,
    traversable: np.ndarray,
    bbox_min: np.ndarray,
    voxel_size: np.ndarray,
):
    """Dijkstra flood within a metric range (`planning/utils.py:153-199`).
    Returns (indices (M, 3), distances (M,))."""
    dim = np.asarray(traversable.shape)
    start = tuple(
        int(v) for v in np.floor((start_xyz - bbox_min) / voxel_size).astype(np.int64)
    )
    if not (all(0 <= start[i] < dim[i] for i in range(3)) and traversable[start]):
        return np.zeros((0, 3), np.int64), np.zeros((0,))
    step_len = np.linalg.norm(_OFFSETS * voxel_size, axis=1)
    dist = {start: 0.0}
    pq = [(0.0, start)]
    while pq:
        d, node = heapq.heappop(pq)
        if d > dist[node]:
            continue
        narr = np.asarray(node) + _OFFSETS
        ok = np.all(narr >= 0, 1) & np.all(narr < dim, 1)
        for off_i in np.nonzero(ok)[0]:
            nb = tuple(int(v) for v in narr[off_i])
            if not traversable[nb]:
                continue
            nd = d + step_len[off_i]
            if nd <= plan_range and nd < dist.get(nb, np.inf):
                dist[nb] = nd
                heapq.heappush(pq, (nd, nb))
    idx = np.array(list(dist.keys()), np.int64)
    return idx, np.array(list(dist.values()))
