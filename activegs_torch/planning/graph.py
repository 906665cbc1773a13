"""Roadmap over traversable voxels (the port's own copy of
`activegs_tpu/planning/graph.py`).

The A* (`planning/astar.py`, `planning/csrc/astar.cpp`) walks the dense
traversability mask directly with implicit 26-connectivity, so the graph
holds only that mask. This class keeps the update_graph(mask) lifecycle and
exposes change tracking and edge counting for introspection and tests.
"""

from __future__ import annotations

import numpy as np


class VoxelGraph:
    def __init__(self, voxel_size, dim):
        self.voxel_size = np.asarray(voxel_size, np.float64)
        self.dim = tuple(int(d) for d in dim)
        self.traversable = np.zeros(self.dim, bool)
        self._initialized = False
        self.last_added = 0
        self.last_removed = 0

    def update_graph(self, traversable_mask: np.ndarray) -> None:
        """`update_graph` (`voxel_map.py:463-485`): record the new
        traversable set; track free<->occupied transitions."""
        new = np.asarray(traversable_mask, bool).reshape(self.dim)
        if self._initialized:
            self.last_added = int((~self.traversable & new).sum())
            self.last_removed = int((self.traversable & ~new).sum())
        else:
            self.last_added = int(new.sum())
            self.last_removed = 0
            self._initialized = True
        self.traversable = new

    def num_nodes(self) -> int:
        return int(self.traversable.sum())

    def num_edges(self) -> int:
        """Count of undirected 26-neighbor edges between traversable voxels
        (the dense_graph edge set of the reference)."""
        t = self.traversable
        count = 0
        offsets = [
            (x, y, z)
            for x in (-1, 0, 1)
            for y in (-1, 0, 1)
            for z in (-1, 0, 1)
            if (x, y, z) > (0, 0, 0)
        ]
        for ox, oy, oz in offsets:
            a = t[
                max(0, -ox) : t.shape[0] - max(0, ox),
                max(0, -oy) : t.shape[1] - max(0, oy),
                max(0, -oz) : t.shape[2] - max(0, oz),
            ]
            b = t[
                max(0, ox) : t.shape[0] + min(0, ox) or None,
                max(0, oy) : t.shape[1] + min(0, oy) or None,
                max(0, oz) : t.shape[2] + min(0, oz) or None,
            ]
            count += int((a & b).sum())
        return count

    def neighbors(self, ijk):
        """Adjacency query (the reference's dense_graph[node]):
        (neighbor ijk, metric distance) pairs."""
        ijk = np.asarray(ijk)
        out = []
        for ox in (-1, 0, 1):
            for oy in (-1, 0, 1):
                for oz in (-1, 0, 1):
                    if not (ox or oy or oz):
                        continue
                    nb = ijk + (ox, oy, oz)
                    if np.any(nb < 0) or np.any(nb >= self.dim):
                        continue
                    if self.traversable[tuple(nb)]:
                        d = float(
                            np.linalg.norm(np.array([ox, oy, oz]) * self.voxel_size)
                        )
                        out.append((tuple(int(v) for v in nb), d))
        return out
