// Multi-goal A* over a dense traversability voxel grid.
//
// The port's copy of native/astar.cpp, the fast path of
// activegs_torch.planning.astar: 26-connected shortest paths from one start
// to up to N goal voxels, heuristic = straight-line distance to the nearest
// goal. Exposed through a C ABI and loaded with ctypes.
//
// Build (planning/native.py does it at first use):
//   g++ -O3 -shared -fPIC -o libastar.so astar.cpp

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

namespace {

struct HeapItem {
  double f;
  int64_t node;
  bool operator<(const HeapItem& o) const { return f > o.f; }  // min-heap
};

}  // namespace

extern "C" {

// Returns number of goals reached. Paths are written as ijk triples
// (int64), at most path_cap waypoints per goal, front-to-back.
int astar_multi_goal(const uint8_t* traversable, int64_t dx, int64_t dy,
                     int64_t dz, const int64_t* start, const int64_t* goals,
                     int64_t n_goals, const double* voxel_size,
                     double* out_lengths, int64_t* out_paths, int64_t path_cap,
                     int64_t* out_path_len) {
  const int64_t n = dx * dy * dz;
  const double inf = std::numeric_limits<double>::infinity();

  for (int64_t g = 0; g < n_goals; ++g) {
    out_lengths[g] = inf;
    out_path_len[g] = 0;
  }

  auto in_bounds = [&](int64_t x, int64_t y, int64_t z) {
    return x >= 0 && x < dx && y >= 0 && y < dy && z >= 0 && z < dz;
  };
  auto lin = [&](int64_t x, int64_t y, int64_t z) {
    return (x * dy + y) * dz + z;
  };

  if (!in_bounds(start[0], start[1], start[2])) return 0;
  const int64_t start_lin = lin(start[0], start[1], start[2]);
  if (!traversable[start_lin]) return 0;

  // 26-neighborhood offsets + metric step lengths
  int64_t offs[26][3];
  double step[26];
  int n_off = 0;
  for (int64_t ox = -1; ox <= 1; ++ox)
    for (int64_t oy = -1; oy <= 1; ++oy)
      for (int64_t oz = -1; oz <= 1; ++oz) {
        if (!ox && !oy && !oz) continue;
        offs[n_off][0] = ox;
        offs[n_off][1] = oy;
        offs[n_off][2] = oz;
        const double sx = ox * voxel_size[0], sy = oy * voxel_size[1],
                     sz = oz * voxel_size[2];
        step[n_off] = std::sqrt(sx * sx + sy * sy + sz * sz);
        ++n_off;
      }

  std::vector<double> dist(n, inf);
  std::vector<int64_t> parent(n, -1);
  std::vector<uint8_t> goal_mark(n, 0);
  std::vector<double> gx(n_goals), gy(n_goals), gz(n_goals);
  int64_t remaining = 0;
  for (int64_t g = 0; g < n_goals; ++g) {
    gx[g] = (goals[3 * g + 0] + 0.5) * voxel_size[0];
    gy[g] = (goals[3 * g + 1] + 0.5) * voxel_size[1];
    gz[g] = (goals[3 * g + 2] + 0.5) * voxel_size[2];
    const int64_t x = goals[3 * g + 0], y = goals[3 * g + 1],
                  z = goals[3 * g + 2];
    if (in_bounds(x, y, z) && traversable[lin(x, y, z)]) {
      if (!goal_mark[lin(x, y, z)]) ++remaining;
      goal_mark[lin(x, y, z)] = 1;
    }
  }

  auto heuristic = [&](int64_t x, int64_t y, int64_t z) {
    const double cx = (x + 0.5) * voxel_size[0];
    const double cy = (y + 0.5) * voxel_size[1];
    const double cz = (z + 0.5) * voxel_size[2];
    double best = inf;
    for (int64_t g = 0; g < n_goals; ++g) {
      const double hx = cx - gx[g], hy = cy - gy[g], hz = cz - gz[g];
      const double d = std::sqrt(hx * hx + hy * hy + hz * hz);
      if (d < best) best = d;
    }
    return best;
  };

  std::priority_queue<HeapItem> pq;
  dist[start_lin] = 0.0;
  pq.push({heuristic(start[0], start[1], start[2]), start_lin});

  int reached = 0;
  while (!pq.empty() && remaining > 0) {
    const HeapItem top = pq.top();
    pq.pop();
    const int64_t node = top.node;
    const int64_t x = node / (dy * dz);
    const int64_t y = (node / dz) % dy;
    const int64_t z = node % dz;
    if (top.f > dist[node] + heuristic(x, y, z) + 1e-9) continue;  // stale
    if (goal_mark[node]) {
      goal_mark[node] = 0;
      --remaining;
      ++reached;
    }
    for (int o = 0; o < n_off; ++o) {
      const int64_t nx = x + offs[o][0], ny = y + offs[o][1],
                    nz = z + offs[o][2];
      if (!in_bounds(nx, ny, nz)) continue;
      const int64_t nl = lin(nx, ny, nz);
      if (!traversable[nl]) continue;
      const double nd = dist[node] + step[o];
      if (nd < dist[nl]) {
        dist[nl] = nd;
        parent[nl] = node;
        pq.push({nd + heuristic(nx, ny, nz), nl});
      }
    }
  }

  for (int64_t g = 0; g < n_goals; ++g) {
    const int64_t x = goals[3 * g + 0], y = goals[3 * g + 1],
                  z = goals[3 * g + 2];
    if (!in_bounds(x, y, z)) continue;
    const int64_t gl = lin(x, y, z);
    if (dist[gl] == inf) continue;
    out_lengths[g] = dist[gl];
    // reconstruct back-to-front, then reverse into out buffer
    std::vector<int64_t> chain;
    for (int64_t node = gl; node != -1; node = parent[node])
      chain.push_back(node);
    int64_t m = static_cast<int64_t>(chain.size());
    if (m > path_cap) m = path_cap;
    out_path_len[g] = m;
    int64_t* dst = out_paths + g * path_cap * 3;
    for (int64_t i = 0; i < m; ++i) {
      const int64_t node = chain[chain.size() - 1 - i];
      dst[3 * i + 0] = node / (dy * dz);
      dst[3 * i + 1] = (node / dz) % dy;
      dst[3 * i + 2] = node % dz;
    }
  }
  return reached;
}

// Dijkstra flood fill within a metric range (`search_range`,
// planning/utils.py:153-199). Writes per-voxel distances (inf where
// unreachable). Returns count of reached voxels.
int64_t dijkstra_range(const uint8_t* traversable, int64_t dx, int64_t dy,
                       int64_t dz, const int64_t* start, double max_range,
                       const double* voxel_size, double* out_dist) {
  const int64_t n = dx * dy * dz;
  const double inf = std::numeric_limits<double>::infinity();
  for (int64_t i = 0; i < n; ++i) out_dist[i] = inf;

  auto in_bounds = [&](int64_t x, int64_t y, int64_t z) {
    return x >= 0 && x < dx && y >= 0 && y < dy && z >= 0 && z < dz;
  };
  auto lin = [&](int64_t x, int64_t y, int64_t z) {
    return (x * dy + y) * dz + z;
  };
  if (!in_bounds(start[0], start[1], start[2])) return 0;
  const int64_t start_lin = lin(start[0], start[1], start[2]);
  if (!traversable[start_lin]) return 0;

  int64_t offs[26][3];
  double step[26];
  int n_off = 0;
  for (int64_t ox = -1; ox <= 1; ++ox)
    for (int64_t oy = -1; oy <= 1; ++oy)
      for (int64_t oz = -1; oz <= 1; ++oz) {
        if (!ox && !oy && !oz) continue;
        offs[n_off][0] = ox;
        offs[n_off][1] = oy;
        offs[n_off][2] = oz;
        const double sx = ox * voxel_size[0], sy = oy * voxel_size[1],
                     sz = oz * voxel_size[2];
        step[n_off++] = std::sqrt(sx * sx + sy * sy + sz * sz);
      }

  std::priority_queue<HeapItem> pq;
  out_dist[start_lin] = 0.0;
  pq.push({0.0, start_lin});
  int64_t reached = 0;
  while (!pq.empty()) {
    const HeapItem top = pq.top();
    pq.pop();
    if (top.f > out_dist[top.node]) continue;
    ++reached;
    const int64_t x = top.node / (dy * dz);
    const int64_t y = (top.node / dz) % dy;
    const int64_t z = top.node % dz;
    for (int o = 0; o < n_off; ++o) {
      const int64_t nx = x + offs[o][0], ny = y + offs[o][1],
                    nz = z + offs[o][2];
      if (!in_bounds(nx, ny, nz)) continue;
      const int64_t nl = lin(nx, ny, nz);
      if (!traversable[nl]) continue;
      const double nd = top.f + step[o];
      if (nd <= max_range && nd < out_dist[nl]) {
        out_dist[nl] = nd;
        pq.push({nd, nl});
      }
    }
  }
  return reached;
}
}  // extern "C"
