// Shared pieces of the three tile-compositor kernels (composite_fwd.cu,
// composite_bwd.cu, composite_stats.cu).
//
// Layout: `entries` is (PARAM_DIM = 24, E) row-major float32; each tile's
// entries form a depth-sorted segment [tile_start, tile_start + tile_len)
// starting at a multiple of K. One thread renders one pixel of a tile of
// P = tile_h * tile_w pixels (`tile_of`); the forward kernel
// splits a tile's pixel rows over a thread-block cluster, the backward and
// stats kernels run one block per tile. Each kernel stages a K-entry
// chunk's parameter rows in shared memory entry by entry, and every thread
// then reads the same entry at once (a broadcast).
//
// Arithmetic is strict float32 (no fast-math), with IEEE division, in the
// op order of activegs_torch/render/preprocess.py::eval_alpha_depth_cols.
// Each kernel also has an instance for bf16 pair math
// (RasterConfig.bf16_pairs), which rounds where the rounding contract of
// activegs_torch/render/composite.py says, with explicit bf16 intrinsics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace composite {

constexpr int kUsedRows = 18;  // entry rows 0..17 carry parameters
constexpr int kOutRows = 16;

// entry rows (render/types.py)
constexpr int kMeanX = 0, kMeanY = 1, kConA = 2, kConB = 3, kConC = 4, kOpac = 5;
constexpr int kColR = 6, kNrmX = 9, kPlaneA = 12, kPlaneB = 13, kPlaneC = 14;
constexpr int kPlaneD = 15, kConf = 16, kDepthZ = 17;

// exp(power) floored at exp(-80) < 1e-34, far below any alpha cut (as in
// preprocess.POWER_FLOOR: outputs are unchanged)
constexpr float kPowerFloor = -80.0f;

struct Cfg {
  float alpha_cut, alpha_max, term_eps, depth_lo, depth_hi;
};

struct Tile {
  int start, nch;  // segment start, number of K-chunks
  float px, py;    // this thread's pixel center
};

// Tile `tile`'s segment and the center of its pixel `pix` (0 .. P-1,
// row-major in the tile). The grid holds views of `tpv` tiles each, one
// after another (a single view: tpv = the tile count), and the pixel lies
// in tile tile % tpv of its view's ntx-wide tile grid.
__device__ __forceinline__ Tile tile_of(const int* __restrict__ tile_start,
                                              const int* __restrict__ tile_len, int tile, int pix,
                                              int tpv, int ntx, int tile_w, int tile_h, int kchunk) {
  Tile tl;
  tl.start = tile_start[tile];
  tl.nch = (tile_len[tile] + kchunk - 1) / kchunk;
  const int vt = tile % tpv;
  tl.px = (float)((vt % ntx) * tile_w + pix % tile_w) + 0.5f;
  tl.py = (float)((vt / ntx) * tile_h + pix / tile_w) + 0.5f;
  return tl;
}

// alpha = min(alpha_max, op * exp(clamp(power, -80, 0))), zeroed below alpha_cut.
// Pad entries are zero rows and give alpha = 0. `ex` returns exp(min(0, power)).
__device__ __forceinline__ float eval_alpha(const float* sh, int kchunk, int k, float dx,
                                            float dy, const Cfg& c, float* ex) {
  const float ca = sh[kConA * kchunk + k];
  const float cb = sh[kConB * kchunk + k];
  const float cc = sh[kConC * kchunk + k];
  const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
  *ex = expf(fminf(fmaxf(power, kPowerFloor), 0.0f));
  const float a = fminf(sh[kOpac * kchunk + k] * *ex, c.alpha_max);
  return a >= c.alpha_cut ? a : 0.0f;
}

// Surfel-plane depth t = D * (1 / (A u + B v + C)) clamped to
// [depth_lo, depth_hi] * dz, dz where the plane is edge-on. Also returns
// 1/denom, the raw t and whether the clamp is inactive (`inside`).
struct PlaneDepth {
  float t, inv_denom, t_raw;
  bool inside;
};

__device__ __forceinline__ PlaneDepth eval_depth(const float* sh, int kchunk, int k, float px,
                                                 float py, const Cfg& c) {
  const float denom = sh[kPlaneA * kchunk + k] * px + sh[kPlaneB * kchunk + k] * py +
                      sh[kPlaneC * kchunk + k];
  const float dz = sh[kDepthZ * kchunk + k];
  const bool ok = fabsf(denom) > 1e-8f;
  PlaneDepth d;
  d.inv_denom = 1.0f / (ok ? denom : 1.0f);
  d.t_raw = sh[kPlaneD * kchunk + k] * d.inv_denom;
  const float lo = c.depth_lo * dz;
  const float hi = c.depth_hi * dz;
  d.t = ok ? fminf(fmaxf(d.t_raw, lo), hi) : dz;
  d.inside = ok && d.t_raw > lo && d.t_raw < hi;
  return d;
}

// ---- bf16 pair math ----
// Pair values in bf16 are carried as floats that hold bf16 values; each
// rounded step is a bf16 intrinsic (__hmul, __hadd, __hsub: one rounding,
// as PyTorch's CPU bf16 arithmetic gives) or __float2bfloat16_rn.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ bf16 to_bf16(float x) { return __float2bfloat16_rn(x); }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
// x rounded to bf16, as a float
__device__ __forceinline__ float round_bf16(float x) { return to_f32(to_bf16(x)); }
// bf16(1 - a) for a bf16 value a
__device__ __forceinline__ float one_minus_bf16(float a) { return to_f32(__hsub(to_bf16(1.0f), to_bf16(a))); }
// bf16(a * b) for bf16 values a, b
__device__ __forceinline__ float mul_bf16(float a, float b) { return to_f32(__hmul(to_bf16(a), to_bf16(b))); }

// eval_alpha in bf16 pair math: dx, dy (formed in float32) and the conic
// and opacity rounded to bf16, every product and sum of the power rounded,
// expf on the bf16 power rounded once, op * exp rounded, then the clamp at
// c.alpha_max (which the launch passes rounded to bf16) and the cut on the
// value. Returns alpha and `ex` as floats holding bf16 values.
__device__ __forceinline__ float alpha_bf16(float ca, float cb, float cc, float op, float dx,
                                            float dy, const Cfg& c, float* ex) {
  const bf16 x = to_bf16(dx), y = to_bf16(dy);
  const bf16 quad = __hadd(__hmul(__hmul(to_bf16(ca), x), x), __hmul(__hmul(to_bf16(cc), y), y));
  const bf16 power = __hsub(__hmul(to_bf16(-0.5f), quad), __hmul(__hmul(to_bf16(cb), x), y));
  const bf16 e = to_bf16(expf(fminf(fmaxf(to_f32(power), kPowerFloor), 0.0f)));
  *ex = to_f32(e);
  const float a = fminf(to_f32(__hmul(to_bf16(op), e)), c.alpha_max);
  return a >= c.alpha_cut ? a : 0.0f;
}

}  // namespace composite

#define COMPOSITE_EXPORT_ERRSTR(name)                                 \
  extern "C" const char* name##_errstr(int code) {                    \
    return cudaGetErrorString(static_cast<cudaError_t>(code));        \
  }
