// Forward tile composite for Hopper (sm_90a).
//
// Replaces: `_fwd_kernel` in activegs_tpu/render/composite_pallas.py
// (launched by `_run_fwd`; differentiable entry `composite_tiled`).
//
// What it computes, per tile of tile_h x tile_w pixels: walk the tile's
// depth-sorted entry segment front to back in chunks of K entries; for each
// (entry, pixel) pair evaluate alpha and the surfel-plane depth, weight
// w = alpha * prod_{earlier}(1 - alpha) * T_chunk_start, and accumulate the
// 7 feature channels (rgb, camera normal, confidence) and depth. The tile
// stops as a whole once max_pixels(T) <= term_eps, checked only between
// chunks; row 9 records the chunks done, which the backward and stats
// replays depend on. One launch may composite several views whose tile
// tables and entry streams were concatenated (`tpv` tiles a view, as the
// reference's `tpv`): tile t is then tile t % tpv of its view's grid.
//
// What bounds it on the H100: FP32 CUDA-core arithmetic. A pair costs 50
// operations (a multiply-add counted as 2): 17 for alpha (the conic
// quadratic, clamps, one expf, the cut), 13 for the plane depth (one IEEE
// division), 4 for the weight and the running product, 16 for the 8
// accumulations. An entry's 18 parameter rows (72 bytes) serve the tile's
// 512 pixels from shared memory, 0.14 bytes per pair, so at 67 TFLOP/s
// against 3.35 TB/s the arithmetic, not memory, is the limit.
//
// The first design (one block of 512 threads per tile, every thread walking
// every entry) lost time in two ways:
// - Dead pairs paid full price. A trained surfel covers a few of a tile's
//   16 pixel rows, so most (entry, 32-pixel row) pairs have alpha == 0 at
//   every pixel (55% at a 512x512 keyframe view), yet each paid the depth
//   with its division, the weight and the 8 accumulations: at the card's
//   measured rates two thirds of a pair's cost.
// - Too few blocks. A 128x128 candidate render is 32 tiles, so 32 blocks
//   ran on 32 of the 132 SMs; at 512x512, 512 blocks of 512 threads ran in
//   waves of a few blocks per SM, the heaviest tiles on alone at the end.
//
// Design:
// - Exact cull. After alpha, a pixel with alpha == 0 skips the depth, the
//   weight and the accumulations; a warp whose 32 pixels all have
//   alpha == 0 skips them as a whole. This changes no bit of the output.
//   Alpha is either >= alpha_cut or exactly +0 (eval_alpha), so the test
//   alpha > 0 finds every skipped pair at +0. There w = +0 * excl * trans =
//   +0 (both factors finite and >= 0); each feature product f * w is +-0,
//   and so is w * t, because t is finite: the plane depth is clamped to
//   [depth_lo, depth_hi] * dz, or is dz. A sum that starts at +0 never
//   becomes -0 (x + -0 == x, and +0 + -0 == +0), so adding +-0 leaves
//   every accumulator's bits as they were; and excl *= 1 - 0 is the
//   identity. Every pixel's sequence of operations on its live pairs is the
//   first design's, in the same order (`tests/test_torch_fwd_cull.py`
//   shows the invariant on the CPU).
// - Cluster split. A tile is rendered by a thread-block cluster of C blocks
//   (C = 4 for the default 16x32 tile): block `rank` owns the tile's
//   row-major pixels [rank * P / C, (rank + 1) * P / C), one thread per
//   pixel, whole warps and at most 512 threads a block (`splits`), so a
//   128x128 candidate is 128 blocks and a 512x512 view 2048 blocks of 128
//   threads. A 32x32 tile is 4 blocks of 256 threads (8 pixel rows each),
//   a 16x16 tile 4 blocks of 64 and an 8x16 tile 4 blocks of one warp;
//   where tile_w is 16 a warp spans two pixel rows, which changes nothing
//   below: the cull tests alpha, not the geometry. Each block stages the
//   chunk's 18 rows into its own shared memory (the view's entries stay
//   resident in the 50 MB L2). Nothing is summed across blocks: every
//   output pixel belongs to one thread.
// - The stop stays tile-wide and exact. At each chunk boundary a block
//   takes __syncthreads_or(trans > term_eps) over its rows and writes the
//   bit into one of two flag slots of its shared memory (by chunk parity);
//   a cluster barrier (release/acquire) publishes the C bits, and every
//   warp reads them through distributed shared memory and ORs them, so all
//   C blocks stop at the same chunk and write the same row 9. A slot is
//   written again two chunks later, after the next cluster barrier, which
//   no block passes before every sibling has read it; a final cluster
//   barrier keeps each block alive until its siblings are done reading.
// - Latency. With C = 4 a 128x128 candidate has one warp per SM
//   sub-partition, so each warp's own chain of dependent instructions per
//   entry sets the time. A chunk is staged entry by entry, 20 floats
//   apart, each thread loading one entry's 18 rows at once; an entry's
//   rows are read as 16-byte vectors (2 for alpha, 5 for a live pair); and
//   the alphas of 8 entries are evaluated before any of them is
//   composited, so their chains overlap. Compositing then walks the 8 in
//   order, so each pixel's sequence of operations is unchanged.
// One compiled kernel serves every C: the launch gives the cluster size as
// a launch attribute (cudaLaunchKernelEx). Arithmetic is that of the first
// design: -fmad=false, IEEE division, expf, and the op order of
// eval_alpha / eval_depth and of the accumulations. No atomics: every
// output belongs to one thread.
//
// Build at the default tile, K = 128, C = 4 (composite_fwd_occupancy on an
// NVIDIA H100 80GB HBM3): 64 registers and 8 local bytes a thread (the
// stack of the division's slow-path call; nothing spills), 10256 shared
// bytes a block, 248 clusters at once, 7.52 blocks of 128 threads per SM.
//
// What bounds it now (chip_smoke.py on that card): at 128x128, the latency
// of each warp's own chain of dependent instructions. There is one warp
// per sub-partition, and the heaviest tile's 9216 entries take about 255
// cycles each. At 512x512, with about 7.5 warps a sub-partition, the
// kernel's device time is 1.7x the live-work bound at the card's measured
// rates: alpha on every pair, the rest on pairs of live rows.
//
// The bf16 instance (`composite_fwd_bf16_launch`, RasterConfig.bf16_pairs;
// the reference's bf16 branch of `_fwd_kernel`, composite_pallas.py:238-248)
// is the same kernel with the pair math of the rounding contract in
// render/composite.py: alpha in bf16 (`alpha_bf16`), w = bf16(bf16(alpha *
// bf16(excl)) * bf16(T)), the features rounded to bf16, the sums, the
// depth, the in-chunk product and T in float32. It is scalar, one pixel a
// thread: a scalar bf16 instruction costs what a packed one does, and each
// bf16/f32 seam adds a conversion, so it does more instructions than the
// f32 instance. Packing two pixels a thread (`__nv_bfloat162`) is left to a
// redesign. The cull stays exact: a pair with bf16 alpha == 0 has w = +0.
#include <cooperative_groups.h>

#include "composite_common.cuh"

namespace cg = cooperative_groups;

namespace composite {

constexpr int kStride = 20;  // floats a staged entry takes: rows 0..17 and 2 of padding
constexpr int kVecs = kStride / 4;
constexpr int kGroup = 8;    // entries whose alphas are evaluated together
constexpr int kMaxBlockThreads = 512;  // the kernel's launch bounds (`splits`)

// Stage rows 0..17 of chunk `chunk` entry by entry, entry k's rows at
// sh[k * kVecs .. + kVecs) (16-byte aligned; the rows of one thread's
// entry are loaded at once, coalesced across the block's threads). The
// caller synchronizes before and after.
__device__ __forceinline__ void stage_chunk(float4* sh, const float* __restrict__ entries,
                                            long long e_total, int start, int chunk, int kchunk) {
  const float* src = entries + start + (long long)chunk * kchunk;
  for (int k = threadIdx.x; k < kchunk; k += blockDim.x) {
    float v[kStride];
#pragma unroll
    for (int r = 0; r < kUsedRows; ++r) v[r] = src[(long long)r * e_total + k];
    v[kUsedRows] = v[kUsedRows + 1] = 0.0f;
#pragma unroll
    for (int q = 0; q < kVecs; ++q)
      sh[k * kVecs + q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// Entries [k0, k0 + G) of the staged chunk, for this thread's pixel: the G
// alphas first (independent, so their latencies overlap), then in entry
// order, where alpha > 0, the depth, the weight and the accumulations; excl
// takes every entry. eval_alpha / eval_depth read the entry's rows from
// registers (kchunk = 1, k = 0). BF16: bf16 pair math, where `trans` holds
// the chunk's starting T rounded to bf16; w = bf16(bf16(alpha * bf16(excl))
// * T), the features rounded to bf16, the products w * f (exact) and w * t
// summed in float32, and excl (float32) times bf16(1 - alpha). A pair with
// alpha == 0 still adds exactly nothing: w = +0.
template <int G, bool BF16>
__device__ __forceinline__ void composite_entries(const float4* sh, int k0, const Tile& tl,
                                                  const Cfg& cfg, float trans, float& excl,
                                                  float* acc) {
  float alpha[G];
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const float4 a = sh[(k0 + u) * kVecs], b = sh[(k0 + u) * kVecs + 1];
    const float e[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const float dx = tl.px - e[kMeanX];
    const float dy = tl.py - e[kMeanY];
    float ex;
    if constexpr (BF16)
      alpha[u] = alpha_bf16(e[kConA], e[kConB], e[kConC], e[kOpac], dx, dy, cfg, &ex);
    else
      alpha[u] = eval_alpha(e, 1, 0, dx, dy, cfg, &ex);
  }
#pragma unroll
  for (int u = 0; u < G; ++u) {
    if (alpha[u] > 0.0f) {
      float e[kStride];
#pragma unroll
      for (int q = 0; q < kVecs; ++q) {
        const float4 v = sh[(k0 + u) * kVecs + q];
        e[4 * q] = v.x, e[4 * q + 1] = v.y, e[4 * q + 2] = v.z, e[4 * q + 3] = v.w;
      }
      const PlaneDepth d = eval_depth(e, 1, 0, tl.px, tl.py, cfg);
      if constexpr (BF16) {
        const float w = mul_bf16(mul_bf16(alpha[u], round_bf16(excl)), trans);
#pragma unroll
        for (int c = 0; c < 6; ++c) acc[c] += round_bf16(e[kColR + c]) * w;
        acc[6] += round_bf16(e[kConf]) * w;
        acc[7] += w * d.t;
      } else {
        const float w = alpha[u] * excl * trans;
#pragma unroll
        for (int c = 0; c < 6; ++c) acc[c] += e[kColR + c] * w;
        acc[6] += e[kConf] * w;
        acc[7] += w * d.t;
      }
    }
    if constexpr (BF16)
      excl *= one_minus_bf16(alpha[u]);
    else
      excl *= 1.0f - alpha[u];
  }
}

// BF16: the bf16 pair-math instance (composite_entries); T across chunks
// stays float32, times each chunk's total product rounded to bf16.
template <bool BF16>
__global__ void __launch_bounds__(kMaxBlockThreads)
fwd_kernel(const float* __restrict__ entries, long long e_total,
           const int* __restrict__ tile_start, const int* __restrict__ tile_len,
           float* __restrict__ out, int tpv, int ntx, int tile_w, int tile_h, int kchunk, Cfg cfg) {
  extern __shared__ float4 sh[];  // [kchunk][kVecs]
  __shared__ int above[2];       // by chunk parity: some pixel of this block has T > term_eps
  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = (int)cluster.num_blocks();
  const int tile = blockIdx.x / nsplit;
  const int npix = tile_w * tile_h;
  const int p = (int)cluster.block_rank() * blockDim.x + threadIdx.x;
  const Tile tl = tile_of(tile_start, tile_len, tile, p, tpv, ntx, tile_w, tile_h, kchunk);
  const int lane = threadIdx.x & 31;

  float trans = 1.0f;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // r g b nx ny nz conf depth
  int i = 0;
  for (; i < tl.nch; ++i) {
    // the block's bit; the barrier also orders the previous chunk's shared
    // reads before this chunk's loads
    const int mine = __syncthreads_or(trans > cfg.term_eps);
    if (threadIdx.x == 0) above[i & 1] = mine;
    cluster.sync();
    const bool go = __any_sync(0xffffffffu,
                               lane < nsplit && *cluster.map_shared_rank(&above[i & 1], lane) != 0);
    if (!go) break;
    stage_chunk(sh, entries, e_total, tl.start, i, kchunk);
    __syncthreads();
    float excl = 1.0f;
    const float t_chunk = BF16 ? round_bf16(trans) : trans;
    int k = 0;
    for (; k + kGroup <= kchunk; k += kGroup)
      composite_entries<kGroup, BF16>(sh, k, tl, cfg, t_chunk, excl, acc);
    for (; k < kchunk; ++k) composite_entries<1, BF16>(sh, k, tl, cfg, t_chunk, excl, acc);
    trans *= BF16 ? round_bf16(excl) : excl;
  }
  // no block leaves while a sibling may still read its flags
  cluster.sync();

  float* o = out + (long long)tile * kOutRows * npix + p;
#pragma unroll
  for (int c = 0; c < 6; ++c) o[c * npix] = acc[c];
  o[6 * npix] = acc[7];
  o[7 * npix] = acc[6];
  o[8 * npix] = trans;
  o[9 * npix] = (float)i;
#pragma unroll
  for (int r = 10; r < kOutRows; ++r) o[r * npix] = 0.0f;
}

// The launch of `num_tiles` tiles, a cluster of `cluster` blocks each.
// `attr` holds the cluster dimension the config points at.
inline cudaLaunchConfig_t launch_config(int num_tiles, int cluster, int npix, int smem,
                                        cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(num_tiles * cluster);
  lc.blockDim = dim3(npix / cluster);
  lc.dynamicSmemBytes = smem;
  lc.stream = stream;
  lc.attrs = attr;
  lc.numAttrs = 1;
  return lc;
}

// the staged chunk; raises the kernel's dynamic shared memory limit to it
template <bool BF16>
inline cudaError_t chunk_smem(int kchunk, int* smem) {
  *smem = kStride * kchunk * (int)sizeof(float);
  return cudaFuncSetAttribute(fwd_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

// A cluster of `cluster` blocks splits the tile's pixels into equal runs of
// whole warps, at most kMaxBlockThreads each (composite.fwd_cluster_size
// picks the largest such cluster of 4, 2, 1).
inline bool splits(int cluster, int tile_w, int tile_h) {
  const int npix = tile_w * tile_h;
  return cluster >= 1 && npix % cluster == 0 && (npix / cluster) % 32 == 0 &&
         npix / cluster <= kMaxBlockThreads;
}

template <bool BF16>
int launch(const float* entries, long long e_total, const int* tile_start, const int* tile_len,
           float* out, int num_tiles, int tpv, int cluster, int ntx, int tile_w, int tile_h,
           int kchunk, const Cfg& cfg, void* stream) {
  if (!splits(cluster, tile_w, tile_h)) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  if (tpv <= 0 || num_tiles % tpv != 0) return (int)cudaErrorInvalidValue;
  int smem;
  cudaError_t err = chunk_smem<BF16>(kchunk, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t lc =
      launch_config(num_tiles, cluster, tile_w * tile_h, smem, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&lc, fwd_kernel<BF16>, entries, e_total, tile_start, tile_len, out, tpv,
                           ntx, tile_w, tile_h, kchunk, cfg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace composite

// `cluster` blocks render each tile, each P / cluster consecutive pixels
// of its row-major P = tile_w * tile_h (`splits`).
// The `num_tiles` tiles are views of `tpv` tiles each (tpv divides
// num_tiles; tpv = num_tiles for one view).
extern "C" int composite_fwd_launch(const float* entries, long long e_total,
                                    const int* tile_start, const int* tile_len, float* out,
                                    int num_tiles, int tpv, int cluster, int ntx, int tile_w,
                                    int tile_h, int kchunk, float alpha_cut, float alpha_max,
                                    float term_eps, float depth_lo, float depth_hi, void* stream) {
  return composite::launch<false>(entries, e_total, tile_start, tile_len, out, num_tiles, tpv,
                                  cluster, ntx, tile_w, tile_h, kchunk,
                                  {alpha_cut, alpha_max, term_eps, depth_lo, depth_hi}, stream);
}

// The bf16 pair-math instance (RasterConfig.bf16_pairs), with the same
// arguments; `alpha_max` comes rounded to bf16.
extern "C" int composite_fwd_bf16_launch(const float* entries, long long e_total,
                                         const int* tile_start, const int* tile_len, float* out,
                                         int num_tiles, int tpv, int cluster, int ntx, int tile_w,
                                         int tile_h, int kchunk, float alpha_cut, float alpha_max,
                                         float term_eps, float depth_lo, float depth_hi,
                                         void* stream) {
  return composite::launch<true>(entries, e_total, tile_start, tile_len, out, num_tiles, tpv,
                                 cluster, ntx, tile_w, tile_h, kchunk,
                                 {alpha_cut, alpha_max, term_eps, depth_lo, depth_hi}, stream);
}

// What the build gives the kernel at this tile size, K and cluster size:
// registers and local (spill) bytes a thread, shared bytes a block (the
// staged chunk and the stop flags), and the clusters of that size the GPU
// holds at once (the CUDA occupancy query).
extern "C" int composite_fwd_occupancy(int tile_w, int tile_h, int kchunk, int cluster,
                                       int* registers, int* local_bytes, int* smem_bytes,
                                       int* active_clusters) {
  if (!composite::splits(cluster, tile_w, tile_h)) return (int)cudaErrorInvalidValue;
  int smem;
  cudaError_t err = composite::chunk_smem<false>(kchunk, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, composite::fwd_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  *registers = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  *smem_bytes = smem + (int)fa.sharedSizeBytes;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t lc =
      composite::launch_config(1, cluster, tile_w * tile_h, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(active_clusters, composite::fwd_kernel<false>, &lc);
}

COMPOSITE_EXPORT_ERRSTR(composite_fwd)
