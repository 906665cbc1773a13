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
// chunks (__syncthreads_or); row 9 records the chunks done, which the
// backward and stats replays depend on.
//
// What bounds it on the H100: FP32 CUDA-core arithmetic. A pair costs 50
// operations (a multiply-add counted as 2): 17 for alpha (the conic
// quadratic, clamps, one expf, the cut), 13 for the plane depth (one IEEE
// division), 4 for the weight and the running product, 16 for the 8
// accumulations. An entry's 18 parameter rows (72 bytes) serve the tile's
// 512 pixels from shared memory, 0.14 bytes per pair, so at 67 TFLOP/s
// against 3.35 TB/s the arithmetic, not memory, is the limit.
//
// Design: one block per tile, one thread per pixel (512 threads for the
// 16x32 tile). Each chunk's 18 used parameter rows are staged in shared
// memory with coalesced loads; every thread then walks the chunk's entries
// in order keeping its transmittance in a register, so the TPU's
// prefix-product scan becomes a sequential per-pixel product. The per-pixel
// accumulators stay in registers; the output rows are written once,
// coalesced. No atomics: every output belongs to one tile.
#include "composite_common.cuh"

namespace composite {

__global__ void __launch_bounds__(512)
fwd_kernel(const float* __restrict__ entries, long long e_total,
           const int* __restrict__ tile_start, const int* __restrict__ tile_len,
           float* __restrict__ out, int ntx, int tile_w, int tile_h, int kchunk, Cfg cfg) {
  extern __shared__ float sh[];  // [kUsedRows][kchunk]
  const Tile tl = tile_of(tile_start, tile_len, ntx, tile_w, tile_h, kchunk);
  const int npix = blockDim.x;
  const int p = threadIdx.x;

  float trans = 1.0f;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // r g b nx ny nz conf depth
  int i = 0;
  // the barrier also orders the previous chunk's shared reads before the
  // next chunk's loads
  while (i < tl.nch && __syncthreads_or(trans > cfg.term_eps)) {
    load_chunk(sh, entries, e_total, tl.start, i, kchunk);
    __syncthreads();
    float excl = 1.0f;
    for (int k = 0; k < kchunk; ++k) {
      const float dx = tl.px - sh[kMeanX * kchunk + k];
      const float dy = tl.py - sh[kMeanY * kchunk + k];
      float ex;
      const float alpha = eval_alpha(sh, kchunk, k, dx, dy, cfg, &ex);
      const PlaneDepth d = eval_depth(sh, kchunk, k, tl.px, tl.py, cfg);
      const float w = alpha * excl * trans;
#pragma unroll
      for (int c = 0; c < 6; ++c) acc[c] += sh[(kColR + c) * kchunk + k] * w;
      acc[6] += sh[kConf * kchunk + k] * w;
      acc[7] += w * d.t;
      excl *= 1.0f - alpha;
    }
    trans *= excl;
    ++i;
  }

  float* o = out + (long long)blockIdx.x * kOutRows * npix + p;
#pragma unroll
  for (int c = 0; c < 6; ++c) o[c * npix] = acc[c];
  o[6 * npix] = acc[7];
  o[7 * npix] = acc[6];
  o[8 * npix] = trans;
  o[9 * npix] = (float)i;
#pragma unroll
  for (int r = 10; r < kOutRows; ++r) o[r * npix] = 0.0f;
}

}  // namespace composite

extern "C" int composite_fwd_launch(const float* entries, long long e_total,
                                    const int* tile_start, const int* tile_len, float* out,
                                    int num_tiles, int ntx, int tile_w, int tile_h, int kchunk,
                                    float alpha_cut, float alpha_max, float term_eps,
                                    float depth_lo, float depth_hi, void* stream) {
  if (num_tiles == 0) return 0;
  const composite::Cfg cfg{alpha_cut, alpha_max, term_eps, depth_lo, depth_hi};
  const int smem = composite::kUsedRows * kchunk * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      composite::fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  composite::fwd_kernel<<<num_tiles, tile_w * tile_h, smem, (cudaStream_t)stream>>>(
      entries, e_total, tile_start, tile_len, out, ntx, tile_w, tile_h, kchunk, cfg);
  return (int)cudaGetLastError();
}

COMPOSITE_EXPORT_ERRSTR(composite_fwd)
