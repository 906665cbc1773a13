// Importance / count replay for Hopper (sm_90a).
//
// Replaces: `_stats_kernel` in activegs_tpu/render/composite_pallas.py
// (wrapper `composite_stats`; caller `renderer.render_stats`).
//
// What it computes, per tile: the forward replay with a per-pixel render
// mask and the forward pass's tile-wide early stop. Per entry,
//   importance = sum over the tile's pixels of w * mask,
//   count      = #pixels with w * mask >= weight_thres;
// written for the chunks it replays; the caller passes both outputs zeroed,
// which leaves the chunks the replay never reached at zero.
//
// What bounds it on the H100: FP32 CUDA-core work, 25 operations per pair
// (17 for alpha, 3 for the masked weight, 3 for the two sums and the
// threshold test, 2 for the running product); the design adds two 5-step
// warp-shuffle trees per pair. Memory: 72 bytes read and 8 written per
// entry, 4 bytes of mask per pixel.
//
// Design: one block per tile, one thread per pixel; each chunk's
// parameters are staged in shared memory; the two per-entry sums use warp
// shuffles, then shared memory across the block's warps for the whole
// chunk (2 x K x 16 warps partials); every entry belongs to one tile, so
// the outputs need no atomics. The bf16 instance
// (`composite_stats_bf16_launch`, RasterConfig.bf16_pairs; the reference's
// `_stats_kernel` under bf16, composite_pallas.py:581-584) takes alpha,
// 1 - alpha and alpha * excl in bf16, then the weight times T in float32.
#include "composite_common.cuh"

namespace composite {

// BF16: bf16 pair math (alpha_bf16; w = float32(bf16(alpha * bf16(excl)))
// * T, then float32; excl times bf16(1 - alpha); T times each chunk's total
// product rounded to bf16).
template <bool BF16>
__global__ void __launch_bounds__(512)
stats_kernel(const float* __restrict__ entries, long long e_total,
             const int* __restrict__ tile_start, const int* __restrict__ tile_len,
             const float* __restrict__ mask, float weight_thres, float* __restrict__ imp,
             float* __restrict__ cnt, int ntx, int tile_w, int tile_h, int kchunk, Cfg cfg) {
  extern __shared__ float smem[];
  float* sh = smem;                        // [kUsedRows][kchunk]
  float* red = smem + kUsedRows * kchunk;  // [nwarps][2][kchunk]
  const Tile tl = tile_of(tile_start, tile_len, ntx, tile_w, tile_h, kchunk);
  const int npix = blockDim.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int nwarps = npix >> 5;
  const float m = mask[(long long)blockIdx.x * npix + p];

  float trans = 1.0f;
  int i = 0;
  while (i < tl.nch && __syncthreads_or(trans > cfg.term_eps)) {
    load_chunk(sh, entries, e_total, tl.start, i, kchunk);
    __syncthreads();
    float excl = 1.0f;
    for (int k = 0; k < kchunk; ++k) {
      const float dx = tl.px - sh[kMeanX * kchunk + k];
      const float dy = tl.py - sh[kMeanY * kchunk + k];
      float ex;
      const float alpha =
          BF16 ? alpha_bf16(sh[kConA * kchunk + k], sh[kConB * kchunk + k], sh[kConC * kchunk + k],
                            sh[kOpac * kchunk + k], dx, dy, cfg, &ex)
               : eval_alpha(sh, kchunk, k, dx, dy, cfg, &ex);
      const float wm = (BF16 ? mul_bf16(alpha, round_bf16(excl)) : alpha * excl) * trans * m;
      const float s_imp = warp_sum(wm);
      const float s_cnt = warp_sum(wm >= weight_thres ? 1.0f : 0.0f);
      if (lane == 0) {
        red[(warp * 2 + 0) * kchunk + k] = s_imp;
        red[(warp * 2 + 1) * kchunk + k] = s_cnt;
      }
      excl *= BF16 ? one_minus_bf16(alpha) : 1.0f - alpha;
    }
    trans *= BF16 ? round_bf16(excl) : excl;
    __syncthreads();
    const long long base = tl.start + (long long)i * kchunk;
    for (int idx = p; idx < 2 * kchunk; idx += npix) {
      const int j = idx / kchunk;
      const int k = idx - j * kchunk;
      float s = 0.0f;
      for (int wi = 0; wi < nwarps; ++wi) s += red[(wi * 2 + j) * kchunk + k];
      (j == 0 ? imp : cnt)[base + k] = s;
    }
    ++i;
  }
}

template <bool BF16>
int launch(const float* entries, long long e_total, const int* tile_start, const int* tile_len,
           const float* mask, float weight_thres, float* imp, float* cnt, int num_tiles, int ntx,
           int tile_w, int tile_h, int kchunk, const Cfg& cfg, void* stream) {
  if (num_tiles == 0) return 0;
  const int nwarps = tile_w * tile_h / 32;
  const int smem = (kUsedRows + 2 * nwarps) * kchunk * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(stats_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  stats_kernel<BF16><<<num_tiles, tile_w * tile_h, smem, (cudaStream_t)stream>>>(
      entries, e_total, tile_start, tile_len, mask, weight_thres, imp, cnt, ntx, tile_w, tile_h,
      kchunk, cfg);
  return (int)cudaGetLastError();
}

}  // namespace composite

extern "C" int composite_stats_launch(const float* entries, long long e_total,
                                      const int* tile_start, const int* tile_len,
                                      const float* mask, float weight_thres, float* imp,
                                      float* cnt, int num_tiles, int ntx, int tile_w, int tile_h,
                                      int kchunk, float alpha_cut, float alpha_max,
                                      float term_eps, float depth_lo, float depth_hi,
                                      void* stream) {
  return composite::launch<false>(entries, e_total, tile_start, tile_len, mask, weight_thres, imp,
                                  cnt, num_tiles, ntx, tile_w, tile_h, kchunk,
                                  {alpha_cut, alpha_max, term_eps, depth_lo, depth_hi}, stream);
}

// The bf16 pair-math instance (RasterConfig.bf16_pairs), with the same
// arguments; `alpha_max` comes rounded to bf16.
extern "C" int composite_stats_bf16_launch(const float* entries, long long e_total,
                                           const int* tile_start, const int* tile_len,
                                           const float* mask, float weight_thres, float* imp,
                                           float* cnt, int num_tiles, int ntx, int tile_w,
                                           int tile_h, int kchunk, float alpha_cut,
                                           float alpha_max, float term_eps, float depth_lo,
                                           float depth_hi, void* stream) {
  return composite::launch<true>(entries, e_total, tile_start, tile_len, mask, weight_thres, imp,
                                 cnt, num_tiles, ntx, tile_w, tile_h, kchunk,
                                 {alpha_cut, alpha_max, term_eps, depth_lo, depth_hi}, stream);
}

COMPOSITE_EXPORT_ERRSTR(composite_stats)
