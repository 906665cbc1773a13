// Backward tile composite for Hopper (sm_90a).
//
// Replaces: `_bwd_kernel` in activegs_tpu/render/composite_pallas.py
// (launched by `_run_bwd`; wired as `_composite_bwd`, the VJP of
// `composite_tiled`).
//
// What it computes, per tile: replay the chunks the forward pass reached
// (row 9 of its output) in reverse. Per pixel it carries T after the chunk
// and S = sum over later entries of w * q, where q = feats . g_feat +
// t * g_depth; per (entry, pixel) pair
//   dalpha = T_k q - (S_k + g_T T_final) / max(1 - alpha, 0.01),
// masked where alpha is clamped (alpha <= 0 or >= alpha_max), chained into
// 18 per-entry gradient columns reduced over the tile's pixels: mean x/y and
// conic a/b/c through five moment sums, opacity, the 7 features, the plane
// A/B/C/D and the center depth (outside the plane-depth clamp only). A
// chunk's starting T is recovered as T_after / max(total, 1e-30) from the
// chunk's total product and the in-chunk products are rebuilt forward, as
// the reference does; dividing by (1 - alpha) one entry at a time would
// drift where alpha is near 0.99. The kernel writes rows 0..17 of the
// chunks it replays; the caller passes `dentries` zeroed, which leaves the
// chunks at or past the stop, rows 18..23 and the budget's tail at zero.
//
// What bounds it on the H100: FP32 CUDA-core work. The gradient needs 105
// operations per pair (a multiply-add counted as 2): 30 for alpha and the
// plane depth, 16 for q, 10 for dalpha and its clamp mask, 31 for the 18
// per-pair gradient terms, 18 adds to sum them over pixels. This design
// adds about 50 more for a first pass over the chunk (its total product and
// sum of w q, recomputing alpha, depth and q), and 90 warp shuffles plus 90
// adds for the 18 five-step shuffle trees; a shuffle issues at a quarter of
// the FP32 rate, so the reduction is the largest cost. Memory is small: 72
// bytes of parameters and 72 of gradients per entry, shared by 512 pixels.
//
// Design: one block per tile, one thread per pixel; the chunk's parameters
// are staged in shared memory as in the forward kernel. The 18 per-entry
// sums use warp shuffles, then shared memory across the block's warps, in
// sub-chunks of 32 entries (18 x 32 x 16 warps partials); each entry
// belongs to exactly one tile, so no atomics are needed across blocks.
#include "composite_common.cuh"

namespace composite {

constexpr int kSub = 32;  // most entries per block-wide reduction round

__global__ void __launch_bounds__(512)
bwd_kernel(const float* __restrict__ entries, long long e_total,
           const int* __restrict__ tile_start, const int* __restrict__ tile_len,
           const float* __restrict__ out_fwd, const float* __restrict__ gout,
           float* __restrict__ dentries, int ntx, int tile_w, int tile_h, int kchunk, Cfg cfg) {
  extern __shared__ float smem[];
  float* sh = smem;                        // [kUsedRows][kchunk]
  float* red = smem + kUsedRows * kchunk;  // [nwarps][kUsedRows][sub]
  const int sub = kchunk < kSub ? kchunk : kSub;
  const Tile tl = tile_of(tile_start, tile_len, ntx, tile_w, tile_h, kchunk);
  const int npix = blockDim.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int nwarps = npix >> 5;
  const long long tile_off = (long long)blockIdx.x * kOutRows * npix;
  const int stop = (int)out_fwd[tile_off + 9 * npix];

  const float* g = gout + tile_off + p;
  float gf[7];  // feature-channel cotangents in feature order r g b nx ny nz conf
#pragma unroll
  for (int c = 0; c < 6; ++c) gf[c] = g[c * npix];
  gf[6] = g[7 * npix];
  const float g_depth = g[6 * npix];
  const float t_final = out_fwd[tile_off + 8 * npix + p];
  const float gtf = g[8 * npix] * t_final;
  float t_after = t_final;
  float s_q = 0.0f;

  for (int i = stop - 1; i >= 0; --i) {
    __syncthreads();  // the previous chunk's shared reads are done
    load_chunk(sh, entries, e_total, tl.start, i, kchunk);
    __syncthreads();

    // pass 1: the chunk's total product and sum of alpha * excl * q
    float excl = 1.0f;
    float u_sum = 0.0f;
    for (int k = 0; k < kchunk; ++k) {
      const float dx = tl.px - sh[kMeanX * kchunk + k];
      const float dy = tl.py - sh[kMeanY * kchunk + k];
      float ex;
      const float alpha = eval_alpha(sh, kchunk, k, dx, dy, cfg, &ex);
      const PlaneDepth d = eval_depth(sh, kchunk, k, tl.px, tl.py, cfg);
      const float q = feat_dot(sh, kchunk, k, gf) + d.t * g_depth;
      u_sum += alpha * excl * q;
      excl *= 1.0f - alpha;
    }
    const float t_before = t_after / fmaxf(excl, 1e-30f);
    const float tot_wq = t_before * u_sum;

    // pass 2: per-pair gradients, reduced per entry in rounds of `sub`
    excl = 1.0f;
    float incl = 0.0f;
    for (int k0 = 0; k0 < kchunk; k0 += sub) {
      for (int kk = 0; kk < sub; ++kk) {
        const int k = k0 + kk;
        const float dx = tl.px - sh[kMeanX * kchunk + k];
        const float dy = tl.py - sh[kMeanY * kchunk + k];
        float ex;
        const float alpha = eval_alpha(sh, kchunk, k, dx, dy, cfg, &ex);
        const PlaneDepth d = eval_depth(sh, kchunk, k, tl.px, tl.py, cfg);
        const float one_m = 1.0f - alpha;
        const float t_k = t_before * excl;
        const float w = alpha * t_k;
        const float q = feat_dot(sh, kchunk, k, gf) + d.t * g_depth;
        incl += w * q;
        const float suffix = s_q + (tot_wq - incl);  // entries after k
        float dalpha = t_k * q - (suffix + gtf) * (1.0f / fmaxf(one_m, 0.01f));
        if (!(alpha > 0.0f && alpha < cfg.alpha_max)) dalpha = 0.0f;
        const float dpow = dalpha * alpha;
        const float t1 = dpow * dx;
        const float t2 = dpow * dy;
        const float wgd = w * g_depth;
        const float com = d.inside ? wgd * d.inv_denom : 0.0f;
        const float u = com * d.t_raw;
        float v[kUsedRows] = {
            t1, t2, t1 * dx, t1 * dy, t2 * dy, dalpha * ex,
            w * gf[0], w * gf[1], w * gf[2], w * gf[3], w * gf[4], w * gf[5],
            -(u * tl.px), -(u * tl.py), -u, com, w * gf[6],
            d.inside ? 0.0f : wgd * d.t,
        };
#pragma unroll
        for (int j = 0; j < kUsedRows; ++j) {
          const float s = warp_sum(v[j]);
          if (lane == 0) red[(warp * kUsedRows + j) * sub + kk] = s;
        }
        excl *= one_m;
      }
      __syncthreads();
      // sum the warps' partials into warp 0's slots
      for (int idx = p; idx < kUsedRows * sub; idx += npix) {
        float s = 0.0f;
        for (int wi = 0; wi < nwarps; ++wi) s += red[wi * kUsedRows * sub + idx];
        red[idx] = s;
      }
      __syncthreads();
      // gradient columns: mean x/y, conic a/b/c, opacity, rgb, normal,
      // plane A/B/C/D, confidence, center depth
      float* dst = dentries + tl.start + (long long)i * kchunk + k0;
      for (int idx = p; idx < kUsedRows * sub; idx += npix) {
        const int r = idx / sub;
        const int kk = idx - r * sub;
        const int k = k0 + kk;
        const float* s = red + kk;  // s[j * sub] = column sum j
        float val;
        switch (r) {
          case 0: val = sh[kConA * kchunk + k] * s[0] + sh[kConB * kchunk + k] * s[sub]; break;
          case 1: val = sh[kConB * kchunk + k] * s[0] + sh[kConC * kchunk + k] * s[sub]; break;
          case 2: val = -0.5f * s[2 * sub]; break;
          case 3: val = -s[3 * sub]; break;
          case 4: val = -0.5f * s[4 * sub]; break;
          case 17: val = s[17 * sub] / fmaxf(sh[kDepthZ * kchunk + k], 1e-30f); break;
          default: val = s[r * sub];
        }
        dst[(long long)r * e_total + kk] = val;
      }
      __syncthreads();  // `red` is reused by the next round
    }
    t_after = t_before;
    s_q += tot_wq;
  }
}

}  // namespace composite

extern "C" int composite_bwd_launch(const float* entries, long long e_total,
                                    const int* tile_start, const int* tile_len,
                                    const float* out_fwd, const float* gout, float* dentries,
                                    int num_tiles, int ntx, int tile_w, int tile_h, int kchunk,
                                    float alpha_cut, float alpha_max, float term_eps,
                                    float depth_lo, float depth_hi, void* stream) {
  if (num_tiles == 0) return 0;
  if (kchunk % (kchunk < composite::kSub ? kchunk : composite::kSub))
    return (int)cudaErrorInvalidValue;
  const composite::Cfg cfg{alpha_cut, alpha_max, term_eps, depth_lo, depth_hi};
  const int nwarps = tile_w * tile_h / 32;
  const int smem = (composite::kUsedRows * kchunk +
                    nwarps * composite::kUsedRows * composite::kSub) *
                   (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      composite::bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  composite::bwd_kernel<<<num_tiles, tile_w * tile_h, smem, (cudaStream_t)stream>>>(
      entries, e_total, tile_start, tile_len, out_fwd, gout, dentries, ntx, tile_w, tile_h,
      kchunk, cfg);
  return (int)cudaGetLastError();
}

COMPOSITE_EXPORT_ERRSTR(composite_bwd)
