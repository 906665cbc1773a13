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
// As in the forward kernel, the grid may hold several concatenated views of
// `tpv` tiles each; tile t lies at tile t % tpv of its view's grid.
//
// What bounds it on the H100: FP32 CUDA-core work. The gradient needs 105
// operations per real (entry, pixel) pair (a multiply-add counted as 2): 30
// for alpha and the plane depth, 16 for q, 10 for dalpha and its clamp
// mask, 31 for the 18 per-pair gradient terms, 18 adds to sum them over
// pixels. A design adds a first pass over the chunk (its total product and
// sum of w q) and the cost of moving the 18 sums across a warp's lanes.
// With one five-step shuffle tree per column, 18 trees per (entry, warp),
// 90 shuffles at a quarter of the FP32 issue rate were the largest cost,
// paid on every pair of the reached chunks. Memory is small: 72 bytes of
// parameters and 72 of gradients per entry, shared by 512 pixels. What
// bounds this design is instruction issue: about 40 SASS instructions for
// every (entry, warp) of the reached chunks (alpha and the ballot) and
// about 300 more for each live one (both passes and the 20 shuffles).
//
// Design: one block per tile, one thread per pixel, so a warp is 32
// neighbouring pixels (a row of the 16x32 tile).
// - Exact warp cull. A surfel covers a few rows of a tile, and where no lane
//   of a warp has alpha > 0 every per-pair term of the entry is exactly +-0:
//   w = 0, dalpha is masked, and excl *= 1 and the sums += +-0 change no bit
//   (a sum that starts at +0 never becomes -0). Pass 1 evaluates alpha for
//   every entry and, where the warp's ballot of alpha > 0 is empty, skips
//   the depth, q and the running sums; it records the ballot per (warp,
//   entry) as a bit in shared memory. Pass 2 walks only the set bits of its
//   warp's words. The test is alpha > 0, not the dalpha mask: at alpha ==
//   alpha_max dalpha is masked but w, and the feature and depth terms, are
//   not zero. Pass 1 evaluates the alphas of two entries before their
//   ballots, so that their latencies overlap.
// - Transposed reduction. A surviving warp sums its 18 values with halving
//   transposes (`xsum`): a lane keeps half its values and sends the other
//   half to lane ^ O, 9 + 5 + 3 + 2 + 1 = 20 shuffles and 20 adds instead of
//   90 and 90; each column then sits in one lane (`xcol`). Each column's sum
//   adds the same operands in the same pairs as the five-step butterfly, so
//   its bits equal those of a tree per column. One store writes the 18 sums.
// - Fewer barriers. Entries go in rounds of 32 (one ballot word); the round's
//   partials are double-buffered in shared memory, so a round costs one
//   block barrier (the next round writes the other buffer), and a K = 128
//   chunk costs 2 + 4 instead of 12. The cross-warp sum of an entry reads
//   only the warps whose bit is set, in warp order; a culled warp's partial
//   was +-0 and leaving it out changes no bit. Partials are stored with a
//   row stride of 19 floats, so neither the store nor the sum's reads
//   conflict on a bank.
// - Fewer instructions per entry: the chunk is staged entry by entry (20
//   floats, 16-byte aligned), so an entry's 18 parameters load as five
//   vectors, and the default K = 128 is compiled with K known (any other K
//   takes it as an argument).
// - Heaviest tiles first. Tiles differ in work (at keyframe 5 the most real
//   entries a tile's replay reaches is 2.2x the mean), and a tile's block
//   runs from start to end on one SM. So the launch first runs
//   `tile_order_kernel`, which ranks the tiles once by reached entries into
//   an int buffer the wrapper allocates, and block b replays the tile of
//   rank b: the longest replays start in the first wave.
// - Tiles of up to 1024 pixels (a 32x32 tile). A block stays one thread a
//   pixel, up to 1024 threads under __launch_bounds__(1024, 1), which caps
//   a thread at 64 registers, the cap that (512, 2) set while tiles had
//   at most 512 pixels, so the code's register fit holds, and a 512-thread
//   block still fits two an SM. At K = 128 and 32 warps its shared memory
//   is the staged chunk (10,240 B), the double-buffered partial rows (2 x
//   32 x 32 x 19 x 4 = 155,648 B) and the ballot words (512 B): 166,400 of
//   the 227 KB, one block an SM, 32 warps, as two blocks of 16 warps give
//   at 16x32. The other design, two pixels a thread in 512 threads, would
//   keep two blocks an SM but carry two pixels' state (7 cotangents, T,
//   the suffix, the 18 per-pair values) under the same 64-register cap,
//   and its warp would cover 64 pixels, so its ballots, its cull and its
//   transposed sums would all change shape; one pixel a thread keeps the
//   code as it is.
// Alpha, the plane depth, excl, t_before and T are computed as the forward
// pass does (-fmad=false, IEEE division, the plain version's op order:
// `alpha_of` and `depth_of` repeat eval_alpha and eval_depth of
// composite_common.cuh on staged values), and the gradient terms with the
// plain version's roundings too (no __fmaf_rn), so the result is bitwise
// that of the design with a tree per column and no cull. Each entry belongs
// to one tile: no atomics, and every sum has a fixed order.
//
// Build (nvcc 12.9, sm_90a, -Xptxas -v): 58 registers a thread at K = 128,
// 64 for any other K, no spills (__launch_bounds__(1024, 1) caps it at
// 64); 88320 bytes of shared memory a block at K = 128, where the CUDA
// occupancy query (`composite_bwd_occupancy`) gives 2 blocks of 512
// threads per SM. The design with a tree per column had 63 registers. The
// ordering kernel has 22 registers and takes about 9 us a launch at 512
// tiles.
//
// The bf16 instance (`composite_bwd_bf16_launch`, RasterConfig.bf16_pairs;
// the reference's bf16 branches of `_bwd_kernel`, composite_pallas.py:332-334,
// 382-415, 429-449) follows the rounding contract of render/composite.py:
// t_k, w, q_d, w q_d, the suffix, dalpha and its products in bf16, every
// reduction and the depth-plane chain in float32, the `active` mask against
// alpha_max rounded to bf16. The sum of bf16(w q_d) over the chunk needs
// the chunk's T_before, known only after pass 1, so pass 1 takes only the
// ballots and the total product, and a walk over the live entries
// (`wq_total_bf16`) forms that sum before pass 2: one more pass than the f32
// instance, which sums alpha excl q in pass 1 and scales it by T_before.
#include "composite_common.cuh"

namespace composite {

constexpr int kSub = 32;                   // most entries per round: one ballot word
constexpr int kRedStride = kUsedRows + 1;  // floats per (warp, entry) partial row
constexpr int kEntryStride = 20;           // floats per staged entry: rows 0..17, 16-byte aligned
constexpr int kScan = 2;                   // entries pass 1 evaluates alpha for together
constexpr int kMaxThreads = 1024;          // threads a block at most: one a pixel of a 32x32 tile

// Stage rows 0..17 of chunk `chunk` entry by entry, sh[k * kEntryStride +
// row], so that one entry's parameters load as five vectors; the caller
// synchronizes before and after.
__device__ __forceinline__ void load_chunk_by_entry(float* sh, const float* __restrict__ entries,
                                                    long long e_total, int start, int chunk,
                                                    int kchunk) {
  const float* src = entries + start + (long long)chunk * kchunk;
  for (int idx = threadIdx.x; idx < kUsedRows * kchunk; idx += blockDim.x) {
    const int r = idx / kchunk;
    const int k = idx - r * kchunk;
    sh[k * kEntryStride + r] = src[(long long)r * e_total + k];
  }
}

// eval_alpha and eval_depth of composite_common.cuh on staged values, with
// the same operations in the same order
__device__ __forceinline__ float alpha_of(float ca, float cb, float cc, float op, float dx,
                                          float dy, const Cfg& c, float* ex) {
  const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
  *ex = expf(fminf(fmaxf(power, kPowerFloor), 0.0f));
  const float a = fminf(op * *ex, c.alpha_max);
  return a >= c.alpha_cut ? a : 0.0f;
}

__device__ __forceinline__ PlaneDepth depth_of(float4 plane, float dz, float px, float py,
                                               const Cfg& c) {
  const float denom = plane.x * px + plane.y * py + plane.z;
  const bool ok = fabsf(denom) > 1e-8f;
  PlaneDepth d;
  d.inv_denom = 1.0f / (ok ? denom : 1.0f);
  d.t_raw = plane.w * d.inv_denom;
  const float lo = c.depth_lo * dz;
  const float hi = c.depth_hi * dz;
  d.t = ok ? fminf(fmaxf(d.t_raw, lo), hi) : dz;
  d.inside = ok && d.t_raw > lo && d.t_raw < hi;
  return d;
}

// One staged entry's parameters: rows 4i..4i+3 in v[i], conf and dz in w.
struct Staged {
  float4 v[4];
  float2 w;
};

__device__ __forceinline__ Staged staged_at(const float* sh, int k) {
  const float4* e = reinterpret_cast<const float4*>(sh + k * kEntryStride);
  Staged s;
#pragma unroll
  for (int i = 0; i < 4; ++i) s.v[i] = e[i];
  s.w = *reinterpret_cast<const float2*>(e + 4);
  return s;
}

// alpha of entry k at (dx, dy) from its first eight rows (BF16: bf16 pair
// math, alpha_bf16; dx, dy are returned rounded to bf16)
template <bool BF16>
__device__ __forceinline__ float staged_alpha(const float4& m, const float4& o, float px, float py,
                                              const Cfg& c, float* dx, float* dy, float* ex) {
  *dx = px - m.x;
  *dy = py - m.y;
  if constexpr (BF16) {
    const float a = alpha_bf16(m.z, m.w, o.x, o.y, *dx, *dy, c, ex);
    *dx = round_bf16(*dx);
    *dy = round_bf16(*dy);
    return a;
  } else {
    return alpha_of(m.z, m.w, o.x, o.y, *dx, *dy, c, ex);
  }
}

// feat_dot: sum of the 7 composited features times g, in the same order
// (BF16: each feature rounded to bf16 first)
template <bool BF16>
__device__ __forceinline__ float staged_feat_dot(const Staged& s, const float* g) {
  const auto f16 = [](float x) { return BF16 ? round_bf16(x) : x; };
  float f = 0.0f;
  f += f16(s.v[1].z) * g[0];
  f += f16(s.v[1].w) * g[1];
  f += f16(s.v[2].x) * g[2];
  f += f16(s.v[2].y) * g[3];
  f += f16(s.v[2].z) * g[4];
  f += f16(s.v[2].w) * g[5];
  return f + f16(s.w.x) * g[6];
}

// The bf16 instance's sum over the chunk's entries of bf16(w q_d), in
// float32, for this thread's pixel: a walk over the warp's live entries
// (`live`, one word of `sub` entries a round) with the chunk's T_before
// rounded to bf16 (`tb`). Culled entries have w = +0 and add nothing.
__device__ __forceinline__ float wq_total_bf16(const float* sh, const unsigned* live, int nsub,
                                               int sub, float px, float py, float tb,
                                               const float* gf, float g_depth, const Cfg& cfg) {
  float excl = 1.0f;
  float tot = 0.0f;
  for (int r = 0; r < nsub; ++r) {
    for (unsigned word = live[r]; word != 0u; word &= word - 1u) {
      const Staged s = staged_at(sh, r * sub + __ffs(word) - 1);
      float dx, dy, ex;
      const float alpha = staged_alpha<true>(s.v[0], s.v[1], px, py, cfg, &dx, &dy, &ex);
      const PlaneDepth d = depth_of(s.v[3], s.w.y, px, py, cfg);
      const float w = mul_bf16(alpha, mul_bf16(tb, round_bf16(excl)));
      const float q = staged_feat_dot<true>(s, gf) + d.t * g_depth;
      tot += mul_bf16(w, round_bf16(q));
      excl *= one_minus_bf16(alpha);
    }
  }
  return tot;
}

// Warp sums of the N per-lane values v by halving transposes: at the step of
// offset O a lane keeps one half of its values and sends the other half to
// lane ^ O, ceil(N/2) shuffles a step. Lane L returns the sum of column
// xcol<N, O>(L) (0 for a pad column).
template <int N, int O>
__device__ __forceinline__ float xsum(const float (&v)[N], int lane) {
  constexpr int H = (N + 1) / 2;
  const bool up = (lane & O) != 0;
  float r[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float lo = v[j];
    const float hi = j + H < N ? v[j + H < N ? j + H : 0] : 0.0f;
    r[j] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, O);
  }
  if constexpr (O == 1) {
    static_assert(H == 1, "xsum: N must halve to one value in the warp's five steps");
    return r[0];
  } else {
    return xsum<H, O / 2>(r, lane);
  }
}

// the column whose sum lane L holds after xsum<N, O>, or -1 for a pad
template <int N, int O>
__device__ __forceinline__ int xcol(int lane) {
  constexpr int H = (N + 1) / 2;
  int c = 0;
  if constexpr (O > 1) c = xcol<H, O / 2>(lane);
  if (c < 0) return -1;
  c += (lane & O) ? H : 0;
  return c < N ? c : -1;
}

// The order in which the replay's blocks take the tiles: tiles by the real
// entries their replay reaches, min(tile_len, stop * K), most first (ties by
// index), so that the longest replays start in the first wave. One thread a
// tile counts the tiles ahead of it, reading every tile's count through
// shared memory a block's width at a time: order[rank] = tile.
__global__ void tile_order_kernel(const int* __restrict__ tile_len,
                                  const float* __restrict__ out_fwd, int num_tiles, int npix,
                                  int kchunk, int* __restrict__ order) {
  extern __shared__ int wsh[];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const long long stop_row = (long long)kOutRows * npix;
  const int w = t < num_tiles ? min(tile_len[t], (int)out_fwd[t * stop_row + 9 * npix] * kchunk) : 0;
  int rank = 0;
  for (int u0 = 0; u0 < num_tiles; u0 += blockDim.x) {
    __syncthreads();  // the previous stretch is read
    const int u = u0 + threadIdx.x;
    if (u < num_tiles) wsh[threadIdx.x] = min(tile_len[u], (int)out_fwd[u * stop_row + 9 * npix] * kchunk);
    __syncthreads();
    const int m = min((int)blockDim.x, num_tiles - u0);
    for (int j = 0; j < m; ++j) {
      const int wu = wsh[j];
      rank += (wu > w) | ((wu == w) & (u0 + j < t));
    }
  }
  if (t < num_tiles) order[rank] = t;
}

// KT: the chunk K at compile time, or 0 to take `kchunk_arg`. BF16: the
// bf16 pair-math instance (the rounding contract of render/composite.py):
// pass 1 takes only alpha, the ballots and the chunk's total product; a
// walk over the live entries (`wq_total_bf16`) then sums bf16(w q_d) with
// the chunk's T_before, which the suffix needs before pass 2.
template <int KT, bool BF16>
__global__ void __launch_bounds__(kMaxThreads, 1)
bwd_kernel(const float* __restrict__ entries, long long e_total,
           const int* __restrict__ tile_start, const int* __restrict__ tile_len,
           const float* __restrict__ out_fwd, const float* __restrict__ gout,
           const int* __restrict__ order, float* __restrict__ dentries, int tpv, int ntx,
           int tile_w, int tile_h, int kchunk_arg, Cfg cfg) {
  const int kchunk = KT > 0 ? KT : kchunk_arg;
  const int sub = kchunk < kSub ? kchunk : kSub;
  const int nsub = kchunk / sub;
  const int npix = blockDim.x;
  const int nwarps = npix >> 5;
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);  // [kchunk][kEntryStride]
  float* red = sh + kEntryStride * kchunk;        // [2][nwarps][sub][kRedStride]
  const int red_half = nwarps * sub * kRedStride;
  unsigned* live = reinterpret_cast<unsigned*>(red + 2 * red_half);  // [nwarps][nsub]
  const int tile = order[blockIdx.x];
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int col = xcol<kUsedRows, 16>(lane);
  const int start = tile_start[tile];
  const int vt = tile % tpv;  // the tile's place in its view's grid
  const float px = (float)((vt % ntx) * tile_w + p % tile_w) + 0.5f;
  const float py = (float)((vt / ntx) * tile_h + p / tile_w) + 0.5f;
  const long long tile_off = (long long)tile * kOutRows * npix;
  const int stop = (int)out_fwd[tile_off + 9 * npix];

  const float* g = gout + tile_off + p;
  // feature-channel cotangents in feature order r g b nx ny nz conf
  // (BF16: rounded to bf16, as g_T * T_final)
  const auto g16 = [](float x) { return BF16 ? round_bf16(x) : x; };
  float gf[7];
#pragma unroll
  for (int c = 0; c < 6; ++c) gf[c] = g16(g[c * npix]);
  gf[6] = g16(g[7 * npix]);
  const float g_depth = g[6 * npix];
  const float t_final = out_fwd[tile_off + 8 * npix + p];
  const float gtf = g16(g[8 * npix] * t_final);
  float t_after = t_final;
  float s_q = 0.0f;

  for (int i = stop - 1; i >= 0; --i) {
    __syncthreads();  // the previous chunk's shared reads are done
    load_chunk_by_entry(sh, entries, e_total, start, i, kchunk);
    __syncthreads();

    // pass 1: the chunk's total product and sum of alpha * excl * q, and
    // the ballot of alpha > 0 of each (warp, entry)
    float excl = 1.0f;
    float u_sum = 0.0f;
    for (int r = 0; r < nsub; ++r) {
      unsigned word = 0;
      for (int k0 = 0; k0 < sub; k0 += kScan) {
        // the alphas of kScan entries first, so that their latencies overlap
        float alpha[kScan];
#pragma unroll
        for (int j = 0; j < kScan; ++j) {
          alpha[j] = 0.0f;  // past the round: no lane live
          if (k0 + j < sub) {
            const float4* e = reinterpret_cast<const float4*>(sh + (r * sub + k0 + j) * kEntryStride);
            float dx, dy, ex;
            alpha[j] = staged_alpha<BF16>(e[0], e[1], px, py, cfg, &dx, &dy, &ex);
          }
        }
#pragma unroll
        for (int j = 0; j < kScan; ++j) {
          if (__ballot_sync(0xffffffffu, alpha[j] > 0.0f) == 0u) continue;
          word |= 1u << (k0 + j);
          if constexpr (BF16) {
            excl *= one_minus_bf16(alpha[j]);
          } else {
            const Staged s = staged_at(sh, r * sub + k0 + j);
            const PlaneDepth d = depth_of(s.v[3], s.w.y, px, py, cfg);
            const float q = staged_feat_dot<false>(s, gf) + d.t * g_depth;
            u_sum += alpha[j] * excl * q;
            excl *= 1.0f - alpha[j];
          }
        }
      }
      if (lane == 0) live[warp * nsub + r] = word;
    }
    __syncwarp();
    float t_before, tot_wq;
    if constexpr (BF16) {
      t_before = t_after / fmaxf(round_bf16(excl), 1e-30f);
      tot_wq = wq_total_bf16(sh, live + warp * nsub, nsub, sub, px, py, round_bf16(t_before), gf,
                             g_depth, cfg);
    } else {
      t_before = t_after / fmaxf(excl, 1e-30f);
      tot_wq = t_before * u_sum;
    }
    const float tb = round_bf16(t_before);  // BF16 only
    const float sqb = round_bf16(s_q);      // BF16 only

    // pass 2: per-pair gradients of the warp's live entries, one round of
    // `sub` entries per ballot word
    excl = 1.0f;
    float incl = 0.0f;
    for (int r = 0; r < nsub; ++r) {
      float* buf = red + (r & 1) * red_half;
      for (unsigned word = live[warp * nsub + r]; word != 0u; word &= word - 1u) {
        const int kk = __ffs(word) - 1;
        const Staged s = staged_at(sh, r * sub + kk);
        float dx, dy, ex;
        const float alpha = staged_alpha<BF16>(s.v[0], s.v[1], px, py, cfg, &dx, &dy, &ex);
        const PlaneDepth d = depth_of(s.v[3], s.w.y, px, py, cfg);
        const float q = staged_feat_dot<BF16>(s, gf) + d.t * g_depth;
        float one_m, w, dalpha, t1, t2, m_xx, m_xy, m_yy, dop;
        if constexpr (BF16) {
          // every step of dalpha and of its products rounds to bf16; the
          // suffix over later entries is formed in float32, then rounded
          one_m = one_minus_bf16(alpha);
          const float t_k = mul_bf16(tb, round_bf16(excl));
          w = mul_bf16(alpha, t_k);
          const float q_d = round_bf16(q);
          incl += mul_bf16(w, q_d);
          const bf16 suffix = __hadd(to_bf16(sqb), to_bf16(tot_wq - incl));  // entries after k
          const bf16 recip = to_bf16(1.0f / fmaxf(one_m, round_bf16(0.01f)));
          dalpha = to_f32(__hsub(__hmul(to_bf16(t_k), to_bf16(q_d)),
                                 __hmul(__hadd(suffix, to_bf16(gtf)), recip)));
          if (!(alpha > 0.0f && alpha < cfg.alpha_max)) dalpha = 0.0f;
          const float dpow = mul_bf16(dalpha, alpha);
          t1 = mul_bf16(dpow, dx);
          t2 = mul_bf16(dpow, dy);
          m_xx = mul_bf16(t1, dx);
          m_xy = mul_bf16(t1, dy);
          m_yy = mul_bf16(t2, dy);
          dop = mul_bf16(dalpha, ex);
        } else {
          one_m = 1.0f - alpha;
          const float t_k = t_before * excl;
          w = alpha * t_k;
          incl += w * q;
          const float suffix = s_q + (tot_wq - incl);  // entries after k
          dalpha = t_k * q - (suffix + gtf) * (1.0f / fmaxf(one_m, 0.01f));
          if (!(alpha > 0.0f && alpha < cfg.alpha_max)) dalpha = 0.0f;
          const float dpow = dalpha * alpha;
          t1 = dpow * dx;
          t2 = dpow * dy;
          m_xx = t1 * dx;
          m_xy = t1 * dy;
          m_yy = t2 * dy;
          dop = dalpha * ex;
        }
        const float wgd = w * g_depth;
        const float com = d.inside ? wgd * d.inv_denom : 0.0f;
        const float u = com * d.t_raw;
        const float v[kUsedRows] = {
            t1, t2, m_xx, m_xy, m_yy, dop,
            w * gf[0], w * gf[1], w * gf[2], w * gf[3], w * gf[4], w * gf[5],
            -(u * px), -(u * py), -u, com, w * gf[6],
            d.inside ? 0.0f : wgd * d.t,
        };
        const float sum = xsum<kUsedRows, 16>(v, lane);
        if (col >= 0) buf[(warp * sub + kk) * kRedStride + col] = sum;
        excl *= one_m;
      }
      __syncthreads();  // the round's partials are written
      // sum the live warps' partials in warp order, then the gradient
      // columns: mean x/y, conic a/b/c, opacity, rgb, normal, plane A/B/C/D,
      // confidence, center depth
      float* dst = dentries + start + (long long)i * kchunk + r * sub;
      for (int idx = p; idx < kUsedRows * sub; idx += npix) {
        const int j = idx / sub;
        const int kk = idx - j * sub;
        const float* e = sh + (r * sub + kk) * kEntryStride;
        const int j0 = j < 2 ? 0 : j;  // columns 0 and 1 both need sums 0 and 1
        float s0 = 0.0f;
        float s1 = 0.0f;
        for (int wi = 0; wi < nwarps; ++wi) {
          if (!((live[wi * nsub + r] >> kk) & 1u)) continue;
          const float* b = buf + (wi * sub + kk) * kRedStride;
          s0 += b[j0];
          if (j < 2) s1 += b[1];
        }
        float val;
        switch (j) {
          case 0: val = e[kConA] * s0 + e[kConB] * s1; break;
          case 1: val = e[kConB] * s0 + e[kConC] * s1; break;
          case 2: val = -0.5f * s0; break;
          case 3: val = -s0; break;
          case 4: val = -0.5f * s0; break;
          case 17: val = s0 / fmaxf(e[kDepthZ], 1e-30f); break;
          default: val = s0;
        }
        dst[(long long)j * e_total + kk] = val;
      }
      // no barrier here: the next round writes the other buffer, and the
      // round after it passes the next round's barrier first
    }
    t_after = t_before;
    s_q += tot_wq;
  }
}

// dynamic shared memory of a block: the staged chunk, two rounds of
// partials and the ballot words
inline int smem_bytes(int tile_pixels, int kchunk) {
  const int sub = kchunk < kSub ? kchunk : kSub;
  const int nwarps = tile_pixels / 32;
  return (kEntryStride * kchunk + 2 * nwarps * sub * kRedStride) * (int)sizeof(float) +
         nwarps * (kchunk / sub) * (int)sizeof(unsigned);
}

// the instance for chunk K: the default K = 128 with K known at compile
// time, any other K from its argument
using Kernel = decltype(&bwd_kernel<0, false>);
template <bool BF16>
inline Kernel kernel_for(int kchunk) {
  return kchunk == 128 ? bwd_kernel<128, BF16> : bwd_kernel<0, BF16>;
}

constexpr int kOrderThreads = 256;

template <bool BF16>
int launch(const float* entries, long long e_total, const int* tile_start, const int* tile_len,
           const float* out_fwd, const float* gout, float* dentries, int* order, int num_tiles,
           int tpv, int ntx, int tile_w, int tile_h, int kchunk, const Cfg& cfg, void* stream) {
  if (num_tiles == 0) return 0;
  if (tpv <= 0 || num_tiles % tpv != 0) return (int)cudaErrorInvalidValue;
  if (kchunk % (kchunk < kSub ? kchunk : kSub)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int npix = tile_w * tile_h;
  if (npix % 32 || npix > kMaxThreads) return (int)cudaErrorInvalidValue;
  const int nt = kOrderThreads;
  tile_order_kernel<<<(num_tiles + nt - 1) / nt, nt, nt * (int)sizeof(int), st>>>(
      tile_len, out_fwd, num_tiles, npix, kchunk, order);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Kernel kernel = kernel_for<BF16>(kchunk);
  const int smem = smem_bytes(npix, kchunk);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_tiles, npix, smem, st>>>(entries, e_total, tile_start, tile_len, out_fwd, gout,
                                        order, dentries, tpv, ntx, tile_w, tile_h, kchunk, cfg);
  return (int)cudaGetLastError();
}

}  // namespace composite

// `order` is scratch of num_tiles ints: the ordering kernel writes it, the
// replay reads it. The `num_tiles` tiles are views of `tpv` tiles each (tpv
// divides num_tiles; tpv = num_tiles for one view).
extern "C" int composite_bwd_launch(const float* entries, long long e_total,
                                    const int* tile_start, const int* tile_len,
                                    const float* out_fwd, const float* gout, float* dentries,
                                    int* order, int num_tiles, int tpv, int ntx, int tile_w,
                                    int tile_h, int kchunk, float alpha_cut, float alpha_max,
                                    float term_eps, float depth_lo, float depth_hi, void* stream) {
  return composite::launch<false>(entries, e_total, tile_start, tile_len, out_fwd, gout, dentries,
                                  order, num_tiles, tpv, ntx, tile_w, tile_h, kchunk,
                                  {alpha_cut, alpha_max, term_eps, depth_lo, depth_hi}, stream);
}

// The bf16 pair-math instance (RasterConfig.bf16_pairs), with the same
// arguments; `alpha_max` comes rounded to bf16.
extern "C" int composite_bwd_bf16_launch(const float* entries, long long e_total,
                                         const int* tile_start, const int* tile_len,
                                         const float* out_fwd, const float* gout, float* dentries,
                                         int* order, int num_tiles, int tpv, int ntx, int tile_w,
                                         int tile_h, int kchunk, float alpha_cut, float alpha_max,
                                         float term_eps, float depth_lo, float depth_hi,
                                         void* stream) {
  return composite::launch<true>(entries, e_total, tile_start, tile_len, out_fwd, gout, dentries,
                                 order, num_tiles, tpv, ntx, tile_w, tile_h, kchunk,
                                 {alpha_cut, alpha_max, term_eps, depth_lo, depth_hi}, stream);
}

// What the build gives the replay kernel that a launch at this tile size
// and K runs: registers and local (spill) bytes a thread, dynamic shared
// bytes a block, and the blocks an SM holds (the CUDA occupancy query).
extern "C" int composite_bwd_occupancy(int tile_pixels, int kchunk, int* registers,
                                       int* local_bytes, int* smem_bytes, int* blocks_per_sm) {
  const composite::Kernel kernel = composite::kernel_for<false>(kchunk);
  const int smem = composite::smem_bytes(tile_pixels, kchunk);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, tile_pixels, smem);
}

COMPOSITE_EXPORT_ERRSTR(composite_bwd)
