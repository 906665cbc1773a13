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
// threshold test, 2 for the running product). Memory is small: alpha needs
// 6 of an entry's parameter rows (24 bytes), shared by the tile's 512
// pixels, and 8 bytes are written per entry, 4 bytes of mask read per pixel.
//
// The first design (one block of 512 threads per tile, each chunk's 18
// rows staged row by row between two block barriers, and for every (entry,
// 32-pixel row) pair two five-step shuffle trees, one for each sum) spent
// most of its issue slots on the trees: 10 shuffles, at a quarter of the
// FP32 rate, and 10 adds per pair, on top of the 25 operations of real
// work, and every masked or unreached pixel paid them in full.
//
// Design: one block per tile, one thread per pixel, so a warp is 32
// neighbouring pixels (a row of the 16x32 tile).
// - Counts by ballot. A warp's count for an entry is the popcount of the
//   ballot of wm >= weight_thres: one vote a pair, the vote word stored by
//   lane 0. The cross-warp pass sums the popcounts as integers; sums of
//   integers below 2^24 are exact in any order, so the float count is the
//   first design's bit for bit. A threshold <= 0 counts every pixel,
//   masked ones and pad entries included, as the plain version does.
// - Importance by halving transposes, folded as the values arrive. A
//   round of 32 entries is reduced over the warp's lanes with 31 shuffles
//   instead of 32 x 5: at the fold of offset O, a lane keeps one of two
//   values and adds the other lane's copy of it (`fold`), so two columns'
//   sums advance with one shuffle. A group of 4 entries folds at offsets
//   16 and 8, then a binary counter over the round's 8 groups folds at 4,
//   2 and 1, so a lane holds 3 pending values, not 32; lane L ends with
//   the sum of entry brev5(L) of the round. Each entry's sum adds the same
//   operands in the same pairs as the five-step butterfly (lane ^ 16 first,
//   then ^ 8, ...), so its bits are the butterfly's (addition commutes).
// - An exact warp cull. Where every one of a warp's 32 sums of a round is
//   +-0, the warp stores no partial and clears its live flag; the
//   cross-warp sum reads only live warps' partials, in warp order, from
//   +0. Adding +-0 to a sum that starts at +0 changes no bit (it never
//   becomes -0), so leaving such partials out is exact. The test is taken
//   on the sums, once a round, not on each wm: a vote per pair would cost
//   an instruction on every pair, and a whole round of 32 entries that
//   misses a warp's pixel row is rare in a depth-sorted tile (5% of the
//   rounds at the keyframe-5 view). Masked pixels still evaluate alpha and
//   excl: T over the whole tile, masked pixels included, decides the stop.
// - Pad entries skipped. The zero rows that fill a tile's last chunk past
//   its length have alpha = 0: w * mask is +-0 at every pixel (for a
//   finite mask) and excl is unchanged, so they are not evaluated; the
//   pass writes what they would get, importance +0 and a count of every
//   pixel where the threshold is <= 0.
// - Staging that keeps loads in flight. Only rows 0..5 are staged (mean,
//   conic, opacity: all that alpha reads), entry by entry 8 floats apart,
//   so an entry loads as one float4 and one float2, read by every thread
//   at once (a broadcast). Chunk i + 1 is copied with cp.async into the
//   other of two buffers while chunk i is composited, and chunk i's
//   partials are summed across warps after the next chunk's barrier, from
//   the other of two partial buffers: one block barrier a chunk (the stop
//   test), against 3 in the first design.
// - Heaviest tiles first, 2 blocks an SM. A tile's block runs from start
//   to end on one SM, and tiles differ in work (the most real entries a
//   tile's replay reaches is 2.2x the mean at the keyframe-5 view). A
//   small kernel first ranks the tiles by tile_len, most first, into a
//   scratch buffer (`tile_rank_kernel`, one block a tile), and block b
//   replays the tile of rank b, so the lightest tiles fill in at the end.
//   The launch asks for the shared memory that caps an SM at 2 blocks of
//   512 threads: with the 3 its registers allow, the heavy tiles of the
//   first wave share their SMs three ways and end later.
// - The default K = 128 is compiled with K known; any other K takes it as
//   an argument, its last round padded with zero values that no lane
//   stores.
// - Tiles of up to 1024 pixels (32x32). Nothing of the above depends on
//   the warp count: the ballots, folds and the cull are per warp, and the
//   cross-warp pass loops over nwarps = P / 32 (32 warps at 32x32; counts
//   up to 1024 stay exact integers). A block of up to 1024 threads runs
//   under __launch_bounds__(1024), whose cap of 64 registers a thread the
//   code keeps under (32 at K = 128, 55 for any other K; no spills); where
//   tile_w is 16 a warp spans two pixel rows, and the cull, taken on the
//   sums, stays exact.
// Alpha, wm, excl and T are computed as the first design does (-fmad=false,
// eval_alpha's op order), so the output is that design's bit for bit.
// Every entry belongs to one tile: no atomics.
//
// Build at the default tile and K = 128 (composite_stats_occupancy, nvcc
// 12.8, on an NVIDIA H100 80GB HBM3): 40 registers a thread, no spills,
// 76801 shared bytes a block (41472 needed), 2 blocks of 512 threads per
// SM; the ranking kernel has 14 registers. The full round's loop holds 202
// instructions for 4 entries (50.5 each, 6 shuffles, 3 of which, the
// binary counter's, run on one group in 2, 4 and 8), against 77 and 10 a
// pair in the first design (`chip_smoke.py --parent`, from the SASS).
//
// What bounds it now (chip_smoke.py on that card): at the keyframe-5 view
// the replay takes 0.133 ms of device time and the ranking 0.002, two
// thirds of the bound at the probe's measured rates; without the ranking
// the replay takes 0.163 ms, with 3 blocks an SM 0.149 (`--stats-schedule`).
// What is left is the issue of those instructions on every (entry, warp)
// pair of the real entries: alpha (most of them, expf included) is needed
// at every pixel, live or masked, because T decides the stop.
//
// The bf16 instance (`composite_stats_bf16_launch`, RasterConfig.bf16_pairs;
// the reference's `_stats_kernel` under bf16, composite_pallas.py:581-584)
// takes alpha, 1 - alpha and alpha * excl in bf16, then the weight times T
// in float32; the same design through the template.
#include "composite_common.cuh"

namespace composite {

constexpr int kAlphaRows = 6;  // rows 0..5: mean x/y, conic a/b/c, opacity
constexpr int kSlot = 8;       // floats a staged entry takes: its 6 rows and 2 of padding
constexpr int kRound = 32;     // entries a round: the 32 columns of one warp's folds
constexpr int kGroup = 4;      // entries whose alphas are evaluated together
constexpr int kMaxThreads = 1024;  // threads a block at most: one a pixel of a 32x32 tile

// Start copying rows 0..5 of chunk `chunk` into sh, entry k's rows at
// sh[k * kSlot + row] (coalesced along each row); cp.async.wait_all then
// a block barrier make them visible.
__device__ __forceinline__ void stage_alpha_rows(float* sh, const float* __restrict__ entries,
                                                 long long e_total, int start, int chunk,
                                                 int kchunk) {
  const float* src = entries + start + (long long)chunk * kchunk;
  for (int idx = threadIdx.x; idx < kAlphaRows * kchunk; idx += blockDim.x) {
    const int r = idx / kchunk;
    const int k = idx - r * kchunk;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(sh + k * kSlot + r);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src + (long long)r * e_total + k)
                 : "memory");
  }
}

__device__ __forceinline__ void wait_staged() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// One fold of a halving transpose at offset o: lanes without bit o keep
// column a and add lane ^ o's a; lanes with it keep b and add lane ^ o's b.
__device__ __forceinline__ float fold(float a, float b, int lane, int o) {
  const bool up = (lane & o) != 0;
  return (up ? b : a) + __shfl_xor_sync(0xffffffffu, up ? a : b, o);
}

// Sum over this warp's pixels of the masked weight of entries [k0, k0 + n)
// of the staged chunk, one round; entries past n are zero columns. Lane L
// returns the sum of entry k0 + brev5(L). Stores each entry's vote of
// wm >= thres (lane 0, votes[k]) and advances excl. FULL: n == kRound.
template <bool FULL, bool BF16>
__device__ __forceinline__ float round_sums(const float* sh, int k0, int n, const Tile& tl,
                                            const Cfg& cfg, float trans, float m, float thres,
                                            int lane, float& excl, unsigned* votes) {
  float x = 0.0f, p2 = 0.0f, p3 = 0.0f, p4 = 0.0f;  // the pending folds of levels 2, 3, 4
  for (int g = 0; g < kRound / kGroup; ++g) {
    // the alphas of kGroup entries first, so that their latencies overlap
    float alpha[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int k = k0 + g * kGroup + u;
      alpha[u] = 0.0f;
      if (FULL || g * kGroup + u < n) {
        const float4 a = *reinterpret_cast<const float4*>(sh + k * kSlot);
        const float2 o = *reinterpret_cast<const float2*>(sh + k * kSlot + 4);
        const float dx = tl.px - a.x;
        const float dy = tl.py - a.y;
        float ex;
        if constexpr (BF16) {
          alpha[u] = alpha_bf16(a.z, a.w, o.x, o.y, dx, dy, cfg, &ex);
        } else {
          const float e[6] = {a.x, a.y, a.z, a.w, o.x, o.y};
          alpha[u] = eval_alpha(e, 1, 0, dx, dy, cfg, &ex);
        }
      }
    }
    // in entry order: the masked weight, its vote, the running product
    float w[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      w[u] = 0.0f;
      if (FULL || g * kGroup + u < n) {
        w[u] = (BF16 ? mul_bf16(alpha[u], round_bf16(excl)) : alpha[u] * excl) * trans * m;
        const unsigned v = __ballot_sync(0xffffffffu, w[u] >= thres);
        if (lane == 0) votes[k0 + g * kGroup + u] = v;
        excl *= BF16 ? one_minus_bf16(alpha[u]) : 1.0f - alpha[u];
      }
    }
    // the group's folds (offsets 16 and 8), then a binary counter over the
    // groups for offsets 4, 2, 1
    x = fold(fold(w[0], w[1], lane, 16), fold(w[2], w[3], lane, 16), lane, 8);
    if (g & 1) {
      x = fold(p2, x, lane, 4);
      if (g & 2) {
        x = fold(p3, x, lane, 2);
        if (g & 4)
          x = fold(p4, x, lane, 1);
        else
          p4 = x;
      } else {
        p3 = x;
      }
    } else {
      p2 = x;
    }
  }
  return x;
}

// The order in which the replay's blocks take the tiles: the tiles by entry
// count (tile_len), most first, ties by index, so that the longest replays
// start in the first wave and the lightest fill in at the end. Block t
// counts the tiles ahead of tile t, one block-wide count a stretch of
// blockDim.x tiles: order[rank] = t.
__global__ void tile_rank_kernel(const int* __restrict__ tile_len, int num_tiles,
                                 int* __restrict__ order) {
  const int t = blockIdx.x;
  const int w = tile_len[t];
  int rank = 0;
  for (int u0 = 0; u0 < num_tiles; u0 += blockDim.x) {
    const int u = u0 + threadIdx.x;
    const int wu = u < num_tiles ? tile_len[u] : 0;
    rank += __syncthreads_count(u < num_tiles && (wu > w || (wu == w && u < t)));
  }
  if (threadIdx.x == 0) order[rank] = t;
}

// KT: the chunk K at compile time, or 0 to take `kchunk_arg`. BF16: bf16
// pair math (alpha_bf16; w = float32(bf16(alpha * bf16(excl))) * T, then
// float32; excl times bf16(1 - alpha); T times each chunk's total product
// rounded to bf16).
template <int KT, bool BF16>
__global__ void __launch_bounds__(kMaxThreads)
stats_kernel(const float* __restrict__ entries, long long e_total,
             const int* __restrict__ tile_start, const int* __restrict__ tile_len,
             const float* __restrict__ mask, float weight_thres, float* __restrict__ imp,
             float* __restrict__ cnt, const int* __restrict__ order, int ntx, int tile_w,
             int tile_h, int kchunk_arg, Cfg cfg) {
  const int kchunk = KT > 0 ? KT : kchunk_arg;
  const int nround = (kchunk + kRound - 1) / kRound;
  const int npix = blockDim.x;
  const int nwarps = npix >> 5;
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);      // [2][kchunk][kSlot]
  float* part = stage + 2 * kSlot * kchunk;            // [2][nwarps][kchunk] importance partials
  unsigned* votes = reinterpret_cast<unsigned*>(part + 2 * nwarps * kchunk);  // [2][nwarps][kchunk]
  int* live = reinterpret_cast<int*>(votes + 2 * nwarps * kchunk);            // [2][nwarps][nround]
  const int tile = order[blockIdx.x];
  const int p = threadIdx.x;
  const Tile tl = tile_of(tile_start, tile_len, tile, p, gridDim.x, ntx, tile_w, tile_h, kchunk);
  const int len = tile_len[tile];
  const int lane = p & 31;
  const int warp = p >> 5;
  const int col = (int)(__brev((unsigned)lane) >> 27);  // the entry of a round whose sum lane ends with
  const float m = mask[(long long)tile * npix + p];

  if (tl.nch > 0) stage_alpha_rows(stage, entries, e_total, tl.start, 0, kchunk);
  float trans = 1.0f;
  for (int i = 0;; ++i) {
    wait_staged();
    // chunk i is staged, chunk i - 1's partials are written, and the
    // buffers of chunk i - 1 are free once its sums are taken below
    const bool go = __syncthreads_or(i < tl.nch && trans > cfg.term_eps);
    if (i > 0) {
      // chunk i - 1: the live warps' importance partials summed in warp
      // order, and the counts of all warps' votes; its pad entries (zero
      // rows past the tile's length) get the values they would get: w * mask
      // = +-0 at every pixel, so importance +0 and a count of every pixel
      // where the threshold is <= 0
      const int b = (i - 1) & 1;
      const float* pb = part + b * nwarps * kchunk;
      const unsigned* vb = votes + b * nwarps * kchunk;
      const int* lb = live + b * nwarps * nround;
      const int n = min(kchunk, len - (i - 1) * kchunk);
      const long long base = tl.start + (long long)(i - 1) * kchunk;
      for (int idx = p; idx < 2 * kchunk; idx += npix) {
        if (idx < kchunk) {
          float s = 0.0f;
          if (idx < n)
            for (int wi = 0; wi < nwarps; ++wi)
              if (lb[wi * nround + idx / kRound]) s += pb[wi * kchunk + idx];
          imp[base + idx] = s;
        } else {
          const int k = idx - kchunk;
          int c = weight_thres <= 0.0f ? npix : 0;
          if (k < n) {
            c = 0;
            for (int wi = 0; wi < nwarps; ++wi) c += __popc(vb[wi * kchunk + k]);
          }
          cnt[base + k] = (float)c;
        }
      }
    }
    if (!go) break;
    if (i + 1 < tl.nch)
      stage_alpha_rows(stage + ((i + 1) & 1) * kSlot * kchunk, entries, e_total, tl.start, i + 1,
                       kchunk);

    // the chunk's real entries, by rounds; a pad entry has alpha = 0 and
    // leaves excl as it is
    const float* sh = stage + (i & 1) * kSlot * kchunk;
    float* pw = part + (i & 1) * nwarps * kchunk + warp * kchunk;
    unsigned* vw = votes + (i & 1) * nwarps * kchunk + warp * kchunk;
    int* lw = live + (i & 1) * nwarps * nround + warp * nround;
    const int n = min(kchunk, len - i * kchunk);
    float excl = 1.0f;
    for (int r = 0; r * kRound < n; ++r) {
      const int k0 = r * kRound;
      const float x =
          k0 + kRound <= n
              ? round_sums<true, BF16>(sh, k0, kRound, tl, cfg, trans, m, weight_thres, lane, excl, vw)
              : round_sums<false, BF16>(sh, k0, n - k0, tl, cfg, trans, m, weight_thres, lane, excl,
                                        vw);
      // x: the sum over the warp's pixels of entry k0 + col
      const bool alive = __any_sync(0xffffffffu, x != 0.0f);
      if (alive && k0 + col < n) pw[k0 + col] = x;
      if (lane == 0) lw[r] = alive;
    }
    trans *= BF16 ? round_bf16(excl) : excl;
  }
}

// dynamic shared memory of a block: two staged chunks, and two chunks'
// importance partials, count votes and live flags
inline int smem_bytes(int tile_pixels, int kchunk) {
  const int nwarps = tile_pixels / 32;
  const int nround = (kchunk + kRound - 1) / kRound;
  return 2 * (kSlot * kchunk + 2 * nwarps * kchunk + nwarps * nround) * (int)sizeof(float);
}

constexpr int kThreadsPerSM = 1024;  // threads an SM holds at most (`launch_smem`)

// The dynamic shared memory a launch asks for: what a block needs, raised
// so that an SM holds at most kThreadsPerSM threads: 2 blocks of the
// default 512 threads. The registers would let it hold 3, which then share
// each SM's issue slots three ways, so that the heaviest tiles end later.
// A 1024-pixel tile's block is then alone on its SM,
// 32 warps as at 16x32, and its 74,752 B of need fit well under the cap.
inline cudaError_t launch_smem(int tile_pixels, int kchunk, int* smem) {
  int dev, per_sm, reserved;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return err;
  const int blocks = max(1, kThreadsPerSM / tile_pixels);
  *smem = max(smem_bytes(tile_pixels, kchunk), per_sm / (blocks + 1) - reserved + 1);
  return cudaSuccess;
}

// the instance for chunk K: the default K = 128 with K known at compile
// time, any other K from its argument
using Kernel = decltype(&stats_kernel<0, false>);
template <bool BF16>
inline Kernel kernel_for(int kchunk) {
  return kchunk == 128 ? stats_kernel<128, BF16> : stats_kernel<0, BF16>;
}

constexpr int kRankThreads = 256;

template <bool BF16>
int launch(const float* entries, long long e_total, const int* tile_start, const int* tile_len,
           const float* mask, float weight_thres, float* imp, float* cnt, int* order,
           int num_tiles, int ntx, int tile_w, int tile_h, int kchunk, const Cfg& cfg,
           void* stream) {
  if (num_tiles == 0) return 0;
  if ((tile_w * tile_h) % 32 || tile_w * tile_h > kMaxThreads) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  tile_rank_kernel<<<num_tiles, kRankThreads, 0, st>>>(tile_len, num_tiles, order);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Kernel kernel = kernel_for<BF16>(kchunk);
  int smem;
  err = launch_smem(tile_w * tile_h, kchunk, &smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_tiles, tile_w * tile_h, smem, st>>>(entries, e_total, tile_start, tile_len, mask,
                                                   weight_thres, imp, cnt, order, ntx, tile_w,
                                                   tile_h, kchunk, cfg);
  return (int)cudaGetLastError();
}

template <bool BF16>
int occupancy(int tile_pixels, int kchunk, int* registers, int* local_bytes, int* smem_bytes_out,
              int* blocks_per_sm) {
  const Kernel kernel = kernel_for<BF16>(kchunk);
  int smem;
  cudaError_t err = launch_smem(tile_pixels, kchunk, &smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes_out = smem + (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, tile_pixels, smem);
}

}  // namespace composite

// `order` is scratch of num_tiles ints: the ranking kernel writes it, the
// replay reads it.
extern "C" int composite_stats_launch(const float* entries, long long e_total,
                                      const int* tile_start, const int* tile_len,
                                      const float* mask, float weight_thres, float* imp,
                                      float* cnt, int* order, int num_tiles, int ntx, int tile_w,
                                      int tile_h, int kchunk, float alpha_cut, float alpha_max,
                                      float term_eps, float depth_lo, float depth_hi,
                                      void* stream) {
  return composite::launch<false>(entries, e_total, tile_start, tile_len, mask, weight_thres, imp,
                                  cnt, order, num_tiles, ntx, tile_w, tile_h, kchunk,
                                  {alpha_cut, alpha_max, term_eps, depth_lo, depth_hi}, stream);
}

// The bf16 pair-math instance (RasterConfig.bf16_pairs), with the same
// arguments; `alpha_max` comes rounded to bf16.
extern "C" int composite_stats_bf16_launch(const float* entries, long long e_total,
                                           const int* tile_start, const int* tile_len,
                                           const float* mask, float weight_thres, float* imp,
                                           float* cnt, int* order, int num_tiles, int ntx,
                                           int tile_w, int tile_h, int kchunk, float alpha_cut,
                                           float alpha_max, float term_eps, float depth_lo,
                                           float depth_hi, void* stream) {
  return composite::launch<true>(entries, e_total, tile_start, tile_len, mask, weight_thres, imp,
                                 cnt, order, num_tiles, ntx, tile_w, tile_h, kchunk,
                                 {alpha_cut, alpha_max, term_eps, depth_lo, depth_hi}, stream);
}

// What the build gives the kernel that a launch at this tile size and K
// runs: registers and local (spill) bytes a thread, the shared bytes a
// launch gives a block, and the blocks an SM holds (the CUDA occupancy
// query); the f32 instance, and the bf16 one.
extern "C" int composite_stats_occupancy(int tile_pixels, int kchunk, int* registers,
                                         int* local_bytes, int* smem_bytes, int* blocks_per_sm) {
  return composite::occupancy<false>(tile_pixels, kchunk, registers, local_bytes, smem_bytes,
                                     blocks_per_sm);
}

extern "C" int composite_stats_bf16_occupancy(int tile_pixels, int kchunk, int* registers,
                                              int* local_bytes, int* smem_bytes,
                                              int* blocks_per_sm) {
  return composite::occupancy<true>(tile_pixels, kchunk, registers, local_bytes, smem_bytes,
                                    blocks_per_sm);
}

COMPOSITE_EXPORT_ERRSTR(composite_stats)
