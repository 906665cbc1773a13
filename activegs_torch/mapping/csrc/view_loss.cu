// The 4-term mapping loss of one view for Hopper (sm_90a), and its backward.
//
// Replaces no Pallas kernel: activegs_tpu/mapping/trainer.py::_view_loss
// (with losses.py and core/image_ops.py::depth_to_normal) is plain jnp that
// XLA fuses. Run eagerly, the same per-pixel arithmetic dispatches about
// 200 ATen launches a view, and autograd's adjoints (of the slices, the
// replicate padding, the stacks) about 200 more, each a few microseconds
// of host work for a microsecond or less of device work. These two kernels
// do a view in one launch each (wrapper `mapping/view_loss.py::view_loss`,
// caller `trainer.batch_loss`).
//
// What it computes, one thread a pixel, a block a 32 x 8 tile:
// - `view_loss_fwd`: the masks (opacity > 1e-3, depth_gt > 0), the masked
//   L1 of colour and depth, the depth-derived normals of
//   core/image_ops.py::depth_to_normal (back-projection, masked differences
//   to the 4 replicate-padded neighbours, the four cross products,
//   rsqrt-normalised), the consistency 1 - n . d2n, and the two axis terms
//   of the edge-aware normal TV (losses.normal_tv_maps); writes the maps
//   that view_loss.py::reduce_maps sums: rgb + 0.8 depth + 0.1 consistency
//   and rgb + depth (h, w), and the TV terms (h, w - 1) and (h - 1, w). The
//   tile and a 1-pixel halo (clamped to the image: the replicate padding)
//   sit in shared memory. Every product, sum and division follows the op
//   order of view_loss.py::view_loss_maps_plain as ATen's CUDA kernels
//   round it, and nvcc contracts nothing (-fmad=false), so the maps are
//   bitwise those of the plain torch ops on the card, and so are their
//   sums, which stay torch.sum.
// - `view_loss_bwd`: the gradient of loss_v (its upstream gradient read
//   from device memory) with respect to rgb, depth and normal, in the order
//   of view_loss.py::view_loss_bwd_plain, which is the order in which
//   autograd accumulates the same terms through the plain formula, so the
//   gradients are bitwise autograd's. Nothing of the forward is saved:
//   a block loads its tile with a 2-pixel halo, works out for the tile and
//   a 1-pixel halo what each pixel's depth-to-normal stencil sends back to
//   its centre and its four neighbours, and then each pixel gathers what
//   its stencil neighbours send it. Every pixel writes its own gradients
//   once: no atomics, the same bits on every run.
//
// What bounds it on the H100: memory. The forward reads 11 floats a pixel
// and writes 4; the backward reads the same 11 (rgb_gt, depth_gt and
// opacity for the masks) and writes 7. About 150 FP32 operations a pixel
// forward and 400 backward are far below 67 TFLOP/s at these bytes. At
// 512 x 512 the bytes take about 5 us either way; the host's launch costs
// more than that, which is why the view is one launch each way.

#include <cuda_runtime.h>

namespace view_loss {

constexpr int kTW = 32, kTH = 8;  // a block's tile: 32 x 8 pixels, a thread each
constexpr int kThreads = kTW * kTH;
constexpr float kVisible = 1e-3f;  // opacity > 1e-3 is visible
constexpr float kFlat = 1e-4f;     // the TV's gate on the squared depth step
constexpr float kN2Min = 1e-24f;   // depth_to_normal's clamp under rsqrt

struct Inputs {
  const float* rgb;        // (3, h, w), contiguous
  const float* depth;      // (1, h, w)
  const float* normal;     // (3, h, w)
  const float* opacity;    // (1, h, w)
  const float* rgb_gt;     // (3, h, w)
  const float* depth_gt;   // (1, h, w)
  const float* intrinsic;  // (3, 3) normalized, contiguous
  int h, w;
  float w_depth, w_cons, w_tv;  // losses.W_DEPTH, W_CONS, W_TV
  float inv_two_sigma_sq;       // the TV's 1 / (2 sigma^2)
  float inv_px;                 // 1 / (h w)
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }

// core/quaternions.py::cross, in its op order
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// torch.sum over a channel axis of 3 that is not the innermost (the loss's
// (3, h, w) maps): ATen's CUDA reduction adds them in order
__device__ __forceinline__ float sum3_outer(float a, float b, float c) { return (a + b) + c; }

// torch.sum(n * n, dim=-1) over the innermost axis of 3 ((h, w, 3) in
// depth_to_normal): ATen's CUDA reduction splits it over two lanes, one
// adding elements 0 and 2, the other holding 1, and then adds the lanes
__device__ __forceinline__ float sum3_inner(float a, float b, float c) { return (a + c) + b; }

// clamp(x, min=lo) as ATen's: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }

// torch.sgn of a real number: 0 at 0
__device__ __forceinline__ float sgn(float x) { return (float)(0.0f < x) - (float)(x < 0.0f); }

// The camera constants of depth_to_normal: fx = K00 * w, fy = K11 * h,
// cx = K02 * w, cy = K12 * h
struct Cam {
  float fx, fy, cx, cy;
};

__device__ __forceinline__ Cam camera(const Inputs& in) {
  const float* k = in.intrinsic;
  return {k[0] * (float)in.w, k[4] * (float)in.h, k[2] * (float)in.w, k[5] * (float)in.h};
}

// d(x, y, z) / d depth at column j, row i: x = ((u - cx) / fx) depth with
// u = j + 0.5, y = ((v - cy) / fy) depth with v = i + 0.5, z = depth
__device__ __forceinline__ float ray_x(const Cam& c, int j) { return (((float)j + 0.5f) - c.cx) / c.fx; }
__device__ __forceinline__ float ray_y(const Cam& c, int i) { return (((float)i + 0.5f) - c.cy) / c.fy; }

// One pixel as the stencils see it: its back-projected point, its
// visibility and depth-gt masks (0 or 1) and its rendered normal.
struct Px {
  float px, py, pz, mv, md, n0, n1, n2;
};

__device__ __forceinline__ Px load_px(const Inputs& in, const Cam& c, int i, int j) {
  // the replicate padding: a pixel off the image reads the nearest edge pixel
  i = min(max(i, 0), in.h - 1);
  j = min(max(j, 0), in.w - 1);
  const long long plane = (long long)in.h * in.w;
  const long long o = (long long)i * in.w + j;
  const float d = in.depth[o];
  Px p;
  p.px = ray_x(c, j) * d;
  p.py = ray_y(c, i) * d;
  p.pz = d;
  p.mv = in.opacity[o] > kVisible ? 1.0f : 0.0f;
  p.md = in.depth_gt[o] > 0.0f ? 1.0f : 0.0f;
  p.n0 = in.normal[o];
  p.n1 = in.normal[plane + o];
  p.n2 = in.normal[2 * plane + o];
  return p;
}

__device__ __forceinline__ V3 point(const Px& p) { return {p.px, p.py, p.pz}; }
__device__ __forceinline__ V3 nrm(const Px& p) { return {p.n0, p.n1, p.n2}; }

// depth_to_normal's stencil at a centre c with its neighbours up, left,
// below and right (already clamped): the masked differences, the
// unnormalised normal n, its squared norm and rsqrt(max(n2, 1e-24))
struct Stencil {
  V3 pu, pl, pb, pr, n;
  float n2, r;
};

__device__ __forceinline__ Stencil stencil(const Px& c, const Px& u, const Px& l, const Px& b, const Px& r) {
  Stencil s;
  const V3 pc = mul(point(c), c.mv);
  s.pu = mul(sub(point(u), pc), u.mv);
  s.pl = mul(sub(point(l), pc), l.mv);
  s.pb = mul(sub(point(b), pc), b.mv);
  s.pr = mul(sub(point(r), pc), r.mv);
  s.n = add(add(add(cross(s.pu, s.pl), cross(s.pr, s.pu)), cross(s.pb, s.pr)), cross(s.pl, s.pb));
  s.n2 = sum3_inner(s.n.x * s.n.x, s.n.y * s.n.y, s.n.z * s.n.z);
  s.r = rsqrtf(clamp_min(s.n2, kN2Min));
  return s;
}

// the depth-derived normal: (n * r) * m
__device__ __forceinline__ V3 d2n(const Stencil& s, float m) { return mul(mul(s.n, s.r), m); }

// One TV pair (a, b): nd = sum (n_a - n_b)^2, dd = (d_a - d_b)^2, and the
// term ((dd <= 1e-4) * exp(-nd k)) * nd, as losses.normal_tv_maps
struct TvPair {
  V3 diff;
  float nd, gate, e, term;
};

__device__ __forceinline__ TvPair tv_pair(const Px& a, const Px& b, float k) {
  TvPair t;
  t.diff = sub(nrm(a), nrm(b));
  t.nd = sum3_outer(t.diff.x * t.diff.x, t.diff.y * t.diff.y, t.diff.z * t.diff.z);
  const float dz = a.pz - b.pz;
  t.gate = dz * dz <= kFlat ? 1.0f : 0.0f;
  t.e = expf(-t.nd * k);
  t.term = (t.gate * t.e) * t.nd;
  return t;
}

// either pixel of a pair has depth (the masks are boolean: m_a + m_b is
// their `or`)
__device__ __forceinline__ float pair_mask(const Px& a, const Px& b) {
  return (a.md != 0.0f || b.md != 0.0f) ? 1.0f : 0.0f;
}

constexpr int kH1W = kTW + 2, kH1H = kTH + 2;  // the tile with a 1-pixel halo
constexpr int kH2W = kTW + 4, kH2H = kTH + 4;  // with a 2-pixel halo

__global__ void __launch_bounds__(kThreads)
    view_loss_fwd_kernel(const Inputs in, float* __restrict__ map_loss, float* __restrict__ map_err,
                         float* __restrict__ tv_x, float* __restrict__ tv_y) {
  __shared__ Px tile[kH1H][kH1W];
  const int i0 = blockIdx.y * kTH, j0 = blockIdx.x * kTW;
  const int tid = threadIdx.y * kTW + threadIdx.x;
  const Cam cam = camera(in);
  for (int s = tid; s < kH1H * kH1W; s += kThreads) {
    const int ly = s / kH1W, lx = s % kH1W;
    tile[ly][lx] = load_px(in, cam, i0 + ly - 1, j0 + lx - 1);
  }
  __syncthreads();
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  if (i >= in.h || j >= in.w) return;
  const int ly = threadIdx.y + 1, lx = threadIdx.x + 1;
  const Px& c = tile[ly][lx];
  const long long plane = (long long)in.h * in.w;
  const long long o = (long long)i * in.w + j;

  // masked L1: rgb_px = sum_c |(rgb - gt) mv| / 3 (ATen divides by a
  // host scalar as a product with its float reciprocal)
  float a[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) a[ch] = fabsf((in.rgb[ch * plane + o] - in.rgb_gt[ch * plane + o]) * c.mv);
  const float rgb_px = sum3_outer(a[0], a[1], a[2]) * (1.0f / 3.0f);
  const float depth_px = fabsf((c.pz - in.depth_gt[o]) * c.md);

  // consistency: (1 - sum_c normal_c d2n_c) mv
  const Stencil st = stencil(c, tile[ly - 1][lx], tile[ly][lx - 1], tile[ly + 1][lx], tile[ly][lx + 1]);
  const V3 dn = d2n(st, c.mv);
  const float cons_px = (1.0f - sum3_outer(c.n0 * dn.x, c.n1 * dn.y, c.n2 * dn.z)) * c.mv;

  map_loss[o] = (rgb_px + in.w_depth * depth_px) + in.w_cons * cons_px;
  map_err[o] = rgb_px + depth_px;
  if (j + 1 < in.w) {
    const Px& b = tile[ly][lx + 1];
    tv_x[(long long)i * (in.w - 1) + j] = tv_pair(c, b, in.inv_two_sigma_sq).term * pair_mask(c, b);
  }
  if (i + 1 < in.h) {
    const Px& b = tile[ly + 1][lx];
    tv_y[o] = tv_pair(c, b, in.inv_two_sigma_sq).term * pair_mask(c, b);
  }
}

// What one pixel's stencil sends back to the points it read: to its own
// point (c0) and to the points of its up, left, below and right slots,
// and its depth-derived normal (for its own consistency gradient).
struct Sends {
  V3 c0, cu, cl, cb, cr, d2n;
};

// The stencil's backward at one pixel q: the consistency's cotangent on
// d2n is -((g1 w_cons) mv) normal; through d2n = (n r) m, the rsqrt and
// clamp, n2 = n . n, the four cross products and the masked differences.
__device__ __forceinline__ Sends stencil_bwd(const Px& c, const Px& u, const Px& l, const Px& b, const Px& r,
                                             float g_cons) {
  Sends out;
  const Stencil s = stencil(c, u, l, b, r);
  out.d2n = d2n(s, c.mv);
  const float q = -(g_cons * c.mv);
  const V3 dnn = mul(mul(nrm(c), q), c.mv);
  // n * r: r is broadcast over the 3 channels; autograd sums them over a
  // gradient laid out channel by channel, in order
  const float dr = sum3_outer(dnn.x * s.n.x, dnn.y * s.n.y, dnn.z * s.n.z);
  // rsqrt: -0.5 grad r^3; clamp: the gradient passes where n2 >= 1e-24
  const float dn2 = s.n2 >= kN2Min ? (-0.5f * dr) * ((s.r * s.r) * s.r) : 0.0f;
  // n2 = sum n * n: each factor's dn2 n, added one after the other
  const V3 dn = add(add(mul(dnn, s.r), mul(s.n, dn2)), mul(s.n, dn2));
  // n = pu x pl + pr x pu + pb x pr + pl x pb; for a x b the adjoints
  // are b x dn and dn x a
  const V3 dpu = add(cross(s.pl, dn), cross(dn, s.pr));
  const V3 dpl = add(cross(dn, s.pu), cross(s.pb, dn));
  const V3 dpb = add(cross(s.pr, dn), cross(dn, s.pl));
  const V3 dpr = add(cross(s.pu, dn), cross(dn, s.pb));
  // p_k = (P_k - pc) m_k: P_k gets dp_k m_k, pc its negation
  out.cu = mul(dpu, u.mv);
  out.cl = mul(dpl, l.mv);
  out.cb = mul(dpb, b.mv);
  out.cr = mul(dpr, r.mv);
  // pc = P_c m_c; pc's four terms in the order autograd adds them
  out.c0 = mul(neg(add(add(add(out.cr, out.cb), out.cl), out.cu)), c.mv);
  return out;
}

// A TV pair's cotangent on its normal difference: the pair's weight gt
// (the upstream gradient through W_TV / (4 h w)) times its mask, through
// term = (gate e) nd, e = exp(-nd k), nd = sum diff^2.
__device__ __forceinline__ V3 tv_pair_bwd(const Px& a, const Px& b, float gt, float k) {
  const TvPair t = tv_pair(a, b, k);
  const float dterm = gt * pair_mask(a, b);
  const float dnd = dterm * (t.gate * t.e) + -((((dterm * t.nd) * t.gate) * t.e) * k);
  return mul(t.diff, dnd * 2.0f);
}

__global__ void __launch_bounds__(kThreads)
    view_loss_bwd_kernel(const Inputs in, const float* __restrict__ g_loss, float* __restrict__ d_rgb,
                         float* __restrict__ d_depth, float* __restrict__ d_normal) {
  __shared__ Px tile[kH2H][kH2W];
  __shared__ Sends sends[kH1H][kH1W];
  const int i0 = blockIdx.y * kTH, j0 = blockIdx.x * kTW;
  const int tid = threadIdx.y * kTW + threadIdx.x;
  const Cam cam = camera(in);
  for (int s = tid; s < kH2H * kH2W; s += kThreads) {
    const int ly = s / kH2W, lx = s % kH2W;
    tile[ly][lx] = load_px(in, cam, i0 + ly - 2, j0 + lx - 2);
  }
  const float g = *g_loss;
  // d map_loss = g / (h w); through the weights
  const float g1 = g * in.inv_px;
  const float g_cons = g1 * in.w_cons;
  __syncthreads();
  // what the stencils of the tile and its 1-pixel halo send back; a halo
  // pixel off the image has no stencil and sends nothing
  for (int s = tid; s < kH1H * kH1W; s += kThreads) {
    const int ly = s / kH1W, lx = s % kH1W;
    const int i = i0 + ly - 1, j = j0 + lx - 1;
    if (i < 0 || j < 0 || i >= in.h || j >= in.w) continue;
    const int y = ly + 1, x = lx + 1;  // in `tile`
    sends[ly][lx] = stencil_bwd(tile[y][x], tile[y - 1][x], tile[y][x - 1], tile[y + 1][x], tile[y][x + 1], g_cons);
  }
  __syncthreads();
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  if (i >= in.h || j >= in.w) return;
  const int ly = threadIdx.y + 1, lx = threadIdx.x + 1;  // in `sends`
  const int y = ly + 1, x = lx + 1;                      // in `tile`
  const Px& c = tile[y][x];
  const long long plane = (long long)in.h * in.w;
  const long long o = (long long)i * in.w + j;

  // masked L1 colour: d rgb_c = ((g1 / 3) sgn(e_c)) mv
  const float g_rgb = g1 * (1.0f / 3.0f);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float e = (in.rgb[ch * plane + o] - in.rgb_gt[ch * plane + o]) * c.mv;
    d_rgb[ch * plane + o] = (g_rgb * sgn(e)) * c.mv;
  }

  // depth: its masked L1, and what the stencils send to its point, summed
  // in the order autograd accumulates them through the slices of the
  // padded points and the padding's adjoint: the left neighbour's right
  // slot, the upper's lower, the right's left, the lower's upper, its own
  // point (c0), then its own slots that the replicate padding points back
  // at it on an edge (right, left, below, above); then through
  // p = (x, y, depth), z first
  const float g_l1 = ((g1 * in.w_depth) * sgn((c.pz - in.depth_gt[o]) * c.md)) * c.md;
  V3 dp = {0.0f, 0.0f, 0.0f};
  if (j > 0) dp = add(dp, sends[ly][lx - 1].cr);
  if (i > 0) dp = add(dp, sends[ly - 1][lx].cb);
  if (j + 1 < in.w) dp = add(dp, sends[ly][lx + 1].cl);
  if (i + 1 < in.h) dp = add(dp, sends[ly + 1][lx].cu);
  dp = add(dp, sends[ly][lx].c0);
  if (j == in.w - 1) dp = add(dp, sends[ly][lx].cr);
  if (j == 0) dp = add(dp, sends[ly][lx].cl);
  if (i == in.h - 1) dp = add(dp, sends[ly][lx].cb);
  if (i == 0) dp = add(dp, sends[ly][lx].cu);
  d_depth[o] = g_l1 + ((dp.z + dp.y * ray_y(cam, i)) + dp.x * ray_x(cam, j));

  // normal: the consistency's -((g1 w_cons) mv) d2n, and the TV pairs in
  // autograd's order: it is the second of the pair above, the first of
  // the one below, the second of the left one, the first of the right
  const float gt = (g * in.w_tv) * (1.0f / (float)(4LL * in.h * in.w));
  const float k = in.inv_two_sigma_sq;
  V3 tv = {0.0f, 0.0f, 0.0f};
  if (i > 0) tv = sub(tv, tv_pair_bwd(tile[y - 1][x], c, gt, k));
  if (i + 1 < in.h) tv = add(tv, tv_pair_bwd(c, tile[y + 1][x], gt, k));
  if (j > 0) tv = sub(tv, tv_pair_bwd(tile[y][x - 1], c, gt, k));
  if (j + 1 < in.w) tv = add(tv, tv_pair_bwd(c, tile[y][x + 1], gt, k));
  const V3 dn = add(mul(sends[ly][lx].d2n, -(g_cons * c.mv)), tv);
  d_normal[o] = dn.x;
  d_normal[plane + o] = dn.y;
  d_normal[2 * plane + o] = dn.z;
}

inline dim3 grid_of(int h, int w) { return dim3((w + kTW - 1) / kTW, (h + kTH - 1) / kTH); }

}  // namespace view_loss

using view_loss::Inputs;

static Inputs inputs(const float* rgb, const float* depth, const float* normal, const float* opacity,
                     const float* rgb_gt, const float* depth_gt, const float* intrinsic, int h, int w,
                     float w_depth, float w_cons, float w_tv, float inv_two_sigma_sq, float inv_px) {
  return Inputs{rgb, depth, normal, opacity, rgb_gt, depth_gt, intrinsic, h, w,
                w_depth, w_cons, w_tv, inv_two_sigma_sq, inv_px};
}

// Every tensor float32 and contiguous: rgb, normal, rgb_gt (3, h, w);
// depth, opacity, depth_gt (1, h, w); intrinsic (3, 3). Writes map_loss
// and map_err (h, w), tv_x (h, w - 1), tv_y (h - 1, w). Returns the
// launch's CUDA error code.
extern "C" int view_loss_fwd_launch(const float* rgb, const float* depth, const float* normal,
                                    const float* opacity, const float* rgb_gt, const float* depth_gt,
                                    const float* intrinsic, int h, int w, float w_depth, float w_cons,
                                    float w_tv, float inv_two_sigma_sq, float inv_px, float* map_loss,
                                    float* map_err, float* tv_x, float* tv_y, void* stream) {
  const Inputs in = inputs(rgb, depth, normal, opacity, rgb_gt, depth_gt, intrinsic, h, w, w_depth, w_cons,
                           w_tv, inv_two_sigma_sq, inv_px);
  view_loss::view_loss_fwd_kernel<<<view_loss::grid_of(h, w), dim3(view_loss::kTW, view_loss::kTH), 0,
                                    (cudaStream_t)stream>>>(in, map_loss, map_err, tv_x, tv_y);
  return (int)cudaGetLastError();
}

// The backward: the same inputs, the upstream gradient of loss_v (one
// float on the device), and the gradients of rgb (3, h, w), depth (1, h, w)
// and normal (3, h, w), contiguous.
extern "C" int view_loss_bwd_launch(const float* rgb, const float* depth, const float* normal,
                                    const float* opacity, const float* rgb_gt, const float* depth_gt,
                                    const float* intrinsic, int h, int w, float w_depth, float w_cons,
                                    float w_tv, float inv_two_sigma_sq, float inv_px, const float* g_loss,
                                    float* d_rgb, float* d_depth, float* d_normal, void* stream) {
  const Inputs in = inputs(rgb, depth, normal, opacity, rgb_gt, depth_gt, intrinsic, h, w, w_depth, w_cons,
                           w_tv, inv_two_sigma_sq, inv_px);
  view_loss::view_loss_bwd_kernel<<<view_loss::grid_of(h, w), dim3(view_loss::kTW, view_loss::kTH), 0,
                                    (cudaStream_t)stream>>>(in, g_loss, d_rgb, d_depth, d_normal);
  return (int)cudaGetLastError();
}

extern "C" const char* view_loss_errstr(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
