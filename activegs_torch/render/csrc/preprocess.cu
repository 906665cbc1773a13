// Per-gaussian view preprocessing for Hopper (sm_90a), and its backward.
//
// Replaces no Pallas kernel: activegs_tpu/render/preprocess.py::preprocess
// is plain jnp that XLA fuses into a few loops, and its gradient is XLA's
// transpose of them. Run eagerly, the same ~150 lines of (N,) arithmetic
// dispatch some 300 ATen launches a call, and autograd's transpose some
// 480 more, each a few microseconds of host work for about 2 us of device
// work. These two kernels do the call in one launch each (wrapper
// `render/preprocess.py::preprocess`, caller `renderer._view_entries`,
// `prepare_view_bins`, `render_stats`, the trainer's and planner's view
// counts).
//
// What it computes, one thread per gaussian:
// - `preprocess_fwd`: the world-to-camera transform (the rigid inverse of
//   the camera-to-world extrinsic, as core/geometry.py::invert_rigid forms
//   it), the projected center, the EWA 2D covariance through the clamped
//   Jacobian, its conic, the screen radius and extents, the surfel plane
//   and the in-view test; writes params2d (N, 24), radius, depth_z and
//   in_view. Every product, sum, division and sqrt follows the op order of
//   render/preprocess.py::_project, and nvcc contracts nothing
//   (-fmad=false), so the outputs are bitwise those of the plain torch ops
//   on the card (each ATen elementwise launch rounds once per op).
// - `preprocess_bwd`: recomputes the forward's intermediates from the
//   inputs (nothing of (N,) size is saved between the passes) and chains
//   the cotangent of params2d (rows 0..17; zero where not in view) and of
//   depth_z back to the means, scales, rotations, opacities, colors and
//   confidences, in the op order of render/preprocess.py::
//   preprocess_bwd_plain. Each thread writes its own gaussian's gradients
//   once: no atomics.
//
// What bounds it on the H100: memory. A call reads 15 input floats and
// `valid` and writes 27 output values a gaussian (the backward reads only
// the means, scales, rotations and `valid` of those, and 18 cotangent
// floats, and writes up to 15 gradients);
// about 250 FP32 operations a gaussian in the forward and 700 in the
// backward are far below the 67 TFLOP/s at these byte counts. On an
// H100 at the train cell's subset bucket of 32,768 gaussians the two
// kernels take 5.2 and 4.3 us of device time against 1.6 and 1.7 us for
// their bytes: one wave of 128 blocks, so latency holds them, and the
// host's launch (about 0.1 ms) costs twenty times either. The launch
// count, not the work, is the cost, which is the point of having one
// launch a call.

#include <cuda_runtime.h>

namespace preprocess {

constexpr int kParamDim = 24;  // render/types.py PARAM_DIM
constexpr int kUsedRows = 18;  // rows that carry gradient (ext_x, ext_y and the pad do not)
constexpr int kThreads = 256;

struct Inputs {
  const float* means;  // (N, 3), rows `ms` floats apart, unit inner stride
  const float* scales;
  const float* rotations;  // (N, 4) wxyz
  const float* opacities;  // (N,), `os` floats apart
  const float* colors;
  const float* confidences;
  const unsigned char* valid;  // torch.bool
  long long ms, ss, rs, os, cs, fs, vs;
  const float* extrinsic;  // (4, 4) camera-to-world, contiguous
  const float* intrinsic;  // (3, 3) normalized, contiguous
  long long n;
  int h, w, front_only;
  float near_z, tan_clamp, lowpass, sigma_extent;
};

// clamp(x, min=lo) as ATen's: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// The view's constants. r[i][j] is the world-to-camera rotation, whose
// rows are the extrinsic's columns; t = -(r_c2w^T t_c2w), summed as
// geometry.apply_rotation sums. fx = K00 * w, and lim_x = tan_clamp *
// ((1 / fx) * (0.5 * w)), as `tan_clamp * (0.5 * w / fx)` evaluates on a
// tensor fx.
struct View {
  float r[3][3], t[3];
  float fx, fy, cx, cy, lim_x, lim_y;
};

__device__ __forceinline__ View view_of(const Inputs& in) {
  View v;
  const float* e = in.extrinsic;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) v.r[i][j] = e[j * 4 + i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    v.t[i] = -((v.r[i][0] * e[3] + v.r[i][1] * e[7]) + v.r[i][2] * e[11]);
  const float* k = in.intrinsic;
  const float w = (float)in.w, h = (float)in.h;
  v.fx = k[0] * w;
  v.fy = k[4] * h;
  v.cx = k[2] * w;
  v.cy = k[5] * h;
  v.lim_x = ((1.0f / v.fx) * (float)(0.5 * in.w)) * in.tan_clamp;
  v.lim_y = ((1.0f / v.fy) * (float)(0.5 * in.h)) * in.tan_clamp;
  return v;
}

// One gaussian's forward intermediates (render/preprocess.py::_project).
struct Terms {
  float m[3], q[4], sc[3];
  float px, py, pz, zs, inv_z, fpx, fpy, mean_x, mean_y;
  bool in_front, in_view;
  float R[3][3], s[3];
  float c00, c01, c02, c11, c12, c22;
  float vx, vy, clx, cly, tx, ty;
  float j00, u1x, u2x, j02, j11, u1y, u2y, j12;
  float a[3], b[3], ca[3], cb[3];
  float cov_a, cov_b, cov_c, det, inv_det;
  float radius, ext_x, ext_y;
  float nc[3], plane_dot, pa, pb, pc;
};

__device__ __forceinline__ Terms project(const Inputs& in, const View& v, long long i) {
  Terms T;
  const float* mp = in.means + i * in.ms;
  const float* sp = in.scales + i * in.ss;
  const float* qp = in.rotations + i * in.rs;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    T.m[j] = mp[j];
    T.sc[j] = sp[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) T.q[j] = qp[j];
  const float mx = T.m[0], my = T.m[1], mz = T.m[2];
  const float(*r)[3] = v.r;
  T.px = r[0][0] * mx + r[0][1] * my + r[0][2] * mz + v.t[0];
  T.py = r[1][0] * mx + r[1][1] * my + r[1][2] * mz + v.t[1];
  T.pz = r[2][0] * mx + r[2][1] * my + r[2][2] * mz + v.t[2];

  T.in_front = T.pz > in.near_z;
  T.zs = T.in_front ? T.pz : 1.0f;
  T.inv_z = 1.0f / T.zs;
  T.fpx = v.fx * T.px;
  T.fpy = v.fy * T.py;
  T.mean_x = T.fpx * T.inv_z + v.cx;
  T.mean_y = T.fpy * T.inv_z + v.cy;

  const float qw = T.q[0], qx = T.q[1], qy = T.q[2], qz = T.q[3];
  T.R[0][0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  T.R[0][1] = 2.0f * (qx * qy - qw * qz);
  T.R[0][2] = 2.0f * (qx * qz + qw * qy);
  T.R[1][0] = 2.0f * (qx * qy + qw * qz);
  T.R[1][1] = 1.0f - 2.0f * (qx * qx + qz * qz);
  T.R[1][2] = 2.0f * (qy * qz - qw * qx);
  T.R[2][0] = 2.0f * (qx * qz - qw * qy);
  T.R[2][1] = 2.0f * (qy * qz + qw * qx);
  T.R[2][2] = 1.0f - 2.0f * (qx * qx + qy * qy);
  const float(*R)[3] = T.R;

#pragma unroll
  for (int k = 0; k < 3; ++k) T.s[k] = T.sc[k] * T.sc[k];
  const float s0 = T.s[0], s1 = T.s[1], s2 = T.s[2];

  // cov3d = R diag(s^2) R^T
  T.c00 = s0 * R[0][0] * R[0][0] + s1 * R[0][1] * R[0][1] + s2 * R[0][2] * R[0][2];
  T.c01 = s0 * R[0][0] * R[1][0] + s1 * R[0][1] * R[1][1] + s2 * R[0][2] * R[1][2];
  T.c02 = s0 * R[0][0] * R[2][0] + s1 * R[0][1] * R[2][1] + s2 * R[0][2] * R[2][2];
  T.c11 = s0 * R[1][0] * R[1][0] + s1 * R[1][1] * R[1][1] + s2 * R[1][2] * R[1][2];
  T.c12 = s0 * R[1][0] * R[2][0] + s1 * R[1][1] * R[2][1] + s2 * R[1][2] * R[2][2];
  T.c22 = s0 * R[2][0] * R[2][0] + s1 * R[2][1] * R[2][1] + s2 * R[2][2] * R[2][2];

  // frustum-clamped Jacobian point
  T.vx = T.px * T.inv_z;
  T.vy = T.py * T.inv_z;
  T.clx = clamp(T.vx, -v.lim_x, v.lim_x);
  T.cly = clamp(T.vy, -v.lim_y, v.lim_y);
  T.tx = T.clx * T.zs;
  T.ty = T.cly * T.zs;

  T.j00 = v.fx * T.inv_z;
  T.u1x = -v.fx * T.tx;
  T.u2x = T.u1x * T.inv_z;
  T.j02 = T.u2x * T.inv_z;
  T.j11 = v.fy * T.inv_z;
  T.u1y = -v.fy * T.ty;
  T.u2y = T.u1y * T.inv_z;
  T.j12 = T.u2y * T.inv_z;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T.a[k] = T.j00 * r[0][k] + T.j02 * r[2][k];
    T.b[k] = T.j11 * r[1][k] + T.j12 * r[2][k];
  }
  const float *a = T.a, *b = T.b;

  // cov2d = T cov3d T^T + pixel low-pass
  T.ca[0] = a[0] * T.c00 + a[1] * T.c01 + a[2] * T.c02;
  T.ca[1] = a[0] * T.c01 + a[1] * T.c11 + a[2] * T.c12;
  T.ca[2] = a[0] * T.c02 + a[1] * T.c12 + a[2] * T.c22;
  T.cov_a = T.ca[0] * a[0] + T.ca[1] * a[1] + T.ca[2] * a[2] + in.lowpass;
  T.cov_b = T.ca[0] * b[0] + T.ca[1] * b[1] + T.ca[2] * b[2];
  T.cb[0] = b[0] * T.c00 + b[1] * T.c01 + b[2] * T.c02;
  T.cb[1] = b[0] * T.c01 + b[1] * T.c11 + b[2] * T.c12;
  T.cb[2] = b[0] * T.c02 + b[1] * T.c12 + b[2] * T.c22;
  T.cov_c = T.cb[0] * b[0] + T.cb[1] * b[1] + T.cb[2] * b[2] + in.lowpass;

  T.det = T.cov_a * T.cov_c - T.cov_b * T.cov_b;
  T.inv_det = 1.0f / clamp_min(T.det, 1e-12f);

  // screen extents (no gradient)
  const float mid = 0.5f * (T.cov_a + T.cov_c);
  const float eig_max = mid + sqrtf(clamp_min(mid * mid - T.det, 0.0f));
  T.radius = ceilf(in.sigma_extent * sqrtf(eig_max));
  T.ext_x = ceilf(in.sigma_extent * sqrtf(clamp_min(T.cov_a, 0.0f)));
  T.ext_y = ceilf(in.sigma_extent * sqrtf(clamp_min(T.cov_c, 0.0f)));

  // surfel plane: the world normal is R's third column
#pragma unroll
  for (int k = 0; k < 3; ++k) T.nc[k] = r[k][0] * R[0][2] + r[k][1] * R[1][2] + r[k][2] * R[2][2];
  T.plane_dot = T.nc[0] * T.px + T.nc[1] * T.py + T.nc[2] * T.pz;
  T.pa = T.nc[0] / v.fx;
  T.pb = T.nc[1] / v.fy;
  T.pc = T.nc[2] - T.pa * v.cx - T.pb * v.cy;

  T.in_view = in.valid[i * in.vs] && T.in_front && T.det > 1e-12f && T.mean_x + T.radius > 0.0f &&
              T.mean_x - T.radius < (float)in.w && T.mean_y + T.radius > 0.0f &&
              T.mean_y - T.radius < (float)in.h;
  if (in.front_only) T.in_view = T.in_view && T.plane_dot < 0.0f;
  return T;
}

// Named apart from the compositor's `fwd_kernel` and `bwd_kernel`, which
// the benchmark's roofline readers find in a device trace by those names.
__global__ void __launch_bounds__(kThreads)
    preprocess_fwd_kernel(Inputs in, float* __restrict__ params2d, float* __restrict__ radius,
                          float* __restrict__ depth_z, unsigned char* __restrict__ in_view) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= in.n) return;
  const View v = view_of(in);
  const Terms T = project(in, v, i);
  const bool iv = T.in_view;
  float row[kParamDim] = {
      T.mean_x, T.mean_y, T.cov_c * T.inv_det, -T.cov_b * T.inv_det, T.cov_a * T.inv_det,
      in.opacities[i * in.os], in.colors[i * in.cs], in.colors[i * in.cs + 1],
      in.colors[i * in.cs + 2], T.nc[0], T.nc[1], T.nc[2], T.pa, T.pb, T.pc, T.plane_dot,
      in.confidences[i * in.fs], T.pz, T.ext_x, T.ext_y, 0.0f, 0.0f, 0.0f, 0.0f};
  // rows of 96 bytes from a 16-byte aligned base (the wrapper checks)
  float4* out = reinterpret_cast<float4*>(params2d + i * kParamDim);
#pragma unroll
  for (int c = 0; c < kParamDim / 4; ++c)
    out[c] = iv ? make_float4(row[4 * c], row[4 * c + 1], row[4 * c + 2], row[4 * c + 3])
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  radius[i] = iv ? T.radius : 0.0f;
  depth_z[i] = T.pz;
  in_view[i] = iv ? 1 : 0;
}

struct Grads {
  float* means;  // (N, 3) contiguous; each may be null (not needed)
  float* scales;
  float* rotations;  // (N, 4)
  float* opacities;  // (N,)
  float* colors;
  float* confidences;
};

__global__ void __launch_bounds__(kThreads)
    preprocess_bwd_kernel(Inputs in, const float* __restrict__ dparams2d,
                          const float* __restrict__ ddepth_z, Grads out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= in.n) return;
  const View v = view_of(in);
  const Terms T = project(in, v, i);
  const float(*r)[3] = v.r;
  const float(*R)[3] = T.R;
  // the six unique entries of cov3d as (x, y) of R's rows, in the order
  // the chain visits them (constant indices once the loops unroll)
  const int pair_x[6] = {0, 0, 0, 1, 1, 2}, pair_y[6] = {0, 1, 2, 1, 2, 2};

  // the cotangent rows, zero where out of view (the forward's mask)
  float g[kUsedRows];
#pragma unroll
  for (int c = 0; c < kUsedRows; ++c)
    g[c] = (T.in_view && dparams2d != nullptr) ? dparams2d[i * kParamDim + c] : 0.0f;
  float g_pz = ddepth_z != nullptr ? g[17] + ddepth_z[i] : g[17];

  // surfel plane: pc = (ncz - pa cx) - pb cy, pa = ncx / fx, pb = ncy / fy
  const float g_pc = g[14];
  const float g_pa = g[12] + (-g_pc) * v.cx;
  const float g_pb = g[13] + (-g_pc) * v.cy;
  const float g_pd = g[15];
  const float g_ncx = (g[9] + g_pa / v.fx) + g_pd * T.px;
  const float g_ncy = (g[10] + g_pb / v.fy) + g_pd * T.py;
  const float g_ncz = (g[11] + g_pc) + g_pd * T.pz;
  float g_px = g_pd * T.nc[0];
  float g_py = g_pd * T.nc[1];
  g_pz = g_pz + g_pd * T.nc[2];
  float gR[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    gR[k][0] = 0.0f;
    gR[k][1] = 0.0f;
    gR[k][2] = g_ncx * r[0][k] + g_ncy * r[1][k] + g_ncz * r[2][k];
  }

  // conic = (cov_c, -cov_b, cov_a) / clamp(det, 1e-12)
  const float g_inv_det = (g[2] * T.cov_c - g[3] * T.cov_b) + g[4] * T.cov_a;
  float g_cov_a = g[4] * T.inv_det;
  float g_cov_b = -(g[3] * T.inv_det);
  float g_cov_c = g[2] * T.inv_det;
  const float g_det = T.det >= 1e-12f ? -(g_inv_det * (T.inv_det * T.inv_det)) : 0.0f;
  g_cov_a = g_cov_a + g_det * T.cov_c;
  g_cov_c = g_cov_c + g_det * T.cov_a;
  g_cov_b = g_cov_b - 2.0f * (g_det * T.cov_b);

  // cov2d: cov_a = ca . a, cov_b = ca . b, cov_c = cb . b; ca = C a, cb = C b
  float g_ca[3], g_cb[3], g_a[3], g_b[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_ca[k] = g_cov_a * T.a[k] + g_cov_b * T.b[k];
    g_cb[k] = g_cov_c * T.b[k];
    g_a[k] = g_cov_a * T.ca[k];
    g_b[k] = g_cov_b * T.ca[k] + g_cov_c * T.cb[k];
  }
  const float C[3][3] = {{T.c00, T.c01, T.c02}, {T.c01, T.c11, T.c12}, {T.c02, T.c12, T.c22}};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_a[k] = g_a[k] + (g_ca[0] * C[0][k] + g_ca[1] * C[1][k] + g_ca[2] * C[2][k]);
    g_b[k] = g_b[k] + (g_cb[0] * C[0][k] + g_cb[1] * C[1][k] + g_cb[2] * C[2][k]);
  }
  float g_c[6];
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const int x = pair_x[p], y = pair_y[p];
    g_c[p] = x == y ? g_ca[x] * T.a[x] + g_cb[x] * T.b[x]
                    : (g_ca[x] * T.a[y] + g_ca[y] * T.a[x]) + (g_cb[x] * T.b[y] + g_cb[y] * T.b[x]);
  }

  // T = J W: a_k = j00 r0k + j02 r2k, b_k = j11 r1k + j12 r2k
  const float g_j00 = g_a[0] * r[0][0] + g_a[1] * r[0][1] + g_a[2] * r[0][2];
  const float g_j02 = g_a[0] * r[2][0] + g_a[1] * r[2][1] + g_a[2] * r[2][2];
  const float g_j11 = g_b[0] * r[1][0] + g_b[1] * r[1][1] + g_b[2] * r[1][2];
  const float g_j12 = g_b[0] * r[2][0] + g_b[1] * r[2][1] + g_b[2] * r[2][2];
  // J: j00 = fx inv_z, j02 = ((-fx tx) inv_z) inv_z
  const float g_u2x = g_j02 * T.inv_z;
  const float g_u1x = g_u2x * T.inv_z;
  const float g_tx = g_u1x * -v.fx;
  const float g_u2y = g_j12 * T.inv_z;
  const float g_u1y = g_u2y * T.inv_z;
  const float g_ty = g_u1y * -v.fy;
  float g_inv_z = ((g_j00 * v.fx + g_j02 * T.u2x) + g_u2x * T.u1x) +
                  ((g_j11 * v.fy + g_j12 * T.u2y) + g_u2y * T.u1y);
  // tx = clamp(px inv_z, -lim_x, lim_x) zs: gradient where lo <= x <= hi
  float g_zs = g_tx * T.clx + g_ty * T.cly;
  const float g_vx = (T.vx >= -v.lim_x && T.vx <= v.lim_x) ? g_tx * T.zs : 0.0f;
  const float g_vy = (T.vy >= -v.lim_y && T.vy <= v.lim_y) ? g_ty * T.zs : 0.0f;
  g_px = g_px + g_vx * T.inv_z;
  g_py = g_py + g_vy * T.inv_z;
  g_inv_z = g_inv_z + (g_vx * T.px + g_vy * T.py);
  // mean = (f p) inv_z + c
  const float g_fpx = g[0] * T.inv_z;
  const float g_fpy = g[1] * T.inv_z;
  g_px = g_px + g_fpx * v.fx;
  g_py = g_py + g_fpy * v.fy;
  g_inv_z = g_inv_z + (g[0] * T.fpx + g[1] * T.fpy);
  // inv_z = 1 / zs, zs = where(in_front, pz, 1)
  g_zs = g_zs - g_inv_z * (T.inv_z * T.inv_z);
  g_pz = g_pz + (T.in_front ? g_zs : 0.0f);

  if (out.means != nullptr) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out.means[i * 3 + j] = g_px * r[0][j] + g_py * r[1][j] + g_pz * r[2][j];
  }

  // cov3d: c_xy = sum_k (s_k R_xk) R_yk
  float g_s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const int x = pair_x[p], y = pair_y[p];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float gw = g_c[p] * R[y][k];
      gR[y][k] = gR[y][k] + g_c[p] * (T.s[k] * R[x][k]);
      g_s[k] = g_s[k] + gw * R[x][k];
      gR[x][k] = gR[x][k] + gw * T.s[k];
    }
  }
  if (out.scales != nullptr) {
#pragma unroll
    for (int k = 0; k < 3; ++k) out.scales[i * 3 + k] = g_s[k] * (2.0f * T.sc[k]);
  }

  if (out.rotations != nullptr) {
    // R(q): diagonal R_kk = 1 - 2 (..), off-diagonal 2 (..)
    const float qw = T.q[0], qx = T.q[1], qy = T.q[2], qz = T.q[3];
    const float e00 = -2.0f * gR[0][0], e11 = -2.0f * gR[1][1], e22 = -2.0f * gR[2][2];
    const float h01 = 2.0f * gR[0][1], h02 = 2.0f * gR[0][2], h10 = 2.0f * gR[1][0];
    const float h12 = 2.0f * gR[1][2], h20 = 2.0f * gR[2][0], h21 = 2.0f * gR[2][1];
    float* dq = out.rotations + i * 4;
    dq[0] = (h02 * qy + h10 * qz + h21 * qx) - (h01 * qz + h12 * qx + h20 * qy);
    dq[1] = (2.0f * (e11 * qx) + 2.0f * (e22 * qx)) + (h01 * qy + h02 * qz + h10 * qy + h20 * qz + h21 * qw) -
            h12 * qw;
    dq[2] = (2.0f * (e00 * qy) + 2.0f * (e22 * qy)) + (h01 * qx + h02 * qw + h10 * qx + h12 * qz + h21 * qz) -
            h20 * qw;
    dq[3] = (2.0f * (e00 * qz) + 2.0f * (e11 * qz)) + (h02 * qx + h10 * qw + h12 * qy + h20 * qx + h21 * qy) -
            h01 * qw;
  }
  if (out.opacities != nullptr) out.opacities[i] = g[5];
  if (out.colors != nullptr) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out.colors[i * 3 + j] = g[6 + j];
  }
  if (out.confidences != nullptr) out.confidences[i] = g[16];
}

inline unsigned grid_of(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace preprocess

using preprocess::Inputs;

static Inputs inputs(const float* means, const float* scales, const float* rotations,
                     const float* opacities, const float* colors, const float* confidences,
                     const unsigned char* valid, const long long* strides, const float* extrinsic,
                     const float* intrinsic, long long n, int h, int w, float near_z,
                     float tan_clamp, float lowpass, float sigma_extent, int front_only) {
  return Inputs{means,     scales,     rotations,  opacities,  colors,     confidences, valid,
                strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],  strides[6],
                extrinsic, intrinsic,  n,          h,          w,          front_only,  near_z,
                tan_clamp, lowpass,    sigma_extent};
}

// `strides`: the row strides, in floats (bytes for `valid`), of means,
// scales, rotations, opacities, colors, confidences and valid, as a host
// array of 7. Returns the launch's CUDA error code.
extern "C" int preprocess_fwd_launch(const float* means, const float* scales,
                                     const float* rotations, const float* opacities,
                                     const float* colors, const float* confidences,
                                     const unsigned char* valid, const long long* strides,
                                     const float* extrinsic, const float* intrinsic, long long n,
                                     int h, int w, float near_z, float tan_clamp, float lowpass,
                                     float sigma_extent, int front_only, float* params2d,
                                     float* radius, float* depth_z, unsigned char* in_view,
                                     void* stream) {
  const Inputs in = inputs(means, scales, rotations, opacities, colors, confidences, valid, strides,
                           extrinsic, intrinsic, n, h, w, near_z, tan_clamp, lowpass, sigma_extent,
                           front_only);
  preprocess::preprocess_fwd_kernel<<<preprocess::grid_of(n), preprocess::kThreads, 0,
                                      (cudaStream_t)stream>>>(in, params2d, radius, depth_z,
                                                              in_view);
  return (int)cudaGetLastError();
}

// The backward: the same inputs, the cotangents (dparams2d (N, 24)
// contiguous or null for none, ddepth_z (N,) or null), and the six leaf
// gradients, each contiguous or null where not needed.
extern "C" int preprocess_bwd_launch(const float* means, const float* scales,
                                     const float* rotations, const float* opacities,
                                     const float* colors, const float* confidences,
                                     const unsigned char* valid, const long long* strides,
                                     const float* extrinsic, const float* intrinsic, long long n,
                                     int h, int w, float near_z, float tan_clamp, float lowpass,
                                     float sigma_extent, int front_only, const float* dparams2d,
                                     const float* ddepth_z, float* dmeans, float* dscales,
                                     float* drotations, float* dopacities, float* dcolors,
                                     float* dconfidences, void* stream) {
  const Inputs in = inputs(means, scales, rotations, opacities, colors, confidences, valid, strides,
                           extrinsic, intrinsic, n, h, w, near_z, tan_clamp, lowpass, sigma_extent,
                           front_only);
  const preprocess::Grads out{dmeans, dscales, drotations, dopacities, dcolors, dconfidences};
  preprocess::preprocess_bwd_kernel<<<preprocess::grid_of(n), preprocess::kThreads, 0,
                                      (cudaStream_t)stream>>>(in, dparams2d, ddepth_z, out);
  return (int)cudaGetLastError();
}

extern "C" const char* preprocess_errstr(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
