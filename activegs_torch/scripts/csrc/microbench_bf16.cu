// bf16 against f32 elementwise multiply-add throughput, for Hopper (sm_90a).
//
// Replaces: `kernel` in scripts/microbench_bf16.py (launched by its `run`),
// the TPU's bf16-versus-f32 VPU probe.
//
// What it computes: `rounds` serial rounds of v <- v * c1 + c0 per element,
// from an f32 input, with an f32 output:
//   op 0 (f32)   in f32, under -fmad=false a rounded FMUL then an FADD;
//   op 1 (bf16)  in bf16: the input rounds to bf16, and each round is a
//                packed __hmul2 then __hadd2 on an __nv_bfloat162, each
//                rounding to bf16 as the reference's mul then add does.
// Both count 2 operations per element per round.
//
// What bounds it: instruction issue on the FP32 pipe (f32) or the packed
// 16-bit pipe (bf16); memory is 8 bytes per element against 1024
// operations. c1 and c0 are kernel arguments: in bf16, 1.000001 rounds to
// exactly 1.0, and a literal would let nvcc fold the multiply away.
//
// Design: one thread per element in f32, and one thread per packed pair of
// elements in bf16, each running the serial chain in a register; the 67 M
// elements of the reference's grid keep every SM full. The chain is
// unrolled UNROLL times inside a loop that is not.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int UNROLL = 8;

__global__ void __launch_bounds__(256)
chain_f32(const float* __restrict__ x, float* __restrict__ y, long long n, int rounds, float c1, float c0) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
#pragma unroll 1
  for (int r = 0; r < rounds; r += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v = v * c1 + c0;
  }
  y[i] = v;
}

__global__ void __launch_bounds__(256)
chain_bf16(const float2* __restrict__ x, float2* __restrict__ y, long long npairs, int rounds, float c1,
           float c0) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= npairs) return;
  const float2 xv = x[i];
  __nv_bfloat162 v = __floats2bfloat162_rn(xv.x, xv.y);
  const __nv_bfloat162 k1 = __float2bfloat162_rn(c1);
  const __nv_bfloat162 k0 = __float2bfloat162_rn(c0);
#pragma unroll 1
  for (int r = 0; r < rounds; r += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v = __hadd2(__hmul2(v, k1), k0);
  }
  y[i] = __bfloat1622float2(v);
}

}  // namespace

// n elements (even for bf16); rounds a multiple of UNROLL (the wrapper
// checks both).
extern "C" int microbench_bf16_launch(const float* x, float* y, long long n, int rounds, int op,
                                      float c1, float c0, void* stream) {
  if (n == 0) return 0;
  if (rounds % UNROLL || (op == 1 && n % 2)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (op == 0) {
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    chain_f32<<<blocks, threads, 0, s>>>(x, y, n, rounds, c1, c0);
  } else if (op == 1) {
    const long long npairs = n / 2;
    const unsigned blocks = (unsigned)((npairs + threads - 1) / threads);
    chain_bf16<<<blocks, threads, 0, s>>>(reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(y),
                                          npairs, rounds, c1, c0);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* microbench_bf16_errstr(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
