// Sustained FP32 elementwise rate per primitive, for Hopper (sm_90a).
//
// Replaces: `kernel` in scripts/microbench_vpu.py (launched by its `run`),
// the TPU's VPU probe.
//
// What it computes: every element runs `rounds` serial rounds of one
// operation, v <- op(v), and writes the result:
//   0 fma        v * c1 + c0, as the compositor writes it: under -fmad=false
//                a rounded FMUL then an FADD (2 ops per round)
//   1 fma_fused  __fmaf_rn(v, c1, c0): one FFMA (2 ops per round)
//   2 mul        v * c1 (1)
//   3 add        v + c0 (1)
//   4 cmpsel     v > c0 ? v * c1 : v (3: compare, select, multiply)
//   5 exp        expf(-v) + c0, the accurate expf (3: exp, negate, add)
//   6 div        c1 / (v + c0), IEEE division (2: divide, add)
// The operation counts are those of the reference's OPS_PER_ROUND.
//
// What bounds it: instruction issue on the FP32 (and, for exp and div, the
// MUFU) pipes; memory is 8 bytes per element against thousands of
// operations. The rates it prints are the rates the compositor kernels get,
// because it builds with their flags (render/_build.py).
//
// Design: one thread per element, each running the reference's serial
// chain in a register. The 4.2 M elements of the reference's grid give
// every SM far more resident warps than it needs to hide the chain's
// latency. c1 and c0 are kernel arguments, so nvcc cannot fold them; the
// chain is unrolled UNROLL times inside a loop that is not, so the loop's
// counter and branch cost 1/UNROLL of an instruction per round and the SASS
// of the loop body shows the instructions of UNROLL rounds.
#include <cuda_runtime.h>

namespace {

constexpr int UNROLL = 8;

template <int OP>
__device__ __forceinline__ float step(float v, float c1, float c0) {
  if (OP == 0) return v * c1 + c0;
  if (OP == 1) return __fmaf_rn(v, c1, c0);
  if (OP == 2) return v * c1;
  if (OP == 3) return v + c0;
  if (OP == 4) return v > c0 ? v * c1 : v;
  if (OP == 5) return expf(-v) + c0;
  return c1 / (v + c0);
}

template <int OP>
__global__ void __launch_bounds__(256)
chain(const float* __restrict__ x, float* __restrict__ y, long long n, int rounds, float c1, float c0) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
#pragma unroll 1
  for (int r = 0; r < rounds; r += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v = step<OP>(v, c1, c0);
  }
  y[i] = v;
}

}  // namespace

// rounds must be a multiple of UNROLL (the wrapper checks).
extern "C" int microbench_vpu_launch(const float* x, float* y, long long n, int rounds, int op,
                                     float c1, float c0, void* stream) {
  if (n == 0) return 0;
  if (rounds % UNROLL) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case 0: chain<0><<<blocks, threads, 0, s>>>(x, y, n, rounds, c1, c0); break;
    case 1: chain<1><<<blocks, threads, 0, s>>>(x, y, n, rounds, c1, c0); break;
    case 2: chain<2><<<blocks, threads, 0, s>>>(x, y, n, rounds, c1, c0); break;
    case 3: chain<3><<<blocks, threads, 0, s>>>(x, y, n, rounds, c1, c0); break;
    case 4: chain<4><<<blocks, threads, 0, s>>>(x, y, n, rounds, c1, c0); break;
    case 5: chain<5><<<blocks, threads, 0, s>>>(x, y, n, rounds, c1, c0); break;
    case 6: chain<6><<<blocks, threads, 0, s>>>(x, y, n, rounds, c1, c0); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* microbench_vpu_errstr(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
