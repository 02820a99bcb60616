// Tensor-core issue rates of the two routes a packed-bit Hamming scan can
// take on Hopper (sm_90a), for tools/mma_rates.py:
//   route 0: mma.sync m16n8k256 b1 with .and.popc (the packed words are the
//            fragments; 16 x 8 x 256 bit pairs an instruction);
//   route 1: mma.sync m16n8k32 s8 (the bits expanded to +-1 bytes; 16 x 8 x
//            32 byte pairs an instruction).
// Each warp runs `iters` rounds of four independent accumulator chains on
// register operands, so the count of instructions over the time is the
// rate the SMs issue them at; the sums go to out so nothing is dropped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHAINS = 4;

template <int ROUTE>
__device__ __forceinline__ void mma(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  if (ROUTE == 0) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
}

template <int ROUTE>
__global__ void __launch_bounds__(THREADS) rate_kernel(int iters, int* __restrict__ out) {
  const uint32_t x = (blockIdx.x * THREADS + threadIdx.x) * 0x9E3779B9u;
  const uint32_t a0 = x, a1 = x ^ 0x55555555u, a2 = ~x, a3 = x * 3u, b0 = x + 7u, b1 = x >> 3;
  int acc[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) mma<ROUTE>(acc[j], a0, a1, a2, a3, b0, b1);
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * THREADS + threadIdx.x] = s;
}

}  // namespace

// Launches `blocks` blocks of 256 threads, each warp issuing 4 * iters
// instructions of the route; out holds blocks * 256 ints. Returns a cudaError_t.
extern "C" int gvdb_mma_rate(int route, int blocks, int iters, int* out, void* stream) {
  if (blocks <= 0 || iters <= 0 || (route != 0 && route != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0)
    rate_kernel<0><<<blocks, THREADS, 0, s>>>(iters, out);
  else
    rate_kernel<1><<<blocks, THREADS, 0, s>>>(iters, out);
  return (int)cudaGetLastError();
}

extern "C" const char* gvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
