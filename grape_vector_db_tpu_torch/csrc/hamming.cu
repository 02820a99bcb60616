// Packed-bit Hamming scan for the binary index (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel _kernel of
// grape_vector_db_tpu/ops/hamming_pallas.py (reached through
// hamming_scores_pallas), and is bound to PyTorch through a plain C interface
// (ctypes) by grape_vector_db_tpu_torch/ops/hamming.py, which also holds the
// plain PyTorch version of the same contract (hamming_scores_ref).
//
// Contract. q [B, W] and codes [C, W] are 32-bit words (int32 tensors holding
// the bits of the reference's uint32 codes); out [B, C] int32 with
//   out[b, c] = sum over w < W of popcount(q[b, w] ^ codes[c, w]).
// B, C and W are any positive sizes: rows past C and queries past B are
// guarded (the TPU kernel needed C % 512 == 0). Validity is the caller's.
//
// What bounds it on an H100. At the binary index's scan (B = 128, W = 24,
// D = 768) over 1,048,576 rows, the kernel reads 101 MB of codes and writes
// 537 MB of distances: ~0.19 ms at 3.35 TB/s. The same distances are a +-1
// product (dot = D - 2 * hamming), 2.1e11 int8 operations, ~0.10 ms on the
// int8 tensor cores, so the card's bound is memory. This design counts with
// __popc instead: 3.2e9 popcounts at 16 a clock per SM (CUDA programming
// guide, compute capability 9.0: a quarter of the 64 a clock of xor and
// integer add), ~0.8 ms at 132 SMs and 1.98 GHz. That issue rate is this
// kernel's floor, about four times the card's bound; the b1 tensor-core
// product below is the route to the bound.
//
// Design, simple first. A block of 256 threads takes a tile of TB = 32
// queries x TC = 128 corpus rows; each thread holds a 4 x 4 register tile
// (queries ty*4 + i, rows tx + 32 j), so each staged word feeds 16 xor +
// popc + add from 8 shared-memory reads. The words stream through in K-tiles
// of up to 32: the codes tile is staged transposed ([word][row], the row
// stride padded by one so that a warp's 32 row reads hit 32 banks) with
// coalesced 16-byte loads when the rows split
// into them (W % 4 == 0 and the codes 16-byte aligned; 4-byte loads
// otherwise); the queries' words are read as one 16-byte broadcast per 4
// queries. Writes run along C, 32 consecutive rows a warp. The levers of a
// later version: the b1 tensor-core product with .and.popc (popc(q ^ c) =
// popc(q) + popc(c) - 2 popc(q & c)), which lifts the popcount floor and
// leaves the output write as the bound; or, short of that, carry-save adders
// over 3 or 7 words before the popcount (LOP3 at the full integer rate).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RQ = 4;                       // queries a thread scores
constexpr int RC = 4;                       // rows a thread scores
constexpr int TB = (THREADS / 32) * RQ;     // queries a block scores (32)
constexpr int TC = 32 * RC;                 // rows a block scores (128)
constexpr int KT = 32;                      // words a K-tile stages

__global__ void __launch_bounds__(THREADS)
hamming_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ codes,
               int32_t* __restrict__ out, int B, int C, int W, int vec) {
  __shared__ uint32_t cs[KT][TC + 1];             // codes tile, [word][row]
  __shared__ __align__(16) uint32_t qs[KT][TB];   // query tile, [word][query]

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int c0 = blockIdx.x * TC, b0 = blockIdx.y * TB;
  int acc[RQ][RC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RC; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < W; k0 += KT) {
    const int kt = min(KT, W - k0);
    if (vec) {  // kt % 4 == 0 and every row segment 16-byte aligned
      const int g = kt >> 2;
      for (int i = tid; i < TC * g; i += THREADS) {
        const int r = i / g, e = (i - r * g) * 4;
        const int c = c0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (c < C) v = __ldg(reinterpret_cast<const uint4*>(codes + (size_t)c * W + k0 + e));
        cs[e][r] = v.x;
        cs[e + 1][r] = v.y;
        cs[e + 2][r] = v.z;
        cs[e + 3][r] = v.w;
      }
    } else {
      for (int i = tid; i < TC * kt; i += THREADS) {
        const int r = i / kt, e = i - r * kt;
        const int c = c0 + r;
        cs[e][r] = (c < C) ? __ldg(codes + (size_t)c * W + k0 + e) : 0u;
      }
    }
    for (int i = tid; i < TB * kt; i += THREADS) {
      const int r = i / kt, e = i - r * kt;
      const int b = b0 + r;
      qs[e][r] = (b < B) ? __ldg(q + (size_t)b * W + k0 + e) : 0u;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kt; ++k) {
      const uint4 qv = *reinterpret_cast<const uint4*>(&qs[k][ty * RQ]);
      const uint32_t qr[RQ] = {qv.x, qv.y, qv.z, qv.w};
      uint32_t cr[RC];
#pragma unroll
      for (int j = 0; j < RC; ++j) cr[j] = cs[k][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RC; ++j) acc[i][j] += __popc(qr[i] ^ cr[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int b = b0 + ty * RQ + i;
    if (b >= B) continue;
    int32_t* o = out + (size_t)b * C;
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const int c = c0 + tx + 32 * j;
      if (c < C) o[c] = acc[i][j];
    }
  }
}

}  // namespace

// q [B, W], codes [C, W] (32-bit words), out [B, C] int32, all contiguous on
// `device`. Returns a cudaError_t (0 = launched).
extern "C" int gvdb_hamming(int device, const void* q, const void* codes, void* out, int B,
                            int C, int W, void* stream) {
  if (B <= 0 || C <= 0 || W <= 0 || (B + TB - 1) / TB > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int vec = (W % 4 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  const dim3 grid((C + TC - 1) / TC, (B + TB - 1) / TB);
  hamming_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(codes),
      static_cast<int32_t*>(out), B, C, W, vec);
  return (int)cudaGetLastError();
}

extern "C" const char* gvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
