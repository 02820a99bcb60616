// Candidate gather-dot kernel for graph search (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel _gather_kernel of
// grape_vector_db_tpu/ops/gather_pallas.py (called through
// _gather_dots_pallas / gather_dots(impl="pallas")), and is bound to PyTorch
// through a plain C interface (ctypes) by grape_vector_db_tpu_torch/ops/gather.py,
// which also holds the plain PyTorch version of the same contract
// (gather_dots_ref).
//
// Contract. q [B, D] f32 (already prepared: unit rows for cosine), vectors
// [N, D] bf16 or f32, ids [B, C] int32, out [B, C] f32:
//   out[b, c] = sum_d q'[b, d] * vectors[clamp(ids[b, c], 0, N - 1), d],
// summed in f32, where q' is q rounded to bf16 (round to nearest even) for
// bf16 storage and q itself for f32 storage (true f32 FMA: the reference
// asks for Precision.HIGHEST there). An id outside [0, N) is clamped, as the
// Pallas kernel clamps; it never drives a read out of bounds. Any B, C and
// D <= 12288; every output element is written.
//
// What bounds it on an H100. Each gathered row meets one query, so the work
// is 2 FLOP for every 2 bytes of a bf16 row: memory bounds it by two orders.
// At the beam's shape (B = 128 queries, C = 256 candidates = expand 8 x
// degree 32, D = 768 bf16) the distinct rows the ids name are at most
// 32,768 x 1.5 KB = 50 MB; at the NN-descent build's (B = 2048 nodes,
// C = 576 candidates) at most the N rows of the graph. The reads are random
// 1.5 KB rows, not a stream, so latency and the number of loads in flight
// decide how near it comes to the memory rate.
//
// Design, simple first. The TPU kernel DMAs each candidate row into VMEM
// (scalar-prefetched ids, 16 copies in flight) and multiplies 8 queries at a
// time on the MXU. Here one thread block scores 32 candidates of one query:
// it stages q' in shared memory once (as f32), then each of its 8 warps
// scores 4 candidate rows together, its lanes striding over the rows'
// 16-byte chunks (4 independent loads in flight a lane), FMA in f32 and a
// shuffle reduction a row. No tensor cores: a row is used once. A row whose
// width is not a multiple of 16 bytes (or a base not 16-byte aligned) takes
// the same loop over single elements. Each (query, candidate) pair reads its
// row again, from device memory or L2; the beam's queries name overlapping
// rows and the build's candidate lists overlap heavily. A later redesign
// would group the pairs by row so that one read serves every query that
// names it, and bring the rows in with bulk asynchronous copies (TMA /
// cp.async.bulk) ahead of the arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;               // candidate rows a warp scores together
constexpr int TILE = WARPS * ROWS;    // candidates a block scores

enum Fmt { FMT_BF16 = 0, FMT_F32 = 1 };

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// f32 -> bf16 -> f32, round to nearest even (finite inputs), as torch's
// .to(torch.bfloat16) rounds.
__device__ __forceinline__ float bf16_round(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// Chunk<FMT>: one 16-byte chunk of a stored row, NQ values.
template <int FMT>
struct Chunk;

template <>
struct Chunk<FMT_BF16> {
  static constexpr int NQ = 8;
  __device__ __forceinline__ static void fma(float& acc, const uint4& x, const float* q) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc = fmaf(q[2 * i], bf16_lo(w[i]), acc);
      acc = fmaf(q[2 * i + 1], bf16_hi(w[i]), acc);
    }
  }
  // element i of a row as f32 (the unaligned route)
  __device__ __forceinline__ static float at(const void* base, size_t i) {
    return __uint_as_float(static_cast<uint32_t>(__ldg(static_cast<const uint16_t*>(base) + i))
                           << 16);
  }
};

template <>
struct Chunk<FMT_F32> {
  static constexpr int NQ = 4;
  __device__ __forceinline__ static void fma(float& acc, const uint4& x, const float* q) {
    acc = fmaf(q[0], __uint_as_float(x.x), acc);
    acc = fmaf(q[1], __uint_as_float(x.y), acc);
    acc = fmaf(q[2], __uint_as_float(x.z), acc);
    acc = fmaf(q[3], __uint_as_float(x.w), acc);
  }
  __device__ __forceinline__ static float at(const void* base, size_t i) {
    return __ldg(static_cast<const float*>(base) + i);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One block: query b = blockIdx.x / tiles, candidates [t * TILE, t * TILE + TILE)
// of it, t = blockIdx.x % tiles. VEC: rows split into row_chunks 16-byte chunks.
template <int FMT, bool VEC>
__global__ void __launch_bounds__(THREADS)
gather_dots_kernel(const float* __restrict__ q, const void* __restrict__ vectors,
                   const int32_t* __restrict__ ids, float* __restrict__ out, int C, int N,
                   int D, int tiles, int row_chunks) {
  extern __shared__ __align__(16) float q_s[];  // [D] prepared query

  const int b = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < D; i += THREADS) {
    const float v = q[(size_t)b * D + i];
    q_s[i] = (FMT == FMT_BF16) ? bf16_round(v) : v;
  }
  __syncthreads();

  const int cw = c0 + warp * ROWS;  // this warp's first candidate (uniform over the warp)
  if (cw >= C) return;              // after the only barrier
  const int32_t* idb = ids + (size_t)b * C;
  size_t row[ROWS];
  bool live[ROWS];
  float acc[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    live[j] = cw + j < C;
    const int id = live[j] ? __ldg(idb + cw + j) : 0;
    row[j] = (size_t)min(max(id, 0), N - 1);
    acc[j] = 0.f;
  }

  if (VEC) {
    const uint4* base = static_cast<const uint4*>(vectors);
    for (int ch = lane; ch < row_chunks; ch += 32) {
      uint4 x[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        x[j] = live[j] ? __ldg(base + row[j] * row_chunks + ch) : make_uint4(0u, 0u, 0u, 0u);
      float qr[Chunk<FMT>::NQ];
#pragma unroll
      for (int i = 0; i < Chunk<FMT>::NQ; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(q_s + Chunk<FMT>::NQ * ch + i);
        qr[i] = v.x;
        qr[i + 1] = v.y;
        qr[i + 2] = v.z;
        qr[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        if (live[j]) Chunk<FMT>::fma(acc[j], x[j], qr);
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      const float qv = q_s[i];
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        if (live[j]) acc[j] = fmaf(qv, Chunk<FMT>::at(vectors, row[j] * D + i), acc[j]);
    }
  }

#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const float s = warp_sum(acc[j]);
    if (lane == 0 && live[j]) out[(size_t)b * C + cw + j] = s;
  }
}

template <int FMT>
cudaError_t launch(const float* q, const void* vectors, const int32_t* ids, float* out, int B,
                   int C, int N, int D, cudaStream_t stream) {
  const int tiles = (C + TILE - 1) / TILE;
  const size_t smem = (size_t)D * sizeof(float);
  const long row_bytes = (long)D * (FMT == FMT_BF16 ? 2 : 4);
  const bool vec = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(vectors) % 16 == 0;
  const int row_chunks = vec ? static_cast<int>(row_bytes / 16) : 0;
  if (vec)
    gather_dots_kernel<FMT, true><<<B * tiles, THREADS, smem, stream>>>(q, vectors, ids, out, C,
                                                                        N, D, tiles, row_chunks);
  else
    gather_dots_kernel<FMT, false><<<B * tiles, THREADS, smem, stream>>>(q, vectors, ids, out, C,
                                                                         N, D, tiles, 0);
  return cudaGetLastError();
}

}  // namespace

// fmt: 0 = bf16 vectors, 1 = f32 vectors. q [B, D] f32, vectors [N, D],
// ids [B, C] int32, out [B, C] f32, all contiguous on `device`. D <= 12288
// (the staged query fits 48 KB of shared memory). Returns a cudaError_t
// (0 = launched; nothing is launched when B or C is 0).
extern "C" int gvdb_gather_dots(int fmt, int device, const float* q, const void* vectors,
                                const int32_t* ids, float* out, int B, int C, int N, int D,
                                void* stream) {
  if (B < 0 || C < 0 || N <= 0 || D <= 0 || D > 12288) return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return (int)cudaSuccess;
  const long tiles = (C + (long)TILE - 1) / TILE;
  if ((long)B * tiles > 2147483647L) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case FMT_BF16: return (int)launch<FMT_BF16>(q, vectors, ids, out, B, C, N, D, s);
    case FMT_F32: return (int)launch<FMT_F32>(q, vectors, ids, out, B, C, N, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
