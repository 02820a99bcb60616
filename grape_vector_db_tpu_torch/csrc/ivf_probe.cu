// Ragged IVF probe kernels for the partitioned search (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernels of grape_vector_db_tpu/ops/ivf_pallas.py,
// which share one ragged fetch (_ragged_cell_dma) and one contract:
//   FMT_BF16 (and FMT_F32): _probe_kernel,      wrapper ivf_probe_scores
//   FMT_I8:                 _probe_kernel_int8, wrapper ivf_probe_scores_int8
//   FMT_I4:                 _probe_kernel_int4, wrapper ivf_probe_scores_int4
// and is bound to PyTorch through a plain C interface (ctypes) by
// grape_vector_db_tpu_torch/ops/ivf.py, which also holds the plain PyTorch
// version of the same contract (ivf_probe_scores*_ref).
//
// Contract. For query b, probe slot p, list l = probe[b, p] and row c < C:
//   out[b, p, c] = -1e9 when w[l, c] == 0 or c >= min(C, 64 * nblocks[l]);
//   otherwise    dot(q'_b, row(l, c)) * w[l, c], accumulated in f32,
// where q' is q rounded to bf16 (q itself for f32 storage) and row(l, c) is
// the stored row: bf16 values, int8 codes (exact in bf16), or the packed
// split-plane nibbles u in 0..15 (low nibble of byte j = dim j, high nibble =
// dim j + D/2), whose -8 level offset folds as dot(q', u) - 8 * sum(q').
// nblocks counts 64-row blocks below the list's high-water mark; a negative
// or too large count is clamped to [0, C/64]. A probe id outside [0, L)
// scores -1e9 on its whole cell: it never drives a read out of bounds.
// Every output element is written, the -1e9 tail included.
//
// What bounds it on an H100. At B = 128 queries and P = 16 probes over
// 1,048,576 x 768 bf16 rows in 4096 lists, each cell reads its list's
// occupied rows (~256 x 1.5 KB): B * P * 0.4 MB = 0.8 GB per call, against
// ~2 x 128 x 16 x 256 x 768 = 0.8 GFLOP. Memory bounds it, by three orders.
// The least it could move is each probed list once (queries that probe the
// same list share it): the unique lists' rows, a fraction of the per-cell
// read.
//
// Design, simple first. One thread block per (b, p) cell, as the TPU kernel
// walks one cell per grid step. The block stages q' in shared memory (and,
// for int4, sum(q')), writes the -1e9 tail past the row limit, then its 8
// warps stride over the rows below the limit, 4 rows a warp at a time so
// each lane keeps 4 independent 16-byte loads in flight; lanes stride over a
// row's 16-byte chunks, read the chunk's query values from shared memory
// into registers once for the 4 rows, FMA in f32, and the warp reduces with
// shuffles. Rows whose weight is 0 (free cells, deleted rows) are not read.
// Each cell reads its list from device memory (or L2) again; grouping the
// cells by list so that one block reads a list once for every query that
// probes it, with mma/wgmma, is the lever a later version pulls.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RB = 64;          // rows per nblocks unit
constexpr int ROWS = 4;         // rows a warp scores together
constexpr float INVALID = -1e9f;

enum Fmt { FMT_BF16 = 0, FMT_F32 = 1, FMT_I8 = 2, FMT_I4 = 3 };

// Chunk<FMT> covers one 16-byte chunk ch of a stored row: load_q reads the
// NQ query values the chunk meets from the staged query q_s into registers
// (once per chunk, for every row a warp scores with it), fma adds the chunk's
// products with them to acc.
template <int FMT>
struct Chunk;

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// f32 -> bf16 -> f32, round to nearest even (finite inputs), as torch's
// .to(torch.bfloat16) rounds.
__device__ __forceinline__ float bf16_round(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// N consecutive floats of shared memory (16-byte aligned) into registers.
template <int N>
__device__ __forceinline__ void load_f4(float* r, const float* src) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + i);
    r[i] = v.x;
    r[i + 1] = v.y;
    r[i + 2] = v.z;
    r[i + 3] = v.w;
  }
}

template <>
struct Chunk<FMT_BF16> {  // 8 dims per chunk: [8 ch, 8 ch + 8)
  static constexpr int NQ = 8;
  __device__ __forceinline__ static void load_q(float (&qr)[NQ], const float* q_s, int ch,
                                                int /*half*/) {
    load_f4<8>(qr, q_s + 8 * ch);
  }
  __device__ __forceinline__ static void fma(float& acc, const uint4& x, const float (&q)[NQ]) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc = fmaf(q[2 * i], bf16_lo(w[i]), acc);
      acc = fmaf(q[2 * i + 1], bf16_hi(w[i]), acc);
    }
  }
};

template <>
struct Chunk<FMT_F32> {  // 4 dims per chunk
  static constexpr int NQ = 4;
  __device__ __forceinline__ static void load_q(float (&qr)[NQ], const float* q_s, int ch,
                                                int /*half*/) {
    load_f4<4>(qr, q_s + 4 * ch);
  }
  __device__ __forceinline__ static void fma(float& acc, const uint4& x, const float (&q)[NQ]) {
    acc = fmaf(q[0], __uint_as_float(x.x), acc);
    acc = fmaf(q[1], __uint_as_float(x.y), acc);
    acc = fmaf(q[2], __uint_as_float(x.z), acc);
    acc = fmaf(q[3], __uint_as_float(x.w), acc);
  }
};

template <>
struct Chunk<FMT_I8> {  // 16 dims per chunk; codes are exact in bf16 and f32
  static constexpr int NQ = 16;
  __device__ __forceinline__ static void load_q(float (&qr)[NQ], const float* q_s, int ch,
                                                int /*half*/) {
    load_f4<16>(qr, q_s + 16 * ch);
  }
  __device__ __forceinline__ static void fma(float& acc, const uint4& x, const float (&q)[NQ]) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc = fmaf(q[4 * i + j], static_cast<float>(static_cast<int8_t>(w[i] >> (8 * j))), acc);
    }
  }
};

template <>
struct Chunk<FMT_I4> {  // 16 packed bytes: dims [16 ch, +16) and [half + 16 ch, +16)
  static constexpr int NQ = 32;  // qr[0..16) low-nibble dims, qr[16..32) high
  __device__ __forceinline__ static void load_q(float (&qr)[NQ], const float* q_s, int ch,
                                                int half) {
    load_f4<16>(qr, q_s + 16 * ch);
    load_f4<16>(qr + 16, q_s + half + 16 * ch);
  }
  __device__ __forceinline__ static void fma(float& acc, const uint4& x, const float (&q)[NQ]) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t byte = (w[i] >> (8 * j)) & 0xffu;
        acc = fmaf(q[4 * i + j], static_cast<float>(byte & 0xfu), acc);
        acc = fmaf(q[16 + 4 * i + j], static_cast<float>(byte >> 4), acc);
      }
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int FMT>
__global__ void __launch_bounds__(THREADS)
probe_kernel(const float* __restrict__ q, const int32_t* __restrict__ probe,
             const uint4* __restrict__ data, const float* __restrict__ w,
             const int32_t* __restrict__ nblocks, float* __restrict__ out, int P, int L,
             int C, int D, int row_chunks) {
  extern __shared__ __align__(16) float q_s[];  // [D] prepared query
  __shared__ float red[WARPS];

  const int cell = blockIdx.x;    // b * P + p
  const int b = cell / P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* o = out + (size_t)cell * C;

  const int l = probe[cell];
  int lim = 0;
  if (l >= 0 && l < L) {
    const int nb = min(max(nblocks[l], 0), C / RB + 1);
    lim = min(C, RB * nb);
  }
  for (int c = lim + tid; c < C; c += THREADS) o[c] = INVALID;
  if (lim == 0) return;  // uniform over the block, before any barrier

  float part = 0.f;
  for (int i = tid; i < D; i += THREADS) {
    float v = q[(size_t)b * D + i];
    if (FMT != FMT_F32) v = bf16_round(v);
    q_s[i] = v;
    part += v;
  }
  float qsum = 0.f;
  if (FMT == FMT_I4) {
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
  }
  __syncthreads();
  if (FMT == FMT_I4) {
#pragma unroll
    for (int i = 0; i < WARPS; ++i) qsum += red[i];  // same order in every thread
  }

  const float* wl = w + (size_t)l * C;
  const uint4* base = data + (size_t)l * C * row_chunks;
  const int half = D / 2;
  for (int r0 = warp * ROWS; r0 < lim; r0 += WARPS * ROWS) {
    float wr[ROWS], acc[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      wr[j] = (r0 + j < lim) ? __ldg(wl + r0 + j) : 0.f;
      acc[j] = 0.f;
    }
    for (int ch = lane; ch < row_chunks; ch += 32) {
      uint4 x[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        x[j] = (wr[j] != 0.f) ? __ldg(base + (size_t)(r0 + j) * row_chunks + ch)
                              : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      float qr[Chunk<FMT>::NQ];
      Chunk<FMT>::load_q(qr, q_s, ch, half);
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        if (wr[j] != 0.f) Chunk<FMT>::fma(acc[j], x[j], qr);
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const float dot = warp_sum(acc[j]);
      if (lane == 0 && r0 + j < lim) {
        const float s = (FMT == FMT_I4) ? dot - 8.f * qsum : dot;
        o[r0 + j] = (wr[j] == 0.f) ? INVALID : s * wr[j];
      }
    }
  }
}

// 16-byte chunks per stored row; 0 when the row width does not split into them.
int row_chunks_of(int fmt, int D) {
  long bytes = 0;
  if (fmt == FMT_BF16) bytes = 2L * D;
  if (fmt == FMT_F32) bytes = 4L * D;
  if (fmt == FMT_I8) bytes = D;
  if (fmt == FMT_I4) bytes = (D % 2 == 0) ? D / 2 : 0;
  return (bytes > 0 && bytes % 16 == 0) ? static_cast<int>(bytes / 16) : 0;
}

template <int FMT>
cudaError_t launch(const float* q, const int32_t* probe, const void* data, const float* w,
                   const int32_t* nblocks, float* out, int B, int P, int L, int C, int D,
                   int row_chunks, cudaStream_t stream) {
  const size_t smem = (size_t)D * sizeof(float);
  probe_kernel<FMT><<<B * P, THREADS, smem, stream>>>(
      q, probe, static_cast<const uint4*>(data), w, nblocks, out, P, L, C, D, row_chunks);
  return cudaGetLastError();
}

}  // namespace

// fmt: 0 = bf16 rows [L, C, D], 1 = f32 rows [L, C, D], 2 = int8 codes
// [L, C, D], 3 = packed int4 [L, C, D/2] (int8-typed bytes). q [B, D] f32,
// probe [B, P] int32, w [L, C] f32, nblocks [L] int32, out [B, P, C] f32,
// all contiguous on `device`, data 16-byte aligned. A stored row must split
// into 16-byte chunks and D <= 12288 (the staged query fits 48 KB of shared
// memory). Returns a cudaError_t (0 = launched).
extern "C" int gvdb_ivf_probe(int fmt, int device, const float* q, const int32_t* probe,
                              const void* data, const float* w, const int32_t* nblocks,
                              float* out, int B, int P, int L, int C, int D, void* stream) {
  const int row_chunks = row_chunks_of(fmt, D);
  if (B <= 0 || P <= 0 || L <= 0 || C <= 0 || D <= 0 || D > 12288 || row_chunks == 0 ||
      (long)B * P > 2147483647L || reinterpret_cast<uintptr_t>(data) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case FMT_BF16: return (int)launch<FMT_BF16>(q, probe, data, w, nblocks, out, B, P, L, C, D, row_chunks, s);
    case FMT_F32: return (int)launch<FMT_F32>(q, probe, data, w, nblocks, out, B, P, L, C, D, row_chunks, s);
    case FMT_I8: return (int)launch<FMT_I8>(q, probe, data, w, nblocks, out, B, P, L, C, D, row_chunks, s);
    case FMT_I4: return (int)launch<FMT_I4>(q, probe, data, w, nblocks, out, B, P, L, C, D, row_chunks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
