// Ragged IVF probe kernels for the partitioned search (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernels of grape_vector_db_tpu/ops/ivf_pallas.py,
// which share one ragged fetch (_ragged_cell_dma) and one contract:
//   probe_kernel<FMT_BF16> (and <FMT_F32>): _probe_kernel,      wrapper ivf_probe_scores
//   probe_kernel<FMT_I8>:                   _probe_kernel_int8, wrapper ivf_probe_scores_int8
//   int4_group_kernel + int4_probe_kernel:  _probe_kernel_int4, wrapper ivf_probe_scores_int4
// and is bound to PyTorch through a plain C interface (ctypes) by
// grape_vector_db_tpu_torch/ops/ivf.py, which also holds the plain PyTorch
// version of the same contract (ivf_probe_scores*_ref) and of the grouping
// pass (group_cells_ref).
//
// Contract. For query b, probe slot p, list l = probe[b, p] and row c < C:
//   out[b, p, c] = -1e9 when w[l, c] == 0 or c >= min(C, 64 * nblocks[l]);
//   otherwise    dot(q'_b, row(l, c)) * w[l, c], accumulated in f32,
// where q' is q rounded to bf16 (q itself for f32 storage) and row(l, c) is
// the stored row: bf16 values, int8 codes (exact in bf16), or the packed
// split-plane nibbles u in 0..15 (low nibble of byte j = dim j, high nibble =
// dim j + D/2), whose -8 level offset folds as (dot(q', u) - 8 * sum(q')) * w.
// nblocks counts 64-row blocks below the list's high-water mark; a negative
// or too large count is clamped to [0, C/64]. A probe id outside [0, L)
// scores -1e9 on its whole cell: it never drives a read out of bounds.
// Every output element is written, the -1e9 tail included.
//
// What bounds it on an H100. At B = 128 queries and P = 16 probes over
// 1,048,576 x 768 rows in 4096 lists (~256 rows a list after optimize()),
// each cell reads its list's occupied rows: 0.8 GB a call in bf16, 0.2 GB in
// int4, against ~0.8 GFLOP. Memory bounds it, by three orders. The least it
// could move is each probed list once: 1625 distinct lists serve the 2048
// cells of the smoke's queries.
//
// probe_kernel<FMT> (bf16, f32, int8), simple first. One thread block per
// (b, p) cell, as the TPU kernel walks one cell per grid step. The block
// stages q' in shared memory, writes the -1e9 tail past the row limit, then
// its 8 warps stride over the rows below the limit, 4 rows a warp at a time
// so each lane keeps 4 independent 16-byte loads in flight; lanes stride over
// a row's 16-byte chunks, read the chunk's query values from shared memory
// into registers once for the 4 rows, FMA in f32, and the warp reduces with
// shuffles. Rows whose weight is 0 (free cells, deleted rows) are not read.
// Each cell reads its list again.
//
// int4, grouped by list on the tensor cores. Converting every nibble with
// the int-to-float unit (a quarter of the FMA rate) and an FMA a nibble held
// the per-cell form at 3.4x its bound, and a 192-byte row (D = 384) left 20
// of a warp's 32 lanes idle. So:
// - int4_group_kernel, block 0: a counting sort of the B * P cells by list
//   (ids outside [0, L) into bin L): counts in shared memory, an exclusive
//   scan into start[L + 2] (bins in list order), a scatter into order[] (any
//   order within a bin), and each bin cut into groups of G <= 8 cells, each
//   with a header (list, cells, row limit) and its cells. Blocks 1 .. B of
//   the same launch round each query to bf16 once and sum it in one order.
// - int4_probe_kernel: block k takes group k. It copies its cells' q' (low
//   and high halves of D, zero-padded to whole 128-byte slices) and streams
//   the list's rows once through a 3-stage cp.async ring of 64 rows x 128
//   bytes (chunk j of row r at j ^ 4 (r & 1): a quarter warp's 16-byte
//   reads hit 32 banks); warp w owns rows 16 w .. 16 w + 15 of a stage.
// - The product is mma.sync m16n8k16 bf16 -> f32 with 16 rows on M and the
//   group's cells on N. Lane t of a quad reads 16 bytes of its rows, whose
//   word i feeds k-step i: mma k-slots 2t, 2t+1, 2t+8, 2t+9 take bytes
//   4i .. 4i+3 (a permutation of the k axis that the query fragment, 4
//   adjacent bf16 of q', follows). A word's nibbles become bf16 on the
//   integer units: prmt spreads two bytes into 16-bit halves, one lop3 gives
//   0x4300 | u (bf16 128 + u, exact), and one bf16x2 fma subtracts 128; low
//   nibbles feed the k-step over dims j, high nibbles the one over j + D/2.
// - The epilogue folds -8 sum(q'), the weight and the -1e9 rules, and writes
//   each cell's row of the output.
// What holds it back (PERF.md): six blocks an SM stream the lists at ~2
// TB/s, and the unpack and products add a quarter; other stage, block and
// group sizes did not move it.
// bf16 products are exact in f32, so integer-valued inputs give exact sums
// in either form; otherwise sums differ from the per-cell order in the last
// bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RB = 64;          // rows per nblocks unit
constexpr int ROWS = 4;         // rows a warp scores together
constexpr float INVALID = -1e9f;

enum Fmt { FMT_BF16 = 0, FMT_F32 = 1, FMT_I8 = 2 };

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
  __device__ __forceinline__ static void load_q(float (&qr)[NQ], const float* q_s, int ch) {
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
  __device__ __forceinline__ static void load_q(float (&qr)[NQ], const float* q_s, int ch) {
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
  __device__ __forceinline__ static void load_q(float (&qr)[NQ], const float* q_s, int ch) {
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

  for (int i = tid; i < D; i += THREADS) {
    float v = q[(size_t)b * D + i];
    if (FMT != FMT_F32) v = bf16_round(v);
    q_s[i] = v;
  }
  __syncthreads();

  const float* wl = w + (size_t)l * C;
  const uint4* base = data + (size_t)l * C * row_chunks;
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
      Chunk<FMT>::load_q(qr, q_s, ch);
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        if (wr[j] != 0.f) Chunk<FMT>::fma(acc[j], x[j], qr);
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const float dot = warp_sum(acc[j]);
      if (lane == 0 && r0 + j < lim) o[r0 + j] = (wr[j] == 0.f) ? INVALID : dot * wr[j];
    }
  }
}

// 16-byte chunks per stored row; 0 when the row width does not split into them.
int row_chunks_of(int fmt, int D) {
  long bytes = 0;
  if (fmt == FMT_BF16) bytes = 2L * D;
  if (fmt == FMT_F32) bytes = 4L * D;
  if (fmt == FMT_I8) bytes = D;
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


// -- int4: the grouping pass and the grouped tensor-core kernel --------------------

namespace int4g {

constexpr int GROUP_THREADS = 1024;
constexpr int THREADS = 128;               // 4 warps, 16 rows each
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUP = 8;               // cells a group: the mma's N
constexpr int RT = WARPS * 16;             // rows a stage
constexpr int SB = 128;                    // row bytes a stage (256 dims)
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = RT * SB;       // 8 KB
constexpr int Q_BUDGET = 64 * 1024;        // bytes of staged queries a block
constexpr int SMEM_BINS = 24 * 1024;       // bins the grouping pass counts in shared memory

__host__ __device__ __forceinline__ int bin_of(int l, int L) { return (l >= 0 && l < L) ? l : L; }

// Staged queries: each cell's low and high halves of D, padded to whole
// slices (qh dims each), a row of 4 qh + 16 bytes (16 mod 128: a quarter
// warp's 16-byte reads of 8 rows hit 32 banks); G cells fit Q_BUDGET.
int half_dims(int D) { return (D / 2 + SB - 1) / SB * SB; }
int query_row_bytes(int D) { return 4 * half_dims(D) + 16; }
int group_size(int D) { return std::min(MAX_GROUP, Q_BUDGET / query_row_bytes(D)); }

// The scratch of one probe call, in int32 words (each region 16-byte
// aligned): start [L + 2] and order [n] first (the plain version's outputs),
// then cursor and gstart [L + 1], n_groups, the groups' headers [n] int4
// (list or -1, cells, row limit, 0) and cells [n][8], the queries' bf16 rows
// [B][D] and their sums [B].
struct Scratch {
  long start, order, cursor, gstart, n_groups, headers, cells, qb, qsum, words;
  __host__ __device__ static long up(long x) { return (x + 3) / 4 * 4; }
  __host__ __device__ Scratch(long n, long L, long B, long D) {
    start = 0;
    order = up(L + 2L);
    cursor = up(order + n);
    gstart = up(cursor + L + 1L);
    n_groups = up(gstart + L + 1L);
    headers = up(n_groups + 1);
    cells = up(headers + 4L * n);
    qb = up(cells + 8L * n);
    qsum = up(qb + B * D / 2);
    words = qsum + B;
  }
};

// Block 0 is the grouping pass: a counting sort of the n_cells cells by
// list. start [L + 2] out: bin k (list k, or L for ids outside [0, L)) holds
// sorted positions [start[k], start[k + 1]); order [n_cells] out: the cells
// of each bin, in any order within it. The L + 1 counters live in shared
// memory (dynamic, when L < SMEM_BINS) or in cursor [L + 1]. With G > 0 it
// also cuts each bin into groups of G cells: n_groups, and for group k its
// header (list or -1, cells, min(C, 64 nblocks[list]) or 0) and its cells.
// Blocks 1 .. B prepare the queries: qb[b] = bf16(q[b]) (round to nearest
// even), qsum[b] = sum(qb[b]) in f32 in one fixed order.
__global__ void __launch_bounds__(GROUP_THREADS)
int4_group_kernel(const int32_t* __restrict__ probe, int n_cells, int L, int G, int C,
                  const int32_t* __restrict__ nblocks, int32_t* __restrict__ scratch,
                  const float* __restrict__ q, int B, int D, bool in_smem) {
  extern __shared__ int bins_s[];
  __shared__ float wpart[GROUP_THREADS / 32];
  __shared__ int wsum[GROUP_THREADS / 32], wgsum[GROUP_THREADS / 32];
  __shared__ int total, gtotal;
  const Scratch at(n_cells, L, B, D);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (blockIdx.x > 0) {                            // query b = blockIdx.x - 1
    const int b = blockIdx.x - 1;
    float part = 0.f;
    for (int u = tid; u < D / 4; u += GROUP_THREADS) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(q + (size_t)b * D) + u);
      const float x = bf16_round(v.x), y = bf16_round(v.y), z = bf16_round(v.z),
                  w = bf16_round(v.w);
      reinterpret_cast<uint2*>(scratch + at.qb + (size_t)b * D / 2)[u] =
          make_uint2((__float_as_uint(x) >> 16) | (__float_as_uint(y) & 0xffff0000u),
                     (__float_as_uint(z) >> 16) | (__float_as_uint(w) & 0xffff0000u));
      part += ((x + y) + (z + w));
    }
    part = warp_sum(part);
    if (lane == 0) wpart[warp] = part;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int i = 0; i < GROUP_THREADS / 32; ++i) s += wpart[i];
      reinterpret_cast<float*>(scratch + at.qsum)[b] = s;
    }
    return;
  }

  int32_t* start = scratch + at.start;
  int32_t* order = scratch + at.order;
  int32_t* gstart = scratch + at.gstart;
  int* cnt = in_smem ? bins_s : scratch + at.cursor;
  for (int i = tid; i <= L; i += GROUP_THREADS) cnt[i] = 0;
  __syncthreads();
  for (int c = tid; c < n_cells; c += GROUP_THREADS) atomicAdd(cnt + bin_of(probe[c], L), 1);
  __syncthreads();
  int carry = 0, gcarry = 0;
  for (int base = 0; base <= L; base += GROUP_THREADS) {
    const int i = base + tid;
    const int v = i <= L ? cnt[i] : 0;
    const int gv = G > 0 ? (v + G - 1) / G : 0;    // the bin's groups
    int x = v, gx = gv;                            // inclusive scans over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      const int gy = __shfl_up_sync(0xffffffffu, gx, off);
      if (lane >= off) {
        x += y;
        gx += gy;
      }
    }
    if (lane == 31) {
      wsum[warp] = x;
      wgsum[warp] = gx;
    }
    __syncthreads();
    if (warp == 0) {
      const int ws = wsum[lane], wg = wgsum[lane];
      int y = ws, gy = wg;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int z = __shfl_up_sync(0xffffffffu, y, off);
        const int gz = __shfl_up_sync(0xffffffffu, gy, off);
        if (lane >= off) {
          y += z;
          gy += gz;
        }
      }
      wsum[lane] = y - ws;                         // exclusive over the warps
      wgsum[lane] = gy - wg;
      if (lane == 31) {
        total = y;
        gtotal = gy;
      }
    }
    __syncthreads();
    if (i <= L) {
      const int first = carry + wsum[warp] + x - v;
      start[i] = first;
      cnt[i] = first;
      gstart[i] = gcarry + wgsum[warp] + gx - gv;
    }
    carry += total;
    gcarry += gtotal;
    __syncthreads();                               // wsum, wgsum and the totals are reused
  }
  if (tid == 0) {
    start[L + 1] = n_cells;
    scratch[at.n_groups] = gcarry;
  }
  for (int c = tid; c < n_cells; c += GROUP_THREADS)
    order[atomicAdd(cnt + bin_of(probe[c], L), 1)] = c;
  if (G == 0) return;
  __syncthreads();                                 // order and start are complete
  int4* headers = reinterpret_cast<int4*>(scratch + at.headers);
  int32_t* cells = scratch + at.cells;
  for (int pos = tid; pos < n_cells; pos += GROUP_THREADS) {
    const int cell = order[pos], l = probe[cell], bin = bin_of(l, L);
    const int first = start[bin], j = (pos - first) % G;
    const int k = gstart[bin] + (pos - first) / G;
    cells[8 * k + j] = cell;
    if (j == 0) {
      const int lim = bin < L ? min(C, RB * min(max(nblocks[l], 0), C / RB + 1)) : 0;
      headers[k] = make_int4(bin < L ? l : -1, min(G, start[bin + 1] - pos), lim, 0);
    }
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two nibbles (bits 0-3 and 16-19 of x) as a bf16x2 pair of their values:
// 0x4300 | u is bf16 128 + u, exactly; one fma takes 128 off, exactly.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t x) {
  const uint32_t biased = (x & 0x000F000Fu) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(biased), "r"(0x3F803F80u), "r"(0xC300C300u));
  return d;
}

// Block k takes group k of the grouping pass (blocks past n_groups return).
// codes [L, C, D/2] bytes (16-byte aligned), w [L, C] f32, out [n, C] f32
// with n = B * P cells. Dynamic shared memory: STAGES * STAGE_BYTES of rows,
// then G rows of SQ bytes of queries.
__global__ void __launch_bounds__(THREADS)
int4_probe_kernel(const int32_t* __restrict__ scratch, const uint8_t* __restrict__ codes,
                  const float* __restrict__ w, float* __restrict__ out, int n, int L, int B,
                  int P, int C, int D, int QH, int SQ) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int cells[MAX_GROUP];
  __shared__ float qsum[MAX_GROUP];

  const Scratch at(n, L, B, D);
  const int k = blockIdx.x;
  if (k >= scratch[at.n_groups]) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;           // mma row group, thread in group
  const int4 head = reinterpret_cast<const int4*>(scratch + at.headers)[k];
  const int l = head.x, cn = head.y, lim = head.z;
  int my_cell = 0;
  if (tid < cn) {
    my_cell = scratch[at.cells + 8 * k + tid];
    cells[tid] = my_cell;
  }
  __syncthreads();

  for (int i = tid; i < cn * (C - lim); i += THREADS) {     // the -1e9 tail
    const int j = i / (C - lim);
    out[(size_t)cells[j] * C + lim + (i - j * (C - lim))] = INVALID;
  }
  if (lim == 0) return;                            // uniform over the block

  const int half = D / 2;                          // bytes a row
  const int n_s = (half + SB - 1) / SB;            // 128-byte slices a row
  const int n_st = ((lim + RT - 1) / RT) * n_s;    // stages: row tiles x slices
  const uint8_t* rows = codes + (size_t)l * C * half;
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  auto issue = [&](int st) {
    if (st < n_st) {
      const int r0 = (st / n_s) * RT, b0 = (st % n_s) * SB;
      const uint32_t buf = ring + (st % STAGES) * STAGE_BYTES;
      for (int i = tid; i < RT * (SB / 16); i += THREADS) {
        const int r = i >> 3, j = i & 7;
        if (r0 + r < lim && b0 + 16 * j < half)
          cp_async16(buf + r * SB + 16 * (j ^ ((r & 1) << 2)),
                     rows + (size_t)(r0 + r) * half + b0 + 16 * j);
      }
    }
    cp_async_commit();                             // an empty group keeps the count
  };

  // q' of the group's cells (the grouping pass rounded it): dims [0, D/2) at
  // [0, QH) and [D/2, D) at [QH, 2 QH), copied with stage 0; zero between.
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem + STAGES * STAGE_BYTES);
  const uint16_t* qb = reinterpret_cast<const uint16_t*>(scratch + at.qb);
  const int chunks = half / 8;                     // 16-byte chunks a half
  for (int i = tid; i < cn * 2 * chunks; i += THREADS) {
    const int j = i / (2 * chunks), r = i - j * 2 * chunks, h = r / chunks;
    const int d = 8 * (r - h * chunks);
    const uint16_t* dst = qs + (size_t)j * (SQ / 2) + h * QH + d;
    cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(dst)),
               qb + (size_t)(cells[j] / P) * D + h * half + d);
  }
  for (int i = tid; i < cn * 2 * (QH - half); i += THREADS) {   // the padding
    const int j = i / (2 * (QH - half)), r = i - j * 2 * (QH - half), h = r / (QH - half);
    qs[(size_t)j * (SQ / 2) + h * QH + half + (r - h * (QH - half))] = 0;
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) issue(st);  // stage 0's group holds q'
  if (tid < cn) qsum[tid] = reinterpret_cast<const float*>(scratch + at.qsum)[my_cell / P];

  const float* wl = w + (size_t)l * C;
  const uint16_t* qg = qs + (size_t)g * (SQ / 2);  // this lane's cell (column g)
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<STAGES - 2>();                   // this thread's copies of stage st
    __syncthreads();                               // everyone's; stage st - 1 is free
    issue(st + STAGES - 1);
    const int s = st % n_s;
    const unsigned char* buf = smem + (st % STAGES) * STAGE_BYTES;
    const int ra = warp * 16 + g;                  // rows ra and ra + 8 of the stage
#pragma unroll
    for (int h = 0; h < 2; ++h) {                  // the slice's two 64-byte halves
      const int byte0 = s * SB + 64 * h + 16 * t;  // this lane's 16 bytes (and dims)
      if (s * SB + 64 * h >= half) break;          // uniform: past the row
      const int sw = (4 * h + t) ^ ((ra & 1) << 2);
      const uint4 x0 = *reinterpret_cast<const uint4*>(buf + ra * SB + 16 * sw);
      const uint4 x1 = *reinterpret_cast<const uint4*>(buf + (ra + 8) * SB + 16 * sw);
      uint4 ql0 = make_uint4(0u, 0u, 0u, 0u), ql1 = ql0, qh0 = ql0, qh1 = ql0;
      if (g < cn) {
        ql0 = *reinterpret_cast<const uint4*>(qg + byte0);
        ql1 = *reinterpret_cast<const uint4*>(qg + byte0 + 8);
        qh0 = *reinterpret_cast<const uint4*>(qg + QH + byte0);
        qh1 = *reinterpret_cast<const uint4*>(qg + QH + byte0 + 8);
      }
      const uint32_t w0[4] = {x0.x, x0.y, x0.z, x0.w}, w1[4] = {x1.x, x1.y, x1.z, x1.w};
      const uint32_t bl[8] = {ql0.x, ql0.y, ql0.z, ql0.w, ql1.x, ql1.y, ql1.z, ql1.w};
      const uint32_t bh[8] = {qh0.x, qh0.y, qh0.z, qh0.w, qh1.x, qh1.y, qh1.z, qh1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {                // k-step i: bytes 4i .. 4i + 3
        // bytes 4i, 4i + 1 (and 4i + 2, 4i + 3) into the halves of a word
        const uint32_t a01 = __byte_perm(w0[i], 0u, 0x4140u), a23 = __byte_perm(w0[i], 0u, 0x4342u);
        const uint32_t c01 = __byte_perm(w1[i], 0u, 0x4140u), c23 = __byte_perm(w1[i], 0u, 0x4342u);
        mma_bf16(acc, nibbles_bf16x2(a01), nibbles_bf16x2(c01), nibbles_bf16x2(a23),
                 nibbles_bf16x2(c23), bl[2 * i], bl[2 * i + 1]);
        mma_bf16(acc, nibbles_bf16x2(a01 >> 4), nibbles_bf16x2(c01 >> 4),
                 nibbles_bf16x2(a23 >> 4), nibbles_bf16x2(c23 >> 4), bh[2 * i], bh[2 * i + 1]);
      }
    }
    if (s == n_s - 1) {                            // the row tile is done
      const int r = (st / n_s) * RT + ra;
#pragma unroll
      for (int e = 0; e < 4; ++e) {                // (ra, 2t), (ra, 2t+1), (ra+8, 2t), (ra+8, 2t+1)
        const int row = r + (e >> 1) * 8, j = 2 * t + (e & 1);
        if (j < cn && row < lim) {
          const float wr = __ldg(wl + row);
          out[(size_t)cells[j] * C + row] = wr == 0.f ? INVALID : (acc[e] - 8.f * qsum[j]) * wr;
        }
        acc[e] = 0.f;
      }
    }
  }
}

// The grouping pass (and, with B > 0, the query pre-pass) on `stream`.
cudaError_t group(const int32_t* probe, int n, int L, int G, int C, const int32_t* nblocks,
                  int32_t* scratch, const float* q, int B, int D, cudaStream_t stream) {
  const bool in_smem = L < SMEM_BINS;
  const size_t smem = in_smem ? sizeof(int) * (L + 1) : 0;
  cudaError_t err = cudaFuncSetAttribute(int4_group_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(int) * SMEM_BINS));
  if (err != cudaSuccess) return err;
  int4_group_kernel<<<1 + B, GROUP_THREADS, smem, stream>>>(probe, n, L, G, C, nblocks, scratch,
                                                            q, B, D, in_smem);
  return cudaGetLastError();
}

}  // namespace int4g

}  // namespace

// fmt: 0 = bf16 rows [L, C, D], 1 = f32 rows [L, C, D], 2 = int8 codes
// [L, C, D] (packed int4 has its own entries below). q [B, D] f32,
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
    default: return (int)cudaErrorInvalidValue;
  }
}

// Words of int32 scratch the int4 probe (B > 0, with its query pre-pass)
// or its grouping pass alone (B = 0) needs for n = B * P cells over L lists;
// start [L + 2] sits at word 0, order [n] at word order_word(L).
extern "C" long gvdb_ivf_int4_scratch_words(int n, int L, int B, int D) {
  return int4g::Scratch(n, L, B, D).words;
}
extern "C" long gvdb_ivf_int4_order_word(int L) { return int4g::Scratch(0, L, 0, 0).order; }

// The int4 probe's grouping pass alone: probe [n_cells] int32 list ids,
// scratch as gvdb_ivf_int4_scratch_words(n_cells, L, 0, 0) gives it, whose
// start and order it fills. One launch. Returns a cudaError_t.
extern "C" int gvdb_ivf_group(int device, const int32_t* probe, int n_cells, int L,
                              int32_t* scratch, void* stream) {
  if (n_cells <= 0 || L <= 0 || L >= 2147483647 - 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)int4g::group(probe, n_cells, L, 0, 0, nullptr, scratch, nullptr, 0, 0,
                           static_cast<cudaStream_t>(stream));
}

// The int4 probe over packed split-plane nibbles: codes [L, C, D/2] bytes
// (16-byte aligned), q [B, D] f32, probe [B, P] int32, w [L, C] f32, nblocks
// [L] int32, out [B, P, C] f32, scratch [gvdb_ivf_int4_scratch_words(B P,
// L, B, D)] int32, all contiguous on `device`. D % 32 == 0 and D <= 12288.
// Two launches: the grouping pass with the query pre-pass, then one block a
// group of the probe (B * P blocks; those past the groups return). Returns a
// cudaError_t (0 = launched).
extern "C" int gvdb_ivf_probe_int4(int device, const float* q, const int32_t* probe,
                                   const void* codes, const float* w, const int32_t* nblocks,
                                   float* out, int32_t* scratch, int B, int P, int L, int C,
                                   int D, void* stream) {
  if (B <= 0 || P <= 0 || L <= 0 || C <= 0 || D <= 0 || D % 32 != 0 || D > 12288 ||
      int4g::Scratch((long)B * P, L, B, D).words > 2147483647L ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n = B * P;
  const int qh = int4g::half_dims(D), sq = int4g::query_row_bytes(D);
  const int G = int4g::group_size(D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = int4g::group(probe, n, L, G, C, nblocks, scratch, q, B, D, s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)int4g::STAGES * int4g::STAGE_BYTES + (size_t)G * sq;
  err = cudaFuncSetAttribute(int4g::int4_probe_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return (int)err;
  int4g::int4_probe_kernel<<<n, int4g::THREADS, smem, s>>>(
      scratch, static_cast<const uint8_t*>(codes), w, out, n, L, B, P, C, D, qh, sq);
  return (int)cudaGetLastError();
}

extern "C" const char* gvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
