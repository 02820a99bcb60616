// Ragged IVF probe kernels for the partitioned search (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernels of grape_vector_db_tpu/ops/ivf_pallas.py,
// which share one ragged fetch (_ragged_cell_dma) and one contract:
//   probe_kernel<FMT_BF16> (and <FMT_F32>): _probe_kernel,      wrapper ivf_probe_scores
//   group_kernel + int8_probe_kernel:        _probe_kernel_int8, wrapper ivf_probe_scores_int8
//   group_kernel + int4_probe_kernel:        _probe_kernel_int4, wrapper ivf_probe_scores_int4
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
// probe_kernel<FMT> (bf16, f32), simple first. One thread block per (b, p)
// cell, as the TPU kernel walks one cell per grid step. The block stages q'
// in shared memory, writes the -1e9 tail past the row limit, then its 8
// warps stride over the rows below the limit, 4 rows a warp at a time so each
// lane keeps 4 independent 16-byte loads in flight; lanes stride over a row's
// 16-byte chunks, read the chunk's query values from shared memory into
// registers once for the 4 rows, FMA in f32, and the warp reduces with
// shuffles. Rows whose weight is 0 (free cells, deleted rows) are not read.
// Each cell reads its list again.
//
// The grouping pass, group_kernel (int8 and int4). Block 0: a counting sort
// of the B * P cells by list (ids outside [0, L) into bin L): counts in
// shared memory, an exclusive scan into start[L + 2] (bins in list order), a
// scatter into order[] (any order within a bin), and each bin cut into groups
// of G <= 8 cells, each with a header (list, cells, row limit) and its cells;
// for int8 also the groups in descending order of their 64-row tiles (a
// counting sort on the tile count) and a zeroed work counter. Blocks 1 .. B
// of the same launch round each query to bf16 once and sum it in one order;
// for int8, blocks B + 1 .. find each probed list's live limit, one past its
// last row below the row limit whose weight is not 0.
//
// int4, grouped by list on the tensor cores. Converting every nibble with
// the int-to-float unit (a quarter of the FMA rate) and an FMA a nibble held
// the per-cell form at 3.4x its bound, and a 192-byte row (D = 384) left 20
// of a warp's 32 lanes idle. So:
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
//
// int8, grouped by list and streamed by a persistent grid. The per-cell form
// read each list once a cell at ~1.65 TB/s, and a 384-byte row left 8 of 32
// lanes idle. int8_probe_kernel:
// - Three blocks an SM (as many as the shared memory holds) take the groups,
//   largest first, from an atomic counter. One producer thread keeps a ring
//   of 128-row x 128-byte stages in flight with 2-D TMA loads of the codes
//   viewed as [L * C, D] bytes (128-byte swizzle; zero fill past D), each
//   stage completed on a `full` mbarrier with expect-tx and freed on an
//   `empty` mbarrier that the 8 consumer warps arrive on: no block-wide
//   barrier a stage. A list streams up to its live limit (rows past it
//   score -1e9 in any case); its last tile in 16-row boxes. The producer
//   runs ahead across groups: a group's header, cells and q' rows (1-D bulk
//   copies of the grouping pass's bf16 rows) go to one of two slots with
//   their own full / empty pair, so the next group's first stages load while
//   the consumers score the last rows of this one.
// - The kernel is launched as a programmatic dependent of the grouping pass:
//   its blocks set up while the pass runs, and the producer waits for the
//   pass's results (griddepcontrol.wait) before it reads them.
// - Consumer warp w owns rows 16 w .. 16 w + 15 of a stage; its mma rows g
//   and g + 8 are stage rows 16 w + rg and 16 w + 8 + rg with rg = 4 (g & 1)
//   + g / 2, so the two rows a quarter warp reads differ in bit 2 and the
//   swizzle puts their 64-byte halves on different banks. The product is
//   int4_probe_kernel's: mma.sync m16n8k16 bf16 -> f32 with the group's
//   cells on N and the same k-axis permutation (lane t's word i: bytes
//   4i .. 4i+3 into k-slots 2t, 2t+1, 2t+8, 2t+9).
// - A byte s becomes bf16 exactly on the integer and FP units: u = s ^ 0x80
//   (one lop3 a word), prmt puts u under 0x4B0000, the f32 2^23 + u, one
//   fadd takes 2^23 + 128 off, which leaves s exactly; |s| <= 128 leaves the
//   low 16 bits of that float zero, so one prmt of two floats' high halves is
//   the bf16x2 pair.
// - The epilogue applies the weight and the -1e9 rules and writes each
//   cell's rows; the consumers write the -1e9 tail past the live limit when
//   they take up a group.
// What holds it back (PERF.md): once the grouping pass is done the lists
// stream at ~2.6 TB/s (D = 768; ~2.2 at D = 384, whose groups are half the
// bytes), and the unpack and products add ~5%; the grouping pass (~0.01 ms)
// is a tenth of the call at D = 768, a sixth at D = 384.
// bf16 products are exact in f32, so integer-valued inputs give exact sums
// in either form; otherwise sums differ from the per-cell order in the last
// bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RB = 64;          // rows per nblocks unit
constexpr int ROWS = 4;         // rows a warp scores together
constexpr float INVALID = -1e9f;

enum Fmt { FMT_BF16 = 0, FMT_F32 = 1 };

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

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}


// -- the grouping pass of the grouped probes (int8, int4) ---------------------------

namespace grp {

constexpr int GROUP_THREADS = 1024;
constexpr int MAX_GROUP = 8;               // cells a group: the mma's N
constexpr int SMEM_BINS = 24 * 1024;       // bins the grouping pass counts in shared memory
constexpr int SIZE_KEYS = GROUP_THREADS;   // tile counts the size order tells apart

__host__ __device__ __forceinline__ int bin_of(int l, int L) { return (l >= 0 && l < L) ? l : L; }

// The scratch of one probe call, in int32 words (each region 16-byte
// aligned): start [L + 2] and order [n] first (the plain version's outputs),
// then cursor and gstart [L + 1], n_groups, the groups' headers [n] int4
// (list or -1, cells, row limit, 0) and cells [n][8], the queries' bf16 rows
// [B][D] and their sums [B], the work counter of the persistent int8 kernel,
// the groups in descending order of their tiles [n] and each probed list's
// live limit [L].
struct Scratch {
  long start, order, cursor, gstart, n_groups, headers, cells, qb, qsum, next, by_size, live,
      words;
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
    next = up(qsum + B);
    by_size = up(next + 1);
    live = up(by_size + n);
    words = live + L;
  }
};

// Exclusive sum of v over the block's threads (GROUP_THREADS of them), in
// thread order; part [32] is shared scratch. Every thread must call it.
__device__ __forceinline__ int block_exclusive_sum(int v, int* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int s = part[lane];
    int y = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, off);
      if (lane >= off) y += z;
    }
    part[lane] = y - s;
  }
  __syncthreads();
  return part[warp] + x - v;
}

// Block 0 is the grouping pass: a counting sort of the n_cells cells by
// list. start [L + 2] out: bin k (list k, or L for ids outside [0, L)) holds
// sorted positions [start[k], start[k + 1]); order [n_cells] out: the cells
// of each bin, in any order within it. The L + 1 counters live in shared
// memory (dynamic, when L < SMEM_BINS) or in cursor [L + 1]. With G > 0 it
// also cuts each bin into groups of G cells: n_groups, and for group k its
// header (list or -1, cells, min(C, 64 nblocks[list]) or 0) and its cells;
// with by_size also by_size [n_groups], the groups in descending order of
// their 64-row tiles; and the work counter next = 0.
// Blocks 1 .. B prepare the queries: qb[b] = bf16(q[b]) (round to nearest
// even), qsum[b] = sum(qb[b]) in f32 in one fixed order. With w, blocks
// B + 1 .. give one warp to each cell: live[l] = 1 + the last row below
// min(C, 64 nblocks[l]) whose weight w[l, row] is not 0 (0 if none), for
// each probed list l (every cell of l writes the same value).
__global__ void __launch_bounds__(GROUP_THREADS)
group_kernel(const int32_t* __restrict__ probe, int n_cells, int L, int G, int C,
             const int32_t* __restrict__ nblocks, int32_t* __restrict__ scratch,
             const float* __restrict__ q, int B, int D, const float* __restrict__ w,
             bool in_smem, bool by_size) {
  extern __shared__ int bins_s[];
  __shared__ float wpart[GROUP_THREADS / 32];
  __shared__ int wsum[GROUP_THREADS / 32], wgsum[GROUP_THREADS / 32];
  __shared__ int total, gtotal;
  __shared__ int keys[SIZE_KEYS];
  const Scratch at(n_cells, L, B, D);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the int8 probe launched after this pass may start its prologue now; it
  // waits for this grid's results before it reads them
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  if (blockIdx.x > B) {                            // cell (blockIdx.x - B - 1) * 32 + warp
    const int c = (blockIdx.x - B - 1) * (GROUP_THREADS / 32) + warp;
    if (c >= n_cells) return;
    const int l = probe[c];
    if (l < 0 || l >= L) return;
    const float* wl = w + (size_t)l * C;
    int hi = min(C, RB * min(max(nblocks[l], 0), C / RB + 1)), found = 0;
    while (hi > 0) {                               // 32 rows at a time, from the top
      const int lo = max(hi - 32, 0), r = lo + lane;
      const unsigned m = __ballot_sync(0xffffffffu, r < hi && __ldg(wl + r) != 0.f);
      if (m) {
        found = lo + 32 - __clz(m);
        break;
      }
      hi = lo;
    }
    if (lane == 0) scratch[at.live + l] = found;
    return;
  }
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
  if (by_size) keys[tid] = 0;
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
    if (G > 0) scratch[at.next] = 0;
  }
  for (int c = tid; c < n_cells; c += GROUP_THREADS)
    order[atomicAdd(cnt + bin_of(probe[c], L), 1)] = c;
  if (G == 0) return;
  __syncthreads();                                 // order and start are complete
  int4* headers = reinterpret_cast<int4*>(scratch + at.headers);
  int32_t* cells = scratch + at.cells;
  auto key_of = [](int lim) { return min((lim + RB - 1) / RB, SIZE_KEYS - 1); };
  for (int pos = tid; pos < n_cells; pos += GROUP_THREADS) {
    const int cell = order[pos], l = probe[cell], bin = bin_of(l, L);
    const int first = start[bin], j = (pos - first) % G;
    const int k = gstart[bin] + (pos - first) / G;
    cells[8 * k + j] = cell;
    if (j == 0) {
      const int lim = bin < L ? min(C, RB * min(max(nblocks[l], 0), C / RB + 1)) : 0;
      headers[k] = make_int4(bin < L ? l : -1, min(G, start[bin + 1] - pos), lim, 0);
      if (by_size) atomicAdd(keys + key_of(lim), 1);
    }
  }
  if (!by_size) return;
  __syncthreads();                                 // the headers and the key counts are complete
  // keys in descending order: thread i takes key SIZE_KEYS - 1 - i
  const int key = SIZE_KEYS - 1 - tid;
  const int first = block_exclusive_sum(keys[key], wsum);
  keys[key] = first;                               // each thread reads and writes its own key
  __syncthreads();
  for (int k = tid; k < gcarry; k += GROUP_THREADS)
    scratch[at.by_size + atomicAdd(keys + key_of(headers[k].z), 1)] = k;
}

// The grouping pass (with B > 0 the query pre-pass, with w the lists' live
// limits) on `stream`.
cudaError_t group(const int32_t* probe, int n, int L, int G, int C, const int32_t* nblocks,
                  int32_t* scratch, const float* q, int B, int D, const float* w, bool by_size,
                  cudaStream_t stream) {
  const bool in_smem = L < SMEM_BINS;
  const size_t smem = in_smem ? sizeof(int) * (L + 1) : 0;
  cudaError_t err = cudaFuncSetAttribute(group_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(int) * SMEM_BINS));
  if (err != cudaSuccess) return err;
  const int live_blocks = w == nullptr ? 0 : (n + GROUP_THREADS / 32 - 1) / (GROUP_THREADS / 32);
  group_kernel<<<1 + B + live_blocks, GROUP_THREADS, smem, stream>>>(
      probe, n, L, G, C, nblocks, scratch, q, B, D, w, in_smem, by_size);
  return cudaGetLastError();
}

}  // namespace grp


// -- int4: the grouped tensor-core kernel ---------------------------------------------

namespace int4g {

using grp::Scratch;

constexpr int THREADS = 128;               // 4 warps, 16 rows each
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUP = grp::MAX_GROUP;  // cells a group: the mma's N
constexpr int RT = WARPS * 16;             // rows a stage
constexpr int SB = 128;                    // row bytes a stage (256 dims)
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = RT * SB;       // 8 KB
constexpr int Q_BUDGET = 64 * 1024;        // bytes of staged queries a block

// Staged queries: each cell's low and high halves of D, padded to whole
// slices (qh dims each), a row of 4 qh + 16 bytes (16 mod 128: a quarter
// warp's 16-byte reads of 8 rows hit 32 banks); G cells fit Q_BUDGET.
int half_dims(int D) { return (D / 2 + SB - 1) / SB * SB; }
int query_row_bytes(int D) { return 4 * half_dims(D) + 16; }
int group_size(int D) { return std::min(MAX_GROUP, Q_BUDGET / query_row_bytes(D)); }

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
}  // namespace int4g


// -- int8: the persistent grouped kernel ------------------------------------------------

namespace i8g {

using grp::MAX_GROUP;
using grp::Scratch;

constexpr int CONSUMER_WARPS = 8;          // 16 rows of a stage each
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);   // and the producer warp
constexpr int RT = 16 * CONSUMER_WARPS;    // rows a stage (a box of the tensor map)
constexpr int SB = 128;                    // row bytes a stage: one 128-byte swizzle row
constexpr int STAGE_BYTES = RT * SB;       // 16 KB
constexpr int MAX_STAGES = 16;
constexpr int BLOCKS_PER_SM = 3;
constexpr int Q_SLOT_BUDGET = 32 * 1024;   // bytes of staged queries a group
constexpr int RQ = 16;                     // rows a box of a list's last, short tile

// Staged queries: a cell's q' (D bf16) zero-padded to whole 128-dim slices,
// a row of 2 pad + 16 bytes (16 mod 128: a quarter warp's 16-byte reads of
// 2 rows hit 32 banks); G cells a group fit Q_SLOT_BUDGET.
int padded_dims(int D) { return (D + SB - 1) / SB * SB; }
int query_row_bytes(int D) { return 2 * padded_dims(D) + 16; }
int group_size(int D) { return std::min(MAX_GROUP, Q_SLOT_BUDGET / query_row_bytes(D)); }

// -- PTX wrappers (as in csrc/segmax_max.cu: each source builds on its own) --

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// WAIT_LIMIT_NS traps, so a fault in the ring ends the launch with an error
// instead of hanging the card.
constexpr uint64_t WAIT_LIMIT_NS = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer_ns();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer_ns() - t0 > WAIT_LIMIT_NS) __trap();
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, completed on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Four int8 codes (one word) as two bf16x2 pairs, exactly: bytes 0, 1 into
// lo and bytes 2, 3 into hi. u = s ^ 0x80 = s + 128 under 0x4B0000 is the
// f32 2^23 + u; taking 2^23 + 128 off leaves s, whose low 16 bits are zero
// (|s| <= 128), so the float's high half is s in bf16.
__device__ __forceinline__ void i8x4_bf16(uint32_t x, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = x ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Persistent: each block takes groups from the work counter, in the size
// order by_size, until they run out. codes is the tensor map
// of the codes as [L * C, D] bytes, box 128 bytes x RT rows, 128-byte
// swizzle, codes16 the same with RQ-row boxes (the last tile of a list cut
// at its live limit); w [L, C] f32, out [n, C] f32 with n = B * P cells. Dynamic
// shared memory: 1024 bytes of alignment, `stages` stages of STAGE_BYTES,
// then two query slots of G rows of SQ bytes.
__global__ void __launch_bounds__(THREADS)
int8_probe_kernel(const __grid_constant__ CUtensorMap codes,
                  const __grid_constant__ CUtensorMap codes16, int32_t* __restrict__ scratch,
                  const float* __restrict__ w, float* __restrict__ out, int n, int L, int B,
                  int P, int C, int D, int G, int SQ, int stages) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * MAX_STAGES + 4];
  // a slot's group: taken (0 = no group left), list, cells, row limit, its cells
  __shared__ int info[2][4 + MAX_GROUP];

  const Scratch at(n, L, B, D);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 1023u) & ~1023u;    // the swizzle repeats every 1024 bytes
  const unsigned char* const ring_p = smem_raw + (ring - raw);
  const int slot_bytes = G * SQ;
  unsigned char* const qslots = smem_raw + (ring - raw) + stages * STAGE_BYTES;
  const uint32_t qslots_s = ring + stages * STAGE_BYTES;
  const uint32_t bar0 = static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  auto full = [=](int s) { return bar0 + 8 * s; };
  auto empty = [=](int s) { return bar0 + 8 * (MAX_STAGES + s); };
  auto qfull = [=](int s) { return bar0 + 8 * (2 * MAX_STAGES + s); };
  auto qempty = [=](int s) { return bar0 + 8 * (2 * MAX_STAGES + 2 + s); };
  const int n_s = (D + SB - 1) / SB;               // 128-byte slices a row

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMER_WARPS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(qfull(s), 1);
      mbar_init(qempty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the staged rows' padding past D stays zero (the copies write D dims)
  const int pad16 = (SQ - 2 * D) / 16;
  for (int i = tid; i < 2 * G * pad16; i += THREADS) {
    const int r = i / pad16;
    *reinterpret_cast<uint4*>(qslots + (size_t)r * SQ + 2 * D + 16 * (i - r * pad16)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // -- the producer: one thread keeps the ring and the query slots full ---------
    if (lane != 0) return;
    asm volatile("griddepcontrol.wait;" ::: "memory");   // the grouping pass is complete
    const int ng = scratch[at.n_groups];
    const char* qb = reinterpret_cast<const char*>(scratch + at.qb);
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0;; ++it) {
      const int qs = it & 1;
      const int k = atomicAdd(scratch + at.next, 1);
      int l = -1, cn = 0, lim = 0;
      int cl[MAX_GROUP];
      if (k < ng) {
        const int kk = scratch[at.by_size + k];
        const int4 h = reinterpret_cast<const int4*>(scratch + at.headers)[kk];
        l = h.x;
        cn = h.y;
        lim = l >= 0 ? min(h.z, scratch[at.live + l]) : 0;
#pragma unroll
        for (int j = 0; j < MAX_GROUP; ++j) cl[j] = j < cn ? scratch[at.cells + 8 * kk + j] : 0;
      }
      mbar_wait(qempty(qs), ((it >> 1) & 1) ^ 1);
      info[qs][0] = k < ng;
      info[qs][1] = l;
      info[qs][2] = cn;
      info[qs][3] = lim;
#pragma unroll
      for (int j = 0; j < MAX_GROUP; ++j) info[qs][4 + j] = cl[j];
      if (k >= ng || lim == 0) {
        mbar_arrive(qfull(qs));                    // releases the slot's header
        if (k >= ng) return;
        continue;
      }
      mbar_expect_tx(qfull(qs), static_cast<uint32_t>(cn) * 2 * D);
#pragma unroll
      for (int j = 0; j < MAX_GROUP; ++j)
        if (j < cn)
          bulk_load(qslots_s + qs * slot_bytes + j * SQ, qb + (size_t)(cl[j] / P) * 2 * D,
                    2 * D, qfull(qs));
      for (int r0 = 0; r0 < lim; r0 += RT) {
        const int boxes = (min(lim - r0, RT) + RQ - 1) / RQ;   // RQ-row boxes of a short tile
        for (int s = 0; s < n_s; ++s) {
          mbar_wait(empty(stage), phase ^ 1);
          const uint32_t buf = ring + stage * STAGE_BYTES;
          if (boxes == RT / RQ) {
            mbar_expect_tx(full(stage), STAGE_BYTES);
            tma_load_2d(buf, &codes, full(stage), s * SB, l * C + r0);
          } else {                                 // the swizzle repeats every 8 rows
            mbar_expect_tx(full(stage), boxes * RQ * SB);
            for (int i = 0; i < boxes; ++i)
              tma_load_2d(buf + i * RQ * SB, &codes16, full(stage), s * SB, l * C + r0 + i * RQ);
          }
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  }

  // -- the consumers: warp w scores rows 16 w .. 16 w + 15 of every stage -------------
  const int g = lane >> 2, t = lane & 3;           // mma row group, thread in group
  const int rg = ((g & 1) << 2) | (g >> 1);        // stage rows 16 w + rg and + 8
  const int sa = 16 * warp + rg;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0;; ++it) {
    const int qs = it & 1;
    mbar_wait(qfull(qs), (it >> 1) & 1);
    const int* inf = info[qs];
    if (!inf[0]) return;
    const int l = inf[1], cn = inf[2], lim = inf[3];
    const int tail = C - lim;
    for (int i = tid; i < cn * tail; i += 32 * CONSUMER_WARPS) {   // the -1e9 tail
      const int j = i / tail;
      out[(size_t)inf[4 + j] * C + lim + (i - j * tail)] = INVALID;
    }
    const uint16_t* qg = reinterpret_cast<const uint16_t*>(qslots + qs * slot_bytes + g * SQ);
    const float* wl = w + (size_t)max(l, 0) * C;
    for (int r0 = 0; r0 < lim; r0 += RT) {
      const int ra = r0 + sa, rb = ra + 8;
      const float wa = ra < lim ? __ldg(wl + ra) : 0.f, wb = rb < lim ? __ldg(wl + rb) : 0.f;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s < n_s; ++s) {
        mbar_wait(full(stage), phase);
        const unsigned char* buf = ring_p + stage * STAGE_BYTES;
        uint4 xa[2], xb[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {              // the slice's two 64-byte halves
          const int c = ((4 * h + t) ^ rg) << 4;   // the swizzled 16-byte chunk
          xa[h] = *reinterpret_cast<const uint4*>(buf + sa * SB + c);
          xb[h] = *reinterpret_cast<const uint4*>(buf + (sa + 8) * SB + c);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(stage));  // the stage's bytes are in registers
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d0 = s * SB + 64 * h;          // the half's first dim
          if (d0 >= D) break;                      // uniform: past the row
          uint4 q0 = make_uint4(0u, 0u, 0u, 0u), q1 = q0;
          if (g < cn) {
            q0 = *reinterpret_cast<const uint4*>(qg + d0 + 16 * t);
            q1 = *reinterpret_cast<const uint4*>(qg + d0 + 16 * t + 8);
          }
          const uint32_t bq[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
          const uint32_t wa4[4] = {xa[h].x, xa[h].y, xa[h].z, xa[h].w};
          const uint32_t wb4[4] = {xb[h].x, xb[h].y, xb[h].z, xb[h].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {            // k-step i: bytes 4i .. 4i + 3
            uint32_t a01, a23, b01, b23;
            i8x4_bf16(wa4[i], a01, a23);
            i8x4_bf16(wb4[i], b01, b23);
            mma_bf16(acc, a01, b01, a23, b23, bq[2 * i], bq[2 * i + 1]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {                // (ra, 2t), (ra, 2t+1), (rb, 2t), (rb, 2t+1)
        const int row = e < 2 ? ra : rb, j = 2 * t + (e & 1);
        const float wr = e < 2 ? wa : wb;
        if (j < cn && row < lim)
          out[(size_t)inf[4 + j] * C + row] = wr == 0.f ? INVALID : acc[e] * wr;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(qempty(qs));        // done with the slot's header and rows
  }
}

}  // namespace i8g

// -- host side -------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Error codes of this library beside cudaError_t's (see gvdb_cuda_error_string).
constexpr int ERR_NO_ENCODER = -1;       // the CUDA driver has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE_BASE = -1000;   // -1000 - CUresult: a map was refused

// cuTensorMapEncodeTiled through the runtime (the library links no libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The persistent int8 kernel's shape at width D on `device`: stages of its
// ring, dynamic shared memory (bytes) and blocks an SM. BLOCKS_PER_SM
// blocks share the SM's shared memory, each less 1 KB the runtime keeps a
// block and 2 KB for static shared memory and alignment.
struct Int8Plan {
  int stages, smem, per_sm, sms;
};

cudaError_t int8_plan(int D, int device, Int8Plan* plan) {
  int smem_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&plan->sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return err;
  const int queries = 2 * i8g::group_size(D) * i8g::query_row_bytes(D);
  const int per_block = smem_sm / i8g::BLOCKS_PER_SM - 3 * 1024;
  plan->stages =
      std::max(2, std::min(i8g::MAX_STAGES, (per_block - queries) / i8g::STAGE_BYTES));
  plan->smem = 1024 + plan->stages * i8g::STAGE_BYTES + queries;
  err = cudaFuncSetAttribute(i8g::int8_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan->smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&plan->per_sm, i8g::int8_probe_kernel,
                                                       i8g::THREADS, plan->smem);
}

// The int8 probe's second launch: the persistent kernel over the groups the
// grouping pass wrote into scratch.
int int8_launch(const void* codes, const float* w, float* out, int32_t* scratch, int B, int P,
                int L, int C, int D, int device, cudaStream_t stream) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  CUtensorMap maps[2];                            // boxes of RT and of RQ rows
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(L) * C};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D)};
  const cuuint32_t ones[2] = {1, 1};
  for (int m = 0; m < 2; ++m) {
    const cuuint32_t box[2] = {i8g::SB, m == 0 ? i8g::RT : i8g::RQ};
    const CUresult r = fn(&maps[m], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(codes),
                          dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return ERR_ENCODE_BASE - static_cast<int>(r);
  }
  Int8Plan plan;
  cudaError_t err = int8_plan(D, device, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = std::min(std::max(plan.per_sm, 1) * plan.sms, B * P);
  // launched as a programmatic dependent of the grouping pass: its blocks set
  // up while the pass runs, and only the producer, which reads the pass's
  // results, waits for it (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(i8g::THREADS);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, i8g::int8_probe_kernel, maps[0], maps[1], scratch, w, out,
                           B * P, L, B, P, C, D, i8g::group_size(D), i8g::query_row_bytes(D),
                           plan.stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fmt: 0 = bf16 rows [L, C, D], 1 = f32 rows [L, C, D] (int8 and packed
// int4 codes have their own entries below). q [B, D] f32, probe [B, P]
// int32, w [L, C] f32, nblocks [L] int32, out [B, P, C] f32, all contiguous
// on `device`, data 16-byte aligned. A stored row must split into 16-byte
// chunks and D <= 12288 (the staged query fits 48 KB of shared memory).
// Returns a cudaError_t (0 = launched).
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
    default: return (int)cudaErrorInvalidValue;
  }
}

// Words of int32 scratch a grouped probe (B > 0, with its query pre-pass)
// or the grouping pass alone (B = 0) needs for n = B * P cells over L lists;
// start [L + 2] sits at word 0, order [n] at word gvdb_ivf_order_word(L).
extern "C" long gvdb_ivf_scratch_words(int n, int L, int B, int D) {
  return grp::Scratch(n, L, B, D).words;
}
extern "C" long gvdb_ivf_order_word(int L) { return grp::Scratch(0, L, 0, 0).order; }

// The grouping pass alone: probe [n_cells] int32 list ids, scratch as
// gvdb_ivf_scratch_words(n_cells, L, 0, 0) gives it, whose start and order
// it fills. One launch. Returns a cudaError_t.
extern "C" int gvdb_ivf_group(int device, const int32_t* probe, int n_cells, int L,
                              int32_t* scratch, void* stream) {
  if (n_cells <= 0 || L <= 0 || L >= 2147483647 - 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)grp::group(probe, n_cells, L, 0, 0, nullptr, scratch, nullptr, 0, 0, nullptr,
                         false, static_cast<cudaStream_t>(stream));
}

// The int4 probe over packed split-plane nibbles: codes [L, C, D/2] bytes
// (16-byte aligned), q [B, D] f32, probe [B, P] int32, w [L, C] f32, nblocks
// [L] int32, out [B, P, C] f32, scratch [gvdb_ivf_scratch_words(B P, L, B,
// D)] int32, all contiguous on `device`. D % 32 == 0 and D <= 12288. Two
// launches: the grouping pass with the query pre-pass, then one block a
// group of the probe (B * P blocks; those past the groups return). Returns
// a cudaError_t (0 = launched).
extern "C" int gvdb_ivf_probe_int4(int device, const float* q, const int32_t* probe,
                                   const void* codes, const float* w, const int32_t* nblocks,
                                   float* out, int32_t* scratch, int B, int P, int L, int C,
                                   int D, void* stream) {
  if (B <= 0 || P <= 0 || L <= 0 || C <= 0 || D <= 0 || D % 32 != 0 || D > 12288 ||
      grp::Scratch((long)B * P, L, B, D).words > 2147483647L ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n = B * P;
  const int qh = int4g::half_dims(D), sq = int4g::query_row_bytes(D);
  const int G = int4g::group_size(D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = grp::group(probe, n, L, G, C, nblocks, scratch, q, B, D, nullptr, false, s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)int4g::STAGES * int4g::STAGE_BYTES + (size_t)G * sq;
  err = cudaFuncSetAttribute(int4g::int4_probe_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return (int)err;
  int4g::int4_probe_kernel<<<n, int4g::THREADS, smem, s>>>(
      scratch, static_cast<const uint8_t*>(codes), w, out, n, L, B, P, C, D, qh, sq);
  return (int)cudaGetLastError();
}

// The int8 probe: codes [L, C, D] int8 (16-byte aligned), q [B, D] f32,
// probe [B, P] int32, w [L, C] f32, nblocks [L] int32, out [B, P, C] f32,
// scratch [gvdb_ivf_scratch_words(B P, L, B, D)] int32, all contiguous on
// `device`. D % 16 == 0, D <= 12288 and L * C < 2^31 rows. Two launches:
// the grouping pass with the query pre-pass and the size order, then the
// persistent kernel (three blocks an SM). Returns 0 once launched, a
// cudaError_t, or one of this library's negative codes.
extern "C" int gvdb_ivf_probe_int8(int device, const float* q, const int32_t* probe,
                                   const void* codes, const float* w, const int32_t* nblocks,
                                   float* out, int32_t* scratch, int B, int P, int L, int C,
                                   int D, void* stream) {
  if (B <= 0 || P <= 0 || L <= 0 || C <= 0 || D <= 0 || D % 16 != 0 || D > 12288 ||
      (long)L * C > 2147483647L || grp::Scratch((long)B * P, L, B, D).words > 2147483647L ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = grp::group(probe, B * P, L, i8g::group_size(D), C, nblocks, scratch, q, B, D, w, true,
                   s);
  if (err != cudaSuccess) return (int)err;
  return int8_launch(codes, w, out, scratch, B, P, L, C, D, device, s);
}

// The int8 probe kernel's launch shape at width D: out4 = stages of its
// ring, dynamic shared memory in bytes, blocks an SM, threads a block.
// Returns a cudaError_t.
extern "C" int gvdb_ivf_int8_plan(int device, int D, int* out4) {
  if (D <= 0 || D % 16 != 0 || D > 12288) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Int8Plan plan;
  err = int8_plan(D, device, &plan);
  out4[0] = plan.stages;
  out4[1] = plan.smem;
  out4[2] = plan.per_sm;
  out4[3] = i8g::THREADS;
  return (int)err;
}

extern "C" const char* gvdb_cuda_error_string(int code) {
  if (code == ERR_NO_ENCODER)
    return "the CUDA driver has no cuTensorMapEncodeTiled (cudaGetDriverEntryPoint)";
  if (code <= ERR_ENCODE_BASE) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
