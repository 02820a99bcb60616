// Candidate gather-dot kernels for graph search (Hopper, sm_90a).
//
// Replace the Pallas TPU kernel _gather_kernel of
// grape_vector_db_tpu/ops/gather_pallas.py (called through
// _gather_dots_pallas / gather_dots(impl="pallas")), and are bound to PyTorch
// through a plain C interface (ctypes) by grape_vector_db_tpu_torch/ops/gather.py,
// which also holds the plain PyTorch version of the same contract
// (gather_dots_ref), the grouping step and the rule that picks a route.
//
// Contract. q [B, D] f32 (already prepared: unit rows for cosine), vectors
// [N, D] bf16 or f32, ids [B, C] int32, out [B, C] f32:
//   out[b, c] = sum_d q'[b, d] * vectors[clamp(ids[b, c], 0, N - 1), d],
// summed in f32, where q' is q rounded to bf16 (round to nearest even) for
// bf16 storage and q itself for f32 storage (true f32 FMA: the reference
// asks for Precision.HIGHEST there). An id outside [0, N) is clamped, as the
// Pallas kernel clamps; it never drives a read out of bounds. Any B, C and
// D <= 12288; every output element is written exactly once.
//
// What bounds it on an H100. Each (query, candidate) pair is 2 FLOP for every
// 2 bytes of a bf16 row, so bytes bound it. The least bytes are the distinct
// rows the ids name, each read once: at the NN-descent build's shape (B = 2048
// nodes, C = 576 candidates, D = 768) 1,179,648 pairs name ~105k distinct rows
// (161 MB, ~11 pairs a row); at the beam's (B = 128, C = 256) 32,768 pairs
// name ~23k (~1.4 pairs a row).
//
// Two routes; ops/gather.py picks one by a rule on B, C and the storage type.
//
// "pairs" (gather_dots_kernel<FMT, VEC>, both storage types): one thread block
// scores 32 candidates of one query. It stages q' in shared memory (as f32),
// then each of its 8 warps scores 4 candidate rows together, its lanes
// striding over the rows' 16-byte chunks, FMA in f32 and a shuffle reduction a
// row. Every pair reads its row again (1.81 GB at the build shape, mostly
// from L2), so what L2 delivers to the SMs bounds it; at small shapes (the
// beam, the entry step) its one launch and short chain win.
//
// "grouped" (bf16 storage): a grouping pass, then a persistent kernel.
// - The grouping pass (namespace group) finds each query's repeated rows (the
//   NN-descent join names a row ~5 times in one list: 248,308 distinct pairs
//   of 1,179,648 in a build chunk of the smoke's graph), keeps the first copy
//   of each, and sorts the first copies by (query group, row) with a
//   counting sort: count, offsets, scatter. A last small kernel copies each
//   first copy's dot to its repeats.
// - grouped_kernel<VEC>: one 512-thread block an SM owns a contiguous
//   range of the sorted pairs, cut by count, not by row (a row named by every
//   pair still spreads over every block). D is cut into 64-dim slices. For
//   each slice the block stages the slice of its query group's q' [512, 64]
//   bf16 (64 KB) in shared memory with cp.async, double-buffered, and its
//   warps walk the slice in two 32-dim steps, reading each pair's row piece
//   from device memory with a 128-byte L2 prefetch (the row's next step
//   then comes from L2). A pair's query is read from shared memory, not
//   from L2, and the sort puts the pairs of one row side by side.
// - The products run on the tensor cores: a warp takes 16 sorted pairs at a
//   time, A = their 16 query slices, B = the rows of pairs 0-7 (then 8-15)
//   as 8 columns, mma.sync m16n8k16 bf16 -> f32, two k-steps a 32-dim step;
//   pair i's dot is C[i][col(i)]. A lane loads 16 contiguous bytes of each
//   operand (lane t of a quad holds k-slots 2t, 2t+1, 2t+8, 2t+9, mapped to
//   the same 4 dims in A and B). 7/8 of the tensor work is thrown away, which
//   does not show: the loads bound it. Query b's 16-byte chunk k sits at
//   place k ^ (b % 8), so two queries read together rarely share banks.
// - A pair's dot is summed by one fixed lane in registers, one f32 add a step
//   in step order, so two calls agree bit for bit; there are no float
//   atomics. bf16 products are exact in f32, so small integers sum exactly.
//   Batches of 512 queries form query groups. A row not in 16-byte pieces
//   (D % 8 != 0 or an unaligned base) and the tail of the last step read
//   single elements; dims past D read as zero (q' is zero-padded).
// What bounds it: the row loads' latency. Each warp keeps two batches of two
// groups in flight (registers; larger batches spill or lose), and each step
// waits on its loads; the per-slice barrier, the q staging and the chunk's
// set-up add a fixed ~30 us. PERF.md holds the measured split.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// -- the grouped route -----------------------------------------------------------

namespace grouped {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int GW = 36;                   // groups of 16 pairs a warp holds in a chunk
constexpr int KB = 2;                    // groups a batch of row loads; two batches in flight
constexpr int CAP = WARPS * GW * 16;     // pairs a chunk holds (9216)
constexpr int DS = 64;                   // dims a slice of q in shared memory
constexpr int STEP = 32;                 // dims a step of the warps: two mma k-steps
constexpr int QROW = DS * 2;             // bytes of one query's slice
constexpr int CHUNKS = QROW / 16;        // its 16-byte chunks
constexpr int SPS = DS / STEP;           // steps a slice
constexpr int MAX_QG = 512;              // queries a group (ops/gather.py GROUP_QUERIES)
constexpr int META_BYTES = CAP * 6;      // 12 bytes for two pairs, in two arrays
constexpr int SMEM_BYTES = META_BYTES + 2 * MAX_QG * QROW;   // 186,368
static_assert(MAX_QG <= 1024, "10-bit query fields");
constexpr long MIN_BLOCK_PAIRS = 2048;   // fewer blocks than SMs below this many a block
static_assert(GW % 4 == 0 && GW % KB == 0 && CAP % THREADS == 0,
              "owner rotation, load batches, records");

__device__ __forceinline__ long lmin(long a, long b) { return a < b ? a : b; }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// 16 bytes of a row, through the read-only path, asking L2 to fetch the
// 128-byte line around them (the row's next step). A 256-byte fetch was
// slower: four steps of every block's rows (~64 MB) outgrow the 50 MB L2.
__device__ __forceinline__ uint4 ldg_prefetch16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Dims d0 .. d0 + 7 of a bf16 row as four packed words; dims past D read as 0.
template <bool VEC>
__device__ __forceinline__ uint4 row_piece(const uint16_t* row, int d0, int D) {
  if (VEC && d0 + 8 <= D) return ldg_prefetch16(row + d0);
  uint32_t w[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) w[e] = d0 + e < D ? static_cast<uint32_t>(__ldg(row + d0 + e)) : 0u;
  return make_uint4(w[0] | (w[1] << 16), w[2] | (w[3] << 16), w[4] | (w[5] << 16),
                    w[6] | (w[7] << 16));
}

// D[16 x 8] = A[16 x 16] B[16 x 8] + C, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A group of 16 pairs, the k-th of its warp (r = k % 4): the pair at position
// i < 8 sits in B column (i + 2r) % 8 of the first mma and the pair at i + 8
// in the same column of the second, so the lane holding its entry C[i][col]
// is t = col / 2, which differs for the four r. Each lane thus owns the two
// pairs of exactly one group of four, and its sums take GW / 2 registers.
__device__ __forceinline__ int owner_t(int g, int r) { return ((g + 2 * r) & 7) >> 1; }

// qb [B, Dp] bf16 (q', zero past D; Dp = S * DS), vectors [N, D] bf16, ids
// [B * C]; order: the flat indices of the distinct pairs, grouped by (b / QG,
// row), query group g's totals[g] of them after the earlier groups'. Block k
// owns positions [P k / grid, P (k + 1) / grid) of the P = sum(totals).
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
grouped_kernel(const uint16_t* __restrict__ qb, const uint16_t* __restrict__ vectors,
               const int32_t* __restrict__ ids, const int32_t* __restrict__ order,
               const int* __restrict__ totals, float* __restrict__ out, int B, int C, int N,
               int D, int S, int QG, int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  // For group grp and column / position g: rows[grp][g] = the rows of B column
  // g in the two mmas; packed[grp][g] = the queries (within the query group,
  // 10 bits each) of the pairs at positions g and g + 8. Query b's slice sits
  // in 8 chunks of 16 bytes, chunk k at place k ^ (b % 8), so that two queries
  // read together fall on different banks unless b = b' (mod 8).
  uint2* rows = reinterpret_cast<uint2*>(smem);
  uint32_t* packed = reinterpret_cast<uint32_t*>(smem + CAP * 4);
  const uint32_t q_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem + META_BYTES));
  const unsigned char* q_gen = smem + META_BYTES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;      // mma row group and thread in group
  const int Dp = S * DS;
  long P = 0;
  for (int h = 0; h < groups; ++h) P += totals[h];
  const long p_lo = P * blockIdx.x / gridDim.x, p_hi = P * (blockIdx.x + 1) / gridDim.x;
  uint32_t* rows32 = reinterpret_cast<uint32_t*>(rows);

  for (long seg = p_lo; seg < p_hi;) {
    int qg = 0;                 // the query group of this run: [start, start + totals[qg])
    long start = 0;
    while (seg >= start + totals[qg]) start += totals[qg++];
    const long seg_hi = lmin(p_hi, start + totals[qg]);
    const int b0 = qg * QG, nq = min(QG, B - b0);
    for (long ch = seg; ch < seg_hi; ch += CAP) {
      const int np = static_cast<int>(lmin(CAP, seg_hi - ch));
      __syncthreads();   // the last chunk's readers of meta and of the q buffers are done
      auto stage = [&](int s, int buf) {   // slice s of the group's q' into buffer buf
        const uint32_t dst = q_base + buf * (MAX_QG * QROW);
        for (int i = tid; i < CHUNKS * nq; i += THREADS) {
          const int bl = i / CHUNKS, h = i % CHUNKS;
          cp_async16(dst + bl * QROW + ((h ^ bl) & (CHUNKS - 1)) * 16,
                     qb + (size_t)(b0 + bl) * Dp + s * DS + h * 8);
        }
        cp_async_commit();
      };
      stage(0, 0);
      // The chunk's ng groups of 16 consecutive pairs, gw a warp: warp w takes
      // groups [w gw, (w + 1) gw). Their records, a half-warp a group here
      // (THREADS is a multiple of 16).
      const int ng = (np + 15) / 16, gw = (ng + WARPS - 1) / WARPS;
      for (int i = tid; i < CAP / 2; i += THREADS) packed[i] = 0;
      // all of this thread's order and ids loads first, then the records
      constexpr int PER = CAP / THREADS;
      uint32_t pv[PER], rv[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int j = tid + u * THREADS;
        pv[u] = j < np ? static_cast<uint32_t>(order[ch + j]) : 0xffffffffu;
      }
#pragma unroll
      for (int u = 0; u < PER; ++u)
        rv[u] = pv[u] != 0xffffffffu ? static_cast<uint32_t>(min(max(__ldg(ids + pv[u]), 0), N - 1))
                                      : 0u;
      __syncthreads();   // packed is zero
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int j = tid + u * THREADS;
        // past np: query 0, row 0 (read, never written)
        const uint32_t bl = pv[u] != 0xffffffffu ? pv[u] / static_cast<uint32_t>(C) - b0 : 0u;
        const int grp = j >> 4, i = j & 7, hi = (j >> 3) & 1;
        const int col = (i + 2 * ((grp % gw) & 3)) & 7;
        rows32[(grp * 8 + col) * 2 + hi] = rv[u];
        // one atomic OR a pair: the record's two positions come from two lanes
        atomicOr(packed + grp * 8 + i, bl << (10 * hi));
      }
      float acc[GW / 4][2];
#pragma unroll
      for (int m = 0; m < GW / 4; ++m) acc[m][0] = acc[m][1] = 0.f;
      const int my_first = (warp * gw) * 8 + g;   // this warp's first record, column g
      const int my_groups = min(gw, max(0, ng - warp * gw));
      for (int s = 0; s < SPS * S; ++s) {   // steps of 32 dims, SPS a slice
        const int sl = s / SPS;
        if (s % SPS == 0) {
          cp_async_wait_all();
          __syncthreads();   // slice sl is in buffer sl & 1; slice sl - 1's readers are done
          if (sl + 1 < S) stage(sl + 1, (sl + 1) & 1);
        }
        const unsigned char* qs = q_gen + (sl & 1) * (MAX_QG * QROW);
        const uint32_t chunk = (s % SPS) * 4 + t;    // this lane's 16 bytes of the slice
        const int d0 = s * STEP + 8 * t;
        // Two batches in registers: batch b + 1's rows are in flight while
        // batch b runs.
        uint32_t mp[2][KB];
        uint4 row_lo[2][KB], row_hi[2][KB];
        auto load = [&](int b) {
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            const int k = b * KB + j;
            if (k < my_groups) {
              const uint2 m = rows[my_first + k * 8];
              mp[b & 1][j] = packed[my_first + k * 8];
              row_lo[b & 1][j] = row_piece<VEC>(vectors + (size_t)m.x * D, d0, D);
              row_hi[b & 1][j] = row_piece<VEC>(vectors + (size_t)m.y * D, d0, D);
            }
          }
        };
        load(0);
#pragma unroll
        for (int b = 0; b < GW / KB; ++b) {
          if (b * KB >= my_groups) break;   // uniform over the warp
          if (b + 1 < GW / KB) load(b + 1);
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            const int k = b * KB + j;
            if (k < my_groups) {   // uniform over the warp
              const uint32_t w = mp[b & 1][j];
              const uint32_t q_lo = w & 1023u, q_hi = (w >> 10) & 1023u;
              const uint4 a_lo = *reinterpret_cast<const uint4*>(
                  qs + q_lo * QROW + ((chunk ^ q_lo) & (CHUNKS - 1)) * 16);
              const uint4 a_hi = *reinterpret_cast<const uint4*>(
                  qs + q_hi * QROW + ((chunk ^ q_hi) & (CHUNKS - 1)) * 16);
              const uint4 bl = row_lo[b & 1][j], bh = row_hi[b & 1][j];
              float c_lo[4] = {0.f, 0.f, 0.f, 0.f}, c_hi[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16(c_lo, a_lo.x, a_hi.x, a_lo.y, a_hi.y, bl.x, bl.y);   // dims 8t .. 8t+3
              mma_bf16(c_lo, a_lo.z, a_hi.z, a_lo.w, a_hi.w, bl.z, bl.w);   // dims 8t+4 .. 8t+7
              mma_bf16(c_hi, a_lo.x, a_hi.x, a_lo.y, a_hi.y, bh.x, bh.y);
              mma_bf16(c_hi, a_lo.z, a_hi.z, a_lo.w, a_hi.w, bh.z, bh.w);
              if (t == owner_t(g, k & 3)) {
                acc[k >> 2][0] += (g & 1) ? c_lo[1] : c_lo[0];   // C[g][col]
                acc[k >> 2][1] += (g & 1) ? c_hi[3] : c_hi[2];   // C[g + 8][col]
              }
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < GW; ++k) {
        if (k < my_groups && t == owner_t(g, k & 3)) {
          const int i_lo = (warp * gw + k) * 16 + g, i_hi = i_lo + 8;
          if (i_lo < np) out[order[ch + i_lo]] = acc[k >> 2][0];
          if (i_hi < np) out[order[ch + i_hi]] = acc[k >> 2][1];
        }
      }
    }
    seg = seg_hi;
  }
}

}  // namespace grouped

// -- the grouping pass ---------------------------------------------------------

// A candidate list names a row more than once (the NN-descent join repeats its
// neighbours' neighbours: ~5 times on average at the build shape), and every
// copy of a (query, row) pair has the same dot. dedup_count_kernel finds, for
// each query, the first column naming each row (a hash table in shared
// memory): rep[b, c] = that column. Only first columns are computed; the
// expand kernel copies their dots to the rest. It also counts the distinct
// pairs of each bin, key = (b / QG) * N + row, and of each query group.
// offsets_kernel turns the counts into each bin's first position: query group
// y starts after the earlier groups' pairs, and within it the bins of a block
// take one contiguous range by one atomic add (bins land in any order, each
// bin's pairs are contiguous); scatter_kernel puts each distinct pair at its
// bin's next free position (a warp's pairs of one bin take one atomic). The
// order within a bin depends on the atomics' order, which changes no result:
// each pair's dot is computed alone.
namespace group {

constexpr int THREADS = 1024;
constexpr int DEDUP_THREADS = 256;
constexpr int MAX_TABLE = 4096;          // hash slots a query (keys and columns: 32 KB)

__device__ __forceinline__ int clamp_row(int id, int N) { return min(max(id, 0), N - 1); }

// table: slots a query, a power of two >= 2 C, or 0 for no dedup (C too large).
__global__ void __launch_bounds__(DEDUP_THREADS)
dedup_count_kernel(const int32_t* __restrict__ ids, int32_t* __restrict__ rep,
                   int* __restrict__ count, int* __restrict__ totals, int C, int N, int QG,
                   int table, int shift) {
  extern __shared__ int slots[];   // [table] keys, then [table] first columns
  __shared__ int block_sum;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int32_t* idb = ids + (size_t)b * C;
  int32_t* repb = rep + (size_t)b * C;
  int* key = slots;
  int* first = slots + table;
  if (tid == 0) block_sum = 0;
  for (int i = tid; i < table; i += DEDUP_THREADS) {
    key[i] = -1;
    first[i] = 0x7fffffff;
  }
  __syncthreads();
  const unsigned mask = table - 1;
  if (table > 0) {
    for (int c = tid; c < C; c += DEDUP_THREADS) {
      const int r = clamp_row(idb[c], N);
      for (unsigned h = (static_cast<unsigned>(r) * 2654435761u) >> shift;; h = (h + 1) & mask) {
        const int prev = atomicCAS(key + h, -1, r);
        if (prev == -1 || prev == r) {
          atomicMin(first + h, c);
          break;
        }
      }
    }
  }
  __syncthreads();
  int mine = 0;
  const int bin0 = (b / QG) * N;
  for (int c = tid; c < C; c += DEDUP_THREADS) {
    const int r = clamp_row(idb[c], N);
    int f = c;
    if (table > 0) {
      unsigned h = (static_cast<unsigned>(r) * 2654435761u) >> shift;
      while (key[h] != r) h = (h + 1) & mask;
      f = first[h];
    }
    repb[c] = f;
    if (f == c) {
      atomicAdd(count + bin0 + r, 1);
      ++mine;
    }
  }
  atomicAdd(&block_sum, mine);
  __syncthreads();
  if (tid == 0) atomicAdd(totals + b / QG, block_sum);
}

__global__ void __launch_bounds__(THREADS)
offsets_kernel(int* __restrict__ count, int* __restrict__ used,
               const int* __restrict__ totals, int N) {
  __shared__ int warp_sum[THREADS / 32];
  __shared__ int block_base;
  const int qg = blockIdx.y, row = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* cnt = count + (size_t)qg * N;
  const int c = row < N ? cnt[row] : 0;
  int x = c;   // inclusive scan over the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane], v = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += y;
    }
    warp_sum[lane] = v - w;                         // exclusive over the warps
    if (lane == 31) {
      int start = 0;                                // the earlier groups' pairs
      for (int h = 0; h < qg; ++h) start += totals[h];
      block_base = start + atomicAdd(used + qg, v);
    }
  }
  __syncthreads();
  if (row < N) cnt[row] = block_base + warp_sum[warp] + x - c;
}

__global__ void __launch_bounds__(THREADS)
scatter_kernel(const int32_t* __restrict__ ids, const int32_t* __restrict__ rep,
               int* __restrict__ cursor, int32_t* __restrict__ order, int P, int C, int N,
               int QG) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int bin = -1;
  if (p < P) {
    const int b = p / C;
    if (rep[p] == p - b * C) bin = (b / QG) * N + clamp_row(__ldg(ids + p), N);
  }
  const uint32_t same = __match_any_sync(0xffffffffu, bin);
  const int leader = __ffs(same) - 1;
  int base = 0;
  if (bin >= 0 && lane == leader) base = atomicAdd(cursor + bin, __popc(same));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (bin >= 0) order[base + __popc(same & ((1u << lane) - 1u))] = p;
}

// Every repeated pair takes its first copy's dot.
__global__ void __launch_bounds__(THREADS)
expand_kernel(const int32_t* __restrict__ rep, float* __restrict__ out, int P, int C) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  const int c = p % C, f = rep[p];
  if (f != c) out[p] = out[p - c + f];
}

}  // namespace group

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

// The grouping pass of the grouped route. ids [B, C] int32; rep [B, C] int32
// (out: the first column of each row naming the same clamped row); order
// [B * C] int32 (out: its first sum(totals) entries are the flat indices of
// the distinct pairs, grouped by (b / QG, clamped row), query groups in
// order); scratch [groups * N + 2 groups] int32 with groups = ceil(B / QG)
// (zeroed here; its last `groups` entries are out: totals, the distinct pairs
// of each query group). 1 <= QG, B * C < 2^31, groups * N < 2^31. Four
// launches and a memset on `stream`. Returns a cudaError_t.
extern "C" int gvdb_gather_group(int device, const int32_t* ids, int32_t* rep, int32_t* order,
                                 int* scratch, int B, int C, int N, int QG, void* stream) {
  using group::THREADS;
  if (B < 0 || C < 0 || N <= 0 || QG < 1 || (long)B * C > 2147483647L)
    return (int)cudaErrorInvalidValue;
  const long groups = (B + (long)QG - 1) / QG;
  if (groups * N + 2 * groups > 2147483647L) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(scratch, 0, (groups * N + 2 * groups) * sizeof(int), s);
  if (err != cudaSuccess || B == 0 || C == 0) return (int)err;
  int* used = scratch + groups * N;
  int* totals = used + groups;
  int table = 0, shift = 0;
  if (2L * C <= group::MAX_TABLE) {
    table = 1;
    while (table < 2 * C) table <<= 1;
    shift = 32;
    for (int t = table; t > 1; t >>= 1) --shift;
  }
  const size_t table_bytes = 2 * sizeof(int) * (size_t)table;
  group::dedup_count_kernel<<<B, group::DEDUP_THREADS, table_bytes, s>>>(
      ids, rep, scratch, totals, C, N, QG, table, shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 ogrid((N + THREADS - 1) / THREADS, static_cast<unsigned>(groups));
  group::offsets_kernel<<<ogrid, THREADS, 0, s>>>(scratch, used, totals, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int P = B * C;
  group::scatter_kernel<<<(P + THREADS - 1) / THREADS, THREADS, 0, s>>>(ids, rep, scratch, order,
                                                                       P, C, N, QG);
  return (int)cudaGetLastError();
}

// The grouped route (bf16 storage). qb [B, Dp] bf16 (q' zero-padded, Dp a
// multiple of 64 and < D + 64), vectors [N, D] bf16, ids [B, C] int32; rep,
// order and totals (the last ceil(B / QG) entries of scratch) from
// gvdb_gather_group with the same QG; out [B, C] f32; all contiguous on
// `device`; 1 <= QG <= 512, B * C < 2^31. The kernel, then the expand
// kernel. Returns a cudaError_t (0 = launched; nothing is launched when B or
// C is 0).
extern "C" int gvdb_gather_dots_grouped(int device, const void* qb, const void* vectors,
                                        const int32_t* ids, const int32_t* rep,
                                        const int32_t* order, const int* totals, float* out,
                                        int B, int C, int N, int D, int Dp, int QG,
                                        void* stream) {
  using grouped::DS;
  using grouped::MAX_QG;
  using grouped::MIN_BLOCK_PAIRS;
  using grouped::SMEM_BYTES;
  using grouped::grouped_kernel;
  if (B < 0 || C < 0 || N <= 0 || D <= 0 || D > 12288 || Dp % DS != 0 || Dp < D ||
      Dp >= D + DS || QG < 1 || QG > MAX_QG || (long)B * C > 2147483647L)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return (int)cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long P = (long)B * C;
  const int grid = static_cast<int>(
      std::max(1L, std::min((long)sms, (P + MIN_BLOCK_PAIRS - 1) / MIN_BLOCK_PAIRS)));
  const bool vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(vectors) % 16 == 0;
  auto kernel = vec ? grouped_kernel<true> : grouped_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (B + QG - 1) / QG;
  kernel<<<grid, grouped::THREADS, SMEM_BYTES, s>>>(
      static_cast<const uint16_t*>(qb), static_cast<const uint16_t*>(vectors), ids, order, totals,
      out, B, C, N, D, Dp / DS, QG, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group::expand_kernel<<<static_cast<int>((P + group::THREADS - 1) / group::THREADS),
                         group::THREADS, 0, s>>>(rep, out, static_cast<int>(P), C);
  return (int)cudaGetLastError();
}

extern "C" const char* gvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
