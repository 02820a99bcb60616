// Segment top-j on the tensor cores (Hopper, sm_90a): the bf16-storage
// instances of B1, B2, B7, B8, B9 and B10.
//
// Replaces the Pallas TPU kernels of grape_vector_db_tpu/ops/segmax_pallas.py:
//   <4, PLAIN>   B1  _segmax4_kernel (:354, call :482),         segmax4_scores_pallas
//   <2, PLAIN>   B2  _segmax2_kernel (:124, call :217),         segmax2_scores_pallas
//   <1, PLAIN>   B9  _segmax_kernel (:53, call :109),           segmax_scores_pallas
//   <1, CONTIG>  B10 _segmax_kernel_contig (:728, call :784),   segmax_scores_pallas_contig
//   <2, SELFOLD> B8  _segmax2_kernel_selfold (:237, call :217), segmax2_scores_pallas(impl="selfold")
//   <4, SUP>     B7  _segmax4_sup_kernel (:401, call :542),     segmax4_sup_scores_pallas
// It is bound to PyTorch through a plain C interface (ctypes) by
// grape_vector_db_tpu_torch/ops/segmax.py (segmax4_scores, segmax2_scores,
// segmax_scores, segmax_scores_contig, segmax4_sup_scores), which also holds
// the plain PyTorch versions. f32 storage stays on the template of
// csrc/segmax.cu (full-f32 FMA: the port keeps TF32 off).
//
// Contract (as csrc/segmax.cu states it). For query b and corpus row r:
//   s[b, r] = dot(q[b], v[r]) * w[r]   (bf16 operands, f32 accumulation), and
//   s = -inf where w[r] == 0 (select, not add).
//   strided: segment g = blk * 128 + j holds rows blk * 4096 + j + 128 m
//            (m < 32). Per (b, g) the kernel writes the TOPJ largest of the
//            32 scores (a multiset, -inf included) to out_m [TOPJ, B, N/32]
//            and the member index m of ranks 1 .. TOPJ-1 to out_i
//            [TOPJ-1, B, N/32], members ordered by (score descending, m
//            ascending), all -inf segments included (m = 0, 1, 2). SELFOLD
//            orders tied members by their 5-bit bit-reversed index instead.
//            SUP also writes out_s [2, B, N/4096]: the maxima of the rank-1
//            and rank-2 values over each block's 128 segments.
//   contig:  segment g holds rows 32 g .. 32 g + 31; TOPJ = 1 only, and out_m
//            is the maxima, [N/32, B].
//
// What bounds it on an H100. At B = 128 and a 1,048,576 x 768 bf16 corpus the
// corpus read is 1.61 GB; with w (4 MB), q and the planes written (16.8 MB for
// TOPJ = 1, 50.3 MB for 2, 117.4 MB for 4, 117.7 MB for SUP) that is 0.487 /
// 0.497 / 0.517 ms at 3.35 TB/s. The products are 0.206 TFLOP, 0.21 ms at 989
// TFLOP/s: the kernel is bound by bytes. The [B, N] score plane (512 MB) never
// leaves the SM.
//
// Design.
// - A tile is 128 queries x 256 corpus rows that hold 8 whole segments, so no
//   segment's state crosses tiles. Strided: TMA sees v as the 4-D tensor
//   (D, j:128, m:32, blk:N/4096) and loads the box (64, 8, 32, 1): shared row
//   8 m + jl is member m of segment j0 + jl. Contig: the plain 2-D box
//   (64, 256) of rows 256 c ..; shared row 32 s + mm is member mm of segment s.
// - Two consumer warpgroups (64 queries each) issue wgmma m64n256k16 (bf16,
//   f32 accumulate, both operands K-major from 128-byte-swizzled shared
//   memory): 128 accumulators a thread. In the accumulator layout, column
//   group i of a thread is shared rows 8 i .. 8 i + 7, and its two columns are
//   rows 8 i + 2 t4 + {0, 1}. Strided: group i is member i and the two columns
//   are two segments, so a thread holds all 32 members of its two segments,
//   for two query rows, and its top-j needs no shuffle. Contig: groups
//   4 s .. 4 s + 3 are segment s, so a thread takes the maximum of its 8
//   values of each segment and two __shfl_xor_sync over t4 finish it.
// - One producer thread issues TMA loads into a 4-stage ring (each stage: q
//   [128 x 64] 16 KB, v [256 x 64] 32 KB) and the tile's w (1 KB, two slots),
//   completed on mbarriers with expect-tx; the consumers release a stage once
//   its wgmma group has completed. setmaxnreg gives the producer warpgroup 40
//   registers and the consumers 232.
// - The grid is persistent (one block an SM) and walks the tiles round-robin;
//   the producer runs ahead into the next tile while the consumers run the
//   epilogue. The query tiles of one corpus tile are adjacent in the walk, so
//   at B > 128 the corpus comes from HBM once and from L2 after that. q rows
//   past B are zero-filled by TMA's bounds, and their stores are skipped.
// - Epilogue: multiply by w, select -inf where w == 0. Strided: each of a
//   thread's four (query row, segment) pairs walks its 32 members and folds
//   each score into a register list of TOPJ values and one packed word of
//   member indices (insert below: TOPJ = 1 is the maximum). The stable
//   insertion makes the walk's order the tie rule: members ascending, or for
//   SELFOLD in 5-bit bit-reversed order (step i reads member brev5(i), a
//   constant in the unrolled walk, so d keeps compile-time indices). Each
//   plane stores 8 contiguous values a query row (one float2 or int2 a
//   thread, a quad of lanes filling one 32-byte sector). Contig stores 8 rows
//   of [N/32, B], each warp store filling whole 32-byte sectors. The top-4
//   epilogue is ~128 insertions a thread a tile, a few microseconds that the
//   ring's 4 stages (192 KB in flight) cover.
// - SUP's block maxima: a block's 16 tiles land on different SMs, so each
//   tile folds its share into out_s. Two __shfl_xor_sync over t4 give the max
//   of the rank-1 / rank-2 values over the tile's 8 segments for each query
//   row, and one lane a (row, rank) issues an atomic max on the float's bits
//   (atomicMax on the int bits when the sign bit is clear, atomicMin on the
//   unsigned bits when it is set): exact and independent of order, so s1 and
//   s2 equal the plain amax bit for bit. 256 atomics a tile, 16 on each
//   address. A small fill kernel writes -inf to out_s first, on the same
//   stream, from the same C entry.
// The tensor maps are encoded on the host for each call through the driver's
// cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint (the library
// links no libcuda), and passed as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SEG = 32;              // members per segment
constexpr int SPB = 128;             // segments per 4096-row block (strided)
constexpr int CB = SEG * SPB;        // rows per block
constexpr int BM = 128;              // queries per tile: two warpgroups of 64
constexpr int BN = 256;              // corpus rows per tile: 8 whole segments
constexpr int SEGS = BN / SEG;       // segments per tile
constexpr int TPB = CB / BN;         // strided tiles per block (16)
constexpr int BK = 64;               // K-step: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int W_SLOTS = 2;
constexpr int CONSUMERS = 256;       // warpgroups 0 and 1
constexpr int THREADS = CONSUMERS + 128;  // warpgroup 2: the producer
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr uint32_t Q_BYTES = BM * BK * 2;   // 16 KB
constexpr uint32_t V_BYTES = BN * BK * 2;   // 32 KB
constexpr uint32_t W_BYTES = BN * 4;        // 1 KB
constexpr int BAR_BYTES = 128;              // 2 * (STAGES + W_SLOTS) mbarriers
// dynamic shared memory, with 1024 bytes to align the swizzled tiles
constexpr int SMEM_BYTES =
    STAGES * (Q_BYTES + V_BYTES) + W_SLOTS * W_BYTES + BAR_BYTES + 1024;

// -- PTX wrappers --------------------------------------------------------------

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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte rows, 128-byte swizzle
// (the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): start address,
// leading offset 1 (unused), stride 1024 bytes between 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define D8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A[64 x 16] . B[256 x 16]^T, both from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64), D8(72), D8(80),
        D8(88), D8(96), D8(104), D8(112), D8(120)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef D8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads of the accumulators above a wait.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Member indices of ranks 1 .. TOPJ-1 live packed in one word, IDX_BITS each
// (m < 32): a (query, segment) list then costs TOPJ + 1 registers, not 2 * TOPJ.
constexpr int IDX_BITS = 5;

// Stable insertion of member m's score s into a descending top-TOPJ list.
// `step` counts the members that arrived before this one, so slots
// t >= step are still empty, and a score goes below every equal score
// already listed (those arrived earlier). The ascending walk passes
// step == m; the bit-reversed walk passes its step and the member it reads.
// (The twin of insert in csrc/segmax.cu, copied because ops/_build.py
// rebuilds a library when its own .cu source changes, not a shared header.)
template <int TOPJ>
__device__ __forceinline__ void insert(float (&val)[TOPJ], uint32_t& idx, float s, int step,
                                       int m) {
  // pos: the slots that keep their place (filled, and s does not beat them).
  // pos == TOPJ drops s; every update below is then a no-op, so the
  // insertion needs no branch.
  int pos = 0;
#pragma unroll
  for (int t = 0; t < TOPJ; ++t) pos += (step > t && !(s > val[t])) ? 1 : 0;
#pragma unroll
  for (int t = TOPJ - 1; t >= 1; --t) {
    if (t > pos) val[t] = val[t - 1];
    if (t == pos) val[t] = s;
  }
  if (pos == 0) val[0] = s;
  constexpr uint32_t kMask = (1u << (IDX_BITS * (TOPJ - 1))) - 1u;
  const int sh = IDX_BITS * pos;
  const uint32_t keep = idx & ((1u << sh) - 1u);
  const uint32_t moved = (idx << IDX_BITS) & ~((1u << (sh + IDX_BITS)) - 1u);
  idx = (keep | (static_cast<uint32_t>(m) << sh) | moved) & kMask;
}

// 5-bit bit reversal: SELFOLD's step i reads member brev5(i).
__host__ __device__ constexpr int brev5(int x) {
  return ((x & 1) << 4) | ((x & 2) << 2) | (x & 4) | ((x & 8) >> 2) | ((x & 16) >> 4);
}

// Exact float max into global memory: for a clear sign bit the float's order
// is its int bits' order, for a set one the reverse of its unsigned bits'.
__device__ __forceinline__ void atomic_max_float(float* addr, float x) {
  if (__float_as_int(x) >= 0)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(x));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(x));
}

// The walk and the outputs of one instance (csrc/segmax.cu's enum).
enum Variant { PLAIN = 0, CONTIG = 1, SELFOLD = 2, SUP = 3 };

// -- the kernels -----------------------------------------------------------------

__global__ void fill_kernel(float* __restrict__ p, int n, float x) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    p[i] = x;
}

// Walk order: tile t is (corpus tile t / nqt, query tile t % nqt).
template <int TOPJ, int VAR>
__global__ void __launch_bounds__(THREADS, 1)
segmax_max_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap wmap, float* __restrict__ out,
                  int32_t* __restrict__ out_i, float* __restrict__ out_s, int B, int N,
                  int ksteps) {
  static_assert((VAR == PLAIN && (TOPJ == 1 || TOPJ == 2 || TOPJ == 4)) ||
                    (VAR == CONTIG && TOPJ == 1) || (VAR == SELFOLD && TOPJ == 2) ||
                    (VAR == SUP && TOPJ == 4),
                "no such instance");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t sq = base;                                   // STAGES x Q_BYTES
  const uint32_t sv = sq + STAGES * Q_BYTES;                  // STAGES x V_BYTES
  const uint32_t sw = sv + STAGES * V_BYTES;                  // W_SLOTS x W_BYTES
  const float* const wbuf = reinterpret_cast<const float*>(smem + (sw - base));
  const uint32_t bars = sw + W_SLOTS * W_BYTES;
  const uint32_t full = bars, empty = bars + 8 * STAGES;      // 8-byte mbarriers
  const uint32_t wfull = bars + 16 * STAGES, wempty = wfull + 8 * W_SLOTS;

  const int nqt = (B + BM - 1) / BM;
  const int ntiles = (N / BN) * nqt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    for (int s = 0; s < W_SLOTS; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // -- producer warpgroup: one thread keeps the ring full ----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == CONSUMERS) {
      int stage = 0, ws = 0;
      uint32_t phase = 0, wphase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int c = t / nqt, q0 = (t % nqt) * BM;
        mbar_wait(wempty + 8 * ws, wphase ^ 1);
        mbar_expect_tx(wfull + 8 * ws, W_BYTES);
        if (VAR == CONTIG)
          tma_load_2d(sw + ws * W_BYTES, &wmap, wfull + 8 * ws, 0, c);
        else
          tma_load_3d(sw + ws * W_BYTES, &wmap, wfull + 8 * ws, (c % TPB) * SEGS, 0, c / TPB);
        if (++ws == W_SLOTS) { ws = 0; wphase ^= 1; }
        for (int kb = 0; kb < ksteps; ++kb) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(full + 8 * stage, Q_BYTES + V_BYTES);
          tma_load_2d(sq + stage * Q_BYTES, &qmap, full + 8 * stage, kb * BK, q0);
          if (VAR == CONTIG)
            tma_load_2d(sv + stage * V_BYTES, &vmap, full + 8 * stage, kb * BK, c * BN);
          else
            tma_load_4d(sv + stage * V_BYTES, &vmap, full + 8 * stage, kb * BK,
                        (c % TPB) * SEGS, 0, c / TPB);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // -- consumer warpgroups: wgmma over the ring, then the epilogue ------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    int stage = 0, ws = 0;
    uint32_t phase = 0, wphase = 0;
    float d[128];
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int c = t / nqt, q0 = (t % nqt) * BM;
      int prev = -1;
      for (int kb = 0; kb < ksteps; ++kb) {
        mbar_wait(full + 8 * stage, phase);
        const uint64_t da = sw128_desc(sq + stage * Q_BYTES + wg * (Q_BYTES / 2));
        const uint64_t db = sw128_desc(sv + stage * V_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)    // 16 elements = 32 bytes = 2 units
          wgmma_m64n256k16(d, da + 2 * kk, db + 2 * kk, kb > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();            // the previous step's group has completed
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = stage;
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_acc(d);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * prev);

      mbar_wait(wfull + 8 * ws, wphase);
      const float* wt = wbuf + ws * BN;
      const int b0 = q0 + wg * 64 + warp * 16 + g;   // rows b0 and b0 + 8
      if (VAR != CONTIG) {
        // pairs e: query row b0 + 8 (e >> 1), segment 2 t4 + (e & 1)
        float val[4][TOPJ];
        uint32_t idx[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int t = 0; t < TOPJ; ++t) val[e][t] = -INFINITY;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {              // step i reads member m
          const int m = VAR == SELFOLD ? brev5(i) : i;
          const float2 wv = *reinterpret_cast<const float2*>(wt + 8 * m + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float wr = (e & 1) ? wv.y : wv.x;
            const float s = wr == 0.f ? -INFINITY : d[4 * m + e] * wr;
            if constexpr (TOPJ == 1)
              val[e][0] = fmaxf(val[e][0], s);
            else
              insert<TOPJ>(val[e], idx[e], s, i, m);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(wempty + 8 * ws);
        const size_t nseg = static_cast<size_t>(N) / SEG;
        const size_t plane = static_cast<size_t>(B) * nseg;
        const size_t seg = static_cast<size_t>(c / TPB) * SPB + (c % TPB) * SEGS + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {               // query rows b0, b0 + 8
          const int b = b0 + 8 * h;
          if (b >= B) continue;
          const size_t at = b * nseg + seg;
#pragma unroll
          for (int t = 0; t < TOPJ; ++t)
            *reinterpret_cast<float2*>(out + t * plane + at) =
                make_float2(val[2 * h][t], val[2 * h + 1][t]);
#pragma unroll
          for (int t = 0; t < TOPJ - 1; ++t)
            *reinterpret_cast<int2*>(out_i + t * plane + at) =
                make_int2(static_cast<int>((idx[2 * h] >> (IDX_BITS * t)) & 31u),
                          static_cast<int>((idx[2 * h + 1] >> (IDX_BITS * t)) & 31u));
        }
        if constexpr (VAR == SUP) {
          // the tile's share of s1 / s2 (rank r = 0 / 1) of query rows b0 + 8 h:
          // this thread's two segments, then the 4 lanes of t4 (the tile's 8
          // segments); lane t4 == 2 h + r folds it into block c / TPB
          const size_t nblk = static_cast<size_t>(N) / CB;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float x = fmaxf(val[2 * h][r], val[2 * h + 1][r]);
              x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
              x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
              const int b = b0 + 8 * h;
              if (t4 == 2 * h + r && b < B)
                atomic_max_float(out_s + (static_cast<size_t>(r) * B + b) * nblk + c / TPB, x);
            }
          }
        }
      } else {
        float mx[SEGS][2];
#pragma unroll
        for (int s = 0; s < SEGS; ++s) mx[s][0] = mx[s][1] = -INFINITY;
#pragma unroll
        for (int i = 0; i < 32; ++i) {              // rows 8 i .. 8 i + 7: segment i / 4
          const float2 wv = *reinterpret_cast<const float2*>(wt + 8 * i + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float wr = (e & 1) ? wv.y : wv.x;
            mx[i >> 2][e >> 1] =
                fmaxf(mx[i >> 2][e >> 1], wr == 0.f ? -INFINITY : d[4 * i + e] * wr);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(wempty + 8 * ws);
#pragma unroll
        for (int s = 0; s < SEGS; ++s) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x = mx[s][h];
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
            mx[s][h] = x;
          }
        }
        // lane t4 stores segments 2 t4 and 2 t4 + 1
#pragma unroll
        for (int s = 0; s < SEGS; ++s) {
          if ((s >> 1) != t4) continue;
          float* row = out + (static_cast<size_t>(c) * SEGS + s) * B;
          if (b0 < B) row[b0] = mx[s][0];
          if (b0 + 8 < B) row[b0 + 8] = mx[s][1];
        }
      }
      if (++ws == W_SLOTS) { ws = 0; wphase ^= 1; }
    }
  }
}

// -- host side -------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Error codes of this library beside cudaError_t's (see gvdb_cuda_error_string).
constexpr int ERR_NO_ENCODER = -1;       // the driver has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE_BASE = -1000;   // -1000 - CUresult: a map was refused

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

// One tiled map; dims and box innermost first, strides in bytes (rank - 1 of them).
int encode(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type, int rank,
           const void* ptr, const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE_BASE - static_cast<int>(r);
}

template <int TOPJ, int VAR>
int launch(const void* q, const void* v, const float* w, float* out_m, int32_t* out_i,
           float* out_s, int B, int N, int D, int device, cudaStream_t stream) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t d = static_cast<cuuint64_t>(D), row = d * 2;
  CUtensorMap qmap, vmap, wmap;
  {
    const cuuint64_t dims[2] = {d, static_cast<cuuint64_t>(B)}, strides[1] = {row};
    const cuuint32_t box[2] = {BK, BM};
    const int rc = encode(fn, &qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, dims, strides,
                          box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc) return rc;
  }
  if (VAR == CONTIG) {
    const cuuint64_t dims[2] = {d, static_cast<cuuint64_t>(N)}, strides[1] = {row};
    const cuuint32_t box[2] = {BK, BN};
    int rc = encode(fn, &vmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc) return rc;
    const cuuint64_t wdims[2] = {BN, static_cast<cuuint64_t>(N / BN)}, wstrides[1] = {BN * 4};
    const cuuint32_t wbox[2] = {BN, 1};
    rc = encode(fn, &wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, w, wdims, wstrides, wbox,
                CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc) return rc;
  } else {
    // v as (D, j, m, blk): row blk * 4096 + j + 128 m
    const cuuint64_t dims[4] = {d, SPB, SEG, static_cast<cuuint64_t>(N / CB)};
    const cuuint64_t strides[3] = {row, row * SPB, row * CB};
    const cuuint32_t box[4] = {BK, SEGS, SEG, 1};
    int rc = encode(fn, &vmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, v, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc) return rc;
    const cuuint64_t wdims[3] = {SPB, SEG, static_cast<cuuint64_t>(N / CB)};
    const cuuint64_t wstrides[2] = {SPB * 4, CB * 4};
    const cuuint32_t wbox[3] = {SEGS, SEG, 1};
    rc = encode(fn, &wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, w, wdims, wstrides, wbox,
                CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc) return rc;
  }
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(segmax_max_kernel<TOPJ, VAR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (VAR == SUP) {          // the block maxima start at -inf
    const int n = 2 * B * (N / CB);
    fill_kernel<<<(n + 255) / 256 < sms ? (n + 255) / 256 : sms, 256, 0, stream>>>(
        out_s, n, -INFINITY);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int ntiles = (N / BN) * ((B + BM - 1) / BM);
  const int grid = ntiles < sms ? ntiles : sms;
  segmax_max_kernel<TOPJ, VAR><<<grid, THREADS, SMEM_BYTES, stream>>>(
      qmap, vmap, wmap, out_m, out_i, out_s, B, N, D / BK);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The six instances, by variant (csrc/segmax.cu's enum) and top-j: PLAIN 4 =
// B1, PLAIN 2 = B2, PLAIN 1 = B9, SELFOLD 2 = B8, SUP 4 = B7 (strided
// segments; out_m [topj, B, N/32], out_i [topj-1, B, N/32], null for topj 1;
// SUP also out_s [2, B, N/4096]); CONTIG 1 = B10 (contiguous segments, out_m
// [N/32, B]). q [B, D] and v [N, D] bf16, w [N] f32, outputs f32 / int32, all
// contiguous, 16-byte aligned, on `device`; N % 4096 == 0, D % 64 == 0. A
// combination with no instance, or a missing output, is refused with
// cudaErrorInvalidValue. Returns 0 once launched, a cudaError_t, or one of
// this library's negative codes (gvdb_cuda_error_string names each).
extern "C" int gvdb_segmax_max(int variant, int topj, int device, const void* q, const void* v,
                               const float* w, float* out_m, int32_t* out_i, float* out_s,
                               int B, int N, int D, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || N <= 0 || N % CB || D <= 0 || D % BK) return invalid;
  if (variant < PLAIN || variant > SUP || topj < 1 || topj > 4) return invalid;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(w)) % 16)
    return invalid;
  if (out_m == nullptr || (topj > 1 && out_i == nullptr) || (variant == SUP && out_s == nullptr))
    return invalid;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant * 8 + topj) {
    case PLAIN * 8 + 1:
      return launch<1, PLAIN>(q, v, w, out_m, nullptr, nullptr, B, N, D, device, s);
    case PLAIN * 8 + 2:
      return launch<2, PLAIN>(q, v, w, out_m, out_i, nullptr, B, N, D, device, s);
    case PLAIN * 8 + 4:
      return launch<4, PLAIN>(q, v, w, out_m, out_i, nullptr, B, N, D, device, s);
    case CONTIG * 8 + 1:
      return launch<1, CONTIG>(q, v, w, out_m, nullptr, nullptr, B, N, D, device, s);
    case SELFOLD * 8 + 2:
      return launch<2, SELFOLD>(q, v, w, out_m, out_i, nullptr, B, N, D, device, s);
    case SUP * 8 + 4:
      return launch<4, SUP>(q, v, w, out_m, out_i, out_s, B, N, D, device, s);
    default:
      return invalid;
  }
}

// Dynamic shared memory a block of the kernel takes, in bytes.
extern "C" int gvdb_segmax_max_smem_bytes() { return SMEM_BYTES; }

extern "C" const char* gvdb_cuda_error_string(int code) {
  if (code == ERR_NO_ENCODER)
    return "the CUDA driver has no cuTensorMapEncodeTiled (cudaGetDriverEntryPoint)";
  if (code <= ERR_ENCODE_BASE) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
