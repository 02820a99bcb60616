// Segment top-j kernels for the exact large-corpus flat search in f32 storage
// (Hopper, sm_90a).
//
// One template, six instances, each replacing a Pallas TPU kernel of
// grape_vector_db_tpu/ops/segmax_pallas.py:
//   <4, PLAIN>   B1  _segmax4_kernel (fold _segmax4_core), segmax4_scores_pallas
//   <2, PLAIN>   B2  _segmax2_kernel ("eqfold"),           segmax2_scores_pallas
//   <1, PLAIN>   B9  _segmax_kernel (maxima only),         segmax_scores_pallas
//   <1, CONTIG>  B10 _segmax_kernel_contig,                segmax_scores_pallas_contig
//   <2, SELFOLD> B8  _segmax2_kernel_selfold,              segmax2_scores_pallas(impl="selfold")
//   <4, SUP>     B7  _segmax4_sup_kernel,                  segmax4_sup_scores_pallas
// All six take f32 storage only: in bf16 storage every instance runs the TMA +
// wgmma kernel of csrc/segmax_max.cu, and the C entries here refuse bf16. The
// products are full-f32 FMA (the port keeps TF32 off). It is bound to PyTorch
// through a plain C interface (ctypes) by grape_vector_db_tpu_torch/ops/segmax.py,
// which also holds the plain PyTorch version of every instance's contract.
//
// Contract. For query b and corpus row r:
//   s[b, r] = dot(q[b], v[r]) * w[r]   (f32 accumulation), and s = -inf
//             where w[r] == 0 (select, not add).
// Segments are strided and block-major: segment g = blk * 128 + j holds rows
// blk * 4096 + j + 128 * m for members m < 32 (CONTIG: rows 32 * g + m, so
// chunk m of a block is rows blk * 4096 + 32 * j + m). Per (b, g) the kernel
// emits the TOPJ largest of the 32 scores (a multiset, -inf included) and the
// member index m of ranks 1 .. TOPJ-1, where members are ordered by (score
// descending, m ascending) -- the rule the Pallas "eqfold" recovery gives,
// including ties and all -inf segments (which yield m = 0, 1, 2). SELFOLD
// orders tied members by their 5-bit bit-reversed index instead, the rule of
// the Pallas fold that carries the index through five halvings, each of which
// keeps the lower half on a tie. CONTIG stores its maxima transposed,
// [N/32, B]. SUP also writes s[0 / 1][b][blk], the maxima of the block's 128
// rank-1 / rank-2 values.
//
// What bounds it on an H100. At B = 128 and a 1,048,576 x 768 f32 corpus the
// corpus read is 3.2 GB (about 1 ms at 3.35 TB/s) and the products are
// 2 * 128 * 1M * 768 = 0.2 TFLOP, about 3 ms at the 67 TFLOP/s of f32 FMA
// outside the tensor cores: in full f32 it is bound by operations. The
// [B, N] score plane (512 MB) is the traffic the fusion removes: it never
// leaves the SM, only the 32x smaller top-j planes are written.
//
// Design. One thread block takes 32 queries x one 4096-row corpus block. The
// 32 members of the block's 128 segments are 32 128-row chunks (member m of
// segment j is row 128 * m + j), so the block walks m = 0..31, computes the
// [32 x 128] score tile of chunk m with K-tiles staged in shared memory (FMA
// in full f32, in the layout of an mma accumulator), and folds each score
// into a per-(query, segment) top-j list kept in registers (values, plus the
// member indices packed into one word). A stable insertion places a new
// score below equal ones already listed, so the order in which members
// arrive is the tie rule: ascending m gives (score desc, m asc); SELFOLD
// walks the chunks in bit-reversed order, so the member with the smallest
// bit-reversed index wins a tie. SUP's block maxima are one more epilogue: a
// max over each thread's segments, a shuffle across the 4 lanes that share a
// query, and shared memory across the 4 warps along segments; each (query
// tile, block) pair has one thread block, so no atomics are needed. Blocks
// for the same corpus block are adjacent in the grid (queries on x), so the
// extra query tiles at B > 32 mostly re-read the corpus from L2. A block
// stages each K-tile with plain loads between two barriers, so it also waits
// on memory; bf16 storage, the port's default, moved to the TMA ring,
// wgmma and persistent grid of csrc/segmax_max.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SEG = 32;        // members per segment
constexpr int SPB = 128;       // segments per corpus block
constexpr int CB = SEG * SPB;  // rows per corpus block
constexpr int BQ = 32;         // queries per thread block
constexpr int THREADS = 256;   // 8 warps: 2 along queries x 4 along segments
constexpr int KT = 64;         // K-tile width: 256 bytes of each row
constexpr int LD = KT + 4;     // 16-byte row pad: no bank conflicts
constexpr int VEC = 4;         // elements per 16-byte load
constexpr int VECS_PER_ROW = KT / VEC;

// The [32 x 128] tile product of one K-tile in full f32. Thread (warp, lane)
// owns the mma accumulator positions: query rows qa = wq*16 + g and qa + 8,
// segment columns nb + nt*8 + 2*t4 + {0, 1} for nt < 4.
__device__ __forceinline__ void tile_product(float (*sq)[LD], float (*sv)[LD], int qa, int nb,
                                             int t4, float (&acc)[4][4]) {
#pragma unroll 8
  for (int k = 0; k < KT; ++k) {
    const float xa = sq[qa][k];
    const float xb = sq[qa + 8][k];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = nb + nt * 8 + 2 * t4;
      const float y0 = sv[n][k];
      const float y1 = sv[n + 1][k];
      acc[nt][0] = fmaf(xa, y0, acc[nt][0]);
      acc[nt][1] = fmaf(xa, y1, acc[nt][1]);
      acc[nt][2] = fmaf(xb, y0, acc[nt][2]);
      acc[nt][3] = fmaf(xb, y1, acc[nt][3]);
    }
  }
}

// Member indices of ranks 1 .. TOPJ-1 live packed in one word, IDX_BITS each
// (m < 32): a (query, segment) list then costs TOPJ + 1 registers, not 2 * TOPJ.
constexpr int IDX_BITS = 5;

// Stable insertion of member m's score s into a descending top-TOPJ list.
// `step` counts the members that arrived before this one, so slots
// t >= step are still empty, and a score goes below every equal score
// already listed (those arrived earlier). The ascending walk passes
// step == m; the bit-reversed walk passes its step and the member it reads.
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

// The walk and the outputs of one instance (see the header).
enum Variant { PLAIN = 0, CONTIG = 1, SELFOLD = 2, SUP = 3 };

template <int TOPJ, int VAR>
__global__ void __launch_bounds__(THREADS, 1)
segmax_kernel(const float* __restrict__ q, const float* __restrict__ v,
              const float* __restrict__ w, float* __restrict__ out_m,
              int32_t* __restrict__ out_i, float* __restrict__ out_s, int B, int N, int D) {
  __shared__ __align__(16) float sq[BQ][LD];
  __shared__ __align__(16) float sv[SPB][LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qa = (warp >> 2) * 16 + g;  // this thread's query rows: qa, qa + 8
  const int nb = (warp & 3) * 32;       // this warp's first segment column
  const int q0 = blockIdx.x * BQ;
  const int blk = blockIdx.y;
  const size_t nseg = (size_t)N / SEG;

  float val[16][TOPJ];
  uint32_t idx[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    idx[p] = 0;
#pragma unroll
    for (int t = 0; t < TOPJ; ++t) val[p][t] = -INFINITY;
  }

  for (int step = 0; step < SEG; ++step) {
    // SELFOLD reads the member chunks in 5-bit bit-reversed order
    const int m = VAR == SELFOLD ? (int)(__brev((unsigned)step) >> 27) : step;
    // row of segment column r in chunk m: strided blk*CB + 128*m + r, or
    // contiguous blk*CB + 32*r + m
    const size_t row0 = (size_t)blk * CB + (size_t)m * (VAR == CONTIG ? 1 : SPB);
    constexpr int RSTRIDE = VAR == CONTIG ? SEG : 1;
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
    }
    for (int k0 = 0; k0 < D; k0 += KT) {
      __syncthreads();  // the previous K-tile has been consumed
      for (int i = tid; i < BQ * VECS_PER_ROW; i += THREADS) {
        const int r = i / VECS_PER_ROW, cv = (i % VECS_PER_ROW) * VEC;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (q0 + r < B) x = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * D + k0 + cv);
        *reinterpret_cast<uint4*>(&sq[r][cv]) = x;
      }
      for (int i = tid; i < SPB * VECS_PER_ROW; i += THREADS) {
        const int r = i / VECS_PER_ROW, cv = (i % VECS_PER_ROW) * VEC;
        *reinterpret_cast<uint4*>(&sv[r][cv]) =
            *reinterpret_cast<const uint4*>(v + (row0 + (size_t)r * RSTRIDE) * D + k0 + cv);
      }
      __syncthreads();
      tile_product(sq, sv, qa, nb, t4, acc);
    }
    // epilogue: weight, mask and fold member m into each pair's list
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = nb + nt * 8 + 2 * t4 + (c & 1);
        const float wr = __ldg(&w[row0 + (size_t)j * RSTRIDE]);
        const float s = (wr == 0.f) ? -INFINITY : acc[nt][c] * wr;
        insert<TOPJ>(val[nt * 4 + c], idx[nt * 4 + c], s, step, m);
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int b = q0 + qa + ((c >> 1) << 3);
      if (b >= B) continue;
      const size_t seg = (size_t)blk * SPB + nb + nt * 8 + 2 * t4 + (c & 1);
      const int p = nt * 4 + c;
      if constexpr (VAR == CONTIG) {
        out_m[seg * B + b] = val[p][0];  // transposed [N/32, B]
      } else {
#pragma unroll
        for (int t = 0; t < TOPJ; ++t) out_m[((size_t)t * B + b) * nseg + seg] = val[p][t];
#pragma unroll
        for (int t = 0; t < TOPJ - 1; ++t)
          out_i[((size_t)t * B + b) * nseg + seg] =
              (idx[p] >> (IDX_BITS * t)) & ((1u << IDX_BITS) - 1u);
      }
    }
  }

  if constexpr (VAR == SUP) {
    // block maxima of the rank-1 and rank-2 values: this thread's 8
    // segments of query rows qa (h = 0) and qa + 8 (h = 1), then the 4
    // lanes that share those rows, then the 4 warps along segments
    __shared__ float ssup[4][BQ][2];
    float r[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float x = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          x = fmaxf(x, val[nt * 4 + 2 * h][t]);
          x = fmaxf(x, val[nt * 4 + 2 * h + 1][t]);
        }
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        r[h][t] = x;
      }
    }
    if (t4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ssup[warp & 3][qa + 8 * h][0] = r[h][0];
        ssup[warp & 3][qa + 8 * h][1] = r[h][1];
      }
    }
    __syncthreads();
    if (tid < 2 * BQ) {
      const int qrow = tid >> 1, t = tid & 1;
      const float x = fmaxf(fmaxf(ssup[0][qrow][t], ssup[1][qrow][t]),
                            fmaxf(ssup[2][qrow][t], ssup[3][qrow][t]));
      const int b = q0 + qrow;
      if (b < B) out_s[((size_t)t * B + b) * (N / CB) + blk] = x;
    }
  }
}

template <int TOPJ, int VAR>
cudaError_t launch(const void* q, const void* v, const float* w, float* out_m, int32_t* out_i,
                   float* out_s, int B, int N, int D, cudaStream_t stream) {
  const dim3 grid((B + BQ - 1) / BQ, N / CB);
  segmax_kernel<TOPJ, VAR><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(v), w, out_m, out_i, out_s, B, N,
      D);
  return cudaGetLastError();
}

bool shape_ok(int B, int N, int D) {
  return B > 0 && N > 0 && N % CB == 0 && N / CB <= 65535 && D > 0 && D % 128 == 0;
}

}  // namespace

// topj: 4 or 2; f32 storage only (dtype 1): in bf16 storage (dtype 0) every
// instance runs gvdb_segmax_max (csrc/segmax_max.cu), so dtype 0 is refused
// with cudaErrorInvalidValue. q [B, D] and v [N, D] f32, w [N] f32, out_m
// [topj, B, N/32] f32, out_i [topj-1, B, N/32] int32, all contiguous, 16-byte
// aligned, on `device`. Returns a cudaError_t (0 = launched).
extern "C" int gvdb_segmax(int topj, int dtype, int device, const void* q, const void* v,
                           const float* w, float* out_m, int32_t* out_i, int B, int N, int D,
                           void* stream) {
  if (!shape_ok(B, N, D) || dtype != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (topj == 4) return (int)launch<4, PLAIN>(q, v, w, out_m, out_i, nullptr, B, N, D, s);
  if (topj == 2) return (int)launch<2, PLAIN>(q, v, w, out_m, out_i, nullptr, B, N, D, s);
  return (int)cudaErrorInvalidValue;
}

// The instances of B7-B10. variant: 0 = B9 (maxima, out_m [B, N/32]), 1 = B10
// (contiguous maxima, out_m [N/32, B]), 2 = B8 (selfold: out_m [2, B, N/32],
// out_i [1, B, N/32]), 3 = B7 (B1's planes plus out_s [2, B, N/4096]). Unused
// outputs may be null. f32 storage only (dtype 1), layouts and the return
// value as gvdb_segmax.
extern "C" int gvdb_segmax_variant(int variant, int dtype, int device, const void* q,
                                   const void* v, const float* w, float* out_m, int32_t* out_i,
                                   float* out_s, int B, int N, int D, void* stream) {
  if (!shape_ok(B, N, D) || dtype != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return (int)launch<1, PLAIN>(q, v, w, out_m, nullptr, nullptr, B, N, D, s);
    case 1: return (int)launch<1, CONTIG>(q, v, w, out_m, nullptr, nullptr, B, N, D, s);
    case 2: return (int)launch<2, SELFOLD>(q, v, w, out_m, out_i, nullptr, B, N, D, s);
    case 3: return (int)launch<4, SUP>(q, v, w, out_m, out_i, out_s, B, N, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
