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
// B, C and W are any positive sizes: rows past C, queries past B and words
// past W are guarded (the TPU kernel needed C % 512 == 0). Validity is the
// caller's.
//
// What bounds it on an H100. At the binary index's scan chunk (B = 128,
// W = 24, D = 768, C = 262,144 rows) the kernel reads 25 MB of codes and
// writes the 134 MB [B, C] int32 plane: 0.048 ms at 3.35 TB/s. The same
// distances are a +-1 product (dot = 32 W - 2 hamming), 1.6e11 int8
// operations, 0.026 ms on the int8 tensor cores; so memory bounds it, and
// the output write is 84% of its bytes. Counting with __popc (16 a clock an
// SM) would take 0.19 ms, four times the bound.
//
// Design: the b1 tensor cores (on an H100 a b1 mma.sync issues at the rate
// of an s8 m16n8k32 one, so 8x its bit pairs: tools/mma_rates.py, PERF.md).
// mma.sync m16n8k256 .and.popc takes the packed words as they are as its
// fragments (a k-step is 8 words; lane t of a quad holds words t and t + 4
// of its row) and sums popc(q & c) over 256 bit pairs; then
//   popc(q ^ c) = popc(q) + popc(c) - 2 popc(q & c),
// exact in int32, with popc(q) taken once per query block and popc(c) summed
// from the B fragments each warp loads anyway (a quad reduction and two
// shuffles per 8 rows). Words past W are zero on both sides and add nothing.
// A persistent grid of two 256-thread blocks an SM walks tiles of 128 queries
// x 128 rows (queries outer, so a block stages its query block once). The
// query block and the tile's codes sit in shared memory in chunks of up to
// 64 words a row (row stride = 4 mod 8 words: a quad's 8 rows x 4 words hit
// 32 banks); cp.async copies the next two tiles' codes into a ring of three
// buffers while the current tile is computed. Each warp owns 64 queries x 32
// rows (16 accumulators of 4 registers). The output write is the bound: a
// quad swaps halves with its neighbour lane so every lane stores 16
// contiguous bytes (4 rows of one query), and the stores of one tile drain
// while the next tile's products run. What is left above the bound is the
// per-tile instruction stream (epilogue, copy issue, fragment loads and
// barriers), which overlaps the stores only in part (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int QB = 128;                     // queries a tile
constexpr int TC = 128;                     // corpus rows a tile
constexpr int WM = 64;                      // queries a warp
constexpr int WN = 32;                      // rows a warp
constexpr int MT = WM / 16;                 // m16 tiles a warp
constexpr int NT = WN / 8;                  // n8 tiles a warp
constexpr int KC = 64;                      // words a staged chunk
constexpr int NBUF = 3;                     // codes buffers: items in flight + 1
constexpr int BLOCKS_PER_SM = 2;
static_assert((QB / WM) * (TC / WN) == THREADS / 32, "warps cover the tile");

// Row stride in words of a staged chunk of W-word rows: the chunk's words
// rounded up to whole k-steps (8 words), plus 4, so that S = 4 mod 8 and a
// quad's 8 rows x 4 words hit 32 banks.
__host__ __device__ constexpr int stride_of(int W) { return ((W < KC ? W : KC) + 7) / 8 * 8 + 4; }

// D[16 x 8] += popc(A[16 x 256] & B[256 x 8]), b1 in, s32 accumulate.
__device__ __forceinline__ void mma_and_popc(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Asynchronous copies of `bytes` (4 or 16) into shared memory; `valid` false
// reads nothing and writes zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0) : "memory");
}

// A block's work is a stream of items, (tile, chunk) for each of its tiles
// (tile = blockIdx.x + j * gridDim.x, queries outer) and each KC-word chunk
// of W. The codes of the next NBUF - 1 items are copied into a ring of
// shared-memory buffers while the current one is computed, so no k-step
// waits on device memory.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
hamming_mma_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ codes,
                   int32_t* __restrict__ out, int B, int C, int W, int n_cb, int tiles,
                   bool vec_in) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int pq[QB];                           // popc of each query of the block

  const int S = stride_of(W);
  uint32_t* qs = smem;                             // query chunk [QB][S]
  uint32_t* cs = smem + QB * S;                    // codes chunks [NBUF][TC][S]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;           // mma row group, thread in group
  const int wm = (warp / (TC / WN)) * WM;          // the warp's first query in the tile
  const int wn = (warp % (TC / WN)) * WN;          // its first row in the tile
  const int n_chunks = (W + KC - 1) / KC;
  const bool vec_out = (C & 3) == 0;

  // the codes of chunk `chunk` of tile `tile` (if tile < tiles) into buffer buf_id
  auto issue = [&](int tile, int chunk, int buf_id) {
    if (tile < tiles) {
      const int c0 = (tile % n_cb) * TC;
      const int kb = chunk * KC;
      const int kw = min(KC, W - kb), k8 = (kw + 7) & ~7;
      uint32_t* buf = cs + buf_id * TC * S;
      if (vec_in) {                                // 16-byte pieces; kw % 4 == 0
        const int per_row = k8 / 4;
        for (int i = tid; i < TC * per_row; i += THREADS) {
          const int r = i / per_row, e = (i - r * per_row) * 4;
          const bool ok = c0 + r < C && e < kw;
          cp_async<16>(buf + r * S + e, ok ? codes + (size_t)(c0 + r) * W + kb + e : codes, ok);
        }
      } else {
        for (int i = tid; i < TC * k8; i += THREADS) {
          const int r = i / k8, e = i - r * k8;
          const bool ok = c0 + r < C && e < kw;
          cp_async<4>(buf + r * S + e, ok ? codes + (size_t)(c0 + r) * W + kb + e : codes, ok);
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  int acc[MT][NT][4];
  int pc[NT];                                      // popc of row wn + 8 n + g, a quarter a lane
  int staged_qb = -1, buf_id = 0;
  int next_tile = blockIdx.x, next_chunk = 0, issue_buf = 0;   // the next item to issue
  for (int i = 0; i < NBUF - 1; ++i) {             // the first NBUF - 1 items
    issue(next_tile, next_chunk, issue_buf);
    issue_buf = (issue_buf + 1) % NBUF;
    if (++next_chunk == n_chunks) {
      next_chunk = 0;
      next_tile += gridDim.x;
    }
  }
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int qb = tile / n_cb;
    const int q0 = qb * QB;
    const int c0 = (tile - qb * n_cb) * TC;
    for (int chunk = 0; chunk < n_chunks; ++chunk, buf_id = (buf_id + 1) % NBUF) {
      const int kb = chunk * KC;
      const int kw = min(KC, W - kb), k8 = (kw + 7) & ~7;
      __syncthreads();                             // all done with the other buffer, qs, pq
      const bool new_q = n_chunks > 1 || qb != staged_qb;
      if (new_q) {                                 // the query chunk, zero past kw and B
        for (int i = tid; i < QB * k8; i += THREADS) {
          const int r = i / k8, e = i - r * k8;
          const bool ok = q0 + r < B && e < kw;
          cp_async<4>(qs + r * S + e, ok ? q + (size_t)(q0 + r) * W + kb + e : q, ok);
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
        staged_qb = qb;
      }
      issue(next_tile, next_chunk, issue_buf);     // NBUF - 1 items ahead
      issue_buf = (issue_buf + 1) % NBUF;
      if (++next_chunk == n_chunks) {
        next_chunk = 0;
        next_tile += gridDim.x;
      }
      // this item's codes (NBUF - 1 groups before the newest) and its queries
      // (one before the newest) are in, for this thread
      if (new_q)
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      else
        asm volatile("cp.async.wait_group %0;" ::"n"(NBUF - 1) : "memory");
      __syncthreads();                                       // (everyone's)
      if (new_q && tid < QB) {                     // popc(q), summed over the chunks
        int s = chunk ? pq[tid] : 0;
        for (int e = 0; e < k8; ++e) s += __popc(qs[tid * S + e]);
        pq[tid] = s;
      }

      if (chunk == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;
#pragma unroll
        for (int n = 0; n < NT; ++n) pc[n] = 0;
      }
      const uint32_t* cb = cs + buf_id * TC * S + (wn + g) * S + t;
      for (int ks = 0; ks < k8 / 8; ++ks) {
        uint32_t b[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          b[n][0] = cb[8 * n * S + 8 * ks];
          b[n][1] = cb[8 * n * S + 8 * ks + 4];
          pc[n] += __popc(b[n][0]) + __popc(b[n][1]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint32_t* qa = qs + (wm + 16 * m + g) * S + 8 * ks + t;
          const uint32_t a0 = qa[0], a1 = qa[8 * S], a2 = qa[4], a3 = qa[8 * S + 4];
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma_and_popc(acc[m][n], a0, a1, a2, a3, b[n][0], b[n][1]);
        }
      }
      if (new_q && chunk == n_chunks - 1) __syncthreads();   // pq is complete (uniform)
    }

    // popc(c) of columns 2t and 2t + 1 of each n8 tile (rows 8 n + 2t, + 1)
    int pc0[NT], pc1[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      int s = pc[n];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);     // row 8 n + g, in every lane of quad g
      pc0[n] = __shfl_sync(0xffffffffu, s, 8 * t);
      pc1[n] = __shfl_sync(0xffffffffu, s, 8 * t + 4);
    }

    const bool full = vec_out && q0 + QB <= B && c0 + TC <= C;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r0 = wm + 16 * m + g;              // rows r0 and r0 + 8 of the tile
      const int p0 = pq[r0], p1 = pq[r0 + 8];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int h0 = p0 + pc0[n] - 2 * acc[m][n][0];   // (r0, 2t)
        const int h1 = p0 + pc1[n] - 2 * acc[m][n][1];   // (r0, 2t + 1)
        const int h2 = p1 + pc0[n] - 2 * acc[m][n][2];   // (r0 + 8, 2t)
        const int h3 = p1 + pc1[n] - 2 * acc[m][n][3];   // (r0 + 8, 2t + 1)
        const int cc = c0 + wn + 8 * n + 2 * t;
        if (full) {
          // even lanes keep row r0 and take the odd neighbour's columns; odd
          // lanes keep row r0 + 8 and take the even neighbour's
          const bool odd = t & 1;
          const int s0 = __shfl_xor_sync(0xffffffffu, odd ? h0 : h2, 1);
          const int s1 = __shfl_xor_sync(0xffffffffu, odd ? h1 : h3, 1);
          const int row = q0 + r0 + (odd ? 8 : 0);
          const int4 v = odd ? make_int4(s0, s1, h2, h3) : make_int4(h0, h1, s0, s1);
          *reinterpret_cast<int4*>(out + (size_t)row * C + (odd ? cc - 2 : cc)) = v;
        } else {
          const int b0 = q0 + r0, b1 = b0 + 8;
          if (b0 < B) {
            if (cc < C) out[(size_t)b0 * C + cc] = h0;
            if (cc + 1 < C) out[(size_t)b0 * C + cc + 1] = h1;
          }
          if (b1 < B) {
            if (cc < C) out[(size_t)b1 * C + cc] = h2;
            if (cc + 1 < C) out[(size_t)b1 * C + cc + 1] = h3;
          }
        }
      }
    }
  }
}

}  // namespace

// q [B, W], codes [C, W] (32-bit words), out [B, C] int32, all contiguous on
// `device`, out 16-byte aligned. Returns a cudaError_t (0 = launched).
extern "C" int gvdb_hamming(int device, const void* q, const void* codes, void* out, int B,
                            int C, int W, void* stream) {
  if (B <= 0 || C <= 0 || W <= 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(uint32_t) * (QB + NBUF * TC) * stride_of(W);
  err = cudaFuncSetAttribute(hamming_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return (int)err;
  const long n_cb = (C + (long)TC - 1) / TC;
  const long tiles = n_cb * ((B + (long)QB - 1) / QB);
  if (tiles > 2147483647L - (long)BLOCKS_PER_SM * sms) return (int)cudaErrorInvalidValue;
  const long grid = tiles < (long)BLOCKS_PER_SM * sms ? tiles : (long)BLOCKS_PER_SM * sms;
  const bool vec_in = W % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  hamming_mma_kernel<<<static_cast<int>(grid), THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(codes),
      static_cast<int32_t*>(out), B, C, W, static_cast<int>(n_cb), static_cast<int>(tiles),
      vec_in);
  return (int)cudaGetLastError();
}

extern "C" const char* gvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
