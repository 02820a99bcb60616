// Asymmetric binary prescan: a bf16 query against packed sign codes (Hopper, sm_90a).
//
// Replaces no Pallas kernel. The JAX package's asym_topk
// (grape_vector_db_tpu/ops/hamming.py) decodes the codes to a +-1 bf16 plane
// and takes one product, and on the TPU XLA fuses that decode into the
// product. Eager PyTorch runs the decode as five elementwise passes over a
// [rows, 768] int32 plane and a cast, each through device memory (~20 GB a
// call at 1M rows), which was most of a two-stage search's device time. This
// kernel is bound to PyTorch through a plain C interface (ctypes) by
// grape_vector_db_tpu_torch/ops/hamming.py (asym_scores), which also holds
// the plain PyTorch version of the same contract (asym_scores_ref).
//
// Contract. q [B, D] bf16, codes [C, W] 32-bit words with W = ceil(D / 32)
// (bit j of word w is the sign bit of coordinate 32 w + j), valid [C] bytes;
// out [B, C] f32 with
//   out[b, c] = sum over j < D of q[b, j] * (bit j of row c ? +1 : -1)
// where valid[c], and -inf where not. Each product bf16 x +-1 is exact and
// the sum is f32, in the tensor cores' order. Lanes past D add nothing (q is
// zero there). B, C and D are any positive sizes.
//
// What bounds it on an H100. At the two-stage search's shape (B = 8 after
// padding, D = 768, C = 1,048,576 rows) the kernel reads 96 MB of codes and
// 1 MB of validity and writes the 32 MB [8, C] f32 plane: 0.039 ms at
// 3.35 TB/s. The products are 12.9 GFLOP (3.1M m16n8k16 mma.sync), 0.013 ms
// at the bf16 tensor-core peak. Memory is the floor; the issue of the
// products and of the operands they need comes next. Measured on an H100
// (PERF.md): mma.sync bf16 issues at ~6.9 cycles an SM sub-partition with
// its operands in registers; rebuilt each time by shift + lop3 it falls to
// ~16.7, because both run on the integer pipe at half a warp a cycle; and B
// read from shared memory right before each product costs latency on top.
//
// Design. Corpus rows are the M side of bf16 mma.sync m16n8k16 and queries
// the n8 side, f32 accumulate. Inside each 32-bit word the K order is
// permuted (the query side follows the same order) so that every A register
// a thread needs holds bits i and i + 16 of one word: the word multiplied by
// 2^(15 - i) puts them at the two bf16 sign positions (15 and 31), and
// (~x & 0x80008000) | 0x3F803F80 is the pair of signs, +1 (0x3F80) where the
// bit is set and -1 (0xBF80) where not. That is one multiply (FMA pipe) and
// one lop3 (integer pipe) a register, in registers only, so no +-1 value
// reaches memory. Lane (g, t) of a warp takes bits {2t, 2t + 1, 2t + 8,
// 2t + 9} and each of them + 16 of every word of rows g and g + 8 of its m16
// tile, four words a 16-byte shared-memory load. The queries are staged in
// shared memory once per query tile, already in mma B-fragment order, one
// 16-byte load a lane a word for its two k-steps (no bank conflicts). A
// persistent grid walks items (query tile, 128-row corpus tile, chunk of up
// to 32 words), queries outer, and cp.async copies the codes of the next
// NBUF - 1 items into a ring while the current one is computed (the ring of
// csrc/hamming.cu); rows are staged at a stride of 4 mod 8 words, so the 8
// rows a warp reads at once hit distinct banks. Each warp owns 16 rows x QN
// n8 tiles of queries (QN = 1 at B <= 8, 2 at B <= 16, else 4), so each
// operand built serves QN products. The epilogue writes each score, or -inf
// for an invalid row; a store of a warp covers 4 queries x 8 consecutive rows
// (32-byte sectors). Left above the floor (PERF.md): the product stream alone
// takes ~2.5x the memory floor and overlaps the copies only in part.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TC = 16 * WARPS;              // corpus rows a tile: one m16 tile a warp
constexpr int KC = 32;                      // words a staged chunk
constexpr int NBUF = 4;                     // codes buffers: items in flight + 1
constexpr int BLOCKS_PER_SM = 2;

// Row stride in words of a staged chunk: its words rounded up to 8, plus 4,
// so that S = 4 mod 8 and rows g = 0..7 of a warp's load hit distinct banks;
// a multiple of 4, so each row starts 16-byte aligned.
__host__ __device__ constexpr int stride_of(int W) { return ((W < KC ? W : KC) + 7) / 8 * 8 + 4; }

// Words of a chunk of W-word rows as the product walks them, 4 at a time.
__host__ __device__ constexpr int words4(int W) { return ((W < KC ? W : KC) + 3) / 4 * 4; }

// 32-bit words of shared memory the query fragments of a chunk take (the
// codes ring follows them).
__host__ __device__ constexpr int qfrag_words(int qn, int W) { return qn * 2 * words4(W) * 64; }

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bits 15 - sh and 31 - sh of x as two bf16 signs, +1 where set and -1
// where not, with mul = 2^sh: (~(x * mul) & 0x80008000) | 0x3F803F80. The
// shift is a multiply, which the FMA pipe issues, and the rest one lop3 on
// the integer pipe (the compiler, left to itself, spends two on the two
// constants), so the two pipes share the work of building the operands.
__device__ __forceinline__ uint32_t signs(uint32_t x, uint32_t mul) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xAE;" : "=r"(r) : "r"(x * mul), "r"(0x80008000u), "r"(0x3F803F80u));
  return r;
}

// Asynchronous copy of `BYTES` (4 or 16) into shared memory; `valid` false
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
// (tile = blockIdx.x + j * gridDim.x; tile / n_ct is the query tile) and each
// KC-word chunk of W. The codes of the next NBUF - 1 items are in flight while
// the current one is computed.
template <int QN>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
asym_mma_kernel(const uint16_t* __restrict__ q, const uint32_t* __restrict__ codes,
                const uint8_t* __restrict__ valid, float* __restrict__ out, int B, int C, int D,
                int W, int n_ct, int tiles, bool vec_in) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int S = stride_of(W);
  uint32_t* qf = smem;                             // [QN][chunk words (to 4)][32 lanes][4]
  uint32_t* cs = smem + qfrag_words(QN, W);        // codes chunks [NBUF][TC][S]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;           // mma row group, thread in group
  const int n_chunks = (W + KC - 1) / KC;

  // the codes of chunk `chunk` of tile `tile` (if tile < tiles) into buffer buf_id
  auto issue = [&](int tile, int chunk, int buf_id) {
    if (tile < tiles) {
      const int c0 = (tile % n_ct) * TC;
      const int kb = chunk * KC;
      const int kw = min(KC, W - kb);
      uint32_t* buf = cs + buf_id * TC * S;
      if (vec_in) {                                // 16-byte pieces; kw % 4 == 0
        const int per_row = kw / 4;
        for (int i = tid; i < TC * per_row; i += THREADS) {
          const int r = i / per_row, e = (i - r * per_row) * 4;
          const bool ok = c0 + r < C;
          cp_async<16>(buf + r * S + e, ok ? codes + (size_t)(c0 + r) * W + kb + e : codes, ok);
        }
      } else {
        for (int i = tid; i < TC * kw; i += THREADS) {
          const int r = i / kw, e = i - r * kw;
          const bool ok = c0 + r < C;
          cp_async<4>(buf + r * S + e, ok ? codes + (size_t)(c0 + r) * W + kb + e : codes, ok);
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float acc[QN][4];
  int staged_qt = -1, buf_id = 0;
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
    const int qt = tile / n_ct;
    const int q0 = qt * 8 * QN;
    const int c0 = (tile - qt * n_ct) * TC;
    // the validity of this lane's rows g and g + 8, read here so that the
    // product hides the wait
    const int r0 = c0 + 16 * warp + g, r1 = r0 + 8;
    const bool ok0 = r0 < C && valid[r0], ok1 = r1 < C && valid[r1];
    for (int chunk = 0; chunk < n_chunks; ++chunk, buf_id = (buf_id + 1) % NBUF) {
      const int kb = chunk * KC;
      const int kw = min(KC, W - kb);
      const int kw4 = (kw + 3) & ~3;              // the words the product walks
      const int ks_n = 2 * kw4;                    // k-steps of this chunk
      __syncthreads();                             // all done with qf and the other buffer
      if (n_chunks > 1 || qt != staged_qt) {
        // B fragments of queries q0 .. q0 + 8 QN - 1 over words kb .. kb + kw4 - 1,
        // one 16-byte piece a lane a word: lane (g, t) holds query 8 n + g at
        // coordinates (i, i + 16), (i + 1, i + 17) of k-step 2w (i = 2t) and
        // the same + 8 of k-step 2w + 1; zero past B and past D
        for (int i = tid; i < QN * ks_n * 32; i += THREADS) {
          const int l = i & 31, ks = (i >> 5) % ks_n, n = (i >> 5) / ks_n;
          const int b = q0 + 8 * n + (l >> 2);
          const int j = 32 * (kb + (ks >> 1)) + 2 * (l & 3) + 8 * (ks & 1);
          uint32_t v[4] = {0, 0, 0, 0};
          if (b < B) {
            const uint16_t* qr = q + (size_t)b * D;
            const int js[4] = {j, j + 16, j + 1, j + 17};
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = js[e] < D ? qr[js[e]] : 0;
          }
          uint32_t* dst = qf + 4 * ((n * (ks_n >> 1) + (ks >> 1)) * 32 + l) + 2 * (ks & 1);
          dst[0] = v[0] | (v[1] << 16);
          dst[1] = v[2] | (v[3] << 16);
        }
        staged_qt = qt;
      }
      issue(next_tile, next_chunk, issue_buf);     // NBUF - 1 items ahead
      issue_buf = (issue_buf + 1) % NBUF;
      if (++next_chunk == n_chunks) {
        next_chunk = 0;
        next_tile += gridDim.x;
      }
      // this item's codes (NBUF - 1 groups before the newest) are in, for this thread
      asm volatile("cp.async.wait_group %0;" ::"n"(NBUF - 1) : "memory");
      __syncthreads();                             // (everyone's, and the query fragments)

      if (chunk == 0) {
#pragma unroll
        for (int n = 0; n < QN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      }
      const uint32_t* cb = cs + buf_id * TC * S + (16 * warp + g) * S;
      const uint4* qb = reinterpret_cast<const uint4*>(qf) + lane;
      // 2^(15 - i) for this lane's bits i = 2t, 2t + 1, 2t + 8, 2t + 9
      const uint32_t mul[4] = {1u << (15 - 2 * t), 1u << (14 - 2 * t), 1u << (7 - 2 * t),
                               1u << (6 - 2 * t)};
      // words kw .. kw4 - 1 of a row hold stale bits; the query is zero there
      for (int w4 = 0; w4 < kw4; w4 += 4) {
        const uint4 x0 = *reinterpret_cast<const uint4*>(cb + w4);           // row g
        const uint4 x1 = *reinterpret_cast<const uint4*>(cb + 8 * S + w4);   // row g + 8
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint32_t y0 = u == 0 ? x0.x : u == 1 ? x0.y : u == 2 ? x0.z : x0.w;
          const uint32_t y1 = u == 0 ? x1.x : u == 1 ? x1.y : u == 2 ? x1.z : x1.w;
          // k-step 2w: a0/a1 bits (2t, 2t + 16) of rows g / g + 8, a2/a3 bits
          // (2t + 1, 2t + 17); k-step 2w + 1: the same + 8
          const uint32_t a[2][4] = {
              {signs(y0, mul[0]), signs(y1, mul[0]), signs(y0, mul[1]), signs(y1, mul[1])},
              {signs(y0, mul[2]), signs(y1, mul[2]), signs(y0, mul[3]), signs(y1, mul[3])}};
#pragma unroll
          for (int n = 0; n < QN; ++n) {
            const uint4 b = qb[(n * (ks_n >> 1) + w4 + u) * 32];      // k-steps 2w, 2w + 1
            mma_bf16(acc[n], a[0], b.x, b.y);
            mma_bf16(acc[n], a[1], b.z, b.w);
          }
        }
      }
    }

    // c0/c1: row g, queries 2t and 2t + 1 of the n8 tile; c2/c3: row g + 8
    const float NEG_INF = -__int_as_float(0x7f800000);
#pragma unroll
    for (int n = 0; n < QN; ++n) {
      const int b0 = q0 + 8 * n + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (b0 + e >= B) continue;
        float* orow = out + (size_t)(b0 + e) * C;
        if (r0 < C) orow[r0] = ok0 ? acc[n][e] : NEG_INF;
        if (r1 < C) orow[r1] = ok1 ? acc[n][2 + e] : NEG_INF;
      }
    }
  }
}

template <int QN>
size_t smem_bytes(int W) {
  return sizeof(uint32_t) * (qfrag_words(QN, W) + (size_t)NBUF * TC * stride_of(W));
}

template <int QN>
int launch(int device, const void* q, const void* codes, const void* valid, void* out, int B,
           int C, int D, cudaStream_t stream) {
  const int W = (D + 31) / 32;
  const size_t smem = smem_bytes<QN>(W);
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(asym_mma_kernel<QN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return (int)err;
  // as many blocks an SM as fit (2-3 at D = 768)
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, asym_mma_kernel<QN>, THREADS,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long n_ct = (C + (long)TC - 1) / TC;
  const long tiles = n_ct * ((B + 8L * QN - 1) / (8L * QN));
  const long slots = (long)per_sm * sms;
  if (tiles > 2147483647L - slots) return (int)cudaErrorInvalidValue;
  const long grid = tiles < slots ? tiles : slots;
  const bool vec_in = W % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  asym_mma_kernel<QN><<<static_cast<int>(grid), THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint32_t*>(codes),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), B, C, D, W,
      static_cast<int>(n_ct), static_cast<int>(tiles), vec_in);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, D] bf16, codes [C, ceil(D / 32)] 32-bit words, valid [C] bytes (0 or
// 1), out [B, C] f32, all contiguous on `device`. Returns a cudaError_t
// (0 = launched).
extern "C" int gvdb_asym(int device, const void* q, const void* codes, const void* valid,
                         void* out, int B, int C, int D, void* stream) {
  if (B <= 0 || C <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 8) return launch<1>(device, q, codes, valid, out, B, C, D, s);
  if (B <= 16) return launch<2>(device, q, codes, valid, out, B, C, D, s);
  return launch<4>(device, q, codes, valid, out, B, C, D, s);
}

extern "C" const char* gvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
