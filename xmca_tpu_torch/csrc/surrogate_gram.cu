// Raw temporal Gram of a generated surrogate field; the field is never
// stored whole.
//
// Replaces the Pallas TPU kernel xmca_tpu/ops/surrogate.py:surrogate_gram
// (pallas_call at surrogate.py:177): G = X X^T (n, n) f32 of the (n, p)
// field of gen_draw.cuh, plus its column sums (for mu).  The wrapper
// (ops/surrogate.py:surrogate_gram) takes u = G 1 / n and mu.mu =
// 1^T G 1 / n^2 from G, the identity the JAX package uses at
// xmca_tpu/core/fastpath.py:948-952.
//
// What bounds it on the card: the tensor cores, once each element is
// generated only once.  At (2000, 100000) the lower triangle is 4.0e11
// bf16 operations (0.40 ms at 989 TFLOP/s) against 5e7 Philox4x32-10
// calls for the field (~0.1 ms at the SM issue rate).  Generating inside
// every Gram tile instead (one regeneration of each element per tile of
// its row panel, ~1.6e9 calls) made generation the bound, 30x over.
//
// Design: the TPU kernel walks the columns in blocks with G resident; on
// Hopper G cannot stay in one SM, so the walk is a loop of launches on the
// caller's stream, one pair per chunk of C columns
// (ops/surrogate.py:chunk_plan):
// * gen_chunk_kernel writes the chunk of the field into one (n_pad, C)
//   workspace slot (each element generated once, 16-byte stores, rows >= n
//   and columns >= p zero) and the chunk's column sums: a block owns its
//   columns over all rows and sums its row slices in a fixed order, with
//   no atomics, so mu has the same bits on every run;
// * K1's kernel (syrk.cu) contracts the slot with the TMA tensor map that
//   serves every chunk, in its accumulate mode (syrk.cuh): the first chunk
//   stores the lower triangle, later chunks add to it, the last one also
//   writes the mirror.  G is exactly symmetric and, the chunks being added
//   in order, has the same bits on every run.
// * +-1 draws (rademacher, rademacher8) go through an int8 slot and K1's
//   int8 path: exact, half the bytes and twice the tensor rate.
// Memory: the slot (n_pad x C elements) and K1's split workspace whatever
// p is; only the column sums (4p bytes) grow with p.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gen_draw.cuh"
#include "syrk.cuh"

namespace {

constexpr int kColThreads = 2;     // threads across a block's columns
constexpr int kRowThreads = 128;   // threads down the rows
constexpr int kGenThreads = kColThreads * kRowThreads;
constexpr int kPlanInts = 7;       // col0, width, K1's schedule (5 ints)

// Columns [col0, col0 + width) of the field -> the slot (n_pad rows of
// ld elements), and their sums -> colsum[col0 ...] (columns < p).  A
// thread writes 16 bytes a row (8 bf16: 2 Philox calls; 16 int8 +-1: 4
// calls) for rows ry, ry + kRowThreads, ...  kDist is the distribution
// (int8: kRademacher).
template <bool kInt8, int kDist>
__global__ void __launch_bounds__(kGenThreads)
gen_chunk_kernel(uint8_t* __restrict__ slot, int ld,
                 float* __restrict__ colsum, int n, int n_pad, int p,
                 int col0, uint32_t seed) {
  constexpr int kElt = kInt8 ? 1 : 2;
  constexpr int kPer = 16 / kElt;                // elements a thread a row
  constexpr int kBlockCols = kColThreads * kPer;
  __shared__ float red[kRowThreads][kBlockCols + 1];
  const int cx = threadIdx.x % kColThreads;
  const int ry = threadIdx.x / kColThreads;
  const int lc = blockIdx.x * kBlockCols + cx * kPer;   // in the chunk
  const int col = col0 + lc;
  float sum[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) sum[e] = 0.0f;

#pragma unroll 2
  for (int row = ry; row < n_pad; row += kRowThreads) {
    uint32_t words[4] = {0u, 0u, 0u, 0u};
    if (row < n && col < p) {
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) {
        const uint4 w = xmca::gen_words(seed, row, col / 4 + q);
        if constexpr (kInt8) {
          float x[4];
          xmca::gen_values4(w, col + 4 * q, p, kDist, x);
          uint32_t packed = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[4 * q + e] += x[e];
            packed |= static_cast<uint32_t>(static_cast<uint8_t>(
                          static_cast<int8_t>(x[e]))) << (8 * e);
          }
          words[q] = packed;
        } else {
          // the sums add the stored bf16 values, unpacked
          const uint2 b = xmca::gen_bf16x4(w, col + 4 * q, p, kDist);
          words[2 * q] = b.x;
          words[2 * q + 1] = b.y;
          sum[4 * q] += __uint_as_float(b.x << 16);
          sum[4 * q + 1] += __uint_as_float(b.x & 0xFFFF0000u);
          sum[4 * q + 2] += __uint_as_float(b.y << 16);
          sum[4 * q + 3] += __uint_as_float(b.y & 0xFFFF0000u);
        }
      }
    }
    *reinterpret_cast<uint4*>(slot + (static_cast<size_t>(row) * ld + lc) *
                                         kElt) =
        make_uint4(words[0], words[1], words[2], words[3]);
  }

  // the row slices' sums, in the order ry = 0, 1, ...
#pragma unroll
  for (int e = 0; e < kPer; ++e) red[ry][cx * kPer + e] = sum[e];
  __syncthreads();
  if (threadIdx.x < kBlockCols) {
    float t = 0.0f;
    for (int r = 0; r < kRowThreads; ++r) t += red[r][threadIdx.x];
    const int c = col0 + blockIdx.x * kBlockCols + threadIdx.x;
    if (c < p) colsum[c] = t;
  }
}

}  // namespace

// G (n_pad, n_pad) f32 <- X X^T and colsum (p,) f32 <- X^T 1 for the
// generated (n, p) field of `seed` (dist id as in gen_draw.cuh).  slot is
// (n_pad, ld) int8 (is_int8 = 1: +-1 dists only) or bf16, 16-byte
// aligned; work holds K1's split pieces for the largest chunk; order is
// K1's tile order of n_pad on the card (ops/syrk.py:tile_order) and
// waves its wave counter (4 bytes on the card, or nullptr).  plan
// holds n_chunks rows of (col0, width, kblocks, grid, dp_tiles,
// split_tiles, splits): the chunks of ops/surrogate.py:chunk_plan in
// order, each with its ops/syrk.py:schedule.  The caller guarantees
// n_pad % 128 == 0, n <= n_pad, widths that are multiples of 128 and at
// most ld.  Returns the first CUDA error of the launches.
extern "C" int xmca_surrogate_gram(void* G, void* colsum, void* slot,
                                   void* work, const void* order,
                                   void* waves, int n, int p, int n_pad,
                                   int ld, int is_int8, unsigned seed,
                                   int dist, const int* plan, int n_chunks,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap map;
  int err = xmca::syrk_tensor_map(&map, slot, n_pad, ld, is_int8);
  if (err != 0) return err;
  uint8_t* x = static_cast<uint8_t*>(slot);
  float* cs = static_cast<float*>(colsum);
  for (int i = 0; i < n_chunks; ++i) {
    const int* c = plan + kPlanInts * i;
    if (is_int8) {
      gen_chunk_kernel<true, xmca::kRademacher>
          <<<c[1] / (kColThreads * 16), kGenThreads, 0, s>>>(
              x, ld, cs, n, n_pad, p, c[0], seed);
    } else if (dist == xmca::kNormal16) {
      gen_chunk_kernel<false, xmca::kNormal16>
          <<<c[1] / (kColThreads * 8), kGenThreads, 0, s>>>(
              x, ld, cs, n, n_pad, p, c[0], seed);
    } else {
      gen_chunk_kernel<false, xmca::kNormal32>
          <<<c[1] / (kColThreads * 8), kGenThreads, 0, s>>>(
              x, ld, cs, n, n_pad, p, c[0], seed);
    }
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const xmca::SyrkSched sched{n_pad, c[2], c[4], c[5], c[6], i > 0,
                                i == n_chunks - 1,
                                static_cast<const int2*>(order),
                                static_cast<unsigned*>(waves)};
    err = xmca::syrk_launch(map, static_cast<float*>(G),
                            static_cast<uint32_t*>(work), sched, c[3],
                            is_int8, s);
    if (err != 0) return err;
  }
  return 0;
}
