// Raw temporal Gram of a generated surrogate field; the field is never
// stored.
//
// Replaces the Pallas TPU kernel xmca_tpu/ops/surrogate.py:surrogate_gram
// (pallas_call at surrogate.py:177): G = X X^T (n, n) f32 of the (n, p)
// field of gen_draw.cuh, plus its column sums (for mu).  The wrapper
// (ops/surrogate.py:surrogate_gram) takes u = G 1 / n and mu.mu =
// 1^T G 1 / n^2 from G, the identity the JAX package uses at
// xmca_tpu/core/fastpath.py:948-952.
//
// What bounds it on the card: generation, not the tensor cores.  At
// (2000, 100000) the lower triangle is 528 tiles of 64 rows, each
// regenerating two 64-row panels over all p columns: ~1.7e9 Philox4x32-10
// calls (10 rounds of two 32-bit multiply pairs, ~70 integer instructions
// each, ~1.2e11 in all), against ~4.2e11 bf16 multiply-adds that the
// tensor cores finish in ~1 ms.  The TPU kernel lost to a materialised
// draw + Gram for the same reason (surrogate.py:29-34).
//
// Design (a first, simple kernel):
// * K1's lower-triangle mma.sync kernel (tri_gram.cuh), bf16 -> f32 with
//   its 64-product chunk fold, fed by a loader that GENERATES each 64-row
//   x 64-column panel chunk into the shared ring instead of copying it:
//   8 Philox calls per thread per panel, one 8-byte shared store each.
//   All 4 warps of the block read the panel there; a diagonal tile
//   generates its one panel once.  Rows >= n and columns >= p are 0.
// * the column sums, which a triangle tile never sees whole, come from
//   the projection kernel of surrogate_project.cu with S = a column of
//   ones (S = nullptr): every element regenerated once more, summed in a
//   fixed order with no atomics, so mu is deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gen_draw.cuh"
#include "tri_gram.cuh"

using namespace xmca::tri;

extern "C" int xmca_surrogate_project(const void* S, void* P, int n, int p,
                                      int m, unsigned seed, int dist,
                                      void* stream);

namespace {

// Generates chunk kc (columns 64 kc .. 64 kc + 63) of the 64 rows row0..
// as bf16: 16 Philox calls per row, 8 per thread.
struct GenLoader {
  uint32_t seed;
  int n, p, dist;

  __device__ __forceinline__ void operator()(uint8_t* dst, int row0,
                                             int kc) const {
#pragma unroll 2
    for (int q = 0; q < 8; ++q) {
      const int call = threadIdx.x + kThreads * q;
      const int r = call >> 4;
      const int c4 = call & 15;
      const int row = row0 + r;
      const int col4 = kc * 16 + c4;
      uint2 v = make_uint2(0u, 0u);
      if (row < n && 4 * col4 < p) {
        float x[4];
        xmca::gen_values4(xmca::gen_words(seed, row, col4), 4 * col4, p,
                          dist, x);
        v = make_uint2(xmca::bf16_pair(x[0], x[1]),
                       xmca::bf16_pair(x[2], x[3]));
      }
      *reinterpret_cast<uint2*>(dst + r * kStride + c4 * 8) = v;
    }
  }
};

}  // namespace

// G (n_pad, n_pad) f32 <- X X^T and colsum (p,) f32 <- X^T 1 for the
// generated (n, p) field of `seed` (dist id as in gen_draw.cuh).  The
// caller guarantees n_pad % 64 == 0 and n <= n_pad.  Returns the first
// CUDA error of the two launches.
extern "C" int xmca_surrogate_gram(void* G, void* colsum, int n, int p,
                                   int n_pad, unsigned seed, int dist,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GenLoader load{seed, n, p, dist};
  const int n_chunks = (p + 63) / 64;
  tri_gram_kernel<false, GenLoader><<<tile_count(n_pad), kThreads, 0, s>>>(
      load, static_cast<float*>(G), n_pad, n_chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return xmca_surrogate_project(nullptr, colsum, n, p, 1, seed, dist,
                                stream);
}
