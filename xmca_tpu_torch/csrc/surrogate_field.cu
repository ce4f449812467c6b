// The generated surrogate field itself, written to device memory.
//
// Replaces the Pallas TPU kernel xmca_tpu/ops/surrogate.py:surrogate_field
// (pallas_call at surrogate.py:464): the (n, p) field of gen_draw.cuh,
// bf16 (int8 for rademacher8), the very streams surrogate_gram.cu and
// surrogate_project.cu regenerate.  It is their oracle: a Gram or a
// projection of this field must agree with theirs.
//
// What bounds it on the card: the write.  At (2000, 100000) the bf16
// field is 400 MB, ~0.12 ms at 3.35 TB/s, plus 5e7 Philox4x32-10 calls.
//
// Design: thread i of a row writes one 16-byte piece, 8 bf16 (2 Philox
// calls) or 16 int8 (4 calls) consecutive elements, with one vector store
// when the row's byte length is a multiple of 16 (every row then starts
// 16-byte aligned) and element stores otherwise or at the row's ragged
// end.  blockIdx.y walks the rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gen_draw.cuh"

namespace {

constexpr int kThreads = 128;

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
field_kernel(uint8_t* __restrict__ X, int n, int p, uint32_t seed,
             int dist, bool vec) {
  constexpr int kElt = kInt8 ? 1 : 2;
  constexpr int kPer = 16 / kElt;      // elements per thread
  const int col = (blockIdx.x * kThreads + threadIdx.x) * kPer;
  if (col >= p) return;
  for (int row = blockIdx.y; row < n; row += gridDim.y) {
    uint32_t words[4];                   // the kPer elements, packed
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const uint4 w = xmca::gen_words(seed, row, col / 4 + q);
      const int c = col + 4 * q;
      if constexpr (kInt8) {
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
        uint32_t packed = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          packed |= (c + e < p ? ((ws[e] & 1u) ? 0x01u : 0xFFu) : 0u)
                    << (8 * e);
        words[q] = packed;
      } else {
        float x[4];
        xmca::gen_values4(w, c, p, dist, x);
        words[2 * q] = xmca::bf16_pair(x[0], x[1]);
        words[2 * q + 1] = xmca::bf16_pair(x[2], x[3]);
      }
    }
    uint8_t* dst = X + (static_cast<size_t>(row) * p + col) * kElt;
    if (vec && col + kPer <= p) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(words[0], words[1], words[2], words[3]);
    } else {
      const int len = (p - col < kPer ? p - col : kPer) * kElt;
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (b < len)
          dst[b] = static_cast<uint8_t>(words[b >> 2] >> (8 * (b & 3)));
    }
  }
}

}  // namespace

// X (n, p) row-major, contiguous, 16-byte aligned: bf16, or int8 when
// dist is rademacher8 (dist id as in gen_draw.cuh).  Returns
// cudaGetLastError() after the launch.
extern "C" int xmca_surrogate_field(void* X, int n, int p, unsigned seed,
                                    int dist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool int8 = dist == xmca::kRademacher8;
  const int per = int8 ? 16 : 8;
  const bool vec = (static_cast<long long>(p) * (int8 ? 1 : 2)) % 16 == 0;
  const dim3 grid((p + per * kThreads - 1) / (per * kThreads),
                  n < 65535 ? n : 65535);
  uint8_t* x = static_cast<uint8_t*>(X);
  if (int8) {
    field_kernel<true><<<grid, kThreads, 0, s>>>(x, n, p, seed, dist, vec);
  } else {
    field_kernel<false><<<grid, kThreads, 0, s>>>(x, n, p, seed, dist, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
