// Symmetric rank-k update G = X X^T for Hopper (sm_90a), int8 or bf16.
//
// Replaces the Pallas TPU kernel xmca_tpu/ops/syrk.py:syrk (pallas_call
// at syrk.py:95): the temporal Gram of every Rule-N surrogate field.
//
// What bounds it on the card: at the main path's shape, X is
// (2048, 100352) int8 = 205 MB, more than the 50 MB L2, and the Gram is
// 2048^2 * 100352 multiply-adds = 4.2e11 int8 ops for the full product.
// The TPU kernel's point carries over: only the nb(nb+1)/2 lower
// triangle tiles are computed, which halves both the operations and the
// panel reads.  Each tile streams two 64-row panels of X through shared
// memory, so the DRAM/L2 traffic is ~(nb+1)/2 passes over X.
//
// Design (a first, simple kernel; wgmma/TMA/persistence come later): the
// lower-triangle mma.sync kernel of tri_gram.cuh, one block per 64x64
// tile, fed by a cp.async loader that streams 128-byte chunks of X into
// a 2-stage shared ring (see tri_gram.cuh for the tile decode, the bf16
// chunk fold and the mirrored epilogue).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_gram.cuh"

using namespace xmca::tri;

namespace {

// Copies one 64-row x 128-byte chunk of X (rows row0.., chunk kc) into
// shared memory: 512 16-byte cp.async pieces, 4 per thread.
struct GlobalLoader {
  const uint8_t* X;
  size_t row_bytes;

  __device__ __forceinline__ void operator()(uint8_t* dst, int row0,
                                             int kc) const {
    const size_t k0 = static_cast<size_t>(kc) * kChunk;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int piece = threadIdx.x + kThreads * q;
      int r = piece >> 3;
      int c = (piece & 7) * 16;
      cp_async16(dst + r * kStride + c,
                 X + static_cast<size_t>(row0 + r) * row_bytes + k0 + c);
    }
  }
};

}  // namespace

// G (n_pad, n_pad) f32 <- X X^T for X (n_pad, p_pad) int8 (is_int8=1) or
// bf16 (is_int8=0), row-major and contiguous.  The caller guarantees
// n_pad % 64 == 0, p_pad % 128 == 0, 16-byte aligned pointers and (int8)
// no int32 overflow.  Returns cudaGetLastError() after the launch.
extern "C" int xmca_syrk(const void* X, void* G, int n_pad, int p_pad,
                         int is_int8, void* stream) {
  const int tiles = tile_count(n_pad);
  const int row_bytes = p_pad * (is_int8 ? 1 : 2);
  const int n_chunks = row_bytes / kChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GlobalLoader load{static_cast<const uint8_t*>(X),
                          static_cast<size_t>(row_bytes)};
  float* g = static_cast<float*>(G);
  if (is_int8) {
    tri_gram_kernel<true, GlobalLoader><<<tiles, kThreads, 0, s>>>(
        load, g, n_pad, n_chunks);
  } else {
    tri_gram_kernel<false, GlobalLoader><<<tiles, kThreads, 0, s>>>(
        load, g, n_pad, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
