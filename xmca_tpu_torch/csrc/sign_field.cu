// Masked +-1 int8 surrogate field plus its column sums, one write.
//
// Replaces the Pallas TPU kernel xmca_tpu/ops/surrogate.py:sign_field_sums
// (pallas_call at surrogate.py:403), the draw stage of every Rule-N run.
// It writes straight into the padded int8 layout the syrk kernel reads.
//
// What bounds it on the card: the write.  At the main path's shape one
// field is (2048, 100352) int8 = 205 MB, ~61 us at 3.35 TB/s; the random
// bits cost one Philox4x32-10 call (10 rounds of two 32-bit multiplies)
// per 128 elements, far below the store rate.
//
// Design:
// * Philox4x32-10 (philox.cuh) in the kernel.  Key =
//   (seed ^ 0x53474E53, stream); counter = (row, column group, 0, 0).
//   Output word w, bit b is the element at column 128*group + 32*w + b:
//   bit 1 -> +1, bit 0 -> -1.  Rows >= n and columns >= p are 0.
//   xmca_tpu_torch/ops/surrogate.py:sign_field_sums_reference reproduces
//   this mapping bit for bit.
// * one block of 128 threads owns one 128-column group and walks all
//   row tiles of 128 rows: thread r draws row r's 128 signs into a shared
//   tile (rows padded to 144 bytes), the block stores the tile with
//   coalesced 16-byte writes, and thread c adds column c of the tile to
//   its running sum.  Each column sum has one owner and a fixed order:
//   no atomics, so the sums are deterministic and exact.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kCols = 128;              // columns per group == threads
constexpr int kRows = 128;              // rows per tile
constexpr int kStride = kCols + 16;     // padded shared row (bytes)
constexpr uint32_t kSalt = 0x53474E53u; // 'SGNS', as the TPU kernel's

// 4 consecutive elements (bits b..b+3 of `word`) as packed int8 bytes
__device__ __forceinline__ uint32_t pack4(uint32_t word, int b, int col,
                                          int p, bool row_ok) {
  uint32_t out = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const uint32_t bit = (word >> (b + m)) & 1u;
    const uint32_t byte = (row_ok && col + m < p) ? (bit ? 0x01u : 0xFFu)
                                                  : 0u;
    out |= byte << (8 * m);
  }
  return out;
}

__global__ void __launch_bounds__(kCols)
sign_field_kernel(int8_t* __restrict__ X, int32_t* __restrict__ colsum,
                  int n, int p, int n_pad, int p_pad, uint32_t k0,
                  uint32_t k1) {
  __shared__ __align__(16) uint8_t tile[kRows * kStride];
  const int grp = blockIdx.x;
  const int tid = threadIdx.x;
  const int col0 = grp * kCols;
  int sum = 0;

  for (int r0 = 0; r0 < n_pad; r0 += kRows) {
    const int row = r0 + tid;
    const uint4 w4 = xmca::philox4x32_10(
        make_uint4(static_cast<uint32_t>(row), static_cast<uint32_t>(grp),
                   0u, 0u), k0, k1);
    const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
    const bool row_ok = row < n;
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int h = 0; h < 2; ++h) {       // 16 elements per 16-byte store
        const int e = 32 * w + 16 * h;
        uint4 v;
        v.x = pack4(words[w], 16 * h + 0, col0 + e + 0, p, row_ok);
        v.y = pack4(words[w], 16 * h + 4, col0 + e + 4, p, row_ok);
        v.z = pack4(words[w], 16 * h + 8, col0 + e + 8, p, row_ok);
        v.w = pack4(words[w], 16 * h + 12, col0 + e + 12, p, row_ok);
        *reinterpret_cast<uint4*>(tile + tid * kStride + e) = v;
      }
    __syncthreads();

#pragma unroll 8
    for (int r = 0; r < kRows; ++r)
      sum += static_cast<int8_t>(tile[r * kStride + tid]);

#pragma unroll
    for (int q = 0; q < (kRows * kCols / 16) / kCols; ++q) {
      const int piece = tid + kCols * q;
      const int r = piece >> 3;
      const int c = (piece & 7) * 16;
      *reinterpret_cast<uint4*>(
          X + static_cast<size_t>(r0 + r) * p_pad + col0 + c) =
          *reinterpret_cast<const uint4*>(tile + r * kStride + c);
    }
    __syncthreads();
  }
  colsum[col0 + tid] = sum;
}

}  // namespace

// X (n_pad, p_pad) int8 and colsum (p_pad,) int32, both contiguous.  The
// caller guarantees n_pad % 128 == 0, p_pad % 128 == 0, n <= n_pad,
// p <= p_pad.  Returns cudaGetLastError() after the launch.
extern "C" int xmca_sign_field_sums(void* X, void* colsum, int n, int p,
                                    int n_pad, int p_pad, unsigned seed,
                                    unsigned stream_id, void* stream) {
  const int groups = p_pad / kCols;
  sign_field_kernel<<<groups, kCols, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(X), static_cast<int32_t*>(colsum), n, p, n_pad,
      p_pad, seed ^ kSalt, stream_id);
  return static_cast<int>(cudaGetLastError());
}
