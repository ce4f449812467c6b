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
// Design (a first, simple kernel; wgmma/TMA/persistence come later):
// * one CUDA block per lower-triangle 64x64 tile, decoded from blockIdx
//   (no scalar prefetch); the whole contraction loops inside the block,
//   so nothing is carried between blocks and no atomics are needed;
// * 4 warps in a 2x2 layout, each a 32x32 sub-tile from mma.sync:
//   m16n8k32 s8*s8->s32 (integer-exact) or m16n8k16 bf16*bf16->f32;
// * a 2-stage cp.async ring of 128-byte contraction chunks; shared rows
//   are padded to 144 bytes so the fragment loads hit 32 distinct banks;
// * bf16 partial sums are folded into an f32 total once per chunk (the
//   tensor cores' accumulate truncates; see the kernel);
// * the epilogue converts to f32 and writes both G[i,j] and G[j,i]
//   (diagonal tiles write their lower half and its mirror), so G is
//   exactly symmetric and no separate mirror pass exists.
// Both element types share the byte-level fragment layout: one
// contraction step is 32 bytes (32 int8 or 16 bf16 values).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kTile = 64;               // output tile (rows == cols)
constexpr int kChunk = 128;             // contraction bytes per stage
constexpr int kStride = kChunk + 16;    // padded shared row (bytes)
constexpr int kThreads = 128;
constexpr int kTileBytes = kTile * kStride;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma(int (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Copy one 64-row x 128-byte chunk of X (rows row0.., bytes k0..) into
// shared memory: 512 16-byte pieces, 4 per thread.
__device__ __forceinline__ void load_chunk(uint8_t* dst, const uint8_t* X,
                                           size_t row_bytes, int row0,
                                           size_t k0) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int piece = threadIdx.x + kThreads * q;
    int r = piece >> 3;
    int c = (piece & 7) * 16;
    cp_async16(dst + r * kStride + c,
               X + static_cast<size_t>(row0 + r) * row_bytes + k0 + c);
  }
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
syrk_kernel(const uint8_t* __restrict__ X, float* __restrict__ G,
            int n_pad, int row_bytes) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  __shared__ __align__(16) uint8_t smem[2][2][kTileBytes];

  // lower-triangle tile t -> (ti, tj), tj <= ti
  const int t = blockIdx.x;
  int ti = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  while (ti * (ti + 1) / 2 > t) --ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int rowA = ti * kTile, rowB = tj * kTile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = (lane & 3) * 4;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  // bf16: the tensor cores' f32 accumulate truncates the addends it
  // aligns to the accumulator's exponent, a one-sided drift (measured
  // 5e-4 of the diagonal after 100352 products accumulated in place),
  // so each 128-byte chunk (64 products) starts from zero and is folded
  // into an f32 total with ordinary, rounded adds (measured 1.6e-5, the
  // same as a fold after every k=16 step).  int8 sums are exact.
  Acc acc[2][4][4];
  float total[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = Acc(0);
        total[i][j][e] = 0.0f;
      }

  const size_t rb = static_cast<size_t>(row_bytes);
  const int n_chunks = row_bytes / kChunk;
  load_chunk(smem[0][0], X, rb, rowA, 0);
  load_chunk(smem[0][1], X, rb, rowB, 0);
  cp_async_commit();

  for (int kc = 0; kc < n_chunks; ++kc) {
    const int cur = kc & 1;
    if (kc + 1 < n_chunks) {
      const size_t k0 = static_cast<size_t>(kc + 1) * kChunk;
      load_chunk(smem[cur ^ 1][0], X, rb, rowA, k0);
      load_chunk(smem[cur ^ 1][1], X, rb, rowB, k0);
    }
    cp_async_commit();      // possibly empty: keeps the group count fixed
    cp_async_wait1();
    __syncthreads();

    const uint8_t* As = smem[cur][0];
    const uint8_t* Bs = smem[cur][1];
#pragma unroll
    for (int ks = 0; ks < kChunk; ks += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint8_t* p = As + (wm + mi * 16 + g) * kStride + ks + q4;
        a[mi][0] = ld32(p);
        a[mi][1] = ld32(p + 8 * kStride);
        a[mi][2] = ld32(p + 16);
        a[mi][3] = ld32(p + 8 * kStride + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* p = Bs + (wn + ni * 8 + g) * kStride + ks + q4;
        b[ni][0] = ld32(p);
        b[ni][1] = ld32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma(acc[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3],
              b[ni][0], b[ni][1]);
    }
    if constexpr (!kInt8) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            total[mi][ni][e] += acc[mi][ni][e];
            acc[mi][ni][e] = 0.0f;
          }
    }
    __syncthreads();
  }

  // epilogue: c0,c1 at (g, 2*(lane&3) + {0,1}); c2,c3 at row g+8
  const bool diag = (ti == tj);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rowA + wm + mi * 16 + g + (e >> 1) * 8;
        const int c = rowB + wn + ni * 8 + (lane & 3) * 2 + (e & 1);
        if (diag && c > r) continue;
        const float v = kInt8 ? static_cast<float>(acc[mi][ni][e])
                              : total[mi][ni][e];
        G[static_cast<size_t>(r) * n_pad + c] = v;
        G[static_cast<size_t>(c) * n_pad + r] = v;
      }
}

}  // namespace

// G (n_pad, n_pad) f32 <- X X^T for X (n_pad, p_pad) int8 (is_int8=1) or
// bf16 (is_int8=0), row-major and contiguous.  The caller guarantees
// n_pad % 64 == 0, p_pad % 128 == 0, 16-byte aligned pointers and (int8)
// no int32 overflow.  Returns cudaGetLastError() after the launch.
extern "C" int xmca_syrk(const void* X, void* G, int n_pad, int p_pad,
                         int is_int8, void* stream) {
  const int nb = n_pad / kTile;
  const int tiles = nb * (nb + 1) / 2;
  const int row_bytes = p_pad * (is_int8 ? 1 : 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* x = static_cast<const uint8_t*>(X);
  float* g = static_cast<float*>(G);
  if (is_int8) {
    syrk_kernel<true><<<tiles, kThreads, 0, s>>>(x, g, n_pad, row_bytes);
  } else {
    syrk_kernel<false><<<tiles, kThreads, 0, s>>>(x, g, n_pad, row_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}
