// Lower-triangle Gram G = X X^T on mma.sync, templated on where the
// operand comes from: surrogate_gram.cu's loader generates it in the
// block (K1, syrk.cu, has its own wgmma kernel).
//
// * one CUDA block per lower-triangle 64x64 tile, decoded from blockIdx
//   (no scalar prefetch); the whole contraction loops inside the block,
//   so nothing is carried between blocks and no atomics are needed;
// * 4 warps in a 2x2 layout, each a 32x32 sub-tile from mma.sync:
//   m16n8k32 s8*s8->s32 (integer-exact) or m16n8k16 bf16*bf16->f32;
// * a 2-stage ring of 128-byte contraction chunks in shared memory (the
//   loader fills the next stage while the warps read this one); shared
//   rows are padded to 144 bytes so the fragment loads hit 32 distinct
//   banks; a diagonal tile fills only its one panel;
// * bf16 partial sums are folded into an f32 total once per chunk (the
//   tensor cores' accumulate truncates; see the kernel);
// * the epilogue converts to f32 and writes both G[i,j] and G[j,i]
//   (diagonal tiles write their lower half and its mirror), so G is
//   exactly symmetric and no separate mirror pass exists.
// Both element types share the byte-level fragment layout: one
// contraction step is 32 bytes (32 int8 or 16 bf16 values).
//
// A loader is a functor `void operator()(uint8_t* dst, int row0, int kc)`
// that fills the 64-row x 128-byte chunk kc of rows row0.. into dst (row
// stride kStride) with all kThreads threads of the block, either with
// cp.async (completed by the ring's wait) or with plain shared stores.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace xmca {
namespace tri {

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

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// G (n_pad, n_pad) f32 over n_chunks contraction chunks.
template <bool kInt8, class Loader>
__global__ void __launch_bounds__(kThreads)
tri_gram_kernel(Loader load, float* __restrict__ G, int n_pad,
                int n_chunks) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  __shared__ __align__(16) uint8_t smem[2][2][kTileBytes];

  // lower-triangle tile t -> (ti, tj), tj <= ti
  const int t = blockIdx.x;
  int ti = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  while (ti * (ti + 1) / 2 > t) --ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int rowA = ti * kTile, rowB = tj * kTile;
  const bool diag = (ti == tj);

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

  load(smem[0][0], rowA, 0);
  if (!diag) load(smem[0][1], rowB, 0);
  cp_async_commit();

  for (int kc = 0; kc < n_chunks; ++kc) {
    const int cur = kc & 1;
    if (kc + 1 < n_chunks) {
      load(smem[cur ^ 1][0], rowA, kc + 1);
      if (!diag) load(smem[cur ^ 1][1], rowB, kc + 1);
    }
    cp_async_commit();      // possibly empty: keeps the group count fixed
    cp_async_wait1();
    __syncthreads();

    const uint8_t* As = smem[cur][0];
    const uint8_t* Bs = diag ? As : smem[cur][1];
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

// Lower-triangle tiles of an (n_pad, n_pad) Gram, n_pad % kTile == 0.
inline int tile_count(int n_pad) {
  const int nb = n_pad / kTile;
  return nb * (nb + 1) / 2;
}

}  // namespace tri
}  // namespace xmca
