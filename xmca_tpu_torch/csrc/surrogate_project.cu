// X^T S for a regenerated surrogate field; the field is never stored.
//
// Replaces the Pallas TPU kernel xmca_tpu/ops/surrogate.py:
// surrogate_project (pallas_call at surrogate.py:259): P = X^T S (p, m)
// f32 for the (n, p) field of gen_draw.cuh and a small S (n, m) f32 that
// is rounded to bf16 first, as the TPU kernel rounds it (surrogate.py:254),
// with f32 accumulation.
//
// What bounds it on the card: generation.  At (2000, 100000) with m = 20
// it is 5e7 Philox4x32-10 calls (each element drawn once) against 8e9
// multiply-adds, which the tensor cores finish in ~0.01 ms; the only
// device-memory traffic is the (p, m) output, 8 MB.  On the FMA pipe the
// product would take the registers and issue slots the generator needs
// (4 m multiply-adds a Philox call; 155 registers a thread, one block an
// SM, in a first version), so it runs on the tensor cores.
//
// Design:
// * a block of 8 warps owns a strip of 128 columns of X (128 rows of P)
//   over all n rows, so no block shares an output with another: no
//   atomics and no cross-block pass, and P has the same bits every run;
// * per 64-row chunk the block generates the (64, 128) X tile once into
//   shared memory as bf16 (exact: every draw value is), 2 Philox calls and
//   one 16-byte store per thread and row, each value rounded once and two
//   packed by one conversion (gen_draw.cuh:gen_bf16x4), the distribution
//   a template parameter; it stages the chunk of S rounded to bf16 and
//   zero-padded to 8 NT columns, its loads issued before the generator
//   runs so their latency hides behind it;
// * warp w computes rows 16 w .. 16 w + 15 of the strip's X^T S with
//   mma.sync m16n8k16 (bf16 -> f32): the X^T operand by ldmatrix.trans
//   straight from the row-major X tile, S by ldmatrix.trans; padded
//   shared rows make both conflict-free.  A thread holds 4 NT + 4 NT
//   f32 sums (at most 32), so 3 blocks fit an SM at <= 80 registers and
//   their generators keep its issue slots busy;
// * the tensor cores' f32 sums truncate, so each chunk's 64-product sums
//   are folded into an f32 total with rounded adds (K1's finding,
//   PERF.md);
// * S has up to 32 columns a launch; the entry point launches once per 32
//   columns of a wider S.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gen_draw.cuh"

namespace {

constexpr int kCols = 128;               // columns of X per block
constexpr int kRows = 64;                // rows of X and S per chunk
constexpr int kWarps = kCols / 16;       // one m16 slab of the strip each
constexpr int kThreads = 32 * kWarps;
constexpr int kXStride = kCols + 8;      // bf16 a shared X row (272 bytes)
constexpr int kMaxM = 32;                // columns of S per launch
constexpr int kSStride = kMaxM + 8;      // bf16 a shared S row (80 bytes)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// P[:, :mb] of the block's strip for S[:, :mb] (mb <= 8 NT), the field
// of distribution kDist.
template <int NT, int kDist>
__global__ void __launch_bounds__(kThreads, 3)
project_kernel(const float* __restrict__ S, int lds, float* __restrict__ P,
               int ldp, int n, int p, int mb, uint32_t seed) {
  __shared__ __align__(16) __nv_bfloat16 xs[kRows * kXStride];
  __shared__ __align__(16) __nv_bfloat16 ss[kRows * kSStride];
  constexpr int kSPer = kRows * 8 * NT / kThreads;   // S values a thread
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * kCols;
  // generator map: thread t draws columns gc .. gc + 7 of rows gr + 16 q
  const int gc = (tid & 15) * 8, gr = tid >> 4;
  const int col = col0 + gc;
  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8
  const int mat = lane >> 3, q8 = lane & 7;
  const __nv_bfloat16* a_src =
      xs + (q8 + 8 * (mat >> 1)) * kXStride + 16 * warp + 8 * (mat & 1);
  const __nv_bfloat16* b_src = ss + (q8 + 8 * (mat & 1)) * kSStride;

  float total[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) total[t][e] = 0.0f;

  for (int r0 = 0; r0 < n; r0 += kRows) {
    // the chunk of S: loads issued before the generator runs, so their
    // latency hides behind it
    float sv[kSPer];
#pragma unroll
    for (int k = 0; k < kSPer; ++k) {
      const int i = tid + kThreads * k;
      const int r = i / (8 * NT), j = i % (8 * NT);
      sv[k] = r0 + r < n && j < mb
                  ? S[static_cast<size_t>(r0 + r) * lds + j]
                  : 0.0f;
    }
    __syncthreads();                     // the previous chunk is consumed
#pragma unroll
    for (int q = 0; q < kRows / 16; ++q) {
      const int r = gr + 16 * q, row = r0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < n && col < p) {
        const uint2 x = xmca::gen_bf16x4(xmca::gen_words(seed, row, col / 4),
                                         col, p, kDist);
        const uint2 y = xmca::gen_bf16x4(
            xmca::gen_words(seed, row, col / 4 + 1), col + 4, p, kDist);
        v = make_uint4(x.x, x.y, y.x, y.y);
      }
      *reinterpret_cast<uint4*>(xs + r * kXStride + gc) = v;
    }
#pragma unroll
    for (int k = 0; k < kSPer; ++k) {
      const int i = tid + kThreads * k;
      ss[(i / (8 * NT)) * kSStride + i % (8 * NT)] =
          __float2bfloat16_rn(sv[k]);
    }
    __syncthreads();

    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
#pragma unroll
    for (int k0 = 0; k0 < kRows; k0 += 16) {
      uint32_t a[4], b[NT][2];
      ldmatrix_x4_trans(a, a_src + k0 * kXStride);
#pragma unroll
      for (int t = 0; t < NT; ++t)
        ldmatrix_x2_trans(b[t], b_src + k0 * kSStride + 8 * t);
#pragma unroll
      for (int t = 0; t < NT; ++t) mma_bf16(acc[t], a, b[t]);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[t][e] += acc[t][e];
  }

  // thread holds rows 16 warp + lane / 4 (+ 8) and columns
  // 8 t + 2 (lane % 4) (+ 1) of the strip's P
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = col0 + 16 * warp + (lane >> 2) + 8 * (e >> 1);
      const int j = 8 * t + 2 * (lane & 3) + (e & 1);
      if (i < p && j < mb) P[static_cast<size_t>(i) * ldp + j] = total[t][e];
    }
}

template <int NT>
void launch(const float* S, int lds, float* P, int ldp, int n, int p,
            int mb, uint32_t seed, int dist, cudaStream_t s) {
  const int blocks = (p + kCols - 1) / kCols;
  if (dist == xmca::kNormal32) {
    project_kernel<NT, xmca::kNormal32><<<blocks, kThreads, 0, s>>>(
        S, lds, P, ldp, n, p, mb, seed);
  } else if (dist == xmca::kNormal16) {
    project_kernel<NT, xmca::kNormal16><<<blocks, kThreads, 0, s>>>(
        S, lds, P, ldp, n, p, mb, seed);
  } else {   // rademacher and rademacher8: the same +-1 values
    project_kernel<NT, xmca::kRademacher><<<blocks, kThreads, 0, s>>>(
        S, lds, P, ldp, n, p, mb, seed);
  }
}

}  // namespace

// P (p, m) f32 <- X^T bf16(S) for S (n, m) f32, both row-major and
// contiguous, X the generated (n, p) field of `seed` (dist id as in
// gen_draw.cuh).  Returns the first CUDA error of the launches.
extern "C" int xmca_surrogate_project(const void* S, void* P, int n, int p,
                                      int m, unsigned seed, int dist,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Sf = static_cast<const float*>(S);
  float* Pf = static_cast<float*>(P);
  for (int j0 = 0; j0 < m; j0 += kMaxM) {
    const int mb = m - j0 < kMaxM ? m - j0 : kMaxM;
    switch ((mb + 7) / 8) {
      case 1: launch<1>(Sf + j0, m, Pf + j0, m, n, p, mb, seed, dist, s); break;
      case 2: launch<2>(Sf + j0, m, Pf + j0, m, n, p, mb, seed, dist, s); break;
      case 3: launch<3>(Sf + j0, m, Pf + j0, m, n, p, mb, seed, dist, s); break;
      default: launch<4>(Sf + j0, m, Pf + j0, m, n, p, mb, seed, dist, s);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
