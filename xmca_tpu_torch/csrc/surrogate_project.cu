// X^T S for a regenerated surrogate field; the field is never stored.
//
// Replaces the Pallas TPU kernel xmca_tpu/ops/surrogate.py:
// surrogate_project (pallas_call at surrogate.py:259): P = X^T S (p, m)
// f32 for the (n, p) field of gen_draw.cuh and a small S (n, m) f32 that
// is rounded to bf16 first, as the TPU kernel rounds it (surrogate.py:254),
// with f32 accumulation.  surrogate_gram.cu also runs it with S = ones
// (S == nullptr, m = 1) for the field's column sums.
//
// What bounds it on the card: generation.  At (2000, 100000) with m = 20
// it is 5e7 Philox4x32-10 calls (each element drawn once, ~3.5e9 integer
// instructions) against 8e9 f32 FLOPs on the CUDA cores; the only
// device-memory traffic is the (p, m) output, 8 MB.
//
// Design (a first, simple kernel):
// * a block of 32 x 8 threads owns a strip of 128 columns: thread (g, s)
//   draws the four columns of Philox group g for rows s, s + 8, ... and
//   multiply-adds them into 4 x MT f32 accumulators (MT = m rounded up to
//   a multiple of 4, at most 32 per launch; the entry point launches once
//   per 32 columns of S);
// * S is staged 64 rows at a time in shared memory, rounded to bf16 and
//   zero-padded; every thread of a warp reads the same row (a broadcast);
// * the 8 row slices are summed in a fixed order through shared memory
//   and the (128, m) result is written with coalesced stores: no atomics,
//   so the result is deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gen_draw.cuh"

namespace {

constexpr int kGroups = 32;            // Philox column groups per block
constexpr int kCols = 4 * kGroups;     // 128 columns per block
constexpr int kSlices = 8;             // row slices per block
constexpr int kThreads = kGroups * kSlices;
constexpr int kRowChunk = 64;          // rows of S staged at a time
constexpr int kMaxM = 32;              // columns of S per launch

template <int MT>
__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ S, int lds, float* __restrict__ P,
               int ldp, int n, int p, int mb, uint32_t seed, int dist) {
  __shared__ float s_tile[kRowChunk][MT];
  __shared__ float red[kSlices][kCols];
  __shared__ float out[kCols][MT];
  const int g = threadIdx.x, slice = threadIdx.y;
  const int tid = slice * kGroups + g;
  const int col4 = blockIdx.x * kGroups + g;
  const int col0 = blockIdx.x * kCols;

  float acc[4][MT];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int j = 0; j < MT; ++j) acc[c][j] = 0.0f;

  for (int r0 = 0; r0 < n; r0 += kRowChunk) {
    __syncthreads();                   // the previous chunk is consumed
    for (int i = tid; i < kRowChunk * MT; i += kThreads) {
      const int r = i / MT, j = i % MT;
      float v = 0.0f;
      if (r0 + r < n && j < mb)
        v = S ? __bfloat162float(__float2bfloat16_rn(
                    S[static_cast<size_t>(r0 + r) * lds + j]))
              : 1.0f;
      s_tile[r][j] = v;
    }
    __syncthreads();
    if (4 * col4 < p) {
      const int rows = min(kRowChunk, n - r0);
      for (int r = slice; r < rows; r += kSlices) {
        float x[4];
        xmca::gen_values4(xmca::gen_words(seed, r0 + r, col4), 4 * col4, p,
                          dist, x);
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const float s = s_tile[r][j];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c][j] = fmaf(x[c], s, acc[c][j]);
        }
      }
    }
  }

  // sum the row slices in a fixed order, one output column at a time
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 4; ++c) red[slice][4 * g + c] = acc[c][j];
    __syncthreads();
    if (tid < kCols) {
      float t = 0.0f;
#pragma unroll
      for (int s = 0; s < kSlices; ++s) t += red[s][tid];
      out[tid][j] = t;
    }
  }
  __syncthreads();
  for (int i = tid; i < kCols * mb; i += kThreads) {
    const int c = i / mb, j = i % mb;
    if (col0 + c < p) P[static_cast<size_t>(col0 + c) * ldp + j] = out[c][j];
  }
}

template <int MT>
void launch(const float* S, int lds, float* P, int ldp, int n, int p,
            int mb, uint32_t seed, int dist, cudaStream_t s) {
  const int blocks = (p + kCols - 1) / kCols;
  project_kernel<MT><<<blocks, dim3(kGroups, kSlices), 0, s>>>(
      S, lds, P, ldp, n, p, mb, seed, dist);
}

}  // namespace

// P (p, m) f32 <- X^T bf16(S) for S (n, m) f32, both row-major and
// contiguous, X the generated (n, p) field of `seed` (dist id as in
// gen_draw.cuh); S == nullptr stands for a column of ones (m = 1).
// Returns the first CUDA error of the launches.
extern "C" int xmca_surrogate_project(const void* S, void* P, int n, int p,
                                      int m, unsigned seed, int dist,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Sf = static_cast<const float*>(S);
  float* Pf = static_cast<float*>(P);
  for (int j0 = 0; j0 < m; j0 += kMaxM) {
    const int mb = m - j0 < kMaxM ? m - j0 : kMaxM;
    const float* Sj = Sf ? Sf + j0 : nullptr;
    switch ((mb + 3) / 4) {
      case 1: launch<4>(Sj, m, Pf + j0, m, n, p, mb, seed, dist, s); break;
      case 2: launch<8>(Sj, m, Pf + j0, m, n, p, mb, seed, dist, s); break;
      case 3: launch<12>(Sj, m, Pf + j0, m, n, p, mb, seed, dist, s); break;
      case 4: launch<16>(Sj, m, Pf + j0, m, n, p, mb, seed, dist, s); break;
      case 5: launch<20>(Sj, m, Pf + j0, m, n, p, mb, seed, dist, s); break;
      case 6: launch<24>(Sj, m, Pf + j0, m, n, p, mb, seed, dist, s); break;
      case 7: launch<28>(Sj, m, Pf + j0, m, n, p, mb, seed, dist, s); break;
      default: launch<32>(Sj, m, Pf + j0, m, n, p, mb, seed, dist, s);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
