// The Rule-N back-projection of a padded +-1 surrogate field:
// out (p, m) f32 = (X^T S)[:p] for X (n, ld) int8 and S (n, m) f32.
//
// Replaces no TPU kernel: the JAX package writes the product as one
// contraction of the int8 field cast to f32 (xmca_tpu/core/fastpath.py:
// 988-993), and XLA fuses the convert into the contraction's operand read,
// so no f32 copy of the field exists there.  The port's plain version
// (xmca_tpu_torch/core/fastpath.py:_pm1_project_plain) casts the field to
// f32 in 1 GiB column blocks and multiplies each block with torch: on the
// card that writes and reads back 4 bytes a field element.  It stays the
// CPU's path and this kernel's reference.
//
// What bounds it on the card: the f32 multiply-adds.  At the main path's
// (2048, 1038336) field and m = 20 the product is 2048 x 1038240 x 20
// multiply-adds, 1.27 ms at 67 TFLOP/s (no tensor core: the sums stay
// f32), against 2.13 GB of int8 read once, 0.64 ms at 3.35 TB/s; at
// m = 10 the two bounds meet.  Each product +-1 * S[r, j] is exact in f32;
// only the order of the sums differs from a GEMM's.
//
// Design:
// * a block of kThreads threads owns kTile = kThreads * kCols columns and
//   walks every row of the field; thread t sums columns kCols t .. kCols t
//   + kCols - 1 of the tile.  Each column's sums live in one thread, in
//   one order: no atomics and no split across blocks, so the result is the
//   same on every launch.  Columns >= p are neither read nor written.
// * the field and S reach shared memory through a ring of kStages stages
//   of kStageRows rows (cp.async: 16-byte copies of the field, bypassing
//   L1, and 4-byte copies of S, zero-filled beyond n rows and beyond the
//   launch's columns), kStages - 1 stages ahead of the rows being summed.
//   A first version read the field straight into registers, 8 rows ahead,
//   and waited on memory: at (2048, 1038336) it took 3.25 ms at m = 20 and
//   2.42 ms at m = 10, this ring 2.60 / 1.38 ms (one run of both on an
//   NVIDIA H100 80GB HBM3).
// * each field element is converted to f32 once, in registers, and feeds
//   MT multiply-adds; a row of S is read as broadcast 16-byte loads.
// * two-level sums: each chunk of kRows rows is summed into fresh partial
//   sums, which are added into the totals; a single running f32 sum over
//   thousands of rows would drift by ~1e-6 of the result.
// * MT, the S columns a launch holds (kCols x MT partial sums and as many
//   totals a thread), is a template parameter: 20 for the complexified
//   runs ([Re, Im] of 10 modes) and 10 for the real ones.  The wrapper
//   (ops/project.py) covers any other m with several launches, each over
//   a tile of S's columns starting at j0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;            // threads a block
constexpr int kCols = 4;                 // columns a thread: one int a row
constexpr int kTile = kThreads * kCols;  // columns a block
constexpr int kStageRows = 32;           // rows a stage of the ring
constexpr int kStages = 4;               // stages of the ring
constexpr int kRows = 128;               // rows a partial sum
static_assert(kRows % kStageRows == 0, "a partial sum ends on a stage");

__device__ __forceinline__ void copy4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every copy but those of the newest kStages - 2 groups has landed
__device__ __forceinline__ void wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// floats a staged row of S: MT rounded up to whole 16-byte loads
template <int MT>
__host__ __device__ constexpr int width() {
  return (MT + 3) / 4 * 4;
}

template <int MT>
__host__ __device__ constexpr int stage_bytes() {
  return kStageRows * (kTile + 4 * width<MT>());
}

// stage s (rows kStageRows s ..) into its slot of the ring: the tile's
// columns of the field (zero at rows >= n and columns >= p), then S's
// columns [j0, j0 + MT) (zero at rows >= n and where j0 + j >= m)
template <int MT>
__device__ __forceinline__ void stage(unsigned char* ring, int s,
                                      const int8_t* X, int ld, int n, int p,
                                      int tile0, const float* S, int m,
                                      int j0) {
  constexpr int W = width<MT>();
  constexpr int kPieces = kTile / 16;     // 16-byte pieces a row
  unsigned char* slot = ring + (s % kStages) * stage_bytes<MT>();
  float* srows = reinterpret_cast<float*>(slot + kStageRows * kTile);
  const int r0 = s * kStageRows;
  for (int e = threadIdx.x; e < kStageRows * kPieces; e += kThreads) {
    const int r = r0 + e / kPieces;
    const int c = tile0 + (e % kPieces) * 16;
    const bool ok = r < n && c < p;
    copy16(slot + (e / kPieces) * kTile + (e % kPieces) * 16,
           ok ? X + static_cast<size_t>(r) * ld + c : X, ok);
  }
  for (int e = threadIdx.x; e < kStageRows * W; e += kThreads) {
    const int r = r0 + e / W;
    const int j = e % W;
    const bool ok = r < n && j < MT && j0 + j < m;
    copy4(srows + e, ok ? S + static_cast<size_t>(r) * m + j0 + j : S, ok);
  }
}

// acc[i][j] += X[r, c0 + i] * S[r, j0 + j] for one row: x4 holds the
// row's kCols int8 elements, srow the row of S
template <int MT>
__device__ __forceinline__ void add_row(float (&acc)[kCols][MT], int x4,
                                        const float* srow) {
  float x[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    x[i] = static_cast<float>(static_cast<int8_t>(x4 >> (8 * i)));
#pragma unroll
  for (int q = 0; q < width<MT>() / 4; ++q) {
    const float4 s4 = reinterpret_cast<const float4*>(srow)[q];
    const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (4 * q + t < MT) {
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          acc[i][4 * q + t] = fmaf(x[i], s[t], acc[i][4 * q + t]);
      }
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 2)
pm1_project_kernel(const int8_t* __restrict__ X, int ld, int n, int p,
                   const float* __restrict__ S, int m, int j0,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int tile0 = blockIdx.x * kTile;
  const int c0 = tile0 + threadIdx.x * kCols;
  const int stages = (n + kStageRows - 1) / kStageRows;

  float tot[kCols][MT];
  float acc[kCols][MT];
#pragma unroll
  for (int i = 0; i < kCols; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) tot[i][j] = acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) stage<MT>(ring, s, X, ld, n, p, tile0, S, m, j0);
    commit();
  }
  for (int s = 0; s < stages; ++s) {
    // stage s has landed for every thread, and every thread is done with
    // the slot that stage s + kStages - 1 overwrites (stage s - 1's)
    wait_ring();
    __syncthreads();
    if (s + kStages - 1 < stages)
      stage<MT>(ring, s + kStages - 1, X, ld, n, p, tile0, S, m, j0);
    commit();
    const unsigned char* slot = ring + (s % kStages) * stage_bytes<MT>();
    const float* srows =
        reinterpret_cast<const float*>(slot + kStageRows * kTile);
#pragma unroll 8
    for (int u = 0; u < kStageRows; ++u)
      add_row<MT>(acc,
                  *reinterpret_cast<const int*>(slot + u * kTile +
                                                threadIdx.x * kCols),
                  srows + u * width<MT>());
    if ((s + 1) % (kRows / kStageRows) == 0 || s + 1 == stages) {
#pragma unroll
      for (int i = 0; i < kCols; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          tot[i][j] += acc[i][j];
          acc[i][j] = 0.f;
        }
    }
  }

  if (c0 >= p) return;
  if (MT == m && j0 == 0 && c0 + kCols <= p) {
    // the thread's kCols rows of out are kCols * MT contiguous floats,
    // 16-byte aligned (c0 is a multiple of 4): 16-byte stores, 2.7% faster
    // than one float at a time at (2048, 1038336) and m = 20
    float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(c0) *
                                                      MT);
#pragma unroll
    for (int v = 0; v < kCols * MT / 4; ++v) {
      const int a = 4 * v;
      dst[v] = make_float4(tot[(a + 0) / MT][(a + 0) % MT],
                           tot[(a + 1) / MT][(a + 1) % MT],
                           tot[(a + 2) / MT][(a + 2) % MT],
                           tot[(a + 3) / MT][(a + 3) % MT]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    if (c0 + i >= p) break;
#pragma unroll
    for (int j = 0; j < MT; ++j)
      if (j0 + j < m) out[static_cast<size_t>(c0 + i) * m + j0 + j] =
          tot[i][j];
  }
}

template <int MT>
int launch(const int8_t* X, int ld, int n, int p, const float* S, int m,
           int j0, float* out, cudaStream_t s) {
  const int bytes = kStages * stage_bytes<MT>();
  cudaError_t err = cudaFuncSetAttribute(
      pm1_project_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (p + kTile - 1) / kTile;
  pm1_project_kernel<MT><<<blocks, kThreads, bytes, s>>>(X, ld, n, p, S, m,
                                                         j0, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X (n, ld) int8 and S (n, m) f32, both contiguous, X 16-byte aligned and
// ld % 16 == 0; 1 <= p <= ld.  Writes out[:, j0:j0 + mt] of out (p, m)
// f32 (contiguous): columns j0 .. min(j0 + mt, m) - 1 of X[:, :p]^T S.
// mt is 20 or 10.  Returns cudaGetLastError() after the launch.
extern "C" int xmca_pm1_project(const void* X, int ld, int n, int p,
                                const void* S, int m, int j0, int mt,
                                void* out, void* stream) {
  if (n < 1 || p < 1 || ld < p || ld % 16 != 0 || m < 1 || j0 < 0 ||
      j0 >= m || (mt != 20 && mt != 10))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* x = static_cast<const int8_t*>(X);
  const float* s_ = static_cast<const float*>(S);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mt == 20 ? launch<20>(x, ld, n, p, s_, m, j0, o, s)
                  : launch<10>(x, ld, n, p, s_, m, j0, o, s);
}
