// One sweep of the theta method's simple exponential smoothing (SES) over
// every series of a (T, p) field, at every smoothing parameter of a grid,
// with the SSE-least grid point of each series chosen in the same launch.
//
// Replaces no TPU kernel: the JAX package runs the sweep as a lax.scan
// (xmca_tpu/core/theta.py:_ses_sweep) that XLA compiles into one loop.
// The port's plain version (xmca_tpu_torch/core/theta.py:_ses_sweep), a
// Python loop of six float64 elementwise launches a step over a (G, p)
// state, stays the CPU's path and this kernel's reference.
//
// The recursion, for a series y and a smoothing parameter a (keep = 1 - a),
// from part = 0, h = 1 and zero sums:
//     c = y_t - part;  s_cc += c c;  s_hc += h c;  s_h2 += h h;
//     part += a c;     h *= keep
// then l0 = s_hc / s_h2, sse = s_cc - s_hc^2 / s_h2, l_T = part + h l0.
// Every operation rounds as the plain version's does on the card: each
// "s += x y" is one fused multiply-add, as PyTorch's addcmul_ rounds there
// (measured on an H100, torch 2.11 with CUDA 12.8: its results are the
// correctly rounded x y + s), and every other product, sum and quotient is
// rounded on its own, written with __dmul_rn / __dadd_rn / __ddiv_rn so that
// nvcc contracts nothing else.  So the chosen grid points, and alpha, are
// those of the plain version bit for bit, also where SSEs tie at roundoff
// (a constant series).
//
// What bounds it on the card: the float64 instruction rate.  A (step, grid
// point, series) update is 4 float64 instructions (a subtraction, three
// FMAs), and each thread's own h and s_h2 add 2 a (step, grid point): 6 a
// thread's grid point and step, against the 64 float64 lanes of each of
// 132 SMs.  The series is read once from device memory (4 T p bytes for
// float32).
//
// Design: a block holds kCols = 32 series and all G grid points of each,
// cut into ceil(G / K) warps of K = 6 points (threadIdx.y); every state of a
// (series, grid point) lives in registers through the T steps, so no
// (G, p) state reaches device memory.  Lanes run along the series, so a
// warp's read of step t is one 128-byte line; the block's other warps
// read the same line from L1.  The next kAhead steps are loaded while the
// current ones are computed.  At the end each thread takes the first
// SSE-least point of its slice, and warp 0 takes the first over the
// slices in order (torch.argmin's rule: NaN before any number, ties to
// the lower index), then writes the point's index, alpha and l_T.
//
// Grids: `alphas` (G,) shared by every series; or, given best_in (p,)
// and offsets (G,), series c's points are clamp(alphas[best_in[c]] +
// offsets[j], lo, hi), formed as the plain version forms them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;        // series a block, one a lane
constexpr int kAhead = 4;        // steps of the series loaded ahead
constexpr int K = 6;             // grid points a warp (112 registers)
constexpr int kMaxSlices = 8;    // warps a block: G <= 8 K = 48

// s + x y, rounded once
__device__ __forceinline__ double acc(double s, double x, double y) {
  return __fma_rn(x, y, s);
}

// v before best in torch.argmin's order, for v at a higher index
__device__ __forceinline__ bool before(double v, double best) {
  return isnan(v) ? !isnan(best) : v < best;
}

template <typename In>
__global__ void __launch_bounds__(kCols * kMaxSlices)
ses_kernel(const In* __restrict__ y, int T, int p,
           const double* __restrict__ alphas, int G,
           const long long* __restrict__ best_in,
           const double* __restrict__ offsets, double lo, double hi,
           long long* __restrict__ best_out, double* __restrict__ alpha_out,
           double* __restrict__ level_out, double* __restrict__ sse_all,
           double* __restrict__ level_all) {
  const int lane = threadIdx.x;
  const int slice = threadIdx.y;
  const int col = blockIdx.x * kCols + lane;
  const bool live = col < p;
  const int c = live ? col : p - 1;       // dead lanes sweep a live series
  const int g0 = slice * K;

  double a[K], keep[K], part[K], h[K], s_cc[K], s_hc[K], s_h2[K];
  const double base = best_in ? alphas[best_in[c]] : 0.0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    // points past G repeat the last one and are never reported
    const int g = g0 + j < G ? g0 + j : G - 1;
    a[j] = best_in ? fmin(fmax(__dadd_rn(base, offsets[g]), lo), hi)
                   : alphas[g];
    keep[j] = __dsub_rn(1.0, a[j]);
    part[j] = 0.0;
    h[j] = 1.0;
    s_cc[j] = 0.0;
    s_hc[j] = 0.0;
    s_h2[j] = 0.0;
  }

  const In* yc = y + c;
  const size_t stride = static_cast<size_t>(p);
  In cur[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k)
    cur[k] = k < T ? yc[k * stride] : In(0);
  for (int t0 = 0; t0 < T; t0 += kAhead) {
    In nxt[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int t = t0 + kAhead + k;
      nxt[k] = t < T ? yc[t * stride] : In(0);
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (t0 + k < T) {
        const double yt = static_cast<double>(cur[k]);
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const double r = __dsub_rn(yt, part[j]);
          s_cc[j] = acc(s_cc[j], r, r);
          s_hc[j] = acc(s_hc[j], h[j], r);
          s_h2[j] = acc(s_h2[j], h[j], h[j]);
          part[j] = acc(part[j], a[j], r);
          h[j] = __dmul_rn(h[j], keep[j]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) cur[k] = nxt[k];
  }

  double best_v = 0.0, best_a = 0.0, best_l = 0.0;
  int best_g = -1;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int g = g0 + j;
    if (g < G) {
      const double l0 = __ddiv_rn(s_hc[j], s_h2[j]);
      const double sse = __dsub_rn(
          s_cc[j], __ddiv_rn(__dmul_rn(s_hc[j], s_hc[j]), s_h2[j]));
      const double level = __dadd_rn(part[j], __dmul_rn(h[j], l0));
      if (live && sse_all) {
        sse_all[g * stride + col] = sse;
        level_all[g * stride + col] = level;
      }
      if (best_g < 0 || before(sse, best_v)) {
        best_v = sse;
        best_g = g;
        best_a = a[j];
        best_l = level;
      }
    }
  }

  // the first least point over the slices, in order
  __shared__ double sv[kMaxSlices][kCols], sa[kMaxSlices][kCols],
      sl[kMaxSlices][kCols];
  __shared__ int sg[kMaxSlices][kCols];
  sv[slice][lane] = best_v;
  sa[slice][lane] = best_a;
  sl[slice][lane] = best_l;
  sg[slice][lane] = best_g;
  __syncthreads();
  if (slice != 0 || !live) return;
  for (int q = 1; q < blockDim.y; ++q) {
    if (before(sv[q][lane], best_v)) {
      best_v = sv[q][lane];
      best_a = sa[q][lane];
      best_l = sl[q][lane];
      best_g = sg[q][lane];
    }
  }
  if (best_out) best_out[col] = best_g;
  if (alpha_out) alpha_out[col] = best_a;
  if (level_out) level_out[col] = best_l;
}

template <typename In>
int launch(const void* y, int T, int p, const double* alphas, int G,
           const long long* best_in, const double* offsets, double lo,
           double hi, long long* best_out, double* alpha_out,
           double* level_out, double* sse_all, double* level_all,
           cudaStream_t s) {
  const dim3 block(kCols, (G + K - 1) / K);
  const dim3 grid((p + kCols - 1) / kCols);
  ses_kernel<In><<<grid, block, 0, s>>>(
      static_cast<const In*>(y), T, p, alphas, G, best_in, offsets, lo, hi,
      best_out, alpha_out, level_out, sse_all, level_all);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (T, p) row-major, contiguous: float32, or float64 when y_double.
// 1 <= G <= 48: ceil(G / 6) warps a block.
// Grid: alphas (G,) float64; or, with best_in (p,) int64 and offsets
// (G,) float64, clamp(alphas[best_in[c]] + offsets[j], lo, hi).
// Writes, where the pointer is not null: best_out (p,) int64, alpha_out
// and level_out (p,) float64; sse_all and level_all (G, p) float64, every
// grid point's SSE and l_T.  Returns cudaGetLastError() after the launch.
extern "C" int xmca_ses_sweep(const void* y, int y_double, int T, int p,
                              const void* alphas, int G,
                              const void* best_in, const void* offsets,
                              double lo, double hi, void* best_out,
                              void* alpha_out, void* level_out,
                              void* sse_all, void* level_all,
                              void* stream) {
  if (T < 1 || p < 1 || G < 1 || (G + K - 1) / K > kMaxSlices ||
      (best_in == nullptr) != (offsets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* al = static_cast<const double*>(alphas);
  const long long* bi = static_cast<const long long*>(best_in);
  const double* off = static_cast<const double*>(offsets);
  long long* bo = static_cast<long long*>(best_out);
  double* ao = static_cast<double*>(alpha_out);
  double* lo_ = static_cast<double*>(level_out);
  double* sa = static_cast<double*>(sse_all);
  double* la = static_cast<double*>(level_all);
  return y_double
             ? launch<double>(y, T, p, al, G, bi, off, lo, hi, bo, ao, lo_,
                              sa, la, s)
             : launch<float>(y, T, p, al, G, bi, off, lo, hi, bo, ao, lo_, sa,
                             la, s);
}
