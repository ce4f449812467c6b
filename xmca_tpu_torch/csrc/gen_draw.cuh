// The generated surrogate family shared by surrogate_field (K5),
// surrogate_gram (K3) and surrogate_project (K4).
//
// Layout: element (row, col) of the field drawn from `seed` is output word
// col % 4 of Philox4x32-10 at counter (row, col / 4, 0, 0) under key
// (seed, kGenStream).  Each element's word depends only on (seed, row,
// col), never on a block or tile size, so any kernel regenerates exactly
// what another drew, whatever its launch geometry.  The stream id keeps
// this family apart from the +-1 draw of sign_field.cu (stream 0).
//
// The map of one word w (xmca_tpu/ops/surrogate.py:_bits_to_draw):
//   normal32     (popcount(w) - 16) / sqrt(8), f32, rounded to bf16 (RNE)
//   normal16     (popcount(w & 0xFFFF) - 8) / 2
//   rademacher   w & 1 ? +1 : -1 (bf16); rademacher8: the same, as int8
// Every value is exact in bf16.  xmca_tpu_torch/ops/surrogate.py holds the
// same layout and map in plain PyTorch (words_reference, bits_to_draw).
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include "philox.cuh"

namespace xmca {

constexpr uint32_t kGenStream = 1u;
// dist ids, in the order of ops/surrogate.py:GEN_DISTS
constexpr int kNormal32 = 0, kNormal16 = 1, kRademacher = 2,
              kRademacher8 = 3;
constexpr float kInvSqrt8 = 0.3535533905932738f;

// The words of elements (row, 4 col4 .. 4 col4 + 3).
__device__ __forceinline__ uint4 gen_words(uint32_t seed, int row,
                                           int col4) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(row),
                                  static_cast<uint32_t>(col4), 0u, 0u),
                       seed, kGenStream);
}

// The value of one word before its rounding to bf16: normal32's f32
// product, which bf16 then rounds once; the other maps are exact.
__device__ __forceinline__ float gen_value_f32(uint32_t w, int dist) {
  if (dist == kNormal32)
    return static_cast<float>(__popc(w) - 16) * kInvSqrt8;
  if (dist == kNormal16)
    return static_cast<float>(__popc(w & 0xFFFFu) - 8) * 0.5f;
  return (w & 1u) ? 1.0f : -1.0f;
}

// The value of one word (bf16-exact, held in f32); rademacher8 gives the
// same +-1 values as rademacher.
__device__ __forceinline__ float gen_value(uint32_t w, int dist) {
  const float v = gen_value_f32(w, dist);
  return dist == kNormal32 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// The four values of one Philox call for the columns col .. col + 3;
// columns >= p are 0.
__device__ __forceinline__ void gen_values4(uint4 w, int col, int p,
                                            int dist, float (&x)[4]) {
  x[0] = col + 0 < p ? gen_value(w.x, dist) : 0.0f;
  x[1] = col + 1 < p ? gen_value(w.y, dist) : 0.0f;
  x[2] = col + 2 < p ? gen_value(w.z, dist) : 0.0f;
  x[3] = col + 3 < p ? gen_value(w.w, dist) : 0.0f;
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
      | (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
         << 16);
}

// The four values of one Philox call for the columns col .. col + 3 as
// packed bf16 (columns >= p are 0), each rounded once from gen_value_f32
// with one two-value conversion a pair: the bits of gen_values4 +
// bf16_pair in fewer instructions.
__device__ __forceinline__ uint2 gen_bf16x4(uint4 w, int col, int p,
                                            int dist) {
  float x[4] = {gen_value_f32(w.x, dist), gen_value_f32(w.y, dist),
                gen_value_f32(w.z, dist), gen_value_f32(w.w, dist)};
  if (col + 4 > p) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e >= p) x[e] = 0.0f;
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

}  // namespace xmca
