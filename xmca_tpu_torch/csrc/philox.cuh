// Philox4x32-10 (Salmon et al. 2011, "Parallel random numbers: as easy
// as 1, 2, 3"), the one device generator of every draw kernel.
//
// Counter-based: the four output words depend only on (counter, key), so
// any thread can draw any element and a kernel can regenerate what
// another drew.  The second key word names the draw family (stream id),
// so two families never share bits.
// xmca_tpu_torch/ops/surrogate.py:philox4x32_10 is the same function in
// plain PyTorch; its known-answer vectors are Random123's.
#pragma once
#include <stdint.h>

namespace xmca {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return c;
}

}  // namespace xmca
