// Symmetric rank-k update G = X X^T for Hopper (sm_90a), int8 or bf16:
// a persistent, warp-specialised wgmma kernel fed by TMA.
//
// Replaces the Pallas TPU kernel xmca_tpu/ops/syrk.py:syrk (pallas_call
// at syrk.py:95): the temporal Gram of every Rule-N surrogate field.
//
// What bounds it on the card: at the main path's shape X is (2048,
// 100096), 205 MB of int8 (410 MB of bf16), and the lower triangle is
// 2048*2049/2 * 100096 * 2 = 4.2e11 operations: 0.21 ms at the 1979
// TOP/s int8 peak (0.43 ms at 989 TFLOP/s bf16) against 0.07 ms (0.13
// ms) to read X once, so the tensor cores bound it.  They reach their
// rate only through wgmma, and every tile streams two row panels of X
// through shared memory, so the tile size sets how many bytes L2 and
// shared memory move per operation (64x64 mma.sync tiles: 6.8 GB of
// L2 traffic per Gram).
//
// Design:
// * 128x128 lower-triangle output tiles (136 at n_pad = 2048), half the
//   panel traffic of 64x64 tiles; a diagonal tile loads one panel.
// * one producer warp keeps TMA loads of 128-row x 128-byte boxes (64
//   bf16 or 128 int8 values along the contraction, 128-byte swizzle)
//   in flight into a 6-stage ring of A/B panel pairs, tracked by full/empty
//   mbarriers; two consumer warpgroups each run wgmma m64n128 (k16 bf16
//   -> f32, k32 s8 -> s32) on their 64 rows, with both operands K-major
//   straight from the swizzled shared tiles.
// * persistent blocks, one per SM: whole waves of tiles first; the
//   tiles left after the last whole wave (4 of 136 at n_pad = 2048) are
//   split along the contraction over all blocks, so the last wave does
//   not leave 128 SMs idle.  Pieces go to a workspace the wrapper
//   allocates and a second kernel sums them in a fixed order; the
//   schedule is computed in ops/syrk.py:schedule.
// * X is far larger than the 50 MB L2 (205 MB at n_pad = 2048, 1.47 GB
//   at 14720; a 128-row panel is 12.8 MB), so a panel slice comes from
//   L2 only if the other tiles that read it ask for it at about the same
//   contraction step.  In one wave they start together; from two whole
//   waves on (n_pad >= 2944) two things keep them together:
//   - the tile order is a table the kernel reads (ops/syrk.py:
//     tile_order): bands of ~sqrt(132) = 11 tile rows walked column by
//     column, so a wave of 132 tiles reads ~24 row panels, not up to
//     all of them (115 at n_pad = 14720 in row-major order);
//   - a wave barrier: a block's producer waits for every block before it
//     loads its next whole tile.  Without it the blocks drift apart
//     along the contraction, the tiles stream their panels from HBM
//     about as if there were no L2, and the order alone changes nothing
//     (on an H100 SXM at 700 W, n_pad = 14720 int8: ~46 ms without the
//     barrier, ~18 ms with it, ~42 ms in row-major order without it;
//     PERF.md).  The barrier costs the wave's spread, not a pipeline
//     drain: the consumers still finish the previous tile meanwhile.
// * one wgmma group stays in flight while the next block's is queued.
//   int8 sums stay in s32 registers (exact).  bf16 partial sums restart
//   from zero every kFoldBlocks blocks (256 products) and are folded into
//   a separate f32 total with rounded adds, because the tensor cores' f32
//   accumulate truncates: a one-sided drift of 5.1e-4 of max|G| at full
//   width without a fold, ~1.7e-5 with this one (PERF.md).
// * every value is written to G[i, j] and G[j, i], so G is exactly
//   symmetric, and no atomic touches G (the wave counter is the only
//   one), so every run gives the same bits.
// * an accumulate mode (syrk.cuh) for surrogate_gram.cu, which runs this
//   kernel once per generated column chunk of one field: the lower
//   triangle adds its value to what G holds (each element has one owner,
//   so no atomics) and the mirror is written by the last chunk only.  The
//   chunks run in order on one stream, so the sum over chunks has a fixed
//   order: the same bits on every run, and G exactly symmetric.
#include "syrk.cuh"

#include <dlfcn.h>

#include <type_traits>

namespace {

using xmca::SyrkSched;

constexpr int kTile = 128;                       // output tile rows == cols
constexpr int kBlockBytes = 128;                 // contraction bytes a stage
constexpr int kStages = 6;
constexpr int kPanelBytes = kTile * kBlockBytes; // one 128-row box: 16 KB
constexpr int kStageBytes = 2 * kPanelBytes;     // A panel + B panel
constexpr int kConsumers = 256;                  // two warpgroups
constexpr int kThreads = kConsumers + 32;        // + the producer warp
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
constexpr int kTileElems = kTile * kTile;
// bf16: contraction blocks per chunk folded into the f32 total (each
// fold waits for the wgmma queue to drain)
constexpr int kFoldBlocks = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Spins until the phase of parity `parity` has completed.  A wait that
// lasts ~2 s (a lost TMA transaction or a phase mix-up) traps, so a
// fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 32)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// One TMA box (128 rows x 128 bytes) at element (c0 along the
// contraction, c1 rows) into dst; completes `bytes` on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows in
// the 128-byte swizzle TMA wrote: start address >> 4, leading byte
// offset 16 (unused by swizzled K-major tiles), stride byte offset 1024
// (one 8-row swizzle atom), layout type 1 (128B swizzle).  The tile is
// 1024-byte aligned; the k-th 32-byte step along the row adds 2*k.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators above the
// wgmma_wait that completes them.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (+)= A B^T for a 64-row A and a 128-row B, both K-major, one 32-byte
// contraction step; scale_d = 0 starts from zero.  Thread t of the
// warpgroup holds d[4j + e] at row 16*(t/32) + (t%32)/4 + 8*(e/2),
// column 8*j + 2*(t%4) + e%2.
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Tile t of the schedule -> (ti, tj), tj <= ti: entry t of the order.
__device__ __forceinline__ void tile_of(const SyrkSched& s, int t, int& ti,
                                        int& tj) {
  const int2 c = s.order[t];
  ti = c.x;
  tj = c.y;
}

// Wave barrier u: the block's arrival makes the counter reach u * grid
// once every block has arrived u times.  Like mbar_wait it traps rather
// than hang, after ~2 s plus ~2 us a contraction block (a tile's time).
__device__ __forceinline__ void wave_wait(const SyrkSched& s, unsigned u) {
  asm volatile("red.release.gpu.add.u32 [%0], 1;\n"
               :: "l"(s.waves) : "memory");
  const unsigned target = u * gridDim.x;
  const long long limit = (1ll << 32) + 4096ll * s.kblocks;
  long long start = 0;
  while (true) {
    unsigned v;
    asm volatile("ld.acquire.gpu.u32 %0, [%1];\n"
                 : "=r"(v) : "l"(s.waves) : "memory");
    if (v >= target) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > limit) {
      __trap();
    }
  }
}

// Work unit u of this block (ops/syrk.py:work_units): contraction blocks
// [k0, k1) of tile t; slot >= 0 is the workspace tile of a split piece.
struct Unit {
  int t, k0, k1, slot;
};

__device__ __forceinline__ int unit_count(const SyrkSched& s) {
  const int b = blockIdx.x, g = gridDim.x;
  const int whole = b < s.dp_tiles ? (s.dp_tiles - b + g - 1) / g : 0;
  return whole + (b < s.split_tiles * s.splits ? 1 : 0);
}

__device__ __forceinline__ Unit unit_of(const SyrkSched& s, int u) {
  const int b = blockIdx.x;
  if (b + u * static_cast<int>(gridDim.x) < s.dp_tiles) {
    return {b + u * static_cast<int>(gridDim.x), 0, s.kblocks, -1};
  }
  const int i = b % s.splits;
  return {s.dp_tiles + b / s.splits, i * s.kblocks / s.splits,
          (i + 1) * s.kblocks / s.splits, b};
}

// kAccumulate: the epilogue of surrogate_gram.cu's chunks (s.accumulate,
// s.mirror); without it the main path's store-and-mirror.
template <bool kInt8, bool kAccumulate>
__global__ void __launch_bounds__(kThreads, 1)
syrk_kernel(const __grid_constant__ CUtensorMap xmap, float* __restrict__ G,
            uint32_t* __restrict__ work, const SyrkSched s) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_units = unit_count(s);

  if (threadIdx.x >= kConsumers) {
    // producer: one thread keeps the ring full across all units
    if (threadIdx.x != kConsumers) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = 0; u < n_units; ++u) {
      const Unit w = unit_of(s, u);
      if (s.waves != nullptr && u > 0 && w.slot < 0) wave_wait(s, u);
      int ti, tj;
      tile_of(s, w.t, ti, tj);
      const bool diag = ti == tj;
      for (int kb = w.k0; kb < w.k1; ++kb) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* a = smem + stage * kStageBytes;
        mbar_expect_tx(&full[stage], diag ? kPanelBytes : kStageBytes);
        const int kc = kb * (kInt8 ? kBlockBytes : kBlockBytes / 2);
        tma_load(a, &xmap, &full[stage], kc, ti * kTile);
        if (!diag) tma_load(a + kPanelBytes, &xmap, &full[stage], kc,
                            tj * kTile);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64*wg .. 64*wg + 63 of the tile
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row0 = 64 * wg + 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  Acc acc[64];
  float total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = Acc(0);
    total[i] = 0.0f;
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int u = 0; u < n_units; ++u) {
    const Unit w = unit_of(s, u);
    int ti, tj;
    tile_of(s, w.t, ti, tj);
    const bool diag = ti == tj;
    // int8 sums the whole unit in acc; bf16 restarts acc every chunk of
    // kFoldBlocks blocks and folds it into total.  The waits sit outside
    // any data-dependent branch: ptxas serialises wgmma otherwise.
    const int chunk = kInt8 ? w.k1 - w.k0 : kFoldBlocks;
    for (int c0 = w.k0; c0 < w.k1; c0 += chunk) {
      const int c1 = min(c0 + chunk, w.k1);
      int prev = -1;   // the stage the in-flight wgmma group reads
      for (int kb = c0; kb < c1; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint8_t* a = smem + stage * kStageBytes;
        const uint64_t da = desc_sw128(a + wg * 64 * kBlockBytes);
        const uint64_t db = desc_sw128(diag ? a : a + kPanelBytes);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBlockBytes / 32; ++k) {
          wgmma(acc, da + 2 * k, db + 2 * k, kb > c0 || k > 0);
        }
        wgmma_commit();
        // keep one group in flight; release the stage it has finished
        wgmma_wait<1>();
        if (prev >= 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[prev]);
      if constexpr (!kInt8) {
#pragma unroll
        for (int i = 0; i < 64; ++i) total[i] += acc[i];
      }
    }

    // epilogue: a whole tile goes to G and its mirror (kAccumulate: added
    // to G; the mirror written in mirror mode only), a piece to its
    // workspace tile (raw s32 or f32 bits)
    if constexpr (kAccumulate) {
      if constexpr (kInt8) {
#pragma unroll
        for (int i = 0; i < 64; ++i) total[i] = static_cast<float>(acc[i]);
      }
      if (w.slot < 0 && s.accumulate) {
        // every load before the first store, so their latencies overlap
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = row0 + 8 * ((i >> 1) & 1);
          const int c = col0 + 8 * (i >> 2) + (i & 1);
          if (!diag || c <= r) {
            total[i] += G[(static_cast<size_t>(ti) * kTile + r) * s.n_pad +
                          static_cast<size_t>(tj) * kTile + c];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = row0 + 8 * ((i >> 1) & 1);
      const int c = col0 + 8 * (i >> 2) + (i & 1);
      float v;
      uint32_t bits;
      if constexpr (kInt8) {
        v = kAccumulate ? total[i] : static_cast<float>(acc[i]);
        bits = static_cast<uint32_t>(acc[i]);
      } else {
        v = total[i];
        bits = __float_as_uint(total[i]);
        total[i] = 0.0f;
      }
      if (w.slot >= 0) {
        work[static_cast<size_t>(w.slot) * kTileElems + r * kTile + c] = bits;
      } else if (!diag || c <= r) {
        const size_t gr = static_cast<size_t>(ti) * kTile + r;
        const size_t gc = static_cast<size_t>(tj) * kTile + c;
        G[gr * s.n_pad + gc] = v;
        if (!kAccumulate || s.mirror) G[gc * s.n_pad + gr] = v;
      }
    }
  }
}

// Sums the `splits` pieces of each split tile in order 0, 1, ... and
// stores (or adds) the tile and, in mirror mode, its mirror; one thread
// per element.
template <bool kInt8>
__global__ void __launch_bounds__(256)
split_sum_kernel(const uint32_t* __restrict__ work, float* __restrict__ G,
                 const SyrkSched s) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = e / kTile, c = e % kTile;
  int ti, tj;
  tile_of(s, s.dp_tiles + blockIdx.y, ti, tj);
  if (ti == tj && c > r) return;
  const uint32_t* p =
      work + static_cast<size_t>(blockIdx.y) * s.splits * kTileElems + e;
  float v;
  if constexpr (kInt8) {
    int sum = 0;
    for (int i = 0; i < s.splits; ++i)
      sum += static_cast<int>(p[i * kTileElems]);
    v = static_cast<float>(sum);
  } else {
    float sum = 0.0f;
    for (int i = 0; i < s.splits; ++i)
      sum += __uint_as_float(p[i * kTileElems]);
    v = sum;
  }
  const size_t gr = static_cast<size_t>(ti) * kTile + r;
  const size_t gc = static_cast<size_t>(tj) * kTile + c;
  if (s.accumulate) v += G[gr * s.n_pad + gc];
  G[gr * s.n_pad + gc] = v;
  if (s.mirror) G[gc * s.n_pad + gr] = v;
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has already
// loaded (so no -lcuda is needed at link time).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    if (lib != nullptr) {
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
    }
  }
  return fn;
}

template <bool kInt8, bool kAccumulate>
int launch(const CUtensorMap& map, float* G, uint32_t* work,
           const SyrkSched& s, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      syrk_kernel<kInt8, kAccumulate>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s.waves != nullptr) {
    err = cudaMemsetAsync(s.waves, 0, sizeof(unsigned), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the wave barrier needs every block resident: a cooperative launch
  // guarantees it or fails
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = s.waves != nullptr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, syrk_kernel<kInt8, kAccumulate>, map, G,
                           work, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || s.split_tiles == 0) return static_cast<int>(err);
  split_sum_kernel<kInt8><<<dim3(kTileElems / 256, s.split_tiles), 256, 0,
                            stream>>>(work, G, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace xmca {

int syrk_tensor_map(CUtensorMap* map, const void* X, int n_pad, int ld,
                    int is_int8) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) {
    return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  }
  const int elem = is_int8 ? 1 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ld),
                              static_cast<cuuint64_t>(n_pad)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBlockBytes / elem),
                             static_cast<cuuint32_t>(kTile)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map, is_int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(X), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return static_cast<int>(res == CUDA_SUCCESS ? cudaSuccess
                                              : cudaErrorInvalidValue);
}

int syrk_launch(const CUtensorMap& map, float* G, uint32_t* work,
                const SyrkSched& s, int grid, int is_int8,
                cudaStream_t stream) {
  // the main path's launch (store and mirror) runs the kernel without the
  // accumulate epilogue, whose code it does not need
  const bool store = !s.accumulate && s.mirror;
  if (is_int8) {
    return store ? launch<true, false>(map, G, work, s, grid, stream)
                 : launch<true, true>(map, G, work, s, grid, stream);
  }
  return store ? launch<false, false>(map, G, work, s, grid, stream)
               : launch<false, true>(map, G, work, s, grid, stream);
}

}  // namespace xmca

// Dynamic shared memory of the syrk kernel (bytes).
extern "C" int xmca_syrk_smem_bytes() { return kSmemBytes; }

// G (n_pad, n_pad) f32 <- X X^T for X (n_pad, p_pad) int8 (is_int8=1) or
// bf16 (is_int8=0), row-major and contiguous, on the schedule of
// ops/syrk.py:schedule (kblocks, grid, dp_tiles, split_tiles, splits);
// order holds ops/syrk.py:tile_order as int32 (tile row, tile column)
// pairs on the card; waves is 4 bytes on the card for the wave barrier,
// or nullptr for none; work holds split_tiles * splits tiles of 128 x 128
// 4-byte values.  The caller guarantees n_pad % 128 == 0, p_pad % 128 ==
// 0, a 16-byte aligned X and (int8) no int32 overflow.  Returns a
// cudaError_t: the launch's, or cudaErrorSharedObjectSymbolNotFound /
// cudaErrorInvalidValue when the tensor map cannot be made.
extern "C" int xmca_syrk(const void* X, void* G, void* work,
                         const void* order, void* waves, int n_pad, int p_pad,
                         int is_int8, int kblocks, int grid, int dp_tiles,
                         int split_tiles, int splits, void* stream) {
  CUtensorMap map;
  const int err = xmca::syrk_tensor_map(&map, X, n_pad, p_pad, is_int8);
  if (err != 0) return err;
  const SyrkSched s{n_pad, kblocks, dp_tiles, split_tiles, splits, 0, 1,
                    static_cast<const int2*>(order),
                    static_cast<unsigned*>(waves)};
  return xmca::syrk_launch(map, static_cast<float*>(G),
                           static_cast<uint32_t*>(work), s, grid, is_int8,
                           static_cast<cudaStream_t>(stream));
}
