// K1's kernel (syrk.cu) as other kernels of the library launch it:
// surrogate_gram.cu runs it once per generated column chunk, adding each
// chunk's Gram into one G.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xmca {

// One launch: the schedule of ops/syrk.py:schedule and the epilogue mode.
// accumulate = 0 stores each lower-triangle value, 1 adds it to what G
// holds; mirror = 1 also writes the value to G[j, i].  The +-1 main path
// (xmca_syrk) stores and mirrors.  order (on the card) is
// ops/syrk.py:tile_order: tile t of the schedule is the output tile
// (order[t].x, order[t].y), tile row and tile column.  waves (a 4-byte
// counter on the card, or nullptr) makes every block wait for all the
// others before it starts its next whole tile: syrk_launch zeroes it and
// launches the kernel cooperatively, so that every block is resident.
struct SyrkSched {
  int n_pad, kblocks, dp_tiles, split_tiles, splits;
  int accumulate, mirror;
  const int2* order;
  unsigned* waves;
};

// TMA tensor map of a row-major X of n_pad rows and ld elements a row
// (int8 or bf16); the kernel reads the first kblocks 128-byte blocks of
// each row.  Returns a cudaError_t.
int syrk_tensor_map(CUtensorMap* map, const void* X, int n_pad, int ld,
                    int is_int8);

// Launches K1 (and its split sums) on `stream`; work holds
// split_tiles * splits tiles of 128 x 128 4-byte values.  Returns a
// cudaError_t.
int syrk_launch(const CUtensorMap& map, float* G, uint32_t* work,
                const SyrkSched& s, int grid, int is_int8,
                cudaStream_t stream);

}  // namespace xmca
