// The grid of the particle-order kernels over (N, d) rows, shared by the
// drift test (philox_draws.cu rebuild_rows_kernel) and the Brownian move
// (verlet_update.cu brownian_rows_kernel): a particle a thread,
// kRowsThreads a block, one block a tile of kRowsThreads particles, at
// most kRowsMaxBlocks blocks (one wave on the H100 at any count: 512
// blocks of 256 threads fit on its 132 multiprocessors at once), a thread
// taking a particle of each later tile beyond that. The grid depends on the
// count alone, not on the card.
//
// A particle a thread, not a group of them: groups of whole particles that
// fill whole 16-byte vectors (four float32 particles at d = 3) were built
// and measured, and lost. A quarter of the threads each ran four
// particles' arithmetic in series, one warp to a scheduler, and the
// latency that nothing hid outweighed the loads they saved (PERF.md §6,
// the drift test and Brownian move of particle rows). A warp's scalar
// loads of a row-major array cover one contiguous run, so they coalesce
// as vectors would.
#pragma once

#include <stdint.h>

namespace mdtpu {
namespace rows {

constexpr int kRowsThreads = 256;
constexpr int kRowsMaxBlocks = 512;

constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// The fewest particles whose D values fill whole Philox blocks (16 bytes:
// 4 float32 or 2 float64 values): four float32 particles at d = 3.
template <typename T, int D>
constexpr int philox_period() {
  return int(16 / sizeof(T)) / gcd(int(16 / sizeof(T)), D);
}

__host__ __device__ inline int rows_grid(int64_t n) {
  const int64_t blocks = (n + kRowsThreads - 1) / kRowsThreads;
  return (int)(blocks < 1 ? 1 : (blocks > kRowsMaxBlocks ? kRowsMaxBlocks
                                                         : blocks));
}

// D values of row i of p (no __restrict__: the Verlet kernels write the
// rows they read in place).
template <typename U, int D>
__device__ __forceinline__ void load_row(const U* p, int64_t i, U (&r)[D]) {
#pragma unroll
  for (int k = 0; k < D; ++k) r[k] = p[i * D + k];
}

}  // namespace rows
}  // namespace mdtpu
