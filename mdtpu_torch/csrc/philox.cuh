// Philox-4x32-10, the counter-based generator of Salmon, Moraes, Dror and
// Shaw (SC'11; Random123's philox4x32 at 10 rounds), and the uniforms the
// port takes from its words.
//
// A draw is a pure function of a 128-bit counter and a 64-bit key: the
// same (counter, key) gives the same four 32-bit words on any thread, in
// any launch, on any card, and in the plain PyTorch version
// (mdtpu_torch/ops/philox_draws.py philox4x32_10), which does the same
// integer arithmetic in int64. So a step's random numbers depend on
// nothing but (seed, step, stream), as the JAX package's fold_in(key,
// step) draws do, and a kernel that reads the step from device memory can
// sit inside a CUDA graph that is replayed step after step.
#pragma once

#include <stdint.h>

namespace mdtpu {
namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u;  // round multipliers
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;  // Weyl key increments
constexpr uint32_t kW1 = 0xBB67AE85u;

__host__ __device__ inline void mulhilo(uint32_t a, uint32_t b, uint32_t& hi,
                                        uint32_t& lo) {
  const uint64_t p = static_cast<uint64_t>(a) * b;
  hi = static_cast<uint32_t>(p >> 32);
  lo = static_cast<uint32_t>(p);
}

// Ten rounds; the key is bumped before every round but the first.
__host__ __device__ inline uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += kW0;
      k.y += kW1;
    }
    uint32_t hi0, lo0, hi1, lo1;
    mulhilo(kM0, c.x, hi0, lo0);
    mulhilo(kM1, c.z, hi1, lo1);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The counter of a step's draw: (block, step lo, step hi, stream).
__host__ __device__ inline uint4 counter(uint32_t block, int64_t step,
                                         uint32_t stream) {
  const uint64_t s = static_cast<uint64_t>(step);
  return make_uint4(block, static_cast<uint32_t>(s),
                    static_cast<uint32_t>(s >> 32), stream);
}

// A float in [0, 1) from the top 24 bits of a word: exact, m 2^-24.
__host__ __device__ inline float u24(uint32_t w) {
  return static_cast<float>(w >> 8) * 0x1p-24f;
}

// A double in [0, 1) from 53 bits of two words (27 of a, 26 of b): exact.
__host__ __device__ inline double u53(uint32_t a, uint32_t b) {
  return (static_cast<double>(a >> 5) * 67108864.0 +
          static_cast<double>(b >> 6)) *
         0x1p-53;
}

// The Brownian noise's variance-matched uniforms (2u - 1) sqrt(3) of one
// block's words (mdtpu/integrate/step.py brownian_noise): four float32
// values, each from its word's top 24 bits, or two float64, each from 53
// bits of two words. 2u - 1 is exact; the product rounds once. Shared by
// the noise kernel (philox_draws.cu) and the Brownian update
// (verlet_update.cu), so both give element e the same bits.
constexpr double kSqrt3 = 1.7320508075688772;  // math.sqrt(3)

__host__ __device__ inline void noise_values(uint4 w, float (&v)[4]) {
  const float sqrt3 = static_cast<float>(kSqrt3);
  v[0] = (2.0f * u24(w.x) - 1.0f) * sqrt3;
  v[1] = (2.0f * u24(w.y) - 1.0f) * sqrt3;
  v[2] = (2.0f * u24(w.z) - 1.0f) * sqrt3;
  v[3] = (2.0f * u24(w.w) - 1.0f) * sqrt3;
}

__host__ __device__ inline void noise_values(uint4 w, double (&v)[2]) {
  v[0] = (2.0 * u53(w.x, w.y) - 1.0) * kSqrt3;
  v[1] = (2.0 * u53(w.z, w.w) - 1.0) * kSqrt3;
}

}  // namespace philox
}  // namespace mdtpu
