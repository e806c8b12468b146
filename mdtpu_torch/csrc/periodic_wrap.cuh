// The Kahan add and the periodic wrap of one particle's position, shared by
// the particle-order kernels of verlet_update.cu and fire_update.cu.
#pragma once

#include <stdint.h>

namespace mdtpu {
namespace box {

// kahan_add of utils/math.py: y = dx - c; t = x + y; c' = (t - x) - y.
template <typename T>
__device__ __forceinline__ void kahan(T& x, T& c, T dx) {
  const T y = dx - c;
  const T t = x + y;
  c = (t - x) - y;
  x = t;
}

// The periodic wrap of one particle's position (integrate/step.py with
// core/box.py wrap_positions_compensated and wrap_positions), as the torch
// composition computes it: frac_k = sum_j x_j ci[k][j] (j ascending, each
// product rounded; core/box.py _mm of cell_inv.T), n = floor(frac), and
// where COMP delta_k = -(sum_j n_j c[k][j]) through the Kahan add, else
// x_k = sum_j (frac_j - n_j) c[k][j]; images += n. c, ci: the cell and its
// inverse, row-major.
template <typename T, int D, bool COMP>
__device__ __forceinline__ void wrap(T (&x)[D], T (&xc)[D], int64_t (&img)[D],
                                     const T (&c)[D][D], const T (&ci)[D][D]) {
  T frac[D], n[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    T s = x[0] * ci[k][0];
#pragma unroll
    for (int j = 1; j < D; ++j) s = s + x[j] * ci[k][j];
    frac[k] = s;
    n[k] = floor(s);
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (COMP) {
      T s = n[0] * c[k][0];
#pragma unroll
      for (int j = 1; j < D; ++j) s = s + n[j] * c[k][j];
      kahan(x[k], xc[k], -s);
    } else {
      T s = (frac[0] - n[0]) * c[k][0];
#pragma unroll
      for (int j = 1; j < D; ++j) s = s + (frac[j] - n[j]) * c[k][j];
      x[k] = s;
    }
    img[k] = img[k] + (int64_t)n[k];
  }
}

template <typename T, int D>
__device__ __forceinline__ void load_cell(const T* cell, const T* cell_inv,
                                          T (&c)[D][D], T (&ci)[D][D]) {
#pragma unroll
  for (int k = 0; k < D; ++k)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      c[k][j] = cell[k * D + j];
      ci[k][j] = cell_inv[k * D + j];
    }
}

}  // namespace box
}  // namespace mdtpu
