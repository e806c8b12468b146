// Cell-list pair sweep for NVIDIA Hopper (sm_90a): forces, energy and virial
// of every pair within the cutoff, over particles sorted into the slots of a
// periodic 3D orthorhombic cell grid.
//
// Replaces mdtpu/ops/experimental/pallas_cell.py::_pair_row_kernel, the
// Pallas TPU kernel that runs the full 27-cell stencil per (x, y) column of
// cells. This kernel computes the same function, not the same blocks:
//
//   * one thread block per cell, one thread per own slot (the block is the
//     cell capacity C rounded up to a power of two, at least one warp);
//   * the full 27-cell stencil, so every pair is seen from both sides: no
//     reaction write-back, no atomics, a deterministic result. Energy and
//     virial take the factor 1/2;
//   * no ghost cells and no far-away pad coordinates: the neighbour cell is
//     found by a periodic index, the +-L image shift is added to the
//     coordinates as they are loaded, and every loop is bounded by the
//     per-cell counts. The self pair is excluded by slot index;
//   * each neighbour cell's coordinates and diameters are staged in shared
//     memory (4 C values) and read by every thread of the block;
//   * each block writes its own slots' forces and one energy and one virial
//     partial, reduced over the block in a fixed order. The caller sums the
//     partials (a second fixed-order pass).
//
// The HILO variant is the hi/lo (double-f32) sweep of the JAX package's slot
// path (mdtpu/ops/cell_grid.py make_pair_block :254-259, ghost_z_window_hilo
// :144, ghost_shift_hilo :189): coordinates come as a hi word (slot_pos) and
// a lo word, the image shift goes onto the hi word through an error-free
// two_sum with its residual folded into lo, and each displacement is
// s + (e + (lo_i - lo_j)) with (s, e) = two_sum(hi_i, -hi_j). A plain f32
// difference of absolute coordinates carries ~eps*L of rounding; this one
// carries ~eps*r, which is what f32 NVE needs to conserve energy.
//
// What bounds it on the H100. The function itself is bound by memory: it
// reads about 16 bytes per slot (4 values; 28 with the lo word) and writes
// 12, and needs ~40 operations per pair inside the cutoff, which at the bench
// geometry take about as long as the bytes at peak rates. This design does
// far more arithmetic than that: it evaluates ~27 C candidate pairs per slot
// (~1,000 at the bench geometry), about 19 times the pairs inside the cutoff,
// each seen from both sides; and with one thread per own slot most of a block
// idles at small C while it waits on the shared-memory staging of each
// neighbour cell. The design keeps the operands in shared memory and
// registers so device memory is touched once per slot per neighbour cell,
// and keeps the potential's arithmetic free of sqrt and divides where the
// JAX package's evaluate_r2 is. The Newton half-stencil variant is
// plane_sweep.cu.

#include "pair_potentials.cuh"

namespace {

using namespace mdtpu;

// pos: (3, n_cells * cap) slot coordinates, component-major (the hi word
// under HILO); lo: (3, n_cells * cap) lo words (HILO only, else unused);
// diam: (n_cells * cap,); counts: (n_cells,) occupied slots per cell
// (clamped to cap here); box: (3,) box lengths. Slots [0, count) of each
// cell are occupied. force: (3, n_cells * cap), every slot written (vacant
// slots get 0).
template <typename T, typename Pot, bool HILO>
__global__ void cell_sweep_kernel(const T* __restrict__ pos,
                                  const T* __restrict__ lo,
                                  const T* __restrict__ diam,
                                  const int64_t* __restrict__ counts,
                                  const T* __restrict__ box, int nx, int ny,
                                  int nz, int cap, T cutoff2, Pot pot,
                                  T* __restrict__ force,
                                  T* __restrict__ e_part,
                                  T* __restrict__ w_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sy = sx + cap;
  T* sz = sy + cap;
  T* sd = sz + cap;
  T* sxl = sd + cap;  // lo words, HILO only
  T* syl = sxl + (HILO ? cap : 0);
  T* szl = syl + (HILO ? cap : 0);
  T* red_e = szl + (HILO ? cap : 0);
  T* red_w = red_e + blockDim.x;

  const int64_t n_slots = (int64_t)nx * ny * nz * cap;
  const int cell = blockIdx.x;
  const int cz = cell % nz;
  const int cy = (cell / nz) % ny;
  const int cx = cell / (ny * nz);
  const int i = threadIdx.x;
  const int64_t cnt_own = counts[cell];
  const int n_own = cnt_own < cap ? (int)cnt_own : cap;
  const bool active = i < n_own;
  const int64_t own = (int64_t)cell * cap + i;
  const T lx = box[0], ly = box[1], lz = box[2];

  T xi = T(0), yi = T(0), zi = T(0), di = T(0);
  T xil = T(0), yil = T(0), zil = T(0);
  if (active) {
    xi = pos[own];
    yi = pos[n_slots + own];
    zi = pos[2 * n_slots + own];
    di = diam[own];
    if (HILO) {
      xil = lo[own];
      yil = lo[n_slots + own];
      zil = lo[2 * n_slots + own];
    }
  }
  T fx = T(0), fy = T(0), fz = T(0), e = T(0), w = T(0);

  for (int ox = -1; ox <= 1; ++ox) {
    T shx;
    const int jx = wrap_axis(cx + ox, nx, lx, shx);
    for (int oy = -1; oy <= 1; ++oy) {
      T shy;
      const int jy = wrap_axis(cy + oy, ny, ly, shy);
      for (int oz = -1; oz <= 1; ++oz) {
        T shz;
        const int jz = wrap_axis(cz + oz, nz, lz, shz);
        const int nb = (jx * ny + jy) * nz + jz;
        const int64_t cnt_nb = counts[nb];
        const int n_nb = cnt_nb < cap ? (int)cnt_nb : cap;
        __syncthreads();  // the previous cell's stage is no longer read
        if (i < n_nb) {
          const int64_t s = (int64_t)nb * cap + i;
          if (HILO) {
            T r;
            two_sum(pos[s], shx, sx[i], r);
            sxl[i] = lo[s] + r;
            two_sum(pos[n_slots + s], shy, sy[i], r);
            syl[i] = lo[n_slots + s] + r;
            two_sum(pos[2 * n_slots + s], shz, sz[i], r);
            szl[i] = lo[2 * n_slots + s] + r;
          } else {
            sx[i] = pos[s] + shx;
            sy[i] = pos[n_slots + s] + shy;
            sz[i] = pos[2 * n_slots + s] + shz;
          }
          sd[i] = diam[s];
        }
        __syncthreads();
        if (active) {
          const bool self_cell = (ox == 0 && oy == 0 && oz == 0);
          for (int j = 0; j < n_nb; ++j) {
            if (self_cell && j == i) continue;
            T dx, dy, dz;
            if (HILO) {
              T s, err;
              two_sum(xi, -sx[j], s, err);
              dx = s + (err + (xil - sxl[j]));
              two_sum(yi, -sy[j], s, err);
              dy = s + (err + (yil - syl[j]));
              two_sum(zi, -sz[j], s, err);
              dz = s + (err + (zil - szl[j]));
            } else {
              dx = xi - sx[j];
              dy = yi - sy[j];
              dz = zi - sz[j];
            }
            const T r2 = dx * dx + dy * dy + dz * dz;
            if (r2 < cutoff2) {
              T u, f;
              pot(r2, di, sd[j], u, f);
              e += T(0.5) * u;
              w += T(0.5) * (f * r2);
              fx += f * dx;
              fy += f * dy;
              fz += f * dz;
            }
          }
        }
      }
    }
  }

  if (i < cap) {
    force[own] = fx;
    force[n_slots + own] = fy;
    force[2 * n_slots + own] = fz;
  }

  block_reduce2(e, w, red_e, red_w);
  if (i == 0) {
    e_part[cell] = red_e[0];
    w_part[cell] = red_w[0];
  }
}

template <typename T, bool HILO>
int sweep(const T* pos, const T* lo, const T* diam, const int64_t* counts,
          const T* box, int nx, int ny, int nz, int cap, double cutoff,
          int kind, double p0, double p1, double p2, double p3, int i0,
          int i1, int i2, T* force, T* e_part, T* w_part, void* stream_ptr) {
  if (cap < 1 || cap > 1024) return kErrCapacity;
  if (nx < 3 || ny < 3 || nz < 3) return kErrGrid;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const T rc_engine = T(cutoff);
  const T cutoff2 = rc_engine * rc_engine;
  int threads = 32;
  while (threads < cap) threads <<= 1;
  const size_t smem =
      (size_t)((HILO ? 7 : 4) * cap + 2 * threads) * sizeof(T);
  const int n_cells = nx * ny * nz;
  return with_potential<T>(kind, p0, p1, p2, p3, i0, i1, i2, [&](auto pot) {
    cell_sweep_kernel<T, decltype(pot), HILO>
        <<<n_cells, threads, smem, stream>>>(pos, lo, diam, counts, box, nx,
                                             ny, nz, cap, cutoff2, pot, force,
                                             e_part, w_part);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

int mdtpu_cell_sweep_f32(const float* pos, const float* diam,
                         const int64_t* counts, const float* box, int nx,
                         int ny, int nz, int cap, double cutoff, int kind,
                         double p0, double p1, double p2, double p3, int i0,
                         int i1, int i2, float* force, float* e_part,
                         float* w_part, void* stream) {
  return sweep<float, false>(pos, nullptr, diam, counts, box, nx, ny, nz, cap,
                             cutoff, kind, p0, p1, p2, p3, i0, i1, i2, force,
                             e_part, w_part, stream);
}

int mdtpu_cell_sweep_f64(const double* pos, const double* diam,
                         const int64_t* counts, const double* box, int nx,
                         int ny, int nz, int cap, double cutoff, int kind,
                         double p0, double p1, double p2, double p3, int i0,
                         int i1, int i2, double* force, double* e_part,
                         double* w_part, void* stream) {
  return sweep<double, false>(pos, nullptr, diam, counts, box, nx, ny, nz,
                              cap, cutoff, kind, p0, p1, p2, p3, i0, i1, i2,
                              force, e_part, w_part, stream);
}

// The hi/lo sweep, float32 only (as the JAX package's f32x2 mode).
int mdtpu_cell_sweep_hilo_f32(const float* hi, const float* lo,
                              const float* diam, const int64_t* counts,
                              const float* box, int nx, int ny, int nz,
                              int cap, double cutoff, int kind, double p0,
                              double p1, double p2, double p3, int i0, int i1,
                              int i2, float* force, float* e_part,
                              float* w_part, void* stream) {
  return sweep<float, true>(hi, lo, diam, counts, box, nx, ny, nz, cap,
                            cutoff, kind, p0, p1, p2, p3, i0, i1, i2, force,
                            e_part, w_part, stream);
}

const char* mdtpu_cell_sweep_error_string(int code) {
  return mdtpu::error_string(code);
}

}  // extern "C"
