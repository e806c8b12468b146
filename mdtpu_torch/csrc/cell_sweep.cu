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
// What bounds it on the H100. The function itself is bound by memory: it
// reads about 16 bytes per slot (4 values) and writes 12, and needs ~40
// operations per pair inside the cutoff, which at the bench geometry take
// about as long as the bytes at peak rates. This design does far more
// arithmetic than that: it evaluates ~27 C candidate pairs per slot (~1,000
// at the bench geometry), about 19 times the pairs inside the cutoff, each
// seen from both sides; and with one thread per own slot most of a block
// idles at small C while it waits on the shared-memory staging of each
// neighbour cell. The design keeps the operands in shared memory and
// registers so device memory is touched once per slot per neighbour cell,
// and keeps the potential's arithmetic free of sqrt and divides where the
// JAX package's evaluate_r2 is. What it does not yet do: half-stencil
// (Newton) variants, warp-per-cell layouts for small C, tuned cell sizes —
// later work, to be chosen by measurement.
//
// The potentials are functors with their parameters passed by value. Each
// mirrors the evaluate_r2 method of its PyTorch class (mdtpu_torch/potentials)
// expression for expression; keep them in step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kPseudoHSA = 134.5526623421209;
constexpr double kPseudoHSB = 1.0204081632653061;

template <typename T>
__device__ __forceinline__ T rsqrt_t(T x);
template <>
__device__ __forceinline__ float rsqrt_t<float>(float x) { return rsqrtf(x); }
template <>
__device__ __forceinline__ double rsqrt_t<double>(double x) { return rsqrt(x); }

// x**n by binary exponentiation, in the squaring order of utils/math.py::ipow.
template <typename T>
__device__ __forceinline__ T ipow(T x, int n) {
  if (n == 0) return T(1);
  T result = T(0);
  bool have = false;
  T base = x;
  while (n > 0) {
    if (n & 1) {
      result = have ? result * base : base;
      have = true;
    }
    n >>= 1;
    if (n) base = base * base;
  }
  return result;
}

template <typename T>
struct LJ {
  T eps, sigma, rc;
  int shift, force_shift, mix;

  __device__ __forceinline__ void operator()(T r2, T si, T sj, T& u,
                                             T& f_over_r) const {
    const T sig = mix ? T(0.5) * (si + sj) : sigma;
    if (!(r2 < rc * rc)) {
      u = T(0);
      f_over_r = T(0);
      return;
    }
    T inv_r = T(0), inv_r2;
    if (force_shift) {
      inv_r = rsqrt_t<T>(r2);
      inv_r2 = inv_r * inv_r;
    } else {
      inv_r2 = T(1) / r2;
    }
    const T sr2 = (sig * sig) * inv_r2;
    const T sr6 = sr2 * sr2 * sr2;
    const T sr12 = sr6 * sr6;
    T v = T(4) * eps * (sr12 - sr6);
    T f = T(24) * eps * (T(2) * sr12 - sr6) * inv_r2;
    if (shift || force_shift) {
      const T sr = sig / rc;
      const T s2 = sr * sr;
      const T src6 = s2 * s2 * s2;
      const T src12 = src6 * src6;
      v = v - T(4) * eps * (src12 - src6);
      if (force_shift) {
        const T f_cut = T(24) * eps * (T(2) * src12 - src6) / rc;
        v = v + (r2 * inv_r - rc) * f_cut;
        f = f - f_cut * inv_r;
      }
    }
    u = v;
    f_over_r = f;
  }
};

template <typename T>
struct PseudoHS {
  int lam, scaled, mix;

  __device__ __forceinline__ void operator()(T r2, T si, T sj, T& u,
                                             T& f_over_r) const {
    const T sig = mix ? T(0.5) * (si + sj) : T(1);
    const T cut = scaled ? T(kPseudoHSB) * sig : T(kPseudoHSB);
    if (!(r2 < cut * cut)) {
      u = T(0);
      f_over_r = T(0);
      return;
    }
    const T inv_r = rsqrt_t<T>(r2);
    const T sr = sig * inv_r;
    const T sr2 = sr * sr;
    const T sr_lm2 = (lam % 2 == 0) ? ipow<T>(sr2, (lam - 2) / 2)
                                    : ipow<T>(sr2, (lam - 3) / 2) * sr;
    const T sr_lm1 = sr_lm2 * sr;
    const T sr_l = sr_lm2 * sr2;
    const T sr_lp1 = sr_l * sr;
    const T sr_lp2 = sr_l * sr2;
    const T a = T(kPseudoHSA);
    u = a * (sr_l - sr_lm1) + T(1);
    f_over_r = (a / (sig * sig)) * (T(lam) * sr_lp2 - T(lam - 1) * sr_lp1);
  }
};

template <typename T>
struct XPLOR {
  T eps, sigma, ron, rc;
  int mix;

  __device__ __forceinline__ void operator()(T r2, T si, T sj, T& u,
                                             T& f_over_r) const {
    const T sig = mix ? T(0.5) * (si + sj) : sigma;
    const T rc2 = rc * rc;
    const T ron2 = ron * ron;
    if (!(r2 < rc2)) {
      u = T(0);
      f_over_r = T(0);
      return;
    }
    const T inv_r2 = T(1) / r2;
    const T sr2 = (sig * sig) * inv_r2;
    const T sr6 = sr2 * sr2 * sr2;
    const T sr12 = sr6 * sr6;
    const T v = T(4) * eps * (sr12 - sr6);
    const T f = T(24) * eps * (T(2) * sr12 - sr6) * inv_r2;
    const T d = rc2 - ron2;
    const T denom = d * d * d;
    const T a = rc2 - r2;
    const T b = rc2 + T(2) * r2 - T(3) * ron2;
    const bool below = r2 < ron2;
    const T s = below ? T(1) : a * a * b / denom;
    const T ds_over_r = below ? T(0) : T(4) * a * (a - b) / denom;
    u = v * s;
    f_over_r = s * f - v * ds_over_r;
  }
};

// pos: (3, n_cells * cap) slot coordinates, component-major; diam: (n_cells *
// cap,); counts: (n_cells,) occupied slots per cell (clamped to cap here);
// box: (3,) box lengths. Slots [0, count) of each cell are occupied.
// force: (3, n_cells * cap), every slot written (vacant slots get 0).
template <typename T, typename Pot>
__global__ void cell_sweep_kernel(const T* __restrict__ pos,
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
  T* red_e = sd + cap;
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
  if (active) {
    xi = pos[own];
    yi = pos[n_slots + own];
    zi = pos[2 * n_slots + own];
    di = diam[own];
  }
  T fx = T(0), fy = T(0), fz = T(0), e = T(0), w = T(0);

  for (int ox = -1; ox <= 1; ++ox) {
    int jx = cx + ox;
    T shx = T(0);
    if (jx < 0) { jx += nx; shx = -lx; } else if (jx >= nx) { jx -= nx; shx = lx; }
    for (int oy = -1; oy <= 1; ++oy) {
      int jy = cy + oy;
      T shy = T(0);
      if (jy < 0) { jy += ny; shy = -ly; } else if (jy >= ny) { jy -= ny; shy = ly; }
      for (int oz = -1; oz <= 1; ++oz) {
        int jz = cz + oz;
        T shz = T(0);
        if (jz < 0) { jz += nz; shz = -lz; } else if (jz >= nz) { jz -= nz; shz = lz; }
        const int nb = (jx * ny + jy) * nz + jz;
        const int64_t cnt_nb = counts[nb];
        const int n_nb = cnt_nb < cap ? (int)cnt_nb : cap;
        __syncthreads();  // the previous cell's stage is no longer read
        if (i < n_nb) {
          const int64_t s = (int64_t)nb * cap + i;
          sx[i] = pos[s] + shx;
          sy[i] = pos[n_slots + s] + shy;
          sz[i] = pos[2 * n_slots + s] + shz;
          sd[i] = diam[s];
        }
        __syncthreads();
        if (active) {
          const bool self_cell = (ox == 0 && oy == 0 && oz == 0);
          for (int j = 0; j < n_nb; ++j) {
            if (self_cell && j == i) continue;
            const T dx = xi - sx[j];
            const T dy = yi - sy[j];
            const T dz = zi - sz[j];
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

  // Fixed-order tree reduction of the block's energy and virial.
  red_e[i] = e;
  red_w[i] = w;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (i < stride) {
      red_e[i] += red_e[i + stride];
      red_w[i] += red_w[i + stride];
    }
    __syncthreads();
  }
  if (i == 0) {
    e_part[cell] = red_e[0];
    w_part[cell] = red_w[0];
  }
}

// Error codes of this file, beside cudaError_t values (which are >= 0).
constexpr int kErrCapacity = -1;   // cap outside [1, 1024]
constexpr int kErrPotential = -2;  // unknown potential kind
constexpr int kErrGrid = -3;       // fewer than 3 cells on an axis

template <typename T, typename Pot>
int launch(const T* pos, const T* diam, const int64_t* counts, const T* box,
           int nx, int ny, int nz, int cap, T cutoff2, const Pot& pot,
           T* force, T* e_part, T* w_part, cudaStream_t stream) {
  int threads = 32;
  while (threads < cap) threads <<= 1;
  const size_t smem = (size_t)(4 * cap + 2 * threads) * sizeof(T);
  const int n_cells = nx * ny * nz;
  cell_sweep_kernel<T, Pot><<<n_cells, threads, smem, stream>>>(
      pos, diam, counts, box, nx, ny, nz, cap, cutoff2, pot, force, e_part,
      w_part);
  return (int)cudaGetLastError();
}

// kind: 0 LennardJones (p0 eps, p1 sigma, p2 r_cut; i0 shift, i1
// force_shift, i2 mix), 1 PseudoHS (i0 lam, i1 sigma_scaled_cutoff, i2 mix),
// 2 LennardJonesXPLOR (p0 eps, p1 sigma, p2 r_on, p3 r_cut; i2 mix).
template <typename T>
int sweep(const T* pos, const T* diam, const int64_t* counts, const T* box,
          int nx, int ny, int nz, int cap, double cutoff, int kind, double p0,
          double p1, double p2, double p3, int i0, int i1, int i2, T* force,
          T* e_part, T* w_part, void* stream_ptr) {
  if (cap < 1 || cap > 1024) return kErrCapacity;
  if (nx < 3 || ny < 3 || nz < 3) return kErrGrid;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const T rc_engine = T(cutoff);
  const T cutoff2 = rc_engine * rc_engine;
  switch (kind) {
    case 0: {
      LJ<T> pot{T(p0), T(p1), T(p2), i0, i1, i2};
      return launch<T, LJ<T>>(pos, diam, counts, box, nx, ny, nz, cap,
                              cutoff2, pot, force, e_part, w_part, stream);
    }
    case 1: {
      PseudoHS<T> pot{i0, i1, i2};
      return launch<T, PseudoHS<T>>(pos, diam, counts, box, nx, ny, nz, cap,
                                    cutoff2, pot, force, e_part, w_part,
                                    stream);
    }
    case 2: {
      XPLOR<T> pot{T(p0), T(p1), T(p2), T(p3), i2};
      return launch<T, XPLOR<T>>(pos, diam, counts, box, nx, ny, nz, cap,
                                 cutoff2, pot, force, e_part, w_part, stream);
    }
    default:
      return kErrPotential;
  }
}

}  // namespace

extern "C" {

int mdtpu_cell_sweep_f32(const float* pos, const float* diam,
                         const int64_t* counts, const float* box, int nx,
                         int ny, int nz, int cap, double cutoff, int kind,
                         double p0, double p1, double p2, double p3, int i0,
                         int i1, int i2, float* force, float* e_part,
                         float* w_part, void* stream) {
  return sweep<float>(pos, diam, counts, box, nx, ny, nz, cap, cutoff, kind,
                      p0, p1, p2, p3, i0, i1, i2, force, e_part, w_part,
                      stream);
}

int mdtpu_cell_sweep_f64(const double* pos, const double* diam,
                         const int64_t* counts, const double* box, int nx,
                         int ny, int nz, int cap, double cutoff, int kind,
                         double p0, double p1, double p2, double p3, int i0,
                         int i1, int i2, double* force, double* e_part,
                         double* w_part, void* stream) {
  return sweep<double>(pos, diam, counts, box, nx, ny, nz, cap, cutoff, kind,
                       p0, p1, p2, p3, i0, i1, i2, force, e_part, w_part,
                       stream);
}

const char* mdtpu_cell_sweep_error_string(int code) {
  switch (code) {
    case kErrCapacity: return "cell capacity outside [1, 1024]";
    case kErrPotential: return "potential kind unknown to the kernel";
    case kErrGrid: return "cell grid needs at least 3 cells on every axis";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
