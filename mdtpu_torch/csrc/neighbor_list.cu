// The Verlet neighbour list for NVIDIA Hopper (sm_90a): its build (K1) and
// its force pass (K2).
//
// Counterparts of mdtpu/ops/neighbor_list.py, which is XLA in the JAX
// package (no Pallas kernel): the candidate gather, r^2 filter and top-K
// compaction of NeighborListEngine.allocate (:172-203), and the (N, K)
// gathers, potential and row sums of NeighborListEngine.compute (:224-263).
// Inputs are in particle order: positions (N, D), D = 2 or 3, in an
// orthorhombic box of lengths L (D,). Every minimum image is
// d - L * rint(d / L) per component, and r^2 = (d_0^2 + d_1^2) + d_2^2, in
// the JAX component order; rint rounds half to even as jnp.round does.
// Built with -fmad=false and IEEE division (mdtpu_torch/ops/_cuda_build.py),
// so every distance rounds as the plain PyTorch versions' do
// (ops/neighbor_list.py).
//
// nl_build_kernel (K1): one warp a particle i. It walks the 3^D stencil
// cells around its cell (the last axis fastest, each coordinate wrapped
// periodically), and in each cell the occupied slots of the bucket
// (n_cells, cap), up to the cell's count and not up to cap, 32 at a time:
// a lane tests j != i and r^2 < r_list^2, a ballot and a prefix count place
// the hits of the 32 in order after the row's earlier hits. The row keeps
// its first K hits in stencil order, then slot order; the rest of the row
// is the sentinel N. It writes the row's count (at most K) and raises the
// overflow flag (a plain store of 1, no atomics) where a stencil cell holds
// more than cap or the row more than K hits. The JAX build keeps the K
// closest (top_k) and so sorts its rows by r^2: the two rows are equal as
// sets, and where the flag is up they may keep different subsets, which the
// caller never uses (the driver grows the capacities and reruns).
//
// nl_forces_kernel (K2): one warp a particle i. Lane l takes the row's
// entries l, l + 32, ... below the row's count, recomputes r^2 as K1 does,
// and inside the engine cutoff (r^2 < c^2, c^2 the product in T) evaluates
// the potential's functor (pair_potentials.cuh, shared with the cell
// sweeps) with both diameters, adding f/r d to the force and u and f/r r^2
// to the energy and virial. The lanes' sums meet in a fixed shuffle tree;
// each block sums its warps' energies and virials in warp order into one
// partial, which the wrapper sums and halves (every pair is in both rows).
// No float atomics: the result repeats bit for bit.
//
// What bounds them on the H100. K2 at the bench (65,536 LJ particles, rho
// 0.8, r_c 2.5, skin 0.3; ~74 entries a row): bytes, the list's occupied
// entries (4.8 M int32, 19 MB) beside 1 MB of positions and forces; the
// gathered positions come from L2. K1: the stencil's candidates (~34 M
// distances of ~21 operations) and the (N, K) list written once (34 MB).
// The design is the simple one: no staging of the stencil in shared memory
// and no particles sorted by cell (a warp's 32 candidates are one cell's
// consecutive slots, but its row's positions are gathered one by one).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_potentials.cuh"

namespace {

using namespace mdtpu;

constexpr int kThreads = 256;            // 8 warps, 8 particles a block
constexpr int kWarps = kThreads / 32;
constexpr int kErrShape = -5;            // n, cap or K outside what it takes

__device__ __forceinline__ float round_even(float x) { return rintf(x); }
__device__ __forceinline__ double round_even(double x) { return rint(x); }

// Minimum-image displacement xi - xj in d and its r^2, in the JAX order.
template <typename T, int D>
__device__ __forceinline__ T min_image_r2(const T (&xi)[D],
                                          const T* __restrict__ xj,
                                          const T (&len)[D], T (&d)[D]) {
  T r2 = T(0);
#pragma unroll
  for (int a = 0; a < D; ++a) {
    T dk = xi[a] - xj[a];
    dk = dk - len[a] * round_even(dk / len[a]);
    d[a] = dk;
    r2 = r2 + dk * dk;
  }
  return r2;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    nl_build_kernel(const T* __restrict__ pos, const int* __restrict__ cid,
                    const int* __restrict__ cell_buf,
                    const int64_t* __restrict__ counts,
                    const T* __restrict__ lengths, int n, int nx, int ny,
                    int nz, int cap, int k_max, T r_list2,
                    int* __restrict__ idx, int* __restrict__ count,
                    int* __restrict__ overflow) {
  constexpr int kStencil = D == 3 ? 27 : 9;
  const int i = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;  // the whole warp
  const int g[3] = {nx, ny, nz};
  T xi[D], len[D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    xi[a] = pos[(int64_t)i * D + a];
    len[a] = lengths[a];
  }
  // The particle's cell coordinates (row-major cell id, last axis fastest).
  int cc[D];
  int c = cid[i];
#pragma unroll
  for (int a = D - 1; a >= 0; --a) {
    cc[a] = c % g[a];
    c /= g[a];
  }
  int* row = idx + (int64_t)i * k_max;
  int hits = 0;
  bool over = false;
  for (int s = 0; s < kStencil; ++s) {
    int nb = 0, t = s, off[D];
#pragma unroll
    for (int a = D - 1; a >= 0; --a) {
      off[a] = t % 3 - 1;
      t /= 3;
    }
#pragma unroll
    for (int a = 0; a < D; ++a) {
      int j = cc[a] + off[a];
      j = j < 0 ? j + g[a] : (j >= g[a] ? j - g[a] : j);
      nb = nb * g[a] + j;
    }
    const int64_t cnt = counts[nb];
    if (cnt > cap) over = true;
    const int m = cnt < cap ? (int)cnt : cap;
    const int* bucket = cell_buf + (int64_t)nb * cap;
    for (int base = 0; base < m; base += 32) {
      const int k = base + lane;
      bool hit = false;
      int j = n;
      if (k < m) {
        j = bucket[k];
        if (j != i) {
          T d[D];
          hit = min_image_r2<T, D>(xi, pos + (int64_t)j * D, len, d) <
                r_list2;
        }
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int at = hits + __popc(mask & ((1u << lane) - 1u));
        if (at < k_max) row[at] = j;
      }
      hits += __popc(mask);
    }
  }
  const int kept = hits < k_max ? hits : k_max;
  for (int k = kept + lane; k < k_max; k += 32) row[k] = n;
  if (lane == 0) {
    count[i] = kept;
    if (over || hits > k_max) *overflow = 1;
  }
}

template <typename T, int D, typename Pot>
__global__ void __launch_bounds__(kThreads)
    nl_forces_kernel(const T* __restrict__ pos, const T* __restrict__ diam,
                     const int* __restrict__ idx,
                     const int* __restrict__ count,
                     const T* __restrict__ lengths, int n, int k_max,
                     T cutoff2, Pot pot, T* __restrict__ force,
                     T* __restrict__ e_part, T* __restrict__ w_part) {
  __shared__ T red_e[kWarps], red_w[kWarps];
  const int wid = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + wid;
  T e = T(0), w = T(0);
  if (i < n) {  // the whole warp
    T xi[D], len[D], f[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      xi[a] = pos[(int64_t)i * D + a];
      len[a] = lengths[a];
      f[a] = T(0);
    }
    const T di = diam[i];
    const auto setup = pot.setup(di);
    const int* row = idx + (int64_t)i * k_max;
    const int m = count[i];
    for (int k = lane; k < m; k += 32) {
      const int j = row[k];
      T d[D];
      const T r2 = min_image_r2<T, D>(xi, pos + (int64_t)j * D, len, d);
      if (!(r2 < cutoff2)) continue;
      T u, fr;
      pot(setup, r2, di, diam[j], u, fr);
#pragma unroll
      for (int a = 0; a < D; ++a) f[a] += fr * d[a];
      e += u;
      w += fr * r2;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int a = 0; a < D; ++a)
        f[a] += __shfl_down_sync(0xffffffffu, f[a], off);
      e += __shfl_down_sync(0xffffffffu, e, off);
      w += __shfl_down_sync(0xffffffffu, w, off);
    }
    if (lane == 0) {
#pragma unroll
      for (int a = 0; a < D; ++a) force[(int64_t)i * D + a] = f[a];
    }
  }
  if (lane == 0) {
    red_e[wid] = e;
    red_w[wid] = w;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T se = T(0), sw = T(0);
    for (int k = 0; k < kWarps; ++k) {
      se += red_e[k];
      sw += red_w[k];
    }
    e_part[blockIdx.x] = se;
    w_part[blockIdx.x] = sw;
  }
}

int blocks_for(int n) { return (int)(((int64_t)n * 32 + kThreads - 1) / kThreads); }

template <typename T>
int build(const T* pos, const int* cid, const int* cell_buf,
          const int64_t* counts, const T* lengths, int n, int dim, int nx,
          int ny, int nz, int cap, int k_max, double r_list2, int* idx,
          int* count, int* overflow, void* stream_ptr) {
  if (n < 1 || cap < 1 || k_max < 1) return kErrShape;
  if (nx < 3 || ny < 3 || (dim == 3 ? nz < 3 : nz != 1)) return kErrGrid;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto launch = [&](auto kernel) {
    kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        pos, cid, cell_buf, counts, lengths, n, nx, ny, nz, cap, k_max,
        T(r_list2), idx, count, overflow);
    return (int)cudaGetLastError();
  };
  if (dim == 3) return launch(nl_build_kernel<T, 3>);
  if (dim == 2) return launch(nl_build_kernel<T, 2>);
  return kErrGrid;
}

template <typename T>
int forces(const T* pos, const T* diam, const int* idx, const int* count,
           const T* lengths, int n, int dim, int k_max, double cutoff,
           int kind, double p0, double p1, double p2, double p3, int i0,
           int i1, int i2, T* force, T* e_part, T* w_part,
           void* stream_ptr) {
  if (n < 1 || k_max < 1) return kErrShape;
  if (dim != 2 && dim != 3) return kErrGrid;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const T c = T(cutoff);
  const T cutoff2 = c * c;
  const int blocks = (n + kWarps - 1) / kWarps;
  return with_potential<T>(kind, p0, p1, p2, p3, i0, i1, i2, [&](auto pot) {
    using Pot = decltype(pot);
    auto kernel = dim == 3 ? nl_forces_kernel<T, 3, Pot>
                           : nl_forces_kernel<T, 2, Pot>;
    kernel<<<blocks, kThreads, 0, stream>>>(pos, diam, idx, count, lengths,
                                            n, k_max, cutoff2, pot, force,
                                            e_part, w_part);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// K1. pos (n, dim); cid (n,) the cell of each particle; cell_buf (n_cells,
// cap) particle ids by cell; counts (n_cells,) particles binned per cell
// (may exceed cap); lengths (dim,); a 2D grid has nz = 1. r_list2: the
// squared list radius in double, rounded to the kernel's type. Writes idx
// (n, k_max), count (n,) and, on overflow, 1 into *overflow (which the
// caller zeroes).
int mdtpu_nl_build_f32(const float* pos, const int* cid, const int* cell_buf,
                       const int64_t* counts, const float* lengths, int n,
                       int dim, int nx, int ny, int nz, int cap, int k_max,
                       double r_list2, int* idx, int* count, int* overflow,
                       void* stream) {
  return build<float>(pos, cid, cell_buf, counts, lengths, n, dim, nx, ny,
                      nz, cap, k_max, r_list2, idx, count, overflow, stream);
}

int mdtpu_nl_build_f64(const double* pos, const int* cid,
                       const int* cell_buf, const int64_t* counts,
                       const double* lengths, int n, int dim, int nx, int ny,
                       int nz, int cap, int k_max, double r_list2, int* idx,
                       int* count, int* overflow, void* stream) {
  return build<double>(pos, cid, cell_buf, counts, lengths, n, dim, nx, ny,
                       nz, cap, k_max, r_list2, idx, count, overflow, stream);
}

// K2. The potential as with_potential (pair_potentials.cuh) takes it;
// writes force (n, dim) and one energy and one virial partial per block of
// kThreads / 32 particles (unhalved).
int mdtpu_nl_forces_f32(const float* pos, const float* diam, const int* idx,
                        const int* count, const float* lengths, int n,
                        int dim, int k_max, double cutoff, int kind,
                        double p0, double p1, double p2, double p3, int i0,
                        int i1, int i2, float* force, float* e_part,
                        float* w_part, void* stream) {
  return forces<float>(pos, diam, idx, count, lengths, n, dim, k_max, cutoff,
                       kind, p0, p1, p2, p3, i0, i1, i2, force, e_part,
                       w_part, stream);
}

int mdtpu_nl_forces_f64(const double* pos, const double* diam,
                        const int* idx, const int* count,
                        const double* lengths, int n, int dim, int k_max,
                        double cutoff, int kind, double p0, double p1,
                        double p2, double p3, int i0, int i1, int i2,
                        double* force, double* e_part, double* w_part,
                        void* stream) {
  return forces<double>(pos, diam, idx, count, lengths, n, dim, k_max,
                        cutoff, kind, p0, p1, p2, p3, i0, i1, i2, force,
                        e_part, w_part, stream);
}

const char* mdtpu_neighbor_list_error_string(int code) {
  if (code == kErrShape) return "particle count, cell capacity or K < 1";
  return mdtpu::error_string(code);
}

}  // extern "C"
