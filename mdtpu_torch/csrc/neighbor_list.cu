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
// the JAX component order; rint rounds half to even as jnp.round does. The
// kernels take rint(d * (1 / L)), which gives every hit, entry and force
// the same bits (min_image below). Built with -fmad=false
// (mdtpu_torch/ops/_cuda_build.py), so every distance rounds as the plain
// PyTorch versions' do (ops/neighbor_list.py).
//
// nl_build_kernel (K1): one block a cell. Every particle of a cell walks the
// same 3^D stencil cells (the last axis fastest, each coordinate wrapped
// periodically), so the block stages their candidates once: warp 0 finds the
// stencil's cells and a scan of their occupied slots (the count clamped to
// the bucket's capacity C), then the block copies the occupied slots of the
// bucket (n_cells, C), ids and coordinates (one row of the stage per
// coordinate), into shared memory, compacted in stencil order and slot order.
// The block's own particles come from `order` (the particles sorted by cell)
// from the cell's start: every particle binned there, also one past C that
// the bucket dropped, gets its row and count. A warp takes one own particle
// at a time and tests 32 staged candidates a round (j != i and
// r^2 < r_list^2); a ballot and a prefix count place the hits of the round
// after the row's earlier hits, so the row keeps its first K hits in stencil
// order, then slot order, and the rest of the row is the sentinel N: the
// rows of the first design (one warp a particle, walking the cells one by
// one) bit for bit. The count is at most K; the sticky overflow flag (a
// plain store of 1, no atomics) goes up where a stencil cell holds more than
// C or a row more than K hits. A stage holds `stage_cells` stencil cells of
// C slots each (the host's plan: all 3^D where that fits the budget, else
// 3^(D-1), 3 or 1); a smaller stage is refilled for each part of the stencil
// in turn, the rows' hit counts carried across parts in shared memory, so no
// candidate is ever dropped. A stage holds at least one whole cell, so C is
// bounded by the block's dynamic shared memory (kMaxDynamicShared over 4 +
// D sizeof(T) bytes a slot): at most 14,464 (f32) or 8,265 (f64) in 3D,
// 19,285 or 11,571 in 2D; past it the launch returns kErrCapacity, which
// the wrapper raises. Cells of side r_list hold far fewer at any liquid or
// solid density (the bench's C is 57, 137 grown twice). The JAX build
// keeps the K closest (top_k) and so sorts its rows by r^2: the two rows
// are equal as sets, and where the flag is up they may keep different
// subsets, which the caller never uses (the driver grows the capacities
// and reruns).
//
// nl_forces_kernel (K2): kLanes = 4 lanes a row. Worker r of the launch
// takes row order[r] (the particles sorted by cell at the build), or row r
// where no order is given. Lane l of a row's group takes the row's entries
// l, l + 4, ... below the row's count, kGather = 4 at a time (their ids,
// then their coordinates and diameters, all loads in flight before the
// first distance), recomputes r^2 as K1 does, and inside the engine cutoff
// (r^2 < c^2, c^2 the product in T) evaluates the potential's functor
// (pair_potentials.cuh, shared with the cell sweeps) with both diameters,
// adding f/r d to the force and u and f/r r^2 to the energy and virial. A
// group's lanes meet in a fixed two-level shuffle tree; the groups' energies
// and virials then meet in a fixed tree over the warp and in warp order over
// the block, one partial a block, which the wrapper sums and halves (every
// pair is in both rows). No float atomics: the result repeats bit for bit,
// and a row's force does not depend on where its worker lies.
//
// What bounds them on the H100, and what the design does about it. K2 at
// the bench (65,536 LJ particles, rho 0.8, r_c 2.5, skin 0.3; ~74 entries a
// row): bytes by the HBM count, the list's occupied entries (4.8 M int32,
// 19 MB) beside 1 MB of positions and forces; in practice the latency of
// its gathers and its instructions. The first design gave a row a warp:
// ~2.3 entries a lane, a third pass with 22 of 32 lanes idle, a five-level
// tree over D + 2 sums a row. Four lanes a row take ~18 entries each, and
// four loads a lane in flight hide the chain id -> coordinates. The gathers
// of pos[j] hit L1 only where a block's rows are neighbours in space: in
// particle order that holds only while the particles keep the order of the
// lattice they started from, and after a packing or a long run it does not;
// rows in cell order make it hold always. K1: the stencil's candidates
// (~34 M distances of ~21 operations) and the (N, K) list written once
// (34 MB). The first design fetched every candidate's id and position from
// L2 once for each of the ~19 particles of its cell, in chains of three
// dependent loads a stencil cell, 19 of 32 lanes working, and divided by L
// three times a candidate (an IEEE division, and at f64 a long one); the
// staged window fetches each candidate once a block, keeps the lanes on
// distances, ~500 candidates a particle in full rounds of 32, and
// multiplies by 1 / L.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_potentials.cuh"

namespace {

using namespace mdtpu;

constexpr int kThreads = 256;            // K2: kThreads / kLanes rows a block
constexpr int kLanes = 4;                // K2: lanes a row
constexpr int kGather = 4;               // K2: entries a lane loads at once
constexpr int kBuildThreads = 256;       // K1: 8 warps a block (one cell)
constexpr int kOwnBatch = 64;            // K1: own particles a block holds
constexpr int kStageBatch = 4;           // K1: candidates a thread loads
constexpr int kMaxDynamicShared = 227 * 1024 - 1024;  // less static, spare
constexpr int kErrShape = -5;            // n, cap or K outside what it takes

__device__ __forceinline__ float round_even(float x) { return rintf(x); }
__device__ __forceinline__ double round_even(double x) { return rint(x); }

// The minimum image of one component, d - L rint(d * (1 / L)). It takes
// the same image as d - L rint(d / L), bit for bit, wherever either lies
// within L / 2 of 0 by more than a few ulps: the two quotients differ by at
// most ~2 ulps, so their rint differ only where d / L is that close to a
// half-integer, and there either image leaves |d| ~ L / 2, which the grid
// (at least 3 cells of r_list a side, so L >= 3 r_list) puts outside the
// list radius and the cutoff: no hit, no entry, no force changes.
template <typename T>
__device__ __forceinline__ T min_image(T dk, T len, T inv_len) {
  return dk - len * round_even(dk * inv_len);
}

// Minimum-image displacement xi - xj in d and its r^2, in the JAX order.
template <typename T, int D>
__device__ __forceinline__ T min_image_r2(const T (&xi)[D], const T (&xj)[D],
                                          const T (&len)[D],
                                          const T (&inv_len)[D], T (&d)[D]) {
  T r2 = T(0);
#pragma unroll
  for (int a = 0; a < D; ++a) {
    d[a] = min_image(xi[a] - xj[a], len[a], inv_len[a]);
    r2 = r2 + d[a] * d[a];
  }
  return r2;
}

template <typename T, int D>
__global__ void __launch_bounds__(kBuildThreads)
    nl_build_kernel(const T* __restrict__ pos, const int* __restrict__ order,
                    const int64_t* __restrict__ starts,
                    const int* __restrict__ cell_buf,
                    const int64_t* __restrict__ counts,
                    const T* __restrict__ lengths, int n, int nx, int ny,
                    int nz, int cap, int k_max, T r_list2, int stage_cells,
                    int* __restrict__ idx, int* __restrict__ count,
                    int* __restrict__ overflow) {
  constexpr int kCells = D == 3 ? 27 : 9;
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char build_smem[];
  __shared__ int s_nb[kCells];         // the stencil cells' grid indices
  __shared__ int s_off[kCells + 1];    // occupied slots before each
  __shared__ int s_own[kOwnBatch];     // own particles of this batch
  __shared__ int s_hits[kOwnBatch];    // their hits before this stage

  const int cell = blockIdx.x;
  const int64_t own_n = counts[cell];
  if (own_n <= 0) return;  // the whole block
  const int64_t own0 = starts[cell];
  const int stage_cap = stage_cells * cap;
  T* s_x = reinterpret_cast<T*>(build_smem);  // D rows of stage_cap
  int* s_id = reinterpret_cast<int*>(s_x + (size_t)D * stage_cap);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int warps = kBuildThreads / 32;
  const int g[3] = {nx, ny, nz};
  T len[D], inv_len[D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    len[a] = lengths[a];
    inv_len[a] = T(1) / len[a];
  }

  // Warp 0: lane s takes stencil cell s (offsets -1, 0, 1 on every axis,
  // the last fastest): its grid index, its occupied slots and their scan.
  if (warp == 0) {
    int m = 0;
    bool over = false;
    if (lane < kCells) {
      int home[D], c = cell, t = lane, nb = 0;
#pragma unroll
      for (int a = D - 1; a >= 0; --a) {
        home[a] = c % g[a];
        c /= g[a];
      }
#pragma unroll
      for (int a = D - 1; a >= 0; --a) {
        home[a] += t % 3 - 1;
        t /= 3;
      }
#pragma unroll
      for (int a = 0; a < D; ++a) {
        const int j = home[a] < 0 ? home[a] + g[a]
                                  : (home[a] >= g[a] ? home[a] - g[a]
                                                     : home[a]);
        nb = nb * g[a] + j;
      }
      const int64_t cnt = counts[nb];
      over = cnt > cap;
      m = cnt < cap ? (int)cnt : cap;
      s_nb[lane] = nb;
    }
    int incl = m;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane < kCells) s_off[lane + 1] = incl;
    if (lane == 0) s_off[0] = 0;
    if (__any_sync(kFull, over) && lane == 0) *overflow = 1;
  }

  for (int64_t b0 = 0; b0 < own_n; b0 += kOwnBatch) {
    const int n_own =
        (int)(own_n - b0 < kOwnBatch ? own_n - b0 : (int64_t)kOwnBatch);
    __syncthreads();  // the stencil; the last batch's readers are done
    for (int k = threadIdx.x; k < n_own; k += kBuildThreads) {
      s_own[k] = order[own0 + b0 + k];
      s_hits[k] = 0;
    }
    for (int s0 = 0; s0 < kCells; s0 += stage_cells) {
      const int s1 = s0 + stage_cells;
      const int c0 = s_off[s0];
      const int n_cand = s_off[s1] - c0;
      if (stage_cells < kCells || b0 == 0) {
        __syncthreads();  // the last stage's readers are done
        // Stage the occupied slots of stencil cells [s0, s1), kStageBatch
        // candidates a thread in flight; c only grows with t.
        int c = s0;
        for (int t0 = threadIdx.x; t0 < n_cand;
             t0 += kStageBatch * kBuildThreads) {
          int j[kStageBatch];
#pragma unroll
          for (int q = 0; q < kStageBatch; ++q) {
            const int t = t0 + q * kBuildThreads;
            j[q] = -1;
            if (t < n_cand) {
              while (s_off[c + 1] <= c0 + t) ++c;
              j[q] = cell_buf[(int64_t)s_nb[c] * cap + (c0 + t - s_off[c])];
            }
          }
          T x[kStageBatch][D];
#pragma unroll
          for (int q = 0; q < kStageBatch; ++q) {
#pragma unroll
            for (int a = 0; a < D; ++a)
              x[q][a] = j[q] >= 0 ? pos[(int64_t)j[q] * D + a] : T(0);
          }
#pragma unroll
          for (int q = 0; q < kStageBatch; ++q) {
            const int t = t0 + q * kBuildThreads;
            if (t < n_cand) {
              s_id[t] = j[q];
#pragma unroll
              for (int a = 0; a < D; ++a) s_x[a * stage_cap + t] = x[q][a];
            }
          }
        }
      }
      __syncthreads();
      for (int p = warp; p < n_own; p += warps) {
        const int i = s_own[p];
        T xi[D];
#pragma unroll
        for (int a = 0; a < D; ++a) xi[a] = pos[(int64_t)i * D + a];
        int hits = s_hits[p];
        int* row = idx + (int64_t)i * k_max;
        for (int base = 0; base < n_cand; base += 32) {
          const int t = base + lane;
          bool hit = false;
          int j = n;
          if (t < n_cand) {
            j = s_id[t];
            if (j != i) {
              T xj[D], d[D];
#pragma unroll
              for (int a = 0; a < D; ++a) xj[a] = s_x[a * stage_cap + t];
              hit = min_image_r2<T, D>(xi, xj, len, inv_len, d) < r_list2;
            }
          }
          const unsigned mask = __ballot_sync(kFull, hit);
          if (hit) {
            const int at = hits + __popc(mask & ((1u << lane) - 1u));
            if (at < k_max) row[at] = j;
          }
          hits += __popc(mask);
        }
        if (s1 == kCells) {
          const int kept = hits < k_max ? hits : k_max;
          for (int k = kept + lane; k < k_max; k += 32) row[k] = n;
          if (lane == 0) {
            count[i] = kept;
            if (hits > k_max) *overflow = 1;
          }
        } else if (lane == 0) {
          s_hits[p] = hits;
        }
      }
    }
  }
}

template <typename T, int D, typename Pot>
__global__ void __launch_bounds__(kThreads)
    nl_forces_kernel(const T* __restrict__ pos, const T* __restrict__ diam,
                     const int* __restrict__ idx,
                     const int* __restrict__ count,
                     const int* __restrict__ order,
                     const T* __restrict__ lengths, int n, int k_max,
                     T cutoff2, Pot pot, T* __restrict__ force,
                     T* __restrict__ e_part, T* __restrict__ w_part) {
  constexpr int G = kLanes;
  constexpr int kRows = kThreads / G;
  constexpr int kWarps = kThreads / 32;
  __shared__ T red_e[kWarps], red_w[kWarps];
  const int grp = threadIdx.x / G;
  const int sub = threadIdx.x % G;
  const int r = blockIdx.x * kRows + grp;
  T e = T(0), w = T(0), f[D];
#pragma unroll
  for (int a = 0; a < D; ++a) f[a] = T(0);
  int i = 0;
  if (r < n) {
    i = order != nullptr ? order[r] : r;
    T xi[D], len[D], inv_len[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      xi[a] = pos[(int64_t)i * D + a];
      len[a] = lengths[a];
      inv_len[a] = T(1) / len[a];
    }
    const T di = diam[i];
    const auto setup = pot.setup(di);
    const int* row = idx + (int64_t)i * k_max;
    const int m = count[i];
    // The lane's entries k0, k0 + G, ... in order, kGather at a time: their
    // ids, then their coordinates and diameters, all loads in flight
    // before the first distance.
    for (int k0 = sub; k0 < m; k0 += kGather * G) {
      int j[kGather];
#pragma unroll
      for (int q = 0; q < kGather; ++q) {
        const int k = k0 + q * G;
        j[q] = k < m ? __ldg(row + k) : -1;
      }
      T xj[kGather][D], dj[kGather];
#pragma unroll
      for (int q = 0; q < kGather; ++q) {
#pragma unroll
        for (int a = 0; a < D; ++a)
          xj[q][a] = j[q] >= 0 ? __ldg(pos + (int64_t)j[q] * D + a) : T(0);
        dj[q] = j[q] >= 0 ? __ldg(diam + j[q]) : T(1);
      }
#pragma unroll
      for (int q = 0; q < kGather; ++q) {
        T d[D];
        const T r2 = min_image_r2<T, D>(xi, xj[q], len, inv_len, d);
        if (j[q] < 0 || !(r2 < cutoff2)) continue;
        T u, fr;
        pot(setup, r2, di, dj[q], u, fr);
#pragma unroll
        for (int a = 0; a < D; ++a) f[a] += fr * d[a];
        e += u;
        w += fr * r2;
      }
    }
  }
  // Every lane of the warp takes part (a group past the last row adds
  // zeros): a segment of G lanes sums into its first lane, then the
  // groups' first lanes sum the energies and virials into lane 0.
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < D; ++a)
      f[a] += __shfl_down_sync(0xffffffffu, f[a], off, G);
    e += __shfl_down_sync(0xffffffffu, e, off, G);
    w += __shfl_down_sync(0xffffffffu, w, off, G);
  }
  if (sub == 0 && r < n) {
#pragma unroll
    for (int a = 0; a < D; ++a) force[(int64_t)i * D + a] = f[a];
  }
#pragma unroll
  for (int off = 16; off >= G; off >>= 1) {
    e += __shfl_down_sync(0xffffffffu, e, off);
    w += __shfl_down_sync(0xffffffffu, w, off);
  }
  if ((threadIdx.x & 31) == 0) {
    red_e[threadIdx.x >> 5] = e;
    red_w[threadIdx.x >> 5] = w;
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

template <typename T>
int build(const T* pos, const int* order, const int64_t* starts,
          const int* cell_buf, const int64_t* counts, const T* lengths,
          int n, int dim, int nx, int ny, int nz, int cap, int k_max,
          double r_list2, int stage_cells, int* idx, int* count,
          int* overflow, void* stream_ptr) {
  if (n < 1 || cap < 1 || k_max < 1) return kErrShape;
  if (nx < 3 || ny < 3 || (dim == 3 ? nz < 3 : nz != 1)) return kErrGrid;
  if (dim != 2 && dim != 3) return kErrGrid;
  const int cells = dim == 3 ? 27 : 9;
  if (stage_cells < 1 || stage_cells > cells || cells % stage_cells != 0)
    return kErrPlan;
  const size_t bytes =
      (size_t)stage_cells * cap * (dim * sizeof(T) + sizeof(int));
  if (bytes > (size_t)kMaxDynamicShared) return kErrCapacity;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto launch = [&](auto kernel) {
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(kernel),
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<nx * ny * nz, kBuildThreads, bytes, stream>>>(
        pos, order, starts, cell_buf, counts, lengths, n, nx, ny, nz, cap,
        k_max, T(r_list2), stage_cells, idx, count, overflow);
    return (int)cudaGetLastError();
  };
  return dim == 3 ? launch(nl_build_kernel<T, 3>)
                  : launch(nl_build_kernel<T, 2>);
}

template <typename T>
int forces(const T* pos, const T* diam, const int* idx, const int* count,
           const int* order, const T* lengths, int n, int dim, int k_max,
           double cutoff, int kind, double p0, double p1, double p2,
           double p3, int i0, int i1, int i2, T* force, T* e_part, T* w_part,
           void* stream_ptr) {
  if (n < 1 || k_max < 1) return kErrShape;
  if (dim != 2 && dim != 3) return kErrGrid;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const T c = T(cutoff);
  const T cutoff2 = c * c;
  const int rows = kThreads / kLanes;
  const int blocks = (n + rows - 1) / rows;
  return with_potential<T>(kind, p0, p1, p2, p3, i0, i1, i2, [&](auto pot) {
    using Pot = decltype(pot);
    auto kernel = dim == 3 ? nl_forces_kernel<T, 3, Pot>
                           : nl_forces_kernel<T, 2, Pot>;
    kernel<<<blocks, kThreads, 0, stream>>>(pos, diam, idx, count, order,
                                            lengths, n, k_max, cutoff2, pot,
                                            force, e_part, w_part);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// K1. pos (n, dim); order (n,) the particles sorted by cell and starts
// (n_cells,) int64 where each cell's run of them begins; cell_buf (n_cells,
// cap) particle ids by cell; counts (n_cells,) particles binned per cell
// (may exceed cap); lengths (dim,); a 2D grid has nz = 1. r_list2: the
// squared list radius in double, rounded to the kernel's type.
// stage_cells: the stencil cells a stage of shared memory holds (a divisor
// of 3^dim). Writes idx (n, k_max), count (n,) and, on overflow, 1 into
// *overflow (which the caller zeroes).
int mdtpu_nl_build_f32(const float* pos, const int* order,
                       const int64_t* starts, const int* cell_buf,
                       const int64_t* counts, const float* lengths, int n,
                       int dim, int nx, int ny, int nz, int cap, int k_max,
                       double r_list2, int stage_cells, int* idx, int* count,
                       int* overflow, void* stream) {
  return build<float>(pos, order, starts, cell_buf, counts, lengths, n, dim,
                      nx, ny, nz, cap, k_max, r_list2, stage_cells, idx,
                      count, overflow, stream);
}

int mdtpu_nl_build_f64(const double* pos, const int* order,
                       const int64_t* starts, const int* cell_buf,
                       const int64_t* counts, const double* lengths, int n,
                       int dim, int nx, int ny, int nz, int cap, int k_max,
                       double r_list2, int stage_cells, int* idx, int* count,
                       int* overflow, void* stream) {
  return build<double>(pos, order, starts, cell_buf, counts, lengths, n, dim,
                       nx, ny, nz, cap, k_max, r_list2, stage_cells, idx,
                       count, overflow, stream);
}

// K2. order (n,) the rows' order (null: particle order); the potential as
// with_potential (pair_potentials.cuh) takes it; writes force (n, dim) and
// one energy and one virial partial per block of kThreads / kLanes = 64
// rows (unhalved).
int mdtpu_nl_forces_f32(const float* pos, const float* diam, const int* idx,
                        const int* count, const int* order,
                        const float* lengths, int n, int dim, int k_max,
                        double cutoff, int kind, double p0, double p1,
                        double p2, double p3, int i0, int i1, int i2,
                        float* force, float* e_part, float* w_part,
                        void* stream) {
  return forces<float>(pos, diam, idx, count, order, lengths, n, dim, k_max,
                       cutoff, kind, p0, p1, p2, p3, i0, i1, i2, force,
                       e_part, w_part, stream);
}

int mdtpu_nl_forces_f64(const double* pos, const double* diam,
                        const int* idx, const int* count, const int* order,
                        const double* lengths, int n, int dim, int k_max,
                        double cutoff, int kind, double p0, double p1,
                        double p2, double p3, int i0, int i1, int i2,
                        double* force, double* e_part, double* w_part,
                        void* stream) {
  return forces<double>(pos, diam, idx, count, order, lengths, n, dim, k_max,
                        cutoff, kind, p0, p1, p2, p3, i0, i1, i2, force,
                        e_part, w_part, stream);
}

const char* mdtpu_neighbor_list_error_string(int code) {
  if (code == kErrShape) return "particle count, cell capacity or K < 1";
  return mdtpu::error_string(code);
}

}  // extern "C"
