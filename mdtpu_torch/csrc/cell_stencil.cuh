// The staged stencil shared by the full-stencil pair sweep (cell_sweep.cu)
// and the pair-list builder (cell_pairs.cu), for 2D and 3D grids and any
// cell matrix.
//
// A block works for one cell of a periodic grid of cells. Its stencil is the
// 3^D cells around it, in (ox, oy[, oz]) order, the last axis fastest. The
// occupied slots of a run of stencil cells are staged in shared memory as one
// compacted candidate list, each candidate already carried to the image
// nearest the block's cell: a neighbour found across the grid's edge along
// axis a takes the full cell vector w_a * cell[:, a] (w_a = +-1), the column
// of the cell matrix, so tilted boxes need no other code than orthorhombic
// ones (their off-diagonal terms are zero). This is the ghost shift of the
// JAX package's sweeps (mdtpu/ops/cell_grid.py: ghost_shift, :736-739 for
// the 3D window, _ywindow_sweep :556 for 2D).
//
// Plain coordinates take the summed shift sum_a w_a cell[k, a] (in axis
// order). Under HILO the shift goes onto the hi word one column at a time
// through an error-free two_sum, its residuals folded into the lo word
// (ghost_shift_hilo, cell_grid.py:189): a staged image stays exact to the
// two-float representation in a tilted box too. Zero terms are skipped;
// two_sum with zero is the identity, so this changes no bit.
//
// Candidate records: D + 1 words, (x, y[, z], diameter): 16 bytes at float32
// in 3D (one float4), 12 in 2D. The lo words take 4 words in 3D (xl, yl,
// zl, 0; one float4) and 2 in 2D.

#pragma once

#include <math.h>

#include <type_traits>

#include "pair_potentials.cuh"

namespace mdtpu {

template <int D>
struct Stencil {
  static_assert(D == 2 || D == 3, "2D or 3D grids");
  static constexpr int kCells = D == 3 ? 27 : 9;
  static constexpr int kCentre = D == 3 ? 13 : 4;  // offset (0, .., 0)
  static constexpr int kWords = D + 1;             // x, y[, z], diameter
  static constexpr int kLoWords = D == 3 ? 4 : 2;  // xl, yl[, zl, 0]
};

constexpr int kMeta = 32;       // per-stage cell records (27 used), padded
constexpr int kStageBatch = 4;  // candidates a thread loads before it stores

template <int D, typename T>
__device__ __forceinline__ void load_cand(const T* list, int k, T (&x)[D],
                                          T& d) {
  if constexpr (D == 3) {
    if constexpr (sizeof(T) == 4) {
      const float4 v = reinterpret_cast<const float4*>(list)[k];
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      d = v.w;
    } else {
      const double2 a = reinterpret_cast<const double2*>(list)[2 * k];
      const double2 b = reinterpret_cast<const double2*>(list)[2 * k + 1];
      x[0] = a.x;
      x[1] = a.y;
      x[2] = b.x;
      d = b.y;
    }
  } else {
    x[0] = list[3 * k];
    x[1] = list[3 * k + 1];
    d = list[3 * k + 2];
  }
}

template <int D, typename T>
__device__ __forceinline__ void store_cand(T* list, int k, const T (&x)[D],
                                           T d) {
  if constexpr (D == 3) {
    if constexpr (sizeof(T) == 4) {
      reinterpret_cast<float4*>(list)[k] = make_float4(x[0], x[1], x[2], d);
    } else {
      reinterpret_cast<double2*>(list)[2 * k] = make_double2(x[0], x[1]);
      reinterpret_cast<double2*>(list)[2 * k + 1] = make_double2(x[2], d);
    }
  } else {
    list[3 * k] = x[0];
    list[3 * k + 1] = x[1];
    list[3 * k + 2] = d;
  }
}

// A candidate at infinity: any distance to it fails every cutoff test.
template <int D, typename T>
__device__ __forceinline__ void store_far(T* list, int k) {
  T x[D];
  x[0] = T(INFINITY);
#pragma unroll
  for (int a = 1; a < D; ++a) x[a] = T(0);
  store_cand<D>(list, k, x, T(0));
}

template <int D, typename T>
__device__ __forceinline__ void load_lo(const T* list, int k, T (&x)[D]) {
  T pad;
  if constexpr (D == 3) {
    load_cand<3>(list, k, x, pad);
  } else {
    x[0] = list[2 * k];
    x[1] = list[2 * k + 1];
  }
}

template <int D, typename T>
__device__ __forceinline__ void store_lo(T* list, int k, const T (&x)[D]) {
  if constexpr (D == 3) {
    store_cand<3>(list, k, x, T(0));
  } else {
    list[2 * k] = x[0];
    list[2 * k + 1] = x[1];
  }
}

// The block's cell and its coordinates on the grid (n[2] = 1 in 2D).
struct GridCell {
  int n[3];
  int home[3];
  __device__ GridCell(int cell, int nx, int ny, int nz) {
    n[0] = nx;
    n[1] = ny;
    n[2] = nz;
    home[2] = cell % nz;
    home[1] = (cell / nz) % ny;
    home[0] = cell / (ny * nz);
  }
};

// The wrap w in {-1, 0, +1} of stencil cell c along grid axis a: the
// neighbour's index along a is home + offset - w n.
template <int D>
__device__ __forceinline__ int stencil_wrap(const GridCell& g, int c, int a) {
  const int div = D == 3 ? (a == 0 ? 9 : (a == 1 ? 3 : 1)) : (a == 0 ? 3 : 1);
  const int j = g.home[a] + (c / div) % 3 - 1;
  return j < 0 ? -1 : (j >= g.n[a] ? 1 : 0);
}

// Warp 0: the stencil's cells, one per lane: grid index (s_nb), summed
// image shift (s_shift, D rows of kMeta), and the candidates before each
// (s_off, kCells + 1 entries; an inclusive scan of the clamped counts).
// cellm: the D x D cell matrix, row-major (its columns are the box vectors).
template <int D, typename T>
__device__ __forceinline__ void stencil_meta(const GridCell& g, int lane,
                                             const int64_t* counts,
                                             const T* cellm, int cap,
                                             T* s_shift, int* s_off,
                                             int* s_nb) {
  constexpr int S = Stencil<D>::kCells;
  int n = 0;
  if (lane < S) {
    int w[D];
    int nb = 0;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      w[a] = stencil_wrap<D>(g, lane, a);
      const int div = D == 3 ? (a == 0 ? 9 : (a == 1 ? 3 : 1))
                             : (a == 0 ? 3 : 1);
      const int j = g.home[a] + (lane / div) % 3 - 1 - w[a] * g.n[a];
      nb = nb * g.n[a] + j;
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      T sh = T(w[0]) * cellm[k * D];
#pragma unroll
      for (int a = 1; a < D; ++a) sh = sh + T(w[a]) * cellm[k * D + a];
      s_shift[k * kMeta + lane] = sh;
    }
    const int64_t cnt = counts[nb];
    n = cnt < cap ? (int)cnt : cap;
    if (n < 0) n = 0;
    s_nb[lane] = nb;
  }
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane < S) s_off[lane + 1] = incl;
  if (lane == 0) s_off[0] = 0;
}

// The most stencil cells whose occupied slots fit in one stage of list_len
// candidates: all 3^D, else 9, 3 or 1 at a time (one cell always fits).
// As stage_cells in ops/cell_sweep.py.
template <int D>
__device__ __forceinline__ int cells_per_stage(const int* s_off,
                                               int list_len) {
  constexpr int S = Stencil<D>::kCells;
  int cells = S;
  while (cells > 1) {
    int longest = 0;
    for (int c = 0; c < S; c += cells) {
      const int n = s_off[c + cells] - s_off[c];
      longest = n > longest ? n : longest;
    }
    if (longest <= list_len) break;
    cells /= 3;
  }
  return cells;
}

// Stage stencil cells [c0, c0 + cells) into cand (and cand_lo under HILO):
// the threads share the entries evenly; each finds its entry's cell in the
// offsets and loads kStageBatch entries before it stores the first, so the
// loads are in flight together. Then candidates at infinity fill the last
// chunk of `chunk` and make one more. pos, lo: (D, n_slots); diam:
// (n_slots,). Ends with a barrier.
template <int D, bool HILO, typename T>
__device__ __forceinline__ void stage_candidates(
    const GridCell& g, int c0, int cells, const int* s_off, const int* s_nb,
    const T* s_shift, const T* __restrict__ pos, const T* __restrict__ lo,
    const T* __restrict__ diam, const T* __restrict__ cellm, int64_t n_slots,
    int cap, int chunk, T* cand, T* cand_lo) {
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int start = s_off[c0];
  const int n_stage = s_off[c0 + cells] - start;
  for (int first = tid; first < n_stage; first += kStageBatch * threads) {
    int c[kStageBatch];
    T x[kStageBatch][D], xl[kStageBatch][D], d[kStageBatch];
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int k = first + b * threads;
      c[b] = -1;
      if (k < n_stage) {
        // The last cell with s_off[cell] <= start + k.
        int below = c0, above = c0 + cells;
        while (above - below > 1) {
          const int mid = (below + above) >> 1;
          if (s_off[mid] <= start + k) below = mid; else above = mid;
        }
        c[b] = below;
        const int64_t src =
            (int64_t)s_nb[below] * cap + (start + k - s_off[below]);
#pragma unroll
        for (int a = 0; a < D; ++a) {
          x[b][a] = pos[a * n_slots + src];
          if (HILO) xl[b][a] = lo[a * n_slots + src];
        }
        d[b] = diam[src];
      }
    }
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      if (c[b] < 0) continue;
      const int k = first + b * threads;
      if (HILO) {
        // Column by column (each component takes its terms in axis order),
        // for a cell that wraps: one that does not has a zero shift (the
        // cell matrix is not singular) and takes none.
        bool wrapped = false;
#pragma unroll
        for (int a = 0; a < D; ++a)
          wrapped = wrapped || s_shift[a * kMeta + c[b]] != T(0);
#pragma unroll
        for (int a = 0; a < D && wrapped; ++a) {
          const int w = stencil_wrap<D>(g, c[b], a);
          if (w == 0) continue;
#pragma unroll
          for (int kk = 0; kk < D; ++kk) {
            const T term = T(w) * cellm[kk * D + a];
            if (term != T(0)) {
              T s, r;
              two_sum(x[b][kk], term, s, r);
              x[b][kk] = s;
              xl[b][kk] = xl[b][kk] + r;
            }
          }
        }
        store_cand<D>(cand, k, x[b], d[b]);
        store_lo<D>(cand_lo, k, xl[b]);
      } else {
#pragma unroll
        for (int a = 0; a < D; ++a)
          x[b][a] = x[b][a] + s_shift[a * kMeta + c[b]];
        store_cand<D>(cand, k, x[b], d[b]);
      }
    }
  }
  const int n_chunks = (n_stage + chunk - 1) / chunk;
  for (int p = tid; p < 2 * chunk; p += threads)
    if (n_stage + p < (n_chunks + 1) * chunk) store_far<D>(cand, n_stage + p);
  __syncthreads();
}

// The displacement own - candidate: plain, or under HILO
// s + (e + (lo_i - lo_j)) with (s, e) = two_sum(hi_i, -hi_j) per component;
// and r^2 in the plain versions' order.
template <int D, bool HILO, typename T>
__device__ __forceinline__ T displacement(const T (&xi)[D], const T (&xil)[D],
                                          const T* cand, const T* cand_lo,
                                          int k, T (&dr)[D], T& dj) {
  T x[D];
  load_cand<D>(cand, k, x, dj);
  if (HILO) {
    T xl[D];
    load_lo<D>(cand_lo, k, xl);
#pragma unroll
    for (int a = 0; a < D; ++a) {
      T s, err;
      two_sum(xi[a], -x[a], s, err);
      dr[a] = s + (err + (xil[a] - xl[a]));
    }
  } else {
#pragma unroll
    for (int a = 0; a < D; ++a) dr[a] = xi[a] - x[a];
  }
  T r2 = dr[0] * dr[0];
#pragma unroll
  for (int a = 1; a < D; ++a) r2 = r2 + dr[a] * dr[a];
  return r2;
}

// The longest extent of the box along a coordinate axis: max over k of
// sum_a |cell[k, a]| (in axis order). Every coordinate of a slot and of a
// staged image is below twice this in magnitude. For an orthorhombic box it
// is the longest box length. As box_extent in ops/cell_sweep.py.
template <int D, typename T>
__device__ __forceinline__ T box_extent(const T* cellm) {
  T lmax = T(0);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    T e = fabs(cellm[k * D]);
#pragma unroll
    for (int a = 1; a < D; ++a) e = e + fabs(cellm[k * D + a]);
    lmax = e > lmax ? e : lmax;
  }
  return lmax;
}

// Dynamic-shared-memory carve-out and opt-in above 48 KB for a kernel.
template <typename Kernel>
int prepare_kernel(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > kDefaultSharedBytes)
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  return (int)err;
}

}  // namespace mdtpu
