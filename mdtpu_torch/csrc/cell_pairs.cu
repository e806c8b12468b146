// The pair-list route for NVIDIA Hopper (sm_90a): the candidate pairs of
// the cell grid, and a fixed-order reduction of a potential's values over
// them. Together with the user's potential evaluated in torch on the list
// (ops/cell_pairs.py) they compute what the full-stencil sweep computes
// (cell_sweep.cu, the counterpart of the Pallas kernel
// mdtpu/ops/experimental/pallas_cell.py::_pair_row_kernel, and in 2D of the
// XLA y-window sweep, mdtpu/ops/cell_grid.py:556) for a potential that has
// no functor: a Pallas kernel traces the user's evaluate into its body, a
// CUDA kernel cannot run the user's Python.
//
// cell_pairs_kernel: one block per cell, one thread per own slot. The block
// stages the stencil's occupied slots as the sweep does (cell_stencil.cuh:
// 2D or 3D, image shifts by full cell vectors, hi/lo shifts by two_sum) and
// each own slot walks the staged list in order, computing the displacement
// as the sweep's drain does and testing r^2 < r_c^2 exactly. The count pass
// writes each slot's number of hits; the host-side wrapper turns the counts
// into starts (an exclusive cumulative sum on the device); the fill pass
// walks the same list with the same arithmetic and writes each hit at
// start + rank: the neighbour slot, the displacement components, r^2 and
// the two diameters. Entries at or past the list's capacity are dropped,
// and the wrapper flags the overflow on the device; the fill pass pads the
// entries past the last hit with r^2 = r_c^2 and unit diameters.
//
// pair_reduce_kernel: one thread per slot sums f * disp over its segment in
// list order (the force), and u and f * r^2; the block then reduces the
// last two in a fixed tree into one partial per block, which the wrapper
// sums. No atomics anywhere, so the result repeats bit for bit.
//
// What bounds them on the H100. The list kernel: the stencil's candidates
// times ~10 operations each (a distance and a compare), and the list it
// writes, (d + 3) words and an int a hit: at the user-potential path (2D,
// 65,536 particles, ~9 hits each at rho 0.9 and r_c 1.8, f64) ~0.6 M hits,
// ~27 MB written, so bytes (8 us). The reduction reads the list once more
// and the potential's two values: bytes. The first design is the simple
// one: no filter-then-evaluate split and no several threads a slot (the
// sweep's devices against idle lanes); a block's threads beyond its
// occupied slots idle.

#include <math.h>

#include "cell_stencil.cuh"

namespace {

using namespace mdtpu;

constexpr int kListPad = 2;   // candidates at infinity after a stage

// Dynamic shared memory of one list block; pairs_stage_plan
// (ops/cell_pairs.py) computes the same number.
template <typename T, int D, bool HILO>
size_t shared_bytes(int list_len) {
  const size_t words =
      Stencil<D>::kWords + (HILO ? Stencil<D>::kLoWords : 0);
  return (words * ((size_t)list_len + kListPad) + 3 * kMeta) * sizeof(T) +
         2 * kMeta * sizeof(int);
}

// pos, lo: (D, n_slots) slot coordinates (lo under HILO only); diam:
// (n_slots,); counts: (n_cells,); cellm: (D, D) cell matrix, row-major. The
// count pass (FILL = false) writes seg_count for every slot (0 on vacant
// ones); the fill pass reads seg_start and writes the hits of each slot at
// seg_start + rank where that is below capacity: nb_out (capacity,),
// disp_out (D, capacity), r2_out, sig_i_out, sig_j_out (capacity,).
template <typename T, int D, bool HILO, bool FILL>
__global__ void __launch_bounds__(1024)
    cell_pairs_kernel(const T* __restrict__ pos, const T* __restrict__ lo,
                      const T* __restrict__ diam,
                      const int64_t* __restrict__ counts,
                      const T* __restrict__ cellm, int nx, int ny, int nz,
                      int cap, int list_len, T rc_engine,
                      int* __restrict__ seg_count,
                      const int64_t* __restrict__ seg_start,
                      int64_t capacity, int* __restrict__ nb_out,
                      T* __restrict__ disp_out, T* __restrict__ r2_out,
                      T* __restrict__ sig_i_out, T* __restrict__ sig_j_out) {
  constexpr int kStencil = Stencil<D>::kCells;
  constexpr int kCentre = Stencil<D>::kCentre;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int list_cap = list_len + kListPad;
  T* cand = reinterpret_cast<T*>(smem_raw);
  T* cand_lo = cand + Stencil<D>::kWords * list_cap;  // HILO only
  T* s_shift = cand_lo + (HILO ? Stencil<D>::kLoWords * list_cap : 0);
  int* s_off = reinterpret_cast<int*>(s_shift + 3 * kMeta);
  int* s_nb = s_off + kMeta;

  const int64_t n_slots = (int64_t)nx * ny * nz * cap;
  const int cell = blockIdx.x;
  const GridCell g(cell, nx, ny, nz);
  const int tid = threadIdx.x;
  const int64_t cnt_own = counts[cell];
  if (tid < 32)
    stencil_meta<D>(g, tid, counts, cellm, cap, s_shift, s_off, s_nb);
  const int n_own = cnt_own < cap ? (cnt_own > 0 ? (int)cnt_own : 0) : cap;
  const bool active = tid < n_own;
  const int64_t own = (int64_t)cell * cap + tid;
  T xi[D], xil[D], di = T(0);
#pragma unroll
  for (int a = 0; a < D; ++a) {
    xi[a] = T(0);
    xil[a] = T(0);
  }
  if (active) {
#pragma unroll
    for (int a = 0; a < D; ++a) {
      xi[a] = pos[a * n_slots + own];
      if (HILO) xil[a] = lo[a * n_slots + own];
    }
    di = diam[own];
  }
  const T cutoff2 = rc_engine * rc_engine;
  int64_t next = (FILL && active) ? seg_start[own] : 0;
  int hits = 0;
  __syncthreads();

  const int per_stage = cells_per_stage<D>(s_off, list_len);
  for (int c0 = 0; c0 < kStencil && n_own > 0; c0 += per_stage) {
    if (c0 > 0) __syncthreads();  // the previous stage is no longer read
    const int start = s_off[c0];
    const int n_stage = s_off[c0 + per_stage] - start;
    stage_candidates<D, HILO>(g, c0, per_stage, s_off, s_nb, s_shift, pos,
                              lo, diam, cellm, n_slots, cap, 1, cand,
                              cand_lo);
    if (!active) continue;
    const int self_k = kCentre >= c0 && kCentre < c0 + per_stage
                           ? s_off[kCentre] - start + tid
                           : -1;
    int c = c0;  // the stencil cell of candidate k
    for (int k = 0; k < n_stage; ++k) {
      T dr[D], dj;
      const T r2 = displacement<D, HILO>(xi, xil, cand, cand_lo, k, dr, dj);
      if (k == self_k || !(r2 < cutoff2)) continue;
      ++hits;
      if (!FILL) continue;
      const int64_t at = next++;
      if (at >= capacity) continue;
      while (s_off[c + 1] <= start + k) ++c;
      nb_out[at] = (int)((int64_t)s_nb[c] * cap + (start + k - s_off[c]));
#pragma unroll
      for (int a = 0; a < D; ++a) disp_out[a * capacity + at] = dr[a];
      r2_out[at] = r2;
      sig_i_out[at] = di;
      sig_j_out[at] = dj;
    }
  }
  if (!FILL) {
    if (tid < cap) seg_count[(int64_t)cell * cap + tid] = hits;
    return;
  }
  // The entries past the last hit: r^2 at the engine cutoff squared (beyond
  // every potential's range), unit diameters, zero displacement, as the
  // plain version pads them, so the potential sees defined values there.
  const int64_t total = seg_start[n_slots - 1] + seg_count[n_slots - 1];
  for (int64_t at = total + (int64_t)blockIdx.x * blockDim.x + tid;
       at < capacity; at += (int64_t)gridDim.x * blockDim.x) {
    nb_out[at] = 0;
#pragma unroll
    for (int a = 0; a < D; ++a) disp_out[a * capacity + at] = T(0);
    r2_out[at] = cutoff2;
    sig_i_out[at] = T(1);
    sig_j_out[at] = T(1);
  }
}

// One thread per slot: its force, and its share of sum u and sum f r^2;
// then a fixed-order block reduction of the two (OBS only).
template <typename T, int D, bool OBS>
__global__ void pair_reduce_kernel(const int64_t* __restrict__ seg_start,
                                   const int* __restrict__ seg_count,
                                   int64_t capacity, int64_t n_slots,
                                   const T* __restrict__ u,
                                   const T* __restrict__ f,
                                   const T* __restrict__ disp,
                                   const T* __restrict__ r2,
                                   T* __restrict__ force,
                                   T* __restrict__ e_part,
                                   T* __restrict__ w_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  T fs[D], e = T(0), w = T(0);
#pragma unroll
  for (int a = 0; a < D; ++a) fs[a] = T(0);
  if (s < n_slots) {
    const int64_t m0 = seg_start[s];
    int64_t m1 = m0 + seg_count[s];
    m1 = m1 < capacity ? m1 : capacity;
    for (int64_t m = m0; m < m1; ++m) {
      const T fr = f[m];
#pragma unroll
      for (int a = 0; a < D; ++a) fs[a] += fr * disp[a * capacity + m];
      if (OBS) {
        e += u[m];
        w += fr * r2[m];
      }
    }
#pragma unroll
    for (int a = 0; a < D; ++a) force[a * n_slots + s] = fs[a];
  }
  if (!OBS) return;
  T* red = reinterpret_cast<T*>(smem_raw);
  block_reduce2(e, w, red, red + blockDim.x);
  if (threadIdx.x == 0) {
    e_part[blockIdx.x] = red[0];
    w_part[blockIdx.x] = red[blockDim.x];
  }
}

template <typename T, int D, bool HILO>
int pairs(const T* pos, const T* lo, const T* diam, const int64_t* counts,
          const T* cellm, int nx, int ny, int nz, int cap, double cutoff,
          int* seg_count, const int64_t* seg_start, long long capacity,
          int* nb_out, T* disp_out, T* r2_out, T* sig_i_out, T* sig_j_out,
          int list_len, int smem_bytes, int threads, int fill,
          void* stream_ptr) {
  constexpr int kStencil = Stencil<D>::kCells;
  if (cap < 1 || cap > 1024) return kErrCapacity;
  if (nx < 3 || ny < 3 || (D == 3 ? nz < 3 : nz != 1)) return kErrGrid;
  const bool plan_ok = list_len >= cap && list_len <= kStencil * cap &&
                       threads >= 32 && threads <= 1024 &&
                       (threads & (threads - 1)) == 0 && threads >= cap &&
                       capacity >= 1;
  const size_t smem = shared_bytes<T, D, HILO>(list_len);
  if (!plan_ok || smem_bytes < 0 || (size_t)smem_bytes != smem)
    return kErrPlan;
  if (smem > kMaxSharedBytes) return kErrCapacity;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto kernel = fill ? cell_pairs_kernel<T, D, HILO, true>
                     : cell_pairs_kernel<T, D, HILO, false>;
  const int rc = prepare_kernel(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<nx * ny * nz, threads, smem, stream>>>(
      pos, lo, diam, counts, cellm, nx, ny, nz, cap, list_len, T(cutoff),
      seg_count, seg_start, (int64_t)capacity, nb_out, disp_out, r2_out,
      sig_i_out, sig_j_out);
  return (int)cudaGetLastError();
}

// A 2D grid comes as nx x ny x 1.
template <typename T, bool HILO>
int pairs_dim(const T* pos, const T* lo, const T* diam,
              const int64_t* counts, const T* cellm, int nx, int ny, int nz,
              int cap, double cutoff, int* seg_count,
              const int64_t* seg_start, long long capacity, int* nb_out,
              T* disp_out, T* r2_out, T* sig_i_out, T* sig_j_out,
              int list_len, int smem_bytes, int threads, int fill,
              void* stream) {
  auto run = [&](auto dim) {
    return pairs<T, decltype(dim)::value, HILO>(
        pos, lo, diam, counts, cellm, nx, ny, nz, cap, cutoff, seg_count,
        seg_start, capacity, nb_out, disp_out, r2_out, sig_i_out, sig_j_out,
        list_len, smem_bytes, threads, fill, stream);
  };
  return nz == 1 ? run(std::integral_constant<int, 2>())
                 : run(std::integral_constant<int, 3>());
}

constexpr int kReduceThreads = 256;  // REDUCE_THREADS in ops/cell_pairs.py

template <typename T>
int reduce(const int64_t* seg_start, const int* seg_count,
           long long capacity, long long n_slots, int dim, const T* u,
           const T* f, const T* disp, const T* r2, T* force, T* e_part,
           T* w_part, void* stream_ptr) {
  if (dim != 2 && dim != 3) return kErrGrid;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (int)((n_slots + kReduceThreads - 1) / kReduceThreads);
  const size_t smem = u ? 2 * kReduceThreads * sizeof(T) : 0;
  auto launch = [&](auto kernel) {
    kernel<<<blocks, kReduceThreads, smem, stream>>>(
        seg_start, seg_count, (int64_t)capacity, (int64_t)n_slots, u, f,
        disp, r2, force, e_part, w_part);
    return (int)cudaGetLastError();
  };
  if (dim == 2)
    return u ? launch(pair_reduce_kernel<T, 2, true>)
             : launch(pair_reduce_kernel<T, 2, false>);
  return u ? launch(pair_reduce_kernel<T, 3, true>)
           : launch(pair_reduce_kernel<T, 3, false>);
}

}  // namespace

extern "C" {

// fill = 0: the count pass (writes seg_count; seg_start may be null);
// fill = 1: the fill pass. cellm: the (D, D) cell matrix, row-major; a 2D
// grid has nz = 1.
int mdtpu_cell_pairs_f32(const float* pos, const float* diam,
                         const int64_t* counts, const float* cellm, int nx,
                         int ny, int nz, int cap, double cutoff,
                         int* seg_count, const int64_t* seg_start,
                         long long capacity, int* nb_out, float* disp_out,
                         float* r2_out, float* sig_i_out, float* sig_j_out,
                         int list_len, int smem_bytes, int threads, int fill,
                         void* stream) {
  return pairs_dim<float, false>(pos, nullptr, diam, counts, cellm, nx, ny,
                                 nz, cap, cutoff, seg_count, seg_start,
                                 capacity, nb_out, disp_out, r2_out,
                                 sig_i_out, sig_j_out, list_len, smem_bytes,
                                 threads, fill, stream);
}

int mdtpu_cell_pairs_f64(const double* pos, const double* diam,
                         const int64_t* counts, const double* cellm, int nx,
                         int ny, int nz, int cap, double cutoff,
                         int* seg_count, const int64_t* seg_start,
                         long long capacity, int* nb_out, double* disp_out,
                         double* r2_out, double* sig_i_out,
                         double* sig_j_out, int list_len, int smem_bytes,
                         int threads, int fill, void* stream) {
  return pairs_dim<double, false>(pos, nullptr, diam, counts, cellm, nx, ny,
                                  nz, cap, cutoff, seg_count, seg_start,
                                  capacity, nb_out, disp_out, r2_out,
                                  sig_i_out, sig_j_out, list_len, smem_bytes,
                                  threads, fill, stream);
}

// The hi/lo displacement (float32 hi and lo words), rounded to float32.
int mdtpu_cell_pairs_hilo_f32(const float* hi, const float* lo,
                              const float* diam, const int64_t* counts,
                              const float* cellm, int nx, int ny, int nz,
                              int cap, double cutoff, int* seg_count,
                              const int64_t* seg_start, long long capacity,
                              int* nb_out, float* disp_out, float* r2_out,
                              float* sig_i_out, float* sig_j_out,
                              int list_len, int smem_bytes, int threads,
                              int fill, void* stream) {
  return pairs_dim<float, true>(hi, lo, diam, counts, cellm, nx, ny, nz, cap,
                                cutoff, seg_count, seg_start, capacity,
                                nb_out, disp_out, r2_out, sig_i_out,
                                sig_j_out, list_len, smem_bytes, threads,
                                fill, stream);
}

// u = null: the lean reduction (forces only; e_part and w_part unused).
int mdtpu_pair_reduce_f32(const int64_t* seg_start, const int* seg_count,
                          long long capacity, long long n_slots, int dim,
                          const float* u, const float* f, const float* disp,
                          const float* r2, float* force, float* e_part,
                          float* w_part, void* stream) {
  return reduce<float>(seg_start, seg_count, capacity, n_slots, dim, u, f,
                       disp, r2, force, e_part, w_part, stream);
}

int mdtpu_pair_reduce_f64(const int64_t* seg_start, const int* seg_count,
                          long long capacity, long long n_slots, int dim,
                          const double* u, const double* f,
                          const double* disp, const double* r2,
                          double* force, double* e_part, double* w_part,
                          void* stream) {
  return reduce<double>(seg_start, seg_count, capacity, n_slots, dim, u, f,
                        disp, r2, force, e_part, w_part, stream);
}

const char* mdtpu_cell_pairs_error_string(int code) {
  return mdtpu::error_string(code);
}

}  // extern "C"
