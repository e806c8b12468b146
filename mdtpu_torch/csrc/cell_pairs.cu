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
// cell_pairs_kernel, redesigned for the H100. The first design had one
// thread per own slot walking the whole staged stencil alone: at BASELINE
// config 4's shape (2D, about 4 disks a cell) 4 of a block's 32 lanes
// worked, every hit was stored by one lane to its own segment, and every
// call padded the list to its capacity. Measured on the card (PERF.md
// section 6), the kernel is bound by the instructions it issues, and most
// of them were each block's set-up (the stencil's records, the staging),
// which every warp of a block pays: its time grew linearly with the warps
// a block. So:
//
//   * A block takes a run of `cells` consecutive cells of one row (a row:
//     the cells along the grid's last axis) and stages their window once:
//     3^(D-1) stencil rows of cells + 2 cells, row-major (a cell's index in
//     the grid, its wraps and summed image shift, as stencil_meta computes
//     them, and the occupied slots before it), each candidate carried to
//     its image as the sweep's staging does (cell_stencil.cuh: image shifts
//     by full cell vectors, hi/lo shifts by two_sum). In 2D a block of 4
//     cells stages 18 cells where 4 one-cell blocks staged 36. A window
//     that does not fit in shared memory is staged 3 rows or 1 row at a
//     time; one row always fits (the plan's list_len).
//   * Lanes over candidates. Each occupied own slot is taken by a group of G
//     lanes (G = 8, 16 or 32; the block picks the G that needs the fewest
//     warp iterations for its own count and the window's length). In the
//     window's row-major layout the three cells of a stencil row around an
//     own cell are one run of the staged list, so the lanes of a group test
//     G consecutive candidates of that run at once, with the displacement
//     of the sweep's drain (displacement<D, HILO>) and the exact test r^2 <
//     r_c^2; a __ballot_sync over the group and a popcount of the lanes
//     below give each hit its rank: a slot's hits keep the plain version's
//     order (own slot, stencil cell, candidate). G is a choice of speed
//     only: the entries do not depend on it.
//   * Stores. A block's own slots are consecutive in slot order, so its hits
//     are one run of the list. Its first out_len hits go to shared memory and
//     out in one coalesced run at the end; the rest go straight to their
//     entries, a group's hits of a round to consecutive ones.
//   * Two passes with the same arithmetic. The count pass runs the same
//     filter on the same staged words and writes each own slot's hits and
//     its block's; the wrapper sums the blocks' (a cumulative sum on the
//     device) and the fill pass, which takes each block's start from it and
//     its slots' from their counts, writes the starts and the hits. A
//     one-pass scheme would have to learn every earlier block's count
//     before writing (a look-back across blocks) to keep the segments in
//     slot order; two passes decide each pair identically at the cost of a
//     second set-up and filter.
//   * Padding only where it may be stale. Entries past the last hit hold
//     r^2 = r_c^2 and unit diameters, so the potential, which runs over the
//     whole buffer, sees defined values there. A caller that keeps the
//     buffers across calls (the engines do) passes two int64 on the device:
//     where the hits of the call before the last ended (padded_from; the
//     count pass moves last_total into it) and where the last call's ended
//     (last_total; the fill pass writes it). Everything past padded_from is
//     padding already, so the fill pass writes only [total, padded_from).
//     The kernels move the values themselves, so the scheme holds under
//     CUDA-graph replay with no launch of its own. A fresh buffer passes
//     none and is padded to its capacity.
//   * Deterministic: no atomics, the entries depend on the inputs alone.
//
// A run of cells (the sharded engine's slab, parallel/halo_slot.py): the
// launch covers cells [first_cell, first_cell + n_run) of a ghost-extended
// grid and writes the per-slot counts and starts of cell c at (c -
// first_cell) * cap + i; the neighbour slots it writes are slots of the
// whole grid. A launch over every cell (first_cell 0) is the periodic list.
//
// pair_reduce_kernel: one thread per slot sums f * disp over its segment in
// list order (the force), and u and f * r^2; the block then reduces the
// last two in a fixed tree into one partial per block. Redesigned for the
// H100 in two ways, which the wrapper picks by the list's entries a slot
// (its capacity over the slots, a host number). The first design had each
// thread walk its own segment in device memory: where segments are long
// (the 3D lattice's ~27 entries), a warp's load touches 32 scattered
// segments (32 lines of f, D times that of disp) and the warp runs as long
// as its longest one. The segments are contiguous and in slot order, so a
// block's 256 slots own one run of the list: the staged kernel copies it
// chunk by chunk into shared memory with cp.async (two 12 KB buffers in
// turn, the next chunk's copies in flight while the threads sum the staged
// one; no register holds a copy), each word of an entry read as a
// coalesced run of consecutive entries, and each thread adds its own
// entries from there in list order. Where segments are short (BASELINE
// config 4's ~3 entries), a warp's 32 segments fall on a few lines that
// L1 keeps for the next entries, and staging (and the shared memory it
// takes from L1) measured slower than the walk (PERF.md section 6): that
// list keeps the walk, in a kernel with no shared memory for the run.
// Both add the same entries in the same order, so the bits do not change.
// The full variant
// also finishes the sum in the same launch: each block stores its partials
// and takes an integer ticket; the block that draws the last one sums every
// block's partials in block order (thread t the blocks t, t + threads, ...,
// then the same fixed tree), halves them and writes energy and virial, and
// puts the ticket back to 0 for the next call or graph replay. The ticket
// is one integer of device memory per card (a module global), so two full
// reductions must not run at once on two streams of one card. The sum's
// order depends on the block count alone, and the forces never wait on the
// ticket: the result repeats bit for bit, with one launch a call (the
// wrapper's torch sums of the partials took four more).
//
// What bounds them on the H100. The list kernel: the stencil's candidates
// times ~10 operations each (a distance and a compare), and the list it
// writes, (d + 3) words and an int a hit: at the user-potential path (2D,
// 65,536 particles, ~9 hits each at rho 0.9 and r_c 1.8, f64) ~0.6 M hits,
// ~26 MB written, so bytes (8 us). The reduction reads the list once more
// and the potential's two values: bytes. Its partials add two values a
// block of 256 slots, which the last block reads once more.

#include <cuda_pipeline.h>
#include <math.h>

#include "cell_stencil.cuh"

namespace {

using namespace mdtpu;

constexpr int kMaxWindow = 32;  // window cells a block stages: one warp's

__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Dynamic shared memory of one list block of `cells` own cells with room
// for out_len hits, region by region (each rounded up to 16 bytes);
// list_shared_bytes (ops/cell_pairs.py) computes the same.
template <typename T, int D, bool HILO>
struct ListLayout {
  size_t cand, cand_lo, own, shift, next, off, nb, wrap, ids, own_off, out_nb,
      out_f, total;
  __host__ __device__ ListLayout(int list_len, int cap, int cells,
                                 int out_len) {
    const size_t n = (size_t)list_len;
    const size_t slots = (size_t)cells * cap;
    cand = 0;
    cand_lo = cand + align16(Stencil<D>::kWords * n * sizeof(T));
    own = cand_lo + (HILO ? align16(Stencil<D>::kLoWords * n * sizeof(T)) : 0);
    shift = own + align16((size_t)(HILO ? 2 * D + 1 : D + 1) * slots *
                          sizeof(T));
    next = shift + align16((size_t)D * kMaxWindow * sizeof(T));
    off = next + align16((slots + 1 > 32 ? slots + 1 : 32) *
                         sizeof(long long));
    nb = off + align16((kMaxWindow + 1) * sizeof(int));
    wrap = nb + align16(kMaxWindow * sizeof(int));
    ids = wrap + align16(kMaxWindow * sizeof(int));
    own_off = ids + align16(n * sizeof(int));
    out_nb = own_off + align16((size_t)(cells + 1) * sizeof(int));
    out_f = out_nb + align16((size_t)out_len * sizeof(int));
    total = out_f + align16((size_t)(D + 3) * out_len * sizeof(T));
  }
};

// Stencil rows: the offsets on every axis but the last (3D: (ox, oy), 2D:
// ox), in the stencil's order.
template <int D>
struct Rows {
  static constexpr int kCount = D == 3 ? 9 : 3;
  static constexpr int kCentre = kCount / 2;
};

// Warp iterations of a block whose n_own own slots each walk `chunks`
// groups of 2^lg candidates (a warp holds 32 >> lg groups).
__device__ __forceinline__ int warp_rounds(int chunks, int n_own, int lg) {
  return chunks * (((n_own << lg) + 31) >> 5);
}

// pos, lo: (D, n_slots) slot coordinates of the whole grid (lo under HILO
// only); diam: (n_slots,); counts: (n_cells,); cellm: (D, D) cell matrix,
// row-major. The launch covers the cells [first_cell, first_cell + n_run)
// of the grid; a block takes up to `cells` consecutive cells of one row (a
// row: the cells along the last axis), and its slots' hits are one run of
// the list. The count pass (FILL = false) writes seg_count[(c - first_cell)
// * cap + i] for every slot i of each of its cells c (0 on vacant ones) and
// the block's hits in block_count, and moves *last_total to *padded_from.
// The fill pass reads the counts again and block_ends (the inclusive
// cumulative sum of block_count), writes each slot's start in seg_start
// and its hits from there on, where that is below capacity: nb_out
// (capacity,), disp_out (D, capacity), r2_out, sig_i_out, sig_j_out
// (capacity,); the first out_len hits of a block go through shared memory
// and out in one coalesced run. Then it pads [total, min(*padded_from,
// capacity)) (to the capacity where padded_from is null) and stores the
// total in *last_total.
template <typename T, int D, bool HILO, bool FILL>
__global__ void __launch_bounds__(1024)
    cell_pairs_kernel(const T* __restrict__ pos, const T* __restrict__ lo,
                      const T* __restrict__ diam,
                      const int64_t* __restrict__ counts,
                      const T* __restrict__ cellm, int nx, int ny, int nz,
                      int first_cell, int n_run, int cap, int cells,
                      int list_len, int out_len, T rc_engine,
                      int* __restrict__ seg_count,
                      int* __restrict__ block_count,
                      const int64_t* __restrict__ block_ends,
                      int64_t* __restrict__ seg_start,
                      int64_t* __restrict__ padded_from,
                      int64_t* __restrict__ last_total, int64_t capacity,
                      int* __restrict__ nb_out, T* __restrict__ disp_out,
                      T* __restrict__ r2_out, T* __restrict__ sig_i_out,
                      T* __restrict__ sig_j_out) {
  constexpr int kRows = Rows<D>::kCount;
  constexpr int kOwnWords = HILO ? 2 * D + 1 : D + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ListLayout<T, D, HILO> lay(list_len, cap, cells, out_len);
  T* cand = reinterpret_cast<T*>(smem_raw + lay.cand);
  T* cand_lo = reinterpret_cast<T*>(smem_raw + lay.cand_lo);  // HILO only
  // (kOwnWords, cells * cap): the occupied own slots' coordinates, lo
  // words and diameters, in the order of the block's own slots.
  T* own_w = reinterpret_cast<T*>(smem_raw + lay.own);
  T* s_shift = reinterpret_cast<T*>(smem_raw + lay.shift);
  // Per own slot: its hits (count pass), or where its next hit goes; one
  // more entry: where the block's hits end (fill pass); at least 32, the
  // warps' sums at the end of the count pass.
  long long* s_next = reinterpret_cast<long long*>(smem_raw + lay.next);
  int* s_off = reinterpret_cast<int*>(smem_raw + lay.off);
  int* s_nb = reinterpret_cast<int*>(smem_raw + lay.nb);
  int* s_wrap = reinterpret_cast<int*>(smem_raw + lay.wrap);
  int* s_ids = reinterpret_cast<int*>(smem_raw + lay.ids);  // FILL only
  int* s_own_off = reinterpret_cast<int*>(smem_raw + lay.own_off);
  // The block's first out_len hits: neighbours, then (D + 3, out_len) of
  // displacement components, r^2 and the two diameters (FILL only).
  int* out_nb = reinterpret_cast<int*>(smem_raw + lay.out_nb);
  T* out_f = reinterpret_cast<T*>(smem_raw + lay.out_f);

  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int64_t n_slots = (int64_t)nx * ny * nz * cap;
  const int own_stride = cells * cap;
  // This block's cells: [c_lo, c_hi) of one row, inside the launched run.
  const int nl = D == 3 ? nz : ny;
  const int per_row = (nl + cells - 1) / cells;
  const int row = first_cell / nl + blockIdx.x / per_row;
  const int row0 = row * nl;
  int c_lo = row0 + (blockIdx.x % per_row) * cells;
  int c_hi = c_lo + cells < row0 + nl ? c_lo + cells : row0 + nl;
  c_lo = c_lo > first_cell ? c_lo : first_cell;
  c_hi = c_hi < first_cell + n_run ? c_hi : first_cell + n_run;
  const int n_cells = c_hi - c_lo;  // block-uniform; <= 0: no cell here
  const T cutoff2 = rc_engine * rc_engine;
  const long long block_end = FILL ? block_ends[blockIdx.x] : 0;
  // Read now, used at the end (the padding).
  const int64_t total = FILL ? block_ends[gridDim.x - 1] : 0;
  const int64_t pad_end = FILL && padded_from ? *padded_from : capacity;

  if (!FILL && tid == 0) {
    if (blockIdx.x == 0 && padded_from) *padded_from = *last_total;
    if (n_cells <= 0) block_count[blockIdx.x] = 0;
  }

  if (n_cells > 0) {
    // The window: kRows stencil rows of W = n_cells + 2 cells along the
    // last axis, row-major (the own cells are columns 1 .. n_cells). Warp 0,
    // a lane per window cell: its index in the grid, its wraps, its summed
    // image shift (as stencil_meta sums it) and the candidates before it;
    // and a lane per own cell: the own slots before it.
    const int W = n_cells + 2;
    const int M = kRows * W;
    if (tid < 32) {
      const int lane = tid;
      int n = 0;
      if (lane < M) {
        const int ro = lane / W;
        const int w = lane - ro * W;
        const int n_ax[3] = {nx, ny, nz};
        int j[3];
        if (D == 3) {
          j[0] = row / ny + ro / 3 - 1;
          j[1] = row % ny + ro % 3 - 1;
          j[2] = c_lo - row0 - 1 + w;
        } else {
          j[0] = row + ro - 1;
          j[1] = c_lo - row0 - 1 + w;
        }
        int wr[D], nb = 0, packed = 0;
#pragma unroll
        for (int a = 0; a < D; ++a) {
          wr[a] = j[a] < 0 ? -1 : (j[a] >= n_ax[a] ? 1 : 0);
          nb = nb * n_ax[a] + (j[a] - wr[a] * n_ax[a]);
          packed |= (wr[a] + 1) << (2 * a);
        }
#pragma unroll
        for (int k = 0; k < D; ++k) {
          T sh = T(wr[0]) * cellm[k * D];
#pragma unroll
          for (int a = 1; a < D; ++a) sh = sh + T(wr[a]) * cellm[k * D + a];
          s_shift[k * kMaxWindow + lane] = sh;
        }
        const int64_t cnt = counts[nb];
        n = cnt < cap ? (cnt > 0 ? (int)cnt : 0) : cap;
        s_nb[lane] = nb;
        s_wrap[lane] = packed;
      }
      int own = 0;
      if (lane < n_cells) {
        const int64_t cnt = counts[c_lo + lane];
        own = cnt < cap ? (cnt > 0 ? (int)cnt : 0) : cap;
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, n, d);
        const int u = __shfl_up_sync(0xffffffffu, own, d);
        if (lane >= d) {
          n += v;
          own += u;
        }
      }
      if (lane < M) s_off[lane + 1] = n;
      if (lane < n_cells) s_own_off[lane + 1] = own;
      if (lane == 0) {
        s_off[0] = 0;
        s_own_off[0] = 0;
      }
    }
    __syncthreads();
    const int n_own = s_own_off[n_cells];

    // The occupied own slots' words; in the fill pass also their counts.
    for (int o = tid; o < n_own; o += threads) {
      int jc = 0;
      while (jc + 1 < n_cells && s_own_off[jc + 1] <= o) ++jc;
      const int i = o - s_own_off[jc];
      const int64_t s = (int64_t)(c_lo + jc) * cap + i;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        own_w[a * own_stride + o] = pos[a * n_slots + s];
        if (HILO) own_w[(D + a) * own_stride + o] = lo[a * n_slots + s];
      }
      own_w[(kOwnWords - 1) * own_stride + o] = diam[s];
      s_next[o] =
          FILL ? seg_count[(int64_t)(c_lo + jc - first_cell) * cap + i] : 0;
    }
    long long s_base = 0;  // the list entry of the block's first hit
    long long n_hits = 0;  // the block's hits
    if (FILL) {
      // Each own slot's start: the block's start (its end less its hits)
      // plus the hits of the own slots before it. Warp 0, each lane a
      // contiguous run of own slots.
      __syncthreads();
      if (tid < 32) {
        const int per = (n_own + 31) >> 5;
        const int o0 = tid * per < n_own ? tid * per : n_own;
        const int o1 = o0 + per < n_own ? o0 + per : n_own;
        long long run = 0;
        for (int o = o0; o < o1; ++o) run += s_next[o];
        long long incl = run;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const long long v = __shfl_up_sync(0xffffffffu, incl, d);
          if (tid >= d) incl += v;
        }
        const long long all = __shfl_sync(0xffffffffu, incl, 31);
        long long at = block_end - all + (incl - run);
        for (int o = o0; o < o1; ++o) {
          const long long h = s_next[o];
          s_next[o] = at;
          at += h;
        }
        if (tid == 31) s_next[n_own] = block_end;
      }
      __syncthreads();
      n_hits = s_next[n_own] - (n_own > 0 ? s_next[0] : s_next[n_own]);
      s_base = s_next[n_own] - n_hits;
      for (int jc = 0; jc < n_cells; ++jc) {
        const int o0 = s_own_off[jc];
        const int n_j = s_own_off[jc + 1] - o0;
        int64_t* out = seg_start + (int64_t)(c_lo + jc - first_cell) * cap;
        for (int i = tid; i < cap; i += threads)
          out[i] = s_next[i < n_j ? o0 + i : o0 + n_j];
      }
    }

    // The group size: the fewest warp iterations for a typical own slot
    // (a cell sees 3 of the window's W columns in each row), the larger
    // group on a tie. Uniform over the block.
    const int seg = 3 * s_off[M] / (W * kRows);
    int lg = 5;
    if (warp_rounds(kRows * ((seg + 15) >> 4), n_own, 4) <
        warp_rounds(kRows * ((seg + 31) >> 5), n_own, lg))
      lg = 4;
    if (warp_rounds(kRows * ((seg + 7) >> 3), n_own, 3) <
        warp_rounds(kRows * ((seg + (1 << lg) - 1) >> lg), n_own, lg))
      lg = 3;
    const int G = 1 << lg;
    const int n_groups = threads >> lg;
    const int group = tid >> lg;
    const int gl = tid & (G - 1);
    const int lane = tid & 31;
    const unsigned gmask =
        G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1));
    const unsigned below = (1u << lane) - 1u;

    // Rows a stage holds: all, else 3 or 1 at a time (one row always fits:
    // the plan's list_len is at least W cap).
    int per_stage = kRows;
    while (per_stage > 1) {
      int longest = 0;
      for (int r = 0; r < kRows; r += per_stage) {
        const int len = s_off[(r + per_stage) * W] - s_off[r * W];
        longest = len > longest ? len : longest;
      }
      if (longest <= list_len) break;
      per_stage /= 3;
    }

    for (int r0 = 0; r0 < kRows; r0 += per_stage) {
      if (r0 > 0) __syncthreads();  // the last stage is no longer read
      const int t0 = r0 * W;
      const int t1 = (r0 + per_stage) * W;
      const int start = s_off[t0];
      const int n_stage = s_off[t1] - start;
      // Stage the window cells [t0, t1): each entry's window cell by
      // bisection, kStageBatch loaded before the first is stored; each
      // candidate carried to its image as the sweep's staging does.
      for (int first = tid; first < n_stage; first += kStageBatch * threads) {
        int c[kStageBatch];
        T x[kStageBatch][D], xl[kStageBatch][D], d[kStageBatch];
#pragma unroll
        for (int b = 0; b < kStageBatch; ++b) {
          const int e = first + b * threads;
          c[b] = -1;
          if (e < n_stage) {
            int below_c = t0, above_c = t1;
            while (above_c - below_c > 1) {
              const int mid = (below_c + above_c) >> 1;
              if (s_off[mid] <= start + e) below_c = mid; else above_c = mid;
            }
            c[b] = below_c;
            const int64_t src =
                (int64_t)s_nb[below_c] * cap + (start + e - s_off[below_c]);
            if (FILL) s_ids[e] = (int)src;
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
          const int e = first + b * threads;
          if (HILO) {
            bool wrapped = false;
#pragma unroll
            for (int a = 0; a < D; ++a)
              wrapped = wrapped || s_shift[a * kMaxWindow + c[b]] != T(0);
#pragma unroll
            for (int a = 0; a < D && wrapped; ++a) {
              const int w = ((s_wrap[c[b]] >> (2 * a)) & 3) - 1;
              if (w == 0) continue;
#pragma unroll
              for (int kk = 0; kk < D; ++kk) {
                const T term = T(w) * cellm[kk * D + a];
                if (term != T(0)) {
                  T sum, r;
                  two_sum(x[b][kk], term, sum, r);
                  x[b][kk] = sum;
                  xl[b][kk] = xl[b][kk] + r;
                }
              }
            }
            store_cand<D>(cand, e, x[b], d[b]);
            store_lo<D>(cand_lo, e, xl[b]);
          } else {
#pragma unroll
            for (int a = 0; a < D; ++a)
              x[b][a] = x[b][a] + s_shift[a * kMaxWindow + c[b]];
            store_cand<D>(cand, e, x[b], d[b]);
          }
        }
      }
      __syncthreads();

      // The walk: a group per own slot; for each stencil row of the stage,
      // the row's 3 window cells around the own cell are one run of the
      // staged list, taken G candidates at a time.
      for (int o = group; o < n_own; o += n_groups) {
        int jc = 0;
        while (jc + 1 < n_cells && s_own_off[jc + 1] <= o) ++jc;
        const int i = o - s_own_off[jc];
        T xi[D], xil[D];
#pragma unroll
        for (int a = 0; a < D; ++a) {
          xi[a] = own_w[a * own_stride + o];
          xil[a] = HILO ? own_w[(D + a) * own_stride + o] : T(0);
        }
        const T di = own_w[(kOwnWords - 1) * own_stride + o];
        long long next = s_next[o];
        for (int ro = r0; ro < r0 + per_stage; ++ro) {
          const int t = ro * W + jc;
          const int k_end = s_off[t + 3] - start;
          const int self_k =
              ro == Rows<D>::kCentre ? s_off[t + 1] - start + i : -1;
          for (int k0 = s_off[t] - start; k0 < k_end; k0 += G) {
            const int k = k0 + gl;
            bool hit = false;
            T dr[D], dj = T(0), r2 = T(0);
            if (k < k_end) {
              r2 = displacement<D, HILO>(xi, xil, cand, cand_lo, k, dr, dj);
              hit = k != self_k && r2 < cutoff2;
            }
            const unsigned bits = __ballot_sync(gmask, hit) & gmask;
            if (FILL && hit) {
              const long long at = next + __popc(bits & below);
              const long long l = at - s_base;
              if (l < out_len) {
                out_nb[l] = s_ids[k];
#pragma unroll
                for (int a = 0; a < D; ++a) out_f[a * out_len + l] = dr[a];
                out_f[D * out_len + l] = r2;
                out_f[(D + 1) * out_len + l] = di;
                out_f[(D + 2) * out_len + l] = dj;
              } else if (at < capacity) {
                nb_out[at] = s_ids[k];
#pragma unroll
                for (int a = 0; a < D; ++a)
                  disp_out[a * capacity + at] = dr[a];
                r2_out[at] = r2;
                sig_i_out[at] = di;
                sig_j_out[at] = dj;
              }
            }
            next += __popc(bits);
          }
        }
        if (gl == 0) s_next[o] = next;
      }
    }
    __syncthreads();
    if (FILL) {
      // The buffered hits out, in one run.
      const long long n_buf = n_hits < out_len ? n_hits : out_len;
      for (long long l = tid; l < n_buf; l += threads) {
        const long long at = s_base + l;
        if (at >= capacity) break;
        nb_out[at] = out_nb[l];
#pragma unroll
        for (int a = 0; a < D; ++a)
          disp_out[a * capacity + at] = out_f[a * out_len + l];
        r2_out[at] = out_f[D * out_len + l];
        sig_i_out[at] = out_f[(D + 1) * out_len + l];
        sig_j_out[at] = out_f[(D + 2) * out_len + l];
      }
    } else {
      long long mine = 0;
      for (int jc = 0; jc < n_cells; ++jc) {
        const int o0 = s_own_off[jc];
        const int n_j = s_own_off[jc + 1] - o0;
        int* out = seg_count + (int64_t)(c_lo + jc - first_cell) * cap;
        for (int i = tid; i < cap; i += threads) {
          const int h = i < n_j ? (int)s_next[o0 + i] : 0;
          out[i] = h;
          mine += h;
        }
      }
      // The block's hits: a fixed tree over its threads' sums (the
      // integer sum is exact in any order).
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        mine += __shfl_down_sync(0xffffffffu, mine, d);
      __syncthreads();  // s_next is read; its room takes the warps' sums
      if ((tid & 31) == 0) s_next[tid >> 5] = mine;
      __syncthreads();
      if (tid == 0) {
        long long all = 0;
        for (int w = 0; w < (threads >> 5); ++w) all += s_next[w];
        block_count[blockIdx.x] = (int)all;
      }
    }
  }
  if (!FILL) return;
  // The entries past the last hit that may hold an earlier call's hits:
  // r^2 at the engine cutoff squared (beyond every potential's range), unit
  // diameters, zero displacement, as the plain version pads them, so the
  // potential sees defined values there.
  const int64_t end = pad_end < capacity ? pad_end : capacity;
  for (int64_t at = total + (int64_t)blockIdx.x * threads + tid; at < end;
       at += (int64_t)gridDim.x * threads) {
    nb_out[at] = 0;
#pragma unroll
    for (int a = 0; a < D; ++a) disp_out[a * capacity + at] = T(0);
    r2_out[at] = cutoff2;
    sig_i_out[at] = T(1);
    sig_j_out[at] = T(1);
  }
  if (blockIdx.x == 0 && tid == 0 && last_total) *last_total = total;
}

// The full reduction's ticket: blocks that have stored their partials, on
// this card (0 between calls).
__device__ unsigned int g_reduce_ticket = 0;

// The block's sums of a and b in a fixed order (a tree of shuffles within
// each warp, then the warps' sums by the same tree in warp 0), in thread
// 0; a block of whole warps, at most 32.
template <typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b, T (&warp_a)[32],
                                           T (&warp_b)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if (lane == 0) {
    warp_a[warp] = a;
    warp_b[warp] = b;
  }
  __syncthreads();
  if (warp != 0) return;
  const int warps = blockDim.x >> 5;
  a = lane < warps ? warp_a[lane] : T(0);
  b = lane < warps ? warp_b[lane] : T(0);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
}

constexpr int kReduceThreads = 256;  // REDUCE_THREADS in ops/cell_pairs.py
// The staged reduction's two buffers; with kReduceBlocksPerSM blocks of
// 256 an SM, 24 KB each.
constexpr int kReduceStageBytes = 24576;
constexpr int kReduceBlocksPerSM = 8;
// The full variant's block sums need more registers: 6 blocks an SM keep
// it from spilling.
constexpr int kReduceBlocksPerSMFull = 6;

// A staged block's chunk of the list: the words of an entry (f, the D
// displacement components, and with OBS u and r^2) for kChunk entries, in
// each of two buffers.
template <typename T, int D, bool OBS>
struct ReduceStage {
  static constexpr int kWords = D + 1 + (OBS ? 2 : 0);
  static constexpr int kChunk = kReduceStageBytes / 2 /
                                (kWords * (int)sizeof(T)) / kReduceThreads *
                                kReduceThreads;
  static constexpr int kPerThread = kChunk / kReduceThreads;
  static_assert(kChunk >= kReduceThreads, "a chunk holds an entry a thread");
};

// The staged sums of one block: its slots own one run of the list, [start
// of its first slot, end of its last), clipped to the capacity. The block
// copies it chunk by chunk into shared memory with cp.async (each word of
// an entry a coalesced run of consecutive entries, no register held for
// it; two buffers in turn, the next chunk's copies in flight while the
// threads sum the staged one), and each thread adds its own entries
// [m0, m1) from there in list order. Returns false where this thread's
// segment lies outside the run (starts that are not the counts' running
// sum): it walks it in device memory instead.
template <typename T, int D, bool OBS>
__device__ __forceinline__ bool staged_sums(
    const int64_t* __restrict__ seg_start, const int* __restrict__ seg_count,
    int64_t capacity, int64_t n_slots, const T* __restrict__ u,
    const T* __restrict__ f, const T* __restrict__ disp,
    const T* __restrict__ r2, int64_t m0, int64_t m1, T (&fs)[D], T& e,
    T& w) {
  using S = ReduceStage<T, D, OBS>;
  __shared__ T stage[2][S::kWords][S::kChunk];
  const int tid = threadIdx.x;
  const int64_t s0 = (int64_t)blockIdx.x * kReduceThreads;
  const int64_t s_last =
      (s0 + kReduceThreads < n_slots ? s0 + kReduceThreads : n_slots) - 1;
  auto clip = [capacity](int64_t m) { return m < capacity ? m : capacity; };
  const int64_t run0 = clip(seg_start[s0]);
  const int64_t run1 = clip(seg_start[s_last] + seg_count[s_last]);
  const bool inside = m1 <= m0 || (m0 >= run0 && m1 <= run1);
  // Word k of the entries: f, disp[0..D), u, r^2.
  auto source = [&](int k) {
    return k == 0 ? f : (k <= D ? disp + (k - 1) * capacity
                                : (k == D + 1 ? u : r2));
  };
  // Copies of chunk c (entries from run0 + c kChunk) into buffer c % 2:
  // one commit group a chunk, empty where the thread has no entry.
  auto issue = [&](int64_t c) {
    const int64_t c0 = run0 + c * S::kChunk;
#pragma unroll
    for (int j = 0; j < S::kPerThread; ++j) {
      const int i = j * kReduceThreads + tid;
      if (c0 + i < run1) {
#pragma unroll
        for (int k = 0; k < S::kWords; ++k)
          __pipeline_memcpy_async(&stage[c & 1][k][i], source(k) + c0 + i,
                                  sizeof(T));
      }
    }
    __pipeline_commit();
  };
  const int64_t chunks =
      run1 > run0 ? (run1 - run0 + S::kChunk - 1) / S::kChunk : 0;
  if (chunks > 0) issue(0);
  if (chunks > 1) issue(1);
  for (int64_t c = 0; c < chunks; ++c) {
    if (c + 1 < chunks)
      __pipeline_wait_prior(1);
    else
      __pipeline_wait_prior(0);
    __syncthreads();
    const int64_t c0 = run0 + c * S::kChunk;
    const int64_t c1 = c0 + S::kChunk < run1 ? c0 + S::kChunk : run1;
    if (inside) {
      const T(&buf)[S::kWords][S::kChunk] = stage[c & 1];
      const int64_t a1 = m1 < c1 ? m1 : c1;
      for (int64_t m = m0 > c0 ? m0 : c0; m < a1; ++m) {
        const int i = (int)(m - c0);
        const T fr = buf[0][i];
#pragma unroll
        for (int a = 0; a < D; ++a) fs[a] += fr * buf[1 + a][i];
        if constexpr (OBS) {
          e += buf[D + 1][i];
          w += fr * buf[D + 2][i];
        }
      }
    }
    __syncthreads();
    if (c + 2 < chunks) issue(c + 2);
  }
  return inside;
}

// One thread per slot: its force, and its share of sum u and sum f r^2;
// then a fixed-order block sum of the two, and in the block that finishes
// last the sum over blocks (OBS only). STAGED: the block's run of the
// list goes through shared memory (staged_sums), for lists of long
// segments, where the walk's loads scatter; else, and for a segment
// outside its block's run, each thread walks its own entries in device
// memory (short segments: a warp's loads of its 32 segments fall on a few
// lines, which L1 keeps for the next entries). Both add the same entries
// in the same order.
template <typename T, int D, bool OBS, bool STAGED>
__global__ void __launch_bounds__(kReduceThreads,
                                  OBS ? kReduceBlocksPerSMFull
                                      : kReduceBlocksPerSM)
    pair_reduce_kernel(const int64_t* __restrict__ seg_start,
                       const int* __restrict__ seg_count, int64_t capacity,
                       int64_t n_slots, const T* __restrict__ u,
                       const T* __restrict__ f, const T* __restrict__ disp,
                       const T* __restrict__ r2, T* __restrict__ force,
                       T* e_part, T* w_part, T* __restrict__ e_out,
                       T* __restrict__ w_out) {
  __shared__ T warp_e[32], warp_w[32];
  __shared__ bool last;
  const int64_t s = (int64_t)blockIdx.x * kReduceThreads + threadIdx.x;
  int64_t m0 = 0, m1 = 0;
  if (s < n_slots) {
    m0 = seg_start[s];
    m1 = m0 + seg_count[s];
    m1 = m1 < capacity ? m1 : capacity;
  }
  T fs[D], e = T(0), w = T(0);
#pragma unroll
  for (int a = 0; a < D; ++a) fs[a] = T(0);
  bool walk = true;
  if constexpr (STAGED)
    walk = !staged_sums<T, D, OBS>(seg_start, seg_count, capacity, n_slots,
                                   u, f, disp, r2, m0, m1, fs, e, w);
  if (s < n_slots) {
    if (walk) {
      for (int64_t m = m0; m < m1; ++m) {
        const T fr = f[m];
#pragma unroll
        for (int a = 0; a < D; ++a) fs[a] += fr * disp[a * capacity + m];
        if (OBS) {
          e += u[m];
          w += fr * r2[m];
        }
      }
    }
#pragma unroll
    for (int a = 0; a < D; ++a) force[a * n_slots + s] = fs[a];
  }
  if (!OBS) return;
  block_sum2(e, w, warp_e, warp_w);
  if (threadIdx.x == 0) {
    e_part[blockIdx.x] = e;
    w_part[blockIdx.x] = w;
    __threadfence();  // the partials are visible before the ticket
    last = atomicAdd(&g_reduce_ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  e = T(0);
  w = T(0);
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) {
    e += __ldcg(e_part + b);  // from L2: other SMs wrote them
    w += __ldcg(w_part + b);
  }
  block_sum2(e, w, warp_e, warp_w);
  if (threadIdx.x == 0) {
    *e_out = T(0.5) * e;
    *w_out = T(0.5) * w;
    g_reduce_ticket = 0;
  }
}

// Blocks of a launch over [first_cell, first_cell + n_run): every row it
// touches, ceil(row / cells) blocks a row; list_blocks (ops/cell_pairs.py)
// computes the same.
inline int list_blocks(int nl, int first_cell, int n_run, int cells) {
  const int rows = (first_cell + n_run - 1) / nl - first_cell / nl + 1;
  return rows * ((nl + cells - 1) / cells);
}

template <typename T, int D, bool HILO>
int pairs(const T* pos, const T* lo, const T* diam, const int64_t* counts,
          const T* cellm, int nx, int ny, int nz, int first_cell, int n_run,
          int cap, int cells, int n_blocks, double cutoff, int* seg_count,
          int* block_count, const int64_t* block_ends, int64_t* seg_start,
          int64_t* padded_from, int64_t* last_total, long long capacity,
          int* nb_out, T* disp_out, T* r2_out, T* sig_i_out, T* sig_j_out,
          int list_len, int out_len, int smem_bytes, int threads, int fill,
          void* stream_ptr) {
  constexpr int kRows = Rows<D>::kCount;
  if (cap < 1 || cap > 1024) return kErrCapacity;
  if (nx < 3 || ny < 3 || (D == 3 ? nz < 3 : nz != 1)) return kErrGrid;
  if (first_cell < 0 || n_run < 1 ||
      (int64_t)first_cell + n_run > (int64_t)nx * ny * nz)
    return kErrRange;
  const bool plan_ok =
      cells >= 1 && kRows * (cells + 2) <= kMaxWindow &&
      list_len >= (cells + 2) * cap && list_len <= kRows * (cells + 2) * cap &&
      out_len >= 0 && threads >= 32 && threads <= 1024 &&
      threads % 32 == 0 && capacity >= 1 &&
      n_blocks == list_blocks(D == 3 ? nz : ny, first_cell, n_run, cells) &&
      seg_count && (fill ? block_ends && seg_start : block_count != nullptr) &&
      !padded_from == !last_total;
  const size_t smem =
      ListLayout<T, D, HILO>(list_len, cap, cells, out_len).total;
  if (!plan_ok || smem_bytes < 0 || (size_t)smem_bytes != smem)
    return kErrPlan;
  if (smem > kMaxSharedBytes) return kErrCapacity;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto kernel = fill ? cell_pairs_kernel<T, D, HILO, true>
                     : cell_pairs_kernel<T, D, HILO, false>;
  const int rc = prepare_kernel(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<n_blocks, threads, smem, stream>>>(
      pos, lo, diam, counts, cellm, nx, ny, nz, first_cell, n_run, cap,
      cells, list_len, out_len, T(cutoff), seg_count, block_count,
      block_ends, seg_start, padded_from, last_total, (int64_t)capacity,
      nb_out, disp_out, r2_out, sig_i_out, sig_j_out);
  return (int)cudaGetLastError();
}

// A 2D grid comes as nx x ny x 1.
template <typename T, bool HILO>
int pairs_dim(const T* pos, const T* lo, const T* diam,
              const int64_t* counts, const T* cellm, int nx, int ny, int nz,
              int first_cell, int n_run, int cap, int cells, int n_blocks,
              double cutoff, int* seg_count, int* block_count,
              const int64_t* block_ends, int64_t* seg_start,
              int64_t* padded_from, int64_t* last_total, long long capacity,
              int* nb_out, T* disp_out, T* r2_out, T* sig_i_out,
              T* sig_j_out, int list_len, int out_len, int smem_bytes,
              int threads, int fill, void* stream) {
  auto run = [&](auto dim) {
    return pairs<T, decltype(dim)::value, HILO>(
        pos, lo, diam, counts, cellm, nx, ny, nz, first_cell, n_run, cap,
        cells, n_blocks, cutoff, seg_count, block_count, block_ends,
        seg_start, padded_from, last_total, capacity, nb_out, disp_out,
        r2_out, sig_i_out, sig_j_out, list_len, out_len, smem_bytes, threads,
        fill, stream);
  };
  return nz == 1 ? run(std::integral_constant<int, 2>())
                 : run(std::integral_constant<int, 3>());
}

template <typename T, bool STAGED>
int reduce(const int64_t* seg_start, const int* seg_count,
           long long capacity, long long n_slots, int dim, const T* u,
           const T* f, const T* disp, const T* r2, T* force, T* e_part,
           T* w_part, T* e_out, T* w_out, void* stream_ptr) {
  if (dim != 2 && dim != 3) return kErrGrid;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (int)((n_slots + kReduceThreads - 1) / kReduceThreads);
  auto launch = [&](auto kernel) {
    kernel<<<blocks, kReduceThreads, 0, stream>>>(
        seg_start, seg_count, (int64_t)capacity, (int64_t)n_slots, u, f,
        disp, r2, force, e_part, w_part, e_out, w_out);
    return (int)cudaGetLastError();
  };
  if (dim == 2)
    return u ? launch(pair_reduce_kernel<T, 2, true, STAGED>)
             : launch(pair_reduce_kernel<T, 2, false, STAGED>);
  return u ? launch(pair_reduce_kernel<T, 3, true, STAGED>)
           : launch(pair_reduce_kernel<T, 3, false, STAGED>);
}

template <typename T>
int reduce_by(int staged, const int64_t* seg_start, const int* seg_count,
              long long capacity, long long n_slots, int dim, const T* u,
              const T* f, const T* disp, const T* r2, T* force, T* e_part,
              T* w_part, T* e_out, T* w_out, void* stream) {
  return staged ? reduce<T, true>(seg_start, seg_count, capacity, n_slots,
                                  dim, u, f, disp, r2, force, e_part, w_part,
                                  e_out, w_out, stream)
                : reduce<T, false>(seg_start, seg_count, capacity, n_slots,
                                   dim, u, f, disp, r2, force, e_part, w_part,
                                   e_out, w_out, stream);
}

}  // namespace

extern "C" {

// fill = 0: the count pass (writes seg_count and block_count: the hits of
// each slot and of each block); fill = 1: the fill pass (reads seg_count
// and block_ends, the inclusive cumulative sum of block_count on the
// device; writes seg_start and the list). padded_from, last_total: two
// int64 on the device that a caller keeping the list's buffers across
// calls passes (both at the capacity for new buffers), else both null. The
// cells [first_cell, first_cell + n_run) of the grid, `cells` of a row a
// block, n_blocks blocks (list_blocks). cellm: the (D, D) cell matrix,
// row-major; a 2D grid has nz = 1.
int mdtpu_cell_pairs_f32(
    const float* pos, const float* diam, const int64_t* counts,
    const float* cellm, int nx, int ny, int nz, int first_cell, int n_run,
    int cap, int cells, int n_blocks, double cutoff, int* seg_count,
    int* block_count, const int64_t* block_ends, int64_t* seg_start,
    int64_t* padded_from, int64_t* last_total, long long capacity,
    int* nb_out, float* disp_out, float* r2_out, float* sig_i_out,
    float* sig_j_out, int list_len, int out_len, int smem_bytes, int threads,
    int fill, void* stream) {
  return pairs_dim<float, false>(
      pos, nullptr, diam, counts, cellm, nx, ny, nz, first_cell, n_run, cap,
      cells, n_blocks, cutoff, seg_count, block_count, block_ends, seg_start,
      padded_from, last_total, capacity, nb_out, disp_out, r2_out, sig_i_out,
      sig_j_out, list_len, out_len, smem_bytes, threads, fill, stream);
}

int mdtpu_cell_pairs_f64(
    const double* pos, const double* diam, const int64_t* counts,
    const double* cellm, int nx, int ny, int nz, int first_cell, int n_run,
    int cap, int cells, int n_blocks, double cutoff, int* seg_count,
    int* block_count, const int64_t* block_ends, int64_t* seg_start,
    int64_t* padded_from, int64_t* last_total, long long capacity,
    int* nb_out, double* disp_out, double* r2_out, double* sig_i_out,
    double* sig_j_out, int list_len, int out_len, int smem_bytes, int threads,
    int fill, void* stream) {
  return pairs_dim<double, false>(
      pos, nullptr, diam, counts, cellm, nx, ny, nz, first_cell, n_run, cap,
      cells, n_blocks, cutoff, seg_count, block_count, block_ends, seg_start,
      padded_from, last_total, capacity, nb_out, disp_out, r2_out, sig_i_out,
      sig_j_out, list_len, out_len, smem_bytes, threads, fill, stream);
}

// The hi/lo displacement (float32 hi and lo words), rounded to float32.
int mdtpu_cell_pairs_hilo_f32(
    const float* pos, const float* lo, const float* diam, const int64_t* counts,
    const float* cellm, int nx, int ny, int nz, int first_cell, int n_run,
    int cap, int cells, int n_blocks, double cutoff, int* seg_count,
    int* block_count, const int64_t* block_ends, int64_t* seg_start,
    int64_t* padded_from, int64_t* last_total, long long capacity,
    int* nb_out, float* disp_out, float* r2_out, float* sig_i_out,
    float* sig_j_out, int list_len, int out_len, int smem_bytes, int threads,
    int fill, void* stream) {
  return pairs_dim<float, true>(
      pos, lo, diam, counts, cellm, nx, ny, nz, first_cell, n_run, cap,
      cells, n_blocks, cutoff, seg_count, block_count, block_ends, seg_start,
      padded_from, last_total, capacity, nb_out, disp_out, r2_out, sig_i_out,
      sig_j_out, list_len, out_len, smem_bytes, threads, fill, stream);
}

// u = null: the lean reduction (forces only; e_part, w_part, e_out and
// w_out unused). Otherwise e_part and w_part hold one partial per block of
// kReduceThreads slots, and e_out and w_out receive 0.5 sum u and 0.5 sum
// f r^2 (the caller's energy and virial).
// staged: each block's run of the list through shared memory (lists of
// long segments), else each thread walks its segment.
int mdtpu_pair_reduce_f32(const int64_t* seg_start, const int* seg_count,
                          long long capacity, long long n_slots, int dim,
                          const float* u, const float* f, const float* disp,
                          const float* r2, float* force, float* e_part,
                          float* w_part, float* e_out, float* w_out,
                          int staged, void* stream) {
  return reduce_by<float>(staged, seg_start, seg_count, capacity, n_slots,
                          dim, u, f, disp, r2, force, e_part, w_part, e_out,
                          w_out, stream);
}

int mdtpu_pair_reduce_f64(const int64_t* seg_start, const int* seg_count,
                          long long capacity, long long n_slots, int dim,
                          const double* u, const double* f,
                          const double* disp, const double* r2,
                          double* force, double* e_part, double* w_part,
                          double* e_out, double* w_out, int staged,
                          void* stream) {
  return reduce_by<double>(staged, seg_start, seg_count, capacity, n_slots,
                           dim, u, f, disp, r2, force, e_part, w_part, e_out,
                           w_out, stream);
}

const char* mdtpu_cell_pairs_error_string(int code) {
  return mdtpu::error_string(code);
}

}  // extern "C"
