// Cell-list pair sweep for NVIDIA Hopper (sm_90a): forces, energy and virial
// of every pair within the cutoff, over particles sorted into the slots of a
// periodic 2D or 3D cell grid in any box, orthorhombic or tilted.
//
// Replaces mdtpu/ops/experimental/pallas_cell.py::_pair_row_kernel, the
// Pallas TPU kernel that runs the full 27-cell stencil per (x, y) column of
// cells. This kernel computes the same function, not the same blocks: one
// thread block per cell, the full 27-cell stencil, so every pair is seen
// from both sides: no reaction write-back, no atomics. Energy and virial
// take the factor 1/2. Each block writes its own cell's slots. No ghost
// cells and no far-away pad coordinates: a neighbour cell is found by its
// periodic index and its image shift is added as it is staged.
//
// Dimension and box. The dimension D is a template parameter: 27 stencil
// cells and three components in 3D, 9 and two in 2D (a 2D grid comes as
// nx x ny x 1). The 2D sweep is the counterpart of the JAX package's XLA
// y-window sweep (mdtpu/ops/cell_grid.py _ywindow_sweep :556, its hi/lo form
// ywin_hilo :593); B1's Pallas kernel itself is 3D only. The box comes as
// its D x D cell matrix: a neighbour across the grid's edge along axis a is
// shifted by the cell vector w_a cell[:, a], the JAX sweeps' ghost shift
// (:736-739), so an orthorhombic box is the diagonal case of one code path
// (cell_stencil.cuh, shared with the pair-list builder cell_pairs.cu).
//
// What bounds it on the H100. The function needs ~16 bytes in and 12 out per
// slot and ~40 operations per pair inside the cutoff: microseconds at the
// bench geometry (N = 65,536, 15^3 cells, C = 37). The stencil makes it an
// instruction-issue and latency problem instead. Cells of edge r_c + skin put
// one candidate in ten inside the cutoff (a property of the cell size, which
// this kernel takes as given), so the work is ~35 M candidate distances, and
// a block has few particles (19 of 37 slots at the bench geometry, 5 of 15
// for pseudo-hard spheres). The first design staged and walked the 27 cells
// one by one, one thread per slot, with the potential inside a per-lane
// branch: it paid the potential's ~40 instructions in nearly every
// iteration for about two useful lanes, half its lanes had no particle, and
// each of its 27 stages waited on device memory alone. Measured on an
// instrumented copy (clock64 around the phases), staging one cell per warp
// in turn was as long as all the arithmetic, and with one thread per
// particle a block's time was one warp's dependent instruction chain. The
// design now:
//
//   * Staged stencil. The occupied slots of the stencil cells go into shared
//     memory once, as one compacted candidate list in stencil order ((ox, oy,
//     oz) ascending, then slot ascending), image shift applied, 16 bytes a
//     candidate at float32 (x, y, z, diameter; 12 in 2D). The threads share the
//     entries evenly (an entry's cell is found in the cells' offsets) and
//     each loads several before it stores one, so a stage costs one or two
//     round trips to device memory where there were 27. The list is padded
//     with candidates at infinity to whole chunks of kUnroll and one more.
//   * A stage as long as a typical neighbourhood, not the worst. The list
//     holds list_len candidates (the caller's plan: two thirds of the
//     stencil's 27 C slots, which about half fill), which keeps more blocks
//     on an SM. A block whose 27 cells hold more stages them 9, 3 or 1 at a
//     time, in the same order; one cell always fits.
//   * Several threads per particle. A block has more threads than its cell
//     has particles (stage_plan gives two per slot): thread t works for own
//     slot t % n_own on sub-list t / n_own, the chunks sub, sub + n_sub, ...
//     of the list, so all lanes of all warps are busy whatever the count,
//     and hits that cluster in the list (the own cell's) spread over the
//     sub-lists. At the end each own slot adds its sub-lists' sums in
//     sub-list order.
//   * Filter, then evaluate. Each thread computes only r^2 for its chunks
//     (eight candidates loaded before any hit is stored; contracted, since
//     the filter need only admit a superset) and appends the index of every
//     hit to a queue of its own in shared memory (16-bit indices,
//     queue[depth][thread]). When any lane of the warp may run out of room
//     in the next chunk (a warp vote), or the chunks end, the warp drains:
//     each lane takes its own hits in order, recomputes the displacement as
//     the plain version does, applies the exact cutoff test and runs the
//     potential and the accumulation. The potential then runs on lanes that
//     nearly all hold a pair inside the cutoff.
//   * The potential's pair-independent arithmetic runs once per thread
//     (Pot::setup in pair_potentials.cuh).
//   * Deterministic: queues are thread-private and keep list order, the
//     split into sub-lists depends only on the counts, sub-lists are added
//     in order, and the block reduces energy and virial in a fixed tree
//     into its partials. With one thread per particle (n_sub = 1) the sums
//     are those of the first design, bit for bit; with more they differ
//     from it by rounding.
//   * The sum over blocks in the kernel (where the caller gives e_out and
//     w_out), in two levels, so that no block walks every partial (a block
//     has as few as 32 threads, and a grid as many as 35,000 cells: one
//     block's pass over them took ~0.1 ms on an H100): each block stores its
//     partials and takes its group's ticket (a group: 4 x threads
//     consecutive blocks); the group's last block sums the group's
//     partials (thread t blocks t, t + threads, ..., all loads out before
//     the adds, then a tree of shuffles within each warp and one over the
//     warps) into the group's sums and takes the ticket of groups; the
//     last group's block sums the groups' sums the same way (eight loads a
//     thread in flight) and writes e_out and w_out. In float64 at either
//     dtype, rounded once; the order depends on the grid and the block
//     alone, so every call gives the same bits. Each ticket is put back to
//     0 by the block that drew its last. One full sweep is one launch, with
//     its energy and virial on the device, where two torch.sum launches
//     followed it. One set of tickets and group sums per card: two full
//     sweeps must not run at once on two streams.
//
// The HILO variant is the hi/lo (double-f32) sweep of the JAX package's slot
// path (mdtpu/ops/cell_grid.py make_pair_block :254-259, ghost_z_window_hilo
// :144, ghost_shift_hilo :189): coordinates come as a hi word (slot_pos) and
// a lo word, the image shift goes onto the hi word through an error-free
// two_sum with its residual folded into lo, and each displacement is
// s + (e + (lo_i - lo_j)) with (s, e) = two_sum(hi_i, -hi_j): ~eps*r of
// rounding where a plain f32 difference carries ~eps*L. Its filter takes the
// plain difference of the hi words against a cutoff widened to cover the lo
// words and the rounding of absolute coordinates (hilo_filter_cutoff2 in
// ops/cell_sweep.py derives the margin and mirrors the arithmetic below; the
// cell matrix lives on the device, so the last step is taken here and not on
// the host, which would have to wait for it); the drain forms the exact
// displacement and applies the exact cutoff test. In a tilted box the shift
// goes onto the hi word one cell vector at a time.
//
// The lean variant (template flag OBS = false; the XLA sweep's
// observables=False, mdtpu/ops/cell_grid.py:711-717) is the same kernel with
// the energy and virial left out: no per-pair energy or virial sums, no
// per-cell partials, no block reduction. The potential's energy term is then
// dead code and the compiler drops it. The forces take the same operations
// in the same order, so they are the full variant's bits. The slot loop runs
// it on every step whose energy nobody reads, and FIRE inside its loop.
//
// The slab launch (mdtpu_torch/parallel/halo_slot.py, the sharded
// engine's sweep; the JAX package's is XLA, halo_slot.py:322
// compute_slots) is this kernel over a run of cells: a rank's slab with a
// ghost x-plane on each side is a grid of mx + 2 planes, and the blocks go
// to its interior cells only (first_cell, n_blocks), so no x-neighbour of a
// launched cell wraps and the wrap logic serves y and z unchanged. Block b
// works for cell first_cell + b and writes its outputs at b. A launch over
// the whole grid (0, n_cells) is the single-device sweep, bit for bit.
//
// What it leaves. Registers hold the float32 kernel to 6 blocks of 128
// threads an SM and the float64 and hi/lo kernels to 4. A block's fixed
// phases (counts, own slots, staging, the final sums) are latency that only
// other resident blocks hide. Nine in ten distances are still computed for
// nothing: the H100's cell size is to be chosen by measurement. The Newton
// half-stencil variant is plane_sweep.cu.

#include <math.h>

#include "cell_stencil.cuh"

namespace {

using namespace mdtpu;

// The full variant's sum over blocks in two levels: a group is
// kGroupPerThread x threads consecutive blocks; each group's last block
// sums the group's partials (kGroupPerThread loads a thread, all out
// before the adds) into g_group_sum, and the last group's last block sums
// the groups' (kGroupBatch loads a thread in flight). Per card, 0 between
// launches: each group's ticket (blocks of the group that stored their
// partials) and the ticket of groups summed.
constexpr int kGroupPerThread = 4;
constexpr int kGroupBatch = 8;
constexpr int kMaxGroups = 1 << 16;
__device__ unsigned int g_group_ticket[kMaxGroups] = {};
__device__ double g_group_sum[2 * kMaxGroups];
__device__ unsigned int g_sweep_ticket = 0;

// The sum of a and b over a block of whole warps in a fixed order (a tree
// of shuffles within each warp, then the warps' sums by the same tree in
// warp 0), in thread 0; red: 64 values of shared scratch.
__device__ __forceinline__ void block_sum2(double& a, double& b,
                                           double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  if (warp != 0) return;
  const int warps = blockDim.x >> 5;
  a = lane < warps ? red[lane] : 0.0;
  b = lane < warps ? red[32 + lane] : 0.0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
}

constexpr int kUnroll = 8;    // candidates filtered between two votes
constexpr int kListPad = 2 * kUnroll;  // candidates at infinity after a list

// Dynamic shared memory of one block; stage_plan (ops/cell_sweep.py) computes
// the same number. The layout is that of the 3D kernel in both dimensions
// except the candidate records: (D + 1) words, and (4 or 2) lo words.
template <typename T, int D, bool HILO>
size_t shared_bytes(int list_len, int queue_depth, int threads) {
  const size_t list = (size_t)list_len + kListPad;
  const size_t words =
      Stencil<D>::kWords + (HILO ? Stencil<D>::kLoWords : 0);
  return (words * list + 5 * (size_t)threads + 3 * kMeta) * sizeof(T) +
         2 * kMeta * sizeof(int) +
         (size_t)queue_depth * threads * sizeof(uint16_t);
}

// pos: (D, n_cells * cap) slot coordinates, component-major (the hi word
// under HILO); lo: (D, n_cells * cap) lo words (HILO only, else unused);
// diam: (n_cells * cap,); counts: (n_cells,) occupied slots per cell
// (clamped to cap here); cellm: (D, D) cell matrix, row-major (its columns
// are the box vectors). Slots [0, count) of each cell are occupied. force:
// (D, n_cells * cap), every slot written (vacant slots get 0). list_len >=
// cap candidates fit in a stage; queue_depth >= kUnroll; blockDim.x is a
// power of two >= cap. OBS = false: e_part and w_part are not written. The
// grid is nx x ny x nz, nz = 1 in 2D. Block b works for cell first_cell + b
// and writes its slots at b * cap of force ((D, gridDim.x * cap)) and its
// partials at e_part[b], w_part[b]: a launch over every cell (first_cell 0)
// writes the whole grid, a launch over a run of cells (the interior x-planes
// of a slab with a ghost plane on each side, parallel/halo_slot.py) writes
// that run only. e_out, w_out (OBS; or null): the partials' sum, one value
// each, written by the block that finishes last.
template <typename T, int D, typename Pot, bool HILO, bool OBS,
          int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
    cell_sweep_kernel(const T* __restrict__ pos, const T* __restrict__ lo,
                      const T* __restrict__ diam,
                      const int64_t* __restrict__ counts,
                      const T* __restrict__ cellm, int nx, int ny, int nz,
                      int first_cell, int cap, int list_len, int queue_depth,
                      T rc_engine,
                      T filter_margin, Pot pot, T* __restrict__ force,
                      T* e_part, T* w_part, T* __restrict__ e_out,
                      T* __restrict__ w_out) {
  constexpr int kStencil = Stencil<D>::kCells;
  constexpr int kCentre = Stencil<D>::kCentre;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int threads = blockDim.x;
  const int list_cap = list_len + kListPad;
  T* cand = reinterpret_cast<T*>(smem_raw);
  T* cand_lo = cand + Stencil<D>::kWords * list_cap;  // HILO only
  // (5, threads): each thread's force components (rows 0 .. D-1), e (row
  // 3), w (row 4); then the reduction's scratch
  T* part = cand_lo + (HILO ? Stencil<D>::kLoWords * list_cap : 0);
  // Per stencil cell: its summed image shift (D of 3 rows of kMeta), the
  // number of candidates before it (kStencil + 1 entries) and its index in
  // the grid.
  T* s_shift = part + 5 * threads;
  int* s_off = reinterpret_cast<int*>(s_shift + 3 * kMeta);
  int* s_nb = s_off + kMeta;
  uint16_t* queue = reinterpret_cast<uint16_t*>(s_nb + kMeta);

  const int64_t n_slots = (int64_t)nx * ny * nz * cap;
  const int64_t n_out = (int64_t)gridDim.x * cap;
  const int cell = first_cell + blockIdx.x;
  const GridCell g(cell, nx, ny, nz);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t cnt_own = counts[cell];

  if (warp == 0)
    stencil_meta<D>(g, lane, counts, cellm, cap, s_shift, s_off, s_nb);

  const int n_own = cnt_own < cap ? (cnt_own > 0 ? (int)cnt_own : 0) : cap;
  // Thread tid works for own slot tid % n_own on sub-list tid / n_own of the
  // candidates: with fewer particles than threads, several threads share an
  // own slot and split its list between them.
  const int n_sub = n_own > 0 ? threads / n_own : 0;
  const int sub = n_own > 0 ? tid / n_own : 0;
  const bool active = sub < n_sub;
  const int slot = active ? tid - sub * n_own : 0;
  const int64_t own = (int64_t)cell * cap + slot;

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
  const auto pot_setup = pot.setup(di);
  const T cutoff2 = rc_engine * rc_engine;
  // The filter's r2 is contracted (fma) and only has to admit a superset:
  // the drain recomputes it as the plain version does and tests it exactly.
  const T eps = sizeof(T) == 4 ? T(1.1920928955078125e-07)
                               : T(2.220446049250313e-16);
  T filter2 = cutoff2 * (T(1) + T(8) * eps);
  if (HILO) {
    // As hilo_filter_cutoff2 (ops/cell_sweep.py), operation for operation.
    const T lmax = box_extent<D>(cellm);
    const T rcw = rc_engine * (T(1) + T(2) * eps) + filter_margin * lmax;
    filter2 = rcw * rcw * (T(1) + T(16) * eps);
  }
  uint16_t* const q = queue + tid;
  const uint16_t* const q_full = q + (queue_depth - kUnroll) * threads;
  const bool warp_active = (warp << 5) < n_sub * n_own;
  T f[D], e = T(0), w = T(0);
#pragma unroll
  for (int a = 0; a < D; ++a) f[a] = T(0);
  __syncthreads();

  const int per_stage = cells_per_stage<D>(s_off, list_len);

  // An empty cell has nothing to stage for.
  for (int c0 = 0; c0 < kStencil && n_own > 0; c0 += per_stage) {
    if (c0 > 0) __syncthreads();  // the previous stage is no longer read
    const int start = s_off[c0];
    const int n_stage = s_off[c0 + per_stage] - start;
    const int n_chunks = (n_stage + kUnroll - 1) / kUnroll;
    stage_candidates<D, HILO>(g, c0, per_stage, s_off, s_nb, s_shift, pos,
                              lo, diam, cellm, n_slots, cap, kUnroll, cand,
                              cand_lo);

    if (warp_active) {
      // The own slot's place in the list: it passes the filter (r2 = 0) and
      // is skipped when its turn comes in the drain.
      const int self_k = kCentre >= c0 && kCentre < c0 + per_stage
                             ? s_off[kCentre] - start + slot
                             : -1;
      // Sub-list sub takes chunks sub, sub + n_sub, ...: the hits are
      // spread evenly over an own slot's threads however they cluster in
      // the list.
      const int per = (n_chunks + n_sub - 1) / n_sub;
      uint16_t* q_end = q;
      for (int it = 0;; ++it) {
        const bool done = it >= per;
        if (done || __any_sync(0xffffffffu, q_end > q_full)) {
          // Drain: every lane evaluates its own hits, in the order it met
          // them.
          for (const uint16_t* qh = q; qh != q_end; qh += threads) {
            const int k = *qh;
            T dr[D], dj;
            const T r2 = displacement<D, HILO>(xi, xil, cand, cand_lo, k,
                                               dr, dj);
            if (k != self_k && r2 < cutoff2) {
              T u, fr;
              pot(pot_setup, r2, di, dj, u, fr);
              if (OBS) {
                e += T(0.5) * u;
                w += T(0.5) * (fr * r2);
              }
#pragma unroll
              for (int a = 0; a < D; ++a) f[a] += fr * dr[a];
            }
          }
          __syncwarp();
          q_end = q;
          if (done) break;
        }
        // Filter: r2 of the next kUnroll candidates, all loaded before any
        // hit is stored; hits join the queue. A thread without a chunk
        // reads the one at infinity.
        const int chunk = it * n_sub + sub;
        const int k0 =
            (active && chunk < n_chunks ? chunk : n_chunks) * kUnroll;
        T r2v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          T x[D], dj;
          load_cand<D>(cand, k0 + u, x, dj);
          T r2 = (xi[0] - x[0]) * (xi[0] - x[0]);
#pragma unroll
          for (int a = 1; a < D; ++a)
            r2 = fma(xi[a] - x[a], xi[a] - x[a], r2);
          r2v[u] = r2;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (r2v[u] < filter2) {
            *q_end = (uint16_t)(k0 + u);
            q_end += threads;
          }
        }
      }
    }
  }

  // Each own slot adds up its sub-lists' sums, in list order.
#pragma unroll
  for (int a = 0; a < D; ++a) part[a * threads + tid] = f[a];
  if (OBS) {
    part[3 * threads + tid] = e;
    part[4 * threads + tid] = w;
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < D; ++a) f[a] = T(0);
  e = w = T(0);
  if (tid < n_own) {
    for (int s = 0; s < n_sub; ++s) {
      const int t = s * n_own + tid;
#pragma unroll
      for (int a = 0; a < D; ++a) f[a] += part[a * threads + t];
      if (OBS) {
        e += part[3 * threads + t];
        w += part[4 * threads + t];
      }
    }
  }
  if (tid < cap) {
    const int64_t out = (int64_t)blockIdx.x * cap + tid;
#pragma unroll
    for (int a = 0; a < D; ++a) force[a * n_out + out] = f[a];
  }
  if (!OBS) return;
  __syncthreads();  // part becomes the reduction's scratch

  block_reduce2(e, w, part, part + threads);
  bool last = false;
  // The partials' sum in two levels (see the head of this file): the
  // blocks of group k are [k G, k G + G), G = kGroupPerThread threads.
  const int nb = gridDim.x;
  const int group_blocks = kGroupPerThread * threads;
  const int group = blockIdx.x / group_blocks;
  const int first_block = group * group_blocks;
  const int end_block = min(first_block + group_blocks, nb);
  const int n_groups = (nb + group_blocks - 1) / group_blocks;
  if (tid == 0) {
    e_part[blockIdx.x] = part[0];
    w_part[blockIdx.x] = part[threads];
    if (e_out) {
      __threadfence();  // the partials are visible before the ticket
      last = atomicAdd(&g_group_ticket[group], 1u) ==
             (unsigned)(end_block - first_block - 1);
    }
  }
  if (!__syncthreads_or(last)) return;
  // The group's last block: every partial of the group is stored. part
  // (5 threads values of T, at least 160 floats) holds the 64 doubles of
  // the sums' scratch.
  __threadfence();
  double* red = reinterpret_cast<double*>(
      (reinterpret_cast<uintptr_t>(part) + 7) & ~uintptr_t(7));
  double es = 0.0, ws = 0.0;
  {
    T eb[kGroupPerThread], wb[kGroupPerThread];
#pragma unroll
    for (int k = 0; k < kGroupPerThread; ++k) {
      const int b = first_block + k * threads + tid;
      eb[k] = b < end_block ? __ldcg(e_part + b) : T(0);  // from L2
      wb[k] = b < end_block ? __ldcg(w_part + b) : T(0);
    }
#pragma unroll
    for (int k = 0; k < kGroupPerThread; ++k) {
      es += (double)eb[k];
      ws += (double)wb[k];
    }
  }
  block_sum2(es, ws, red);
  last = false;
  if (tid == 0) {
    g_group_ticket[group] = 0;
    g_group_sum[2 * group] = es;
    g_group_sum[2 * group + 1] = ws;
    __threadfence();  // the group's sums are visible before the ticket
    last = atomicAdd(&g_sweep_ticket, 1u) == (unsigned)(n_groups - 1);
  }
  if (!__syncthreads_or(last)) return;
  // The last group's last block: every group's sums are stored.
  __threadfence();
  es = ws = 0.0;
  for (int g0 = tid; g0 < n_groups; g0 += kGroupBatch * threads) {
    double eb[kGroupBatch], wb[kGroupBatch];
#pragma unroll
    for (int k = 0; k < kGroupBatch; ++k) {
      const int h = g0 + k * threads;
      eb[k] = h < n_groups ? __ldcg(g_group_sum + 2 * h) : 0.0;
      wb[k] = h < n_groups ? __ldcg(g_group_sum + 2 * h + 1) : 0.0;
    }
#pragma unroll
    for (int k = 0; k < kGroupBatch; ++k) {
      es += eb[k];
      ws += wb[k];
    }
  }
  block_sum2(es, ws, red);
  if (tid == 0) {
    *e_out = (T)es;
    *w_out = (T)ws;
    g_sweep_ticket = 0;
  }
}

// The plan (list_len, queue_depth, smem_bytes, threads) comes from
// stage_plan in ops/cell_sweep.py and is held to this file's layout.
// obs = false launches the lean variant: forces only, e_part and w_part
// untouched (they may be null). The launch covers cells [first_cell,
// first_cell + n_blocks) of the grid.
template <typename T, int D, bool HILO>
int sweep(const T* pos, const T* lo, const T* diam, const int64_t* counts,
          const T* cellm, int nx, int ny, int nz, int cap, double cutoff,
          int kind, double p0, double p1, double p2, double p3, int i0,
          int i1, int i2, T* force, T* e_part, T* w_part, T* e_out,
          T* w_out, int first_cell, int n_blocks, int list_len,
          int queue_depth, int smem_bytes, int threads,
          double filter_margin, bool obs, int* blocks_per_sm,
          void* stream_ptr) {
  constexpr int kStencil = Stencil<D>::kCells;
  if (cap < 1 || cap > 1024) return kErrCapacity;
  if (nx < 3 || ny < 3 || (D == 3 ? nz < 3 : nz != 1)) return kErrGrid;
  const bool list_ok = list_len >= cap && list_len <= kStencil * cap;
  const bool block_ok = threads >= 32 && threads <= 1024 &&
                        (threads & (threads - 1)) == 0 && threads >= cap;
  if (!list_ok || !block_ok || queue_depth < kUnroll) return kErrPlan;
  const size_t smem =
      shared_bytes<T, D, HILO>(list_len, queue_depth, threads);
  if (smem_bytes < 0 || (size_t)smem_bytes != smem) return kErrPlan;
  if (smem > kMaxSharedBytes) return kErrCapacity;
  const int n_cells = nx * ny * nz;
  if (first_cell < 0 || n_blocks < 1 || first_cell + n_blocks > n_cells)
    return kErrRange;
  if (!e_out != !w_out || (e_out && !obs)) return kErrPlan;
  // The fold's groups: more than kMaxGroups only past 8 million cells.
  if (e_out && (n_blocks - 1) / (kGroupPerThread * threads) >= kMaxGroups)
    return kErrFold;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return with_potential<T>(kind, p0, p1, p2, p3, i0, i1, i2, [&](auto pot) {
    using Pot = decltype(pot);
    // Registers: a block of up to 256 threads may take them all; a larger
    // one (up to 1024) is held to 64 a thread.
    auto kernel = cell_sweep_kernel<T, D, Pot, HILO, true, 256>;
    if (threads > 256)
      kernel = obs ? cell_sweep_kernel<T, D, Pot, HILO, true, 1024>
                   : cell_sweep_kernel<T, D, Pot, HILO, false, 1024>;
    else if (!obs)
      kernel = cell_sweep_kernel<T, D, Pot, HILO, false, 256>;
    const int rc = prepare_kernel(kernel, smem);
    if (rc != 0) return rc;
    if (blocks_per_sm != nullptr) {  // report the occupancy, launch nothing
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, kernel, threads, smem);
    }
    kernel<<<n_blocks, threads, smem, stream>>>(
        pos, lo, diam, counts, cellm, nx, ny, nz, first_cell, cap, list_len,
        queue_depth, T(cutoff), T(filter_margin), pot, force, e_part,
        w_part, e_out, w_out);
    return (int)cudaGetLastError();
  });
}

// The dimension from the grid: a 2D grid comes as nx x ny x 1.
template <typename T, bool HILO>
int sweep_dim(const T* pos, const T* lo, const T* diam,
              const int64_t* counts, const T* cellm, int nx, int ny, int nz,
              int cap, double cutoff, int kind, double p0, double p1,
              double p2, double p3, int i0, int i1, int i2, T* force,
              T* e_part, T* w_part, T* e_out, T* w_out, int first_cell,
              int n_blocks, int list_len, int queue_depth, int smem_bytes,
              int threads, double filter_margin, bool obs,
              int* blocks_per_sm, void* stream) {
  auto run = [&](auto dim) {
    return sweep<T, decltype(dim)::value, HILO>(
        pos, lo, diam, counts, cellm, nx, ny, nz, cap, cutoff, kind, p0, p1,
        p2, p3, i0, i1, i2, force, e_part, w_part, e_out, w_out, first_cell,
        n_blocks,
        list_len, queue_depth, smem_bytes, threads, filter_margin, obs,
        blocks_per_sm, stream);
  };
  return nz == 1 ? run(std::integral_constant<int, 2>())
                 : run(std::integral_constant<int, 3>());
}

}  // namespace

extern "C" {

// cellm: the (D, D) cell matrix, row-major; a 2D grid has nz = 1.
// The launch covers cells [first_cell, first_cell + n_blocks) of the grid
// (0 and nx * ny * nz for the whole grid); force is (D, n_blocks * cap) and
// e_part, w_part (n_blocks,), in the order of those cells.
// observables = 0 launches the lean variant (forces only; e_part and w_part
// are not written and may be null). e_out, w_out (full only; or null): the
// energy and the virial, the partials summed by the kernel's last block.
int mdtpu_cell_sweep_f32(const float* pos, const float* diam,
                         const int64_t* counts, const float* cellm, int nx,
                         int ny, int nz, int cap, double cutoff, int kind,
                         double p0, double p1, double p2, double p3, int i0,
                         int i1, int i2, float* force, float* e_part,
                         float* w_part, float* e_out, float* w_out,
                         int first_cell, int n_blocks, int list_len,
                         int queue_depth, int smem_bytes, int threads,
                         int observables, void* stream) {
  return sweep_dim<float, false>(pos, nullptr, diam, counts, cellm, nx, ny,
                                 nz, cap, cutoff, kind, p0, p1, p2, p3, i0,
                                 i1, i2, force, e_part, w_part, e_out, w_out,
                                 first_cell, n_blocks, list_len, queue_depth,
                                 smem_bytes, threads, 0.0, observables != 0,
                                 nullptr, stream);
}

int mdtpu_cell_sweep_f64(const double* pos, const double* diam,
                         const int64_t* counts, const double* cellm, int nx,
                         int ny, int nz, int cap, double cutoff, int kind,
                         double p0, double p1, double p2, double p3, int i0,
                         int i1, int i2, double* force, double* e_part,
                         double* w_part, double* e_out, double* w_out,
                         int first_cell, int n_blocks, int list_len,
                         int queue_depth, int smem_bytes, int threads,
                         int observables, void* stream) {
  return sweep_dim<double, false>(pos, nullptr, diam, counts, cellm, nx, ny,
                                  nz, cap, cutoff, kind, p0, p1, p2, p3, i0,
                                  i1, i2, force, e_part, w_part, e_out,
                                  w_out, first_cell, n_blocks, list_len,
                                  queue_depth, smem_bytes, threads, 0.0,
                                  observables != 0, nullptr, stream);
}

// The hi/lo sweep, float32 only (as the JAX package's f32x2 mode).
// filter_margin: how far the filter's cutoff radius is widened per unit of
// the box's extent (hilo_filter_margin in ops/cell_sweep.py).
int mdtpu_cell_sweep_hilo_f32(const float* hi, const float* lo,
                              const float* diam, const int64_t* counts,
                              const float* cellm, int nx, int ny, int nz,
                              int cap, double cutoff, int kind, double p0,
                              double p1, double p2, double p3, int i0, int i1,
                              int i2, float* force, float* e_part,
                              float* w_part, float* e_out, float* w_out,
                              int first_cell, int n_blocks, int list_len,
                              int queue_depth, int smem_bytes, int threads,
                              double filter_margin, int observables,
                              void* stream) {
  return sweep_dim<float, true>(hi, lo, diam, counts, cellm, nx, ny, nz, cap,
                                cutoff, kind, p0, p1, p2, p3, i0, i1, i2,
                                force, e_part, w_part, e_out, w_out,
                                first_cell, n_blocks, list_len, queue_depth,
                                smem_bytes, threads, filter_margin,
                                observables != 0, nullptr, stream);
}

// Resident blocks per SM of the kernel that a launch with this plan would
// run (dtype_bytes 4 or 8; hilo only at 4; observables 0 for the lean
// variant; dim 2 or 3), into *blocks_per_sm.
int mdtpu_cell_sweep_occupancy(int dtype_bytes, int hilo, int cap, int kind,
                               int i0, int i1, int i2, int list_len,
                               int queue_depth, int smem_bytes, int threads,
                               int observables, int dim, int* blocks_per_sm) {
  const bool obs = observables != 0;
  const int nz = dim == 2 ? 1 : 3;
  const int n_cells = 9 * nz;
  if (dtype_bytes == 8)
    return sweep_dim<double, false>(
        nullptr, nullptr, nullptr, nullptr, nullptr, 3, 3, nz, cap, 1.0,
        kind, 1.0, 1.0, 1.0, 1.0, i0, i1, i2, nullptr, nullptr, nullptr,
        nullptr, nullptr, 0, n_cells, list_len, queue_depth, smem_bytes,
        threads, 0.0, obs, blocks_per_sm, nullptr);
  if (hilo)
    return sweep_dim<float, true>(
        nullptr, nullptr, nullptr, nullptr, nullptr, 3, 3, nz, cap, 1.0,
        kind, 1.0, 1.0, 1.0, 1.0, i0, i1, i2, nullptr, nullptr, nullptr,
        nullptr, nullptr, 0, n_cells, list_len, queue_depth, smem_bytes,
        threads, 0.0, obs, blocks_per_sm, nullptr);
  return sweep_dim<float, false>(
      nullptr, nullptr, nullptr, nullptr, nullptr, 3, 3, nz, cap, 1.0, kind,
      1.0, 1.0, 1.0, 1.0, i0, i1, i2, nullptr, nullptr, nullptr, nullptr,
      nullptr, 0, n_cells, list_len, queue_depth, smem_bytes, threads, 0.0,
      obs, blocks_per_sm, nullptr);
}

const char* mdtpu_cell_sweep_error_string(int code) {
  return mdtpu::error_string(code);
}

}  // extern "C"
