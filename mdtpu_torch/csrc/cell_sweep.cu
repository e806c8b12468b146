// Cell-list pair sweep for NVIDIA Hopper (sm_90a): forces, energy and virial
// of every pair within the cutoff, over particles sorted into the slots of a
// periodic 3D orthorhombic cell grid.
//
// Replaces mdtpu/ops/experimental/pallas_cell.py::_pair_row_kernel, the
// Pallas TPU kernel that runs the full 27-cell stencil per (x, y) column of
// cells. This kernel computes the same function, not the same blocks: one
// thread block per cell, the full 27-cell stencil, so every pair is seen
// from both sides: no reaction write-back, no atomics. Energy and virial
// take the factor 1/2. Each block writes its own cell's slots. No ghost
// cells and no far-away pad coordinates: a neighbour cell is found by its
// periodic index and the +-L image shift is added as it is staged.
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
//     candidate at float32 (x, y, z, diameter). The threads share the
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
//     in order, and the block reduces energy and virial in a fixed tree. The
//     caller sums the per-block partials. With one thread per particle
//     (n_sub = 1) the sums are those of the first design, bit for bit; with
//     more they differ from it by rounding.
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
// box lengths live on the device, so the last step is taken here and not on
// the host, which would have to wait for them); the drain forms the exact
// displacement and applies the exact cutoff test.
//
// The lean variant (template flag OBS = false; the XLA sweep's
// observables=False, mdtpu/ops/cell_grid.py:711-717) is the same kernel with
// the energy and virial left out: no per-pair energy or virial sums, no
// per-cell partials, no block reduction. The potential's energy term is then
// dead code and the compiler drops it. The forces take the same operations
// in the same order, so they are the full variant's bits. The slot loop runs
// it on every step whose energy nobody reads, and FIRE inside its loop.
//
// What it leaves. Registers hold the float32 kernel to 6 blocks of 128
// threads an SM and the float64 and hi/lo kernels to 4. A block's fixed
// phases (counts, own slots, staging, the final sums) are latency that only
// other resident blocks hide. Nine in ten distances are still computed for
// nothing: the H100's cell size is to be chosen by measurement. The Newton
// half-stencil variant is plane_sweep.cu.

#include <math.h>

#include "pair_potentials.cuh"

namespace {

using namespace mdtpu;

constexpr int kStencil = 27;
constexpr int kCentre = 13;   // offset (0, 0, 0) in (ox, oy, oz) order
constexpr int kUnroll = 8;    // candidates filtered between two votes
constexpr int kListPad = 2 * kUnroll;  // candidates at infinity after a list
constexpr int kMeta = 32;      // per-stage cell records (27 used), padded
constexpr int kStageBatch = 4; // candidates a thread loads before it stores

// One candidate: (x, y, z, diameter), or the lo words (xl, yl, zl, 0).
__device__ __forceinline__ void load_cand(const float* list, int k, float& x,
                                          float& y, float& z, float& d) {
  const float4 v = reinterpret_cast<const float4*>(list)[k];
  x = v.x;
  y = v.y;
  z = v.z;
  d = v.w;
}

__device__ __forceinline__ void load_cand(const double* list, int k,
                                          double& x, double& y, double& z,
                                          double& d) {
  const double2 a = reinterpret_cast<const double2*>(list)[2 * k];
  const double2 b = reinterpret_cast<const double2*>(list)[2 * k + 1];
  x = a.x;
  y = a.y;
  z = b.x;
  d = b.y;
}

__device__ __forceinline__ void store_cand(float* list, int k, float x,
                                           float y, float z, float d) {
  reinterpret_cast<float4*>(list)[k] = make_float4(x, y, z, d);
}

__device__ __forceinline__ void store_cand(double* list, int k, double x,
                                           double y, double z, double d) {
  reinterpret_cast<double2*>(list)[2 * k] = make_double2(x, y);
  reinterpret_cast<double2*>(list)[2 * k + 1] = make_double2(z, d);
}

// Dynamic shared memory of one block; stage_plan (ops/cell_sweep.py) computes
// the same number.
template <typename T, bool HILO>
size_t shared_bytes(int list_len, int queue_depth, int threads) {
  const size_t list = (size_t)list_len + kListPad;
  return ((HILO ? 8 : 4) * list + 5 * (size_t)threads + 3 * kMeta) *
             sizeof(T) +
         2 * kMeta * sizeof(int) +
         (size_t)queue_depth * threads * sizeof(uint16_t);
}

// pos: (3, n_cells * cap) slot coordinates, component-major (the hi word
// under HILO); lo: (3, n_cells * cap) lo words (HILO only, else unused);
// diam: (n_cells * cap,); counts: (n_cells,) occupied slots per cell
// (clamped to cap here); box: (3,) box lengths. Slots [0, count) of each
// cell are occupied. force: (3, n_cells * cap), every slot written (vacant
// slots get 0). list_len >= cap candidates fit in a stage; queue_depth >=
// kUnroll; blockDim.x is a power of two >= cap. OBS = false: e_part and
// w_part are not written.
template <typename T, typename Pot, bool HILO, bool OBS, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
    cell_sweep_kernel(const T* __restrict__ pos, const T* __restrict__ lo,
                      const T* __restrict__ diam,
                      const int64_t* __restrict__ counts,
                      const T* __restrict__ box, int nx, int ny, int nz,
                      int cap, int list_len, int queue_depth, T rc_engine,
                      T filter_margin, Pot pot, T* __restrict__ force,
                      T* __restrict__ e_part, T* __restrict__ w_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int threads = blockDim.x;
  const int list_cap = list_len + kListPad;
  T* cand = reinterpret_cast<T*>(smem_raw);
  T* cand_lo = cand + 4 * list_cap;  // HILO only
  // (5, threads): each thread's fx, fy, fz, e, w; then the reduction's scratch
  T* part = cand_lo + (HILO ? 4 * list_cap : 0);
  // Per stencil cell: its image shift (3, kMeta), the number of candidates
  // before it (28 entries) and its index in the grid.
  T* s_shift = part + 5 * threads;
  int* s_off = reinterpret_cast<int*>(s_shift + 3 * kMeta);
  int* s_nb = s_off + kMeta;
  uint16_t* queue = reinterpret_cast<uint16_t*>(s_nb + kMeta);

  const int64_t n_slots = (int64_t)nx * ny * nz * cap;
  const int cell = blockIdx.x;
  const int cz = cell % nz;
  const int cy = (cell / nz) % ny;
  const int cx = cell / (ny * nz);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T lx = box[0], ly = box[1], lz = box[2];
  const int64_t cnt_own = counts[cell];

  // The stencil's cells in (ox, oy, oz) order, one per lane of warp 0: grid
  // index, image shift, and the candidates before each (an inclusive scan
  // of the counts).
  if (warp == 0) {
    int n = 0;
    if (lane < kStencil) {
      T shx, shy, shz;
      const int jx = wrap_axis(cx + lane / 9 - 1, nx, lx, shx);
      const int jy = wrap_axis(cy + (lane / 3) % 3 - 1, ny, ly, shy);
      const int jz = wrap_axis(cz + lane % 3 - 1, nz, lz, shz);
      const int nb = (jx * ny + jy) * nz + jz;
      const int64_t cnt = counts[nb];
      n = cnt < cap ? (int)cnt : cap;
      if (n < 0) n = 0;
      s_nb[lane] = nb;
      s_shift[lane] = shx;
      s_shift[kMeta + lane] = shy;
      s_shift[2 * kMeta + lane] = shz;
    }
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane < kStencil) s_off[lane + 1] = incl;
    if (lane == 0) s_off[0] = 0;
  }

  const int n_own = cnt_own < cap ? (cnt_own > 0 ? (int)cnt_own : 0) : cap;
  // Thread tid works for own slot tid % n_own on sub-list tid / n_own of the
  // candidates: with fewer particles than threads, several threads share an
  // own slot and split its list between them.
  const int n_sub = n_own > 0 ? threads / n_own : 0;
  const int sub = n_own > 0 ? tid / n_own : 0;
  const bool active = sub < n_sub;
  const int slot = active ? tid - sub * n_own : 0;
  const int64_t own = (int64_t)cell * cap + slot;

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
  const auto pot_setup = pot.setup(di);
  const T cutoff2 = rc_engine * rc_engine;
  // The filter's r2 is contracted (fma) and only has to admit a superset:
  // the drain recomputes it as the plain version does and tests it exactly.
  const T eps = sizeof(T) == 4 ? T(1.1920928955078125e-07)
                               : T(2.220446049250313e-16);
  T filter2 = cutoff2 * (T(1) + T(8) * eps);
  if (HILO) {
    // As hilo_filter_cutoff2 (ops/cell_sweep.py), operation for operation.
    const T lxy = lx > ly ? lx : ly;
    const T lmax = lxy > lz ? lxy : lz;
    const T rcw = rc_engine * (T(1) + T(2) * eps) + filter_margin * lmax;
    filter2 = rcw * rcw * (T(1) + T(16) * eps);
  }
  uint16_t* const q = queue + tid;
  const uint16_t* const q_full = q + (queue_depth - kUnroll) * threads;
  const bool warp_active = (warp << 5) < n_sub * n_own;
  T fx = T(0), fy = T(0), fz = T(0), e = T(0), w = T(0);
  __syncthreads();

  // The most stencil cells whose occupied slots fit in one stage of
  // list_len candidates, in this block's neighbourhood: all 27, else 9, 3
  // or 1 at a time (one cell always fits). As stage_cells in
  // ops/cell_sweep.py.
  int cells_per_stage = kStencil;
  while (cells_per_stage > 1) {
    int longest = 0;
    for (int c = 0; c < kStencil; c += cells_per_stage) {
      const int n = s_off[c + cells_per_stage] - s_off[c];
      longest = n > longest ? n : longest;
    }
    if (longest <= list_len) break;
    cells_per_stage /= 3;
  }

  // An empty cell has nothing to stage for.
  for (int c0 = 0; c0 < kStencil && n_own > 0; c0 += cells_per_stage) {
    if (c0 > 0) __syncthreads();  // the previous stage is no longer read
    const int start = s_off[c0];
    const int n_stage = s_off[c0 + cells_per_stage] - start;
    const int n_chunks = (n_stage + kUnroll - 1) / kUnroll;

    // Stage: the threads share the list's entries evenly; each finds its
    // entry's cell in the offsets, and loads kStageBatch entries before it
    // stores the first, so the loads are in flight together.
    for (int first = tid; first < n_stage; first += kStageBatch * threads) {
      int c[kStageBatch];
      T x[kStageBatch], y[kStageBatch], z[kStageBatch], d[kStageBatch];
      T xl[kStageBatch], yl[kStageBatch], zl[kStageBatch];
#pragma unroll
      for (int b = 0; b < kStageBatch; ++b) {
        const int k = first + b * threads;
        c[b] = -1;
        if (k < n_stage) {
          // The last cell with s_off[cell] <= start + k.
          int below = c0, above = c0 + cells_per_stage;
          while (above - below > 1) {
            const int mid = (below + above) >> 1;
            if (s_off[mid] <= start + k) below = mid; else above = mid;
          }
          c[b] = below;
          const int64_t src =
              (int64_t)s_nb[below] * cap + (start + k - s_off[below]);
          x[b] = pos[src];
          y[b] = pos[n_slots + src];
          z[b] = pos[2 * n_slots + src];
          d[b] = diam[src];
          if (HILO) {
            xl[b] = lo[src];
            yl[b] = lo[n_slots + src];
            zl[b] = lo[2 * n_slots + src];
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kStageBatch; ++b) {
        if (c[b] < 0) continue;
        const int k = first + b * threads;
        const T shx = s_shift[c[b]];
        const T shy = s_shift[kMeta + c[b]];
        const T shz = s_shift[2 * kMeta + c[b]];
        if (HILO) {
          T hx, hy, hz, rx, ry, rz;
          two_sum(x[b], shx, hx, rx);
          two_sum(y[b], shy, hy, ry);
          two_sum(z[b], shz, hz, rz);
          store_cand(cand, k, hx, hy, hz, d[b]);
          store_cand(cand_lo, k, xl[b] + rx, yl[b] + ry, zl[b] + rz, T(0));
        } else {
          store_cand(cand, k, x[b] + shx, y[b] + shy, z[b] + shz, d[b]);
        }
      }
    }
    // Candidates at infinity fill the last chunk and make one more: the
    // chunk that threads without work read.
    if (tid < kListPad && n_stage + tid < (n_chunks + 1) * kUnroll)
      store_cand(cand, n_stage + tid, T(INFINITY), T(0), T(0), T(0));
    __syncthreads();

    if (warp_active) {
      // The own slot's place in the list: it passes the filter (r2 = 0) and
      // is skipped when its turn comes in the drain.
      const int self_k = kCentre >= c0 && kCentre < c0 + cells_per_stage
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
            T x, y, z, dj;
            load_cand(cand, k, x, y, z, dj);
            T dx, dy, dz;
            if (HILO) {
              T xl, yl, zl, pad, s, err;
              load_cand(cand_lo, k, xl, yl, zl, pad);
              two_sum(xi, -x, s, err);
              dx = s + (err + (xil - xl));
              two_sum(yi, -y, s, err);
              dy = s + (err + (yil - yl));
              two_sum(zi, -z, s, err);
              dz = s + (err + (zil - zl));
            } else {
              dx = xi - x;
              dy = yi - y;
              dz = zi - z;
            }
            const T r2 = dx * dx + dy * dy + dz * dz;
            if (k != self_k && r2 < cutoff2) {
              T u, f;
              pot(pot_setup, r2, di, dj, u, f);
              if (OBS) {
                e += T(0.5) * u;
                w += T(0.5) * (f * r2);
              }
              fx += f * dx;
              fy += f * dy;
              fz += f * dz;
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
          T x, y, z, dj;
          load_cand(cand, k0 + u, x, y, z, dj);
          const T dx = xi - x;
          const T dy = yi - y;
          const T dz = zi - z;
          r2v[u] = fma(dz, dz, fma(dy, dy, dx * dx));
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
  part[tid] = fx;
  part[threads + tid] = fy;
  part[2 * threads + tid] = fz;
  if (OBS) {
    part[3 * threads + tid] = e;
    part[4 * threads + tid] = w;
  }
  __syncthreads();
  fx = fy = fz = e = w = T(0);
  if (tid < n_own) {
    for (int s = 0; s < n_sub; ++s) {
      const int t = s * n_own + tid;
      fx += part[t];
      fy += part[threads + t];
      fz += part[2 * threads + t];
      if (OBS) {
        e += part[3 * threads + t];
        w += part[4 * threads + t];
      }
    }
  }
  if (tid < cap) {
    const int64_t out = (int64_t)cell * cap + tid;
    force[out] = fx;
    force[n_slots + out] = fy;
    force[2 * n_slots + out] = fz;
  }
  if (!OBS) return;
  __syncthreads();  // part becomes the reduction's scratch

  block_reduce2(e, w, part, part + threads);
  if (tid == 0) {
    e_part[cell] = part[0];
    w_part[cell] = part[threads];
  }
}

// All of the SM's shared memory for this kernel's blocks (the default
// carve-out leaves most of it to L1 and holds fewer blocks), and the
// dynamic-size opt-in above 48 KB.
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

// The plan (list_len, queue_depth, smem_bytes, threads) comes from
// stage_plan in ops/cell_sweep.py and is held to this file's layout.
// obs = false launches the lean variant: forces only, e_part and w_part
// untouched (they may be null).
template <typename T, bool HILO>
int sweep(const T* pos, const T* lo, const T* diam, const int64_t* counts,
          const T* box, int nx, int ny, int nz, int cap, double cutoff,
          int kind, double p0, double p1, double p2, double p3, int i0,
          int i1, int i2, T* force, T* e_part, T* w_part, int list_len,
          int queue_depth, int smem_bytes, int threads, double filter_margin,
          bool obs, int* blocks_per_sm, void* stream_ptr) {
  if (cap < 1 || cap > 1024) return kErrCapacity;
  if (nx < 3 || ny < 3 || nz < 3) return kErrGrid;
  const bool list_ok = list_len >= cap && list_len <= kStencil * cap;
  const bool block_ok = threads >= 32 && threads <= 1024 &&
                        (threads & (threads - 1)) == 0 && threads >= cap;
  if (!list_ok || !block_ok || queue_depth < kUnroll) return kErrPlan;
  const size_t smem =
      shared_bytes<T, HILO>(list_len, queue_depth, threads);
  if (smem_bytes < 0 || (size_t)smem_bytes != smem) return kErrPlan;
  if (smem > kMaxSharedBytes) return kErrCapacity;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_cells = nx * ny * nz;
  return with_potential<T>(kind, p0, p1, p2, p3, i0, i1, i2, [&](auto pot) {
    using Pot = decltype(pot);
    // Registers: a block of up to 256 threads may take them all; a larger
    // one (up to 1024) is held to 64 a thread.
    auto kernel = cell_sweep_kernel<T, Pot, HILO, true, 256>;
    if (threads > 256)
      kernel = obs ? cell_sweep_kernel<T, Pot, HILO, true, 1024>
                   : cell_sweep_kernel<T, Pot, HILO, false, 1024>;
    else if (!obs)
      kernel = cell_sweep_kernel<T, Pot, HILO, false, 256>;
    const int rc = prepare_kernel(kernel, smem);
    if (rc != 0) return rc;
    if (blocks_per_sm != nullptr) {  // report the occupancy, launch nothing
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, kernel, threads, smem);
    }
    kernel<<<n_cells, threads, smem, stream>>>(
        pos, lo, diam, counts, box, nx, ny, nz, cap, list_len, queue_depth,
        T(cutoff), T(filter_margin), pot, force, e_part, w_part);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// observables = 0 launches the lean variant (forces only; e_part and w_part
// are not written and may be null).
int mdtpu_cell_sweep_f32(const float* pos, const float* diam,
                         const int64_t* counts, const float* box, int nx,
                         int ny, int nz, int cap, double cutoff, int kind,
                         double p0, double p1, double p2, double p3, int i0,
                         int i1, int i2, float* force, float* e_part,
                         float* w_part, int list_len, int queue_depth,
                         int smem_bytes, int threads, int observables,
                         void* stream) {
  return sweep<float, false>(pos, nullptr, diam, counts, box, nx, ny, nz, cap,
                             cutoff, kind, p0, p1, p2, p3, i0, i1, i2, force,
                             e_part, w_part, list_len, queue_depth,
                             smem_bytes, threads, 0.0, observables != 0,
                             nullptr, stream);
}

int mdtpu_cell_sweep_f64(const double* pos, const double* diam,
                         const int64_t* counts, const double* box, int nx,
                         int ny, int nz, int cap, double cutoff, int kind,
                         double p0, double p1, double p2, double p3, int i0,
                         int i1, int i2, double* force, double* e_part,
                         double* w_part, int list_len, int queue_depth,
                         int smem_bytes, int threads, int observables,
                         void* stream) {
  return sweep<double, false>(pos, nullptr, diam, counts, box, nx, ny, nz,
                              cap, cutoff, kind, p0, p1, p2, p3, i0, i1, i2,
                              force, e_part, w_part, list_len,
                              queue_depth, smem_bytes, threads, 0.0,
                              observables != 0, nullptr, stream);
}

// The hi/lo sweep, float32 only (as the JAX package's f32x2 mode).
// filter_margin: how far the filter's cutoff radius is widened per unit of
// the longest box length (hilo_filter_margin in ops/cell_sweep.py).
int mdtpu_cell_sweep_hilo_f32(const float* hi, const float* lo,
                              const float* diam, const int64_t* counts,
                              const float* box, int nx, int ny, int nz,
                              int cap, double cutoff, int kind, double p0,
                              double p1, double p2, double p3, int i0, int i1,
                              int i2, float* force, float* e_part,
                              float* w_part, int list_len,
                              int queue_depth, int smem_bytes, int threads,
                              double filter_margin, int observables,
                              void* stream) {
  return sweep<float, true>(hi, lo, diam, counts, box, nx, ny, nz, cap,
                            cutoff, kind, p0, p1, p2, p3, i0, i1, i2, force,
                            e_part, w_part, list_len, queue_depth,
                            smem_bytes, threads, filter_margin,
                            observables != 0, nullptr, stream);
}

// Resident blocks per SM of the kernel that a launch with this plan would
// run (dtype_bytes 4 or 8; hilo only at 4; observables 0 for the lean
// variant), into *blocks_per_sm.
int mdtpu_cell_sweep_occupancy(int dtype_bytes, int hilo, int cap, int kind,
                               int i0, int i1, int i2, int list_len,
                               int queue_depth, int smem_bytes, int threads,
                               int observables, int* blocks_per_sm) {
  const bool obs = observables != 0;
  if (dtype_bytes == 8)
    return sweep<double, false>(nullptr, nullptr, nullptr, nullptr, nullptr,
                                3, 3, 3, cap, 1.0, kind, 1.0, 1.0, 1.0, 1.0,
                                i0, i1, i2, nullptr, nullptr, nullptr,
                                list_len, queue_depth, smem_bytes,
                                threads, 0.0, obs, blocks_per_sm, nullptr);
  if (hilo)
    return sweep<float, true>(nullptr, nullptr, nullptr, nullptr, nullptr, 3,
                              3, 3, cap, 1.0, kind, 1.0, 1.0, 1.0, 1.0, i0,
                              i1, i2, nullptr, nullptr, nullptr,
                              list_len, queue_depth, smem_bytes,
                              threads, 0.0, obs, blocks_per_sm, nullptr);
  return sweep<float, false>(nullptr, nullptr, nullptr, nullptr, nullptr, 3,
                             3, 3, cap, 1.0, kind, 1.0, 1.0, 1.0, 1.0, i0, i1,
                             i2, nullptr, nullptr, nullptr, list_len,
                             queue_depth, smem_bytes, threads, 0.0, obs,
                             blocks_per_sm, nullptr);
}

const char* mdtpu_cell_sweep_error_string(int code) {
  return mdtpu::error_string(code);
}

}  // extern "C"
