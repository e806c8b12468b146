// Newton half-stencil pair sweep for NVIDIA Hopper (sm_90a): forces, energy
// and virial of every pair within the cutoff, over particles sorted into the
// slots of a periodic 3D orthorhombic cell grid.
//
// Replaces mdtpu/ops/experimental/pallas_plane.py::_plane_kernel and the XLA
// fold-back after it (:289-309). The Pallas kernel runs one program per
// x-plane over z-windowed ghost arrays: the self column (0,0) seen from both
// sides at half weight, and the 4 in-plane offsets HALF_OFFSETS = (0,1),
// (1,-1), (1,0), (1,1) times the 3-cell z-window evaluated once, with the
// reactions written to a partial buffer that XLA folds back. This kernel
// computes the same function, not the same blocks: one thread block per
// cell, which meets 15 cells,
//
//   * the self column, cells (0, 0, dz) for dz in -1..1: every pair seen from
//     both sides, energy and virial at 1/2, the self pair skipped by its
//     place in the list, no reaction;
//   * the 12 Newton cells HALF_OFFSETS x dz in -1..1: each pair evaluated
//     once at weight 1; the own slot takes +f d into its registers and the
//     neighbour slot -f d through a reaction partial;
//
// and a second kernel that folds the 12 partials of each occupied slot into
// its force, k = 0..11 in order. No ghost cells and no far-away pad
// coordinates: neighbour cells by periodic index, the +-L image shift added
// as a cell is staged, loops bounded by the per-cell counts.
//
// What bounds it on the H100. The function needs ~16 bytes in and 12 out per
// slot and ~33 operations per pair inside the cutoff; at the bench geometry
// (N = 65,536, 15^3 cells, C = 37) the operations are the larger of the two,
// and both are microseconds. As for the full-stencil sweep (cell_sweep.cu)
// the stencil makes it a problem of latency and occupancy: ~19.5 M candidate
// distances of which one in eleven is inside the cutoff, and blocks with few
// particles (19 of 37 slots at the bench geometry, 5 of 15 for pseudo-hard
// spheres, 3 of 12 on the Brownian grid). The design is that of
// cell_sweep.cu, with a reaction path that needs no tile of pair forces:
//
//   * Staged list. The occupied slots of the 15 cells go into shared memory
//     as one compacted candidate list (self column first, then the Newton
//     cells in list_offset order, slots ascending), image shift applied,
//     16 bytes a candidate at float32, entries shared evenly over the
//     threads, kStageBatch loaded before one is stored, padded with
//     candidates at infinity. The list holds list_len candidates (the
//     caller's plan: two thirds of the 15 C slots); a block whose
//     neighbourhood holds more stages it in five parts (the self column,
//     then each in-plane offset's three cells) or cell by cell. One cell
//     always fits.
//   * Several threads per own slot: a block has as many threads as a cell
//     has slots (rounded up to a power of two), and cells are about half
//     full; thread t works for own slot t % n_own on the chunks t / n_own,
//     + n_sub, ... of the list, so all lanes work whatever the cell's count;
//     each own slot adds its threads' sums in order at the end.
//   * Filter, then evaluate: contracted r^2 on kUnroll candidates, hits to a
//     thread-private 16-bit queue; the drain (on a warp vote, or when the
//     chunks end) recomputes the displacement as the plain version does,
//     applies the exact cutoff test and runs the potential on lanes that
//     nearly all hold a pair.
//   * Reactions from hit masks. A drained Newton pair (own slot i, candidate
//     k) with a non-zero force sets bit i of mask[k] in shared memory with an
//     integer atomicOr: the result of ORs does not depend on their order.
//     After a barrier one thread per Newton candidate walks its mask's bits
//     in ascending i and evaluates each pair again from the candidate's side
//     (d' = x_k - x_i is -d exactly, r^2 and f the same bits, so f d' is
//     -(f d)), adds the reactions in that order, and writes the sum to
//     react[k_cell][comp][slot], at the destination slot's own index. No
//     floating-point atomics, no buffer of pair forces; the price is the
//     potential a second time for every Newton pair. A pair whose force is
//     exactly zero (between the potential's cutoff and the engine's) sets no
//     bit: adding its +-0 would change nothing.
//   * Partials only for occupied slots. Each offset's neighbour map is a
//     permutation of the cells, so partial k of every occupied slot is
//     written exactly once (zero by a block whose own cell is empty); the
//     fold-back reads them for slots below its cell's count only, as 12 x 3
//     coalesced rows, and nothing reads the rest of the buffer.
//   * Deterministic: queues are thread-private and keep list order, the
//     split over threads depends only on the counts, masks are integer ORs,
//     reactions are added in slot order and partials in k order, energy and
//     virial go through a fixed tree. Two launches repeat bit for bit.
//
// Registers decide how many blocks an SM holds, and a block's phases are
// chains of dependent instructions that only other resident blocks hide: the
// float32 kernel is compiled for at least three blocks of 256 threads an SM
// (80 registers, a few spilled), which measured faster in every case; the
// float64 kernel keeps the registers it asks for (about 160), which measured
// faster than the same bound there.
//
// What it leaves. The potential runs twice for each Newton pair (measured:
// about a quarter of the kernel's time at the bench geometry); a buffer of
// f d written by the drain at offsets scanned from the masks' popcounts
// would save that at the price of a scan, of a drain that waits for the
// whole stage's filter, and of rounds for a stage fuller than the buffer.
// A block's fixed phases (counts, staging, two barriers a stage, the final
// sums) dominate on grids of few particles a cell. No hi/lo variant:
// PlaneEngine hands hi/lo to the full-stencil sweep.

#include <math.h>

#include "pair_potentials.cuh"

namespace {

using namespace mdtpu;

constexpr int kNewton = 12;    // HALF_OFFSETS x dz
constexpr int kSelf = 3;       // the self column
constexpr int kCells = kSelf + kNewton;
constexpr int kGroup = 3;      // cells of one in-plane offset
constexpr int kOwnCell = 1;    // offset (0, 0, 0) in the list's cell order
constexpr int kUnroll = 8;     // candidates filtered between two votes
constexpr int kListPad = 2 * kUnroll;  // candidates at infinity after a list
constexpr int kMeta = 16;      // per-stage cell records (15 used), padded
constexpr int kStageBatch = 4; // candidates a thread loads before it stores

// Cell c of the list: the self column (0, 0, c - 1) for c < 3, then Newton
// cell k = c - 3: HALF_OFFSETS[k / 3] in-plane, dz = k % 3 - 1.
__device__ __forceinline__ void list_offset(int c, int& ox, int& oy,
                                            int& oz) {
  const int h = c / kGroup - 1;  // -1: the self column
  ox = h <= 0 ? 0 : 1;
  oy = h < 0 ? 0 : (h == 0 ? 1 : h - 2);  // (0,1), (1,-1), (1,0), (1,1)
  oz = c % kGroup - 1;
}

// One candidate: (x, y, z, diameter).
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

// Dynamic shared memory of one block; plane_stage_plan (ops/plane_sweep.py)
// computes the same number.
template <typename T>
size_t shared_bytes(int cap, int list_len, int mask_words, int queue_depth,
                    int threads) {
  const size_t list = (size_t)list_len + kListPad;
  return (4 * list + 4 * (size_t)cap + 5 * (size_t)threads + 3 * kMeta) *
             sizeof(T) +
         2 * kMeta * sizeof(int) +
         (size_t)list_len * mask_words * sizeof(uint32_t) +
         (size_t)queue_depth * threads * sizeof(uint16_t);
}

// pos: (3, n_cells * cap) slot coordinates, component-major; diam: (n_cells *
// cap,); counts: (n_cells,) occupied slots per cell (clamped to cap here);
// box: (3,) box lengths. Slots [0, count) of each cell are occupied. force:
// (3, n_cells * cap) own-side forces, every slot written (vacant slots get
// 0). react: (12, 3, n_cells * cap) reaction partials, indexed by the slot
// they act on; written for occupied slots only. list_len >= cap candidates
// fit in a stage; mask_words = ceil(cap / 32); queue_depth >= kUnroll;
// blockDim.x is a power of two >= cap.
template <typename T, typename Pot, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS,
                                  MAX_THREADS == 256 && sizeof(T) == 4 ? 3 : 1)
    plane_sweep_kernel(const T* __restrict__ pos, const T* __restrict__ diam,
                       const int64_t* __restrict__ counts,
                       const T* __restrict__ box, int nx, int ny, int nz,
                       int cap, int list_len, int mask_words, int queue_depth,
                       T rc_engine, Pot pot, T* __restrict__ force,
                       T* __restrict__ e_part, T* __restrict__ w_part,
                       T* __restrict__ react) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int threads = blockDim.x;
  const int list_cap = list_len + kListPad;
  T* cand = reinterpret_cast<T*>(smem_raw);
  T* own_s = cand + 4 * list_cap;  // the own cell's slots, as candidates
  // (5, threads): each thread's fx, fy, fz, e, w; then the reduction's scratch
  T* part = own_s + 4 * cap;
  // Per list cell: its image shift (3, kMeta), the number of candidates
  // before it (16 entries) and its index in the grid.
  T* s_shift = part + 5 * threads;
  int* s_off = reinterpret_cast<int*>(s_shift + 3 * kMeta);
  int* s_nb = s_off + kMeta;
  // (list_len, mask_words): bit i of mask[k] is own slot i's hit on
  // candidate k of the stage.
  uint32_t* mask = reinterpret_cast<uint32_t*>(s_nb + kMeta);
  uint16_t* queue =
      reinterpret_cast<uint16_t*>(mask + (size_t)list_len * mask_words);

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

  // The 15 cells in list order, one per lane of warp 0: grid index, image
  // shift, and the candidates before each (an inclusive scan of the counts).
  if (warp == 0) {
    int n = 0;
    if (lane < kCells) {
      int ox, oy, oz;
      list_offset(lane, ox, oy, oz);
      T shx, shy, shz;
      const int jx = wrap_axis(cx + ox, nx, lx, shx);
      const int jy = wrap_axis(cy + oy, ny, ly, shy);
      const int jz = wrap_axis(cz + oz, nz, lz, shz);
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
    if (lane < kCells) s_off[lane + 1] = incl;
    if (lane == 0) s_off[0] = 0;
  }

  const int n_own = cnt_own < cap ? (cnt_own > 0 ? (int)cnt_own : 0) : cap;
  // Thread tid works for own slot tid % n_own on sub-list tid / n_own of the
  // candidates.
  const int n_sub = n_own > 0 ? threads / n_own : 0;
  const int sub = n_own > 0 ? tid / n_own : 0;
  const bool active = sub < n_sub;
  const int slot = active ? tid - sub * n_own : 0;
  const int64_t own = (int64_t)cell * cap + slot;

  T xi = T(0), yi = T(0), zi = T(0), di = T(0);
  if (active) {
    xi = pos[own];
    yi = pos[n_slots + own];
    zi = pos[2 * n_slots + own];
    di = diam[own];
    // The reactions read the own slots from shared memory.
    if (sub == 0) store_cand(own_s, slot, xi, yi, zi, di);
  }
  const auto pot_setup = pot.setup(di);
  const T cutoff2 = rc_engine * rc_engine;
  // The filter's r2 is contracted (fma) and only has to admit a superset:
  // the drain recomputes it as the plain version does and tests it exactly.
  const T eps = sizeof(T) == 4 ? T(1.1920928955078125e-07)
                               : T(2.220446049250313e-16);
  const T filter2 = cutoff2 * (T(1) + T(8) * eps);
  uint16_t* const q = queue + tid;
  const uint16_t* const q_full = q + (queue_depth - kUnroll) * threads;
  const bool warp_active = (warp << 5) < n_sub * n_own;
  const uint32_t own_bit = 1u << (slot & 31);
  const int own_word = slot >> 5;
  T fx = T(0), fy = T(0), fz = T(0), e = T(0), w = T(0);
  __syncthreads();

  // The most list cells whose occupied slots fit in one stage of list_len
  // candidates, in this block's neighbourhood: all 15, else the groups of 3
  // (the self column, each in-plane offset), else 1 at a time (one cell
  // always fits). As plane_stage_cells in ops/plane_sweep.py.
  int cells_per_stage = kCells;
  while (cells_per_stage > 1) {
    int longest = 0;
    for (int c = 0; c < kCells; c += cells_per_stage) {
      const int n = s_off[c + cells_per_stage] - s_off[c];
      longest = n > longest ? n : longest;
    }
    if (longest <= list_len) break;
    cells_per_stage = cells_per_stage == kCells ? kGroup : 1;
  }

  for (int c0 = 0; c0 < kCells; c0 += cells_per_stage) {
    if (c0 > 0) __syncthreads();  // the previous stage is no longer read
    const int start = s_off[c0];
    const int n_stage = s_off[c0 + cells_per_stage] - start;
    // Where the Newton candidates begin in this stage's list.
    const int newton_k =
        c0 >= kSelf ? 0 : (cells_per_stage == kCells ? s_off[kSelf] : n_stage);
    if (n_stage == 0) continue;

    // An empty own cell evaluates nothing: it only writes zero reactions.
    if (n_own > 0) {
      const int n_chunks = (n_stage + kUnroll - 1) / kUnroll;
      // Stage: the threads share the list's entries evenly; each finds its
      // entry's cell in the offsets, and loads kStageBatch entries before it
      // stores the first, so the loads are in flight together.
      for (int first = tid; first < n_stage; first += kStageBatch * threads) {
        int c[kStageBatch];
        T x[kStageBatch], y[kStageBatch], z[kStageBatch], d[kStageBatch];
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
          }
        }
#pragma unroll
        for (int b = 0; b < kStageBatch; ++b) {
          if (c[b] < 0) continue;
          const int k = first + b * threads;
          store_cand(cand, k, x[b] + s_shift[c[b]],
                     y[b] + s_shift[kMeta + c[b]],
                     z[b] + s_shift[2 * kMeta + c[b]], d[b]);
        }
      }
      // Candidates at infinity fill the last chunk and make one more: the
      // chunk that threads without work read.
      if (tid < kListPad && n_stage + tid < (n_chunks + 1) * kUnroll)
        store_cand(cand, n_stage + tid, T(INFINITY), T(0), T(0), T(0));
      for (int m = newton_k * mask_words + tid; m < n_stage * mask_words;
           m += threads)
        mask[m] = 0u;
      __syncthreads();

      if (warp_active) {
        // The own slot's place in the list: it passes the filter (r2 = 0)
        // and is skipped when its turn comes in the drain.
        const int self_k = kOwnCell >= c0 && kOwnCell < c0 + cells_per_stage
                               ? s_off[kOwnCell] - start + slot
                               : -1;
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
              const T dx = xi - x;
              const T dy = yi - y;
              const T dz = zi - z;
              const T r2 = dx * dx + dy * dy + dz * dz;
              if (k != self_k && r2 < cutoff2) {
                T u, f;
                pot(pot_setup, r2, di, dj, u, f);
                const bool newton = k >= newton_k;
                const T scale = newton ? T(1) : T(0.5);
                e += scale * u;
                w += scale * (f * r2);
                fx += f * dx;
                fy += f * dy;
                fz += f * dz;
                if (newton && f != T(0))
                  atomicOr(mask + k * mask_words + own_word, own_bit);
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
      __syncthreads();  // every hit's bit is set
    }

    // Reactions: one thread per Newton candidate walks its hits in own-slot
    // order, evaluates each pair from its side and writes the sum where the
    // fold-back finds it.
    for (int k = newton_k + tid; k < n_stage; k += threads) {
      int below = c0 < kSelf ? kSelf : c0, above = c0 + cells_per_stage;
      while (above - below > 1) {
        const int mid = (below + above) >> 1;
        if (s_off[mid] <= start + k) below = mid; else above = mid;
      }
      T rx = T(0), ry = T(0), rz = T(0);
      if (n_own > 0) {
        T xk, yk, zk, dk;
        load_cand(cand, k, xk, yk, zk, dk);
        const auto setup_k = pot.setup(dk);
        for (int wd = 0; wd < mask_words; ++wd) {
          uint32_t bits = mask[k * mask_words + wd];
          while (bits) {
            const int i = (wd << 5) + __ffs(bits) - 1;
            bits &= bits - 1;
            T x, y, z, d_i;
            load_cand(own_s, i, x, y, z, d_i);
            const T dx = xk - x;
            const T dy = yk - y;
            const T dz = zk - z;
            const T r2 = dx * dx + dy * dy + dz * dz;
            T u, f;
            pot(setup_k, r2, dk, d_i, u, f);
            rx += f * dx;
            ry += f * dy;
            rz += f * dz;
          }
        }
      }
      const int64_t dst =
          (int64_t)s_nb[below] * cap + (start + k - s_off[below]);
      T* out = react + (int64_t)(below - kSelf) * 3 * n_slots;
      out[dst] = rx;
      out[n_slots + dst] = ry;
      out[2 * n_slots + dst] = rz;
    }
  }

  // Each own slot adds up its sub-lists' sums, in list order.
  part[tid] = fx;
  part[threads + tid] = fy;
  part[2 * threads + tid] = fz;
  part[3 * threads + tid] = e;
  part[4 * threads + tid] = w;
  __syncthreads();
  fx = fy = fz = e = w = T(0);
  if (tid < n_own) {
    for (int s = 0; s < n_sub; ++s) {
      const int t = s * n_own + tid;
      fx += part[t];
      fy += part[threads + t];
      fz += part[2 * threads + t];
      e += part[3 * threads + t];
      w += part[4 * threads + t];
    }
  }
  if (tid < cap) {
    const int64_t out = (int64_t)cell * cap + tid;
    force[out] = fx;
    force[n_slots + out] = fy;
    force[2 * n_slots + out] = fz;
  }
  __syncthreads();  // part becomes the reduction's scratch

  block_reduce2(e, w, part, part + threads);
  if (tid == 0) {
    e_part[cell] = part[0];
    w_part[cell] = part[threads];
  }
}

// force[comp][s] += the 12 reaction partials of slot s, k in order, for the
// occupied slots (the sweep has written 0 to the vacant ones, and no partial
// for them).
template <typename T>
__global__ void fold_back_kernel(T* __restrict__ force,
                                 const T* __restrict__ react,
                                 const int64_t* __restrict__ counts,
                                 int64_t n_slots, int cap) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  if ((int64_t)(s % cap) >= counts[s / cap]) return;
  T acc[3] = {force[s], force[n_slots + s], force[2 * n_slots + s]};
  for (int k = 0; k < kNewton; ++k) {
    const T* part = react + (int64_t)k * 3 * n_slots + s;
    for (int comp = 0; comp < 3; ++comp) acc[comp] += part[comp * n_slots];
  }
  for (int comp = 0; comp < 3; ++comp) force[comp * n_slots + s] = acc[comp];
}

// All of the SM's shared memory for this kernel's blocks, and the
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

// The plan (list_len, mask_words, queue_depth, smem_bytes, threads) comes
// from plane_stage_plan in ops/plane_sweep.py and is held to this file's
// layout. A capacity whose plan does not fit in a block's shared memory is
// refused here.
template <typename T>
int sweep(const T* pos, const T* diam, const int64_t* counts, const T* box,
          int nx, int ny, int nz, int cap, double cutoff, int kind, double p0,
          double p1, double p2, double p3, int i0, int i1, int i2, T* force,
          T* e_part, T* w_part, T* react, int list_len, int mask_words,
          int queue_depth, int smem_bytes, int threads, int* blocks_per_sm,
          void* stream_ptr) {
  if (cap < 1 || cap > 1024) return kErrCapacity;
  if (nx < 3 || ny < 3 || nz < 3) return kErrGrid;
  const bool list_ok = list_len >= cap && list_len <= kCells * cap;
  const bool block_ok = threads >= 32 && threads <= 1024 &&
                        (threads & (threads - 1)) == 0 && threads >= cap;
  if (!list_ok || !block_ok || queue_depth < kUnroll ||
      mask_words != (cap + 31) / 32)
    return kErrPlan;
  const size_t smem =
      shared_bytes<T>(cap, list_len, mask_words, queue_depth, threads);
  if (smem_bytes < 0 || (size_t)smem_bytes != smem) return kErrPlan;
  if (smem > kMaxSharedBytes) return kErrCapacity;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_cells = nx * ny * nz;
  const int rc = with_potential<T>(
      kind, p0, p1, p2, p3, i0, i1, i2, [&](auto pot) {
        using Pot = decltype(pot);
        // Registers: a block of up to 256 threads takes 80 at float32 and
        // what it needs at float64; a larger one (up to 1024) is held to 64.
        auto kernel = threads <= 256 ? plane_sweep_kernel<T, Pot, 256>
                                     : plane_sweep_kernel<T, Pot, 1024>;
        const int prc = prepare_kernel(kernel, smem);
        if (prc != 0) return prc;
        if (blocks_per_sm != nullptr) {  // report the occupancy only
          return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              blocks_per_sm, kernel, threads, smem);
        }
        kernel<<<n_cells, threads, smem, stream>>>(
            pos, diam, counts, box, nx, ny, nz, cap, list_len, mask_words,
            queue_depth, T(cutoff), pot, force, e_part, w_part, react);
        return (int)cudaGetLastError();
      });
  if (rc != 0 || blocks_per_sm != nullptr) return rc;
  const int64_t n_slots = (int64_t)n_cells * cap;
  const int fold_threads = 256;
  const int blocks = (int)((n_slots + fold_threads - 1) / fold_threads);
  fold_back_kernel<T><<<blocks, fold_threads, 0, stream>>>(
      force, react, counts, n_slots, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mdtpu_plane_sweep_f32(const float* pos, const float* diam,
                          const int64_t* counts, const float* box, int nx,
                          int ny, int nz, int cap, double cutoff, int kind,
                          double p0, double p1, double p2, double p3, int i0,
                          int i1, int i2, float* force, float* e_part,
                          float* w_part, float* react, int list_len,
                          int mask_words, int queue_depth, int smem_bytes,
                          int threads, void* stream) {
  return sweep<float>(pos, diam, counts, box, nx, ny, nz, cap, cutoff, kind,
                      p0, p1, p2, p3, i0, i1, i2, force, e_part, w_part,
                      react, list_len, mask_words, queue_depth, smem_bytes,
                      threads, nullptr, stream);
}

int mdtpu_plane_sweep_f64(const double* pos, const double* diam,
                          const int64_t* counts, const double* box, int nx,
                          int ny, int nz, int cap, double cutoff, int kind,
                          double p0, double p1, double p2, double p3, int i0,
                          int i1, int i2, double* force, double* e_part,
                          double* w_part, double* react, int list_len,
                          int mask_words, int queue_depth, int smem_bytes,
                          int threads, void* stream) {
  return sweep<double>(pos, diam, counts, box, nx, ny, nz, cap, cutoff, kind,
                       p0, p1, p2, p3, i0, i1, i2, force, e_part, w_part,
                       react, list_len, mask_words, queue_depth, smem_bytes,
                       threads, nullptr, stream);
}

// Resident blocks per SM of the kernel that a launch with this plan would
// run (dtype_bytes 4 or 8), into *blocks_per_sm.
int mdtpu_plane_sweep_occupancy(int dtype_bytes, int cap, int kind, int i0,
                                int i1, int i2, int list_len, int mask_words,
                                int queue_depth, int smem_bytes, int threads,
                                int* blocks_per_sm) {
  if (dtype_bytes == 8)
    return sweep<double>(nullptr, nullptr, nullptr, nullptr, 3, 3, 3, cap,
                         1.0, kind, 1.0, 1.0, 1.0, 1.0, i0, i1, i2, nullptr,
                         nullptr, nullptr, nullptr, list_len, mask_words,
                         queue_depth, smem_bytes, threads, blocks_per_sm,
                         nullptr);
  return sweep<float>(nullptr, nullptr, nullptr, nullptr, 3, 3, 3, cap, 1.0,
                      kind, 1.0, 1.0, 1.0, 1.0, i0, i1, i2, nullptr, nullptr,
                      nullptr, nullptr, list_len, mask_words, queue_depth,
                      smem_bytes, threads, blocks_per_sm, nullptr);
}

const char* mdtpu_plane_sweep_error_string(int code) {
  return mdtpu::error_string(code);
}

}  // extern "C"
