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
// computes the same function, not the same blocks:
//
//   * one thread block per cell, one thread per own slot (the block is the
//     cell capacity C rounded up to a power of two, at least one warp);
//   * the self column, cells (0, 0, dz) for dz in -1..1: every pair seen from
//     both sides, energy and virial at 1/2, the self pair skipped by slot
//     index, no reaction;
//   * the 12 Newton cells HALF_OFFSETS x dz in -1..1: each pair evaluated
//     once; the own slot takes +f d, and -f d goes to the neighbour slot
//     through a reaction partial. Each thread writes its row of f d into a
//     (3, C, C) tile in shared memory; then thread j sums column j over the
//     own slots in slot order and writes the reaction partial
//     react[k][comp][cell * C + j] (zero on vacant slots);
//   * a second kernel folds the 12 partials back into the owning slots,
//     k = 0..11 in order: no atomics, a fixed summation order, so results
//     are deterministic and repeat bit for bit;
//   * no ghost cells and no far-away pad coordinates: neighbour cells by
//     periodic index, the +-L image shift added as the cell is staged, loops
//     bounded by the per-cell counts (as in cell_sweep.cu).
//
// What bounds it on the H100. The function is bound by memory, like B1's
// (same inputs, same outputs): ~16 bytes read and 12 written per slot. The
// design visits 15 of the 27 stencil cells per own cell (about 19.4 M
// candidate pairs at the bench geometry against B1's 35.0 M) and pays for it
// with the shared-memory tile of f d (three stores and three loads per
// candidate pair), a column pass whose parallelism is the neighbour's count,
// and the reaction partials: 12 x 3 x n_slots values written once and read
// once by the fold-back (~18 MB each way at f32 at the bench geometry).
// The (3, C, C) tile caps C at 97 (f64) or 137 (f32) within the 227 KB of
// shared memory a block may use.

#include "pair_potentials.cuh"

namespace {

using namespace mdtpu;

constexpr int kNewton = 12;  // HALF_OFFSETS x dz

// Newton cell k: HALF_OFFSETS[k / 3] in-plane, dz = k % 3 - 1.
__device__ __forceinline__ void newton_offset(int k, int& ox, int& oy,
                                              int& oz) {
  const int h = k / 3;
  ox = h == 0 ? 0 : 1;
  oy = h == 0 ? 1 : h - 2;  // (0,1), (1,-1), (1,0), (1,1)
  oz = k % 3 - 1;
}

template <typename T>
size_t smem_bytes(int cap, int threads) {
  return (size_t)(4 * cap + 3 * cap * cap + 2 * threads) * sizeof(T);
}

// pos: (3, n_cells * cap) slot coordinates, component-major; diam: (n_cells *
// cap,); counts: (n_cells,) occupied slots per cell (clamped to cap here);
// box: (3,) box lengths. force: (3, n_cells * cap) own-side forces, every
// slot written. react: (12, 3, n_cells * cap) reaction partials, every slot
// written.
template <typename T, typename Pot>
__global__ void plane_sweep_kernel(const T* __restrict__ pos,
                                   const T* __restrict__ diam,
                                   const int64_t* __restrict__ counts,
                                   const T* __restrict__ box, int nx, int ny,
                                   int nz, int cap, T cutoff2, Pot pot,
                                   T* __restrict__ force,
                                   T* __restrict__ e_part,
                                   T* __restrict__ w_part,
                                   T* __restrict__ react) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sy = sx + cap;
  T* sz = sy + cap;
  T* sd = sz + cap;
  T* tile = sd + cap;  // (3, cap, cap): f d of own slot i, neighbour slot j
  T* red_e = tile + 3 * cap * cap;
  T* red_w = red_e + blockDim.x;

  const int64_t n_slots = (int64_t)nx * ny * nz * cap;
  const int cap2 = cap * cap;
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
  const auto pot_setup = pot.setup(di);  // what does not depend on the pair
  T fx = T(0), fy = T(0), fz = T(0), e = T(0), w = T(0);

  // 3 self-column cells, then the 12 Newton cells.
  for (int c = 0; c < 3 + kNewton; ++c) {
    const bool newton = c >= 3;
    int ox = 0, oy = 0, oz = c - 1;
    if (newton) newton_offset(c - 3, ox, oy, oz);
    T shx, shy, shz;
    const int jx = wrap_axis(cx + ox, nx, lx, shx);
    const int jy = wrap_axis(cy + oy, ny, ly, shy);
    const int jz = wrap_axis(cz + oz, nz, lz, shz);
    const int nb = (jx * ny + jy) * nz + jz;
    const int64_t cnt_nb = counts[nb];
    const int n_nb = cnt_nb < cap ? (int)cnt_nb : cap;
    __syncthreads();  // the previous cell's stage and tile are no longer read
    if (i < n_nb) {
      const int64_t s = (int64_t)nb * cap + i;
      sx[i] = pos[s] + shx;
      sy[i] = pos[n_slots + s] + shy;
      sz[i] = pos[2 * n_slots + s] + shz;
      sd[i] = diam[s];
    }
    __syncthreads();
    if (active) {
      const bool self_cell = (c == 1);  // offset (0, 0, 0)
      const T scale = newton ? T(1) : T(0.5);
      for (int j = 0; j < n_nb; ++j) {
        T px = T(0), py = T(0), pz = T(0);
        if (!(self_cell && j == i)) {
          const T dx = xi - sx[j];
          const T dy = yi - sy[j];
          const T dz = zi - sz[j];
          const T r2 = dx * dx + dy * dy + dz * dz;
          if (r2 < cutoff2) {
            T u, f;
            pot(pot_setup, r2, di, sd[j], u, f);
            e += scale * u;
            w += scale * (f * r2);
            px = f * dx;
            py = f * dy;
            pz = f * dz;
            fx += px;
            fy += py;
            fz += pz;
          }
        }
        if (newton) {
          tile[i * cap + j] = px;
          tile[cap2 + i * cap + j] = py;
          tile[2 * cap2 + i * cap + j] = pz;
        }
      }
    }
    if (newton) {
      __syncthreads();
      if (i < cap) {
        // Reaction on neighbour slot i: minus the column sum, own slots in
        // order.
        T rx = T(0), ry = T(0), rz = T(0);
        if (i < n_nb) {
          for (int a = 0; a < n_own; ++a) {
            rx += tile[a * cap + i];
            ry += tile[cap2 + a * cap + i];
            rz += tile[2 * cap2 + a * cap + i];
          }
        }
        T* out = react + (int64_t)(c - 3) * 3 * n_slots + (int64_t)cell * cap;
        out[i] = -rx;
        out[n_slots + i] = -ry;
        out[2 * n_slots + i] = -rz;
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

// force[comp][s] += the 12 reaction partials that belong to slot s, k in
// order: partial k of slot (cell, j) was written by the cell whose k-th
// Newton neighbour is this cell, i.e. cell - offset_k (periodic).
template <typename T>
__global__ void fold_back_kernel(T* __restrict__ force,
                                 const T* __restrict__ react, int nx, int ny,
                                 int nz, int cap) {
  const int64_t n_slots = (int64_t)nx * ny * nz * cap;
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  const int cell = (int)(s / cap);
  const int j = (int)(s % cap);
  const int cz = cell % nz;
  const int cy = (cell / nz) % ny;
  const int cx = cell / (ny * nz);
  T acc[3] = {force[s], force[n_slots + s], force[2 * n_slots + s]};
  for (int k = 0; k < kNewton; ++k) {
    int ox, oy, oz;
    newton_offset(k, ox, oy, oz);
    const int sx = (cx - ox + nx) % nx;
    const int sy = (cy - oy + ny) % ny;
    const int sz = (cz - oz + nz) % nz;
    const int64_t src = ((int64_t)(sx * ny + sy) * nz + sz) * cap + j;
    const T* part = react + (int64_t)k * 3 * n_slots;
    for (int comp = 0; comp < 3; ++comp) acc[comp] += part[comp * n_slots + src];
  }
  for (int comp = 0; comp < 3; ++comp) force[comp * n_slots + s] = acc[comp];
}

template <typename T>
int sweep(const T* pos, const T* diam, const int64_t* counts, const T* box,
          int nx, int ny, int nz, int cap, double cutoff, int kind, double p0,
          double p1, double p2, double p3, int i0, int i1, int i2, T* force,
          T* e_part, T* w_part, T* react, void* stream_ptr) {
  if (nx < 3 || ny < 3 || nz < 3) return kErrGrid;
  int threads = 32;
  while (threads < cap) threads <<= 1;
  const size_t smem = smem_bytes<T>(cap, threads);
  if (cap < 1 || threads > 1024 || smem > kMaxSharedBytes) return kErrCapacity;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const T rc_engine = T(cutoff);
  const T cutoff2 = rc_engine * rc_engine;
  const int n_cells = nx * ny * nz;
  const int rc = with_potential<T>(
      kind, p0, p1, p2, p3, i0, i1, i2, [&](auto pot) {
        cudaError_t err = cudaFuncSetAttribute(
            plane_sweep_kernel<T, decltype(pot)>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        plane_sweep_kernel<T, decltype(pot)>
            <<<n_cells, threads, smem, stream>>>(
                pos, diam, counts, box, nx, ny, nz, cap, cutoff2, pot, force,
                e_part, w_part, react);
        return (int)cudaGetLastError();
      });
  if (rc != 0) return rc;
  const int64_t n_slots = (int64_t)n_cells * cap;
  const int fold_threads = 256;
  const int blocks = (int)((n_slots + fold_threads - 1) / fold_threads);
  fold_back_kernel<T><<<blocks, fold_threads, 0, stream>>>(force, react, nx,
                                                           ny, nz, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mdtpu_plane_sweep_f32(const float* pos, const float* diam,
                          const int64_t* counts, const float* box, int nx,
                          int ny, int nz, int cap, double cutoff, int kind,
                          double p0, double p1, double p2, double p3, int i0,
                          int i1, int i2, float* force, float* e_part,
                          float* w_part, float* react, void* stream) {
  return sweep<float>(pos, diam, counts, box, nx, ny, nz, cap, cutoff, kind,
                      p0, p1, p2, p3, i0, i1, i2, force, e_part, w_part,
                      react, stream);
}

int mdtpu_plane_sweep_f64(const double* pos, const double* diam,
                          const int64_t* counts, const double* box, int nx,
                          int ny, int nz, int cap, double cutoff, int kind,
                          double p0, double p1, double p2, double p3, int i0,
                          int i1, int i2, double* force, double* e_part,
                          double* w_part, double* react, void* stream) {
  return sweep<double>(pos, diam, counts, box, nx, ny, nz, cap, cutoff, kind,
                       p0, p1, p2, p3, i0, i1, i2, force, e_part, w_part,
                       react, stream);
}

const char* mdtpu_plane_sweep_error_string(int code) {
  return mdtpu::error_string(code);
}

}  // extern "C"
