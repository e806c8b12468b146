// Micro-probe of the half-stencil sweep's inner loop, for NVIDIA Hopper
// (sm_90a).
//
// Replaces probe_kernel.py::kernel, the Pallas TPU probe that isolates the
// cost parts of one pair-block sweep of _plane_kernel at the bench geometry.
// It computes the same function at the same fixed geometry: input w (4, NX,
// ROWS, 3C) float32 (components x, y, z and an unused diameter), one plane
// per Pallas program. For each plane p, row r and own slot i (the window's
// centre band, column C + i), and for each of 5 offsets s the window row
// (r - s NZ) mod ROWS (a jnp.roll of the plane by s NZ rows), against all 3C
// window columns c:
//
//   d = own - win, r2 = dx^2 + dy^2 + dz^2, mask = r2 < 6.25;
//   full / full_static: u = 4 (sr12 - sr6), f = 24 (2 sr12 - sr6) / r2
//                       with sr6 = (1/r2)^3;
//   nodiv:              u = r2 / 2, f = r2 + dx;
//   u, f zero outside the mask;
//   full, full_static, nodiv: fx[p, r, i] += sum_c f dx + sum_c f dy
//                             + sum_c f dz, energy[p] += sum u;
//   reduce_only: fx stays 0; energy[p] += u + f of (row r0, own slot 0,
//                window column 0) for each chunk's first row r0.
//
// At offset 0 own slot i meets window column C + i, the same point: r2 = 0,
// so full and full_static give NaN in fx and the energy by construction, as
// the Pallas probe does; nodiv and reduce_only stay finite.
//
// Design: one thread block per (plane, chunk of rows), one thread per own
// slot; each window row is staged in shared memory (3 x 3C values) and read
// by every thread. ``chunk`` only sets how the rows are split into blocks
// (and which rows reduce_only samples, as in the Pallas probe; rows past the
// last whole chunk are not swept there, and keep fx = 0 here, which the
// caller zeroes). Each block writes its rows of fx and one energy partial,
// reduced over the block in a fixed order; the caller sums the partials of
// a plane.
//
// What bounds it on the H100: arithmetic. It reads ~3.5 MB and writes
// 0.4 MB, against ~43 M candidate pairs of ~30 operations each for the full
// variant. IEEE division (no fast-math), as the probe's 1.0 / r2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOffsets = 5;
constexpr int kErrGeometry = -1;
constexpr int kErrVariant = -2;

enum Variant { kFull = 0, kFullStatic = 1, kNoDiv = 2, kReduceOnly = 3 };

__device__ __forceinline__ void pair(int variant, float dx, float dy, float dz,
                                     float& u, float& f) {
  const float r2 = dx * dx + dy * dy + dz * dz;
  if (variant == kNoDiv) {
    u = r2 * 0.5f;
    f = r2 + dx;
  } else {
    const float inv_r2 = 1.0f / r2;
    const float sr6 = inv_r2 * inv_r2 * inv_r2;
    const float sr12 = sr6 * sr6;
    u = 4.0f * (sr12 - sr6);
    f = 24.0f * (2.0f * sr12 - sr6) * inv_r2;
  }
  if (!(r2 < 6.25f)) {
    u = 0.0f;
    f = 0.0f;
  }
}

// w: (4, nx, rows, 3 cap); fx: (nx, rows, cap); e_part: (nx, n_chunks),
// n_chunks = rows / chunk.
__global__ void plane_probe_kernel(const float* __restrict__ w, int nx,
                                   int rows, int cap, int nz, int chunk,
                                   int variant, float* __restrict__ fx,
                                   float* __restrict__ e_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c3 = 3 * cap;
  float* win = reinterpret_cast<float*>(smem_raw);  // (3, c3)
  float* red = win + 3 * c3;                        // (blockDim.x,)

  const int p = blockIdx.x;
  const int ci = blockIdx.y;
  const int n_chunks = gridDim.y;
  const int i = threadIdx.x;
  const int64_t comp = (int64_t)nx * rows * c3;  // stride of w's component
  const float* plane = w + (int64_t)p * rows * c3;
  float e = 0.0f;

  for (int r = ci * chunk; r < (ci + 1) * chunk; ++r) {
    float ox = 0.0f, oy = 0.0f, oz = 0.0f;
    if (i < cap) {
      ox = plane[(int64_t)r * c3 + cap + i];
      oy = plane[comp + (int64_t)r * c3 + cap + i];
      oz = plane[2 * comp + (int64_t)r * c3 + cap + i];
    }
    float acc = 0.0f;
    for (int s = 0; s < kOffsets; ++s) {
      const int rr = ((r - s * nz) % rows + rows) % rows;
      __syncthreads();  // the previous window row is no longer read
      for (int c = i; c < c3; c += blockDim.x) {
        win[c] = plane[(int64_t)rr * c3 + c];
        win[c3 + c] = plane[comp + (int64_t)rr * c3 + c];
        win[2 * c3 + c] = plane[2 * comp + (int64_t)rr * c3 + c];
      }
      __syncthreads();
      if (variant == kReduceOnly) {
        if (i == 0 && r == ci * chunk) {
          float u, f;
          pair(variant, ox - win[0], oy - win[c3], oz - win[2 * c3], u, f);
          e = (e + u) + f;
        }
        continue;
      }
      if (i < cap) {
        float ax = 0.0f, ay = 0.0f, az = 0.0f;
        for (int c = 0; c < c3; ++c) {
          const float dx = ox - win[c];
          const float dy = oy - win[c3 + c];
          const float dz = oz - win[2 * c3 + c];
          float u, f;
          pair(variant, dx, dy, dz, u, f);
          e += u;
          ax += f * dx;
          ay += f * dy;
          az += f * dz;
        }
        acc = acc + ((ax + ay) + az);
      }
    }
    if (i < cap) fx[((int64_t)p * rows + r) * cap + i] = acc;
  }

  red[i] = e;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (i < stride) red[i] += red[i + stride];
    __syncthreads();
  }
  if (i == 0) e_part[p * n_chunks + ci] = red[0];
}

}  // namespace

extern "C" {

// variant: 0 full, 1 full_static, 2 nodiv, 3 reduce_only.
int mdtpu_plane_probe(const float* w, int nx, int rows, int cap, int nz,
                      int chunk, int variant, float* fx, float* e_part,
                      void* stream_ptr) {
  if (nx < 1 || cap < 1 || cap > 1024 || chunk < 1 || chunk > rows)
    return kErrGeometry;
  if (variant < kFull || variant > kReduceOnly) return kErrVariant;
  int threads = 32;
  while (threads < cap) threads <<= 1;
  const size_t smem = (size_t)(9 * cap + threads) * sizeof(float);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid(nx, rows / chunk);
  plane_probe_kernel<<<grid, threads, smem, stream>>>(w, nx, rows, cap, nz,
                                                      chunk, variant, fx,
                                                      e_part);
  return (int)cudaGetLastError();
}

const char* mdtpu_plane_probe_error_string(int code) {
  switch (code) {
    case kErrGeometry: return "probe geometry the kernel does not take";
    case kErrVariant: return "unknown probe variant";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
