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
// ``chunk`` belongs to the function, not to the launch: rows past the last
// whole chunk are not swept (the caller zeroes fx, and they stay 0), and
// reduce_only samples the first row of each chunk. The launch is the same
// for every chunk.
//
// What bounds it on the H100: arithmetic. It reads ~3.5 MB and writes
// 0.4 MB, against ~43 M candidate pairs of ~30 operations each for the full
// variant, every one evaluated (no filter: the probe prices the inner loop's
// parts). IEEE division (no fast-math), as the probe's 1.0 / r2. The design:
//
//   * one thread block per (plane, row), one warp per offset s, lanes = own
//     slots (C = 29 of 32 busy): 3,375 blocks of 5 warps, where a launch
//     shaped by the chunk gave the card 75 warps at chunk 45;
//   * each warp stages its window row in shared memory (3 x 3C values,
//     padded to whole groups of four) and reads it back four columns a
//     load, the same address in every lane;
//   * the columns go kColumns at a time: the pairs' potentials (the
//     divisions) are independent and in flight together, and only the sums
//     form a chain. Each of ax, ay, az and the energy is added in column
//     order, so a warp's (ax + ay) + az is what one thread walking the row
//     gives;
//   * the five offsets' sums of an own slot are added in s order by warp 0:
//     fx is the same bits as a single thread walking offsets and columns in
//     order;
//   * the energy goes through a fixed tree (lanes by shuffles, the warps in
//     order) into one partial per block; the caller sums a plane's partials.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOffsets = 5;
constexpr int kColumns = 4;   // window columns evaluated together
constexpr int kErrGeometry = -1;
constexpr int kErrVariant = -2;

enum Variant { kFull = 0, kFullStatic = 1, kNoDiv = 2, kReduceOnly = 3 };

template <int VARIANT>
__device__ __forceinline__ void pair(float dx, float dy, float dz, float& u,
                                     float& f) {
  const float r2 = dx * dx + dy * dy + dz * dz;
  if (VARIANT == kNoDiv) {
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

// w: (4, nx, rows, 3 cap); fx: (nx, rows, cap); e_part: (nx, gridDim.y), one
// partial per swept row. blockDim.x = 32 kOffsets; cap <= 32. c3p: 3 cap
// rounded up to a multiple of kColumns.
template <int VARIANT>
__global__ void __launch_bounds__(32 * kOffsets)
    plane_probe_kernel(const float* __restrict__ w, int nx, int rows, int cap,
                       int nz, int chunk, int c3p, float* __restrict__ fx,
                       float* __restrict__ e_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c3 = 3 * cap;
  const int s = threadIdx.x >> 5;  // this warp's offset
  const int i = threadIdx.x & 31;  // own slot
  // Per warp its window row (3, c3p); then the warps' sums (kOffsets, 32)
  // and energies (kOffsets,).
  float* win = reinterpret_cast<float*>(smem_raw) + s * 3 * c3p;
  float* sums = reinterpret_cast<float*>(smem_raw) + kOffsets * 3 * c3p;
  float* e_warp = sums + kOffsets * 32;

  const int p = blockIdx.x;
  const int r = blockIdx.y;
  const int64_t comp = (int64_t)nx * rows * c3;  // stride of w's component
  const float* plane = w + (int64_t)p * rows * c3;
  const int rr = ((r - s * nz) % rows + rows) % rows;
  for (int c = i; c < c3p; c += 32) {
    const bool in = c < c3;
    win[c] = in ? plane[(int64_t)rr * c3 + c] : 0.0f;
    win[c3p + c] = in ? plane[comp + (int64_t)rr * c3 + c] : 0.0f;
    win[2 * c3p + c] = in ? plane[2 * comp + (int64_t)rr * c3 + c] : 0.0f;
  }
  float ox = 0.0f, oy = 0.0f, oz = 0.0f;
  if (i < cap) {
    ox = plane[(int64_t)r * c3 + cap + i];
    oy = plane[comp + (int64_t)r * c3 + cap + i];
    oz = plane[2 * comp + (int64_t)r * c3 + cap + i];
  }
  __syncwarp();

  float e = 0.0f, total = 0.0f;
  if (VARIANT == kReduceOnly) {
    if (i == 0 && r % chunk == 0) {
      float u, f;
      pair<VARIANT>(ox - win[0], oy - win[c3p], oz - win[2 * c3p], u, f);
      e = u + f;
    }
  } else if (i < cap) {
    float ax = 0.0f, ay = 0.0f, az = 0.0f;
    const float4* wx = reinterpret_cast<const float4*>(win);
    const float4* wy = reinterpret_cast<const float4*>(win + c3p);
    const float4* wz = reinterpret_cast<const float4*>(win + 2 * c3p);
    for (int c = 0; c < c3p; c += kColumns) {
      const float4 x4 = wx[c / kColumns];
      const float4 y4 = wy[c / kColumns];
      const float4 z4 = wz[c / kColumns];
      const float dx[kColumns] = {ox - x4.x, ox - x4.y, ox - x4.z, ox - x4.w};
      const float dy[kColumns] = {oy - y4.x, oy - y4.y, oy - y4.z, oy - y4.w};
      const float dz[kColumns] = {oz - z4.x, oz - z4.y, oz - z4.z, oz - z4.w};
      float u[kColumns], f[kColumns];
#pragma unroll
      for (int k = 0; k < kColumns; ++k) pair<VARIANT>(dx[k], dy[k], dz[k], u[k], f[k]);
#pragma unroll
      for (int k = 0; k < kColumns; ++k) {
        if (c + k < c3) {  // the padding columns add nothing
          e += u[k];
          ax += f[k] * dx[k];
          ay += f[k] * dy[k];
          az += f[k] * dz[k];
        }
      }
    }
    total = (ax + ay) + az;
  }

  // Energy: the warp's lanes in a fixed tree, then the warps in order.
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) e += __shfl_xor_sync(0xffffffffu, e, d);
  sums[s * 32 + i] = total;
  if (i == 0) e_warp[s] = e;
  __syncthreads();
  if (s == 0) {
    if (VARIANT != kReduceOnly && i < cap) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kOffsets; ++k) acc = acc + sums[k * 32 + i];
      fx[((int64_t)p * rows + r) * cap + i] = acc;
    }
    if (i == 0) {
      float sum = e_warp[0];
#pragma unroll
      for (int k = 1; k < kOffsets; ++k) sum += e_warp[k];
      e_part[p * gridDim.y + r] = sum;
    }
  }
}

template <int VARIANT>
int launch(const float* w, int nx, int rows, int cap, int nz, int chunk,
           float* fx, float* e_part, cudaStream_t stream) {
  const int c3p = (3 * cap + kColumns - 1) / kColumns * kColumns;
  const size_t smem =
      (size_t)(kOffsets * 3 * c3p + kOffsets * 32 + kOffsets) * sizeof(float);
  const dim3 grid(nx, rows / chunk * chunk);
  plane_probe_kernel<VARIANT><<<grid, 32 * kOffsets, smem, stream>>>(
      w, nx, rows, cap, nz, chunk, c3p, fx, e_part);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// variant: 0 full, 1 full_static, 2 nodiv, 3 reduce_only. e_part holds
// (nx, rows / chunk * chunk) partials, one per swept row.
int mdtpu_plane_probe(const float* w, int nx, int rows, int cap, int nz,
                      int chunk, int variant, float* fx, float* e_part,
                      void* stream_ptr) {
  if (nx < 1 || cap < 1 || cap > 32 || chunk < 1 || chunk > rows ||
      rows > 65535)
    return kErrGeometry;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (variant) {
    case kFull:
      return launch<kFull>(w, nx, rows, cap, nz, chunk, fx, e_part, stream);
    case kFullStatic:
      return launch<kFullStatic>(w, nx, rows, cap, nz, chunk, fx, e_part,
                                 stream);
    case kNoDiv:
      return launch<kNoDiv>(w, nx, rows, cap, nz, chunk, fx, e_part, stream);
    case kReduceOnly:
      return launch<kReduceOnly>(w, nx, rows, cap, nz, chunk, fx, e_part,
                                 stream);
    default:
      return kErrVariant;
  }
}

const char* mdtpu_plane_probe_error_string(int code) {
  switch (code) {
    case kErrGeometry: return "probe geometry the kernel does not take";
    case kErrVariant: return "unknown probe variant";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
