// Pair-distance histogram for the radial distribution function, for NVIDIA
// Hopper (sm_90a).
//
// Computes mdtpu/observables.py:21 rdf_histogram, which in the JAX package
// is XLA (dense (N, N) arrays, no Pallas kernel): for every ordered pair
// i != j of the N positions (N, D), D = 2 or 3, the minimum-image distance
//
//   d = x_i - x_j,  frac_k = sum_j inv[k][j] d_j,  frac_k -= rint(frac_k),
//   c_i = sum_k cell[i][k] frac_k,  r = sqrt(sum_i c_i^2),
//
// each sum in index order, with rint rounding half to even as jnp.round
// and torch.round do; a pair with r < r_max adds 1 to bin
// min(trunc(r / r_max * n_bins), n_bins - 1). Output: int64 counts
// (n_bins,). Built with -fmad=false and IEEE division and square root, so
// every operation rounds as the plain PyTorch version's
// (ops/rdf.py:rdf_histogram_plain) and the counts are the same integers.
//
// The minimum image is exactly antisymmetric (x_j - x_i = -(x_i - x_j),
// the products and sums negate, rint(-f) = -rint(f)), so r_ji = r_ij bit
// for bit: each unordered pair is visited once and adds 2.
//
// What bounds it on the H100: operations. It reads N D values and writes
// n_bins counts; it does N (N - 1) / 2 distances of ~46 operations each in
// 3D (23 in 2D), 2.1e9 distances at N = 65,536. The design, simple first:
//
//   * a block of kRows threads owns kRows rows i (one a thread, in
//     registers) and walks up to kSpan column tiles of kRows columns j,
//     only tiles at or right of its own (the diagonal tile takes j > i);
//     each column tile is staged in shared memory component-major and
//     read back as a broadcast (every lane the same j);
//   * a histogram per block in shared memory (32-bit integer atomics),
//     added to the global int64 counts at the end with one atomic per
//     non-empty bin. Integer sums do not depend on their order, so the
//     counts repeat exactly.
//
// Warp-private histograms, wgmma and TMA are left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;   // rows of a block = columns of a tile
constexpr int kSpan = 16;    // column tiles a block walks
constexpr int kMaxBins = 12288;  // 48 KB of shared memory
constexpr int kErrBins = -1;
constexpr int kErrDim = -2;

__device__ __forceinline__ float round_even(float x) { return rintf(x); }
__device__ __forceinline__ double round_even(double x) { return rint(x); }

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
rdf_kernel(const T* __restrict__ pos, int n, const T* __restrict__ cellm,
           const T* __restrict__ inv, T r_max, T n_bins_f, int n_bins,
           unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned int hist[];
  __shared__ T col[D][kRows];

  const int row_tile = blockIdx.x;
  const int n_tiles = (n + kRows - 1) / kRows;
  const int first = max(row_tile, (int)blockIdx.y * kSpan);
  const int last = min(n_tiles, ((int)blockIdx.y + 1) * kSpan);
  if (first >= last) return;  // the whole block: left of the diagonal

  T cm[D][D], iv[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) {
      cm[a][b] = cellm[a * D + b];
      iv[a][b] = inv[a * D + b];
    }
  for (int b = threadIdx.x; b < n_bins; b += kRows) hist[b] = 0;

  const int i = row_tile * kRows + threadIdx.x;
  T xi[D];
#pragma unroll
  for (int k = 0; k < D; ++k) xi[k] = i < n ? pos[(size_t)i * D + k] : T(0);

  for (int tile = first; tile < last; ++tile) {
    __syncthreads();  // the previous tile is read (and hist is zeroed)
    const int jl = tile * kRows + threadIdx.x;
#pragma unroll
    for (int k = 0; k < D; ++k)
      col[k][threadIdx.x] = jl < n ? pos[(size_t)jl * D + k] : T(0);
    __syncthreads();
    if (i >= n) continue;
    const int j0 = tile * kRows;
    const int jn = min(kRows, n - j0);
    // The diagonal tile: only j > i, each unordered pair once.
    const int start = tile == row_tile ? threadIdx.x + 1 : 0;
    for (int jj = start; jj < jn; ++jj) {
      T d[D], f[D];
#pragma unroll
      for (int k = 0; k < D; ++k) d[k] = xi[k] - col[k][jj];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        T s = iv[k][0] * d[0];
#pragma unroll
        for (int b = 1; b < D; ++b) s = s + iv[k][b] * d[b];
        f[k] = s - round_even(s);
      }
      T r2 = T(0);
#pragma unroll
      for (int a = 0; a < D; ++a) {
        T c = cm[a][0] * f[0];
#pragma unroll
        for (int b = 1; b < D; ++b) c = c + cm[a][b] * f[b];
        r2 = a == 0 ? c * c : r2 + c * c;
      }
      const T r = sqrt(r2);
      if (r < r_max) {
        const int bin = min(static_cast<int>(r / r_max * n_bins_f),
                            n_bins - 1);
        atomicAdd(&hist[bin], 2u);
      }
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += kRows)
    if (hist[b]) atomicAdd(&counts[b], (unsigned long long)hist[b]);
}

template <typename T>
int launch(const T* pos, int n, int dim, const T* cellm, const T* inv,
           double r_max, int n_bins, int64_t* counts, void* stream) {
  if (n_bins < 1 || n_bins > kMaxBins) return kErrBins;
  if (dim != 2 && dim != 3) return kErrDim;
  if (n < 2) return 0;
  const int n_tiles = (n + kRows - 1) / kRows;
  const dim3 grid(n_tiles, (n_tiles + kSpan - 1) / kSpan);
  const size_t smem = (size_t)n_bins * sizeof(unsigned int);
  auto* out = reinterpret_cast<unsigned long long*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3)
    rdf_kernel<T, 3><<<grid, kRows, smem, s>>>(
        pos, n, cellm, inv, static_cast<T>(r_max), static_cast<T>(n_bins),
        n_bins, out);
  else
    rdf_kernel<T, 2><<<grid, kRows, smem, s>>>(
        pos, n, cellm, inv, static_cast<T>(r_max), static_cast<T>(n_bins),
        n_bins, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// pos: (n, dim) row-major; cellm, inv: (dim, dim) row-major; counts:
// (n_bins,) int64, zeroed by the caller (the kernel adds to it).
int mdtpu_rdf_histogram_f32(const float* pos, int n, int dim,
                            const float* cellm, const float* inv,
                            double r_max, int n_bins, int64_t* counts,
                            void* stream) {
  return launch<float>(pos, n, dim, cellm, inv, r_max, n_bins, counts,
                       stream);
}

int mdtpu_rdf_histogram_f64(const double* pos, int n, int dim,
                            const double* cellm, const double* inv,
                            double r_max, int n_bins, int64_t* counts,
                            void* stream) {
  return launch<double>(pos, n, dim, cellm, inv, r_max, n_bins, counts,
                        stream);
}

const char* mdtpu_rdf_histogram_error_string(int code) {
  switch (code) {
    case kErrBins: return "n_bins outside 1 .. 12288";
    case kErrDim: return "positions must be (N, 2) or (N, 3)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
