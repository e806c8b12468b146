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
// (n_bins,). Built with -fmad=false, so every product and sum rounds as the
// plain PyTorch version's (ops/rdf.py:rdf_histogram_plain) and the counts
// are the same integers.
//
// The minimum image is exactly antisymmetric (x_j - x_i = -(x_i - x_j),
// the products and sums negate, rint(-f) = -rint(f)), so r_ji = r_ij bit
// for bit: each unordered pair is visited once and adds 2.
//
// What bounds it on the H100: operations. It reads N D values and writes
// n_bins counts. The first design did every unordered pair's
// distance by the general matrix arithmetic (~46 operations in 3D), an
// IEEE square root, and for a pair inside r_max an IEEE division: about 75
// instructions a pair, issue-bound at 26% of its bound. This design cuts
// the instructions a pair and, where r_max is short, the pairs:
//
//   * Zero pattern. The distance is one __device__ function templated on
//     the pattern of both matrices: general, upper triangular (a tilted
//     box) or diagonal (an orthorhombic one); the host reads the pattern
//     from the two matrices in their dtype. A product with a zero entry is
//     dropped with the add that takes it. This keeps every bit: the product
//     0 * d is +-0; adding +-0 to a nonzero value leaves it unchanged; a sum
//     whose terms are all zero is +-0 either way, so frac is +-0 where the
//     full sum gives +-0, and then (-0 - rint(-0) and +0 - rint(+0) are
//     both 0) enters c only as +-0 and r^2 only squared. (Positions are
//     finite, so no 0 * inf arises.) 3D: 46 operations a distance general,
//     34 triangular, 22 diagonal; 2D: 23, 19, 15 (the compare included).
//   * No square root for a pair beyond r_max. sqrt_rn is monotone, and so
//     are the division by r_max, the product with n_bins and the
//     truncation, so the bin is a step function of r^2 in the dtype. The
//     host finds its edges by bisection over the dtype's bit patterns with
//     numpy's correctly rounded arithmetic (ops/rdf.py bin_edges): e_b, the
//     least r^2 whose bin is at least b, for b = 1 .. n_bins - 1, with e_0
//     = 0 and e_{n_bins} = t, the least r^2 with sqrt_rn(r^2) >= r_max. A
//     pair is inside iff r^2 < t. At float64 its bin is the largest b with
//     e_b <= r^2: a guess from an approximate float square root, corrected
//     against the edges held in shared memory, with no IEEE square root or
//     division. At float32 the pair inside takes the IEEE sequence (square
//     root, division, product, truncation), which measured faster there
//     (PERF.md section 6). The same integers either way.
//   * Two routes (ops/rdf.py rdf_plan picks one on the host by shape; both
//     evaluate a pair with the same function on the raw positions):
//       - tile route: a block of kTile threads holds one row a thread
//         and walks up to kSpan column tiles of kTile columns at or right
//         of its own (the diagonal tile takes j > i), each staged in shared
//         memory and read back as a broadcast. The grid holds only the
//         (row tile, span) blocks with work. (Two or four rows a thread,
//         to reuse each staged column, and histograms a warp measured no
//         faster: PERF.md section 6.)
//       - cell route, where r_max is short: the host bins the particles by
//         their wrapped fractional coordinates on a grid of cells at least
//         r_max (1 + margin) wide across (at least 3 an axis) and sorts
//         them by cell. A block takes cells in turn and stages the cell and
//         the half of its 3^D - 1 neighbours that lie lexicographically
//         ahead (13 in 3D, 4 in 2D; with 3 or more cells an axis each
//         unordered pair of neighbouring cells once), kStage candidates at
//         a time; its own particles take kCellThreads / own lanes each over
//         the staged candidates (j > i within the cell), adding 2 a hit.
//         Exactness: the margin covers the rounding of the binning near a
//         cell face and of d = x_i - x_j for positions outside the primary
//         cell (derived in ops/rdf.py cell_grid_for from the dtype's unit
//         roundoff, the cell's conditioning and the largest |fractional
//         coordinate|): a pair two or more cells apart along an axis has a
//         computed r >= r_max, so skipping it skips no count.
//   * A histogram in shared memory per block (32-bit integer atomics),
//     added to the global int64 counts at the end with one atomic per
//     non-empty bin; integer sums do not depend on their order, so the
//     counts repeat exactly.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kGeneral = 0;
constexpr int kUpper = 1;
constexpr int kDiagonal = 2;

constexpr int kTile = 128;          // rows of a tile block = its columns
constexpr int kSpan = 16;           // column tiles a tile block walks
constexpr int kCellThreads = 128;
constexpr int kStage = 512;         // candidates a cell block stages
constexpr int kCellBlocksPerSm = 16;
constexpr int kMaxBins = 12288;
constexpr int kMaxSharedBytes = 232448;  // a block's shared memory, sm_90
constexpr int kErrBins = -1;
constexpr int kErrDim = -2;
constexpr int kErrPlan = -3;

template <typename T, int D>
struct Box {
  T cell[D][D];
  T inv[D][D];
};

// What bins a pair: the edges (in shared memory once a block has loaded
// them), r_max and n_bins in the dtype, and n_bins / r_max for the guess.
template <typename T>
struct Bins {
  const T* edges;
  int n_bins;
  T r_max, n_bins_f;
  float scale;
};

// float64 reads its bins from the edges; float32 takes the IEEE sequence.
template <typename T>
struct BinByEdges : std::is_same<T, double> {};

__host__ __device__ constexpr bool kept(int pattern, int row, int col) {
  return pattern == kGeneral || (pattern == kUpper ? col >= row : col == row);
}

__device__ __forceinline__ float round_even(float x) { return rintf(x); }
__device__ __forceinline__ double round_even(double x) { return rint(x); }

// sum_b m[row][b] v[b] in index order over the entries the pattern keeps
// (the others are zero; see the note above).
template <typename T, int D, int P>
__device__ __forceinline__ T row_dot(const T (&m)[D][D], int row,
                                     const T (&v)[D]) {
  T s = T(0);
  bool first = true;
#pragma unroll
  for (int b = 0; b < D; ++b) {
    if (!kept(P, row, b)) continue;
    const T p = m[row][b] * v[b];
    s = first ? p : s + p;
    first = false;
  }
  return s;
}

// The squared minimum-image distance of the JAX expression.
template <typename T, int D, int P>
__device__ __forceinline__ T min_image_r2(const T (&xi)[D], const T (&xj)[D],
                                          const Box<T, D>& box) {
  T d[D], f[D];
#pragma unroll
  for (int k = 0; k < D; ++k) d[k] = xi[k] - xj[k];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const T s = row_dot<T, D, P>(box.inv, k, d);
    f[k] = s - round_even(s);
  }
  T r2 = T(0);
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const T c = row_dot<T, D, P>(box.cell, a, f);
    r2 = a == 0 ? c * c : r2 + c * c;
  }
  return r2;
}

// A float near r2 for the bin's guess: r2 itself, or for a double the
// float made of its high word (no conversion instruction; r2 below 2^-126
// gives some other float, and the edges still decide).
__device__ __forceinline__ float guess_float(float r2) { return r2; }
__device__ __forceinline__ float guess_float(double r2) {
  const unsigned hi = (unsigned)__double2hiint(r2);
  return __uint_as_float((hi - ((1023u - 127u) << 20)) << 3);
}

// The bin of a pair inside r_max (r2 < edges[n_bins]). From the edges: the
// largest b with edges[b] <= r2 (edges[0] = 0); the guess,
// round(sqrt(r2) n_bins / r_max) from an approximate square root and the
// integer in the low bits of x + 1.5 2^23, is within a bin or two, and the
// edges decide. Else min(trunc(sqrt(r2) / r_max * n_bins), n_bins - 1) in
// IEEE arithmetic, as the plain version computes it.
template <typename T>
__device__ __forceinline__ int bin_of(T r2, const Bins<T>& bins) {
  if (!BinByEdges<T>::value)
    return min(static_cast<int>(sqrt(r2) / bins.r_max * bins.n_bins_f),
               bins.n_bins - 1);
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(guess_float(r2)));
  int b = __float_as_int(r * bins.scale + 12582912.0f) - 0x4B400000;
  b = min(max(b, 0), bins.n_bins - 1);
  while (b + 1 < bins.n_bins && bins.edges[b + 1] <= r2) ++b;
  while (bins.edges[b] > r2) --b;
  return b;
}

// Shared memory of a block: the edges (n_bins + 1 of T), then the
// histogram (n_bins 32-bit counts).
template <typename T>
size_t dynamic_shared(int n_bins) {
  return (size_t)(n_bins + 1) * sizeof(T) + (size_t)n_bins * sizeof(unsigned);
}

// Loads the edges and zeroes the histogram; points bins at the copy.
template <typename T>
__device__ unsigned* setup_shared(unsigned char* smem, Bins<T>& bins) {
  T* edges = reinterpret_cast<T*>(smem);
  unsigned* hist = reinterpret_cast<unsigned*>(edges + bins.n_bins + 1);
  for (int b = threadIdx.x; b <= bins.n_bins; b += blockDim.x)
    edges[b] = bins.edges[b];
  for (int b = threadIdx.x; b < bins.n_bins; b += blockDim.x) hist[b] = 0;
  bins.edges = edges;
  return hist;
}

__device__ void flush_hist(const unsigned* hist, int n_bins,
                           unsigned long long* counts) {
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x)
    if (hist[b]) atomicAdd(&counts[b], (unsigned long long)hist[b]);
}

// ----------------------------------------------------------------- tiles

// Blocks of the tile route: span y holds the row tiles 0 ..
// min(n_tiles, (y + 1) kSpan) - 1, the ones with a column tile at or right
// of their own among the span's.
inline int tile_blocks(int n_tiles) {
  int blocks = 0;
  for (int y = 0; y * kSpan < n_tiles; ++y)
    blocks += n_tiles < (y + 1) * kSpan ? n_tiles : (y + 1) * kSpan;
  return blocks;
}

template <typename T, int D, int P>
__global__ void __launch_bounds__(kTile)
rdf_tile_kernel(const T* __restrict__ pos, int n, Box<T, D> box,
                Bins<T> bins, unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T col[D][kTile];

  const int n_tiles = (n + kTile - 1) / kTile;
  int x = blockIdx.x, y = 0;
  for (;;) {
    const int rows = min(n_tiles, (y + 1) * kSpan);
    if (x < rows) break;
    x -= rows;
    ++y;
  }
  const int first = max(x, y * kSpan);
  const int last = min(n_tiles, (y + 1) * kSpan);

  const T t = bins.edges[bins.n_bins];
  unsigned* hist = setup_shared(smem, bins);
  // Rows past n lie only in the last row tile, whose only column tile is
  // the diagonal one, where j > i keeps them out.
  const int i = x * kTile + threadIdx.x;
  T xi[D];
#pragma unroll
  for (int k = 0; k < D; ++k) xi[k] = i < n ? pos[(size_t)i * D + k] : T(0);

  for (int tile = first; tile < last; ++tile) {
    __syncthreads();  // the previous tile is read (and hist is zeroed)
    const int j = tile * kTile + threadIdx.x;
#pragma unroll
    for (int k = 0; k < D; ++k)
      col[k][threadIdx.x] = j < n ? pos[(size_t)j * D + k] : T(0);
    __syncthreads();
    const int jn = min(kTile, n - tile * kTile);
    // The diagonal tile: only j > i, each unordered pair once.
    for (int jj = tile == x ? threadIdx.x + 1 : 0; jj < jn; ++jj) {
      T xj[D];
#pragma unroll
      for (int k = 0; k < D; ++k) xj[k] = col[k][jj];
      const T r2 = min_image_r2<T, D, P>(xi, xj, box);
      if (r2 < t) atomicAdd(&hist[bin_of(r2, bins)], 2u);
    }
  }
  flush_hist(hist, bins.n_bins, counts);
}

// ----------------------------------------------------------------- cells

// The cell and its neighbours lexicographically ahead: 1 + 13 in 3D, 1 + 4
// in 2D.
template <int D>
struct HalfStencil {
  static constexpr int kRuns = D == 3 ? 14 : 5;
};

// Offset h (1 .. kRuns - 1) of the half stencil along the axes.
template <int D>
__device__ __forceinline__ void half_offset(int h, int (&o)[3]) {
  if (D == 3) {
    // (0,0,1); (0,1,-1..1); (1,-1..1,-1..1)
    if (h == 1) {
      o[0] = 0; o[1] = 0; o[2] = 1;
    } else if (h < 5) {
      o[0] = 0; o[1] = 1; o[2] = h - 3;
    } else {
      o[0] = 1; o[1] = (h - 5) / 3 - 1; o[2] = (h - 5) % 3 - 1;
    }
  } else {
    // (0,1); (1,-1..1)
    if (h == 1) {
      o[0] = 0; o[1] = 1;
    } else {
      o[0] = 1; o[1] = h - 3;
    }
    o[2] = 0;
  }
}

template <typename T, int D, int P>
__global__ void __launch_bounds__(kCellThreads)
rdf_cell_kernel(const T* __restrict__ spos, const int64_t* __restrict__ starts,
                const int64_t* __restrict__ cell_counts, int g0, int g1,
                int g2, Box<T, D> box, Bins<T> bins,
                unsigned long long* __restrict__ counts) {
  constexpr int kRuns = HalfStencil<D>::kRuns;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T stage[D][kStage];
  __shared__ int run_start[kRuns], run_len[kRuns];

  const T t = bins.edges[bins.n_bins];
  unsigned* hist = setup_shared(smem, bins);
  const int n_cells = g0 * g1 * g2;
  const int tid = threadIdx.x;

  for (int c = blockIdx.x; c < n_cells; c += gridDim.x) {
    __syncthreads();  // the last cell's runs and stage are read
    if (tid < kRuns) {
      int nc = c;
      if (tid > 0) {
        int o[3];
        half_offset<D>(tid, o);
        const int c0 = c / (g1 * g2), c1 = (c / g2) % g1, c2 = c % g2;
        const int a0 = (c0 + o[0] + g0) % g0, a1 = (c1 + o[1] + g1) % g1;
        const int a2 = (c2 + o[2] + g2) % g2;
        nc = (a0 * g1 + a1) * g2 + a2;
      }
      run_start[tid] = (int)starts[nc];
      run_len[tid] = (int)cell_counts[nc];
    }
    __syncthreads();
    const int own0 = run_start[0], own = run_len[0];
    if (own == 0) continue;
    int total = 0;
#pragma unroll
    for (int s = 0; s < kRuns; ++s) total += run_len[s];
    // The cell's particles in batches of at most kCellThreads, each with
    // `lanes` threads over the candidates; the own cell is run 0, at flat
    // index 0 .. own - 1, where a particle takes only the ones after it.
    for (int ob = 0; ob < own; ob += kCellThreads) {
      const int per = min(own - ob, kCellThreads);
      const int lanes = kCellThreads / per;
      const int p = ob + tid % per;
      const int q = tid / per;
      const bool active = q < lanes;
      T xi[D];
#pragma unroll
      for (int k = 0; k < D; ++k)
        xi[k] = active ? spos[(size_t)(own0 + p) * D + k] : T(0);
      for (int m0 = 0; m0 < total; m0 += kStage) {
        const int len = min(kStage, total - m0);
        __syncthreads();  // the previous stage is read
        for (int e = tid; e < len; e += kCellThreads) {
          int m = m0 + e, s = 0;
          while (m >= run_len[s]) m -= run_len[s++];
          const size_t g = (size_t)(run_start[s] + m) * D;
#pragma unroll
          for (int k = 0; k < D; ++k) stage[k][e] = spos[g + k];
        }
        __syncthreads();
        if (!active) continue;
        // The first candidate of lane q after particle p: m0 + jj > p.
        const int lo = p + 1 - m0;
        int jj = q;
        if (lo > q) jj = q + (lo - q + lanes - 1) / lanes * lanes;
        for (; jj < len; jj += lanes) {
          T xj[D];
#pragma unroll
          for (int k = 0; k < D; ++k) xj[k] = stage[k][jj];
          const T r2 = min_image_r2<T, D, P>(xi, xj, box);
          if (r2 < t) atomicAdd(&hist[bin_of(r2, bins)], 2u);
        }
      }
    }
  }
  flush_hist(hist, bins.n_bins, counts);
}

// ---------------------------------------------------------------- launch

template <typename K>
int allow_shared(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T, int D>
Box<T, D> make_box(const T* cellm, const T* inv) {
  Box<T, D> box;
  for (int a = 0; a < D; ++a)
    for (int b = 0; b < D; ++b) {
      box.cell[a][b] = cellm[a * D + b];
      box.inv[a][b] = inv[a * D + b];
    }
  return box;
}

template <typename T, int D, int P>
int tile_launch(const T* pos, int n, const Box<T, D>& box,
                const Bins<T>& bins, unsigned long long* out,
                cudaStream_t s) {
  const size_t smem = dynamic_shared<T>(bins.n_bins);
  auto kernel = rdf_tile_kernel<T, D, P>;
  const int rc = allow_shared(kernel, smem);
  if (rc) return rc;
  kernel<<<tile_blocks((n + kTile - 1) / kTile), kTile, smem, s>>>(
      pos, n, box, bins, out);
  return (int)cudaGetLastError();
}

template <typename T, int D, int P>
int cell_launch(const T* spos, const int64_t* starts,
                const int64_t* cell_counts, const int* grid,
                const Box<T, D>& box, const Bins<T>& bins,
                unsigned long long* out, cudaStream_t s) {
  const size_t smem = dynamic_shared<T>(bins.n_bins);
  auto kernel = rdf_cell_kernel<T, D, P>;
  int rc = allow_shared(kernel, smem);
  if (rc) return rc;
  int device = 0, sms = 0;
  rc = (int)cudaGetDevice(&device);
  if (!rc) rc = (int)cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (rc) return rc;
  const int g2 = D == 3 ? grid[2] : 1;
  const long long n_cells = (long long)grid[0] * grid[1] * g2;
  const long long most = (long long)kCellBlocksPerSm * sms;
  const int blocks = (int)(n_cells < most ? n_cells : most);
  kernel<<<blocks, kCellThreads, smem, s>>>(spos, starts, cell_counts,
                                            grid[0], grid[1], g2, box, bins,
                                            out);
  return (int)cudaGetLastError();
}

// route 0: tiles over pos (n, dim); route 1: cells, pos sorted by cell,
// starts and cell_counts (n_cells,) int64, grid (dim,) on the host.
template <typename T>
int launch(const T* pos, int n, int dim, const T* cellm, const T* inv,
           int pattern, const T* edges, int n_bins, double r_max, int route,
           const int64_t* starts, const int64_t* cell_counts,
           const int* grid, int64_t* counts, void* stream) {
  if (n_bins < 1 || n_bins > kMaxBins) return kErrBins;
  if (dim != 2 && dim != 3) return kErrDim;
  if (pattern < kGeneral || pattern > kDiagonal || route < 0 || route > 1 ||
      !(r_max > 0) ||
      dynamic_shared<T>(n_bins) +
              sizeof(T) * (size_t)dim * (route ? kStage : kTile) >
          (size_t)kMaxSharedBytes ||
      (route == 1 && (!starts || !cell_counts || !grid || grid[0] < 3 ||
                      grid[1] < 3 || (dim == 3 && grid[2] < 3))))
    return kErrPlan;
  if (n < 2) return 0;
  auto* out = reinterpret_cast<unsigned long long*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bins<T> bins{edges, n_bins, static_cast<T>(r_max),
                     static_cast<T>(n_bins),
                     static_cast<float>(n_bins / r_max)};
  auto run = [&](auto dim_c, auto pat_c) {
    constexpr int D = decltype(dim_c)::value;
    constexpr int P = decltype(pat_c)::value;
    const Box<T, D> box = make_box<T, D>(cellm, inv);
    return route == 0
               ? tile_launch<T, D, P>(pos, n, box, bins, out, s)
               : cell_launch<T, D, P>(pos, starts, cell_counts, grid, box,
                                      bins, out, s);
  };
  auto by_pattern = [&](auto dim_c) {
    if (pattern == kDiagonal)
      return run(dim_c, std::integral_constant<int, kDiagonal>());
    if (pattern == kUpper)
      return run(dim_c, std::integral_constant<int, kUpper>());
    return run(dim_c, std::integral_constant<int, kGeneral>());
  };
  return dim == 3 ? by_pattern(std::integral_constant<int, 3>())
                  : by_pattern(std::integral_constant<int, 2>());
}

}  // namespace

extern "C" {

// pos: (n, dim) row-major (route 1: sorted by cell); cellm, inv: (dim,
// dim) row-major on the host; pattern 0 general, 1 upper triangular, 2
// diagonal (both matrices); edges: (n_bins + 1,) on the device (ops/rdf.py
// bin_edges for r_max); route 0 tiles, 1 cells (starts, cell_counts
// (n_cells,) int64 on the device; grid (dim,) on the host); counts:
// (n_bins,) int64, zeroed by the caller (the kernel adds to it).
int mdtpu_rdf_histogram_f32(const float* pos, int n, int dim,
                            const float* cellm, const float* inv,
                            int pattern, const float* edges, int n_bins,
                            double r_max, int route, const int64_t* starts,
                            const int64_t* cell_counts, const int* grid,
                            int64_t* counts, void* stream) {
  return launch<float>(pos, n, dim, cellm, inv, pattern, edges, n_bins,
                       r_max, route, starts, cell_counts, grid, counts,
                       stream);
}

int mdtpu_rdf_histogram_f64(const double* pos, int n, int dim,
                            const double* cellm, const double* inv,
                            int pattern, const double* edges, int n_bins,
                            double r_max, int route, const int64_t* starts,
                            const int64_t* cell_counts, const int* grid,
                            int64_t* counts, void* stream) {
  return launch<double>(pos, n, dim, cellm, inv, pattern, edges, n_bins,
                        r_max, route, starts, cell_counts, grid, counts,
                        stream);
}

const char* mdtpu_rdf_histogram_error_string(int code) {
  switch (code) {
    case kErrBins: return "n_bins outside 1 .. 12288";
    case kErrDim: return "positions must be (N, 2) or (N, 3)";
    case kErrPlan: return "the plan does not match what the kernel takes";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
