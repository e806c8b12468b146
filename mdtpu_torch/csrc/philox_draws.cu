// The slot step's random draws, its rebuild test and the velocity finish's
// scalar tail, as kernels that read the step from device memory, for NVIDIA
// Hopper (sm_90a); and the conditional node through which a captured slot
// step rebins.
//
// The JAX package runs a whole segment of the slot loop as one device
// program (mdtpu/integrate/slot_step.py:610-691 make_slot_advance): the
// step counter, the draws and the rebuild decision never leave the device,
// and XLA fuses each step's scalar chains into its other work. These
// kernels let the port do the same inside a CUDA graph that is replayed
// once a step (mdtpu_torch/integrate/slot_step.py SlotAdvance), where every
// launch is a graph node of its own and costs about as much as the small
// work it does:
//
//   * velocity_finish ports mdtpu/integrate/thermostat.py:52-67
//     bussi_scale_from_kinetic with :31 compute_kinetic and :37-40
//     compute_temperature (one XLA fusion there): from the velocities (or
//     the kinetic energy already summed, the sharded route's) and the step
//     counter, Bussi's rescale factor and the temperature after it (NVT),
//     or the temperature alone (NVE), as the 0-d tensors a step needs. One
//     launch where the torch composition took ~22. The sum: each thread
//     adds the squares of its values (grid-stride, in float64, eight loads
//     out before their adds) in order, each block reduces its threads in a
//     fixed tree of shuffles and stores one partial, and the block that
//     draws the last integer ticket sums the partials in block order by the
//     same tree and puts the ticket back to 0 (one partial array and one
//     ticket per card, so two launches must not run at once on two
//     streams). The grid depends on the count of values alone, so the sum
//     repeats bit for bit (velocity_finish.kinetic_plain emulates it). One
//     more block, block 0, draws: warp 1 r1, warp 0 the 32 gamma attempts,
//     one a lane, the first accepting one taken by a ballot (the attempt
//     and the bits the sequential loop of bussi_draw takes). The last block
//     follows the torch composition operation for operation (thermostat.py
//     bussi_scale_from_kinetic, step.py md_velocity_finish, as PyTorch's
//     CUDA kernels evaluate them: a tensor divided by a Python number is a
//     product with its reciprocal, a Python number divided by a tensor the
//     tensor's reciprocal times it, a Python number rounded to the tensor's
//     dtype first), so given the same K it equals the composition on the
//     card bit for bit.
//     Bound: the read of the velocities (bytes, 0.45 us at the bench's
//     slots), far below the launch floor (~1 us a graph node), so what
//     bounds it is latency: a chain of dependent round trips to memory
//     and float64 arithmetic after the launch. The design takes each link
//     off the path it can:
//       - It launches as a programmatic dependent of the kernel before it
//         (the step's Kahan half-kick, which writes v): the launch and
//         everything before griddepcontrol.wait overlap that kernel's
//         tail. Summing, nothing is read before the wait: the draw block
//         reads the step and draws after it, beside the sum, off the
//         sum's path. Given K (one block, nothing to overlap the draws
//         with after the wait), the step is read and the draws are made
//         (into shared memory) before the wait; *kinetic, the target and
//         every global write come after it. The given-K callers' step: the
//         sharded route's, a host step (a number); particle order's,
//         state.step + 1 from the step before; no kernel just before
//         writes it.
//       - The draw block computes, after the wait, every operand of the
//         composition that does not depend on K in its own operations and
//         dtype (r2 + r1 r1, r1 2, and the target times numer: *base and
//         the table entry, two dependent loads, are read here, off the
//         sum's path), and hands the three over in one store.
//       - A block publishes its partial (or the handover) by one
//         acquire-release fetch-add on the ticket, with no fence of its
//         own; the last block issues its partials' loads and the
//         handover's together, so one round trip to memory follows the
//         sum. It puts the ticket back after the wait, so two instances that
//         overlap never share it; nothing relies on blocks being resident
//         at once.
//       - Given K (one block), the draws stay in shared memory: no global
//         store, fence or reload.
//     Measured and dropped: the partials combined through clusters of 8
//     blocks in distributed shared memory, one ticket a cluster (slower).
//   * bussi_draw: the same draws, by the same two warps
//     (bussi_draws_two_warps, one algorithm for the draw): r1 by
//     Box-Muller, cos branch, from block 0 (warp 1); the gamma variate by
//     Marsaglia and Tsang (2000), attempt t on lane t of warp 0 taking its
//     normal from block 1 + 2t and its acceptance uniform from words 0-1
//     of block 2 + 2t, the first accepting lane by a ballot (an attempt
//     depends on nothing but its own blocks, so that is the first
//     accepting attempt of a loop over them in order); for a < 1 the
//     variate of a + 1 times u^(1/a), u from words 2-3 of the accepting
//     block; kGammaAttempts attempts, none accepting leaving d; r2 = 0
//     where dof <= 0. Ports thermostat.py:43-50 sum_noises and :59-61
//     (XLA's jax.random.normal and jax.random.gamma). No step launches it
//     since velocity_finish draws in the step; thermostat.bussi_noise
//     does, and the card's checks hold velocity_finish against the
//     composition fed with its draws. Counter (block, step lo, step hi,
//     0), key the seed's two words. Bound: its float64 chain (a Philox
//     block, a Box-Muller and a gamma test, each lane's in parallel), far
//     below the launch; it launches as a programmatic dependent that reads
//     nothing before griddepcontrol.wait (the step after it), so only its
//     launch overlaps the kernel before it. Its first design, one thread
//     running the attempts in series, took 3.2x the launch floor.
//   * uniform_noise ports mdtpu/integrate/step.py:110-119 brownian_noise
//     (XLA's jax.random.uniform): the (d, S) variance-matched uniforms
//     (2u - 1) sqrt(3), element e of the flattened array from block
//     e / 4 (float32: word e % 4, its top 24 bits) or e / 2 (float64: 53
//     bits of two words), counter (block, step lo, step hi, 1 | rank << 8).
//     The arithmetic is integer and exactly rounded (2u - 1 is exact, one
//     rounding in the product), so it equals its plain version bit for
//     bit. Bound: the write of (d, S) values (bytes, 0.45 us at the
//     bench's slots), below the launch floor: what bounds it is the launch,
//     the dependent read of the step and the stores' drain. It launches as
//     a programmatic dependent: a thread reads the step (or takes a host
//     step as a number) and makes its Philox words before the wait and
//     stores them as 16-byte vectors after it (the output may be memory
//     the graph's pool handed back after the kernel before read it). Its
//     callers' step: particle order's (PlaneEngine's Brownian step),
//     state.step + 1 from the step before, or a host step; never written
//     by the kernel just before. The Brownian slot step draws the same
//     values inside its update instead (verlet_update.cu
//     brownian_update_kernel; the values by philox.cuh noise_values). A
//     thread makes one block of words (two over half the grid were
//     measured and dropped: slower inside the Brownian slot step).
//   * rebuild_flag ports mdtpu/integrate/slot_step.py:460 slot_needs_rebin
//     (the drift test): d2 = sum_k (x_k - ref_k)^2 in component order over
//     positions and ref_positions (d, S), flag = any(d2 > (T) thr). Bound:
//     the two (d, S) reads. A thread takes 16 bytes of every row (4 float
//     or 2 double slots; a row whose start is not 16-byte aligned, as S
//     odd makes rows 1 and 2, is read as two aligned vectors and shifted),
//     all its loads out before it tests, grid-stride over few blocks (one
//     a multiprocessor at the bench's slots); a block ORs its threads' tests
//     (__syncthreads_or) into one word, and the block that draws the last
//     ticket writes the flag byte, puts the word and the ticket back to 0
//     and, inside a captured step, sets the IF node's handle itself. One
//     node a step, where a memset, the test and a kernel copying the byte
//     into the handle took three.
//   * rebuild_rows ports the particle-order drift test the JAX package's
//     step makes inside its fori_loop (mdtpu/integrate/step.py:52-68,
//     mdtpu/ops/cell_grid.py needs_rebuild with core/box.py minimum_image,
//     mdtpu/ops/neighbor_list.py needs_rebuild): the displacement of each
//     (N, d) particle row from its reference, minimum-imaged by the cell
//     matrix (the cell grid, PlaneEngine) or by the box lengths (the
//     list; read at a stride, so the cell's diagonal needs no copy), d2 in
//     component order, flag = any(d2 > thr). Bound: the two (N, d) reads
//     (1.6 MB at the bench's 65,536 float32 particles, 0.47 us), below the
//     launch floor, so what bounds it is latency. The design: a particle a
//     thread on a grid fixed by the count (particle_rows.cuh: 256 a
//     block, one wave); a programmatic dependent of the kernel before it
//     (the kick-drift-wrap or FIRE's move, which write the positions):
//     ref is loaded before griddepcontrol.wait, the positions and the box
//     after it; the block's OR, then one relaxed fetch_add a block that
//     carries its count and its hit in one word, the last block writing
//     the flag byte, putting the word back and setting the IF node's
//     handle.
//   * philox_words: the generator's words for given counters and keys,
//     for the known-answer checks on the card. empty: a kernel that does
//     nothing (launched as a programmatic dependent, it only waits), whose
//     time in a graph of many is the card's launch floor.
//   * graph_if_handle / graph_if_begin / graph_if_end: an IF conditional
//     node (CUDA 12.4+) in the graph being captured on a stream, for torch
//     versions without CUDAGraph.begin_capture_to_if_node. The handle comes
//     first, so the rebuild test captured next can set it; the caller then
//     adds the node, captures the body on a second stream into the node's
//     child graph and ends that capture. The decision stays on the device.
//     graph_while_begin / _end: the same for a WHILE node (the JAX
//     package's lax.while_loop: a segment of steps, FIRE's minimization),
//     whose body may hold an IF node of its own (nested conditional nodes,
//     CUDA 12.4+). step_below: a captured segment's loop test, the step
//     counter below the segment's end, setting the WHILE node's handle
//     (one thread; it replaces the while_loop's cond of
//     mdtpu/integrate/slot_step.py:642-690, XLA). rebuild_vote: a sharded
//     segment's rebuild decision (the outer loop's rebin of
//     mdtpu/integrate/slot_step.py:648-677 under shard_map, where the
//     inner while_loop exits on a psum'd drift flag), from the ring's
//     all-reduced vote of the ranks' drift flags or the step counter at the
//     segment's first step, into a flag byte and an IF node's handle (one
//     thread: three loads and a store; bound by the launch, as step_below).
//     capture_census counts the nodes of the graph being captured, by type
//     and for this file's kernels, and its programmatic edges.
//
// Built with -fmad=false, so every product and sum rounds as in the plain
// PyTorch versions (mdtpu_torch/ops/philox_draws.py,
// mdtpu_torch/integrate/velocity_finish.py).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda/atomic>
#include <stdint.h>

#include <vector>

#include "particle_rows.cuh"
#include "philox.cuh"

namespace {

using mdtpu::philox::counter;
using mdtpu::philox::noise_values;
using mdtpu::philox::philox4x32_10;
using mdtpu::philox::u24;
using mdtpu::philox::u53;

constexpr int kErrArgs = -1;
constexpr int kErrNotCapturing = -2;
constexpr int kGammaAttempts = 32;   // one a lane of a warp in velocity_finish
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kTestMaxBlocks = 264;  // two a streaming multiprocessor
constexpr int kFinishMaxBlocks = 256;
constexpr int kFinishPerBlock = 2048;  // values a block sums below the cap
constexpr int kFinishBatch = 8;       // loads a thread issues before adding
constexpr int kDrawThreads = 64;     // the draw's two warps
constexpr double kTwoPi = 6.283185307179586;  // 2 * math.pi
constexpr unsigned kAll = 0xffffffffu;

// A standard normal from one block of words: sqrt(-2 log u1) cos(2 pi u2),
// u1 in (0, 1] from words 0-1, u2 in [0, 1) from words 2-3.
__device__ double box_muller(uint4 w) {
  const double u1 = 1.0 - u53(w.x, w.y);
  const double u2 = u53(w.z, w.w);
  return sqrt(-2.0 * log(u1)) * cos(kTwoPi * u2);
}

// Marsaglia and Tsang's constants for Gamma(dof / 2): a, d, c, and whether
// a < 1 takes the variate of a + 1 times u^(1/a).
struct GammaSetup {
  double a, d, c;
  bool boost;
  __device__ explicit GammaSetup(double dof) {
    a = 0.5 * dof;
    boost = a < 1.0;
    d = (boost ? a + 1.0 : a) - 1.0 / 3.0;
    c = 1.0 / sqrt(9.0 * d);
  }
};

// Attempt t of step s: whether it accepts, its variate d v and the boost's
// uniform from words 2-3 of its uniform block.
__device__ bool gamma_attempt(int t, int64_t s, uint2 key,
                              const GammaSetup& p, double& g, double& ub) {
  const double x = box_muller(philox4x32_10(counter(1 + 2 * t, s, 0), key));
  const uint4 w = philox4x32_10(counter(2 + 2 * t, s, 0), key);
  const double cx = 1.0 + p.c * x;
  const double v = cx * cx * cx;
  const double u = 1.0 - u53(w.x, w.y);
  g = p.d * v;
  ub = 1.0 - u53(w.z, w.w);
  return v > 0.0 && log(u) < 0.5 * x * x + p.d - p.d * v + p.d * log(v);
}

// Waits until the grids this one depends on programmatically have ended
// and their writes are visible (Hopper's griddepcontrol.wait; at once for
// a grid launched without the attribute). Nothing before it may read what
// the kernel launched just before writes, or write global memory.
__device__ __forceinline__ void wait_for_dependencies() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Element e of the noise from Philox block e / 4 (float32: the word's top
// 24 bits) or e / 2 (float64: 53 bits of two words).
template <typename T>
struct Noise;

template <>
struct Noise<float> {
  static constexpr int kPer = 4;
  __device__ static void store(uint4 w, int64_t b, int64_t n, float* out) {
    float v[4];
    noise_values(w, v);
    const int64_t e = 4 * b;
    if (e + 3 < n) {
      reinterpret_cast<float4*>(out)[b] = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      out[e] = v[0];
      if (e + 1 < n) out[e + 1] = v[1];
      if (e + 2 < n) out[e + 2] = v[2];
    }
  }
};

template <>
struct Noise<double> {
  static constexpr int kPer = 2;
  __device__ static void store(uint4 w, int64_t b, int64_t n, double* out) {
    double v[2];
    noise_values(w, v);
    const int64_t e = 2 * b;
    if (e + 1 < n) {
      reinterpret_cast<double2*>(out)[b] = make_double2(v[0], v[1]);
    } else {
      out[e] = v[0];
    }
  }
};

// One Philox block a thread (grid-stride), stored as one 16-byte vector.
// The step and the first words come before the wait, the stores after it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    uniform_noise_kernel(const int64_t* step, int64_t step_value, uint2 key,
                         uint32_t stream, int64_t n, T* out) {
  const int64_t blocks = (n + Noise<T>::kPer - 1) / Noise<T>::kPer;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t b = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (b >= blocks) return;
  const int64_t s = step ? *step : step_value;
  bool waited = false;
  for (; b < blocks; b += stride) {
    const uint4 w = philox4x32_10(counter((uint32_t)b, s, stream), key);
    if (!waited) {
      wait_for_dependencies();
      waited = true;
    }
    Noise<T>::store(w, b, n, out);
  }
}

// ------------------------------------------------------------ rebuild test

// 16 bytes of a row from p on: kWidth values. off is p's place, in values,
// in its aligned 16-byte chunk (the same for a whole row, since a thread
// starts at a multiple of kWidth); where it is not 0 the two chunks it
// straddles (both hold values of the row) are read and shifted. Both loads
// are issued whatever off is (the second at the first chunk again where
// off is 0), so a thread's loads of every row go out before any is used.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kWidth = 4;
  __device__ static void load(const float* p, int off, float (&x)[4]) {
    const float4* q = reinterpret_cast<const float4*>(p - off);
    const float4 a = __ldg(q);
    const float4 b = __ldg(q + (off != 0));
    const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    switch (off) {
      case 0: x[0] = w[0]; x[1] = w[1]; x[2] = w[2]; x[3] = w[3]; break;
      case 1: x[0] = w[1]; x[1] = w[2]; x[2] = w[3]; x[3] = w[4]; break;
      case 2: x[0] = w[2]; x[1] = w[3]; x[2] = w[4]; x[3] = w[5]; break;
      default: x[0] = w[3]; x[1] = w[4]; x[2] = w[5]; x[3] = w[6]; break;
    }
  }
};

template <>
struct Chunk<double> {
  static constexpr int kWidth = 2;
  __device__ static void load(const double* p, int off, double (&x)[2]) {
    const double2* q = reinterpret_cast<const double2*>(p - off);
    const double2 a = __ldg(q);
    const double2 b = __ldg(q + (off != 0));
    x[0] = off ? a.y : a.x;
    x[1] = off ? b.x : a.y;
  }
};

template <typename T>
__device__ __forceinline__ int chunk_offset(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) / sizeof(T)) %
               Chunk<T>::kWidth);
}

// Blocks that tested past the threshold (nonzero) and blocks done with
// the test, on this card (both 0 between launches).
__device__ unsigned int g_test_any = 0;
__device__ unsigned int g_test_ticket = 0;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    rebuild_flag_kernel(const T* __restrict__ pos, const T* __restrict__ ref,
                        int64_t n, T thr, bool* flag,
                        cudaGraphConditionalHandle handle, int set_handle) {
  constexpr int V = Chunk<T>::kWidth;
  const int64_t groups = n / V;
  const int64_t first = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int off_p[D], off_r[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    off_p[k] = chunk_offset(pos + k * n);
    off_r[k] = chunk_offset(ref + k * n);
  }
  bool any = false;
  for (int64_t g = first; g < groups; g += stride) {
    const int64_t i0 = g * V;
    T x[D][V], r[D][V];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      Chunk<T>::load(pos + k * n + i0, off_p[k], x[k]);
      Chunk<T>::load(ref + k * n + i0, off_r[k], r[k]);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      T dk = x[0][j] - r[0][j];
      T d2 = dk * dk;
#pragma unroll
      for (int k = 1; k < D; ++k) {
        dk = x[k][j] - r[k][j];
        d2 = d2 + dk * dk;
      }
      any = any || d2 > thr;
    }
  }
  // The last n % V slots, a thread each.
  for (int64_t i = groups * V + first; i < n; i += stride) {
    T dk = pos[i] - ref[i];
    T d2 = dk * dk;
#pragma unroll
    for (int k = 1; k < D; ++k) {
      dk = pos[k * n + i] - ref[k * n + i];
      d2 = d2 + dk * dk;
    }
    any = any || d2 > thr;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x != 0) return;
  if (any) atomicOr(&g_test_any, 1u);
  __threadfence();  // the OR is visible before the ticket
  if (atomicAdd(&g_test_ticket, 1u) != gridDim.x - 1) return;
  __threadfence();
  const bool hit = atomicExch(&g_test_any, 0u) != 0u;
  g_test_ticket = 0;
  *flag = hit;
  if (set_handle) cudaGraphSetConditional(handle, hit ? 1u : 0u);
}

// The box of the drift test of particle rows: CELL, the cell matrix c and
// its inverse ci (row-major, (D, D)); else the box lengths, len[k] at
// lengths[k * stride] (the cell's diagonal at stride D + 1 is a view the
// caller need not copy).
template <typename T, int D, bool CELL>
struct RowsBox {
  T c[D][D], ci[D][D], len[D];
  __device__ __forceinline__ void load(const T* m, const T* mi,
                                       int64_t stride) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (CELL) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
          c[k][j] = m[k * D + j];
          ci[k][j] = mi[k * D + j];
        }
      } else {
        len[k] = mi[k * stride];
      }
    }
  }

  // Whether the displacement x - r of one particle (D values each),
  // minimum-imaged, is longer than thr: d2 = sum_k dr_k^2 in component
  // order. CELL: as core/box.py minimum_image (frac_k = sum_j dr_j
  // ci[k][j], frac -= rint(frac), dr_k = sum_j frac_j c[k][j], j
  // ascending, each product rounded), the cell grid's and PlaneEngine's;
  // else dr_k -= L_k rint(dr_k / L_k) with a true division, the neighbour
  // list's.
  __device__ __forceinline__ bool drifted(const T* x, const T* r,
                                          T thr) const {
    T dr[D];
#pragma unroll
    for (int k = 0; k < D; ++k) dr[k] = x[k] - r[k];
    if (CELL) {
      T frac[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        T s = dr[0] * ci[k][0];
#pragma unroll
        for (int j = 1; j < D; ++j) s = s + dr[j] * ci[k][j];
        frac[k] = s - rint(s);
      }
#pragma unroll
      for (int k = 0; k < D; ++k) {
        T s = frac[0] * c[k][0];
#pragma unroll
        for (int j = 1; j < D; ++j) s = s + frac[j] * c[k][j];
        dr[k] = s;
      }
    } else {
#pragma unroll
      for (int k = 0; k < D; ++k)
        dr[k] = dr[k] - len[k] * rint(dr[k] / len[k]);
    }
    T d2 = dr[0] * dr[0];
#pragma unroll
    for (int k = 1; k < D; ++k) d2 = d2 + dr[k] * dr[k];
    return d2 > thr;
  }
};

// Blocks done with the particle rows' drift test (the low 16 bits) and
// those of them that found a particle past the threshold (the high 16
// bits), on this card (0 between launches).
__device__ unsigned int g_rows_word = 0;

// The drift test of (n, D) particle rows, flag = any(d2 > thr) over the
// particles (RowsBox::drifted), a particle a thread (particle_rows.cuh).
// A programmatic dependent: a thread's first reference row is loaded
// before griddepcontrol.wait, its positions and the box after it (see the
// note at the launch). The block's OR (__syncthreads_or), then one relaxed
// fetch_add a block that carries both its count and its hit: the block
// that takes the last count knows the answer from the sum, writes the flag
// byte, puts the word back to 0 and, inside a captured step, sets the IF
// node's handle. A grid of one block takes no word.
template <typename T, int D, bool CELL>
__global__ void __launch_bounds__(mdtpu::rows::kRowsThreads)
    rebuild_rows_kernel(const T* __restrict__ pos, const T* __restrict__ ref,
                        const T* __restrict__ m, const T* __restrict__ mi,
                        int64_t len_stride, int64_t n, T thr, bool* flag,
                        cudaGraphConditionalHandle handle, int set_handle) {
  const int64_t threads = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  T r[D] = {};
  if (i < n) mdtpu::rows::load_row<T, D>(ref, i, r);
  wait_for_dependencies();
  RowsBox<T, D, CELL> box;
  box.load(m, mi, len_stride);
  bool any = false;
  for (bool first = true; i < n; i += threads, first = false) {
    T x[D];
    if (!first) mdtpu::rows::load_row<T, D>(ref, i, r);
    mdtpu::rows::load_row<T, D>(pos, i, x);
    any = box.drifted(x, r, thr) || any;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x != 0) return;
  if (gridDim.x > 1) {
    // The word hands over nothing but itself, so relaxed order suffices;
    // the next launch's fetch_add comes after this grid has ended.
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> word(g_rows_word);
    const unsigned mine = 1u + (any ? 1u << 16 : 0u);
    const unsigned before = word.fetch_add(mine, cuda::memory_order_relaxed);
    if ((before & 0xFFFFu) != gridDim.x - 1) return;
    any = (before + mine) >> 16 != 0u;
    word.store(0u, cuda::memory_order_relaxed);
  }
  *flag = any;
  if (set_handle) cudaGraphSetConditional(handle, any ? 1u : 0u);
}

// --------------------------------------------------------- velocity finish

// The summing variant's block partials and its ticket, and the operands of
// the composition that do not depend on the kinetic energy, which the draw
// block hands to the block that finishes; on this card.
__device__ unsigned int g_finish_ticket = 0;
__device__ double g_finish_partial[kFinishMaxBlocks];
__device__ double g_finish_handover[3];

__host__ __device__ inline int finish_blocks(int64_t n) {
  const int64_t blocks = (n + kFinishPerBlock - 1) / kFinishPerBlock;
  return (int)(blocks < kFinishMaxBlocks ? (blocks > 0 ? blocks : 1)
                                         : kFinishMaxBlocks);
}

// The block's sum of a in a fixed order, in thread 0: a tree of shuffles
// within each warp, then the warps' sums by the same tree in warp 0 (the
// lanes past the warps adding 0). Every thread of the block calls it.
__device__ double block_sum(double a, double (&warp_sums)[kThreads / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(kAll, a, off);
  if (lane == 0) warp_sums[warp] = a;
  __syncthreads();
  if (warp != 0) return a;
  a = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(kAll, a, off);
  return a;
}

// Warps 0 and 1 of a block (all their lanes): Bussi's r1 (warp 1) and r2
// (warp 0: attempt t on lane t, the first accepting one by a ballot) into
// drawn[0] and drawn[1] in shared memory, for the block's next barrier.
__device__ void bussi_draws_two_warps(int64_t s, uint2 key, double dof,
                                      double* drawn) {
  static_assert(kGammaAttempts == 32, "one gamma attempt a lane");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 1) {
    if (lane == 0) drawn[0] = box_muller(philox4x32_10(counter(0, s, 0), key));
    return;
  }
  double r2 = 0.0;
  if (dof > 0.0) {
    const GammaSetup p(dof);
    double g, ub;
    const bool ok = gamma_attempt(lane, s, key, p, g, ub);
    const unsigned hits = __ballot_sync(kAll, ok);
    const int at = hits ? __ffs(hits) - 1 : 0;
    g = __shfl_sync(kAll, g, at);
    ub = __shfl_sync(kAll, ub, at);
    if (!hits) {
      g = p.d;
      ub = 1.0;
    }
    if (p.boost) g = g * pow(ub, 1.0 / p.a);
    r2 = 2.0 * g;
  }
  if (lane == 0) drawn[1] = r2;
}

// Bussi's (r1, r2) of one step into out (two T): 64 threads, the draws of
// bussi_draws_two_warps (the velocity finish's: one algorithm for the
// draw). A programmatic dependent of the kernel before it that reads
// nothing before griddepcontrol.wait: the step and the draws after it.
template <typename T>
__global__ void __launch_bounds__(kDrawThreads)
    bussi_draw_kernel(const int64_t* step, uint2 key, double dof, T* out) {
  __shared__ double drawn[2];
  wait_for_dependencies();
  bussi_draws_two_warps(*step, key, dof, drawn);
  __syncthreads();
  if (threadIdx.x == 0) {
    out[0] = static_cast<T>(drawn[0]);
    out[1] = static_cast<T>(drawn[1]);
  }
}

template <typename T>
__device__ __forceinline__ T sqrt_t(T x);
template <>
__device__ __forceinline__ float sqrt_t<float>(float x) { return sqrtf(x); }
template <>
__device__ __forceinline__ double sqrt_t<double>(double x) { return sqrt(x); }

// The operands of the composition that do not depend on K, in its own
// operations and dtype: a = r2 + r1 r1, b = r1 2, and c = target numer (KT:
// the target from the table) or numer.
template <typename T>
struct Handover {
  T a, b, c;
};

template <typename T, bool KT>
__device__ Handover<T> handover(const double* drawn, int64_t s,
                                const T* ktemp, const int64_t* base,
                                double numer) {
  const T r1 = static_cast<T>(drawn[0]);
  const T r2 = static_cast<T>(drawn[1]);
  Handover<T> h;
  h.a = r2 + r1 * r1;
  h.b = r1 * T(2);
  if constexpr (KT)
    h.c = ktemp[base ? s - *base : 0] * static_cast<T>(numer);
  else
    h.c = static_cast<T>(numer);
  return h;
}

template <typename T>
__device__ void store_handover(const Handover<T>& h) {
  g_finish_handover[0] = h.a;
  g_finish_handover[1] = h.b;
  g_finish_handover[2] = h.c;
}

// The rest of the torch composition, operation for operation, from K.
template <typename T, bool NVT, bool KT>
__device__ void finish(T k, const Handover<T>& h, double term1, double nf,
                       T* out) {
  const T inv_nf = T(1) / static_cast<T>(nf);
  const T current = (k * T(2)) * inv_nf;
  if (!NVT) {
    out[0] = T(1);
    out[1] = current;
    return;
  }
  const T den = current * static_cast<T>(nf);
  const T c2 = KT ? h.c / den : (T(1) / den) * h.c;
  const T term2 = c2 * h.a;
  const T term3 = h.b * sqrt_t(c2 * static_cast<T>(term1));
  const T scale = sqrt_t((term2 + static_cast<T>(term1)) + term3);
  out[0] = scale;
  out[1] = (((scale * scale) * T(2)) * k) * inv_nf;
}

// out = (scale, temperature). NVT: Bussi's factor and the temperature
// after it; NVE: (1, the temperature). SUM: the kinetic energy from the n
// values of v, summed by finish_blocks(n) blocks of kThreads (with NVT one
// more block, block 0, draws meanwhile: the summing block b is block
// b + 1); else from *kinetic (one block of kDrawThreads, which draws
// first). KT: NVT's target is ktemp[step - *base] (ktemp[0] without a base)
// and numer is 1 - term1; else numer is (1 - term1) times the target, a
// host number.
template <typename T, bool NVT, bool SUM, bool KT>
__global__ void __launch_bounds__(kThreads)
    velocity_finish_kernel(const T* __restrict__ v, int64_t n,
                           const T* kinetic, const int64_t* step_ptr,
                           int64_t step_value, const T* ktemp,
                           const int64_t* base, double numer, double term1,
                           double nf, uint2 key, T* out) {
  __shared__ double warp_sums[kThreads / 32];
  __shared__ double drawn[2];
  __shared__ bool last;
  const bool draws = NVT && blockIdx.x == 0;
  // Given K, the step and the draws come before the wait (the caller's
  // kernel just before must not write the step); summing, after it, beside
  // the sum.
  int64_t s = 0;
  if (!SUM && draws) {
    s = step_ptr ? *step_ptr : step_value;
    bussi_draws_two_warps(s, key, nf - 1.0, drawn);
  }
  wait_for_dependencies();
  if (!SUM) {
    if (NVT) __syncthreads();  // drawn
    if (threadIdx.x != 0) return;
    const T k = *kinetic;
    Handover<T> h{};
    if (NVT) h = handover<T, KT>(drawn, s, ktemp, base, numer);
    finish<T, NVT, KT>(k, h, term1, nf, out);
    return;
  }
  const int sum_blocks = finish_blocks(n);
  const int b = (int)blockIdx.x - (NVT ? 1 : 0);
  const bool sums = !draws && b < sum_blocks;
  Handover<T> h{};
  double acc = 0.0;
  if (draws) {
    if (threadIdx.x < kDrawThreads) {
      s = step_ptr ? *step_ptr : step_value;
      bussi_draws_two_warps(s, key, nf - 1.0, drawn);
    }
    __syncthreads();  // drawn
    if (threadIdx.x == 0) h = handover<T, KT>(drawn, s, ktemp, base, numer);
  } else if (sums) {
    // Thread t of summing block b adds v[b T + t + j G T] for j = 0, 1,
    // ... in order, kFinishBatch loads out before their adds (a value
    // past n adds 0).
    const int64_t stride = (int64_t)sum_blocks * blockDim.x;
    for (int64_t i0 = b * (int64_t)blockDim.x + threadIdx.x; i0 < n;
         i0 += kFinishBatch * stride) {
      double x[kFinishBatch];
#pragma unroll
      for (int j = 0; j < kFinishBatch; ++j) {
        const int64_t i = i0 + j * stride;
        x[j] = i < n ? static_cast<double>(v[i]) : 0.0;
      }
#pragma unroll
      for (int j = 0; j < kFinishBatch; ++j) acc = acc + x[j] * x[j];
    }
  }
  if (sums) acc = block_sum(acc, warp_sums);
  cuda::atomic_ref<unsigned, cuda::thread_scope_device> ticket(
      g_finish_ticket);
  if (threadIdx.x == 0) {
    if (draws)
      store_handover(h);
    else if (sums)
      g_finish_partial[b] = acc;
    // Release the partial (or the handover); acquire every other's.
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // One round trip: the partials, and in thread 0 the handover.
  acc = (int)threadIdx.x < sum_blocks
            ? __ldcg(g_finish_partial + threadIdx.x) : 0.0;
  double ha = 0.0, hb = 0.0, hc = 0.0;
  if (NVT && threadIdx.x == 0) {
    ha = __ldcg(g_finish_handover);
    hb = __ldcg(g_finish_handover + 1);
    hc = __ldcg(g_finish_handover + 2);
  }
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x != 0) return;
  ticket.store(0u, cuda::memory_order_relaxed);
  finish<T, NVT, KT>(static_cast<T>(0.5 * acc),
                     Handover<T>{static_cast<T>(ha), static_cast<T>(hb),
                                 static_cast<T>(hc)},
                     term1, nf, out);
}

__global__ void philox_words_kernel(const uint4* ctr, const uint2* key,
                                    uint4* out, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = philox4x32_10(ctr[i], key[i]);
}

// The empty kernel: nothing, or with the attribute only the wait a
// programmatic dependent makes before it may touch memory.
template <bool WAIT>
__global__ void empty_kernel() {
  if (WAIT) wait_for_dependencies();
}

// The loop test of a captured segment: whether the step counter is below
// the segment's end, into the flag byte and, inside a capture, the WHILE
// node's handle (one thread: two loads and a store).
__global__ void step_below_kernel(const int64_t* counter, const int64_t* end,
                                  bool* flag,
                                  cudaGraphConditionalHandle handle,
                                  int set_handle) {
  const bool below = *counter < *end;
  *flag = below;
  if (set_handle) cudaGraphSetConditional(handle, below ? 1u : 0u);
}

// A sharded segment's rebuild decision: any rank's drift flag (votes, the
// ring's all-reduced maximum of the ranks' flags; the same on every rank)
// or the segment's first step (the counter at first), into the flag byte
// and, inside a capture, the IF node's handle (one thread).
__global__ void rebuild_vote_kernel(const int* votes, const int64_t* counter,
                                    const int64_t* first, bool* flag,
                                    cudaGraphConditionalHandle handle,
                                    int set_handle) {
  const bool go = *votes != 0 || *counter == *first;
  *flag = go;
  if (set_handle) cudaGraphSetConditional(handle, go ? 1u : 0u);
}

int grid_for(int64_t items, int cap = kMaxBlocks) {
  const int64_t blocks = (items + kThreads - 1) / kThreads;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

// Launch options (the wrappers' flag): kProgrammatic launches the kernel
// as a programmatic dependent of the kernel before it on the stream (the
// wrappers always do; plain stream order is for measurements).
constexpr int kProgrammatic = 1;

// A launch on s with cudaLaunchAttributeProgrammaticStreamSerialization
// where programmatic (built in place: cfg points at attr).
struct LaunchConfig {
  cudaLaunchAttribute attr = {};
  cudaLaunchConfig_t cfg = {};
  LaunchConfig(dim3 grid, dim3 block, cudaStream_t s, bool programmatic) {
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = programmatic ? 1 : 0;
  }
  LaunchConfig(const LaunchConfig&) = delete;
};

// kernel(args...) by cudaLaunchKernelEx: the runtime's error where it
// refuses the launch or its attribute; nothing is retried without it.
template <typename... Params, typename... Args>
int launch_ex(void (*kernel)(Params...), dim3 grid, dim3 block,
              cudaStream_t s, bool programmatic, Args... args) {
  const LaunchConfig c(grid, block, s, programmatic);
  const cudaError_t rc = cudaLaunchKernelEx(&c.cfg, kernel, args...);
  return rc ? (int)rc : (int)cudaGetLastError();
}

template <typename T>
int bussi_draw(const int64_t* step, unsigned k0, unsigned k1, double dof,
               T* out, void* stream) {
  if (!step || !out) return kErrArgs;
  return launch_ex(bussi_draw_kernel<T>, dim3(1), dim3(kDrawThreads),
                   static_cast<cudaStream_t>(stream), true, step,
                   make_uint2(k0, k1), dof, out);
}

template <typename T>
int uniform_noise(const int64_t* step, long long step_value, unsigned k0,
                  unsigned k1, unsigned stream_word, long long n, T* out,
                  int options, void* stream) {
  const long long blocks = (n + Noise<T>::kPer - 1) / Noise<T>::kPer;
  if (!out || n < 0 || blocks > 0xFFFFFFFFLL ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return kErrArgs;
  if (n == 0) return 0;
  return launch_ex(uniform_noise_kernel<T>, dim3(grid_for(blocks)),
                   dim3(kThreads), static_cast<cudaStream_t>(stream),
                   (options & kProgrammatic) != 0, step, (int64_t)step_value,
                   make_uint2(k0, k1), stream_word, (int64_t)n, out);
}

template <typename T>
int rebuild_flag(const T* pos, const T* ref, int dim, long long n,
                 double thr, bool* flag, unsigned long long handle,
                 int set_handle, void* stream) {
  if (!pos || !ref || !flag || dim < 2 || dim > 3 || n < 0 ||
      reinterpret_cast<uintptr_t>(pos) % sizeof(T) ||
      reinterpret_cast<uintptr_t>(ref) % sizeof(T))
    return kErrArgs;
  const int grid = grid_for(n / Chunk<T>::kWidth, kTestMaxBlocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaGraphConditionalHandle h =
      static_cast<cudaGraphConditionalHandle>(handle);
  const T t = static_cast<T>(thr);
  if (dim == 2)
    rebuild_flag_kernel<T, 2><<<grid, kThreads, 0, s>>>(pos, ref, (int64_t)n,
                                                         t, flag, h,
                                                         set_handle);
  else
    rebuild_flag_kernel<T, 3><<<grid, kThreads, 0, s>>>(pos, ref, (int64_t)n,
                                                         t, flag, h,
                                                         set_handle);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool CELL>
int launch_rebuild_rows(cudaStream_t s, bool pdl, const T* pos, const T* ref,
                        const T* m, const T* mi, int64_t stride, int64_t n,
                        T thr, bool* flag, cudaGraphConditionalHandle h,
                        int set_handle) {
  return launch_ex(rebuild_rows_kernel<T, D, CELL>,
                   dim3(mdtpu::rows::rows_grid(n)),
                   dim3(mdtpu::rows::kRowsThreads), s, pdl, pos, ref, m, mi,
                   stride, n, thr, flag, h, set_handle);
}

// The drift test of particle rows, launched as a programmatic dependent
// of the kernel before it where options say so. Before
// griddepcontrol.wait it loads ref alone, which only a rebuild writes (an
// earlier step's IF node, never the kernel just before): the positions
// are the kick-drift-wrap's or FIRE's move's output, written just before
// the test, and the box may be too (a step with force_dtype casts the cell
// just before it), so both come after the wait.
template <typename T>
int rebuild_rows(const T* pos, const T* ref, const T* m, const T* mi,
                 long long len_stride, int dim, long long n, double thr,
                 bool* flag, unsigned long long handle, int set_handle,
                 int options, void* stream) {
  const bool cell = m != nullptr;
  if (!pos || !ref || !mi || !flag || dim < 2 || dim > 3 || n < 0 ||
      (!cell && len_stride < 1) ||
      reinterpret_cast<uintptr_t>(pos) % sizeof(T) ||
      reinterpret_cast<uintptr_t>(ref) % sizeof(T))
    return kErrArgs;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pdl = (options & kProgrammatic) != 0;
  const cudaGraphConditionalHandle h =
      static_cast<cudaGraphConditionalHandle>(handle);
  const T t = static_cast<T>(thr);
  const int64_t st = len_stride;
  if (dim == 2)
    return cell ? launch_rebuild_rows<T, 2, true>(s, pdl, pos, ref, m, mi, st,
                                                  n, t, flag, h, set_handle)
                : launch_rebuild_rows<T, 2, false>(s, pdl, pos, ref, m, mi,
                                                   st, n, t, flag, h,
                                                   set_handle);
  return cell ? launch_rebuild_rows<T, 3, true>(s, pdl, pos, ref, m, mi, st, n,
                                                t, flag, h, set_handle)
              : launch_rebuild_rows<T, 3, false>(s, pdl, pos, ref, m, mi, st,
                                                 n, t, flag, h, set_handle);
}

template <typename T, bool NVT, bool SUM>
int launch_finish(bool kt, dim3 grid, dim3 block, cudaStream_t s, bool pdl,
                  const T* v, int64_t n, const T* kinetic,
                  const int64_t* step, int64_t step_value, const T* ktemp,
                  const int64_t* base, double numer, double term1,
                  double nf, uint2 key, T* out) {
  if (kt)
    return launch_ex(velocity_finish_kernel<T, NVT, SUM, true>, grid, block,
                     s, pdl, v, n, kinetic, step, step_value, ktemp, base,
                     numer, term1, nf, key, out);
  return launch_ex(velocity_finish_kernel<T, NVT, SUM, false>, grid, block, s,
                   pdl, v, n, kinetic, step, step_value, ktemp, base, numer,
                   term1, nf, key, out);
}

template <typename T>
int velocity_finish(const T* v, long long n, const T* kinetic,
                    const int64_t* step, long long step_value,
                    const T* ktemp, const int64_t* base, double numer,
                    double term1, double nf, unsigned k0, unsigned k1,
                    int nvt, int options, T* out, void* stream) {
  const bool sum = v != nullptr;
  if (!out || n < 0 || (!sum && !kinetic) || !(nf > 0.0) ||
      (base && !ktemp))
    return kErrArgs;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pdl = options & kProgrammatic;
  const dim3 grid(sum ? finish_blocks(n) + (nvt ? 1 : 0) : 1);
  const dim3 block(sum ? kThreads : kDrawThreads);
  const uint2 key = make_uint2(k0, k1);
  const bool kt = ktemp != nullptr;
  if (nvt && sum)
    return launch_finish<T, true, true>(kt, grid, block, s, pdl, v, n,
                                        kinetic, step, step_value, ktemp,
                                        base, numer, term1, nf, key, out);
  if (nvt)
    return launch_finish<T, true, false>(kt, grid, block, s, pdl, v, n,
                                         kinetic, step, step_value, ktemp,
                                         base, numer, term1, nf, key, out);
  if (sum)
    return launch_finish<T, false, true>(false, grid, block, s, pdl, v, n,
                                         kinetic, step, step_value, ktemp,
                                         base, numer, term1, nf, key, out);
  return launch_finish<T, false, false>(false, grid, block, s, pdl, v, n,
                                        kinetic, step, step_value, ktemp,
                                        base, numer, term1, nf, key, out);
}

constexpr int kCensusSize = 15;

// Whether func is one of this file's velocity finish (noise) kernels.
template <typename T>
bool finish_kernel(const void* func) {
  const void* kernels[] = {
      (const void*)velocity_finish_kernel<T, true, true, true>,
      (const void*)velocity_finish_kernel<T, true, true, false>,
      (const void*)velocity_finish_kernel<T, true, false, true>,
      (const void*)velocity_finish_kernel<T, true, false, false>,
      (const void*)velocity_finish_kernel<T, false, true, false>,
      (const void*)velocity_finish_kernel<T, false, false, false>};
  for (const void* k : kernels)
    if (k == func) return true;
  return false;
}

template <typename T>
bool noise_kernel(const void* func) {
  return func == (const void*)uniform_noise_kernel<T>;
}

// Whether func is one of this file's particle-row drift tests.
template <typename T>
bool rows_kernel(const void* func) {
  const void* kernels[] = {(const void*)rebuild_rows_kernel<T, 2, true>,
                           (const void*)rebuild_rows_kernel<T, 2, false>,
                           (const void*)rebuild_rows_kernel<T, 3, true>,
                           (const void*)rebuild_rows_kernel<T, 3, false>};
  for (const void* k : kernels)
    if (k == func) return true;
  return false;
}

// The graph being captured on s and its current dependencies; 0, a CUDA
// error, or kErrNotCapturing.
int capturing_graph(cudaStream_t s, cudaGraph_t* graph,
                    const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
  const cudaError_t rc =
      cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, n_deps);
  if (rc) return (int)rc;
  return status == cudaStreamCaptureStatusActive ? 0 : kErrNotCapturing;
}

// Adds a conditional node of type over the capture's current dependencies,
// makes it the capture's only dependency and starts body_stream capturing
// into its body graph.
int conditional_begin(cudaStream_t s, unsigned long long handle,
                      cudaStream_t body_stream,
                      cudaGraphConditionalNodeType type) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  const int err = capturing_graph(s, &graph, &deps, &n_deps);
  if (err) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = static_cast<cudaGraphConditionalHandle>(handle);
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  cudaError_t rc = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (rc) return (int)rc;
  rc = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                           cudaStreamSetCaptureDependencies);
  if (rc) return (int)rc;
  return (int)cudaStreamBeginCaptureToGraph(
      body_stream, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeRelaxed);
}

}  // namespace

extern "C" {

// step: one int64 on the device; k0, k1: the seed's low and high words;
// dof = nf - 1; out: (2,) on the device, r1 then r2. Launched as a
// programmatic dependent of the kernel before it (it reads the step after
// the wait).
int mdtpu_bussi_draw_f32(const int64_t* step, unsigned k0, unsigned k1,
                         double dof, float* out, void* stream) {
  return bussi_draw<float>(step, k0, k1, dof, out, stream);
}

int mdtpu_bussi_draw_f64(const int64_t* step, unsigned k0, unsigned k1,
                         double dof, double* out, void* stream) {
  return bussi_draw<double>(step, k0, k1, dof, out, stream);
}

// step: one int64 on the device, or null and step_value; out: n values on
// the device, 16-byte aligned; stream_word: 1 | rank << 8; options:
// kProgrammatic or 0.
int mdtpu_uniform_noise_f32(const int64_t* step, long long step_value,
                            unsigned k0, unsigned k1, unsigned stream_word,
                            long long n, float* out, int options,
                            void* stream) {
  return uniform_noise<float>(step, step_value, k0, k1, stream_word, n, out,
                              options, stream);
}

int mdtpu_uniform_noise_f64(const int64_t* step, long long step_value,
                            unsigned k0, unsigned k1, unsigned stream_word,
                            long long n, double* out, int options,
                            void* stream) {
  return uniform_noise<double>(step, step_value, k0, k1, stream_word, n, out,
                               options, stream);
}

// pos, ref: (dim, n) row-major on the device, dim 2 or 3; flag: one bool on the
// device, written by every launch; handle: an IF node's (set_handle 1),
// set from the same test, inside the graph that holds the node.
int mdtpu_rebuild_flag_f32(const float* pos, const float* ref, int dim,
                           long long n, double thr, bool* flag,
                           unsigned long long handle, int set_handle,
                           void* stream) {
  return rebuild_flag<float>(pos, ref, dim, n, thr, flag, handle, set_handle,
                             stream);
}

int mdtpu_rebuild_flag_f64(const double* pos, const double* ref, int dim,
                           long long n, double thr, bool* flag,
                           unsigned long long handle, int set_handle,
                           void* stream) {
  return rebuild_flag<double>(pos, ref, dim, n, thr, flag, handle,
                              set_handle, stream);
}

// pos, ref: (n, dim) row-major on the device, dim 2 or 3, each at any
// address of its dtype; m:
// the (dim, dim) cell and mi its inverse, row-major (the minimum image by
// the cell), or m null and mi the box lengths, length k at mi[k *
// len_stride]; flag, handle and set_handle as mdtpu_rebuild_flag_f32's;
// options: kProgrammatic or 0. The kernel just before must not write ref.
int mdtpu_rebuild_rows_f32(const float* pos, const float* ref, const float* m,
                           const float* mi, long long len_stride, int dim,
                           long long n, double thr, bool* flag,
                           unsigned long long handle, int set_handle,
                           int options, void* stream) {
  return rebuild_rows<float>(pos, ref, m, mi, len_stride, dim, n, thr, flag,
                             handle, set_handle, options, stream);
}

int mdtpu_rebuild_rows_f64(const double* pos, const double* ref,
                           const double* m, const double* mi,
                           long long len_stride, int dim, long long n,
                           double thr, bool* flag, unsigned long long handle,
                           int set_handle, int options, void* stream) {
  return rebuild_rows<double>(pos, ref, m, mi, len_stride, dim, n, thr, flag,
                              handle, set_handle, options, stream);
}

// The grid of the particle-order kernels over n particle rows
// (particle_rows.cuh, shared by this library's drift test and the Verlet
// library's Brownian move): out[0] its blocks, out[1] the threads of a
// block, out[2] the most blocks, out[3] the fewest particles whose dim
// values of itemsize bytes (4 or 8) fill whole Philox blocks. Returns 0;
// -1 for another itemsize or dim.
long long mdtpu_rows_grid(long long n, int dim, int itemsize,
                          long long* out) {
  if ((itemsize != 4 && itemsize != 8) || (dim != 2 && dim != 3) || n < 0)
    return -1;
  using mdtpu::rows::philox_period;
  out[0] = mdtpu::rows::rows_grid(n);
  out[1] = mdtpu::rows::kRowsThreads;
  out[2] = mdtpu::rows::kRowsMaxBlocks;
  out[3] = itemsize == 4 ? (dim == 2 ? philox_period<float, 2>()
                                     : philox_period<float, 3>())
                         : (dim == 2 ? philox_period<double, 2>()
                                     : philox_period<double, 3>());
  return 0;
}

// v: n velocities on the device (the kinetic sum in the kernel), or null
// and kinetic one value on the device; step: one int64 on the device, or
// null and step_value; ktemp: NVT's target table on the device, read at
// step - *base (base null: ktemp[0]), or null and numer = (1 - term1) *
// the target (else numer = 1 - term1); term1 = exp(-dt / tau); nvt 0: the
// temperature alone; options: kProgrammatic or 0. out: (2,) on the
// device, scale then temperature.
int mdtpu_velocity_finish_f32(const float* v, long long n,
                              const float* kinetic, const int64_t* step,
                              long long step_value, const float* ktemp,
                              const int64_t* base, double numer,
                              double term1, double nf, unsigned k0,
                              unsigned k1, int nvt, int options, float* out,
                              void* stream) {
  return velocity_finish<float>(v, n, kinetic, step, step_value, ktemp, base,
                                numer, term1, nf, k0, k1, nvt, options, out,
                                stream);
}

int mdtpu_velocity_finish_f64(const double* v, long long n,
                              const double* kinetic, const int64_t* step,
                              long long step_value, const double* ktemp,
                              const int64_t* base, double numer,
                              double term1, double nf, unsigned k0,
                              unsigned k1, int nvt, int options, double* out,
                              void* stream) {
  return velocity_finish<double>(v, n, kinetic, step, step_value, ktemp,
                                 base, numer, term1, nf, k0, k1, nvt, options,
                                 out, stream);
}

// The generator's own words, for its known-answer checks: ctr (n, 4) and
// key (n, 2) 32-bit words on the device; out (n, 4).
int mdtpu_philox_words(const void* ctr, const void* key, void* out,
                       long long n, void* stream) {
  if (!ctr || !key || !out || n < 0) return kErrArgs;
  if (n == 0) return 0;
  philox_words_kernel<<<grid_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(ctr), static_cast<const uint2*>(key),
      static_cast<uint4*>(out), (int64_t)n);
  return (int)cudaGetLastError();
}

// A kernel that does nothing (one block of one warp): the launch floor.
// options kProgrammatic: launched as a programmatic dependent, it waits for
// the kernel before it and does nothing else.
int mdtpu_empty(int options, void* stream) {
  const bool pdl = options & kProgrammatic;
  const LaunchConfig c(dim3(1), dim3(32), static_cast<cudaStream_t>(stream),
                       pdl);
  const cudaError_t rc = cudaLaunchKernelExC(
      &c.cfg,
      pdl ? (const void*)empty_kernel<true> : (const void*)empty_kernel<false>,
      nullptr);
  return rc ? (int)rc : (int)cudaGetLastError();
}

// stream: capturing. A conditional handle of the graph being captured,
// for the kernel captured next that sets it and the IF node
// mdtpu_graph_if_begin adds.
int mdtpu_graph_if_handle(void* stream, unsigned long long* handle) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  const int err = capturing_graph(static_cast<cudaStream_t>(stream), &graph,
                                  &deps, &n_deps);
  if (err) return err;
  cudaGraphConditionalHandle h;
  const cudaError_t rc = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  if (rc) return (int)rc;
  *handle = static_cast<unsigned long long>(h);
  return 0;
}

// stream: capturing; handle: from mdtpu_graph_if_handle; body_stream:
// idle. On success body_stream captures into the IF node's body until
// mdtpu_graph_if_end.
int mdtpu_graph_if_begin(void* stream, unsigned long long handle,
                         void* body_stream) {
  return conditional_begin(static_cast<cudaStream_t>(stream), handle,
                           static_cast<cudaStream_t>(body_stream),
                           cudaGraphCondTypeIf);
}

int mdtpu_graph_if_end(void* body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream),
                                   &body);
}

// The same for a WHILE node: handle from mdtpu_graph_if_handle, set by a
// kernel captured before the node (the first entry) and by the body's last
// kernel (each further pass). Inside the body, a nested IF node takes a
// handle of the body's own graph (mdtpu_graph_if_handle on body_stream).
int mdtpu_graph_while_begin(void* stream, unsigned long long handle,
                            void* body_stream) {
  return conditional_begin(static_cast<cudaStream_t>(stream), handle,
                           static_cast<cudaStream_t>(body_stream),
                           cudaGraphCondTypeWhile);
}

int mdtpu_graph_while_end(void* body_stream) {
  return mdtpu_graph_if_end(body_stream);
}

// counter, end: one int64 each on the device; flag: one bool on the device
// (*counter < *end), and the handle set from it where set_handle is 1.
int mdtpu_step_below(const int64_t* counter, const int64_t* end, bool* flag,
                     unsigned long long handle, int set_handle,
                     void* stream) {
  if (!counter || !end || !flag) return kErrArgs;
  step_below_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      counter, end, flag, static_cast<cudaGraphConditionalHandle>(handle),
      set_handle);
  return (int)cudaGetLastError();
}

// votes: one int on the device (the ring's maximum of the ranks' drift
// flags); counter, first: one int64 each; flag: one bool, set where votes
// is not 0 or counter equals first, and the handle from it where
// set_handle is 1.
int mdtpu_rebuild_vote(const int* votes, const int64_t* counter,
                       const int64_t* first, bool* flag,
                       unsigned long long handle, int set_handle,
                       void* stream) {
  if (!votes || !counter || !first || !flag) return kErrArgs;
  rebuild_vote_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      votes, counter, first, flag,
      static_cast<cudaGraphConditionalHandle>(handle), set_handle);
  return (int)cudaGetLastError();
}

// stream: capturing. out[kCensusSize]: the top-level nodes of the graph
// being captured: all, kernels, copies, memsets, conditionals, others; of
// the conditional nodes' dependencies, how many there are and how many are
// kernel nodes that depend on nothing; the nodes whose type could not be
// read; the error code of the Graphviz dump; the programmatic edges, and
// how many of them enter this file's velocity finish and its noise; the
// error code of the edges' read (where not 0 the edge counts are -1); the
// programmatic edges into its particle-row drift test.
// Types come from the driver (this library's runtime does not name a
// conditional node's type), edges and their data from the runtime
// (cudaGraphGetEdges_v2: the first version refuses a graph whose edges
// carry data, as programmatic ones do), a kernel node's function from the
// runtime (it resolves this library's kernels). dot_path: where not null,
// the graph with its conditional bodies in Graphviz form, kernel names
// included (cudaGraphDebugDotPrint: the driver names every kernel, this
// library's and others'). A node, an edge or a dump it cannot read is
// counted, never an error.
int mdtpu_capture_census(void* stream, const char* dot_path, long long* out) {
  typedef CUresult (*TypeFn)(CUgraphNode, CUgraphNodeType*);
  void* type_fn = nullptr;
  cudaError_t rc = cudaGetDriverEntryPoint("cuGraphNodeGetType", &type_fn,
                                           cudaEnableDefault);
  if (rc) return (int)rc;
  if (!type_fn) return kErrArgs;
  const TypeFn node_type = reinterpret_cast<TypeFn>(type_fn);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  const int err = capturing_graph(static_cast<cudaStream_t>(stream), &graph,
                                  &deps, &n_deps);
  if (err) return err;
  size_t n = 0;
  rc = cudaGraphGetNodes(graph, nullptr, &n);
  if (rc) return (int)rc;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n) {
    rc = cudaGraphGetNodes(graph, nodes.data(), &n);
    if (rc) return (int)rc;
  }
  for (int i = 0; i < kCensusSize; ++i) out[i] = 0;
  out[0] = (long long)n;
  std::vector<int> kind(n, -1);
  for (size_t i = 0; i < n; ++i) {
    CUgraphNodeType type;
    if (node_type(nodes[i], &type) != CUDA_SUCCESS) {
      ++out[8];
      continue;
    }
    kind[i] = (int)type;
    switch (type) {
      case CU_GRAPH_NODE_TYPE_KERNEL: ++out[1]; break;
      case CU_GRAPH_NODE_TYPE_MEMCPY: ++out[2]; break;
      case CU_GRAPH_NODE_TYPE_MEMSET: ++out[3]; break;
      case CU_GRAPH_NODE_TYPE_CONDITIONAL: ++out[4]; break;
      default: ++out[5]; break;
    }
  }
  size_t ne = 0;
  std::vector<cudaGraphNode_t> from, to;
  std::vector<cudaGraphEdgeData> data;
  rc = cudaGraphGetEdges_v2(graph, nullptr, nullptr, nullptr, &ne);
  if (!rc && ne) {
    from.resize(ne);
    to.resize(ne);
    data.resize(ne);
    rc = cudaGraphGetEdges_v2(graph, from.data(), to.data(), data.data(),
                              &ne);
  }
  if (rc) {
    cudaGetLastError();
    out[6] = out[7] = out[10] = out[11] = out[12] = out[14] = -1;
    out[13] = (long long)rc;
  } else {
    auto index = [&](cudaGraphNode_t x) {
      for (size_t i = 0; i < n; ++i)
        if (nodes[i] == x) return (long long)i;
      return -1LL;
    };
    for (size_t e = 0; e < ne; ++e) {
      const long long t = index(to[e]), f = index(from[e]);
      if (data[e].type == cudaGraphDependencyTypeProgrammatic) {
        ++out[10];
        cudaKernelNodeParams p;
        if (cudaGraphKernelNodeGetParams(to[e], &p) != cudaSuccess) {
          cudaGetLastError();
        } else if (finish_kernel<float>(p.func) ||
                   finish_kernel<double>(p.func)) {
          ++out[11];
        } else if (noise_kernel<float>(p.func) ||
                   noise_kernel<double>(p.func)) {
          ++out[12];
        } else if (rows_kernel<float>(p.func) ||
                   rows_kernel<double>(p.func)) {
          ++out[14];
        }
      }
      if (t < 0 || kind[t] != CU_GRAPH_NODE_TYPE_CONDITIONAL) continue;
      ++out[6];
      if (f < 0 || kind[f] != CU_GRAPH_NODE_TYPE_KERNEL) continue;
      bool root = true;
      for (size_t e2 = 0; e2 < ne; ++e2) root = root && to[e2] != from[e];
      if (root) ++out[7];
    }
  }
  if (dot_path) {
    out[9] = cudaGraphDebugDotPrint(graph, dot_path,
                                    cudaGraphDebugDotFlagsKernelNodeParams);
    if (out[9]) cudaGetLastError();
  }
  return 0;
}

const char* mdtpu_philox_draws_error_string(int code) {
  switch (code) {
    case kErrArgs: return "arguments outside what the kernel takes";
    case kErrNotCapturing: return "the stream is not capturing a graph";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
