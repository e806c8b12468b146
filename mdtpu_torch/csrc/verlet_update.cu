// The slot step's velocity-Verlet chain as one kernel for NVIDIA Hopper
// (sm_90a), launched three ways a step.
//
// It replaces no Pallas kernel. The JAX package's slot step
// (mdtpu/integrate/slot_step.py:579-605 make_slot_step, with
// md_velocity_finish at mdtpu/integrate/step.py:78-100) is one device
// program: XLA fuses the half-kicks, the drift, the step counter and the
// thermostat's rescale into the segment's while_loop. The port's step ran
// them as torch operations: three Kahan adds of four kernels each, the
// products f * dt/2 (twice) and v * dt, step + 1, v * scale and a zeroed
// compensation, each a node of the captured step, and seven copies of the
// results into the advance's buffers (PERF.md section 5). Here each part of
// the chain is one launch that reads the buffers and writes them in place
// (or into new tensors, for a caller that keeps its inputs):
//
//   * kick-drift, before the sweep:
//       v, vc <- kahan(v, vc, f * (dt/2));  x, xc <- kahan(x, xc, v * dt)
//     and, for the hi/lo sweep, lo = -xc (the positions' low word);
//   * kick, after the sweep: v, vc <- kahan(v, vc, f * (dt/2));
//   * rescale, after the velocity finish (NVT): v <- v * scale, scale read
//     from the finish's output on the device, and vc <- 0.
// The step counter, where given, is advanced by the chain's last launch
// (rescale in NVT, kick in NVE): the velocity finish between them reads the
// step's own counter for its draws and its target.
//
// Bits. Each value is computed as the torch composition computes it
// (mdtpu_torch/utils/math.py kahan_add; integrate/slot_step.py): the
// scalars dt/2 and dt rounded once to the state's dtype (a Python number
// times a float32 tensor), f * (dt/2) rounded before it enters the Kahan
// add, y = dx - c, t = x + y, c' = (t - x) - y in that order, and
// -fmad=false keeps every product and sum a rounding of its own. So the
// kernel gives the composition's bits, on the card as on the CPU.
//
// What bounds it on the H100: bytes. Each value of the (d, S) rows is read
// and written once (kick-drift reads f, v, vc, x, xc and writes v, vc, x,
// xc: 9 arrays; kick 3 + 2; rescale 1 + 2); at the bench's (3, 124,875)
// float32 slots that is 13.5 MB, 7.5 MB and 4.5 MB, 4.0, 2.2 and 1.3 us at
// 3.35 TB/s. The update is elementwise over the d * S values of the
// component-major rows, so the dimension enters through the count alone.
// Each thread moves 16 bytes of each array a load (float4, double2) where
// every pointer is 16-byte aligned (the advance's buffers are), else one
// value; no value is read twice and nothing is staged.
//
// Beside it, the Brownian slot step's update as one kernel,
// brownian_update_kernel. It replaces no Pallas kernel either: the JAX
// package's Brownian slot step (mdtpu/integrate/slot_step.py:557-577, with
// brownian_noise and brownian_virial_sample at mdtpu/integrate/step.py:110
// and :122) draws the noise, masks it to the occupied slots, moves the
// positions by dx = F dt/kT + xi sqrt(2 dt) through the Kahan add, samples
// the virial every 10 steps and advances the step, all fused by XLA into
// the segment's loop. The port's step ran the noise kernel and about ten
// torch operations, then copied nine results into the advance's buffers
// (33 nodes a captured step, PERF.md section 5). Here, in one launch:
//
//   * per value e of the (d, S) rows, slot s = e mod S: xi, the Philox-4x32
//     -10 draw the noise kernel gives element e (philox_draws.cu
//     uniform_noise_kernel; block e / 4 at float32, e / 2 at float64, the
//     values by philox.cuh noise_values), 0 where slot s is vacant; then
//     x, xc <- kahan(x, xc, f * drift + xi * sigma) (a plain add where not
//     compensated). drift = dt/kT and sigma = sqrt(2 dt) come rounded to
//     the state's dtype as the torch composition rounds them
//     (integrate/slot_step.py), and -fmad=false keeps every product and
//     sum a rounding of its own: the composition's bits.
//   * once a step, the scalar tail: virial_accum += virial where step % 10
//     == 0, nprom += that, the temperature buffer <- kT, step <- step + 1.
//     Every thread draws with the step, so only the block that draws the
//     last ticket writes it (after every block has read it; the ticket is
//     put back to 0, one per card: two updates must not run at once on two
//     streams).
//
// Each thread takes one Philox block: 16 bytes of every row (a float4 or a
// double2), so its draws, loads and stores line up. It launches as a
// programmatic dependent of the kernel before it (the pair sweep, which
// writes the forces and the virial and reads the positions): the step, the
// draws, the occupancy and the positions are read before
// griddepcontrol.wait, the forces and the virial after it, and every store
// comes after it. Bound: bytes, f, x, xc read and x, xc written (5 rows of
// d * S values) and the occupancy: 16.1 MB at the Brownian slot path's
// (3, 263,424) float32 slots, 4.8 us at 3.35 TB/s.
//
// The particle-order step (integrate/step.py make_md_step and
// make_brownian_step on (N, d) rows: PlaneEngine, the neighbour list, the
// naive engine and any run with compensated=False) takes two more kernels.
// They replace no Pallas kernel: the JAX package's particle-order step
// (mdtpu/integrate/step.py:160-169 make_md_step, :233-242
// make_brownian_step) runs inside the segment's fori_loop, where XLA fuses
// the half-kick, the drift and the periodic wrap (core/box.py:63-83), and
// the Brownian noise and move, into the step. The port ran them as about
// 36 torch launches a step (the wrap's _mm products, floor, the Kahan add,
// the images' cast and add). Here:
//
//   * kick_drift_wrap_kernel: a thread a particle, since the wrap needs
//     its d components: the half-kick and the drift (Kahan adds, or plain
//     adds where not compensated), then wrap_positions_compensated
//     (frac_k = sum_j x_j cell_inv[k][j] in j order, each product rounded,
//     n = floor(frac), x, xc <- kahan(x, xc, -(sum_j n_j cell[k][j])),
//     images += n) or wrap_positions (x_k = sum_j (frac_j - n_j)
//     cell[k][j]), and for the hi/lo sweep lo = -xc after the wrap. Any
//     cell, tilted included, read from the device. The kick after the
//     sweep and NVT's rescale are the slot chain's kick and rescale, which
//     take any contiguous shape.
//   * brownian_rows_kernel: the Brownian move, its noise drawn inside
//     with the bits of uniform_noise_kernel for element e = i d + k of the
//     row-major (N, d) array, dx = f drift + xi sigma through the Kahan
//     add, the wrap as above, and the step's scalars written by the last
//     block, as brownian_update_kernel writes them. A particle a thread on
//     a grid fixed by the count (particle_rows.cuh); a block's tile of 256
//     particles is whole Philox blocks, each drawn once into shared
//     memory; it launches as a programmatic dependent of the pair sweep: the step,
//     the cell, x, xc and the images are loaded and the noise drawn before
//     griddepcontrol.wait, the forces after it; a warp more a block takes
//     the ticket and writes the step's scalars off the particles' path.
// Each rounds every operation as the torch composition does (-fmad=false),
// so each gives its bits. Bound: bytes, each array read and written once:
// kick_drift_wrap reads f, v, vc, x, xc and images and writes v, vc, x, xc
// and images (10.2 MB at the bench's 65,536 float32 particles, 3.0 us at
// 3.35 TB/s; with lo 11.0 MB, 3.3 us); brownian_rows reads f, x, xc and
// images and writes x, xc and images (7.1 MB, 2.1 us). kick_drift_wrap
// launches in plain stream order, a thread a particle (a warp's loads of
// an array cover one contiguous run). It does not trigger its dependents
// early (griddepcontrol.launch_dependents after its loads, so that the
// drift test after it would start sooner): measured, the captured steps
// got no faster (PERF.md §6).
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <vector>

#include "particle_rows.cuh"
#include "periodic_wrap.cuh"
#include "philox.cuh"

namespace {

constexpr int kErrArgs = -1;
constexpr int kErrNotCapturing = -2;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;
constexpr int kProgrammatic = 1;  // the options word's flag (philox_draws)

enum Variant { kKickDrift = 0, kKick = 1, kRescale = 2 };

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};

// W values of p from value i * W: one 16-byte load, or one value.
template <typename T, int W>
__device__ __forceinline__ void load(const T* p, int64_t i, T (&r)[W]) {
  if constexpr (W == 1) {
    r[0] = p[i];
  } else {
    const typename Vec<T>::type x =
        reinterpret_cast<const typename Vec<T>::type*>(p)[i];
    memcpy(r, &x, sizeof(x));
  }
}

template <typename T, int W>
__device__ __forceinline__ void store(T* p, int64_t i, const T (&r)[W]) {
  if constexpr (W == 1) {
    p[i] = r[0];
  } else {
    typename Vec<T>::type x;
    memcpy(&x, r, sizeof(x));
    reinterpret_cast<typename Vec<T>::type*>(p)[i] = x;
  }
}

using mdtpu::box::kahan;
using mdtpu::box::load_cell;
using mdtpu::box::wrap;

template <typename T>
struct Args {
  const T* f;
  const T* v;
  const T* vc;
  const T* x;
  const T* xc;
  const T* scale;
  T* v_out;
  T* vc_out;
  T* x_out;
  T* xc_out;
  T* lo_out;
  const int64_t* step_in;
  int64_t* step_out;
};

// The chain's part VARIANT on W values from value i * W. COMP: compensated
// (the Kahan adds; rescale zeroes vc); else plain adds and vc is left
// alone. LO: kick-drift also writes -xc.
template <typename T, int VARIANT, bool COMP, bool LO, int W>
__device__ __forceinline__ void update(const Args<T>& a, int64_t i, T half,
                                       T dt) {
  T v[W], vc[W];
  load<T, W>(a.v, i, v);
  if (VARIANT == kRescale) {
    const T s = *a.scale;
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = v[k] * s;
    store<T, W>(a.v_out, i, v);
    if (COMP) {
#pragma unroll
      for (int k = 0; k < W; ++k) vc[k] = T(0);
      store<T, W>(a.vc_out, i, vc);
    }
    return;
  }
  T f[W];
  load<T, W>(a.f, i, f);
  if (COMP) load<T, W>(a.vc, i, vc);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const T dv = f[k] * half;
    if (COMP)
      kahan(v[k], vc[k], dv);
    else
      v[k] = v[k] + dv;
  }
  store<T, W>(a.v_out, i, v);
  if (COMP) store<T, W>(a.vc_out, i, vc);
  if (VARIANT != kKickDrift) return;
  T x[W], xc[W];
  load<T, W>(a.x, i, x);
  if (COMP) load<T, W>(a.xc, i, xc);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const T dx = v[k] * dt;
    if (COMP)
      kahan(x[k], xc[k], dx);
    else
      x[k] = x[k] + dx;
  }
  store<T, W>(a.x_out, i, x);
  if (COMP) store<T, W>(a.xc_out, i, xc);
  if (LO) {
#pragma unroll
    for (int k = 0; k < W; ++k) xc[k] = -xc[k];
    store<T, W>(a.lo_out, i, xc);
  }
}

// n values; VEC: 16 bytes a load over the first n / W groups, then the
// n % W values left one each (every pointer 16-byte aligned). Thread 0
// advances the step counter where one is given: each thread reads and
// writes only its own values, so the arrays may be the outputs too.
template <typename T, int VARIANT, bool COMP, bool LO, bool VEC>
__global__ void __launch_bounds__(kThreads)
    verlet_update_kernel(Args<T> a, int64_t n, T half, T dt) {
  constexpr int W = VEC ? int(16 / sizeof(T)) : 1;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t groups = n / W;
  for (int64_t i = tid; i < groups; i += stride)
    update<T, VARIANT, COMP, LO, W>(a, i, half, dt);
  if (VEC)
    for (int64_t i = groups * W + tid; i < n; i += stride)
      update<T, VARIANT, COMP, LO, 1>(a, i, half, dt);
  if (tid == 0 && a.step_out) *a.step_out = *a.step_in + 1;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int VARIANT, bool COMP, bool LO>
int launch(const Args<T>& a, int64_t n, T half, T dt, cudaStream_t s) {
  const void* ptrs[] = {a.f,     a.v,      a.vc,    a.x,     a.xc,
                        a.v_out, a.vc_out, a.x_out, a.xc_out, a.lo_out};
  bool vec = true;
  for (const void* p : ptrs) vec = vec && (!p || aligned(p));
  const int64_t w = vec ? 16 / (int64_t)sizeof(T) : 1;
  int64_t blocks = (n / w + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  if (vec)
    verlet_update_kernel<T, VARIANT, COMP, LO, true>
        <<<(int)blocks, kThreads, 0, s>>>(a, n, half, dt);
  else
    verlet_update_kernel<T, VARIANT, COMP, LO, false>
        <<<(int)blocks, kThreads, 0, s>>>(a, n, half, dt);
  return (int)cudaGetLastError();
}

template <typename T>
int verlet_update(int variant, int compensated, long long n, const T* f,
                  const T* v, const T* vc, const T* x, const T* xc,
                  const T* scale, T* v_out, T* vc_out, T* x_out, T* xc_out,
                  T* lo_out, const int64_t* step_in, int64_t* step_out,
                  double half, double dt, void* stream) {
  const bool comp = compensated != 0;
  const Args<T> a{f,     v,      vc,    x,      xc,      scale,  v_out,
                  vc_out, x_out, xc_out, lo_out, step_in, step_out};
  const bool ok =
      n >= 0 && v && v_out && (!comp || (vc && vc_out)) &&
      (!step_out == !step_in) &&
      (!lo_out || (comp && variant == kKickDrift)) &&
      (variant != kRescale || scale) && (variant == kRescale || f) &&
      (variant != kKickDrift || (x && x_out && (!comp || (xc && xc_out))));
  if (!ok || variant < kKickDrift || variant > kRescale) return kErrArgs;
  // The scalars rounded to T once, as torch rounds a Python number.
  const T h = static_cast<T>(half), d = static_cast<T>(dt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kKickDrift:
      if (!comp) return launch<T, kKickDrift, false, false>(a, n, h, d, s);
      return lo_out ? launch<T, kKickDrift, true, true>(a, n, h, d, s)
                    : launch<T, kKickDrift, true, false>(a, n, h, d, s);
    case kKick:
      return comp ? launch<T, kKick, true, false>(a, n, h, d, s)
                  : launch<T, kKick, false, false>(a, n, h, d, s);
    default:
      return comp ? launch<T, kRescale, true, false>(a, n, h, d, s)
                  : launch<T, kRescale, false, false>(a, n, h, d, s);
  }
}

// ------------------------------------------------------ Brownian update

template <typename T>
struct BrownianArgs {
  const T* f;
  const T* x;
  const T* xc;
  const bool* occupied;
  const T* virial;
  const T* accum;
  const int64_t* nprom;
  T* x_out;
  T* xc_out;
  T* accum_out;
  int64_t* nprom_out;
  T* temperature;
  const int64_t* step_in;  // or null: step_value
  int64_t* step_out;       // or null
  int64_t step_value;
};

// Blocks of the Brownian update done with the step, on this card (0
// between launches).
__device__ unsigned int g_brownian_ticket = 0;

// Waits until the grid this one depends on programmatically has ended and
// its writes are visible (at once for a plain launch).
__device__ __forceinline__ void wait_for_dependencies() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// P values of p from value e0: one 16-byte load where VEC and the group is
// whole, else one value each (those past n left alone).
template <typename T, int P, bool VEC>
__device__ __forceinline__ void load_group(const T* p, int64_t g, int64_t e0,
                                           int64_t n, T (&r)[P]) {
  if (VEC && e0 + P <= n) {
    load<T, P>(p, g, r);
    return;
  }
#pragma unroll
  for (int k = 0; k < P; ++k) r[k] = e0 + k < n ? p[e0 + k] : T(0);
}

template <typename T, int P, bool VEC>
__device__ __forceinline__ void store_group(T* p, int64_t g, int64_t e0,
                                            int64_t n, const T (&r)[P]) {
  if (VEC && e0 + P <= n) {
    store<T, P>(p, g, r);
    return;
  }
#pragma unroll
  for (int k = 0; k < P; ++k)
    if (e0 + k < n) p[e0 + k] = r[k];
}

// n = d * S values, S slots; thread group g (grid-stride) takes values
// [P g, P g + P), Philox block g. VEC: every row pointer 16-byte aligned.
template <typename T, bool COMP, bool VEC>
__global__ void __launch_bounds__(kThreads)
    brownian_update_kernel(BrownianArgs<T> a, int64_t n, int64_t slots,
                           T drift, T sigma, T ktemp, uint2 key,
                           uint32_t stream) {
  constexpr int P = int(16 / sizeof(T));  // values of one Philox block
  const int64_t groups = (n + P - 1) / P;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t s = a.step_in ? *a.step_in : a.step_value;
  bool waited = false;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int64_t e0 = g * P;
    T xi[P], x[P], xc[P], f[P];
    mdtpu::philox::noise_values(
        mdtpu::philox::philox4x32_10(
            mdtpu::philox::counter((uint32_t)g, s, stream), key),
        xi);
    int64_t slot = e0 % slots;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (!a.occupied[slot]) xi[k] = T(0);
      slot = slot + 1 == slots ? 0 : slot + 1;
    }
    load_group<T, P, VEC>(a.x, g, e0, n, x);
    if (COMP) load_group<T, P, VEC>(a.xc, g, e0, n, xc);
    if (!waited) {
      wait_for_dependencies();
      waited = true;
    }
    load_group<T, P, VEC>(a.f, g, e0, n, f);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const T dx = f[k] * drift + xi[k] * sigma;
      if (COMP)
        kahan(x[k], xc[k], dx);
      else
        x[k] = x[k] + dx;
    }
    store_group<T, P, VEC>(a.x_out, g, e0, n, x);
    if (COMP) store_group<T, P, VEC>(a.xc_out, g, e0, n, xc);
  }
  if (!waited) wait_for_dependencies();
  // Every thread of the block has read the step; the last block to say so
  // writes the step's scalars.
  __syncthreads();
  if (threadIdx.x != 0) return;
  cuda::atomic_ref<unsigned, cuda::thread_scope_device> ticket(
      g_brownian_ticket);
  if (ticket.fetch_add(1u, cuda::memory_order_acq_rel) != gridDim.x - 1)
    return;
  // brownian_virial_sample: accum + where(take, virial, 0), nprom + take.
  const bool take = s % 10 == 0;
  *a.accum_out = *a.accum + (take ? *a.virial : T(0));
  *a.nprom_out = *a.nprom + (take ? 1 : 0);
  *a.temperature = ktemp;
  if (a.step_out) *a.step_out = s + 1;
  ticket.store(0u, cuda::memory_order_relaxed);
}

// kernel(args...) by cudaLaunchKernelEx, as a programmatic dependent of
// the kernel before it on s where programmatic.
template <typename... Params, typename... Args>
int launch_ex(void (*kernel)(Params...), dim3 grid, dim3 block,
              cudaStream_t s, bool programmatic, Args... args) {
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = programmatic ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, args...);
  return rc ? (int)rc : (int)cudaGetLastError();
}

template <typename T, bool COMP>
int launch_brownian(const BrownianArgs<T>& a, int64_t n, int64_t slots,
                    T drift, T sigma, T ktemp, uint2 key, uint32_t stream_word,
                    bool pdl, cudaStream_t s) {
  const void* ptrs[] = {a.f, a.x, a.xc, a.x_out, a.xc_out};
  bool vec = true;
  for (const void* p : ptrs) vec = vec && (!p || aligned(p));
  constexpr int64_t P = 16 / sizeof(T);
  int64_t blocks = ((n + P - 1) / P + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  auto kernel = vec ? brownian_update_kernel<T, COMP, true>
                    : brownian_update_kernel<T, COMP, false>;
  return launch_ex(kernel, dim3((unsigned)blocks), dim3(kThreads), s, pdl, a,
                   n, slots, drift, sigma, ktemp, key, stream_word);
}

template <typename T>
int brownian_update(int compensated, long long n, long long slots, const T* f,
                    const T* x, const T* xc, const bool* occupied,
                    const T* virial, const T* accum, const int64_t* nprom,
                    T* x_out, T* xc_out, T* accum_out, int64_t* nprom_out,
                    T* temperature, const int64_t* step_in, int64_t* step_out,
                    long long step_value, double drift, double sigma,
                    double ktemp, unsigned k0, unsigned k1,
                    unsigned stream_word, int options, void* stream) {
  const bool comp = compensated != 0;
  constexpr long long P = 16 / sizeof(T);
  const bool ok = n >= 0 && slots >= 1 && n % slots == 0 &&
                  (n + P - 1) / P <= 0xFFFFFFFFLL && f && x && x_out &&
                  occupied && virial && accum && nprom && accum_out &&
                  nprom_out && temperature && (!comp || (xc && xc_out)) &&
                  (!step_out || step_in);
  if (!ok) return kErrArgs;
  const BrownianArgs<T> a{f,         x,          xc,        occupied,
                          virial,    accum,      nprom,     x_out,
                          xc_out,    accum_out,  nprom_out, temperature,
                          step_in,   step_out,   (int64_t)step_value};
  // The scalars rounded to T once (the caller rounded them already).
  const T dr = static_cast<T>(drift), sg = static_cast<T>(sigma),
          kt = static_cast<T>(ktemp);
  const uint2 key = make_uint2(k0, k1);
  const bool pdl = (options & kProgrammatic) != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return comp ? launch_brownian<T, true>(a, n, slots, dr, sg, kt, key,
                                         stream_word, pdl, s)
              : launch_brownian<T, false>(a, n, slots, dr, sg, kt, key,
                                          stream_word, pdl, s);
}

// ------------------------------------------------ particle rows (N, D)

using mdtpu::rows::load_row;

template <typename T, int D>
__device__ __forceinline__ void store_row(T* p, int64_t i, const T (&r)[D]) {
#pragma unroll
  for (int k = 0; k < D; ++k) p[i * D + k] = r[k];
}

template <typename T>
struct RowsArgs {
  const T* f;
  const T* v;
  const T* vc;
  const T* x;
  const T* xc;
  const int64_t* img;
  const T* cell;
  const T* cell_inv;
  T* v_out;
  T* vc_out;
  T* x_out;
  T* xc_out;
  int64_t* img_out;
  T* lo_out;
};

// Kick, drift and wrap of n particles, a thread each (grid-stride): the
// wrap needs all D components of a particle. v, vc <- kahan(v, vc, f
// half); x, xc <- kahan(x, xc, v dt); the wrap; where LO, lo = -xc after
// it. Not COMP: plain adds, vc and xc neither read nor written. Each
// thread reads and writes its own particle only, so the outputs may be
// the inputs.
template <typename T, int D, bool COMP, bool LO>
__global__ void __launch_bounds__(kThreads)
    kick_drift_wrap_kernel(RowsArgs<T> a, int64_t n, T half, T dt) {
  T c[D][D], ci[D][D];
  load_cell<T, D>(a.cell, a.cell_inv, c, ci);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T f[D], v[D], vc[D], x[D], xc[D];
    int64_t img[D];
    load_row<T, D>(a.f, i, f);
    load_row<T, D>(a.v, i, v);
    load_row<T, D>(a.x, i, x);
    load_row<int64_t, D>(a.img, i, img);
    if (COMP) {
      load_row<T, D>(a.vc, i, vc);
      load_row<T, D>(a.xc, i, xc);
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const T dv = f[k] * half;
      if (COMP)
        kahan(v[k], vc[k], dv);
      else
        v[k] = v[k] + dv;
      const T dx = v[k] * dt;
      if (COMP)
        kahan(x[k], xc[k], dx);
      else
        x[k] = x[k] + dx;
    }
    wrap<T, D, COMP>(x, xc, img, c, ci);
    store_row<T, D>(a.v_out, i, v);
    store_row<T, D>(a.x_out, i, x);
    store_row<int64_t, D>(a.img_out, i, img);
    if (COMP) {
      store_row<T, D>(a.vc_out, i, vc);
      store_row<T, D>(a.xc_out, i, xc);
    }
    if (LO) {
#pragma unroll
      for (int k = 0; k < D; ++k) xc[k] = -xc[k];
      store_row<T, D>(a.lo_out, i, xc);
    }
  }
}

template <typename T, int D, bool COMP, bool LO>
int launch_rows(const RowsArgs<T>& a, int64_t n, T half, T dt,
                cudaStream_t s) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  kick_drift_wrap_kernel<T, D, COMP, LO>
      <<<(int)blocks, kThreads, 0, s>>>(a, n, half, dt);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_rows_dim(const RowsArgs<T>& a, bool comp, int64_t n, T half, T dt,
                    cudaStream_t s) {
  if (!comp) return launch_rows<T, D, false, false>(a, n, half, dt, s);
  return a.lo_out ? launch_rows<T, D, true, true>(a, n, half, dt, s)
                  : launch_rows<T, D, true, false>(a, n, half, dt, s);
}

template <typename T>
int kick_drift_wrap(int compensated, int dim, long long n, const T* f,
                    const T* v, const T* vc, const T* x, const T* xc,
                    const int64_t* img, const T* cell, const T* cell_inv,
                    T* v_out, T* vc_out, T* x_out, T* xc_out,
                    int64_t* img_out, T* lo_out, double half, double dt,
                    void* stream) {
  const bool comp = compensated != 0;
  const bool ok = n >= 0 && (dim == 2 || dim == 3) && f && v && x && img &&
                  cell && cell_inv && v_out && x_out && img_out &&
                  (!comp || (vc && xc && vc_out && xc_out)) &&
                  (!lo_out || comp);
  if (!ok) return kErrArgs;
  const RowsArgs<T> a{f,     v,     vc,     x,      xc,      img,     cell,
                      cell_inv, v_out, vc_out, x_out, xc_out, img_out, lo_out};
  // The scalars rounded to T once, as torch rounds a Python number.
  const T h = static_cast<T>(half), d = static_cast<T>(dt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dim == 2 ? launch_rows_dim<T, 2>(a, comp, n, h, d, s)
                  : launch_rows_dim<T, 3>(a, comp, n, h, d, s);
}

template <typename T>
struct BrownianRowsArgs {
  const T* f;
  const T* x;
  const T* xc;
  const int64_t* img;
  const T* cell;
  const T* cell_inv;
  const T* virial;
  const T* accum;
  const int64_t* nprom;
  T* x_out;
  T* xc_out;
  int64_t* img_out;
  T* accum_out;
  int64_t* nprom_out;
  T* temperature;
  const int64_t* step_in;  // or null: step_value
  int64_t* step_out;       // or null
  int64_t step_value;
};

// Blocks of the particle-row Brownian move done with the step, on this
// card (0 between launches).
__device__ unsigned int g_brownian_rows_ticket = 0;

// Threads of a Brownian move's block: a particle each (particle_rows.cuh),
// and one warp more, whose first thread takes the block's ticket and, in
// the last block, writes the step's scalars while the particles move.
constexpr int kBrownianRowsThreads = mdtpu::rows::kRowsThreads + 32;

// The Brownian move of n particles of (n, D) rows, a particle a thread,
// a tile of kRowsThreads particles a block: value e = i D + k of the
// row-major positions takes xi, the noise kernel's element e. The tile's
// D kRowsThreads values are whole Philox blocks (block b holds elements b P
// .. b P + P - 1), each drawn once into shared memory, block t0 D / P + j
// by thread j mod blockDim.x. Then x, xc <- kahan(x, xc, f
// drift + xi sigma) (plain where not COMP) and the wrap. A programmatic
// dependent of the kernel before it (the pair sweep, which writes the
// forces and the virial): the step, the cell, x, xc and the images are
// loaded and the noise drawn before griddepcontrol.wait, the forces and
// the virial after it, every store after it. The ticket (the block's
// last thread, after the wait: every thread of the block read the step
// before the barrier ahead of it) is off the particles' path; the last
// block to take it writes the step's scalars, as brownian_update_kernel
// does.
template <typename T, int D, bool COMP>
__global__ void __launch_bounds__(kBrownianRowsThreads)
    brownian_rows_kernel(BrownianRowsArgs<T> a, int64_t n, T drift, T sigma,
                         T ktemp, uint2 key, uint32_t stream) {
  constexpr int kTile = mdtpu::rows::kRowsThreads;
  constexpr int P = int(16 / sizeof(T));
  constexpr int kBlocks = kTile * D / P;  // Philox blocks a tile
  static_assert(kTile * D % P == 0, "a tile is whole Philox blocks");
  __shared__ __align__(16) T noise[kTile * D];
  const int64_t nv = n * D;
  const bool mover = threadIdx.x < kTile;
  T c[D][D], ci[D][D];
  load_cell<T, D>(a.cell, a.cell_inv, c, ci);
  const int64_t s = a.step_in ? *a.step_in : a.step_value;
  const int64_t stride = (int64_t)gridDim.x * kTile;
  bool waited = false;
  // rows_grid gives every block a tile where n > 0.
  for (int64_t t0 = (int64_t)blockIdx.x * kTile; t0 < n; t0 += stride) {
    for (int j = threadIdx.x; j < kBlocks; j += kBrownianRowsThreads) {
      const int64_t b = t0 * D / P + j;
      if (b * P >= nv) break;
      T w[P];
      mdtpu::philox::noise_values(
          mdtpu::philox::philox4x32_10(
              mdtpu::philox::counter((uint32_t)b, s, stream), key),
          w);
#pragma unroll
      for (int q = 0; q < P; ++q) noise[j * P + q] = w[q];
    }
    const int64_t i = t0 + threadIdx.x;
    const bool mine = mover && i < n;
    T x[D], xc[D] = {}, f[D];
    int64_t img[D];
    if (mine) {
      load_row<T, D>(a.x, i, x);
      if (COMP) load_row<T, D>(a.xc, i, xc);
      load_row<int64_t, D>(a.img, i, img);
    }
    __syncthreads();  // the tile's noise; every thread has read the step
    if (!waited) {
      wait_for_dependencies();
      waited = true;
    }
    if (mine) {
      load_row<T, D>(a.f, i, f);
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const T dx = f[k] * drift + noise[threadIdx.x * D + k] * sigma;
        if (COMP)
          kahan(x[k], xc[k], dx);
        else
          x[k] = x[k] + dx;
      }
      wrap<T, D, COMP>(x, xc, img, c, ci);
      store_row<T, D>(a.x_out, i, x);
      if (COMP) store_row<T, D>(a.xc_out, i, xc);
      store_row<int64_t, D>(a.img_out, i, img);
    }
    if (t0 + stride < n) __syncthreads();  // before the next tile's draws
  }
  if (!waited) wait_for_dependencies();
  if (threadIdx.x != kBrownianRowsThreads - 1) return;
  cuda::atomic_ref<unsigned, cuda::thread_scope_device> ticket(
      g_brownian_rows_ticket);
  if (ticket.fetch_add(1u, cuda::memory_order_acq_rel) != gridDim.x - 1)
    return;
  // brownian_virial_sample: accum + where(take, virial, 0), nprom + take.
  const bool take = s % 10 == 0;
  *a.accum_out = *a.accum + (take ? *a.virial : T(0));
  *a.nprom_out = *a.nprom + (take ? 1 : 0);
  *a.temperature = ktemp;
  if (a.step_out) *a.step_out = s + 1;
  ticket.store(0u, cuda::memory_order_relaxed);
}

template <typename T, int D, bool COMP>
int launch_brownian_rows(const BrownianRowsArgs<T>& a, int64_t n, T drift,
                         T sigma, T ktemp, uint2 key, uint32_t stream_word,
                         bool pdl, cudaStream_t s) {
  return launch_ex(brownian_rows_kernel<T, D, COMP>,
                   dim3(mdtpu::rows::rows_grid(n)),
                   dim3(kBrownianRowsThreads), s, pdl, a, n, drift, sigma,
                   ktemp, key, stream_word);
}

template <typename T>
int brownian_rows(int compensated, int dim, long long n, const T* f,
                  const T* x, const T* xc, const int64_t* img, const T* cell,
                  const T* cell_inv, const T* virial, const T* accum,
                  const int64_t* nprom, T* x_out, T* xc_out,
                  int64_t* img_out, T* accum_out, int64_t* nprom_out,
                  T* temperature, const int64_t* step_in, int64_t* step_out,
                  long long step_value, double drift, double sigma,
                  double ktemp, unsigned k0, unsigned k1,
                  unsigned stream_word, int options, void* stream) {
  const bool comp = compensated != 0;
  constexpr long long P = 16 / sizeof(T);
  // Every group's Philox blocks (a partial group's too) below 2^32.
  const bool ok = n >= 0 && (dim == 2 || dim == 3) &&
                  (n * dim + P * dim) / P <= 0xFFFFFFFFLL && f && x && img &&
                  cell && cell_inv && virial && accum && nprom && x_out &&
                  img_out && accum_out && nprom_out && temperature &&
                  (!comp || (xc && xc_out)) && (!step_out || step_in);
  if (!ok) return kErrArgs;
  const BrownianRowsArgs<T> a{f,         x,        xc,          img,
                              cell,      cell_inv, virial,      accum,
                              nprom,     x_out,    xc_out,      img_out,
                              accum_out, nprom_out, temperature, step_in,
                              step_out,  (int64_t)step_value};
  const T dr = static_cast<T>(drift), sg = static_cast<T>(sigma),
          kt = static_cast<T>(ktemp);
  const uint2 key = make_uint2(k0, k1);
  const bool pdl = (options & kProgrammatic) != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 2)
    return comp ? launch_brownian_rows<T, 2, true>(a, n, dr, sg, kt, key,
                                                   stream_word, pdl, s)
                : launch_brownian_rows<T, 2, false>(a, n, dr, sg, kt, key,
                                                    stream_word, pdl, s);
  return comp ? launch_brownian_rows<T, 3, true>(a, n, dr, sg, kt, key,
                                                 stream_word, pdl, s)
              : launch_brownian_rows<T, 3, false>(a, n, dr, sg, kt, key,
                                                  stream_word, pdl, s);
}

// Whether func is one of this file's particle-row Brownian moves.
template <typename T>
bool brownian_rows_kernel_of(const void* func) {
  const void* kernels[] = {(const void*)brownian_rows_kernel<T, 2, true>,
                           (const void*)brownian_rows_kernel<T, 2, false>,
                           (const void*)brownian_rows_kernel<T, 3, true>,
                           (const void*)brownian_rows_kernel<T, 3, false>};
  for (const void* k : kernels)
    if (k == func) return true;
  return false;
}

// Whether func is one of this file's Brownian update kernels.
bool brownian_kernel(const void* func) {
  const void* kernels[] = {
      (const void*)brownian_update_kernel<float, true, true>,
      (const void*)brownian_update_kernel<float, true, false>,
      (const void*)brownian_update_kernel<float, false, true>,
      (const void*)brownian_update_kernel<float, false, false>,
      (const void*)brownian_update_kernel<double, true, true>,
      (const void*)brownian_update_kernel<double, true, false>,
      (const void*)brownian_update_kernel<double, false, true>,
      (const void*)brownian_update_kernel<double, false, false>};
  for (const void* k : kernels)
    if (k == func) return true;
  return false;
}

}  // namespace

extern "C" {

// variant 0 kick-drift, 1 kick, 2 rescale, over n values of (d, S) rows,
// contiguous. Inputs f, v, vc, x, xc (those the variant reads) and
// scale (rescale: one value on the device); outputs v_out, vc_out, x_out,
// xc_out (each may be its input), lo_out (kick-drift, compensated: -xc, or
// null). step_in, step_out: one int64 each on the device (may be one),
// step_out = step_in + 1, or both null. half, dt: dt / 2 and dt.
int mdtpu_verlet_update_f32(int variant, int compensated, long long n,
                            const float* f, const float* v, const float* vc,
                            const float* x, const float* xc,
                            const float* scale, float* v_out, float* vc_out,
                            float* x_out, float* xc_out, float* lo_out,
                            const int64_t* step_in, int64_t* step_out,
                            double half, double dt, void* stream) {
  return verlet_update<float>(variant, compensated, n, f, v, vc, x, xc, scale,
                              v_out, vc_out, x_out, xc_out, lo_out, step_in,
                              step_out, half, dt, stream);
}

int mdtpu_verlet_update_f64(int variant, int compensated, long long n,
                            const double* f, const double* v,
                            const double* vc, const double* x,
                            const double* xc, const double* scale,
                            double* v_out, double* vc_out, double* x_out,
                            double* xc_out, double* lo_out,
                            const int64_t* step_in, int64_t* step_out,
                            double half, double dt, void* stream) {
  return verlet_update<double>(variant, compensated, n, f, v, vc, x, xc,
                               scale, v_out, vc_out, x_out, xc_out, lo_out,
                               step_in, step_out, half, dt, stream);
}

// The Brownian slot step's update over n = d * S values of (d, S) rows,
// contiguous: f, x, xc (xc, xc_out only where compensated); occupied (S,)
// bools; virial, accum: one value of T, nprom one int64, all on the
// device. Outputs x_out, xc_out (each may be its input), accum_out,
// nprom_out (may be accum, nprom), temperature (kT). step_in: an int64 on
// the device, or null and step_value the step; step_out: step + 1 (may be
// step_in), or null. drift = dt/kT, sigma = sqrt(2 dt), ktemp: rounded to
// T already. k0, k1: the seed's key words; stream_word: the noise's
// counter word (1 | rank << 8). options: kProgrammatic or 0.
int mdtpu_brownian_update_f32(
    int compensated, long long n, long long slots, const float* f,
    const float* x, const float* xc, const bool* occupied,
    const float* virial, const float* accum, const int64_t* nprom,
    float* x_out, float* xc_out, float* accum_out, int64_t* nprom_out,
    float* temperature, const int64_t* step_in, int64_t* step_out,
    long long step_value, double drift, double sigma, double ktemp,
    unsigned k0, unsigned k1, unsigned stream_word, int options,
    void* stream) {
  return brownian_update<float>(
      compensated, n, slots, f, x, xc, occupied, virial, accum, nprom, x_out,
      xc_out, accum_out, nprom_out, temperature, step_in, step_out,
      step_value, drift, sigma, ktemp, k0, k1, stream_word, options, stream);
}

int mdtpu_brownian_update_f64(
    int compensated, long long n, long long slots, const double* f,
    const double* x, const double* xc, const bool* occupied,
    const double* virial, const double* accum, const int64_t* nprom,
    double* x_out, double* xc_out, double* accum_out, int64_t* nprom_out,
    double* temperature, const int64_t* step_in, int64_t* step_out,
    long long step_value, double drift, double sigma, double ktemp,
    unsigned k0, unsigned k1, unsigned stream_word, int options,
    void* stream) {
  return brownian_update<double>(
      compensated, n, slots, f, x, xc, occupied, virial, accum, nprom, x_out,
      xc_out, accum_out, nprom_out, temperature, step_in, step_out,
      step_value, drift, sigma, ktemp, k0, k1, stream_word, options, stream);
}

// The programmatic edges of the graph being captured on stream that enter
// a Brownian update node, into out[0], and the error code of the edges'
// read into out[1] (out[0] and out[2] -1 where it is not 0); those into a
// particle-row Brownian move into out[2]. Only this library's runtime
// knows its kernels' addresses, so the count is made here.
int mdtpu_verlet_update_census(void* stream, long long* out) {
  out[0] = out[1] = out[2] = 0;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t rc = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream),
                                            &status, nullptr, &graph);
  if (rc) return (int)rc;
  if (status != cudaStreamCaptureStatusActive) return kErrNotCapturing;
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
    out[0] = out[2] = -1;
    out[1] = (long long)rc;
    return 0;
  }
  for (size_t e = 0; e < ne; ++e) {
    if (data[e].type != cudaGraphDependencyTypeProgrammatic) continue;
    cudaKernelNodeParams p;
    if (cudaGraphKernelNodeGetParams(to[e], &p) != cudaSuccess)
      cudaGetLastError();
    else if (brownian_kernel(p.func))
      ++out[0];
    else if (brownian_rows_kernel_of<float>(p.func) ||
             brownian_rows_kernel_of<double>(p.func))
      ++out[2];
  }
  return 0;
}

// Kick, drift and wrap of n particles of (n, dim) rows, row-major and
// contiguous: f, v, vc, x, xc (vc, xc, vc_out, xc_out only where
// compensated), img (int64); cell, cell_inv: (dim, dim) row-major on the
// device. Outputs v_out, vc_out, x_out, xc_out, img_out (each may be its
// input) and lo_out (compensated: -xc after the wrap, or null). half, dt:
// dt / 2 and dt.
int mdtpu_kick_drift_wrap_f32(int compensated, int dim, long long n,
                              const float* f, const float* v, const float* vc,
                              const float* x, const float* xc,
                              const int64_t* img, const float* cell,
                              const float* cell_inv, float* v_out,
                              float* vc_out, float* x_out, float* xc_out,
                              int64_t* img_out, float* lo_out, double half,
                              double dt, void* stream) {
  return kick_drift_wrap<float>(compensated, dim, n, f, v, vc, x, xc, img,
                                cell, cell_inv, v_out, vc_out, x_out, xc_out,
                                img_out, lo_out, half, dt, stream);
}

int mdtpu_kick_drift_wrap_f64(int compensated, int dim, long long n,
                              const double* f, const double* v,
                              const double* vc, const double* x,
                              const double* xc, const int64_t* img,
                              const double* cell, const double* cell_inv,
                              double* v_out, double* vc_out, double* x_out,
                              double* xc_out, int64_t* img_out,
                              double* lo_out, double half, double dt,
                              void* stream) {
  return kick_drift_wrap<double>(compensated, dim, n, f, v, vc, x, xc, img,
                                 cell, cell_inv, v_out, vc_out, x_out,
                                 xc_out, img_out, lo_out, half, dt, stream);
}

// The Brownian move of n particles of (n, dim) rows, row-major and
// contiguous: f, x, xc (xc, xc_out only where compensated), img (int64);
// cell, cell_inv (dim, dim) row-major; virial, accum one value of T,
// nprom one int64, all on the device. Outputs x_out, xc_out, img_out (each
// may be its input), accum_out, nprom_out (may be accum, nprom),
// temperature (kT). step_in: an int64 on the device, or null and
// step_value the step; step_out: step + 1 (may be step_in), or null.
// drift, sigma, ktemp: rounded to T already; k0, k1 the seed's key words;
// stream_word the noise's counter word; options: kProgrammatic or 0 (the
// kernel just before must not write the step, the cell, the positions,
// their compensation or the images).
int mdtpu_brownian_rows_f32(
    int compensated, int dim, long long n, const float* f, const float* x,
    const float* xc, const int64_t* img, const float* cell,
    const float* cell_inv, const float* virial, const float* accum,
    const int64_t* nprom, float* x_out, float* xc_out, int64_t* img_out,
    float* accum_out, int64_t* nprom_out, float* temperature,
    const int64_t* step_in, int64_t* step_out, long long step_value,
    double drift, double sigma, double ktemp, unsigned k0, unsigned k1,
    unsigned stream_word, int options, void* stream) {
  return brownian_rows<float>(compensated, dim, n, f, x, xc, img, cell,
                              cell_inv, virial, accum, nprom, x_out, xc_out,
                              img_out, accum_out, nprom_out, temperature,
                              step_in, step_out, step_value, drift, sigma,
                              ktemp, k0, k1, stream_word, options, stream);
}

int mdtpu_brownian_rows_f64(
    int compensated, int dim, long long n, const double* f, const double* x,
    const double* xc, const int64_t* img, const double* cell,
    const double* cell_inv, const double* virial, const double* accum,
    const int64_t* nprom, double* x_out, double* xc_out, int64_t* img_out,
    double* accum_out, int64_t* nprom_out, double* temperature,
    const int64_t* step_in, int64_t* step_out, long long step_value,
    double drift, double sigma, double ktemp, unsigned k0, unsigned k1,
    unsigned stream_word, int options, void* stream) {
  return brownian_rows<double>(compensated, dim, n, f, x, xc, img, cell,
                               cell_inv, virial, accum, nprom, x_out, xc_out,
                               img_out, accum_out, nprom_out, temperature,
                               step_in, step_out, step_value, drift, sigma,
                               ktemp, k0, k1, stream_word, options, stream);
}

const char* mdtpu_verlet_update_error_string(int code) {
  if (code == kErrArgs) return "arguments outside what the kernel takes";
  if (code == kErrNotCapturing) return "the stream is not capturing a graph";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
