// FIRE's update as three kernels for NVIDIA Hopper (sm_90a): the whole
// minimization then runs on the device, one CUDA graph launch.
//
// They replace no Pallas kernel. The JAX package runs FIRE as one device
// program (mdtpu/minimize/fire.py:1-6): in particle order one
// lax.while_loop (:171-228 cond and body), in the slot layout an outer
// while_loop around an inner one of fire_step (:323-370, :372-431), XLA
// fusing the reductions, the scalar tail and the move. The port's iteration
// ran that arithmetic as some forty torch launches and read a flag on the
// host each time (3.7 ms an iteration at 65,536 particles against the lean
// sweep's 0.06 ms; PERF.md section 5). Here, an iteration is:
//
//   * fire_reduce: v' = v + dt F (dt read from the device scalars), the
//     maxima of |v'| and |F| and the max-scaled sums: the power
//     sum (v'/vmax_s)(F/fmax_s), |v'/vmax_s|^2 and |F/fmax_s|^2 (vmax_s is
//     vmax, or 1 where vmax is 0; no raw value is squared: the forces of an
//     overlapping start reach ~1e25). The block that takes the last ticket
//     combines the blocks' partials and computes the scalar tail (fire.py
//     :330-353): do_mix, scale, positive, the new dt, alpha and the steps
//     since the power turned negative. It runs in one pass (mode 7): a
//     block scales its sums by its own maxima and the last block rescales
//     them by (block max / global max)^2. The sharded FIRE launches modes
//     1, 2 and 4 apart (the maxima, the sums divided by the global maxima
//     as the plain version divides, the tail), the ring's all-reduces (max,
//     then sum) of the small buffer red between them, where the JAX package
//     has pmax and psum.
//   * fire_move: per particle v' again (the same expression, so the same
//     bits), the mix (1 - alpha) v' + scale F where do_mix, zero where the
//     power was not positive, disp = dt v, the particle's max-scaled norm,
//     the dmax cap and the non-finite guards (fire.py:355-366), x += disp in
//     place; in particle rows also the periodic wrap with the images
//     (periodic_wrap.cuh, shared with verlet_update.cu's
//     kick_drift_wrap_kernel). Slots are component-major (d, S) and keep
//     the wrap for the rebin, as the JAX package's slot FIRE does.
//   * fire_test, after the sweep: f_rms = |F / fm_s| fm / sqrt(ndof)
//     (fire.py:299-302), step += 1 (not at the entry test), and the loop's
//     predicate step < max_steps & f_rms >= tol & ~overflow into a flag
//     byte and, inside a capture, the WHILE node's handle; a second handle
//     (the rebin's IF node in slots) takes the predicate and the drift
//     test's flag byte. max_steps and tol are read from the device, so one
//     graph serves every call.
//
// Sums. Every sum runs in a fixed order: a thread adds its values in index
// order, a block by warp shuffles in a fixed butterfly and then across its
// warps the same way, the last block the blocks' partials in a fixed
// order by the same reduction (two of them a launch: the maxima first,
// then the sums rescaled by them). The grid follows from
// the count alone and there are no float atomics, so an eager run and a
// captured one give the same bits. The kernels are not held to the plain
// versions' bits (torch sums in another order), only within tolerance.
//
// Overflow. Where the slot state's sticky overflow flag is set (a rebin
// dropped rows), the three kernels leave everything as it is and the test
// ends the loop without counting a step: the run is retried from the start
// at a grown capacity, as the JAX package's loop ends on it.
//
// What bounds it on the H100: bytes. At the bench_fire shape, slots (3,
// 124,875) float32 are 1.50 MB an array: fire_reduce reads v and F (3.0
// MB, 0.89 us at 3.35 TB/s), fire_move reads x, v and F and writes x and v
// (7.5 MB, 2.24 us), fire_test reads F (1.5 MB, 0.45 us); the small
// launches sit near the launch floor. A thread holds kItems values of each
// array, neighbouring threads on neighbouring values.
//
// Built with -fmad=false, so every product and sum rounds as in the plain
// PyTorch versions (mdtpu_torch/minimize/fire_update.py).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "periodic_wrap.cuh"

namespace {

constexpr int kErrArgs = -1;
constexpr int kThreads = 256;
constexpr int kItems = 8;                      // values a thread holds
constexpr int kPerBlock = kThreads * kItems;   // values a block reduces
constexpr int kMoveMaxBlocks = 4096;
constexpr int kPartials = 5;                   // a block's partials
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

// Mode bits of fire_reduce and fire_test.
constexpr int kMaxima = 1;
constexpr int kSums = 2;
constexpr int kTail = 4;

// red (5 values): the maximum of |a|, the maximum of |b|, sum a b, sum a a,
// sum b b, max-scaled. fire_reduce: a = v', b = F; fire_test: b = F alone.
enum Red { kMaxA = 0, kMaxB = 1, kSumAB = 2, kSumAA = 3, kSumBB = 4 };
// scal (T): dt, alpha, f_rms, tol, (1 - alpha) of the mix, its scale, the
// dt of the kick v' = v + dt F (the step's dt before the tail's update).
enum Scal { kDt = 0, kAlpha = 1, kFrms = 2, kTol = 3, kMixV = 4, kMixF = 5,
            kDtKick = 6 };
// ints (int64): steps since the power turned negative, the step, max_steps,
// do_mix, positive, the loop's passes, converged, the overflow the test saw
// (and, at 8, the rebins the caller counts).
enum Ints { kSsn = 0, kStep = 1, kMaxSteps = 2, kDoMix = 3, kPositive = 4,
            kPasses = 5, kConverged = 6, kOverflow = 7 };

template <typename T>
struct Hyper {
  T f_inc, f_dec, dt_max, dt_initial, alpha0;
  int64_t n_min;
};

__device__ unsigned int g_reduce_ticket = 0;
__device__ unsigned int g_test_ticket = 0;

// max with NaN carried, as torch.max and jnp.max carry it.
template <typename T>
__device__ __forceinline__ T nan_max(T m, T a) {
  return (a > m || a != a) ? a : m;
}

template <typename T>
__device__ __forceinline__ T positive_or_one(T m) {
  return m > T(0) ? m : T(1);
}

// A block's reduction of N values a thread, the first M by their maximum
// and the rest by their sum, in a fixed order: each warp by a butterfly of
// shuffles (lane 0's result, whose order is fixed), then the warps'
// results by warp 0 the same way. Every thread gets the block's values
// (through s, kWarps * N values of shared memory).
template <typename T, int N, int M>
__device__ void block_reduce(T (&p)[N], T* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const T o = __shfl_xor_sync(kAll, p[k], off);
      p[k] = k < M ? nan_max(p[k], o) : p[k] + o;
    }
  __syncthreads();  // the last reduction's readers are done with s
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) s[warp * N + k] = p[k];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      p[k] = lane < kWarps ? s[lane * N + k] : T(0);
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const T o = __shfl_xor_sync(kAll, p[k], off);
        p[k] = k < M ? nan_max(p[k], o) : p[k] + o;
      }
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < N; ++k) s[k] = p[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) p[k] = s[k];
}

// FIRE's scalar tail (fire.py:330-353), from the global maxima and sums,
// operation for operation as minimize/fire_update.py fire_tail_plain:
// scale = alpha (vmax_s / fmax_s) (vn / fn_s), the Python numbers rounded
// once to T (as torch rounds a Python number against a tensor).
template <typename T>
__device__ void fire_tail(const T* red, T* scal, int64_t* ints,
                          const Hyper<T>& h) {
  const T vmax = red[kMaxA], fmax = red[kMaxB];
  const T vmax_s = positive_or_one(vmax), fmax_s = positive_or_one(fmax);
  const T vn = sqrt(red[kSumAA]), fn = sqrt(red[kSumBB]);
  const bool do_mix = vmax > T(0) && fmax > T(0);
  const T dt = scal[kDt], alpha = scal[kAlpha];
  const T scale = alpha * (vmax_s / fmax_s) * (vn / positive_or_one(fn));
  const bool positive = red[kSumAB] > T(0);
  const int64_t ssn_pos = ints[kSsn] + 1;
  const bool grow = ssn_pos > h.n_min;
  const T up = dt * h.f_inc;
  const T dt_pos = grow ? (up > h.dt_max ? h.dt_max : up) : dt;
  const T alpha_pos = grow ? alpha * T(0.99) : alpha;
  const T down = dt * h.f_dec;
  const T dt_neg = down < h.dt_initial ? h.dt_initial : down;
  scal[kDtKick] = dt;
  scal[kMixV] = T(1) - alpha;
  scal[kMixF] = scale;
  scal[kDt] = positive ? dt_pos : dt_neg;
  scal[kAlpha] = positive ? alpha_pos : h.alpha0;
  ints[kSsn] = positive ? ssn_pos : 0;
  ints[kDoMix] = do_mix;
  ints[kPositive] = positive;
}

// The loop's test (fire.py:299-302, :386-388 and :407-410) from the global
// max |F| and sum |F / fm_s|^2: f_rms, the step, the predicate, its flag
// bytes and handles.
template <typename T>
__device__ void test_tail(const T* red, T* scal, int64_t* ints, bool ovf,
                          T sqrt_ndof, int entry, const bool* drift,
                          bool* flags, cudaGraphConditionalHandle h_a,
                          cudaGraphConditionalHandle h_b, int set_a,
                          int set_b) {
  if (!entry) ints[kPasses] += 1;
  if (!ovf) {
    scal[kFrms] = sqrt(red[kSumBB]) * red[kMaxB] / sqrt_ndof;
    if (!entry) ints[kStep] += 1;
  }
  const T f_rms = scal[kFrms], tol = scal[kTol];
  const bool going = ints[kStep] < ints[kMaxSteps] && f_rms >= tol && !ovf;
  const bool then = going && (drift ? *drift : true);
  ints[kConverged] = f_rms < tol && !ovf;
  ints[kOverflow] = ovf;
  flags[0] = going;
  flags[1] = then;
  if (set_a) cudaGraphSetConditional(h_a, going ? 1u : 0u);
  if (set_b) cudaGraphSetConditional(h_b, then ? 1u : 0u);
}

struct TestArgs {
  int entry;
  const bool* drift;
  bool* flags;
  cudaGraphConditionalHandle h_a, h_b;
  int set_a, set_b;
};

// The reduction of fire_reduce (TWO: a = v + dt F and b = F) and of
// fire_test (b = F alone) over n values, by MODE bits: kMaxima the maxima,
// kSums the sums (with kMaxima each block scales by its own maxima, the
// last block rescales; alone, by the global maxima in red), kTail the tail
// (alone: a launch of one block on red). work: kPartials values a block.
template <typename T, bool TWO, int MODE>
__global__ void __launch_bounds__(kThreads)
    scaled_reduce_kernel(const T* __restrict__ v, const T* __restrict__ f,
                         int64_t n, T* red, T* work, T* scal, int64_t* ints,
                         const bool* overflow, Hyper<T> h, T sqrt_ndof,
                         TestArgs t) {
  __shared__ T s[kWarps * 3];
  __shared__ bool last;
  const bool ovf = overflow != nullptr && *overflow;
  if (ovf) {
    // Nothing moves; the test ends the loop without a step.
    if (!TWO && (MODE & kTail) && blockIdx.x == 0 && threadIdx.x == 0)
      test_tail(red, scal, ints, true, sqrt_ndof, t.entry, t.drift, t.flags,
                t.h_a, t.h_b, t.set_a, t.set_b);
    return;
  }
  constexpr bool MAXIMA = MODE & kMaxima, SUMS = MODE & kSums;
  const int grid = gridDim.x;
  if (MAXIMA || SUMS) {
    const T dt = TWO ? scal[kDt] : T(0);
    T a[kItems], b[kItems];
    const int64_t base = (int64_t)blockIdx.x * kPerBlock + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = base + (int64_t)j * kThreads;
      b[j] = i < n ? f[i] : T(0);
      a[j] = TWO && i < n ? v[i] + dt * b[j] : T(0);
    }
    // The block's maxima (max |a|, max |b|), or the global ones.
    T m[2] = {T(0), T(0)};
    if (MAXIMA) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (TWO) m[0] = nan_max(m[0], fabs(a[j]));
        m[1] = nan_max(m[1], fabs(b[j]));
      }
      block_reduce<T, 2, 2>(m, s);
    } else {
      m[0] = red[kMaxA];
      m[1] = red[kMaxB];
    }
    // The sums (a b, a a, b b), each value divided by those maxima.
    T q[3] = {T(0), T(0), T(0)};
    if (SUMS) {
      const T sa = positive_or_one(m[0]), sb = positive_or_one(m[1]);
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const T y = b[j] / sb;
        if (TWO) {
          const T x = a[j] / sa;
          q[0] = q[0] + x * y;
          q[1] = q[1] + x * x;
        }
        q[2] = q[2] + y * y;
      }
      block_reduce<T, 3, 0>(q, s);
    }
    if (threadIdx.x == 0) {
      work[0 * grid + blockIdx.x] = m[0];
      work[1 * grid + blockIdx.x] = m[1];
      work[2 * grid + blockIdx.x] = q[0];
      work[3 * grid + blockIdx.x] = q[1];
      work[4 * grid + blockIdx.x] = q[2];
      // The last block to take a ticket combines the partials.
      __threadfence();
      unsigned int* ticket = TWO ? &g_reduce_ticket : &g_test_ticket;
      last = atomicAdd(ticket, 1u) == (unsigned)grid - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    T g[2] = {T(0), T(0)};
    if (MAXIMA) {
      for (int k = threadIdx.x; k < grid; k += kThreads) {
        g[0] = nan_max(g[0], __ldcg(&work[0 * grid + k]));
        g[1] = nan_max(g[1], __ldcg(&work[1 * grid + k]));
      }
      block_reduce<T, 2, 2>(g, s);
    } else {
      g[0] = red[kMaxA];
      g[1] = red[kMaxB];
    }
    if (SUMS) {
      const T ga = positive_or_one(g[0]), gb = positive_or_one(g[1]);
      T r[3] = {T(0), T(0), T(0)};
      for (int k = threadIdx.x; k < grid; k += kThreads) {
        // A block's sums scaled by its own maxima, brought to the global
        // ones: (block max / global max)^2 (the block max is 0 only where
        // its sums are).
        const T ra = MAXIMA ? __ldcg(&work[0 * grid + k]) / ga : T(1);
        const T rb = MAXIMA ? __ldcg(&work[1 * grid + k]) / gb : T(1);
        r[0] = r[0] + __ldcg(&work[2 * grid + k]) * ra * rb;
        r[1] = r[1] + __ldcg(&work[3 * grid + k]) * ra * ra;
        r[2] = r[2] + __ldcg(&work[4 * grid + k]) * rb * rb;
      }
      block_reduce<T, 3, 0>(r, s);
      if (threadIdx.x == 0) {
        red[kSumAB] = r[0];
        red[kSumAA] = r[1];
        red[kSumBB] = r[2];
      }
    }
    if (threadIdx.x == 0) {
      red[kMaxA] = g[0];
      red[kMaxB] = g[1];
      *(TWO ? &g_reduce_ticket : &g_test_ticket) = 0;
    }
  }
  if ((MODE & kTail) && threadIdx.x == 0) {
    if (TWO)
      fire_tail(red, scal, ints, h);
    else
      test_tail(red, scal, ints, false, sqrt_ndof, t.entry, t.drift, t.flags,
                t.h_a, t.h_b, t.set_a, t.set_b);
  }
}

// The move of n particles, a thread each (grid-stride): component k of
// particle p at k * stride + p (slots, stride S) or p * D + k (rows,
// stride 0). WRAP (rows): the periodic wrap and the images after it.
template <typename T, int D, bool WRAP>
__global__ void __launch_bounds__(kThreads)
    fire_move_kernel(T* x, T* v, const T* __restrict__ f, int64_t n,
                     int64_t stride, int64_t* images, const T* cell,
                     const T* cell_inv, const T* scal, const int64_t* ints,
                     T dmax, const bool* overflow) {
  if (overflow != nullptr && *overflow) return;
  T c[D][D], ci[D][D];
  if (WRAP) mdtpu::box::load_cell<T, D>(cell, cell_inv, c, ci);
  const T dt_kick = scal[kDtKick], dt = scal[kDt];
  const T mix_v = scal[kMixV], mix_f = scal[kMixF];
  const bool do_mix = ints[kDoMix] != 0, positive = ints[kPositive] != 0;
  const T inf = T(INFINITY);
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (int64_t)gridDim.x * blockDim.x) {
    T xk[D], vk[D], disp[D];
    T m = T(0);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int64_t e = stride ? k * stride + p : p * D + k;
      const T fk = f[e];
      T w = v[e] + dt_kick * fk;
      if (do_mix) w = mix_v * w + mix_f * fk;
      if (!positive) w = T(0);
      vk[k] = w;
      xk[k] = x[e];
      disp[k] = dt * w;
      m = nan_max(m, fabs(disp[k]));
    }
    const T ms = positive_or_one(m);
    T ss = T(0);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const T q = disp[k] / ms;
      ss = ss + q * q;
    }
    T dnorm = sqrt(ss) * m;
    if (!isfinite(dnorm)) dnorm = inf;
    // torch: dmax / t is reciprocal(t) * dmax; clamp(max=1).
    const T floor_norm = T(1e-30);
    const T r = T(1) / (dnorm < floor_norm ? floor_norm : dnorm);
    T cap = r * dmax;
    cap = cap > T(1) ? T(1) : cap;
#pragma unroll
    for (int k = 0; k < D; ++k)
      xk[k] = xk[k] + (isfinite(disp[k]) ? disp[k] * cap : T(0));
    if (WRAP) {
      T unused[D];
      int64_t img[D];
#pragma unroll
      for (int k = 0; k < D; ++k) img[k] = images[p * D + k];
      mdtpu::box::wrap<T, D, false>(xk, unused, img, c, ci);
#pragma unroll
      for (int k = 0; k < D; ++k) images[p * D + k] = img[k];
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int64_t e = stride ? k * stride + p : p * D + k;
      x[e] = xk[k];
      v[e] = vk[k];
    }
  }
}

int reduce_grid(int64_t n) {
  const int64_t blocks = (n + kPerBlock - 1) / kPerBlock;
  return (int)(blocks > 0 ? blocks : 1);
}

template <typename T, bool TWO, int MODE>
int launch_reduce(const T* v, const T* f, int64_t n, T* red, T* work,
                  T* scal, int64_t* ints, const bool* overflow,
                  const Hyper<T>& h, T sqrt_ndof, const TestArgs& t,
                  cudaStream_t s) {
  const int grid = MODE == kTail ? 1 : reduce_grid(n);
  scaled_reduce_kernel<T, TWO, MODE><<<grid, kThreads, 0, s>>>(
      v, f, n, red, work, scal, ints, overflow, h, sqrt_ndof, t);
  return (int)cudaGetLastError();
}

template <typename T, bool TWO>
int launch_mode(int mode, const T* v, const T* f, int64_t n, T* red,
                T* work, T* scal, int64_t* ints, const bool* overflow,
                const Hyper<T>& h, T sqrt_ndof, const TestArgs& t,
                cudaStream_t s) {
  switch (mode) {
    case kMaxima | kSums | kTail:
      return launch_reduce<T, TWO, kMaxima | kSums | kTail>(
          v, f, n, red, work, scal, ints, overflow, h, sqrt_ndof, t, s);
    case kMaxima:
      return launch_reduce<T, TWO, kMaxima>(v, f, n, red, work, scal, ints,
                                           overflow, h, sqrt_ndof, t, s);
    case kSums:
      return launch_reduce<T, TWO, kSums>(v, f, n, red, work, scal, ints,
                                         overflow, h, sqrt_ndof, t, s);
    case kTail:
      return launch_reduce<T, TWO, kTail>(v, f, n, red, work, scal, ints,
                                         overflow, h, sqrt_ndof, t, s);
    default:
      return kErrArgs;
  }
}

bool known_mode(int mode) {
  return mode == (kMaxima | kSums | kTail) || mode == kMaxima ||
         mode == kSums || mode == kTail;
}

template <typename T>
int fire_reduce(const T* v, const T* f, long long n, T* scal, int64_t* ints,
                T* red, T* work, long long work_len, const bool* overflow,
                int mode, double f_inc, double f_dec, double dt_max,
                double dt_initial, double alpha0, long long n_min,
                void* stream) {
  if (!known_mode(mode) || !scal || !ints || !red || n < 0 ||
      ((mode & (kMaxima | kSums)) &&
       (!v || !f || !work || work_len < (long long)kPartials * reduce_grid(n))))
    return kErrArgs;
  const Hyper<T> h{(T)f_inc, (T)f_dec, (T)dt_max, (T)dt_initial, (T)alpha0,
                   (int64_t)n_min};
  const TestArgs t{};
  return launch_mode<T, true>(mode, v, f, n, red, work, scal, ints, overflow,
                              h, T(1), t, static_cast<cudaStream_t>(stream));
}

template <typename T>
int fire_test(const T* f, long long n, T* scal, int64_t* ints, T* red,
              T* work, long long work_len, const bool* overflow,
              const bool* drift, bool* flags, double sqrt_ndof, int mode,
              int entry, unsigned long long h_a, unsigned long long h_b,
              int set_a, int set_b, void* stream) {
  if (!known_mode(mode) || !scal || !ints || !red || !flags || n < 0 ||
      ((mode & (kMaxima | kSums)) &&
       (!f || !work || work_len < (long long)kPartials * reduce_grid(n))))
    return kErrArgs;
  const Hyper<T> h{};
  const TestArgs t{entry,
                   drift,
                   flags,
                   static_cast<cudaGraphConditionalHandle>(h_a),
                   static_cast<cudaGraphConditionalHandle>(h_b),
                   set_a,
                   set_b};
  return launch_mode<T, false>(mode, nullptr, f, n, red, work, scal, ints,
                               overflow, h, (T)sqrt_ndof, t,
                               static_cast<cudaStream_t>(stream));
}

template <typename T, int D>
int launch_move(bool wrap, T* x, T* v, const T* f, int64_t n, int64_t stride,
                int64_t* images, const T* cell, const T* cell_inv,
                const T* scal, const int64_t* ints, T dmax,
                const bool* overflow, cudaStream_t s) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMoveMaxBlocks ? kMoveMaxBlocks : blocks);
  if (wrap)
    fire_move_kernel<T, D, true><<<(int)blocks, kThreads, 0, s>>>(
        x, v, f, n, stride, images, cell, cell_inv, scal, ints, dmax,
        overflow);
  else
    fire_move_kernel<T, D, false><<<(int)blocks, kThreads, 0, s>>>(
        x, v, f, n, stride, images, cell, cell_inv, scal, ints, dmax,
        overflow);
  return (int)cudaGetLastError();
}

template <typename T>
int fire_move(T* x, T* v, const T* f, int dim, long long n, long long stride,
              int64_t* images, const T* cell, const T* cell_inv,
              const T* scal, const int64_t* ints, double dmax,
              const bool* overflow, void* stream) {
  const bool wrap = images != nullptr;
  if (!x || !v || !f || !scal || !ints || n < 0 || stride < 0 ||
      (dim != 2 && dim != 3) || (wrap && (stride || !cell || !cell_inv)) ||
      (stride && stride < n))
    return kErrArgs;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dim == 2 ? launch_move<T, 2>(wrap, x, v, f, n, stride, images, cell,
                                      cell_inv, scal, ints, (T)dmax,
                                      overflow, s)
                  : launch_move<T, 3>(wrap, x, v, f, n, stride, images, cell,
                                      cell_inv, scal, ints, (T)dmax,
                                      overflow, s);
}

}  // namespace

extern "C" {

// v, f: n values on the device (any layout: the reduction is over all of
// them); scal (7 T), ints (9 int64), red (5 T): the FIRE state and the
// reduction's buffer on the device; work: kPartials values a block of
// kPerBlock values; overflow: one bool on the device or
// null; mode: 7 one pass with the tail; on a shard ring 1 the maxima, 2
// the sums by red's maxima, 4 the tail from red.
int mdtpu_fire_reduce_f32(const float* v, const float* f, long long n,
                          float* scal, int64_t* ints, float* red, float* work,
                          long long work_len, const bool* overflow, int mode,
                          double f_inc, double f_dec, double dt_max,
                          double dt_initial, double alpha0, long long n_min,
                          void* stream) {
  return fire_reduce<float>(v, f, n, scal, ints, red, work, work_len,
                            overflow, mode, f_inc, f_dec, dt_max, dt_initial,
                            alpha0, n_min, stream);
}

int mdtpu_fire_reduce_f64(const double* v, const double* f, long long n,
                          double* scal, int64_t* ints, double* red,
                          double* work, long long work_len,
                          const bool* overflow, int mode, double f_inc,
                          double f_dec, double dt_max, double dt_initial,
                          double alpha0, long long n_min, void* stream) {
  return fire_reduce<double>(v, f, n, scal, ints, red, work, work_len,
                             overflow, mode, f_inc, f_dec, dt_max,
                             dt_initial, alpha0, n_min, stream);
}

// x, v, f: n particles of dim components, component-major slots (stride
// S >= n: component k of slot p at k S + p) or rows (stride 0: p dim + k);
// images (rows only, or null): (n, dim) int64, wrapped into with the cell
// and its inverse (row-major (dim, dim)); scal, ints, overflow as
// mdtpu_fire_reduce_f32's.
int mdtpu_fire_move_f32(float* x, float* v, const float* f, int dim,
                        long long n, long long stride, int64_t* images,
                        const float* cell, const float* cell_inv,
                        const float* scal, const int64_t* ints, double dmax,
                        const bool* overflow, void* stream) {
  return fire_move<float>(x, v, f, dim, n, stride, images, cell, cell_inv,
                          scal, ints, dmax, overflow, stream);
}

int mdtpu_fire_move_f64(double* x, double* v, const double* f, int dim,
                        long long n, long long stride, int64_t* images,
                        const double* cell, const double* cell_inv,
                        const double* scal, const int64_t* ints, double dmax,
                        const bool* overflow, void* stream) {
  return fire_move<double>(x, v, f, dim, n, stride, images, cell, cell_inv,
                           scal, ints, dmax, overflow, stream);
}

// f: n force values; red: the test's own 5 values; drift: the drift
// test's flag byte or null; flags (2 bools): the predicate and the
// predicate and the drift; entry 1: the step is not counted; h_a, h_b: a
// WHILE node's and an IF node's handles where set_a, set_b. The rest as
// mdtpu_fire_reduce_f32's.
int mdtpu_fire_test_f32(const float* f, long long n, float* scal,
                        int64_t* ints, float* red, float* work,
                        long long work_len, const bool* overflow,
                        const bool* drift, bool* flags, double sqrt_ndof,
                        int mode, int entry, unsigned long long h_a,
                        unsigned long long h_b, int set_a, int set_b,
                        void* stream) {
  return fire_test<float>(f, n, scal, ints, red, work, work_len, overflow,
                          drift, flags, sqrt_ndof, mode, entry, h_a, h_b,
                          set_a, set_b, stream);
}

int mdtpu_fire_test_f64(const double* f, long long n, double* scal,
                        int64_t* ints, double* red, double* work,
                        long long work_len, const bool* overflow,
                        const bool* drift, bool* flags, double sqrt_ndof,
                        int mode, int entry, unsigned long long h_a,
                        unsigned long long h_b, int set_a, int set_b,
                        void* stream) {
  return fire_test<double>(f, n, scal, ints, red, work, work_len, overflow,
                           drift, flags, sqrt_ndof, mode, entry, h_a, h_b,
                           set_a, set_b, stream);
}

const char* mdtpu_fire_update_error_string(int code) {
  if (code == kErrArgs) return "arguments outside what the kernel takes";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
