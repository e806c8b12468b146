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
//     since the power turned negative. It runs in one pass (mode 7). The
//     sharded FIRE launches modes 1, 2 and 4 apart (the maxima, the sums
//     divided by the global maxima as the plain version divides, the
//     tail), the ring's all-reduces (max, then sum) of the small buffer red
//     between them, where the JAX package has pmax and psum.
//   * fire_move: per particle v' again (the same expression, so the same
//     bits), the mix (1 - alpha) v' + scale F where do_mix, zero where the
//     power was not positive, disp = dt v, the particle's max-scaled norm,
//     the dmax cap and the non-finite guards (fire.py:355-366), x += disp in
//     place; in particle rows also the periodic wrap with the images
//     (periodic_wrap.cuh, shared with verlet_update.cu's
//     kick_drift_wrap_kernel). Slots are component-major (d, S) and keep
//     the wrap for the rebin, as the JAX package's slot FIRE does. A
//     programmatic dependent of the kernel before it (see below).
//   * fire_test, after the sweep: f_rms = |F / fm_s| fm / sqrt(ndof)
//     (fire.py:299-302), step += 1 (not at the entry test), and the loop's
//     predicate step < max_steps & f_rms >= tol & ~overflow into a flag
//     byte and, inside a capture, the WHILE node's handle; a second handle
//     (the rebin's IF node in slots) takes the predicate and the drift
//     test's flag byte. max_steps and tol are read from the device, so one
//     graph serves every call.
//
// What bounds them on the H100. Bytes, in principle: at the bench_fire
// shape, slots (3, 124,875) float32 are 1.50 MB an array: fire_reduce reads
// v and F (3.0 MB, 0.89 us at 3.35 TB/s), fire_move reads x, v and F and
// writes x and v (7.5 MB, 2.24 us), fire_test reads F (1.5 MB, 0.45 us).
// In fact the two reductions are a chain of latencies (a launch, one round
// trip to memory, the block's combine, a ticket, the last block's combine,
// the tail on one thread), each near a microsecond. Their design
// (scaled_reduce_kernel, one template) shortens that chain:
//
//   * Each launches as a programmatic dependent of the kernel before it
//     (cudaLaunchKernelEx; Hopper's griddepcontrol.wait). Before the wait a
//     kernel reads only what the kernel just before it does not write: the
//     tail's scalars in scal and ints, which the same FIRE kernel wrote a
//     pass ago (fire_reduce reads dt, alpha and the steps since the power
//     turned negative; fire_test tol, f_rms, the step, max_steps and the
//     passes; neither writes what the other reads). The data, the
//     overflow flag, the drift test's flag and red are read after it, and
//     every store comes after it.
//   * One wave with all bytes in flight: a grid fixed by the count alone
//     (at least kMinVectors 16-byte vectors of each array a thread, at most
//     kMaxBlocks blocks; not by the card's SM count, so the order of the
//     sums, and their bits, do not depend on the card), each thread
//     loading kBatch vectors (float4, double2) of each array before any
//     arithmetic. A pointer that is not 16-byte aligned takes a scalar
//     head, a count that is not a whole number of vectors a scalar tail
//     (one value each for the first threads); v and F misaligned apart
//     take scalar loads throughout.
//   * One combine a level, no raw value squared: a thread scales its sums
//     by its own maxima, each value times the maximum's reciprocal (an
//     IEEE division is a subroutine of a few hundred cycles on the card;
//     one a value made a first try of this design take 12 us); a warp
//     takes the maxima across its lanes first (shuffles), brings each
//     lane's sums to them by (lane max / warp max)^2 (the cross sum by the
//     product of both ratios) and adds them; the block the same over its
//     warps (one __syncthreads), the last block the same over the blocks'
//     partials, in one warp. NaN is carried through the maxima (nan_max)
//     and the ratios.
//   * The ticket is an acquire-release fetch_add (cuda::atomic_ref) on the
//     first word of the run's own work buffer, so two FIRE runs on two
//     streams never share one; the last block puts it back to 0. A grid of
//     one block takes no ticket.
//   * The tail's operands sit in registers before the ticket (the scalars
//     read before the wait, the drift flag after it); the tail writes each
//     output once and reads back nothing it stored.
//
// The move has no sum: it is bound by its bytes (x, v and F read, x and v
// written; rows also read and write the int64 images), and its first
// design put two round trips to memory in front of them (the overflow
// flag, then the scalars, before any load of x, v or F) and launched in
// plain stream order. Its design (fire_move_slots_kernel,
// fire_move_rows_kernel; probe_torch_move.py measures each choice against
// the others, PERF.md section 6):
//
//   * It launches as a programmatic dependent of the kernel before it
//     (fire_reduce in the FIRE loops) and reads nothing before
//     griddepcontrol.wait, so any kernel may come before it. Loading x, v
//     and F (rows: the images and the box, in shared memory or in each
//     thread's registers) before the wait and the scalars after it was
//     measured and lost: the wait (SASS ACQBULK) holds a thread until its
//     own loads have landed, so the scalars' round trip followed the
//     data's instead of joining it.
//   * Slots: a slot a thread, one block each kThreads slots, a warp's
//     loads of a component one contiguous run; after the wait x, v, F, the
//     flag and the scalars are loaded together, one round trip. A thread
//     taking 16 bytes of each component row (where aligned) lost.
//   * Rows: a particle a thread on particle_rows.cuh's grid, fixed by the
//     count; the flag, the box (each thread its own copy) and the
//     scalars, then F, v and x, the step, the images after it, as the
//     first design ordered them (x loaded after the step was slower in
//     float32).
//   * The arithmetic of the first design, operation for operation: the
//     same bits.
//
// Sums. Every sum runs in a fixed order (a thread's values in index order,
// then fixed butterflies and a fixed order of partials), and there are no
// float atomics, so an eager run and a captured one give the same bits. The
// reductions are not held to the plain versions' bits (torch sums in
// another order), only within tolerance; the move is held to them bit for
// bit.
//
// Overflow. Where the slot state's sticky overflow flag is set (a rebin
// dropped rows), the three kernels leave everything as it is and the test
// ends the loop without counting a step: the run is retried from the start
// at a grown capacity, as the JAX package's loop ends on it.
//
// Built with -fmad=false, so every product and sum rounds as in the plain
// PyTorch versions (mdtpu_torch/minimize/fire_update.py).
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <vector>

#include "particle_rows.cuh"
#include "periodic_wrap.cuh"

namespace {

constexpr int kErrArgs = -1;
constexpr int kErrNotCapturing = -2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 128;     // the reductions' grid at most
constexpr int kMinVectors = 2;      // vectors of each array a thread at least
constexpr int kBatch = 8;           // vectors a thread loads before adding
constexpr int kPartials = 5;        // a block's partials in work
constexpr int kLanePartials = kMaxBlocks / 32;
constexpr unsigned kAll = 0xffffffffu;

// Mode bits of fire_reduce and fire_test.
constexpr int kMaxima = 1;
constexpr int kSums = 2;
constexpr int kTail = 4;
constexpr int kOnePass = kMaxima | kSums | kTail;

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

// max with NaN carried, as torch.max and jnp.max carry it.
template <typename T>
__device__ __forceinline__ T nan_max(T m, T a) {
  return (a > m || a != a) ? a : m;
}

template <typename T>
__device__ __forceinline__ T positive_or_one(T m) {
  return m > T(0) ? m : T(1);
}

// Waits until the kernel this one depends on programmatically has ended and
// its writes are visible (at once for a launch without the attribute).
__device__ __forceinline__ void wait_for_dependencies() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// A 16-byte vector of T: P values.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int P = 4;
  __device__ static void load(const float* p, int64_t i, float (&r)[4]) {
    const float4 w = __ldcg(reinterpret_cast<const float4*>(p) + i);
    r[0] = w.x;
    r[1] = w.y;
    r[2] = w.z;
    r[3] = w.w;
  }
};
template <>
struct Vec<double> {
  static constexpr int P = 2;
  __device__ static void load(const double* p, int64_t i, double (&r)[2]) {
    const double2 w = __ldcg(reinterpret_cast<const double2*>(p) + i);
    r[0] = w.x;
    r[1] = w.y;
  }
};

// Vector i of p: one 16-byte load where VEC, else P loads of one value.
template <typename T, bool VEC>
__device__ __forceinline__ void load_vector(const T* p, int64_t i,
                                            T (&r)[Vec<T>::P]) {
  if (VEC) {
    Vec<T>::load(p, i, r);
    return;
  }
#pragma unroll
  for (int k = 0; k < Vec<T>::P; ++k) r[k] = __ldcg(p + i * Vec<T>::P + k);
}

// The values a reduction covers: the first head of them (a misaligned
// pointer's) and the last tail one value a thread, the vectors between 16
// bytes a load (VEC) or P values.
struct Span {
  int64_t head, vectors, tail;
};

// Partials of a reduction: the maxima of |a| and |b| and the sums a b, a a
// and b b, each value divided by those maxima (1 where a maximum is 0).
template <typename T>
struct Part {
  T ma, mb, ab, aa, bb;
};

template <typename T, bool TWO>
__device__ __forceinline__ void max_into(Part<T>& p, const Part<T>& q) {
  if (TWO) p.ma = nan_max(p.ma, q.ma);
  p.mb = nan_max(p.mb, q.mb);
}

template <typename T, bool TWO>
__device__ __forceinline__ void add_into(Part<T>& p, const Part<T>& q) {
  if (TWO) {
    p.ab = p.ab + q.ab;
    p.aa = p.aa + q.aa;
  }
  p.bb = p.bb + q.bb;
}

// x / s as x times inv = 1 / s, computed once for many x (an IEEE division
// is a subroutine of some hundred cycles on the card: one for each value
// put the loads' wait behind a chain of them); the division itself where
// 1 / s is not finite (s below the smallest normal's reciprocal range).
template <typename T>
__device__ __forceinline__ T scaled(T x, T s, T inv) {
  return isinf(inv) ? x / s : x * inv;
}

// The divisors of a part's maxima (1 where a maximum is not positive) and
// their reciprocals.
template <typename T, bool TWO>
struct Scale {
  T sa, sb, ia, ib;
  __device__ __forceinline__ explicit Scale(const Part<T>& m) {
    sb = positive_or_one(m.mb);
    ib = T(1) / sb;
    sa = TWO ? positive_or_one(m.ma) : T(1);
    ia = TWO ? T(1) / sa : T(1);
  }
};

// p's sums, scaled by p's maxima, brought to the maxima of m (their
// Scale k): times (p's max / m's max)^2, the cross sum times the product
// of both ratios (p's max is 0 only where its sums are).
template <typename T, bool TWO>
__device__ __forceinline__ void rescale(Part<T>& p, const Part<T>& m,
                                        const Scale<T, TWO>& k) {
  const T rb = scaled(p.mb, k.sb, k.ib);
  p.bb = p.bb * rb * rb;
  if (TWO) {
    const T ra = scaled(p.ma, k.sa, k.ia);
    p.ab = p.ab * ra * rb;
    p.aa = p.aa * ra * ra;
  }
  p.ma = m.ma;
  p.mb = m.mb;
}

// The maxima (MAX) or the sums of the part of lane ^ off.
template <typename T, bool TWO, bool MAX>
__device__ __forceinline__ Part<T> shuffled(const Part<T>& p, int off) {
  Part<T> q{};
  if (MAX) {
    if (TWO) q.ma = __shfl_xor_sync(kAll, p.ma, off);
    q.mb = __shfl_xor_sync(kAll, p.mb, off);
  } else {
    if (TWO) {
      q.ab = __shfl_xor_sync(kAll, p.ab, off);
      q.aa = __shfl_xor_sync(kAll, p.aa, off);
    }
    q.bb = __shfl_xor_sync(kAll, p.bb, off);
  }
  return q;
}

// The combine of the parts of groups of 2 FROM lanes (a fixed butterfly):
// with LOCAL (each part scaled by its own maxima) the maxima first, each
// part brought to them, then the sums; without, the sums (every part
// scaled by the same maxima). Every lane of a group gets its result.
template <typename T, bool TWO, bool MAXIMA, bool SUMS, bool LOCAL, int FROM>
__device__ __forceinline__ void combine_lanes(Part<T>& p) {
  if (MAXIMA) {
    Part<T> m = p;
#pragma unroll
    for (int off = FROM; off > 0; off >>= 1)
      max_into<T, TWO>(m, shuffled<T, TWO, true>(m, off));
    if (SUMS && LOCAL) rescale<T, TWO>(p, m, Scale<T, TWO>(m));
    p.ma = m.ma;
    p.mb = m.mb;
  }
  if (SUMS) {
#pragma unroll
    for (int off = FROM; off > 0; off >>= 1)
      add_into<T, TWO>(p, shuffled<T, TWO, false>(p, off));
  }
}

// The tail's scalars, read before the wait: fire_reduce's dt, alpha and
// steps since the power turned negative; fire_test's tol, f_rms (kept where
// the overflow flag is set), step, max_steps and passes.
template <typename T>
struct TailScalars {
  T dt, alpha, tol, frms;
  int64_t ssn, step, max_steps, passes;
};

template <typename T, bool TWO>
__device__ __forceinline__ TailScalars<T> tail_scalars(const T* scal,
                                                       const int64_t* ints) {
  TailScalars<T> s{};
  if (TWO) {
    s.dt = scal[kDt];
    s.alpha = scal[kAlpha];
    s.ssn = ints[kSsn];
  } else {
    s.tol = scal[kTol];
    s.frms = scal[kFrms];
    s.step = ints[kStep];
    s.max_steps = ints[kMaxSteps];
    s.passes = ints[kPasses];
  }
  return s;
}

// FIRE's scalar tail (fire.py:330-353), from the global maxima and sums g,
// operation for operation as minimize/fire_update.py fire_tail_plain:
// scale = alpha (vmax_s / fmax_s) (vn / fn_s), the Python numbers rounded
// once to T (as torch rounds a Python number against a tensor). Each output
// written once.
template <typename T>
__device__ void fire_tail(const Part<T>& g, const TailScalars<T>& s,
                          T* scal, int64_t* ints, const Hyper<T>& h) {
  const T vmax = g.ma, fmax = g.mb;
  const T vmax_s = positive_or_one(vmax), fmax_s = positive_or_one(fmax);
  const T vn = sqrt(g.aa), fn = sqrt(g.bb);
  const bool do_mix = vmax > T(0) && fmax > T(0);
  const T dt = s.dt, alpha = s.alpha;
  const T scale = alpha * (vmax_s / fmax_s) * (vn / positive_or_one(fn));
  const bool positive = g.ab > T(0);
  const int64_t ssn_pos = s.ssn + 1;
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

struct TestArgs {
  int entry;
  const bool* drift;
  bool* flags;
  cudaGraphConditionalHandle h_a, h_b;
  int set_a, set_b;
};

// The loop's test (fire.py:299-302, :386-388 and :407-410) from the global
// max |F| and sum |F / fm_s|^2 in g: f_rms, the step, the predicate, its
// flag bytes and handles; drift: the drift test's flag (true without one).
template <typename T>
__device__ void test_tail(const Part<T>& g, bool ovf, bool drift,
                          const TailScalars<T>& s, T* scal, int64_t* ints,
                          T sqrt_ndof, const TestArgs& t) {
  if (!t.entry) ints[kPasses] = s.passes + 1;
  T f_rms = s.frms;
  int64_t step = s.step;
  if (!ovf) {
    f_rms = sqrt(g.bb) * g.mb / sqrt_ndof;
    scal[kFrms] = f_rms;
    if (!t.entry) {
      step = step + 1;
      ints[kStep] = step;
    }
  }
  const bool going = step < s.max_steps && f_rms >= s.tol && !ovf;
  const bool then = going && drift;
  ints[kConverged] = f_rms < s.tol && !ovf;
  ints[kOverflow] = ovf;
  t.flags[0] = going;
  t.flags[1] = then;
  if (t.set_a) cudaGraphSetConditional(t.h_a, going ? 1u : 0u);
  if (t.set_b) cudaGraphSetConditional(t.h_b, then ? 1u : 0u);
}

// A batch's max-scaled sums into part: vector j (index first + j
// threads) where below vectors, then the head or tail value where extra;
// each value times the maximum's reciprocal (DIV: divided by the maximum,
// where a reciprocal is not finite).
template <typename T, bool TWO, bool DIV, int P>
__device__ __forceinline__ void add_scaled(Part<T>& part,
                                           const T (&a)[kBatch][P],
                                           const T (&b)[kBatch][P], T ea,
                                           T eb, const Scale<T, TWO>& sc,
                                           int64_t first, int64_t threads,
                                           int64_t vectors, bool extra) {
#pragma unroll
  for (int j = 0; j <= kBatch; ++j) {
    if (j < kBatch ? first + j * threads >= vectors : !extra) continue;
#pragma unroll
    for (int q = 0; q < (j < kBatch ? P : 1); ++q) {
      const T bv = j < kBatch ? b[j][q] : eb;
      const T y = DIV ? bv / sc.sb : bv * sc.ib;
      if (TWO) {
        const T av = j < kBatch ? a[j][q] : ea;
        const T x = DIV ? av / sc.sa : av * sc.ia;
        part.ab = part.ab + x * y;
        part.aa = part.aa + x * x;
      }
      part.bb = part.bb + y * y;
    }
  }
}

// One thread's part of the reduction over span: fire_reduce's (TWO: a = v
// + dt F, b = F) or fire_test's (b = F). Thread t of block b takes, in
// batch k, vectors ((k kBatch + j) G + b) kThreads + t, j < kBatch, all
// loaded before any arithmetic, and in its first batch one value of the
// head or the tail (threads 0 .. head - 1 and P .. P + tail - 1 of the
// grid). Values past the span count as 0, which no maximum or sum sees.
// MAXIMA: the thread's maxima (else those of red, g); SUMS: the sums by
// them, batches merged by their maxima.
template <typename T, bool TWO, bool MAXIMA, bool SUMS, bool VEC>
__device__ Part<T> thread_part(const T* v, const T* f, const Span& span,
                               T dt, const Part<T>& g) {
  constexpr int P = Vec<T>::P;
  const int64_t threads = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t batches =
      (span.vectors + kBatch * threads - 1) / (kBatch * threads);
  int64_t extra = -1;
  if (tid < span.head)
    extra = tid;
  else if (tid >= P && tid < P + span.tail)
    extra = span.head + span.vectors * P + (tid - P);
  const T* fv = f + span.head;
  const T* vv = TWO ? v + span.head : nullptr;
  Part<T> run{};
  for (int64_t k = 0; k == 0 || k < batches; ++k) {
    T a[kBatch][P], b[kBatch][P];
    T ea = T(0), eb = T(0);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int64_t i = (k * kBatch + j) * threads + tid;
      if (i < span.vectors) {
        load_vector<T, VEC>(fv, i, b[j]);
        if (TWO) load_vector<T, VEC>(vv, i, a[j]);
      } else {
#pragma unroll
        for (int q = 0; q < P; ++q) a[j][q] = b[j][q] = T(0);
      }
    }
    if (k == 0 && extra >= 0) {
      eb = __ldcg(f + extra);
      if (TWO) ea = __ldcg(v + extra);
    }
    if (TWO) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int q = 0; q < P; ++q) a[j][q] = a[j][q] + dt * b[j][q];
      ea = ea + dt * eb;
    }
    Part<T> part{};
    if (MAXIMA) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int q = 0; q < P; ++q) {
          if (TWO) part.ma = nan_max(part.ma, fabs(a[j][q]));
          part.mb = nan_max(part.mb, fabs(b[j][q]));
        }
      if (TWO) part.ma = nan_max(part.ma, fabs(ea));
      part.mb = nan_max(part.mb, fabs(eb));
    } else {
      part.ma = g.ma;
      part.mb = g.mb;
    }
    if (SUMS) {
      const Scale<T, TWO> sc(part);
      const int64_t first = k * kBatch * threads + tid;
      const bool extra_here = k == 0 && extra >= 0;
      if (isinf(sc.ia) || isinf(sc.ib))
        add_scaled<T, TWO, true>(part, a, b, ea, eb, sc, first, threads,
                                 span.vectors, extra_here);
      else
        add_scaled<T, TWO, false>(part, a, b, ea, eb, sc, first, threads,
                                  span.vectors, extra_here);
    }
    // The first batch is the thread's part; a later one is merged in.
    if (k == 0) {
      run = part;
      continue;
    }
    if (MAXIMA && SUMS) {
      Part<T> m = run;
      max_into<T, TWO>(m, part);
      const Scale<T, TWO> sm(m);
      rescale<T, TWO>(run, m, sm);
      rescale<T, TWO>(part, m, sm);
    } else if (MAXIMA) {
      max_into<T, TWO>(run, part);
    }
    if (SUMS) add_into<T, TWO>(run, part);
  }
  return run;
}

// The reduction of fire_reduce (TWO) and of fire_test over span, by MODE
// bits: kMaxima the maxima, kSums the sums (with kMaxima by the threads'
// own maxima, brought to the global ones at each level; alone, by the
// global maxima in red), kTail the tail (alone: one block on red). work:
// the ticket (its first word) and kPartials values a block; VEC: 16-byte
// loads. A programmatic dependent: see the note at the head.
template <typename T, bool TWO, int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads)
    scaled_reduce_kernel(const T* __restrict__ v, const T* __restrict__ f,
                         Span span, T* red, T* work, T* scal, int64_t* ints,
                         const bool* overflow, Hyper<T> h, T sqrt_ndof,
                         TestArgs t) {
  constexpr bool MAXIMA = MODE & kMaxima, SUMS = MODE & kSums;
  constexpr bool TAIL = MODE & kTail;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Before the wait: what the kernel just before does not write.
  TailScalars<T> s{};
  if (TAIL && threadIdx.x == 0) s = tail_scalars<T, TWO>(scal, ints);
  const T dt = TWO && (MAXIMA || SUMS) ? scal[kDt] : T(0);
  wait_for_dependencies();
  const bool ovf = overflow != nullptr && *overflow;
  if (ovf) {
    // Nothing moves; the test ends the loop without a step.
    if (!TWO && TAIL && blockIdx.x == 0 && threadIdx.x == 0)
      test_tail<T>(Part<T>{}, true, true, s, scal, ints, sqrt_ndof, t);
    return;
  }
  const bool drift =
      !TWO && TAIL && threadIdx.x == 0 && t.drift ? *t.drift : true;
  Part<T> g{};
  if (!MAXIMA) {
    g.ma = TWO ? red[kMaxA] : T(0);
    g.mb = red[kMaxB];
  }
  if (!MAXIMA && !SUMS) {  // the tail alone, from red
    if (threadIdx.x != 0) return;
    g.ab = TWO ? red[kSumAB] : T(0);
    g.aa = TWO ? red[kSumAA] : T(0);
    g.bb = red[kSumBB];
    if (TWO)
      fire_tail<T>(g, s, scal, ints, h);
    else
      test_tail<T>(g, false, drift, s, scal, ints, sqrt_ndof, t);
    return;
  }
  Part<T> p = thread_part<T, TWO, MAXIMA, SUMS, VEC>(v, f, span, dt, g);
  // The warp, then the block by warp 0 over the warps' parts.
  combine_lanes<T, TWO, MAXIMA, SUMS, MAXIMA, 16>(p);
  __shared__ Part<T> warps[kWarps];
  if (lane == 0) warps[warp] = p;
  __syncthreads();
  if (warp != 0) return;
  p = lane < kWarps ? warps[lane] : Part<T>{};
  combine_lanes<T, TWO, MAXIMA, SUMS, MAXIMA, kWarps / 2>(p);
  const int grid = gridDim.x;
  if (grid > 1) {
    // Lane 0 hands the block's part on; the last block to take a ticket
    // combines them: lane l the blocks l, l + 32, ..., in that order.
    T* part = work + 1;
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> ticket(
        *reinterpret_cast<unsigned*>(work));
    bool last = false;
    if (lane == 0) {
      if (MAXIMA) {
        part[kMaxA * grid + blockIdx.x] = p.ma;
        part[kMaxB * grid + blockIdx.x] = p.mb;
      }
      if (SUMS) {
        part[kSumAB * grid + blockIdx.x] = p.ab;
        part[kSumAA * grid + blockIdx.x] = p.aa;
        part[kSumBB * grid + blockIdx.x] = p.bb;
      }
      // Release the partials; acquire every other block's.
      last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) ==
             (unsigned)grid - 1;
    }
    last = __shfl_sync(kAll, (int)last, 0) != 0;
    if (!last) return;
    __syncwarp();
    Part<T> q[kLanePartials];
    Part<T> m{};
    m.ma = g.ma;
    m.mb = g.mb;
#pragma unroll
    for (int i = 0; i < kLanePartials; ++i) {
      const int b = lane + 32 * i;
      q[i] = Part<T>{};
      if (b < grid) {
        q[i].ma = MAXIMA && TWO ? __ldcg(part + kMaxA * grid + b) : g.ma;
        q[i].mb = MAXIMA ? __ldcg(part + kMaxB * grid + b) : g.mb;
        if (SUMS) {
          q[i].ab = TWO ? __ldcg(part + kSumAB * grid + b) : T(0);
          q[i].aa = TWO ? __ldcg(part + kSumAA * grid + b) : T(0);
          q[i].bb = __ldcg(part + kSumBB * grid + b);
        }
      }
      if (MAXIMA) max_into<T, TWO>(m, q[i]);
    }
    if (MAXIMA) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        max_into<T, TWO>(m, shuffled<T, TWO, true>(m, off));
    }
    p = m;
    p.ab = p.aa = p.bb = T(0);
    if (SUMS) {
      const Scale<T, TWO> k(m);
#pragma unroll
      for (int i = 0; i < kLanePartials; ++i) {
        if (MAXIMA) rescale<T, TWO>(q[i], m, k);
        add_into<T, TWO>(p, q[i]);
      }
      combine_lanes<T, TWO, false, true, false, 16>(p);
    }
    if (lane == 0) ticket.store(0u, cuda::memory_order_relaxed);
  }
  if (lane != 0) return;
  if (MAXIMA) {
    if (TWO) red[kMaxA] = p.ma;
    red[kMaxB] = p.mb;
  }
  if (SUMS) {
    if (TWO) {
      red[kSumAB] = p.ab;
      red[kSumAA] = p.aa;
    }
    red[kSumBB] = p.bb;
  }
  if (TAIL) {
    if (TWO)
      fire_tail<T>(p, s, scal, ints, h);
    else
      test_tail<T>(p, false, drift, s, scal, ints, sqrt_ndof, t);
  }
}

// The scalars of a move: the kick's dt, the step's dt, the mix's two
// coefficients, do_mix and positive (fire_reduce's tail wrote them).
template <typename T>
struct MoveScalars {
  T dt_kick, dt, mix_v, mix_f;
  bool do_mix, positive;
  __device__ __forceinline__ MoveScalars(const T* scal, const int64_t* ints)
      : dt_kick(scal[kDtKick]),
        dt(scal[kDt]),
        mix_v(scal[kMixV]),
        mix_f(scal[kMixF]),
        do_mix(ints[kDoMix] != 0),
        positive(ints[kPositive] != 0) {}
};

// One particle's step (fire.py:355-366): v' = v + dt_kick F into v, the
// mix where do_mix, zero where the power was not positive, disp = dt v',
// the max-scaled norm and the dmax cap; returns the cap, by which the
// caller moves x (move_by). In the order of the torch composition, each
// operation rounded alone (-fmad=false): its bits.
template <typename T, int D>
__device__ __forceinline__ T capped_step(T (&v)[D], const T (&f)[D],
                                         const MoveScalars<T>& s, T dmax,
                                         T (&disp)[D]) {
  T m = T(0);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    T w = v[k] + s.dt_kick * f[k];
    if (s.do_mix) w = s.mix_v * w + s.mix_f * f[k];
    if (!s.positive) w = T(0);
    v[k] = w;
    disp[k] = s.dt * w;
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
  if (!isfinite(dnorm)) dnorm = T(INFINITY);
  // torch: dmax / t is reciprocal(t) * dmax; clamp(max=1).
  const T floor_norm = T(1e-30);
  const T r = T(1) / (dnorm < floor_norm ? floor_norm : dnorm);
  const T cap = r * dmax;
  return cap > T(1) ? T(1) : cap;
}

// x += the capped displacement, a non-finite component dropped.
template <typename T, int D>
__device__ __forceinline__ void move_by(T (&x)[D], const T (&disp)[D],
                                        T cap) {
#pragma unroll
  for (int k = 0; k < D; ++k)
    x[k] = x[k] + (isfinite(disp[k]) ? disp[k] * cap : T(0));
}

// The move of n slots, component k of slot p at k stride + p
// (component-major (D, S), stride S >= n): a slot a thread, kThreads a
// block, one block each kThreads slots. It waits first, then loads x, v,
// F, the overflow flag, the scalars and ints together (one round trip),
// and stores nothing where the flag is set.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fire_move_slots_kernel(T* x, T* v, const T* __restrict__ f, int64_t n,
                           int64_t stride, const T* scal,
                           const int64_t* ints, T dmax,
                           const bool* overflow) {
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  wait_for_dependencies();
  T xk[D], vk[D], fk[D], disp[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    xk[k] = x[k * stride + p];
    vk[k] = v[k * stride + p];
    fk[k] = f[k * stride + p];
  }
  const bool ovf = overflow != nullptr && *overflow;
  const MoveScalars<T> s(scal, ints);
  if (ovf) return;
  move_by<T, D>(xk, disp, capped_step<T, D>(vk, fk, s, dmax, disp));
#pragma unroll
  for (int k = 0; k < D; ++k) {
    x[k * stride + p] = xk[k];
    v[k * stride + p] = vk[k];
  }
}

// The move of n particle rows (row-major (n, D)), WRAP with the periodic
// wrap and the images: a particle a thread on particle_rows.cuh's grid
// (kRowsThreads a block, rows_grid(n) blocks, a thread taking a particle
// of each later tile beyond one wave), as the particle rows' other
// kernels. It waits first, then reads the overflow flag, the box (each
// thread its own copy) and the scalars, then a particle's F, v and x, its
// step and move, then its images and the wrap, in the first design's
// order.
template <typename T, int D, bool WRAP>
__global__ void __launch_bounds__(mdtpu::rows::kRowsThreads)
    fire_move_rows_kernel(T* x, T* v, const T* __restrict__ f, int64_t n,
                          int64_t* images, const T* cell, const T* cell_inv,
                          const T* scal, const int64_t* ints, T dmax,
                          const bool* overflow) {
  using mdtpu::rows::kRowsThreads;
  using mdtpu::rows::load_row;
  wait_for_dependencies();
  if (overflow != nullptr && *overflow) return;
  T c[D][D] = {}, ci[D][D] = {};
  if constexpr (WRAP) mdtpu::box::load_cell<T, D>(cell, cell_inv, c, ci);
  const MoveScalars<T> s(scal, ints);
  const int64_t stride = (int64_t)gridDim.x * kRowsThreads;
  for (int64_t i = (int64_t)blockIdx.x * kRowsThreads + threadIdx.x; i < n;
       i += stride) {
    T xk[D], vk[D], fk[D], disp[D];
    load_row<T, D>(f, i, fk);
    load_row<T, D>(v, i, vk);
    load_row<T, D>(x, i, xk);
    move_by<T, D>(xk, disp, capped_step<T, D>(vk, fk, s, dmax, disp));
    if constexpr (WRAP) {
      T unused[D];
      int64_t img[D];
      load_row<int64_t, D>(images, i, img);
      mdtpu::box::wrap<T, D, false>(xk, unused, img, c, ci);
#pragma unroll
      for (int k = 0; k < D; ++k) images[i * D + k] = img[k];
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      x[i * D + k] = xk[k];
      v[i * D + k] = vk[k];
    }
  }
}

// The reductions' grid over n values of T: at least kMinVectors vectors of
// each array a thread, at most kMaxBlocks blocks (by the count alone).
template <typename T>
int reduce_grid(int64_t n) {
  const int64_t per_block = (int64_t)kThreads * kMinVectors;
  const int64_t blocks = (n / Vec<T>::P + per_block - 1) / per_block;
  return (int)(blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks));
}

// The values of work a reduction over n values needs: the ticket's and
// kPartials a block.
template <typename T>
int64_t work_needed(int64_t n) {
  return 1 + (int64_t)kPartials * reduce_grid<T>(n);
}

// The span of n values at f (and v, where given), and whether its vectors
// take 16-byte loads: F's misaligned head, if v shares it, else none.
template <typename T>
bool plan_span(const T* v, const T* f, int64_t n, Span& span) {
  constexpr int P = Vec<T>::P;
  const uintptr_t at = reinterpret_cast<uintptr_t>(f);
  const bool vec = !v || (reinterpret_cast<uintptr_t>(v) - at) % 16 == 0;
  int64_t head = vec ? (int64_t)((16 - at % 16) % 16 / sizeof(T)) : 0;
  head = head < n ? head : n;
  span.head = head;
  span.vectors = (n - head) / P;
  span.tail = n - head - span.vectors * P;
  return vec;
}

// A launch of grid blocks of block threads on s with
// cudaLaunchAttributeProgrammaticStreamSerialization: a programmatic
// dependent of the kernel before it on the stream.
template <typename... Params, typename... Args>
int launch_ex(void (*kernel)(Params...), int grid, int block, cudaStream_t s,
              Args... args) {
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)block);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, args...);
  return rc ? (int)rc : (int)cudaGetLastError();
}

template <typename T, bool TWO>
using ReduceKernel = void (*)(const T*, const T*, Span, T*, T*, T*, int64_t*,
                              const bool*, Hyper<T>, T, TestArgs);

// The kernel of a mode (one pass, or on a shard ring the maxima, the sums,
// the tail) and load width; null for an unknown mode.
template <typename T, bool TWO>
ReduceKernel<T, TWO> kernel_of(int mode, bool vec) {
  switch (mode) {
    case kOnePass:
      return vec ? scaled_reduce_kernel<T, TWO, kOnePass, true>
                 : scaled_reduce_kernel<T, TWO, kOnePass, false>;
    case kMaxima:
      return vec ? scaled_reduce_kernel<T, TWO, kMaxima, true>
                 : scaled_reduce_kernel<T, TWO, kMaxima, false>;
    case kSums:
      return vec ? scaled_reduce_kernel<T, TWO, kSums, true>
                 : scaled_reduce_kernel<T, TWO, kSums, false>;
    case kTail:
      return scaled_reduce_kernel<T, TWO, kTail, true>;
    default:
      return nullptr;
  }
}

template <typename T, bool TWO>
int launch_reduce(int mode, const T* v, const T* f, int64_t n, T* red,
                  T* work, long long work_len, T* scal, int64_t* ints,
                  const bool* overflow, const Hyper<T>& h, T sqrt_ndof,
                  const TestArgs& t, cudaStream_t s) {
  const bool data = (mode & (kMaxima | kSums)) != 0;
  if (!scal || !ints || !red || n < 0 ||
      (data && (!f || (TWO && !v) || !work ||
                work_len < work_needed<T>(n))))
    return kErrArgs;
  Span span{};
  const bool vec = data ? plan_span<T>(TWO ? v : nullptr, f, n, span) : true;
  const ReduceKernel<T, TWO> kernel = kernel_of<T, TWO>(mode, vec);
  if (!kernel) return kErrArgs;
  return launch_ex(kernel, data ? reduce_grid<T>(n) : 1, kThreads, s, v, f,
                   span, red, work, scal, ints, overflow, h, sqrt_ndof, t);
}

template <typename T>
int fire_reduce(const T* v, const T* f, long long n, T* scal, int64_t* ints,
                T* red, T* work, long long work_len, const bool* overflow,
                int mode, double f_inc, double f_dec, double dt_max,
                double dt_initial, double alpha0, long long n_min,
                void* stream) {
  const Hyper<T> h{(T)f_inc, (T)f_dec, (T)dt_max, (T)dt_initial, (T)alpha0,
                   (int64_t)n_min};
  return launch_reduce<T, true>(mode, v, f, n, red, work, work_len, scal,
                                ints, overflow, h, T(1), TestArgs{},
                                static_cast<cudaStream_t>(stream));
}

template <typename T>
int fire_test(const T* f, long long n, T* scal, int64_t* ints, T* red,
              T* work, long long work_len, const bool* overflow,
              const bool* drift, bool* flags, double sqrt_ndof, int mode,
              int entry, unsigned long long h_a, unsigned long long h_b,
              int set_a, int set_b, void* stream) {
  if (!flags) return kErrArgs;
  const TestArgs t{entry,
                   drift,
                   flags,
                   static_cast<cudaGraphConditionalHandle>(h_a),
                   static_cast<cudaGraphConditionalHandle>(h_b),
                   set_a,
                   set_b};
  return launch_reduce<T, false>(mode, nullptr, f, n, red, work, work_len,
                                 scal, ints, overflow, Hyper<T>{},
                                 (T)sqrt_ndof, t,
                                 static_cast<cudaStream_t>(stream));
}

// Whether func is one of the reductions' kernels (TWO: fire_reduce's).
template <bool TWO>
bool reduce_kernel(const void* func) {
  for (int mode : {kOnePass, kMaxima, kSums, kTail})
    for (bool vec : {true, false})
      if (func == (const void*)kernel_of<float, TWO>(mode, vec) ||
          func == (const void*)kernel_of<double, TWO>(mode, vec))
        return true;
  return false;
}

// The slots' grid: one block each kThreads slots.
int slots_grid(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 1 ? 1 : blocks);
}

template <typename T, int D>
int launch_move(bool rows, bool wrap, T* x, T* v, const T* f, int64_t n,
                int64_t stride, int64_t* images, const T* cell,
                const T* cell_inv, const T* scal, const int64_t* ints,
                T dmax, const bool* overflow, cudaStream_t s) {
  if (!rows)
    return launch_ex(fire_move_slots_kernel<T, D>, slots_grid(n), kThreads,
                     s, x, v, f, n, stride, scal, ints, dmax, overflow);
  const int grid = mdtpu::rows::rows_grid(n);
  constexpr int block = mdtpu::rows::kRowsThreads;
  if (wrap)
    return launch_ex(fire_move_rows_kernel<T, D, true>, grid, block, s, x,
                     v, f, n, images, cell, cell_inv, scal, ints, dmax,
                     overflow);
  return launch_ex(fire_move_rows_kernel<T, D, false>, grid, block, s, x, v,
                   f, n, images, cell, cell_inv, scal, ints, dmax, overflow);
}

template <typename T>
int fire_move(T* x, T* v, const T* f, int dim, long long n, long long stride,
              int64_t* images, const T* cell, const T* cell_inv,
              const T* scal, const int64_t* ints, double dmax,
              const bool* overflow, void* stream) {
  const bool wrap = images != nullptr, rows = stride == 0;
  if (!x || !v || !f || !scal || !ints || n < 0 || stride < 0 ||
      (dim != 2 && dim != 3) || (wrap && (!rows || !cell || !cell_inv)) ||
      (!rows && stride < n))
    return kErrArgs;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dim == 2 ? launch_move<T, 2>(rows, wrap, x, v, f, n, stride, images,
                                      cell, cell_inv, scal, ints, (T)dmax,
                                      overflow, s)
                  : launch_move<T, 3>(rows, wrap, x, v, f, n, stride, images,
                                      cell, cell_inv, scal, ints, (T)dmax,
                                      overflow, s);
}

// Whether func is one of the move's kernels.
template <typename T>
bool move_kernel_of(const void* func) {
  const void* kernels[] = {
      (const void*)fire_move_slots_kernel<T, 2>,
      (const void*)fire_move_slots_kernel<T, 3>,
      (const void*)fire_move_rows_kernel<T, 2, true>,
      (const void*)fire_move_rows_kernel<T, 2, false>,
      (const void*)fire_move_rows_kernel<T, 3, true>,
      (const void*)fire_move_rows_kernel<T, 3, false>};
  for (const void* k : kernels)
    if (func == k) return true;
  return false;
}

bool move_kernel(const void* func) {
  return move_kernel_of<float>(func) || move_kernel_of<double>(func);
}

}  // namespace

extern "C" {

// v, f: n values on the device (any layout: the reduction is over all of
// them; any alignment, 16-byte loads where both share F's); scal (7 T),
// ints (9 int64), red (5 T): the FIRE state and the reduction's buffer on
// the device; work: work_len >= mdtpu_fire_grid(n) values (zeros at
// first; the ticket and the blocks' partials); overflow: one bool on the
// device or null; mode: 7 one pass with the tail; on a shard ring 1 the
// maxima, 2 the sums by red's maxima, 4 the tail from red.
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
// mdtpu_fire_reduce_f32's. Launched as a programmatic dependent of the
// kernel before it (it reads nothing before the wait).
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

// The grid of a reduction over n values of itemsize bytes (4 or 8): out[0]
// its blocks, out[1] the values of one 16-byte vector, out[2] the most
// values one block takes before the grid grows, out[3] the most values
// whose threads load all theirs in one batch (one wave). Returns the
// values of work it needs; -1 for another itemsize.
long long mdtpu_fire_grid(long long n, int itemsize, long long* out) {
  if (itemsize != 4 && itemsize != 8) return -1;
  const long long vec = 16 / itemsize;
  out[0] = itemsize == 4 ? reduce_grid<float>(n) : reduce_grid<double>(n);
  out[1] = vec;
  out[2] = (long long)kThreads * kMinVectors * vec;
  out[3] = (long long)kMaxBlocks * kThreads * kBatch * vec;
  return itemsize == 4 ? work_needed<float>(n) : work_needed<double>(n);
}

// The programmatic edges of the graph being captured on stream that enter
// a fire_reduce node (out[0]), a fire_test node (out[1]) and a fire_move
// node (out[3]), and the error code of the edges' read (out[2]; where not
// 0, out[0], out[1] and out[3] are -1).
// Only this library's runtime knows its kernels' addresses, so the count
// is made here.
int mdtpu_fire_update_census(void* stream, long long* out) {
  out[0] = out[1] = out[2] = out[3] = 0;
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
    out[0] = out[1] = out[3] = -1;
    out[2] = (long long)rc;
    return 0;
  }
  for (size_t e = 0; e < ne; ++e) {
    if (data[e].type != cudaGraphDependencyTypeProgrammatic) continue;
    cudaKernelNodeParams p;
    if (cudaGraphKernelNodeGetParams(to[e], &p) != cudaSuccess) {
      cudaGetLastError();
    } else if (reduce_kernel<true>(p.func)) {
      ++out[0];
    } else if (reduce_kernel<false>(p.func)) {
      ++out[1];
    } else if (move_kernel(p.func)) {
      ++out[3];
    }
  }
  return 0;
}

const char* mdtpu_fire_update_error_string(int code) {
  if (code == kErrArgs) return "arguments outside what the kernel takes";
  if (code == kErrNotCapturing) return "the stream is not capturing";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
