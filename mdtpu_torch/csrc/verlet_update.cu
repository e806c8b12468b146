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
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kErrArgs = -1;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

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

// kahan_add of utils/math.py: y = dx - c; t = x + y; c' = (t - x) - y.
template <typename T>
__device__ __forceinline__ void kahan(T& x, T& c, T dx) {
  const T y = dx - c;
  const T t = x + y;
  c = (t - x) - y;
  x = t;
}

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

const char* mdtpu_verlet_update_error_string(int code) {
  if (code == kErrArgs) return "arguments outside what the kernel takes";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
