// The slot step's random draws and its rebuild test, as kernels that read
// the step from device memory, for NVIDIA Hopper (sm_90a); and the
// conditional node through which a captured slot step rebins.
//
// The JAX package runs a whole segment of the slot loop as one device
// program (mdtpu/integrate/slot_step.py:610-691 make_slot_advance): the
// step counter, the draws and the rebuild decision never leave the device.
// These kernels let the port do the same inside a CUDA graph that is
// replayed once a step (mdtpu_torch/integrate/slot_step.py SlotAdvance):
//
//   * bussi_draw ports mdtpu/integrate/thermostat.py:43-50 sum_noises and
//     :59-61 (XLA's jax.random.normal and jax.random.gamma; no
//     pl.pallas_call): Bussi's r1 ~ N(0, 1) and r2 = 2 Gamma((nf - 1)/2),
//     chi-squared with nf - 1 degrees of freedom (0 where nf - 1 <= 0).
//     One thread, in float64, cast to the state's dtype: r1 by Box-Muller
//     (cos branch) from block 0; the gamma variate by Marsaglia and Tsang
//     (2000), attempt t taking its normal from block 1 + 2t and its
//     acceptance uniform from words 0-1 of block 2 + 2t; for a < 1 the
//     variate of a + 1 times u^(1/a), u from words 2-3 of the accepting
//     block. At most kGammaAttempts attempts (each accepts with
//     probability above 0.95; none accepting leaves d, the same in the
//     plain version). Counter (block, step lo, step hi, 0), key the seed's
//     two words. Bound: latency (one thread, a few hundred dependent
//     operations); it replaces 196,604 normals and a sum a step at 65,536
//     particles.
//   * uniform_noise ports mdtpu/integrate/step.py:110-119 brownian_noise
//     (XLA's jax.random.uniform): the (d, S) variance-matched uniforms
//     (2u - 1) sqrt(3), element e of the flattened array from block
//     e / 4 (float32: word e % 4, its top 24 bits) or e / 2 (float64: 53
//     bits of two words), counter (block, step lo, step hi, 1 | rank << 8).
//     The arithmetic is integer and exactly rounded (2u - 1 is exact, one
//     rounding in the product), so it equals its plain version bit for
//     bit. Bound: the write of (d, S) values; a thread makes one block of
//     words and stores it as one 16-byte vector.
//   * rebuild_flag ports mdtpu/integrate/slot_step.py:460 slot_needs_rebin
//     (the drift test): one pass over positions and ref_positions (d, S),
//     d2 = sum_k (x_k - ref_k)^2 in component order, flag = any(d2 > (T)
//     thr), written as one byte (a bool tensor, which the conditional node
//     reads). Bound: the two (d, S) reads. A block ORs its threads' tests
//     (__syncthreads_or) and one thread stores; the flag is zeroed by a
//     memset first.
//   * philox_words: the generator's words for given counters and keys,
//     for the known-answer checks on the card.
//   * graph_if_begin / graph_if_end: an IF conditional node (CUDA 12.4+)
//     in the graph being captured on a stream, for torch versions without
//     CUDAGraph.begin_capture_to_if_node. A one-thread kernel node sets
//     the node's handle from the flag byte at each replay; the caller then
//     captures the body on a second stream into the node's child graph and
//     ends that capture. The decision stays on the device.
//
// Built with -fmad=false, so every product and sum rounds as in the plain
// PyTorch versions (mdtpu_torch/ops/philox_draws.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using mdtpu::philox::counter;
using mdtpu::philox::philox4x32_10;
using mdtpu::philox::u24;
using mdtpu::philox::u53;

constexpr int kErrArgs = -1;
constexpr int kErrNotCapturing = -2;
constexpr int kGammaAttempts = 32;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr double kTwoPi = 6.283185307179586;  // 2 * math.pi
constexpr double kSqrt3 = 1.7320508075688772;  // math.sqrt(3)

// A standard normal from one block of words: sqrt(-2 log u1) cos(2 pi u2),
// u1 in (0, 1] from words 0-1, u2 in [0, 1) from words 2-3.
__device__ double box_muller(uint4 w) {
  const double u1 = 1.0 - u53(w.x, w.y);
  const double u2 = u53(w.z, w.w);
  return sqrt(-2.0 * log(u1)) * cos(kTwoPi * u2);
}

template <typename T>
__global__ void bussi_draw_kernel(const int64_t* step, uint2 key, double dof,
                                  T* out) {
  const int64_t s = *step;
  const double r1 = box_muller(philox4x32_10(counter(0, s, 0), key));
  double r2 = 0.0;
  if (dof > 0.0) {
    const double a = 0.5 * dof;
    const bool boost = a < 1.0;
    const double d = (boost ? a + 1.0 : a) - 1.0 / 3.0;
    const double c = 1.0 / sqrt(9.0 * d);
    double g = d, ub = 1.0;
    for (int t = 0; t < kGammaAttempts; ++t) {
      const double x =
          box_muller(philox4x32_10(counter(1 + 2 * t, s, 0), key));
      const uint4 w = philox4x32_10(counter(2 + 2 * t, s, 0), key);
      const double cx = 1.0 + c * x;
      const double v = cx * cx * cx;
      const double u = 1.0 - u53(w.x, w.y);
      if (v > 0.0 && log(u) < 0.5 * x * x + d - d * v + d * log(v)) {
        g = d * v;
        ub = 1.0 - u53(w.z, w.w);
        break;
      }
    }
    if (boost) g = g * pow(ub, 1.0 / a);
    r2 = 2.0 * g;
  }
  out[0] = static_cast<T>(r1);
  out[1] = static_cast<T>(r2);
}

__global__ void uniform_noise_f32_kernel(const int64_t* step, uint2 key,
                                         uint32_t stream, int64_t n,
                                         float* out) {
  const int64_t s = *step;
  const float sqrt3 = static_cast<float>(kSqrt3);
  const int64_t blocks = (n + 3) / 4;
  for (int64_t b = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       b < blocks; b += (int64_t)gridDim.x * blockDim.x) {
    const uint4 w = philox4x32_10(counter((uint32_t)b, s, stream), key);
    const float v0 = (2.0f * u24(w.x) - 1.0f) * sqrt3;
    const float v1 = (2.0f * u24(w.y) - 1.0f) * sqrt3;
    const float v2 = (2.0f * u24(w.z) - 1.0f) * sqrt3;
    const float v3 = (2.0f * u24(w.w) - 1.0f) * sqrt3;
    const int64_t e = 4 * b;
    if (e + 3 < n) {
      reinterpret_cast<float4*>(out)[b] = make_float4(v0, v1, v2, v3);
    } else {
      out[e] = v0;
      if (e + 1 < n) out[e + 1] = v1;
      if (e + 2 < n) out[e + 2] = v2;
    }
  }
}

__global__ void uniform_noise_f64_kernel(const int64_t* step, uint2 key,
                                         uint32_t stream, int64_t n,
                                         double* out) {
  const int64_t s = *step;
  const int64_t blocks = (n + 1) / 2;
  for (int64_t b = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       b < blocks; b += (int64_t)gridDim.x * blockDim.x) {
    const uint4 w = philox4x32_10(counter((uint32_t)b, s, stream), key);
    const double v0 = (2.0 * u53(w.x, w.y) - 1.0) * kSqrt3;
    const double v1 = (2.0 * u53(w.z, w.w) - 1.0) * kSqrt3;
    const int64_t e = 2 * b;
    if (e + 1 < n) {
      reinterpret_cast<double2*>(out)[b] = make_double2(v0, v1);
    } else {
      out[e] = v0;
    }
  }
}

template <typename T>
__global__ void rebuild_flag_kernel(const T* pos, const T* ref, int dim,
                                    int64_t n, T thr, bool* flag) {
  bool any = false;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    T dk = pos[i] - ref[i];
    T d2 = dk * dk;
    for (int k = 1; k < dim; ++k) {
      dk = pos[k * n + i] - ref[k * n + i];
      d2 = d2 + dk * dk;
    }
    any = any || d2 > thr;
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) *flag = true;
}

__global__ void philox_words_kernel(const uint4* ctr, const uint2* key,
                                    uint4* out, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = philox4x32_10(ctr[i], key[i]);
}

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

int grid_for(int64_t items) {
  const int64_t blocks = (items + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1) : kMaxBlocks);
}

template <typename T>
int bussi_draw(const int64_t* step, unsigned k0, unsigned k1, double dof,
               T* out, void* stream) {
  if (!step || !out) return kErrArgs;
  bussi_draw_kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      step, make_uint2(k0, k1), dof, out);
  return (int)cudaGetLastError();
}

template <typename T>
int rebuild_flag(const T* pos, const T* ref, int dim, long long n,
                 double thr, bool* flag, void* stream) {
  if (!pos || !ref || !flag || dim < 1 || dim > 3 || n < 0) return kErrArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(flag, 0, 1, s);
  if (rc) return (int)rc;
  if (n == 0) return 0;
  rebuild_flag_kernel<T><<<grid_for(n), kThreads, 0, s>>>(
      pos, ref, dim, (int64_t)n, static_cast<T>(thr), flag);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// step: one int64 on the device; k0, k1: the seed's low and high words;
// dof = nf - 1; out: (2,) on the device, r1 then r2.
int mdtpu_bussi_draw_f32(const int64_t* step, unsigned k0, unsigned k1,
                         double dof, float* out, void* stream) {
  return bussi_draw<float>(step, k0, k1, dof, out, stream);
}

int mdtpu_bussi_draw_f64(const int64_t* step, unsigned k0, unsigned k1,
                         double dof, double* out, void* stream) {
  return bussi_draw<double>(step, k0, k1, dof, out, stream);
}

// out: n values on the device, 16-byte aligned; stream_word: 1 | rank << 8.
int mdtpu_uniform_noise_f32(const int64_t* step, unsigned k0, unsigned k1,
                            unsigned stream_word, long long n, float* out,
                            void* stream) {
  if (!step || !out || n < 0 || (n + 3) / 4 > 0xFFFFFFFFLL) return kErrArgs;
  if (n == 0) return 0;
  const int64_t blocks = (n + 3) / 4;
  uniform_noise_f32_kernel<<<grid_for(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      step, make_uint2(k0, k1), stream_word, (int64_t)n, out);
  return (int)cudaGetLastError();
}

int mdtpu_uniform_noise_f64(const int64_t* step, unsigned k0, unsigned k1,
                            unsigned stream_word, long long n, double* out,
                            void* stream) {
  if (!step || !out || n < 0 || (n + 1) / 2 > 0xFFFFFFFFLL) return kErrArgs;
  if (n == 0) return 0;
  const int64_t blocks = (n + 1) / 2;
  uniform_noise_f64_kernel<<<grid_for(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      step, make_uint2(k0, k1), stream_word, (int64_t)n, out);
  return (int)cudaGetLastError();
}

// pos, ref: (dim, n) row-major on the device; flag: one bool on the device.
int mdtpu_rebuild_flag_f32(const float* pos, const float* ref, int dim,
                           long long n, double thr, bool* flag,
                           void* stream) {
  return rebuild_flag<float>(pos, ref, dim, n, thr, flag, stream);
}

int mdtpu_rebuild_flag_f64(const double* pos, const double* ref, int dim,
                           long long n, double thr, bool* flag,
                           void* stream) {
  return rebuild_flag<double>(pos, ref, dim, n, thr, flag, stream);
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

// stream: capturing; flag: one bool on the device; body_stream: idle. On
// success body_stream captures into the IF node's body until
// mdtpu_graph_if_end.
int mdtpu_graph_if_begin(void* stream, const bool* flag, void* body_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t rc =
      cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (rc) return (int)rc;
  if (status != cudaStreamCaptureStatusActive) return kErrNotCapturing;
  cudaGraphConditionalHandle handle;
  rc = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (rc) return (int)rc;
  set_if_kernel<<<1, 1, 0, s>>>(handle, flag);
  rc = cudaGetLastError();
  if (rc) return (int)rc;
  rc = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (rc) return (int)rc;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  rc = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (rc) return (int)rc;
  rc = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                           cudaStreamSetCaptureDependencies);
  if (rc) return (int)rc;
  return (int)cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed);
}

int mdtpu_graph_if_end(void* body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream),
                                   &body);
}

const char* mdtpu_philox_draws_error_string(int code) {
  switch (code) {
    case kErrArgs: return "arguments outside what the kernel takes";
    case kErrNotCapturing: return "the stream is not capturing a graph";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
