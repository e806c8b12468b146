#!/usr/bin/env python3
"""FIRE's move against other designs of it on one NVIDIA GPU: variants of
``mdtpu_torch/csrc/fire_update.cu`` built apart from the package (the
package has no switch for them), and another tree's source.

    python3 probe_torch_move.py [--parent DIR] [--case NAME] [--turns 1]
                                [--calls 100] [--out FILE]

The package's move waits first (griddepcontrol.wait) and then loads what it
reads (``package``), launched as a programmatic dependent of the kernel
before it. ``plain_order`` is the package's source with its launches
stamped to plain stream order (no programmatic attribute: the move's and
the reduction's). The variants, each a kernel of its own added to the
package's source and launched in its place:

  * ``data_first``: x, v and F (rows: and the images, and the box into
    shared memory by the block's first threads, then a barrier) loaded
    before the wait, the overflow flag, the scalars and ints after it;
  * ``data_first_register_box``: the same with each thread loading the
    box into its registers (no shared memory, no barrier);
  * ``vector`` (slots): a thread takes 16 bytes of each component row (4
    float32 or 2 float64 slots: one ``float4`` or ``double2`` load of x,
    v and F each a component, the same stores), taken where the rows are
    16-byte aligned (the slot count a multiple of the vector's values and
    the three pointers aligned), the package's kernel elsewhere;

  * ``x_late`` (rows): x loaded after the step (v and F, the step, then
    x and the move, then the images);
  * ``first_design_waiting`` (rows): the first design's kernel as it was
    (its own arithmetic, written out), waiting first, on the rows' grid;
  * ``interleaved`` (rows): the package's rows kernel loading a
    particle's F, v and x component by component (the first design's
    order of loads) instead of F's row, then v's, then x's;

and ``--parent``'s source (its own design: the move in plain stream
order). Every variant does each particle's arithmetic as the package
does. Cases (``--case`` picks one): bench_fire's slots (3, 124,875: odd,
so rows 1 and 2 are not aligned and ``vector`` takes the package's
kernel) and one slot more (3, 124,876: aligned), and particle rows
(65,536, 3) with the wrap in a tilted box of 40.3; f32 and f64. Each build
is timed alone (``alone``) and after a reduction in one pass into its
scalars (``after_reduce``: the FIRE loops' order), each its own way of
launching: a graph of ``--calls`` in-place calls (pairs) replayed 20
times between CUDA events (the median of 5 rounds), in turns (each build,
then each again in the reverse order; ``--turns`` such rounds); the
outputs of one call from the same start (positions, velocities, images)
are compared bit for bit between the builds. One JSON line a case, then
the card's name and power limit; ``--out`` keeps the lines (default
``out_probe/probe_torch_move.jsonl``, ignored by git).
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import probe_torch_fire  # noqa: E402

# Cases: (name, shape, rows, the builds compared).
CASES = (("bench_fire", (3, 124875), False,
          ("package", "plain_order", "data_first", "vector", "parent")),
         ("aligned", (3, 124876), False, ("package", "data_first", "vector")),
         ("rows", (65536, 3), True,
          ("package", "plain_order", "data_first", "data_first_register_box",
           "x_late", "first_design_waiting", "interleaved", "parent")))

DATA_FIRST_KERNELS = r"""
// The move with its data loaded before the wait (x, v, F; rows: the
// images, and the box into shared memory or, without SHARED_BOX, into
// each thread's registers), the flag and the scalars after it.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fire_move_slots_first_kernel(T* x, T* v, const T* __restrict__ f,
                                 int64_t n, int64_t stride, const T* scal,
                                 const int64_t* ints, T dmax,
                                 const bool* overflow) {
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  T xk[D], vk[D], fk[D], disp[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    xk[k] = x[k * stride + p];
    vk[k] = v[k * stride + p];
    fk[k] = f[k * stride + p];
  }
  wait_for_dependencies();
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

template <typename T, int D, bool WRAP, bool SHARED_BOX>
__global__ void __launch_bounds__(mdtpu::rows::kRowsThreads)
    fire_move_rows_first_kernel(T* x, T* v, const T* __restrict__ f,
                                int64_t n, int64_t* images, const T* cell,
                                const T* cell_inv, const T* scal,
                                const int64_t* ints, T dmax,
                                const bool* overflow) {
  using mdtpu::rows::kRowsThreads;
  using mdtpu::rows::load_row;
  __shared__ T box[2 * D * D];
  T c[D][D] = {}, ci[D][D] = {};
  if constexpr (WRAP) {
    if constexpr (SHARED_BOX) {
      if (threadIdx.x < 2 * D * D)
        box[threadIdx.x] = threadIdx.x < D * D
                               ? cell[threadIdx.x]
                               : cell_inv[threadIdx.x - D * D];
    } else {
      mdtpu::box::load_cell<T, D>(cell, cell_inv, c, ci);
    }
  }
  const int64_t stride = (int64_t)gridDim.x * kRowsThreads;
  int64_t i = (int64_t)blockIdx.x * kRowsThreads + threadIdx.x;
  T xk[D], vk[D], fk[D], disp[D];
  int64_t img[D] = {};
  if (i < n) {
    load_row<T, D>(x, i, xk);
    load_row<T, D>(v, i, vk);
    load_row<T, D>(f, i, fk);
    if constexpr (WRAP) load_row<int64_t, D>(images, i, img);
  }
  if constexpr (WRAP && SHARED_BOX) __syncthreads();
  wait_for_dependencies();
  const bool ovf = overflow != nullptr && *overflow;
  const MoveScalars<T> s(scal, ints);
  if (ovf) return;
  if constexpr (WRAP && SHARED_BOX) {
#pragma unroll
    for (int k = 0; k < D; ++k)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        c[k][j] = box[k * D + j];
        ci[k][j] = box[D * D + k * D + j];
      }
  }
  for (bool first = true; i < n; i += stride, first = false) {
    if (!first) {
      load_row<T, D>(x, i, xk);
      load_row<T, D>(v, i, vk);
      load_row<T, D>(f, i, fk);
      if constexpr (WRAP) load_row<int64_t, D>(images, i, img);
    }
    move_by<T, D>(xk, disp, capped_step<T, D>(vk, fk, s, dmax, disp));
    if constexpr (WRAP) {
      T unused[D];
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

"""

# The rows' move with x loaded after the step (v and F, the step, then x
# and the move, then the images).
X_LATE_KERNEL = r"""
template <typename T, int D, bool WRAP>
__global__ void __launch_bounds__(mdtpu::rows::kRowsThreads)
    fire_move_rows_late_kernel(T* x, T* v, const T* __restrict__ f,
                               int64_t n, int64_t* images, const T* cell,
                               const T* cell_inv, const T* scal,
                               const int64_t* ints, T dmax,
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
    load_row<T, D>(v, i, vk);
    load_row<T, D>(f, i, fk);
    const T cap = capped_step<T, D>(vk, fk, s, dmax, disp);
    load_row<T, D>(x, i, xk);
    move_by<T, D>(xk, disp, cap);
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

"""
# The package's rows kernel with a particle's F, v and x loaded component
# by component.
INTERLEAVED_KERNEL = r"""
template <typename T, int D, bool WRAP>
__global__ void __launch_bounds__(mdtpu::rows::kRowsThreads)
    fire_move_rows_interleaved_kernel(T* x, T* v, const T* __restrict__ f,
                                      int64_t n, int64_t* images,
                                      const T* cell, const T* cell_inv,
                                      const T* scal, const int64_t* ints,
                                      T dmax, const bool* overflow) {
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
#pragma unroll
    for (int k = 0; k < D; ++k) {
      fk[k] = f[i * D + k];
      vk[k] = v[i * D + k];
      xk[k] = x[i * D + k];
    }
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

"""
# The first design's kernel (its own arithmetic, written out), waiting
# first.
WAITING_KERNEL = r"""
// The first design's move, waiting first (launched for rows here, stride
// 0).
template <typename T, int D, bool WRAP>
__global__ void __launch_bounds__(kThreads)
    fire_move_waiting_kernel(T* x, T* v, const T* __restrict__ f, int64_t n,
                     int64_t stride, int64_t* images, const T* cell,
                     const T* cell_inv, const T* scal, const int64_t* ints,
                     T dmax, const bool* overflow) {
  wait_for_dependencies();
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

"""

VECTOR_KERNEL = r"""
// A thread takes P = 16 / sizeof(T) slots: one 16-byte load of each
// component row of x, v and F after the wait, each slot's arithmetic as
// the package's, the same stores (a ragged last group slot by slot).
template <typename T>
__device__ __forceinline__ void store_vector(T* p, int64_t i,
                                             const T (&r)[Vec<T>::P]);
template <>
__device__ __forceinline__ void store_vector<float>(float* p, int64_t i,
                                                    const float (&r)[4]) {
  reinterpret_cast<float4*>(p)[i] = make_float4(r[0], r[1], r[2], r[3]);
}
template <>
__device__ __forceinline__ void store_vector<double>(double* p, int64_t i,
                                                     const double (&r)[2]) {
  reinterpret_cast<double2*>(p)[i] = make_double2(r[0], r[1]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fire_move_slots_vector_kernel(T* x, T* v, const T* __restrict__ f,
                                  int64_t n, int64_t stride, const T* scal,
                                  const int64_t* ints, T dmax,
                                  const bool* overflow) {
  constexpr int P = Vec<T>::P;
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t p0 = g * P;
  if (p0 >= n) return;
  wait_for_dependencies();
  const int m = n - p0 < P ? (int)(n - p0) : P;
  T xk[D][P], vk[D][P], fk[D][P];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (m == P) {
      Vec<T>::load(x + k * stride, g, xk[k]);
      Vec<T>::load(v + k * stride, g, vk[k]);
      Vec<T>::load(f + k * stride, g, fk[k]);
    } else {
      for (int q = 0; q < m; ++q) {
        xk[k][q] = x[k * stride + p0 + q];
        vk[k][q] = v[k * stride + p0 + q];
        fk[k][q] = f[k * stride + p0 + q];
      }
    }
  }
  const bool ovf = overflow != nullptr && *overflow;
  const MoveScalars<T> s(scal, ints);
  if (ovf) return;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (q >= m) break;
    T xq[D], vq[D], fq[D], dq[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      xq[k] = xk[k][q];
      vq[k] = vk[k][q];
      fq[k] = fk[k][q];
    }
    move_by<T, D>(xq, dq, capped_step<T, D>(vq, fq, s, dmax, dq));
#pragma unroll
    for (int k = 0; k < D; ++k) {
      xk[k][q] = xq[k];
      vk[k][q] = vq[k];
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (m == P) {
      store_vector<T>(x + k * stride, g, xk[k]);
      store_vector<T>(v + k * stride, g, vk[k]);
    } else {
      for (int q = 0; q < m; ++q) {
        x[k * stride + p0 + q] = xk[k][q];
        v[k * stride + p0 + q] = vk[k][q];
      }
    }
  }
}

"""

# The package's launches of the slots and the rows kernels, which each
# variant replaces.
SLOTS_LAUNCH = """  if (!rows)
    return launch_ex(fire_move_slots_kernel<T, D>, slots_grid(n), kThreads,
                     s, x, v, f, n, stride, scal, ints, dmax, overflow);
"""
ROWS_LAUNCH = """  if (wrap)
    return launch_ex(fire_move_rows_kernel<T, D, true>, grid, block, s, x,
                     v, f, n, images, cell, cell_inv, scal, ints, dmax,
                     overflow);
  return launch_ex(fire_move_rows_kernel<T, D, false>, grid, block, s, x, v,
                   f, n, images, cell, cell_inv, scal, ints, dmax, overflow);
"""
# The package's launch attribute, which plain_order drops.
PROGRAMMATIC = "  cfg.numAttrs = 1;\n"
VECTOR_LAUNCH = """  if (!rows) {
    constexpr int P = Vec<T>::P;
    const auto aligned = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    if (stride % P == 0 && aligned(x) && aligned(v) && aligned(f)) {
      const int64_t groups = (n + P - 1) / P;
      return launch_ex(fire_move_slots_vector_kernel<T, D>,
                       slots_grid(groups), kThreads, s, x, v, f, n, stride,
                       scal, ints, dmax, overflow);
    }
    return launch_ex(fire_move_slots_kernel<T, D>, slots_grid(n), kThreads,
                     s, x, v, f, n, stride, scal, ints, dmax, overflow);
  }
"""
GRID = "// The slots' grid: one block each kThreads slots.\n"


def data_first_source(src, shared_box=True):
    """The package's source with the move's data loaded before the wait
    (rows: the box into shared memory, or each thread's registers)."""
    flag = "true" if shared_box else "false"
    rows = ROWS_LAUNCH.replace(
        "fire_move_rows_kernel<T, D, true>",
        f"fire_move_rows_first_kernel<T, D, true, {flag}>").replace(
        "fire_move_rows_kernel<T, D, false>",
        f"fire_move_rows_first_kernel<T, D, false, {flag}>")
    return probe_torch_fire.patched(src, [
        (GRID, DATA_FIRST_KERNELS + GRID),
        (SLOTS_LAUNCH, SLOTS_LAUNCH.replace("fire_move_slots_kernel",
                                            "fire_move_slots_first_kernel")),
        (ROWS_LAUNCH, rows)])


def x_late_source(src):
    """The package's source with the rows' x loaded after the step."""
    return probe_torch_fire.patched(src, [
        (GRID, X_LATE_KERNEL + GRID),
        (ROWS_LAUNCH, ROWS_LAUNCH.replace("fire_move_rows_kernel",
                                          "fire_move_rows_late_kernel"))])


def waiting_source(src):
    """The package's source with the rows' move the first design's kernel,
    waiting first, on the rows' grid."""
    return probe_torch_fire.patched(src, [
        (GRID, WAITING_KERNEL + GRID),
        (ROWS_LAUNCH, ROWS_LAUNCH.replace(
            "fire_move_rows_kernel", "fire_move_waiting_kernel").replace(
            "n, images", "n, (int64_t)0, images"))])


def interleaved_source(src):
    """The package's source with the rows' loads component by
    component."""
    return probe_torch_fire.patched(src, [
        (GRID, INTERLEAVED_KERNEL + GRID),
        (ROWS_LAUNCH, ROWS_LAUNCH.replace(
            "fire_move_rows_kernel", "fire_move_rows_interleaved_kernel"))])


def plain_order_source(src):
    """The package's source with its launches in plain stream order."""
    return probe_torch_fire.patched(src, [(PROGRAMMATIC,
                                           "  cfg.numAttrs = 0;\n")])


def vector_source(src):
    """The package's source with the vector kernel, taken where aligned."""
    return probe_torch_fire.patched(src, [
        (GRID, VECTOR_KERNEL + GRID), (SLOTS_LAUNCH, VECTOR_LAUNCH)])


def load(lib_path):
    """The move's and the reduction's entry points of a build."""
    P, I, L, D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
    lib = ctypes.CDLL(lib_path)
    for s in ("f32", "f64"):
        getattr(lib, f"mdtpu_fire_move_{s}").argtypes = [
            P, P, P, I, L, L, P, P, P, P, P, D, P, P]
        getattr(lib, f"mdtpu_fire_reduce_{s}").argtypes = [
            P, P, L, P, P, P, P, L, P, I, D, D, D, D, D, L, P]
    return lib


class Case:
    """The move's inputs at one shape and dtype (forces ~30, velocities
    along them, positions in [0, 40); the scalars of a positive power with
    the mix; rows: images and a box of 40.3 with a tilt) and its calls
    through a build."""

    def __init__(self, shape, dtype, rows):
        g = torch.Generator(device="cuda").manual_seed(25)
        self.dtype, self.shape, self.rows = dtype, shape, rows
        self.f = (torch.randn(shape, device="cuda", generator=g) * 30).to(
            dtype)
        self.v0 = (torch.randn(shape, device="cuda", generator=g)
                   + 0.01 * self.f).to(dtype)
        self.x0 = (torch.rand(shape, device="cuda", generator=g) * 40).to(
            dtype)
        self.img0 = torch.zeros(shape, dtype=torch.int64, device="cuda")
        self.x, self.v, self.img = (t.clone() for t in (self.x0, self.v0,
                                                        self.img0))
        self.cell = torch.eye(3, dtype=dtype, device="cuda") * 40.3
        self.cell[0, 1] = 2.5
        self.cell_inv = torch.linalg.inv(self.cell).contiguous()
        self.scal = torch.tensor([0.036, 0.07, 0, 1e-3, 0.93, 0.0021, 0.03],
                                 dtype=dtype, device="cuda")
        self.ints = torch.tensor([2, 0, 1 << 60, 1, 1, 0, 0, 0, 0],
                                 device="cuda")
        self.red = torch.zeros(5, dtype=dtype, device="cuda")
        self.work = torch.zeros(1 + 5 * 128, dtype=dtype, device="cuda")

    def reduce(self, lib):
        """fire_reduce in one pass over v and F into the move's scalars."""
        s = "f32" if self.dtype == torch.float32 else "f64"
        rc = getattr(lib, f"mdtpu_fire_reduce_{s}")(
            self.v.data_ptr(), self.f.data_ptr(), self.f.numel(),
            self.scal.data_ptr(), self.ints.data_ptr(), self.red.data_ptr(),
            self.work.data_ptr(), self.work.numel(), None, 7, 1.2, 0.2, 0.1,
            0.01, 0.1, 5, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"probe: fire_reduce launch failed ({rc})")

    def call(self, lib):
        fn = getattr(lib, "mdtpu_fire_move_f32" if self.dtype ==
                     torch.float32 else "mdtpu_fire_move_f64")
        dim, n = ((self.shape[1], self.shape[0]) if self.rows
                  else self.shape)
        box = ((self.img.data_ptr(), self.cell.data_ptr(),
                self.cell_inv.data_ptr()) if self.rows else (None,) * 3)
        rc = fn(self.x.data_ptr(), self.v.data_ptr(), self.f.data_ptr(),
                dim, n, 0 if self.rows else n, *box, self.scal.data_ptr(),
                self.ints.data_ptr(), 0.1, None,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"probe: fire_move launch failed ({rc})")

    def once(self, lib):
        """Positions, velocities and images after one call from the
        start."""
        for t, t0 in ((self.x, self.x0), (self.v, self.v0),
                      (self.img, self.img0)):
            t.copy_(t0)
        self.call(lib)
        torch.cuda.synchronize()
        return self.x.clone(), self.v.clone(), self.img.clone()


def graph_ms(case, lib, calls, pair=False):
    """A CUDA graph of ``calls`` in-place calls (``pair``: each a
    reduction into the move's scalars, then the move) replayed 20 times
    between CUDA events, over the calls; the median of 5 rounds."""
    def one():
        if pair:
            case.reduce(lib)
        case.call(lib)
    one()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            one()
    return probe_torch_fire.replay_ms(graph, calls)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="another tree's directory")
    parser.add_argument("--case", choices=[c[0] for c in CASES],
                        help="only this case")
    parser.add_argument("--turns", type=int, default=1,
                        help="rounds of turns over the builds")
    parser.add_argument("--calls", type=int, default=100)
    parser.add_argument("--out", default=os.path.join(
        HERE, "out_probe", "probe_torch_move.jsonl"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_move: no CUDA device")
    csrc = os.path.join(HERE, "mdtpu_torch", "csrc")
    with open(os.path.join(csrc, "fire_update.cu")) as f:
        src = f.read()
    cases = [c for c in CASES if args.case in (None, c[0])]
    wanted = {k for c in cases for k in c[3]}
    # name -> (source, its csrc)
    sources = {"package": (src, csrc),
               "plain_order": (plain_order_source(src), csrc),
               "data_first": (data_first_source(src), csrc),
               "data_first_register_box": (data_first_source(src, False),
                                           csrc),
               "vector": (vector_source(src), csrc),
               "x_late": (x_late_source(src), csrc),
               "first_design_waiting": (waiting_source(src), csrc),
               "interleaved": (interleaved_source(src), csrc)}
    if args.parent:
        pcsrc = os.path.join(os.path.abspath(args.parent), "mdtpu_torch",
                             "csrc")
        with open(os.path.join(pcsrc, "fire_update.cu")) as f:
            sources["parent"] = (f.read(), pcsrc)
    sources = {k: v for k, v in sources.items() if k in wanted}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    lines = []

    def emit(rec):
        print(json.dumps(rec), flush=True)
        lines.append(json.dumps(rec))

    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(max_workers=len(sources)) as pool:
            futures = {k: pool.submit(probe_torch_fire.build, f"move_{k}",
                                      s, c, tmp)
                       for k, (s, c) in sources.items()}
        libs = {k: load(fut.result()) for k, fut in futures.items()}
        for (name, shape, rows, names), dtype in [
                (c, dtype) for c in cases
                for dtype in (torch.float32, torch.float64)]:
            names = [k for k in names if k in libs]
            case = Case(shape, dtype, rows)
            outs = {k: case.once(libs[k]) for k in names}
            nbytes = (5 * case.f.element_size() + (16 if rows else 0)) * \
                case.f.numel()
            rec = {"shape": list(shape), "case": name,
                   "dtype": str(dtype)[6:],
                   "bits_equal": all(torch.equal(a, b) for k in names
                                     for a, b in zip(outs[k],
                                                     outs[names[0]])),
                   "bound_ms": nbytes / 3.35e12 * 1e3}
            for label, pair in (("alone", False), ("after_reduce", True)):
                times = {k: [] for k in names}
                for k in (names + names[::-1]) * args.turns:
                    times[k].append(graph_ms(case, libs[k], args.calls,
                                             pair))
                rec[label] = {k: statistics.mean(v)
                              for k, v in times.items()}
                rec[f"{label}_turns"] = times
            emit(rec)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"card": smi})
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
