// Pair potentials and small numeric helpers shared by the pair-sweep kernels
// (cell_sweep.cu, plane_sweep.cu).
//
// The potentials are functors with their parameters passed by value. Each
// mirrors the evaluate_r2 method of its PyTorch class (mdtpu_torch/potentials)
// expression for expression; keep them in step. Built with -fmad=false (see
// mdtpu_torch/ops/_cuda_build.py), so every product rounds as in the plain
// PyTorch versions and two_sum stays error-free.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mdtpu {

constexpr double kPseudoHSA = 134.5526623421209;
constexpr double kPseudoHSB = 1.0204081632653061;

// Error codes shared by the sweep libraries, beside cudaError_t values
// (which are >= 0).
constexpr int kErrCapacity = -1;   // cap outside what the kernel takes
constexpr int kErrPotential = -2;  // unknown potential kind
constexpr int kErrGrid = -3;       // fewer than 3 cells on an axis
constexpr int kErrPlan = -4;       // staging plan and kernel layout disagree
constexpr int kErrRange = -5;      // launched cells outside the grid
constexpr int kErrFold = -6;       // too many blocks for the energy sum

// Shared memory a block may use on sm_90 (227 KB); above 48 KB only as
// dynamic shared memory after cudaFuncSetAttribute.
constexpr size_t kMaxSharedBytes = 232448;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

template <typename T>
__device__ __forceinline__ T rsqrt_t(T x);
template <>
__device__ __forceinline__ float rsqrt_t<float>(float x) { return rsqrtf(x); }
template <>
__device__ __forceinline__ double rsqrt_t<double>(double x) { return rsqrt(x); }

// Error-free transform (Knuth): s = fl(a + b), a + b == s + r exactly, as
// utils/math.py::two_sum.
template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& r) {
  s = a + b;
  const T bb = s - a;
  const T err_b = b - bb;
  const T err_a = a - (s - bb);
  r = err_a + err_b;
}

// x**n by binary exponentiation, in the squaring order of utils/math.py::ipow.
template <typename T>
__device__ __forceinline__ T ipow(T x, int n) {
  if (n == 0) return T(1);
  T result = T(0);
  bool have = false;
  T base = x;
  while (n > 0) {
    if (n & 1) {
      result = have ? result * base : base;
      have = true;
    }
    n >>= 1;
    if (n) base = base * base;
  }
  return result;
}

// Each functor splits its arithmetic in two. setup(d_own) runs once per
// thread and holds what does not depend on the pair: the squared cutoff, and
// the terms that depend on the pair's sigma alone, worked out for the sigma a
// pair of two particles of the own diameter has (0.5 * (d + d) == d exactly;
// the fixed sigma without mixing). operator() takes that set-up and
// recomputes the sigma terms only for a neighbour of another diameter. Both
// routes go through the same expressions (sigma_terms), in the same order,
// so hoisting changes no bit of the result.

template <typename T>
struct LJ {
  T eps, sigma, rc;
  int shift, force_shift, mix;

  struct Setup {
    T rc2, d_own, sig2, v_cut, f_cut;
  };

  __device__ __forceinline__ void sigma_terms(T sig, T& sig2, T& v_cut,
                                              T& f_cut) const {
    sig2 = sig * sig;
    v_cut = T(0);
    f_cut = T(0);
    if (shift || force_shift) {
      const T sr = sig / rc;
      const T s2 = sr * sr;
      const T src6 = s2 * s2 * s2;
      const T src12 = src6 * src6;
      v_cut = T(4) * eps * (src12 - src6);
      if (force_shift) f_cut = T(24) * eps * (T(2) * src12 - src6) / rc;
    }
  }

  __device__ __forceinline__ Setup setup(T d_own) const {
    Setup s;
    s.rc2 = rc * rc;
    s.d_own = d_own;
    sigma_terms(mix ? d_own : sigma, s.sig2, s.v_cut, s.f_cut);
    return s;
  }

  __device__ __forceinline__ void operator()(const Setup& s, T r2, T si, T sj,
                                             T& u, T& f_over_r) const {
    if (!(r2 < s.rc2)) {
      u = T(0);
      f_over_r = T(0);
      return;
    }
    T sig2 = s.sig2, v_cut = s.v_cut, f_cut = s.f_cut;
    if (mix && sj != s.d_own)
      sigma_terms(T(0.5) * (si + sj), sig2, v_cut, f_cut);
    T inv_r = T(0), inv_r2;
    if (force_shift) {
      inv_r = rsqrt_t<T>(r2);
      inv_r2 = inv_r * inv_r;
    } else {
      inv_r2 = T(1) / r2;
    }
    const T sr2 = sig2 * inv_r2;
    const T sr6 = sr2 * sr2 * sr2;
    const T sr12 = sr6 * sr6;
    T v = T(4) * eps * (sr12 - sr6);
    T f = T(24) * eps * (T(2) * sr12 - sr6) * inv_r2;
    if (shift || force_shift) {
      v = v - v_cut;
      if (force_shift) {
        v = v + (r2 * inv_r - rc) * f_cut;
        f = f - f_cut * inv_r;
      }
    }
    u = v;
    f_over_r = f;
  }
};

template <typename T>
struct PseudoHS {
  int lam, scaled, mix;

  struct Setup {
    T d_own, sig, cut2, a_sig2;
  };

  __device__ __forceinline__ void sigma_terms(T sig, T& cut2,
                                              T& a_sig2) const {
    const T cut = scaled ? T(kPseudoHSB) * sig : T(kPseudoHSB);
    cut2 = cut * cut;
    a_sig2 = T(kPseudoHSA) / (sig * sig);
  }

  __device__ __forceinline__ Setup setup(T d_own) const {
    Setup s;
    s.d_own = d_own;
    s.sig = mix ? d_own : T(1);
    sigma_terms(s.sig, s.cut2, s.a_sig2);
    return s;
  }

  __device__ __forceinline__ void operator()(const Setup& s, T r2, T si, T sj,
                                             T& u, T& f_over_r) const {
    T sig = s.sig, cut2 = s.cut2, a_sig2 = s.a_sig2;
    if (mix && sj != s.d_own) {
      sig = T(0.5) * (si + sj);
      sigma_terms(sig, cut2, a_sig2);
    }
    if (!(r2 < cut2)) {
      u = T(0);
      f_over_r = T(0);
      return;
    }
    const T inv_r = rsqrt_t<T>(r2);
    const T sr = sig * inv_r;
    const T sr2 = sr * sr;
    const T sr_lm2 = (lam % 2 == 0) ? ipow<T>(sr2, (lam - 2) / 2)
                                    : ipow<T>(sr2, (lam - 3) / 2) * sr;
    const T sr_lm1 = sr_lm2 * sr;
    const T sr_l = sr_lm2 * sr2;
    const T sr_lp1 = sr_l * sr;
    const T sr_lp2 = sr_l * sr2;
    u = T(kPseudoHSA) * (sr_l - sr_lm1) + T(1);
    f_over_r = a_sig2 * (T(lam) * sr_lp2 - T(lam - 1) * sr_lp1);
  }
};

template <typename T>
struct XPLOR {
  T eps, sigma, ron, rc;
  int mix;

  struct Setup {
    T d_own, rc2, ron2, denom, sig2;
  };

  __device__ __forceinline__ Setup setup(T d_own) const {
    Setup s;
    s.d_own = d_own;
    s.rc2 = rc * rc;
    s.ron2 = ron * ron;
    const T d = s.rc2 - s.ron2;
    s.denom = d * d * d;
    const T sig = mix ? d_own : sigma;
    s.sig2 = sig * sig;
    return s;
  }

  __device__ __forceinline__ void operator()(const Setup& s, T r2, T si, T sj,
                                             T& u, T& f_over_r) const {
    const T rc2 = s.rc2, ron2 = s.ron2, denom = s.denom;
    if (!(r2 < rc2)) {
      u = T(0);
      f_over_r = T(0);
      return;
    }
    T sig2 = s.sig2;
    if (mix && sj != s.d_own) {
      const T sig = T(0.5) * (si + sj);
      sig2 = sig * sig;
    }
    const T inv_r2 = T(1) / r2;
    const T sr2 = sig2 * inv_r2;
    const T sr6 = sr2 * sr2 * sr2;
    const T sr12 = sr6 * sr6;
    const T v = T(4) * eps * (sr12 - sr6);
    const T f = T(24) * eps * (T(2) * sr12 - sr6) * inv_r2;
    const T a = rc2 - r2;
    const T b = rc2 + T(2) * r2 - T(3) * ron2;
    const bool below = r2 < ron2;
    const T sw = below ? T(1) : a * a * b / denom;
    const T ds_over_r = below ? T(0) : T(4) * a * (a - b) / denom;
    u = v * sw;
    f_over_r = sw * f - v * ds_over_r;
  }
};

// The packer's harmonic contact repulsion (mdtpu_torch/potentials/overlap.py
// OverlapPotential): u = (tol - r)^2 and f = 2 (tol - r) for r < tol, zero
// beyond. Its PyTorch class computes it through the base class's
// evaluate_r2: r = sqrt(r2), then f / r (f itself where r = 0).
template <typename T>
struct Overlap {
  T tol;

  struct Setup {};

  __device__ __forceinline__ Setup setup(T) const { return Setup{}; }

  __device__ __forceinline__ void operator()(const Setup&, T r2, T, T, T& u,
                                             T& f_over_r) const {
    const T r = sqrt(r2);
    T overlap = tol - r;
    if (!(overlap > T(0))) overlap = T(0);
    u = overlap * overlap;
    const T f = T(2) * overlap;
    f_over_r = r > T(0) ? f / r : f;
  }
};

// Calls launch(pot) with the functor that ``kind`` names: 0 LennardJones (p0
// eps, p1 sigma, p2 r_cut; i0 shift, i1 force_shift, i2 mix), 1 PseudoHS (i0
// lam, i1 sigma_scaled_cutoff, i2 mix), 2 LennardJonesXPLOR (p0 eps, p1
// sigma, p2 r_on, p3 r_cut; i2 mix), 3 OverlapPotential (p0 tol).
// Parameters are rounded to T, as the PyTorch versions round them to the
// working dtype.
template <typename T, typename Launch>
int with_potential(int kind, double p0, double p1, double p2, double p3,
                   int i0, int i1, int i2, Launch&& launch) {
  switch (kind) {
    case 0:
      return launch(LJ<T>{T(p0), T(p1), T(p2), i0, i1, i2});
    case 1:
      return launch(PseudoHS<T>{i0, i1, i2});
    case 2:
      return launch(XPLOR<T>{T(p0), T(p1), T(p2), T(p3), i2});
    case 3:
      return launch(Overlap<T>{T(p0)});
    default:
      return kErrPotential;
  }
}

// Periodic neighbour index along one grid axis, and the +-L image shift
// that the wrapped neighbour's coordinates take.
template <typename T>
__device__ __forceinline__ int wrap_axis(int j, int n, T l, T& shift) {
  shift = T(0);
  if (j < 0) {
    shift = -l;
    return j + n;
  }
  if (j >= n) {
    shift = l;
    return j - n;
  }
  return j;
}

// Fixed-order tree reduction of two per-thread values over the block into
// red_a[0], red_b[0] (blockDim.x a power of two).
template <typename T>
__device__ __forceinline__ void block_reduce2(T a, T b, T* red_a, T* red_b) {
  const int i = threadIdx.x;
  red_a[i] = a;
  red_b[i] = b;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (i < stride) {
      red_a[i] += red_a[i + stride];
      red_b[i] += red_b[i + stride];
    }
    __syncthreads();
  }
}

inline const char* error_string(int code) {
  switch (code) {
    case kErrCapacity: return "cell capacity outside what the kernel takes";
    case kErrPotential: return "potential kind unknown to the kernel";
    case kErrGrid: return "cell grid needs at least 3 cells on every axis";
    case kErrPlan: return "staging plan does not match the kernel's layout";
    case kErrFold:
      return "too many cells for the sweep's in-kernel energy sum";
    case kErrRange: return "the launched run of cells lies outside the grid";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // namespace mdtpu
