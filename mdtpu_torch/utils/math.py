"""Small numeric helpers used by the pair potentials and the integrator.

Counterpart of ``mdtpu/utils/math.py``. Integer powers are built by repeated
squaring in the same multiplication order as the JAX package, so the steep
pseudo-hard-sphere powers (lambda = 50) round identically.
"""

from __future__ import annotations

import torch


def ipow(x, n: int):
    """x**n for a non-negative Python integer n, via binary exponentiation."""
    if not isinstance(n, int):
        raise TypeError(f"ipow exponent must be a static int, got {type(n)}")
    if n < 0:
        raise ValueError("ipow exponent must be >= 0")
    if n == 0:
        return torch.ones_like(x)
    result = None
    base = x
    while n > 0:
        if n & 1:
            result = base if result is None else result * base
        n >>= 1
        if n:
            base = base * base
    return result


def two_sum(a, b):
    """Error-free transform: s = fl(a + b) and the exact residual r with
    a + b == s + r (Knuth; no magnitude ordering assumed)."""
    s = a + b
    bb = s - a
    err_b = b - bb
    err_a = a - (s - bb)
    return s, err_a + err_b


def kahan_add(x, comp, dx):
    """One step of Kahan (compensated) summation: returns (x', comp').

    Keeps f32 position/velocity accumulation error bounded over long runs.
    PyTorch's eager kernels do not reassociate these operations."""
    y = dx - comp
    t = x + y
    comp_new = (t - x) - y
    return t, comp_new
