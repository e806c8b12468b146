"""Potential protocol: the pair-interaction interface.

Counterpart of ``mdtpu/potentials/base.py``. A potential is a small frozen
dataclass with

    potential.evaluate(r, sigma_i, sigma_j)     -> (u, f)        f = -dV/dr
    potential.evaluate_r2(r2, sigma_i, sigma_j) -> (u, f_over_r)
    potential.force_r2(r2, sigma_i, sigma_j)    -> f_over_r

on tensors of any shape (scalars may be Python floats). The pair force
vector is ``f_over_r * dr`` and the pair virial ``f_over_r * r2``.

CUTOFF CONTRACT: a potential returns exact zeros ``(0, 0)`` for every pair
beyond its own cutoff, for arbitrarily large ``r``. Engines validate at
creation that their cutoff covers :meth:`Potential.max_cutoff`
(:func:`check_engine_cutoff`).

WHAT RUNS ON THE CARD. The built-in potentials (LennardJones, PseudoHS,
LennardJonesXPLOR and the packer's OverlapPotential) have functors in the
CUDA pair sweeps (``csrc/pair_potentials.cuh``) that mirror their
``evaluate_r2`` expression for expression. Any other potential, a user's
subclass of :class:`Potential` included (the choice is by type: a subclass of
a built-in is a user potential too), runs on the cell grid's pair-list
route (:mod:`mdtpu_torch.ops.cell_pairs`): a CUDA kernel lists every pair
within the engine cutoff with its r^2 and the two diameters, the
potential's own ``evaluate_r2`` (``force_r2`` on steps whose energy nobody
reads) runs in torch on that flat list, and a CUDA kernel sums the forces,
energy and virial in a fixed order. So a user potential needs only torch
operations that broadcast over 1-D tensors of r^2, sigma_i and sigma_j, in
their dtype and on their device; it must keep the cutoff contract above
(exact zeros beyond its range, including on padding entries at r^2 = the
engine cutoff squared) and must not read values back to the host.

Scalar parameters are rounded to the working dtype before use
(:func:`rounded`), as the JAX package casts them with ``jnp.asarray(x,
dtype)``; they then enter tensor arithmetic as Python scalars, which PyTorch
applies in the tensor's dtype without a host-to-device copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.float16: np.float16, torch.bfloat16: np.float32}


def rounded(x, dtype) -> float:
    """A Python float holding ``x`` rounded to ``dtype``."""
    return float(_NP_DTYPES[dtype](x))


class Potential:
    """Base class for pair potentials (subclasses are frozen dataclasses
    implementing ``evaluate``)."""

    def evaluate(self, r, sigma_i=1.0, sigma_j=1.0):
        raise NotImplementedError(
            f"evaluate not implemented for potential type: {type(self).__name__}")

    def evaluate_r2(self, r2, sigma_i=1.0, sigma_j=1.0):
        """Squared-distance form ``(u, f_over_r)``; the default goes through
        ``evaluate`` with one sqrt."""
        r = torch.sqrt(r2)
        u, f = self.evaluate(r, sigma_i, sigma_j)
        return u, f / torch.where(r > 0, r, torch.ones_like(r))

    def force_r2(self, r2, sigma_i=1.0, sigma_j=1.0):
        """Force-only squared-distance form: ``f_over_r`` alone."""
        return self.evaluate_r2(r2, sigma_i, sigma_j)[1]

    def max_cutoff(self, max_sigma=1.0):
        """Largest pair distance at which the potential is nonzero, given the
        largest particle diameter; None when unknown."""
        return None

    # Long-range (tail) corrections: total energy and pressure correction.
    def energy_lrc(self, n_particles, volume):
        return 0.0

    def pressure_lrc(self, n_particles, volume):
        return 0.0


def check_engine_cutoff(potential, cutoff, max_sigma=1.0):
    """Raise if the engine's cutoff does not cover the potential's maximum
    interaction range (pairs beyond it would be silently dropped)."""
    fn = getattr(potential, "max_cutoff", None)
    mc = fn(max_sigma) if fn is not None else None
    if mc is not None and float(cutoff) < float(mc) - 1e-9:
        raise ValueError(
            f"engine cutoff {float(cutoff):g} is smaller than the "
            f"potential's maximum interaction range {float(mc):g} "
            f"(max diameter {float(max_sigma):g}); pairs beyond the cell "
            f"reach would be silently dropped — increase the engine cutoff")


def lj_tail_corrections(epsilon, sigma, r_cut, n_particles, volume):
    """The closed-form LJ tail-correction pair (total energy, pressure)
    shared by LennardJones and LennardJonesXPLOR."""
    rho = n_particles / volume
    src3 = (sigma / r_cut) ** 3
    src9 = src3 ** 3
    pref = epsilon * sigma ** 3
    e_total = ((8.0 * math.pi * rho * pref / 3.0)
               * (src9 / 3.0 - src3)) * n_particles
    p_total = (16.0 * math.pi * rho ** 2 * pref / 3.0) * (2.0 * src9 / 3.0
                                                          - src3)
    return e_total, p_total


def lorentz_sigma(mixing, self_sigma, sigma_i, sigma_j, dtype):
    """The sigma-mixing rule shared by the built-in potentials: Lorentz
    arithmetic mean, or ``mixing="none"`` (always the potential's sigma)."""
    if mixing == "none":
        return rounded(self_sigma, dtype)
    if not isinstance(sigma_i, torch.Tensor):
        sigma_i = rounded(sigma_i, dtype)
    if not isinstance(sigma_j, torch.Tensor):
        sigma_j = rounded(sigma_j, dtype)
    return 0.5 * (sigma_i + sigma_j)


def evaluate(potential, r, sigma_i=1.0, sigma_j=1.0):
    """Free-function form of the evaluate interface."""
    return potential.evaluate(r, sigma_i, sigma_j)


def energy_lrc(potential, n_particles, volume):
    return potential.energy_lrc(n_particles, volume)


def pressure_lrc(potential, n_particles, volume):
    return potential.pressure_lrc(n_particles, volume)
