"""Lennard-Jones potential with energy/force shifting and tail corrections.

Counterpart of ``mdtpu/potentials/lennard_jones.py``. The ``shift`` and
``force_shift`` flags select the shifted forms; shift constants are taken at
the *mixed* sigma so polydisperse systems stay continuous at the cutoff.
Tail corrections carry the eps * sigma^3 prefactor and apply only with
``tail_correction``.

The CUDA pair sweep evaluates the same expressions in the same order
(``mdtpu_torch/csrc/cell_sweep.cu``, ``struct LJ``); keep the two in step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mdtpu_torch.potentials.base import (Potential, lj_tail_corrections,
                                         lorentz_sigma, rounded)


def _sr_powers(sigma, r):
    sr = sigma / r
    sr2 = sr * sr
    sr6 = sr2 * sr2 * sr2
    sr12 = sr6 * sr6
    return sr6, sr12


def _zero_outside(inside, *values):
    return tuple(torch.where(inside, v, torch.zeros_like(v)) for v in values)


@dataclass(frozen=True)
class LennardJones(Potential):
    epsilon: float = 1.0
    sigma: float = 1.0
    r_cut: float = 2.5
    shift: bool = False
    force_shift: bool = False
    tail_correction: bool = False
    # "lorentz" (arithmetic mean) or "none" (always self.sigma).
    mixing: str = "lorentz"

    def max_cutoff(self, max_sigma=1.0):
        # The potential cuts at a fixed r_cut regardless of sigma.
        return float(self.r_cut)

    def evaluate(self, r, sigma_i=1.0, sigma_j=1.0):
        dtype = r.dtype
        eps = rounded(self.epsilon, dtype)
        rc = rounded(self.r_cut, dtype)
        sigma = lorentz_sigma(self.mixing, self.sigma, sigma_i, sigma_j, dtype)

        inside = r < rc
        r_safe = torch.where(inside, r, torch.ones_like(r))
        sr6, sr12 = _sr_powers(sigma, r_safe)
        v = 4.0 * eps * (sr12 - sr6)
        f = 24.0 * eps * (2.0 * sr12 - sr6) / r_safe

        if self.shift or self.force_shift:
            src6, src12 = _sr_powers(sigma, rc)
            v = v - 4.0 * eps * (src12 - src6)
            if self.force_shift:
                # V_fs = V - V_c + (r - r_c) F_c with F_c = -dV/dr at r_c.
                f_cut = 24.0 * eps * (2.0 * src12 - src6) / rc
                v = v + (r_safe - rc) * f_cut
                f = f - f_cut
        return _zero_outside(inside, v, f)

    def evaluate_r2(self, r2, sigma_i=1.0, sigma_j=1.0):
        """Sqrt-free form: V and F/r are polynomials in sigma^2/r^2; the
        force-shifted form takes 1/r from one rsqrt."""
        dtype = r2.dtype
        eps = rounded(self.epsilon, dtype)
        rc = rounded(self.r_cut, dtype)
        sigma = lorentz_sigma(self.mixing, self.sigma, sigma_i, sigma_j, dtype)

        inside = r2 < rounded(rc * rc, dtype)
        r2_safe = torch.where(inside, r2, torch.ones_like(r2))
        if self.force_shift:
            inv_r = torch.rsqrt(r2_safe)
            inv_r2 = inv_r * inv_r
        else:
            inv_r2 = 1.0 / r2_safe
        sr2 = (sigma * sigma) * inv_r2
        sr6 = sr2 * sr2 * sr2
        sr12 = sr6 * sr6
        v = 4.0 * eps * (sr12 - sr6)
        f_over_r = 24.0 * eps * (2.0 * sr12 - sr6) * inv_r2

        if self.shift or self.force_shift:
            src6, src12 = _sr_powers(sigma, rc)
            v = v - 4.0 * eps * (src12 - src6)
            if self.force_shift:
                f_cut = 24.0 * eps * (2.0 * src12 - src6) / rc
                v = v + (r2_safe * inv_r - rc) * f_cut
                f_over_r = f_over_r - f_cut * inv_r
        return _zero_outside(inside, v, f_over_r)

    def force_r2(self, r2, sigma_i=1.0, sigma_j=1.0):
        """Force-only form: drops the energy polynomial."""
        dtype = r2.dtype
        eps = rounded(self.epsilon, dtype)
        rc = rounded(self.r_cut, dtype)
        sigma = lorentz_sigma(self.mixing, self.sigma, sigma_i, sigma_j, dtype)

        inside = r2 < rounded(rc * rc, dtype)
        r2_safe = torch.where(inside, r2, torch.ones_like(r2))
        if self.force_shift:
            inv_r = torch.rsqrt(r2_safe)
            inv_r2 = inv_r * inv_r
        else:
            inv_r2 = 1.0 / r2_safe
        sr2 = (sigma * sigma) * inv_r2
        sr6 = sr2 * sr2 * sr2
        sr12 = sr6 * sr6
        f_over_r = 24.0 * eps * (2.0 * sr12 - sr6) * inv_r2
        if self.force_shift:
            src6, src12 = _sr_powers(sigma, rc)
            f_cut = 24.0 * eps * (2.0 * src12 - src6) / rc
            f_over_r = f_over_r - f_cut * inv_r
        return _zero_outside(inside, f_over_r)[0]

    def energy_lrc(self, n_particles, volume):
        if not self.tail_correction:
            return 0.0
        return lj_tail_corrections(self.epsilon, self.sigma, self.r_cut,
                                   n_particles, volume)[0]

    def pressure_lrc(self, n_particles, volume):
        if not self.tail_correction:
            return 0.0
        return lj_tail_corrections(self.epsilon, self.sigma, self.r_cut,
                                   n_particles, volume)[1]
