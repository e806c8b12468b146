"""Lennard-Jones with XPLOR smooth switching and optional tail corrections.

Counterpart of ``mdtpu/potentials/xplor.py``. The switch S(r) is 1 below
r_on, a smooth rational on [r_on, r_cut) and 0 beyond; the pair force is
exactly -d/dr [V(r) S(r)].

The CUDA pair sweep evaluates the same expressions in the same order
(``mdtpu_torch/csrc/cell_sweep.cu``, ``struct XPLOR``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mdtpu_torch.potentials.base import (Potential, lj_tail_corrections,
                                         lorentz_sigma, rounded)
from mdtpu_torch.potentials.lennard_jones import _sr_powers


def xplor_switch(r, r_on, r_cut):
    """Value and derivative (dS/dr) of the XPLOR switching function."""
    rc2 = r_cut * r_cut
    ron2 = r_on * r_on
    r2 = r * r
    denom = (rc2 - ron2) ** 3
    a = rc2 - r2
    b = rc2 + 2.0 * r2 - 3.0 * ron2
    s_mid = a * a * b / denom
    # d/dr [a^2 b] = 2a * (-2r) * b + a^2 * 4r = 4r * a * (a - b)
    ds_mid = 4.0 * r * a * (a - b) / denom
    below = r < r_on
    above = r >= r_cut
    s = torch.where(below, torch.ones_like(s_mid),
                    torch.where(above, torch.zeros_like(s_mid), s_mid))
    ds = torch.where(below | above, torch.zeros_like(ds_mid), ds_mid)
    return s, ds


@dataclass(frozen=True)
class LennardJonesXPLOR(Potential):
    epsilon: float = 1.0
    sigma: float = 1.0
    r_on: float = 2.0
    r_cut: float = 2.5
    tail_correction: bool = False
    mixing: str = "lorentz"

    def max_cutoff(self, max_sigma=1.0):
        return float(self.r_cut)

    def evaluate(self, r, sigma_i=1.0, sigma_j=1.0):
        dtype = r.dtype
        eps = rounded(self.epsilon, dtype)
        rc = rounded(self.r_cut, dtype)
        ron = rounded(self.r_on, dtype)
        sigma = lorentz_sigma(self.mixing, self.sigma, sigma_i, sigma_j, dtype)

        inside = r < rc
        r_safe = torch.where(inside, r, torch.ones_like(r))
        sr6, sr12 = _sr_powers(sigma, r_safe)
        v = 4.0 * eps * (sr12 - sr6)
        f = 24.0 * eps * (2.0 * sr12 - sr6) / r_safe  # = -dV/dr

        s, dsdr = xplor_switch(r_safe, ron, rc)
        # force = -d(V*S)/dr = S * (-dV/dr) - V * dS/dr
        force = s * f - v * dsdr
        energy = v * s
        return (torch.where(inside, energy, torch.zeros_like(energy)),
                torch.where(inside, force, torch.zeros_like(force)))

    def evaluate_r2(self, r2, sigma_i=1.0, sigma_j=1.0):
        """Sqrt-free: the LJ core and the switch are polynomials in r^2.

          S_mid      = a^2 b / denom,  a = rc^2 - r^2,  b = rc^2 + 2r^2 - 3ron^2
          (dS/dr)/r  = 4 a (a - b) / denom
          F/r        = S * (24 eps (2 sr12 - sr6) / r^2) - V * (dS/dr)/r
        """
        dtype = r2.dtype
        eps = rounded(self.epsilon, dtype)
        rc = rounded(self.r_cut, dtype)
        ron = rounded(self.r_on, dtype)
        sigma = lorentz_sigma(self.mixing, self.sigma, sigma_i, sigma_j, dtype)

        rc2 = rounded(rc * rc, dtype)
        ron2 = rounded(ron * ron, dtype)
        inside = r2 < rc2
        r2_safe = torch.where(inside, r2, torch.ones_like(r2))
        inv_r2 = 1.0 / r2_safe
        sr2 = (sigma * sigma) * inv_r2
        sr6 = sr2 * sr2 * sr2
        sr12 = sr6 * sr6
        v = 4.0 * eps * (sr12 - sr6)
        f_over_r = 24.0 * eps * (2.0 * sr12 - sr6) * inv_r2

        d = rounded(rc2 - ron2, dtype)
        denom = rounded(rounded(d * d, dtype) * d, dtype)
        a = rc2 - r2_safe
        b = rc2 + 2.0 * r2_safe - rounded(3.0 * ron2, dtype)
        below = r2_safe < ron2
        s = torch.where(below, torch.ones_like(a), a * a * b / denom)
        ds_over_r = torch.where(below, torch.zeros_like(a),
                                4.0 * a * (a - b) / denom)

        energy = v * s
        force_over_r = s * f_over_r - v * ds_over_r
        return (torch.where(inside, energy, torch.zeros_like(energy)),
                torch.where(inside, force_over_r,
                            torch.zeros_like(force_over_r)))

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
