"""Pseudo-hard-sphere (steep inverse-power) potential.

Counterpart of ``mdtpu/potentials/pseudo_hs.py``: lambda = 50 by default,
constants ``B_PARAM`` (cutoff in units of sigma) and ``A_PARAM`` chosen so
the potential and force vanish continuously at the cutoff. The cutoff scales
with the mixed sigma unless ``sigma_scaled_cutoff=False``. Powers are built
by :func:`mdtpu_torch.utils.math.ipow` in the JAX package's squaring order.

The CUDA pair sweep evaluates the same expressions in the same order
(``mdtpu_torch/csrc/cell_sweep.cu``, ``struct PseudoHS``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mdtpu_torch.potentials.base import Potential, lorentz_sigma, rounded
from mdtpu_torch.utils.math import ipow

B_PARAM = 1.0204081632653061
A_PARAM = 134.5526623421209


@dataclass(frozen=True)
class PseudoHS(Potential):
    lam: int = 50
    sigma_scaled_cutoff: bool = True
    # "lorentz" or "none" (PseudoHS's own length scale is 1).
    mixing: str = "lorentz"

    def max_cutoff(self, max_sigma=1.0):
        return B_PARAM * float(max_sigma) if self.sigma_scaled_cutoff \
            else B_PARAM

    def _cutoff(self, sigma, dtype):
        if self.sigma_scaled_cutoff:
            return B_PARAM * sigma
        return rounded(B_PARAM, dtype)

    def evaluate(self, r, sigma_i=1.0, sigma_j=1.0):
        lam = self.lam
        dtype = r.dtype
        sigma = lorentz_sigma(self.mixing, 1.0, sigma_i, sigma_j, dtype)
        inside = r < self._cutoff(sigma, dtype)
        r_safe = torch.where(inside, r, torch.ones_like(r))
        sr = sigma / r_safe
        sr_lm1 = ipow(sr, lam - 1)
        sr_l = sr_lm1 * sr
        sr_lp1 = sr_l * sr
        a = rounded(A_PARAM, dtype)
        u = a * (sr_l - sr_lm1) + 1.0
        f = (a / sigma) * (lam * sr_lp1 - (lam - 1) * sr_l)
        return (torch.where(inside, u, torch.zeros_like(u)),
                torch.where(inside, f, torch.zeros_like(f)))

    def evaluate_r2(self, r2, sigma_i=1.0, sigma_j=1.0):
        """Even powers come from sr2 = (sigma/r)^2 by integer squaring; the
        single odd power needs one rsqrt.

        u        = a (sr^lam - sr^(lam-1)) + 1
        f_over_r = (a / sigma^2) (lam sr^(lam+2) - (lam-1) sr^(lam+1))
        """
        lam = self.lam
        dtype = r2.dtype
        sigma = lorentz_sigma(self.mixing, 1.0, sigma_i, sigma_j, dtype)
        cutoff = self._cutoff(sigma, dtype)
        inside = r2 < cutoff * cutoff
        r2_safe = torch.where(inside, r2, torch.ones_like(r2))
        inv_r = torch.rsqrt(r2_safe)
        sr = sigma * inv_r
        sr2 = sr * sr
        if lam % 2 == 0:
            sr_lm2 = ipow(sr2, (lam - 2) // 2)
        else:
            sr_lm2 = ipow(sr2, (lam - 3) // 2) * sr
        sr_lm1 = sr_lm2 * sr
        sr_l = sr_lm2 * sr2
        sr_lp1 = sr_l * sr
        sr_lp2 = sr_l * sr2
        a = rounded(A_PARAM, dtype)
        u = a * (sr_l - sr_lm1) + 1.0
        f_over_r = (a / (sigma * sigma)) * (lam * sr_lp2 - (lam - 1) * sr_lp1)
        return (torch.where(inside, u, torch.zeros_like(u)),
                torch.where(inside, f_over_r, torch.zeros_like(f_over_r)))
