"""The packer's contact potential (counterpart of the JAX package's
``OverlapPotential`` in ``mdtpu/sim/pack.py``; re-exported from
:mod:`mdtpu_torch.sim.pack`). The CUDA sweeps evaluate it through the
``Overlap`` functor of ``csrc/pair_potentials.cuh``."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mdtpu_torch.potentials.base import Potential, rounded


@dataclass(frozen=True)
class OverlapPotential(Potential):
    """Harmonic contact repulsion: u = (tol - r)^2, f = 2 (tol - r) for
    r < tol."""

    tol: float = 1.0

    def evaluate(self, r, sigma_i=1.0, sigma_j=1.0):
        overlap = torch.clamp(rounded(self.tol, r.dtype) - r, min=0.0)
        return overlap * overlap, 2.0 * overlap

    def max_cutoff(self, max_sigma=1.0):
        return float(self.tol)
