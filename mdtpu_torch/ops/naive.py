"""All-pairs O(N^2) pair engine — the small-N engine and the test oracle.

Counterpart of ``mdtpu/ops/naive.py``. For every pair within the engine
cutoff it evaluates the potential and accumulates the total energy, the
scalar virial W = sum_{i<j} f_ij * r_ij and per-particle forces. Pairs are
computed component-wise as (N, N) arrays, from both sides, and halved.

Engine protocol (shared by all engines):
    nbrs  = engine.allocate(positions, diameters, cell, cell_inv)
    out   = engine.compute(positions, diameters, cell, cell_inv, nbrs)
    # out = (energy, virial, forces, nbrs')
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from mdtpu_torch.potentials.base import potential_values


def _minimum_image_components(d_comps, cell, cell_inv):
    """Minimum-image per-component displacement arrays (any cell)."""
    dim = len(d_comps)
    frac = [sum(cell_inv[k, j] * d_comps[j] for j in range(dim))
            for k in range(dim)]
    frac = [f - torch.round(f) for f in frac]
    return [sum(cell[i, k] * frac[k] for k in range(dim)) for i in range(dim)]


@dataclass(frozen=True)
class NaivePairEngine:
    potential: Any
    cutoff: float = 1.5

    def allocate(self, positions, diameters, cell, cell_inv):
        return ()

    def compute(self, positions, diameters, cell, cell_inv, nbrs=()):
        n, dim = positions.shape
        comps = [positions[:, k] for k in range(dim)]
        d_comps = [c[:, None] - c[None, :] for c in comps]
        d_comps = _minimum_image_components(d_comps, cell, cell_inv)
        r2 = sum(dc * dc for dc in d_comps)

        eye = torch.eye(n, dtype=torch.bool, device=positions.device)
        mask = (~eye) & (r2 < float(self.cutoff) ** 2)

        r2_safe = torch.where(mask, r2, torch.ones_like(r2))
        u, f_over_r = potential_values(self.potential, "evaluate_r2", r2_safe,
                                       diameters[:, None], diameters[None, :])
        u = torch.where(mask, u, torch.zeros_like(u))
        f_over_r = torch.where(mask, f_over_r, torch.zeros_like(f_over_r))

        energy = 0.5 * torch.sum(u)
        virial = 0.5 * torch.sum(f_over_r * r2_safe)
        forces = torch.stack(
            [torch.sum(f_over_r * dc, dim=1) for dc in d_comps], dim=-1)
        return energy, virial, forces, nbrs

    def needs_rebuild(self, positions, nbrs, cell, cell_inv, out=None,
                      handle=None):
        """Never: a static False, so a step makes no test (the JAX
        package's step skips its ``cond``)."""
        return False
