"""BASELINE config 4 through the PyTorch/CUDA port: 2D non-additive
polydisperse mixture with a custom ``evaluate`` overload, N=1200,
initialized from an XYZ snapshot (MolecularDynamics.jl README.md:147-178
pattern). The JAX twin is ``examples/03_polydisperse_2d.py``; the snapshot
is drawn with the same numpy generator, so both start from the same bytes.

    python examples_torch/03_polydisperse_2d.py         # on the card

``main(device="cpu")`` runs it on the CPU (the kernels' plain versions).
No kernel has a functor for a user's potential: on the cell grid (N above
2048) it runs on the pair list, its ``evaluate`` in torch on the listed
pairs, and at the published N on the naive engine's tiles (see
``mdtpu_torch/potentials/base.py``). On the card ``minimize`` and each
segment of ``run_simulation`` are captured into CUDA graphs, the
potential's torch operations inside them, as the JAX package traces this
``evaluate`` into its jitted loops: so it keeps the capture contract that
file states (no read back to the host, no tensor made from host data, no
Python branch on a value)."""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from mdtpu_torch import (NVT, Parameters, Potential, initialize_state,
                         initialize_velocities, minimize, run_simulation)
from mdtpu_torch.io.xyz import write_xyz
from mdtpu_torch.potentials.base import rounded
from mdtpu_torch.utils.math import ipow


@dataclasses.dataclass(frozen=True)
class NonAdditivePHS(Potential):
    """Pseudo-HS-style repulsion with non-additive cross diameters
    sigma_ij = 0.5 (s_i + s_j)(1 - 0.2 |s_i - s_j|).

    Written to the port's potential contract: torch operations that
    broadcast over tensors of r, sigma_i and sigma_j, scalars as Python
    numbers rounded to the working dtype (no tensor made per call, no read
    back to the host, no branch on a value: on the card it runs inside a
    CUDA graph, captured once and replayed every step), exact zeros beyond
    the cutoff."""

    lam: int = 12

    def evaluate(self, r, sigma_i, sigma_j):
        sigma = 0.5 * (sigma_i + sigma_j) * (1.0 - 0.2 * torch.abs(
            sigma_i - sigma_j))
        cutoff = 1.25 * sigma
        inside = r < cutoff
        r_safe = torch.where(inside, r, torch.ones_like(r))
        sr = sigma / r_safe
        u_raw = ipow(sr, self.lam)
        f_raw = self.lam * u_raw / r_safe
        # Energy- AND force-shift so both reach zero smoothly at the
        # cutoff: u -> u - u(rc) - (r - rc) u'(rc). A bare truncation
        # injects an energy jump at every cutoff crossing (visible NVE
        # drift and a discontinuous landscape for FIRE).
        u_c = ipow(rounded(1 / 1.25, r.dtype), self.lam)
        f_c = self.lam * u_c / cutoff
        u = u_raw - u_c + (r_safe - cutoff) * f_c
        f = f_raw - f_c
        zero = torch.zeros_like(u)
        return torch.where(inside, u, zero), torch.where(inside, f, zero)


def main(n_particles=1200, steps=5_000, out="./out_poly2d", device=None):
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(0)
    # Write a polydisperse snapshot, then init from file (config 4 workflow).
    density = 0.9
    L = (n_particles / density) ** 0.5
    diam = rng.uniform(0.8, 1.2, n_particles)
    pos = rng.uniform(0, L, (n_particles, 2))
    snap = os.path.join(out, "start.xyz")
    write_xyz(snap, 0, np.eye(2) * L, pos, diam, mode="w")

    params = Parameters(density=density, n_particles=n_particles, dt=1e-4,
                        potential=NonAdditivePHS())
    state = initialize_state(params, out, from_file=snap, dimension=2,
                             cutoff=1.8, dtype=torch.float64, device=device)
    state, e, conv, _ = minimize(state, params, out, 2, tol=1e-4,
                                 device=device)
    state = state.replace(velocities=initialize_velocities(
        0.5, 1, n_particles, 2, torch.float64, device=device))
    state = run_simulation(state, params, NVT(0.5, 0.01), steps, 200, out,
                           device=device)
    print(f"2D polydisperse done: T = {float(state.temperature):.4f}")
    return state


if __name__ == "__main__":
    main()
