"""Random packing (the Packmol replacement).

Counterpart of ``mdtpu/sim/pack.py``: draw uniform positions in the box,
then FIRE-minimize the short-range harmonic overlap energy U = sum_{r_ij <
tol} (tol - r_ij)^2 until no pair is closer than ``tol``. On the card, a
system large enough for the cell grid packs on the B1 kernel, through its
``Overlap`` functor (``csrc/pair_potentials.cuh``).
"""

from __future__ import annotations

import numpy as np
import torch

from mdtpu_torch.core.box import _mm, wrap_positions
from mdtpu_torch.potentials.overlap import OverlapPotential
from mdtpu_torch.utils.device import resolve_device


def uniform_fractions(seed: int, shape, dtype, device):
    """Uniform fractional coordinates in [0, 1), drawn on the CPU from a
    generator seeded with ``seed`` (the same start on every device): the one
    seam where the packer's random numbers enter (tests replace it to replay
    the JAX package's draws)."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return torch.rand(shape, generator=g, dtype=dtype).to(device)


def pack_positions(seed, unitcell, n_particles, dimension, *, tol=1.0,
                   dtype=torch.float32, max_steps=2000, engine=None,
                   device=None):
    """Uniform random positions with pairwise distances >= ~``tol``, as an
    ``(N, d)`` tensor inside the box. Raises ``RuntimeError`` when FIRE
    leaves overlap energy behind after ``max_steps`` iterations."""
    import dataclasses

    from mdtpu_torch.core.types import Parameters
    from mdtpu_torch.minimize.fire import fire_minimize
    from mdtpu_torch.ops import select_engine
    from mdtpu_torch.sim.initialization import build_state_from_arrays

    device = resolve_device(device)
    cell_np = np.asarray(unitcell.detach().cpu().numpy()
                         if isinstance(unitcell, torch.Tensor) else unitcell,
                         np.float64)
    cell = torch.as_tensor(cell_np, dtype=dtype, device=device)
    frac = uniform_fractions(seed, (n_particles, dimension), dtype, device)
    positions = _mm(frac, cell.T)

    potential = OverlapPotential(tol=tol)
    if engine is None:
        engine = select_engine(potential, float(tol), unitcell=cell_np,
                               n_particles=n_particles)
    else:
        engine = dataclasses.replace(engine, potential=potential,
                                     cutoff=float(tol))
    params = Parameters(density=n_particles / abs(np.linalg.det(cell_np)),
                        n_particles=n_particles, dt=0.0, potential=potential)
    state = build_state_from_arrays(positions, np.ones(n_particles), cell,
                                    seed, dtype=dtype, cutoff=float(tol),
                                    device=device)
    state, energy, converged, _ = fire_minimize(
        state, params, engine, max_steps=max_steps, tol=1e-10,
        dt_initial=0.01, dt_max=0.15, device=device)
    # The overlap energy is exactly zero iff no pair is closer than tol; the
    # Packmol path this replaces fails loudly on non-convergence.
    energy = float(energy)
    if not converged and energy > 1e-8 * n_particles:
        raise RuntimeError(
            f"packing failed: residual overlap energy {energy:.3e} after "
            f"{max_steps} FIRE steps: lower the density, reduce tol, or "
            f"raise max_steps")
    out, _ = wrap_positions(state.positions, state.images, state.unitcell,
                            state.unitcell_inv)
    return out
