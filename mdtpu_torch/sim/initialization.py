"""State construction and velocity initialization.

Counterpart of ``mdtpu/sim/initialization.py``: ``lattice_positions``,
``initialize_velocities``, ``build_state_from_arrays``,
``lattice_fluid_state`` and ``initialize_state`` modes A (positions given)
and B (``from_file``). Modes C and D pack random positions with FIRE, which
is not ported yet (queue A10).

Random numbers come from a CPU ``torch.Generator`` seeded by the caller, so
a seed gives the same state on every device.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from mdtpu_torch.core.box import to_unitcell
from mdtpu_torch.core.types import Parameters, SimulationState
from mdtpu_torch.io.xyz import read_xyz, write_xyz
from mdtpu_torch.utils.device import resolve_device


def _normal(shape, seed, dtype):
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return torch.randn(shape, generator=g, dtype=dtype)


def lattice_positions(n_particles, unitcell, dimension=3, dtype=torch.float32,
                      jitter=0.0, seed=0, device=None):
    """Simple-cubic (square in 2D) lattice filling the box, optionally
    jittered by ``jitter`` standard normals."""
    device = resolve_device(device)
    cell = (unitcell.detach().cpu().numpy() if isinstance(unitcell, torch.Tensor)
            else np.asarray(unitcell))
    cell = np.asarray(cell, dtype=np.float64)
    per_side = int(np.ceil(n_particles ** (1.0 / dimension)))
    idx = np.indices((per_side,) * dimension).reshape(dimension, -1).T[:n_particles]
    frac = (idx + 0.5) / per_side
    pos = torch.as_tensor(frac @ cell.T, dtype=dtype)
    if jitter > 0.0:
        pos = pos + jitter * _normal(pos.shape, seed, dtype)
    return pos.to(device)


def initialize_velocities(ktemp, seed, n_particles, dimension,
                          dtype=torch.float32, device=None):
    """Maxwell-Boltzmann velocities at temperature ``ktemp`` with the
    centre-of-mass motion removed and an exact rescale to nf = d*(N-1)."""
    device = resolve_device(device)
    v = _normal((n_particles, dimension), seed, dtype).to(device)
    v = v - torch.mean(v, dim=0, keepdim=True)
    sum_v2 = torch.sum(v * v)
    fs = torch.sqrt(ktemp / (sum_v2 / ((n_particles - 1) * dimension)))
    return v * fs


def build_state_from_arrays(positions, diameters, unitcell, seed=0, *,
                            velocities=None, dtype=torch.float32,
                            cutoff: float = 1.5, step: int = 0,
                            device=None) -> SimulationState:
    """Assemble a SimulationState from raw arrays (zeros where the reference
    leaves fields empty: velocities, images, forces)."""
    device = resolve_device(device)

    def t(x):
        return torch.as_tensor(x, dtype=dtype).to(device)

    positions = t(positions)
    n, dim = positions.shape
    cell_np = (unitcell.detach().cpu().numpy()
               if isinstance(unitcell, torch.Tensor) else np.asarray(unitcell))
    cell = t(cell_np)
    # Host-side inverse in float64: the cell is constant for a run.
    cell_inv = t(np.linalg.inv(np.asarray(cell_np, dtype=np.float64)))
    velocities = (torch.zeros_like(positions) if velocities is None
                  else t(velocities))
    zero = torch.zeros((), dtype=dtype, device=device)
    return SimulationState(
        positions=positions,
        velocities=velocities,
        forces=torch.zeros_like(positions),
        images=torch.zeros((n, dim), dtype=torch.int64, device=device),
        diameters=t(diameters),
        unitcell=cell,
        unitcell_inv=cell_inv,
        seed=int(seed),
        step=int(step),
        nf=float(dim * (n - 1.0)),
        energy=zero,
        virial=zero,
        temperature=zero,
        pos_comp=torch.zeros_like(positions),
        vel_comp=torch.zeros_like(positions),
        nbrs=None,
        cutoff=float(cutoff),
    )


def initialize_state(
    params: Parameters,
    pathname: str,
    *,
    from_file: str = "",
    dimension: int = 3,
    random_init: bool = False,
    cutoff: float = 1.5,
    seed: int = 0,
    unitcell: Any = None,
    positions: Any = None,
    diameters: Any = None,
    dtype=torch.float32,
    pack_tol: float = 1.0,
    device=None,
) -> SimulationState:
    """Construct the simulation state and write ``init.xyz`` into
    ``pathname``.

    Modes, in priority order:
      A. user-provided ``positions`` (+ ``diameters``; box from the
         coordinates' bounding box if ``unitcell`` is absent);
      B. ``from_file``: read an Extended-XYZ snapshot;
      C/D. random packing in a given or default box: not ported yet
         (queue A10), raises ``NotImplementedError``.

    ``random_init`` and ``pack_tol`` are accepted for signature parity.
    Velocities are left at zero; assign them with
    ``state.replace(velocities=initialize_velocities(...))``."""
    device = resolve_device(device)
    if positions is not None:
        positions = np.asarray(positions, dtype=np.float64)
        n = positions.shape[0]
        if diameters is None:
            diameters = np.ones(n)
        if unitcell is None:
            span = positions.max(axis=0) - positions.min(axis=0)
            cell = to_unitcell(span, dimension, dtype)
        else:
            cell = to_unitcell(unitcell, dimension, dtype)
    elif from_file:
        cell, positions, diameters = read_xyz(from_file, dimension)
    else:
        raise NotImplementedError(
            "random packed initialization (modes C and D) needs the FIRE "
            "packer, which is not ported yet (queue A10); pass positions= "
            "or from_file=")
    os.makedirs(pathname, exist_ok=True)
    state = build_state_from_arrays(positions, diameters, cell, seed,
                                    dtype=dtype, cutoff=cutoff, device=device)
    write_xyz(os.path.join(pathname, "init.xyz"), 0, state.unitcell,
              state.positions, state.diameters, mode="w")
    return state


def lattice_fluid_state(n_particles, density, temperature, *, dimension=3,
                        dtype=torch.float32, cutoff=1.5, jitter=0.01,
                        seed=0, device=None) -> SimulationState:
    """Jittered-lattice fluid with Maxwell velocities in a cubic rho-box."""
    device = resolve_device(device)
    L = (n_particles / density) ** (1.0 / dimension)
    # f32-rounded box length in every dtype, as the JAX package does.
    cell = np.eye(dimension) * float(np.float32(L))
    pos = lattice_positions(n_particles, cell, dimension, dtype=dtype,
                            jitter=jitter, seed=seed, device=device)
    state = build_state_from_arrays(pos, np.ones(n_particles), cell, seed + 1,
                                    dtype=dtype, cutoff=cutoff, device=device)
    v = initialize_velocities(temperature, seed + 2, n_particles, dimension,
                              dtype=dtype, device=device)
    return state.replace(velocities=v)
