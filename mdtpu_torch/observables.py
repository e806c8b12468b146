"""Observables: radial distribution function, mean-squared displacement,
thermo files.

Counterpart of ``mdtpu/observables.py``. The pair histogram is
:func:`mdtpu_torch.ops.rdf.rdf_histogram` (a CUDA kernel on the card, its
row-chunked plain version on the CPU); normalisation and the thermo reader
are numpy, copied from the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from mdtpu_torch.core.box import box_volume, unwrapped_positions
from mdtpu_torch.ops.rdf import rdf_histogram

__all__ = ["rdf_histogram", "rdf_normalize", "sample_rdf",
           "mean_squared_displacement", "read_thermo"]

_SPHERE_FACTOR = {2: np.pi, 3: 4.0 * np.pi / 3.0}


def rdf_normalize(counts, n_particles, volume, r_max, n_frames=1, dim=3):
    """Normalise summed histogram counts to g(r). Returns ``(r_centers,
    g)`` as numpy arrays."""
    if isinstance(counts, torch.Tensor):
        counts = counts.cpu().numpy()
    counts = np.asarray(counts, dtype=np.float64)
    n_bins = counts.shape[0]
    edges = np.linspace(0.0, r_max, n_bins + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    shell = _SPHERE_FACTOR[dim] * (edges[1:] ** dim - edges[:-1] ** dim)
    density = n_particles / volume
    ideal = shell * density * n_particles * n_frames
    return centers, counts / ideal


def half_min_width(unitcell):
    """Half the narrowest perpendicular width of the box (not its
    diagonal: a tilted cell's diagonal entries exceed its widths, and the
    minimum image aliases pairs beyond half the narrowest width)."""
    if isinstance(unitcell, torch.Tensor):
        unitcell = unitcell.cpu().numpy()
    inv = np.linalg.inv(np.asarray(unitcell, np.float64))
    widths = 1.0 / np.linalg.norm(inv, axis=1)
    return 0.5 * float(widths.min())


def sample_rdf(state, n_bins=200, r_max=None):
    """Single-frame g(r) of a particle-order state; ``r_max`` defaults to
    :func:`half_min_width` of its box. Returns ``(r_centers, g)``."""
    if r_max is None:
        r_max = half_min_width(state.unitcell)
    counts = rdf_histogram(state.positions, state.unitcell,
                           state.unitcell_inv, r_max, n_bins)
    return rdf_normalize(counts, state.n_particles, box_volume(state.unitcell),
                         r_max, n_frames=1, dim=state.dimension)


def mean_squared_displacement(state, reference_positions):
    """MSD of the state's unwrapped coordinates against reference
    (unwrapped) positions ``(N, d)``."""
    unwrapped = unwrapped_positions(state.positions, state.images,
                                    state.unitcell)
    ref = torch.as_tensor(reference_positions, dtype=unwrapped.dtype,
                          device=unwrapped.device)
    disp = unwrapped - ref
    return float(torch.mean(torch.sum(disp * disp, dim=-1)))


def read_thermo(path):
    """A thermo file written by ``run_simulation`` as a dict of numpy
    columns."""
    data = np.loadtxt(path, comments="#", ndmin=2)
    return {
        "step": data[:, 0].astype(np.int64),
        "energy": data[:, 1],
        "temperature": data[:, 2],
        "pressure": data[:, 3],
    }
