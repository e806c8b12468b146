"""Pair-interaction engines (counterpart of ``mdtpu.ops``).

Engines implement the protocol documented in :mod:`mdtpu_torch.ops.naive`:
``allocate`` / ``compute`` / ``needs_rebuild``.

  * NaivePairEngine — O(N^2) all pairs; small N, triclinic and 2D boxes.
  * CellGridEngine  — cell grid with the pair sweep as a CUDA kernel; 3D
    orthorhombic boxes at larger N.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from mdtpu_torch.ops.naive import NaivePairEngine

# The O(N^2) engine is picked at and below this size.
_NAIVE_MAX_N = 2048


def select_engine(potential, cutoff, state=None, *, unitcell=None,
                  n_particles=None, skin=0.3, prefer=None):
    """Pick the engine for the system.

    prefer: None (auto) | "naive" | "cellgrid".
    Auto: naive for N <= 2048; the cell grid for a 3D orthorhombic box that
    fits at least 3 cells per axis. Triclinic and 2D boxes take the naive
    engine until the cell grid covers them (queue A9); there is no
    neighbour-list engine yet (queue A12).
    """
    from mdtpu_torch.core.box import is_orthorhombic
    from mdtpu_torch.ops.cell_grid import CellGridEngine, grid_for_box
    from mdtpu_torch.potentials.base import check_engine_cutoff

    if prefer not in (None, "naive", "cellgrid"):
        if prefer == "neighbor":
            raise NotImplementedError(
                "the neighbour-list engine is not ported yet (queue A12)")
        raise ValueError(f"unknown engine preference {prefer!r}")
    max_sigma = 1.0
    diameters = None
    if state is not None:
        unitcell = state.unitcell
        n_particles = state.n_particles
        diameters = state.diameters.detach().cpu().numpy()
        max_sigma = float(np.max(diameters))
    if isinstance(unitcell, torch.Tensor):
        unitcell = unitcell.detach().cpu().numpy()
    check_engine_cutoff(potential, cutoff, max_sigma)

    if prefer == "naive":
        return NaivePairEngine(potential=potential, cutoff=cutoff)
    grid_ok = (unitcell is not None
               and np.asarray(unitcell).shape == (3, 3)
               and is_orthorhombic(unitcell)
               and grid_for_box(np.asarray(unitcell), float(cutoff),
                                float(skin)) is not None)
    if prefer == "cellgrid" or (grid_ok and n_particles is not None
                                and n_particles > _NAIVE_MAX_N):
        return CellGridEngine.create(
            potential, float(cutoff), float(skin), np.asarray(unitcell),
            int(n_particles), max_sigma=max_sigma, diameters=diameters)
    _warn_if_half_box_exceeded(unitcell, cutoff)
    return NaivePairEngine(potential=potential, cutoff=cutoff)


def _warn_if_half_box_exceeded(unitcell, cutoff):
    """Minimum-image engines only see the nearest periodic image: with a box
    narrower than 2*cutoff a pair can also interact through a second image,
    which is missed. Warn rather than raise."""
    if unitcell is None:
        return
    u = np.asarray(unitcell, np.float64)
    widths = 1.0 / np.linalg.norm(np.linalg.inv(u), axis=1)
    if float(widths.min()) < 2.0 * float(cutoff):
        warnings.warn(
            f"box width {widths.min():.3g} < 2*cutoff = {2 * float(cutoff):.3g}: "
            "the minimum-image pair sweep misses second-image interactions "
            "for this system (use a larger box for true periodic physics)")


__all__ = ["NaivePairEngine", "select_engine"]
