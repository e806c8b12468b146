"""Pair-interaction engines (counterpart of ``mdtpu.ops``).

Engines implement the protocol documented in :mod:`mdtpu_torch.ops.naive`:
``allocate`` / ``compute`` / ``needs_rebuild``.

  * NaivePairEngine — O(N^2) all pairs; small N and boxes too small for a
    cell grid.
  * CellGridEngine  — cell grid with the pair sweep as a CUDA kernel; 2D and
    3D boxes, orthorhombic or tilted, at larger N.
  * NeighborListEngine — padded (N, K) Verlet lists built from a cell grid,
    both the build and the force pass CUDA kernels; orthorhombic 2D and 3D
    boxes; picked only by ``prefer="neighbor"``.
  * experimental.PlaneEngine — the cell grid with the Newton half-stencil
    sweep; never picked by :func:`select_engine`.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from mdtpu_torch.ops.naive import NaivePairEngine
from mdtpu_torch.ops.neighbor_list import NeighborListEngine

# The O(N^2) engine is picked at and below this size.
_NAIVE_MAX_N = 2048


def select_engine(potential, cutoff, state=None, *, unitcell=None,
                  n_particles=None, skin=0.3, prefer=None,
                  workload="dynamics"):
    """Pick the engine for the system.

    prefer: None (auto) | "naive" | "neighbor" | "cellgrid".
    The reference's decision (``mdtpu/ops/__init__.py:63-79``): the naive
    engine whenever the box does not fit a cell grid (fewer than 3 cells
    along some axis), whatever ``prefer`` says; otherwise
    ``NeighborListEngine.create`` for ``prefer="neighbor"`` (``ValueError``
    for a tilted box, as the JAX engine), the cell grid for
    ``prefer="cellgrid"``, and without a preference the cell grid for
    N > 2048 and the naive engine for smaller N. The grid takes 2D and 3D
    boxes, orthorhombic or tilted.

    Auto-selection never picks the list: the JAX package's CPU branch
    (``mdtpu/ops/__init__.py:82-86``, the list for orthorhombic boxes on
    the CPU) is a speed heuristic of the CPU, and whether the list should be
    the card's default is for a measurement in a benchmark cell to decide.

    workload: "dynamics" (default) or "minimize", as the JAX package's
    argument. Both give ``CellGridEngine.create``'s geometry: the JAX
    package's minimize-tuned geometry is a model of the TPU's lanes, and the
    H100's is still to be measured.
    """
    if workload not in ("dynamics", "minimize"):
        raise ValueError(f"unknown workload {workload!r}")
    from mdtpu_torch.ops.cell_grid import CellGridEngine, grid_for_box
    from mdtpu_torch.potentials.base import check_engine_cutoff

    if prefer not in (None, "naive", "neighbor", "cellgrid"):
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
               and grid_for_box(np.asarray(unitcell), float(cutoff),
                                float(skin)) is not None)
    if not grid_ok or (prefer is None and (n_particles is None
                                           or n_particles <= _NAIVE_MAX_N)):
        _warn_if_half_box_exceeded(unitcell, cutoff)
        return NaivePairEngine(potential=potential, cutoff=cutoff)
    if prefer == "neighbor":
        return NeighborListEngine.create(
            potential, float(cutoff), float(skin), np.asarray(unitcell),
            int(n_particles), max_sigma=max_sigma)
    return CellGridEngine.create(
        potential, float(cutoff), float(skin), np.asarray(unitcell),
        int(n_particles), max_sigma=max_sigma, diameters=diameters)


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


__all__ = ["NaivePairEngine", "NeighborListEngine", "select_engine"]
