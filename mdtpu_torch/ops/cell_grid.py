"""Cell-grid pair engine for 2D and 3D boxes, orthorhombic or tilted.

Counterpart of ``mdtpu/ops/cell_grid.py`` (``CellGridState`` and
``CellGridEngine``: ``create``, ``with_grown_capacity``, ``allocate``,
``needs_rebuild``, ``compute``). Particles are binned on their fractional
coordinates into a periodic grid of cells whose lattice planes lie at least
cutoff + skin apart (:func:`grid_for_box`) and sorted into ``C`` slots per
cell at rebuild time. Each step :meth:`CellGridEngine.compute` scatters the
current positions into the slots, runs the pair sweep
(:func:`mdtpu_torch.ops.cell_sweep.cell_sweep`, a CUDA kernel on the card)
and gathers the forces back to particle order.

Slot coordinates are stored as ``ref + MIC(pos - ref)``, so every slot sits
within skin/2 of its home cell even after the particle crossed the box edge:
the sweep's image shift on wrapped neighbour cells (the cell vectors of the
wrap) then gives true displacements. With the positions' low words
(``compute(..., pos_lo=...)``) the hi/lo sweep runs on the same layout
(:meth:`slot_inputs_hilo`).

Capacity overflow (more than C particles in a cell) sets ``overflow``; the
overflowing particles go to a trash slot and get no forces, so the driver
reruns the segment with :meth:`CellGridEngine.with_grown_capacity`.

The slot-space loop (:mod:`mdtpu_torch.integrate.slot_step`) keeps the whole
state in slot order instead and calls :meth:`CellGridEngine.compute_slots`:
the sweep on the slots as they are, with no scatter, gather or minimum image.

The sweep is the B1 kernel for a potential it has a functor for, and the
pair-list route (:mod:`mdtpu_torch.ops.cell_pairs`) for any other, chosen by
the potential's type (:attr:`CellGridEngine.uses_pair_list`). The list's
buffer holds ``pair_capacity`` entries, sized by :meth:`CellGridEngine.create`
and grown with the cell capacity, and is kept across calls; a longer list
sets the engine state's ``overflow`` flag as a full cell does.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, ClassVar, Optional, Tuple

import numpy as np
import torch

from mdtpu_torch.core.box import _mm, minimum_image
from mdtpu_torch.ops.cell_pairs import (PairListWorkspace, list_capacity,
                                        pair_sweep)
from mdtpu_torch.ops.cell_sweep import (cell_sweep, cell_sweep_hilo,
                                        kernel_params)
from mdtpu_torch.potentials.base import check_engine_cutoff
from mdtpu_torch.utils.math import two_sum


def cell_ids(frac, grid):
    """Row-major cell index of fractional coordinates in [0, 1], one tensor
    per axis: ``(c_0 g_1 + c_1) g_2 + c_2`` (``c_0 g_1 + c_1`` in 2D), each
    ``c_a = floor(f_a g_a)`` clamped into the grid (a coordinate that rounds
    to 1 bins into the last cell)."""
    cid = 0
    for f, g in zip(frac, grid):
        cid = cid * g + (f * g).long().clamp(0, g - 1)
    return cid


def grid_for_box(unitcell, cutoff: float, skin: float):
    """Cells per axis: floor(h_i / (cutoff + skin)) where h_i is the distance
    between the cell's lattice planes along axis i. None if any axis would
    have fewer than 3 cells."""
    cell = np.asarray(unitcell, dtype=np.float64)
    heights = 1.0 / np.linalg.norm(np.linalg.inv(cell), axis=1)
    grid = tuple(int(x) for x in np.floor(heights / (cutoff + skin)))
    if any(g < 3 for g in grid):
        return None
    return grid


@dataclass(frozen=True)
class CellGridState:
    """The binning. In the slot layout ``addr`` is None, ``ref_positions``
    is ``(d, n_slots)`` in slot order and ``occupied`` marks the real slots:
    those of cell ``c`` are ``c*C .. c*C + min(counts[c], C) - 1``."""

    addr: Optional[torch.Tensor]  # (N,) int64 slot of each particle: cid*C + rank
    counts: torch.Tensor         # (n_cells,) int64 particles binned per cell
    sorted_diam: torch.Tensor    # (n_cells*C,) slot diameters (1 on vacant)
    ref_positions: torch.Tensor  # (N, d) positions at build time
    overflow: torch.Tensor       # () bool: some cell holds more than C
    occupied: Optional[torch.Tensor] = None  # (n_cells*C,) bool, slot layout


@dataclass(frozen=True)
class CellGridEngine:
    potential: Any
    cutoff: float = 1.5
    skin: float = 0.3
    grid: Tuple[int, ...] = (3, 3, 3)
    cell_capacity: int = 16
    # Entries of the pair list (the route of a potential without a kernel
    # functor); 0: room for 8 hits a slot.
    pair_capacity: int = 0
    # The list's buffers, kept across calls (and by a grown copy, which
    # takes new ones at its new capacity).
    pair_workspace: Any = field(default_factory=PairListWorkspace,
                                compare=False, repr=False)
    # The driver and FIRE run this engine in the slot layout.
    runs_in_slots: ClassVar[bool] = True

    @classmethod
    def create(cls, potential, cutoff, skin, unitcell, n_particles,
               cell_capacity=None, max_sigma=1.0, diameters=None):
        if isinstance(unitcell, torch.Tensor):
            unitcell = unitcell.detach().cpu().numpy()
        unitcell = np.asarray(unitcell, np.float64)
        if diameters is not None:
            d = (diameters.detach().cpu().numpy()
                 if isinstance(diameters, torch.Tensor) else diameters)
            max_sigma = max(max_sigma, float(np.max(np.asarray(d))))
        check_engine_cutoff(potential, cutoff, max_sigma)
        if unitcell.shape not in ((2, 2), (3, 3)):
            raise ValueError(f"the cell grid takes 2D and 3D boxes, got a "
                             f"cell of shape {unitcell.shape}")
        grid = grid_for_box(unitcell, cutoff, skin)
        if grid is None:
            raise ValueError(
                "box too small for a cell grid at this cutoff; use "
                "NaivePairEngine")
        if cell_capacity is None:
            # Mean occupancy + 3.5 sigma: rare overflows are handled by the
            # driver's grown-capacity rerun.
            mean_occ = n_particles / int(np.prod(grid))
            cell_capacity = int(math.ceil(mean_occ + 3.5 * math.sqrt(mean_occ)
                                          + 2))
        pair_capacity = 0
        if kernel_params(potential) is None:
            pair_capacity = list_capacity(
                n_particles, abs(float(np.linalg.det(unitcell))),
                float(cutoff), len(grid))
        return cls(potential=potential, cutoff=float(cutoff), skin=float(skin),
                   grid=grid, cell_capacity=int(cell_capacity),
                   pair_capacity=pair_capacity)

    def with_grown_capacity(self):
        """The engine with 1.4 times the cell capacity (plus 4) and, on the
        pair-list route, 1.4 times the list's room (plus 1024)."""
        return dataclasses.replace(
            self, cell_capacity=int(self.cell_capacity * 1.4 + 4),
            pair_capacity=(int(self.pair_capacity * 1.4) + 1024
                           if self.pair_capacity else 0))

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.grid))

    @property
    def uses_pair_list(self) -> bool:
        """Whether the pair sweep goes through the pair list: the potential
        has no functor in the sweep kernels (a choice by type)."""
        return kernel_params(self.potential) is None

    @property
    def pair_list_capacity(self) -> int:
        """Entries of the pair list's buffer."""
        return self.pair_capacity or 8 * self.n_cells * self.cell_capacity

    # ------------------------------------------------------------------ build
    def allocate(self, positions, diameters, cell, cell_inv):
        n = positions.shape[0]
        device = positions.device
        n_cells, cap = self.n_cells, self.cell_capacity

        frac = _mm(positions, cell_inv.T)
        frac = frac - torch.floor(frac)
        cid = cell_ids([frac[:, k] for k in range(frac.shape[1])], self.grid)

        order = torch.argsort(cid, stable=True)
        cid_sorted = cid[order]
        counts = torch.zeros(n_cells, dtype=torch.int64, device=device)
        counts.scatter_add_(0, cid, torch.ones_like(cid))
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(n, device=device) - starts[cid_sorted]
        overflow = torch.any(counts > cap)

        addr_sorted = torch.where(rank < cap, cid_sorted * cap + rank,
                                  torch.full_like(rank, n_cells * cap))
        addr = torch.empty_like(addr_sorted).scatter_(0, order, addr_sorted)

        # One trash slot past the end takes the overflowing particles.
        sorted_diam = torch.ones(n_cells * cap + 1, dtype=diameters.dtype,
                                 device=device)
        sorted_diam[addr] = diameters
        return CellGridState(addr=addr, counts=counts,
                             sorted_diam=sorted_diam[:-1].contiguous(),
                             ref_positions=positions, overflow=overflow)

    # ---------------------------------------------------------------- rebuild
    def needs_rebuild(self, positions, nbrs: CellGridState, cell, cell_inv):
        disp = minimum_image(positions - nbrs.ref_positions, cell, cell_inv)
        half_skin = 0.5 * self.skin
        return torch.any(torch.sum(disp * disp, dim=-1)
                         > half_skin * half_skin)

    # ---------------------------------------------------------------- forces
    def slot_inputs(self, positions, cell, cell_inv, nbrs: CellGridState):
        """The sweep's inputs: (slot_pos (d, n_cells*C), slot_diam, counts,
        the (d, d) cell matrix)."""
        n_slots = self.n_cells * self.cell_capacity
        eff = nbrs.ref_positions + minimum_image(
            positions - nbrs.ref_positions, cell, cell_inv)
        slot_pos = torch.zeros((positions.shape[1], n_slots + 1),
                               dtype=positions.dtype, device=positions.device)
        slot_pos[:, nbrs.addr] = eff.T
        return (slot_pos[:, :n_slots].contiguous(), nbrs.sorted_diam,
                nbrs.counts, cell.contiguous())

    def slot_inputs_hilo(self, positions, pos_lo, cell, cell_inv,
                         nbrs: CellGridState):
        """The hi/lo sweep's inputs: (slot_hi, slot_lo, slot_diam, counts,
        the cell matrix). ``pos_lo`` is the low word of each position (true
        = positions + pos_lo; the driver passes ``-pos_comp``). The image
        ``n`` that :func:`minimum_image` picks for ``positions - ref`` is
        taken off through error-free two_sums, one cell vector at a
        time: ``hi, r = two_sum(hi, -n_a cell[:, a])`` and ``lo += r``, so
        the pair stays exact where ``ref + MIC(pos - ref)`` would round
        twice."""
        n_slots = self.n_cells * self.cell_capacity
        frac = _mm(positions - nbrs.ref_positions, cell_inv.T)
        n_img = torch.round(frac)
        hi, lo = positions, pos_lo
        for a in range(positions.shape[1]):
            hi, r = two_sum(hi, -n_img[:, a:a + 1] * cell[:, a])
            lo = lo + r
        out = []
        for t in (hi, lo):
            slots = torch.zeros((positions.shape[1], n_slots + 1),
                                dtype=positions.dtype,
                                device=positions.device)
            slots[:, nbrs.addr] = t.T
            out.append(slots[:, :n_slots].contiguous())
        return (*out, nbrs.sorted_diam, nbrs.counts, cell.contiguous())

    def sweep(self, slot_pos, slot_diam, counts, box):
        """The engine's pair sweep on slot inputs (the B1 kernel)."""
        return cell_sweep(slot_pos, slot_diam, counts, box, self.grid,
                          self.cutoff, self.potential)

    def _pair_sweep(self, slot_pos, slot_diam, counts, cell, nbrs,
                    observables=True, slot_lo=None):
        """The pair-list route; its overflow joins the engine state's."""
        energy, virial, force, over = pair_sweep(
            slot_pos, slot_diam, counts, cell, self.grid, self.cutoff,
            self.potential, self.pair_list_capacity, observables, slot_lo,
            workspace=self.pair_workspace)
        return energy, virial, force, dataclasses.replace(
            nbrs, overflow=nbrs.overflow | over)

    def compute_slots(self, positions, diameters, cell, cell_inv,
                      nbrs: CellGridState, observables=True, pos_lo=None):
        """``(energy, virial, forces, nbrs)`` of a slot-layout state:
        positions ``(d, n_cells*C)`` already in cell-sorted slot order,
        within skin/2 of their home cells (deferred wrap), so the sweep runs
        on them as they are: no scatter, no gather, no minimum image. Forces
        come back in slot order. ``observables=False`` runs the lean sweep
        (energy and virial zero). ``pos_lo``: the positions' lo words for the
        hi/lo sweep, taken as given (deferred wrap keeps the image at 0
        between rebuilds, so there is no image shift to fold in).
        ``cell_inv`` is unused; it keeps the JAX package's signature."""
        cell = cell.contiguous()
        if self.uses_pair_list:
            return self._pair_sweep(positions, diameters, nbrs.counts, cell,
                                    nbrs, observables, pos_lo)
        if pos_lo is None:
            energy, virial, forces = cell_sweep(
                positions, diameters, nbrs.counts, cell, self.grid,
                self.cutoff, self.potential, observables)
        else:
            energy, virial, forces = cell_sweep_hilo(
                positions, pos_lo, diameters, nbrs.counts, cell, self.grid,
                self.cutoff, self.potential, observables)
        return energy, virial, forces, nbrs

    def compute(self, positions, diameters, cell, cell_inv,
                nbrs: CellGridState, pos_lo=None):
        """``(energy, virial, forces, nbrs)``. With ``pos_lo`` (float32, the
        low words of the positions) the hi/lo sweep runs."""
        if self.uses_pair_list:
            if pos_lo is None:
                slot_pos, diam, counts, cell_m = self.slot_inputs(
                    positions, cell, cell_inv, nbrs)
                slot_lo = None
            else:
                slot_pos, slot_lo, diam, counts, cell_m = \
                    self.slot_inputs_hilo(positions, pos_lo, cell, cell_inv,
                                          nbrs)
            energy, virial, f_slots, nbrs = self._pair_sweep(
                slot_pos, diam, counts, cell_m, nbrs, slot_lo=slot_lo)
        elif pos_lo is None:
            energy, virial, f_slots = self.sweep(*self.slot_inputs(
                positions, cell, cell_inv, nbrs))
        else:
            energy, virial, f_slots = cell_sweep_hilo(
                *self.slot_inputs_hilo(positions, pos_lo, cell, cell_inv,
                                       nbrs),
                self.grid, self.cutoff, self.potential)
        # Back to particle order; the trash slot (overflow) reads zero.
        f_slots = torch.cat([f_slots, f_slots.new_zeros((f_slots.shape[0],
                                                         1))], dim=1)
        forces = f_slots[:, nbrs.addr].T.contiguous()
        return energy, virial, forces, nbrs
