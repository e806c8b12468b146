"""Cell-grid pair engine for 3D orthorhombic boxes.

Counterpart of ``mdtpu/ops/cell_grid.py`` (``CellGridState`` and
``CellGridEngine``: ``create``, ``with_grown_capacity``, ``allocate``,
``needs_rebuild``, ``compute``). Particles are binned into a periodic grid of
cells of side >= cutoff + skin and sorted into ``C`` slots per cell at
rebuild time. Each step :meth:`CellGridEngine.compute` scatters the current
positions into the slots, runs the pair sweep
(:func:`mdtpu_torch.ops.cell_sweep.cell_sweep`, a CUDA kernel on the card)
and gathers the forces back to particle order.

Slot coordinates are stored as ``ref + MIC(pos - ref)``, so every slot sits
within skin/2 of its home cell even after the particle crossed the box edge:
the sweep's +-L image shift on wrapped neighbour cells then gives true
displacements.

Capacity overflow (more than C particles in a cell) sets ``overflow``; the
overflowing particles go to a trash slot and get no forces, so the driver
reruns the segment with :meth:`CellGridEngine.with_grown_capacity`.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch

from mdtpu_torch.core.box import _mm, is_orthorhombic, minimum_image
from mdtpu_torch.ops.cell_sweep import cell_sweep
from mdtpu_torch.potentials.base import check_engine_cutoff


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
    addr: torch.Tensor           # (N,) int64 slot of each particle: cid*C + rank
    counts: torch.Tensor         # (n_cells,) int64 particles binned per cell
    sorted_diam: torch.Tensor    # (n_cells*C,) slot diameters (1 on vacant)
    ref_positions: torch.Tensor  # (N, d) positions at build time
    overflow: torch.Tensor       # () bool: some cell holds more than C


@dataclass(frozen=True)
class CellGridEngine:
    potential: Any
    cutoff: float = 1.5
    skin: float = 0.3
    grid: Tuple[int, int, int] = (3, 3, 3)
    cell_capacity: int = 16

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
        if unitcell.shape != (3, 3) or not is_orthorhombic(unitcell):
            raise ValueError("the cell-grid engine takes 3D orthorhombic "
                             "boxes (2D and triclinic are queue A9)")
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
        return cls(potential=potential, cutoff=float(cutoff), skin=float(skin),
                   grid=grid, cell_capacity=int(cell_capacity))

    def with_grown_capacity(self):
        return dataclasses.replace(
            self, cell_capacity=int(self.cell_capacity * 1.4 + 4))

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.grid))

    # ------------------------------------------------------------------ build
    def allocate(self, positions, diameters, cell, cell_inv):
        n = positions.shape[0]
        device = positions.device
        n_cells, cap = self.n_cells, self.cell_capacity
        _, ny, nz = self.grid

        frac = _mm(positions, cell_inv.T)
        frac = frac - torch.floor(frac)
        coords = [(frac[:, k] * g).long().clamp(0, g - 1)
                  for k, g in enumerate(self.grid)]
        cid = coords[0] * (ny * nz) + coords[1] * nz + coords[2]

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
        """The sweep's inputs: (slot_pos (3, n_cells*C), slot_diam, counts,
        box lengths)."""
        n_slots = self.n_cells * self.cell_capacity
        eff = nbrs.ref_positions + minimum_image(
            positions - nbrs.ref_positions, cell, cell_inv)
        slot_pos = torch.zeros((3, n_slots + 1), dtype=positions.dtype,
                               device=positions.device)
        slot_pos[:, nbrs.addr] = eff.T
        return (slot_pos[:, :n_slots].contiguous(), nbrs.sorted_diam,
                nbrs.counts, torch.diagonal(cell).contiguous())

    def compute(self, positions, diameters, cell, cell_inv,
                nbrs: CellGridState):
        slot_pos, slot_diam, counts, box = self.slot_inputs(
            positions, cell, cell_inv, nbrs)
        energy, virial, f_slots = cell_sweep(
            slot_pos, slot_diam, counts, box, self.grid, self.cutoff,
            self.potential)
        # Back to particle order; the trash slot (overflow) reads zero.
        f_slots = torch.cat([f_slots, f_slots.new_zeros((3, 1))], dim=1)
        forces = f_slots[:, nbrs.addr].T.contiguous()
        return energy, virial, forces, nbrs
