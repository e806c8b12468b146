"""``PlaneEngine``: the cell-grid engine with the Newton half-stencil sweep.

Counterpart of ``mdtpu/ops/experimental/pallas_plane.py::PallasPlaneEngine``:
the same binning, rebuild rule and slot layout as
:class:`mdtpu_torch.ops.cell_grid.CellGridEngine`, with the pair sweep
replaced by :func:`mdtpu_torch.ops.plane_sweep.plane_sweep` (the counterpart
of the Pallas ``_plane_kernel`` and its reaction fold-back; a CUDA kernel on
the card). Unlike the Pallas kernel it takes float64 too.

Drive it through the normal entry point::

    engine = PlaneEngine.create(LennardJones(r_cut=2.5), 2.5, 0.3,
                                state.unitcell, state.n_particles)
    run_simulation(state, params, ensemble, steps, every, out,
                   engine=engine, compensated=False)

``select_engine`` does not pick it. With the hi/lo sweep on (float32 NVE
with ``compensated=True`` and ``precision="auto"``, or ``"f32x2"``) forces
come from the hi/lo variant of the full-stencil kernel, as the JAX package
routes that case to its XLA hi/lo sweep.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch

from mdtpu_torch.core.box import is_orthorhombic
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.plane_sweep import plane_sweep


@dataclass(frozen=True)
class PlaneEngine(CellGridEngine):
    """:class:`CellGridEngine` whose sweep is the Newton half stencil;
    ``create`` and ``with_grown_capacity`` are inherited and keep the
    type. It keeps the particle-order step: the slot loop would call the
    full-stencil sweep."""

    runs_in_slots: ClassVar[bool] = False

    @classmethod
    def create(cls, potential, cutoff, skin, unitcell, n_particles, **kw):
        """:meth:`CellGridEngine.create` for a 3D orthorhombic box, the only
        box the half-stencil kernel takes; ``ValueError`` for any other."""
        cell = (unitcell.detach().cpu().numpy()
                if isinstance(unitcell, torch.Tensor)
                else np.asarray(unitcell))
        if cell.shape != (3, 3) or not is_orthorhombic(cell):
            raise ValueError("PlaneEngine takes 3D orthorhombic boxes; use "
                             "CellGridEngine for 2D and tilted ones")
        return super().create(potential, cutoff, skin, unitcell, n_particles,
                               **kw)

    def sweep(self, slot_pos, slot_diam, counts, box):
        return plane_sweep(slot_pos, slot_diam, counts, box, self.grid,
                           self.cutoff, self.potential)
