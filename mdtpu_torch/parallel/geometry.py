"""The cell grid of a sharded run: the single-device rule with nx a multiple
of the ring's size.

Counterpart of ``mdtpu/parallel/geometry.py`` (``tuned_sharded_geometry``)
without the TPU's lane cost model: the port takes its own rule
(:func:`mdtpu_torch.ops.cell_grid.grid_for_box`: lattice planes at least
cutoff + skin apart), rounds the x axis down to a multiple of the ring's
size, so that every rank owns an equal slab of x-planes, and widens the skin
to what the cells then allow.
"""

from __future__ import annotations

import math

import numpy as np

from mdtpu_torch.ops.cell_grid import grid_for_box


def sharded_geometry(cutoff, unitcell, n_particles, n_shards, min_skin=0.3,
                     cell_capacity=None):
    """``(grid, cell_capacity, skin)`` of a grid whose x axis splits into
    ``n_shards`` equal slabs. The capacity is ``CellGridEngine.create``'s
    (mean occupancy + 3.5 sigma + 2) unless given; the skin is the narrowest
    cell width (lattice plane spacing over cells) less the cutoff.
    ``ValueError``, as the JAX package's, where the box has fewer than
    ``n_shards`` x-planes of cutoff + ``min_skin`` or fewer than 3 on another
    axis."""
    cell = np.asarray(unitcell, np.float64)
    heights = 1.0 / np.linalg.norm(np.linalg.inv(cell), axis=1)
    g_max = [int(h / (cutoff + min_skin)) for h in heights]
    if g_max[0] < n_shards or min(g_max[1:]) < 3:
        raise ValueError(
            f"box too small to shard {g_max[0]} feasible x-planes over "
            f"{n_shards} devices at this cutoff")
    grid = grid_for_box(cell, cutoff, min_skin)
    grid = (grid[0] // n_shards * n_shards,) + tuple(grid[1:])
    skin = min(heights[k] / grid[k] for k in range(len(grid))) - cutoff
    if cell_capacity is None:
        mean = n_particles / math.prod(grid)
        cell_capacity = int(math.ceil(mean + 3.5 * math.sqrt(mean) + 2))
    return grid, int(cell_capacity), float(skin)
