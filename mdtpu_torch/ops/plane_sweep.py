"""The Newton half-stencil pair sweep: a hand-written CUDA kernel and its
plain version.

Counterpart of the Pallas kernel
``mdtpu/ops/experimental/pallas_plane.py::_plane_kernel`` together with the
reaction fold-back that follows it there: forces, energy and virial of every
pair within the cutoff over the slot layout of the cell grid, with the
Newton half stencil. Each own cell meets

  * its own column, cells (0, 0, dz) for dz in {-1, 0, 1}: every pair seen
    from both sides, energy and virial at 1/2, the self pair skipped, no
    reaction;
  * the 12 Newton cells ``HALF_OFFSETS`` x dz in {-1, 0, 1}: each pair
    evaluated once, the own slot takes ``+f d`` and the neighbour slot
    ``-f d`` through a reaction partial that is folded back afterwards in a
    fixed order.

Same arguments and results as :func:`mdtpu_torch.ops.cell_sweep.cell_sweep`.
:func:`plane_sweep` launches the kernels in ``csrc/plane_sweep.cu`` for CUDA
tensors and takes :func:`plane_sweep_plain` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from mdtpu_torch.ops import _cuda_build
from mdtpu_torch.ops.cell_sweep import (MAX_CAPACITY, PairTiles, check_cuda,
                                        check_inputs, launch_sweep)

NAME = "plane_sweep"
HALF_OFFSETS = ((0, 1), (1, -1), (1, 0), (1, 1))
SELF_COLUMN = tuple((0, 0, dz) for dz in (-1, 0, 1))
NEWTON_CELLS = tuple((ox, oy, dz) for ox, oy in HALF_OFFSETS
                     for dz in (-1, 0, 1))

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGS = ((_P,) * 4 + (_I,) * 4 + (_D, _I) + (_D,) * 4 + (_I,) * 3
         + (_P,) * 4 + (_P,))
_SIGNATURES = (("mdtpu_plane_sweep_f32", _ARGS),
               ("mdtpu_plane_sweep_f64", _ARGS))


def _library():
    return _cuda_build.load(NAME, _SIGNATURES)


def build_report() -> str:
    """Build (if needed) the kernels; return the compiler's report."""
    return _cuda_build.build_report(NAME)


def plane_sweep(slot_pos, slot_diam, counts, box, grid, cutoff, potential):
    """The half-stencil sweep. CUDA tensors launch the kernels (or raise);
    CPU tensors take :func:`plane_sweep_plain`. Each launch adds one to
    ``plane_sweep.launches``. The kernel stages a (3, C, C) tile of pair
    forces in shared memory and refuses (RuntimeError) a capacity whose tile
    does not fit."""
    if slot_pos.device.type == "cpu":
        return plane_sweep_plain(slot_pos, slot_diam, counts, box, grid,
                                 cutoff, potential)
    device, dtype = check_cuda((slot_pos, slot_diam, counts, box),
                               (torch.float32, torch.float64))
    n_cells, cap = check_inputs(slot_pos, slot_diam, counts, box, grid,
                                MAX_CAPACITY)
    lib = _library()
    fn = (lib.mdtpu_plane_sweep_f32 if dtype == torch.float32
          else lib.mdtpu_plane_sweep_f64)
    react = torch.empty((len(NEWTON_CELLS), 3, slot_pos.shape[1]),
                        dtype=dtype, device=device)
    out = launch_sweep(lib, NAME, fn, (slot_pos, slot_diam, counts, box),
                       grid, cap, cutoff, potential, n_cells, "plane_sweep",
                       scratch=(react,))
    plane_sweep.launches += 1
    return out


plane_sweep.launches = 0


def plane_sweep_plain(slot_pos, slot_diam, counts, box, grid, cutoff,
                      potential):
    """The half-stencil sweep in plain PyTorch, same arguments and results
    as :func:`plane_sweep`: one (n_cells, C, C) pair tile per stencil cell;
    the Newton cells' reactions ``-sum_i f d`` are added to the neighbour
    cells' slots."""
    n_cells, cap = check_inputs(slot_pos, slot_diam, counts, box, grid,
                                MAX_CAPACITY)
    tiles = PairTiles(slot_pos, slot_diam, counts, box, grid, cutoff,
                      potential)
    zero = torch.zeros((), dtype=tiles.dtype, device=tiles.device)
    energy, virial = zero, zero
    force = torch.zeros((3, n_cells, cap), dtype=tiles.dtype,
                        device=tiles.device)
    for off in SELF_COLUMN:
        _, u, f, r2s, d = tiles.tile(off)
        energy = energy + 0.5 * torch.sum(u)
        virial = virial + 0.5 * torch.sum(f * r2s)
        for k in range(3):
            force[k] += torch.sum(f * d[k], dim=2)
    for off in NEWTON_CELLS:
        nb, u, f, r2s, d = tiles.tile(off)
        energy = energy + torch.sum(u)
        virial = virial + torch.sum(f * r2s)
        for k in range(3):
            fd = f * d[k]
            force[k] += torch.sum(fd, dim=2)
            # nb is a permutation of the cells (>= 3 per axis): no two own
            # cells share a neighbour at one offset.
            force[k].index_add_(0, nb, -torch.sum(fd, dim=1))
    return energy, virial, force.reshape(3, -1)
