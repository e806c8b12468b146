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

Same arguments and results as :func:`mdtpu_torch.ops.cell_sweep.cell_sweep`,
on 3D orthorhombic boxes only (as its Pallas original): ``box`` is the three
box lengths or the diagonal cell matrix, whose diagonal is taken.
:func:`plane_sweep` launches the kernels in ``csrc/plane_sweep.cu`` for CUDA
tensors and takes :func:`plane_sweep_plain` only for CPU tensors.

The kernel (one block per cell) is built like the full-stencil one: the
occupied slots of the 15 cells staged in shared memory as one candidate list
(self column first, then the Newton cells), several threads per own slot, a
filter on r^2 and a drain that runs the potential. The reactions need no
floating-point atomics: a Newton hit sets a bit of the candidate's mask, and
one thread per candidate then walks its bits in own-slot order and adds the
pairs' ``-f d``; see the note at the head of the source. What that needs
from the host is here: :func:`plane_stage_plan` sizes the block, the list,
the masks and the shared memory from the capacity, and
:func:`plane_stage_cells` mirrors the kernel's choice of how many cells it
stages together. The CPU tests hold both (``tests/test_torch_plane_plan.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mdtpu_torch.ops import _cuda_build
from mdtpu_torch.ops.cell_sweep import (FILTER_UNROLL, MAX_CAPACITY,
                                        MAX_SHARED_BYTES, QUEUE_DEPTH, PairTiles,
                                        check_cuda, check_inputs,
                                        functor_params, launch_sweep)
from mdtpu_torch.utils import counters

NAME = "plane_sweep"
HALF_OFFSETS = ((0, 1), (1, -1), (1, 0), (1, 1))
SELF_COLUMN = tuple((0, 0, dz) for dz in (-1, 0, 1))
NEWTON_CELLS = tuple((ox, oy, dz) for ox, oy in HALF_OFFSETS
                     for dz in (-1, 0, 1))
# The kernel's candidate list: the cells in this order, slots ascending.
LIST_CELLS = SELF_COLUMN + NEWTON_CELLS

# The kernel's staging plan (csrc/plane_sweep.cu keeps the same layout).
STAGE_CELLS = (15, 3, 1)    # list cells staged together, most first
LIST_FILL = 2.0 / 3.0       # share of the 15 C slots a stage holds
THREADS_PER_SLOT = 1        # block size over the capacity, before rounding
_META_CELLS = 16            # per-cell records of the list (15 used), padded

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# Pointers in, grid and capacity, cutoff and potential kind, four float and
# three int potential parameters, pointers out (force, energy and virial
# partials, reaction partials), the staging plan (list_len, mask_words,
# queue_depth, smem_bytes, threads), the stream.
_ARGS = ((_P,) * 4 + (_I,) * 4 + (_D, _I) + (_D,) * 4 + (_I,) * 3
         + (_P,) * 4 + (_I,) * 5 + (_P,))
_SIGNATURES = (("mdtpu_plane_sweep_f32", _ARGS),
               ("mdtpu_plane_sweep_f64", _ARGS),
               ("mdtpu_plane_sweep_occupancy", (_I,) * 11 + (_P,)))


def _library():
    return _cuda_build.load(NAME, _SIGNATURES)


def build_report() -> str:
    """Build (if needed) the kernels; return the compiler's report."""
    return _cuda_build.build_report(NAME)


@functools.lru_cache(maxsize=None)
def plane_stage_plan(cap, dtype):
    """``(list_len, mask_words, smem_bytes, threads)`` for a launch at cell
    capacity ``cap``.

    ``threads``: ``THREADS_PER_SLOT`` threads per slot of a cell, rounded up
    to a power of two (at least a warp, at most 1024). A cell holds about
    half its capacity, so a block still has two or three threads for each of
    its particles; measured on an H100, blocks of one thread per slot (more
    of them resident on an SM) beat the full-stencil sweep's two.
    ``mask_words``: 32-bit words of one candidate's hit mask, a bit
    per own slot. ``list_len``: how many candidates one stage holds in
    shared memory: ``LIST_FILL`` of the 15 ``cap`` slots, at least one full
    cell, at most what fits in a block's shared memory beside the own
    cell's slots, the threads' hit queues and the reduction scratch. A
    staged candidate takes four values and its mask; the list is padded by
    two filter chunks. A block whose neighbourhood holds more stages it in
    parts (:func:`plane_stage_cells`).

    Where not even one full cell fits, ``list_len`` is ``cap`` and
    ``smem_bytes`` exceeds ``MAX_SHARED_BYTES``: the kernel refuses such a
    launch, and nothing else does."""
    if not 1 <= cap <= MAX_CAPACITY:
        raise ValueError(f"cell capacity {cap} outside [1, {MAX_CAPACITY}]")
    esize = torch.finfo(dtype).bits // 8
    threads = min(1024, max(32, 1 << (THREADS_PER_SLOT * cap - 1).bit_length()))
    mask_words = (cap + 31) // 32
    fixed = ((4 * cap + 5 * threads + 3 * _META_CELLS) * esize
             + 2 * _META_CELLS * 4 + QUEUE_DEPTH * threads * 2)
    per_candidate = 4 * esize + 4 * mask_words
    pad = 2 * FILTER_UNROLL * 4 * esize
    fits = (MAX_SHARED_BYTES - fixed - pad) // per_candidate
    list_len = max(cap, min(math.ceil(LIST_FILL * 15 * cap), 15 * cap, fits))
    return (list_len, mask_words, per_candidate * list_len + pad + fixed,
            threads)


def plane_stage_cells(list_counts, list_len):
    """How many of the 15 list cells a block stages together, given the
    occupied slots of each (in :data:`LIST_CELLS` order) and the stage's
    length: all 15, else 3 (the self column, then each in-plane offset's
    three cells), else 1, the first whose every group fits. What the kernel
    works out per block."""
    for cells in STAGE_CELLS:
        if all(sum(list_counts[c:c + cells]) <= list_len
               for c in range(0, 15, cells)):
            return cells
    raise ValueError("a single cell exceeds the stage's length")


def _plan_args(cap, dtype):
    list_len, mask_words, smem, threads = plane_stage_plan(cap, dtype)
    return list_len, mask_words, QUEUE_DEPTH, smem, threads


def blocks_per_sm(cap, dtype, potential) -> int:
    """How many blocks of the kernel that a launch at capacity ``cap`` would
    run are resident on one SM together (asks the CUDA runtime; needs a
    card)."""
    lib = _library()
    kind, _, ip = functor_params(potential)
    out = ctypes.c_int(0)
    rc = lib.mdtpu_plane_sweep_occupancy(
        torch.finfo(dtype).bits // 8, cap, kind, *ip, *_plan_args(cap, dtype),
        ctypes.addressof(out))
    _cuda_build.check(lib, NAME, rc, "plane_sweep occupancy query")
    return out.value


def plane_sweep(slot_pos, slot_diam, counts, box, grid, cutoff, potential):
    """The half-stencil sweep. CUDA tensors launch the kernels (or raise);
    CPU tensors take :func:`plane_sweep_plain`. Each launch adds one to
    ``plane_sweep.launches``. The kernel refuses (RuntimeError) a capacity
    whose staging plan does not fit in a block's shared memory."""
    box = _box_lengths(box, grid)
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
    react = _react_buffer(slot_pos.shape[1], dtype, device)
    out = launch_sweep(lib, NAME, fn, (slot_pos, slot_diam, counts, box),
                       grid, cap, cutoff, potential, n_cells, "plane_sweep",
                       scratch=(react,), plan=_plan_args(cap, dtype))
    plane_sweep.launches += 1
    return out


plane_sweep.launches = 0
# A captured particle-order step on PlaneEngine launches it.
counters.register(plane_sweep, "launches")


def _box_lengths(box, grid):
    """The (3,) box lengths of a 3D orthorhombic box given as lengths or as
    its cell matrix (``PlaneEngine.create`` takes no other box)."""
    if len(grid) != 3:
        raise ValueError(f"the half-stencil sweep takes 3D grids, got "
                         f"{tuple(grid)}")
    return torch.diagonal(box).contiguous() if box.dim() == 2 else box


def _react_buffer(n_slots, dtype, device):
    """The reaction partials (12, 3, n_slots), indexed by the slot they act
    on, uninitialised: the sweep writes and the fold-back reads those of
    occupied slots only."""
    return torch.empty((len(NEWTON_CELLS), 3, n_slots), dtype=dtype,
                       device=device)


def plane_sweep_plain(slot_pos, slot_diam, counts, box, grid, cutoff,
                      potential):
    """The half-stencil sweep in plain PyTorch, same arguments and results
    as :func:`plane_sweep`: one (n_cells, C, C) pair tile per stencil cell;
    the Newton cells' reactions ``-sum_i f d`` are added to the neighbour
    cells' slots."""
    box = _box_lengths(box, grid)
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
