"""The pair-list route: any potential on the cell grid, on the card.

The JAX package's sweeps trace a user's ``evaluate`` into their bodies (the
Pallas kernel ``mdtpu/ops/experimental/pallas_cell.py::_pair_row_kernel``
and the XLA sweeps of ``mdtpu/ops/cell_grid.py``). A CUDA kernel cannot run
the user's Python, so for a potential without a functor
(:func:`mdtpu_torch.ops.cell_sweep.kernel_params` returns None) the same
function is made of three parts:

  (a) :func:`pair_list`, the kernels of ``csrc/cell_pairs.cu``: the staged
      stencil of the full-stencil sweep (2D or 3D, tilted boxes by their
      cell vectors, every pair seen from both sides) writes, for each
      occupied own slot in slot order, its hits with r^2 below the engine
      cutoff: the neighbour slot, the displacement components, r^2 and the
      two diameters. A count pass, offsets (an exclusive cumulative sum),
      then a fill pass, in stencil order and then candidate order. With the
      positions' lo words the displacement is the hi/lo one of the hi/lo
      sweep, then rounded. ``interior=(first_cell, n_cells_out)``: the own
      slots of that run of cells only (the sharded engine's slab), their
      neighbours slots of the whole grid.
  (b) the user's potential on the flat list, in torch:
      ``potential.evaluate_r2(r2, sigma_i, sigma_j)``, or ``force_r2`` on
      lean steps. This is the user's own arithmetic.
  (c) :func:`pair_reduce`, a kernel of the same source: per own slot a
      fixed-order sum over its segment gives the force, and a fixed-order
      block reduction gives 0.5 sum u and 0.5 sum f r^2 (partials per block,
      summed in block order by the block that finishes last, in the same
      launch). No floating-point atomics: the result repeats bit for
      bit.

The list lives in buffers of ``capacity`` entries that the engine sizes
(:attr:`CellGridEngine.pair_list_capacity`) and keeps across calls in a
:class:`PairListWorkspace`, so that the kernel pads only the entries an
earlier call's hits may have left (the rest are padding already). A list
longer than that is flagged on the device (``overflow``), never read on the
host here: the engine folds it into its sticky capacity-overflow flag,
which the driver and FIRE already read, and they rerun on a grown engine.

CUDA tensors launch the kernels (or raise); CPU tensors take the plain
versions :func:`pair_list_plain` and :func:`pair_reduce_plain`, which give
the same list in the same order. Each wrapper adds one to its ``launches``
where it launches its kernels (the list's count and fill passes count as
one launch of the list; a launch over a run of cells also to
``pair_list.slab_launches``); the counters are registered with
:mod:`mdtpu_torch.utils.counters`, so they stay true under CUDA-graph
replay (on the card a segment or a minimization of a user potential is
captured, its list and reduction in the WHILE node's body).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from mdtpu_torch.ops import _cuda_build
from mdtpu_torch.ops.cell_sweep import (MAX_CAPACITY, MAX_SHARED_BYTES,
                                        PairTiles, as_cell, check_cuda,
                                        check_inputs, check_interior,
                                        lean_zero, stencil_cells)
from mdtpu_torch.potentials.base import potential_values
from mdtpu_torch.utils import counters

NAME = "cell_pairs"
REDUCE_THREADS = 256      # threads of a reduction block
# A list whose capacity gives more entries a slot than this is reduced by
# the staged kernel (each block's run through shared memory); a list of
# shorter segments by the walk (measured on the card, PERF.md section 6).
STAGED_ENTRIES_PER_SLOT = 8
SM_SHARED_BYTES = 233472  # shared memory of one SM on sm_90 (228 KB)
BLOCK_RESERVED_BYTES = 1024  # shared memory the runtime keeps per block
WARPS_PER_SM = 64
# The list kernel is bound by the instructions it issues, and much of a
# block's work is set-up per cell (measured on the card, PERF.md section 6).
# A block takes a run of up to ROW_CELLS cells along the grid's last axis and
# stages their window once (3 (K + 2) cells in 2D for K cells, against 9 K
# one cell at a time; a window is at most MAX_WINDOW cells, so 3D blocks
# take one cell). A stencil of at most SMALL_STENCIL slots takes one or two
# warps a block (SMALL_THREADS: whichever keeps more warps on an SM), a
# larger one more, at most MAX_LIST_THREADS. A block's first hits go through
# shared memory, up to MAX_OUT_LEN, as much as the blocks an SM holds at 64
# registers a thread leave room for.
ROW_CELLS = {2: 4, 3: 1}
MAX_WINDOW = 32
SMALL_STENCIL = 256
SMALL_THREADS = (32, 64)
MAX_LIST_THREADS = 256
MAX_OUT_LEN = 4096
THREADS_PER_SM_AT_64_REGISTERS = 1024

_P, _I, _D, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                  ctypes.c_longlong)
# Pointers in (positions, [lo,] diameters, counts, cell matrix), the grid
# (nz = 1 in 2D), the run of cells (first, count), the capacity, the cells a
# block takes and the blocks, the cutoff, the per-slot counts, the per-block
# counts and their cumulative sum, the per-slot starts, where the hits ended
# before and after the last call (on the device), the list's capacity, its
# five buffers, the plan (list_len, out_len, smem_bytes, threads), the pass
# (0 count, 1 fill), the stream.
_LIST_ARGS = ((_P,) * 4 + (_I,) * 8 + (_D,) + (_P,) * 6 + (_L,) + (_P,) * 5
              + (_I,) * 5 + (_P,))
# Per-slot starts and counts, the capacity and slot count, the dimension,
# u (or null), f, the displacements and r^2, the force, the energy and
# virial partials, energy, virial, staged or not, the stream.
_REDUCE_ARGS = (_P,) * 2 + (_L,) * 2 + (_I,) + (_P,) * 9 + (_I, _P)
_SIGNATURES = (("mdtpu_cell_pairs_f32", _LIST_ARGS),
               ("mdtpu_cell_pairs_f64", _LIST_ARGS),
               ("mdtpu_cell_pairs_hilo_f32", (_P,) + _LIST_ARGS),
               ("mdtpu_pair_reduce_f32", _REDUCE_ARGS),
               ("mdtpu_pair_reduce_f64", _REDUCE_ARGS))


def _library():
    return _cuda_build.load(NAME, _SIGNATURES)


def build_report() -> str:
    """Build (if needed) the kernels; return the compiler's report."""
    return _cuda_build.build_report(NAME)


@dataclass(frozen=True)
class PairList:
    """The hits of every own slot, in slot order, ``capacity`` entries.

    ``start`` (n_slots,) int64 and ``count`` (n_slots,) int32 give each
    slot's segment ``[start, start + count)``; entries at or past
    ``capacity`` were not written (``overflow``). Entries past ``total``
    are padding and belong to no segment: r^2 at the squared engine
    cutoff, unit diameters, zero displacement and neighbour 0."""

    neighbour: torch.Tensor  # (capacity,) int32 neighbour slot
    disp: torch.Tensor       # (d, capacity) own minus neighbour image
    r2: torch.Tensor         # (capacity,)
    sigma_i: torch.Tensor    # (capacity,) own diameter
    sigma_j: torch.Tensor    # (capacity,) neighbour diameter
    start: torch.Tensor      # (n_slots,) int64
    count: torch.Tensor      # (n_slots,) int32
    total: torch.Tensor      # () int64: hits in all
    overflow: torch.Tensor   # () bool: total > capacity

    @property
    def capacity(self) -> int:
        return self.r2.shape[0]


def _align16(nbytes):
    return -(-nbytes // 16) * 16


def list_shared_bytes(list_len, cap, dtype, hilo=False, dim=3, cells=1,
                      out_len=0):
    """Shared memory of one list block of ``cells`` own cells with room for
    ``out_len`` hits, region by region as ``ListLayout`` in
    ``csrc/cell_pairs.cu`` lays it out (each rounded up to 16 bytes): the
    staged candidates (d + 1 words, then under hi/lo the lo words: 4 in 3D,
    2 in 2D), the own slots' words, the window cells' shifts, a 64-bit position per own slot and one more (at least 32), the
    window cells' offsets, indices and wraps, each staged candidate's slot
    in the grid, the own slots before each own cell, and the buffered hits
    (a neighbour int and d + 3 words each)."""
    esize = torch.finfo(dtype).bits // 8
    n = list_len
    slots = cells * cap
    lo_words = (4 if dim == 3 else 2) if hilo else 0
    own_words = 2 * dim + 1 if hilo else dim + 1
    return (_align16((dim + 1) * n * esize) + _align16(lo_words * n * esize)
            + _align16(own_words * slots * esize)
            + _align16(dim * MAX_WINDOW * esize)
            + _align16(8 * max(slots + 1, 32))
            + _align16(4 * (MAX_WINDOW + 1)) + 2 * _align16(4 * MAX_WINDOW)
            + _align16(4 * n) + _align16(4 * (cells + 1))
            + _align16(4 * out_len) + _align16((dim + 3) * out_len * esize))


def window_stage(cap, dtype, hilo, dim, cells):
    """The longest stage (in candidates) of a block of ``cells`` own cells
    that fits in its shared memory, at most the whole window (3^(d-1) rows
    of ``cells + 2`` cells of ``cap`` slots); 0 where not even one row
    fits."""
    one_row = (cells + 2) * cap
    fits, above = one_row - 1, stencil_cells(dim) // 3 * one_row + 1
    while above - fits > 1:   # bisection: the bytes grow with the length
        mid = (fits + above) // 2
        if list_shared_bytes(mid, cap, dtype, hilo, dim,
                             cells) <= MAX_SHARED_BYTES:
            fits = mid
        else:
            above = mid
    return fits if fits >= one_row else 0


def out_room(smem, threads, dtype, dim):
    """Hits a block can buffer: the shared memory an SM gives each of the
    blocks it holds at 64 registers a thread, beyond ``smem``, at most
    ``MAX_OUT_LEN``."""
    esize = torch.finfo(dtype).bits // 8
    blocks = max(1, min(32, THREADS_PER_SM_AT_64_REGISTERS // threads))
    room = min(SM_SHARED_BYTES // blocks - BLOCK_RESERVED_BYTES,
               MAX_SHARED_BYTES) - smem - 32
    return max(0, min(MAX_OUT_LEN, room // (4 + (dim + 3) * esize)))


@functools.lru_cache(maxsize=None)
def pairs_stage_plan(cap, dtype, hilo=False, dim=3):
    """``(list_len, out_len, smem_bytes, threads, cells)`` of the list
    kernel at cell capacity ``cap``: a block takes ``cells`` consecutive
    cells of a row (``ROW_CELLS``, fewer where a row of their window does
    not fit) and stages their window of 3^(d-1) rows of ``cells + 2``
    cells; the whole window (``list_len`` candidates) in one stage where it
    fits in a block's shared memory, else as many as fit, at least one row
    (the kernel then stages 3 or 1 rows at a time). The block's threads:
    one of ``SMALL_THREADS`` for a stencil of at most ``SMALL_STENCIL``
    slots (the most warps resident on an SM, the fewer threads on a tie),
    else
    enough warps that the blocks the SM's shared memory holds give it its
    64 (a power of two, at most ``MAX_LIST_THREADS``); the kernel splits
    them into groups of 8, 16 or 32 lanes by its own count and stencil
    length, a group to an own slot. ``out_len``: the hits a block buffers
    (:func:`out_room`). As ``plan_ok`` in ``csrc/cell_pairs.cu``."""
    if not 1 <= cap <= MAX_CAPACITY:
        raise ValueError(f"cell capacity {cap} outside [1, {MAX_CAPACITY}]")
    for cells in range(ROW_CELLS[dim], 0, -1):
        list_len = window_stage(cap, dtype, hilo, dim, cells)
        if list_len:
            break
    else:
        raise ValueError(f"no staging plan fits capacity {cap}")
    smem = list_shared_bytes(list_len, cap, dtype, hilo, dim, cells)
    if stencil_cells(dim) * cap <= SMALL_STENCIL:
        # The most resident warps, the fewer threads on a tie.
        threads = max(SMALL_THREADS, key=lambda t: (min(
            32, THREADS_PER_SM_AT_64_REGISTERS // t,
            SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES)) * t, -t))
    else:
        blocks = min(32, SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES))
        threads = min(MAX_LIST_THREADS,
                      1 << (-(-WARPS_PER_SM * 32 // blocks) - 1).bit_length())
    out_len = out_room(smem, threads, dtype, dim)
    smem = list_shared_bytes(list_len, cap, dtype, hilo, dim, cells, out_len)
    return list_len, out_len, smem, threads, cells


def list_blocks(last_axis, first, n_run, cells):
    """Blocks of a list launch over the cells ``[first, first + n_run)``:
    every row (the cells along the grid's last axis, ``last_axis`` of them)
    the run touches, ``ceil(last_axis / cells)`` a row. As
    ``list_blocks`` in ``csrc/cell_pairs.cu``."""
    rows = (first + n_run - 1) // last_axis - first // last_axis + 1
    return rows * -(-last_axis // cells)


def _empty_list(capacity, dim, dtype, device):
    def floats(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    return dict(neighbour=torch.empty(capacity, dtype=torch.int32,
                                      device=device),
                disp=floats(dim, capacity), r2=floats(capacity),
                sigma_i=floats(capacity), sigma_j=floats(capacity))


class PairListWorkspace:
    """The list's five buffers kept across calls, and ``ends``, two int64 on
    the device: where the hits of the call before the last ended (the count
    pass moves the second into the first) and where the last call's ended
    (the fill pass writes it). Every entry from the first to the capacity is
    padding, so the fill pass pads only ``[total, ends[0])``. New buffers
    (the first call, a grown capacity, another dtype, device or cutoff,
    whose square the padding holds) start with both at the capacity, and
    the fill pass pads them whole. The values live on the device and are
    updated by the kernels themselves, so the scheme holds under CUDA-graph
    replay. The :class:`PairList` a call returns lies in these buffers
    until the next call."""

    def __init__(self):
        self._key = None
        self.buffers = None
        self.ends = None

    def take(self, capacity, dim, dtype, device, cutoff):
        key = (int(capacity), dim, dtype, torch.device(device), float(cutoff))
        if key != self._key:
            self.buffers = _empty_list(capacity, dim, dtype, device)
            self.ends = torch.full((2,), capacity, dtype=torch.int64,
                                   device=device)
            self._key = key
        return self.buffers

    @property
    def last_total(self):
        """Where the last call's hits ended (a 0-d view on the device)."""
        return self.ends[1]


def _finish(count, capacity):
    """The plain version's starts (an exclusive cumulative sum of the
    counts), total and overflow flag."""
    ends = torch.cumsum(count, 0, dtype=torch.int64)
    total = ends[-1]
    return ends - count, total, total > capacity


def pair_list(slot_pos, slot_diam, counts, box, grid, cutoff, capacity,
              slot_lo=None, interior=None, workspace=None):
    """The list of hits (a :class:`PairList`). CUDA tensors launch the count
    and fill kernels (or raise); CPU tensors take :func:`pair_list_plain`.
    ``slot_lo``: the positions' lo words (float32), for the hi/lo
    displacement. ``interior=(first_cell, n_cells_out)``: the list of those
    cells' own slots only (``start`` and ``count`` cover ``n_cells_out *
    C`` slots), every cell of the grid still read as a neighbour.
    ``workspace``: a :class:`PairListWorkspace` whose buffers the list
    takes (default: new ones). Each call on the card adds one to
    ``pair_list.launches``, one over a run of cells also to
    ``pair_list.slab_launches``."""
    n_cells, cap = check_inputs(slot_pos, slot_diam, counts, box, grid,
                                MAX_CAPACITY)
    first, n_out = check_interior(interior, n_cells)
    if slot_lo is not None and tuple(slot_lo.shape) != tuple(slot_pos.shape):
        raise ValueError("slot_lo must have the shape of slot_pos")
    if capacity < 1:
        raise ValueError(f"list capacity {capacity} < 1")
    if slot_pos.device.type == "cpu":
        return pair_list_plain(slot_pos, slot_diam, counts, box, grid,
                               cutoff, capacity, slot_lo, interior)
    dim = len(grid)
    cell = as_cell(box, dim).contiguous()
    hilo = slot_lo is not None
    inputs = ((slot_pos,) + ((slot_lo,) if hilo else ())
              + (slot_diam, counts, cell))
    _, dtype = check_cuda(inputs, (torch.float32,) if hilo
                          else (torch.float32, torch.float64))
    lib = _library()
    fn = (lib.mdtpu_cell_pairs_hilo_f32 if hilo
          else lib.mdtpu_cell_pairs_f32 if dtype == torch.float32
          else lib.mdtpu_cell_pairs_f64)
    device = slot_pos.device
    if workspace is None:
        buf, ends = _empty_list(capacity, dim, dtype, device), (None, None)
    else:
        buf = workspace.take(capacity, dim, dtype, device, cutoff)
        ends = (workspace.ends[0].data_ptr(), workspace.ends[1].data_ptr())
    list_len, out_len, smem, threads, cells = pairs_stage_plan(cap, dtype,
                                                               hilo, dim)
    n_blocks = list_blocks(int(grid[-1]), first, n_out, cells)
    count = torch.empty(n_out * cap, dtype=torch.int32, device=device)
    start = torch.empty(n_out * cap, dtype=torch.int64, device=device)
    block_count = torch.empty(n_blocks, dtype=torch.int32, device=device)
    nx, ny, nz = (*(int(g) for g in grid), 1)[:3]
    out_ptrs = tuple(buf[k].data_ptr() for k in
                     ("neighbour", "disp", "r2", "sigma_i", "sigma_j"))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        for fill in (0, 1):
            if fill:
                block_ends = torch.cumsum(block_count, 0, dtype=torch.int64)
                total = block_ends[-1]
                overflow = total > capacity
            rc = fn(*(t.data_ptr() for t in inputs), nx, ny, nz, first,
                    n_out, cap, cells, n_blocks, float(cutoff),
                    count.data_ptr(),
                    *((block_count.data_ptr(), None, None) if not fill else
                      (None, block_ends.data_ptr(), start.data_ptr())),
                    *ends, int(capacity), *out_ptrs, list_len, out_len,
                    smem, threads, fill, stream)
            _cuda_build.check(lib, NAME, rc, "cell_pairs")
    pair_list.launches += 1
    if interior is not None:
        pair_list.slab_launches += 1
    return PairList(start=start, total=total, overflow=overflow, count=count,
                    **buf)


def pair_list_plain(slot_pos, slot_diam, counts, box, grid, cutoff,
                    capacity, slot_lo=None, interior=None):
    """:func:`pair_list` in plain PyTorch: the pair tiles of the plain sweep
    (:class:`~mdtpu_torch.ops.cell_sweep.PairTiles`) for every stencil
    offset, their hits taken in (own slot, stencil offset, neighbour slot)
    order, the first ``capacity`` kept, the rest padded as the kernel pads
    them. ``interior`` as in :func:`pair_list`."""
    check_inputs(slot_pos, slot_diam, counts, box, grid, MAX_CAPACITY)
    tiles = PairTiles(slot_pos, slot_diam, counts, box, grid, cutoff, None,
                      slot_lo=slot_lo, interior=interior)
    cap = tiles.cap
    nbs, disps, r2s, masks = [], [], [], []
    for off in tiles.offsets():
        nb, d, r2, mask = tiles.pairs(off)
        nbs.append(nb)
        disps.append(torch.stack(d))
        r2s.append(r2)
        masks.append(mask)
    # (cell, i, offset, j): nonzero() walks it in the kernel's order.
    mask = torch.stack(masks, dim=2)
    cell_i, i, s, j = mask.nonzero(as_tuple=True)
    nb = torch.stack(nbs)[s, cell_i]
    disp = torch.stack(disps, dim=3)[:, cell_i, i, s, j]
    r2 = torch.stack(r2s, dim=2)[cell_i, i, s, j]
    count = mask.sum(dim=(2, 3)).reshape(-1).to(torch.int32)
    n = min(int(r2.shape[0]), capacity)

    def padded(values, fill):
        out = values.new_full(values.shape[:-1] + (capacity,), fill)
        out[..., :n] = values[..., :n]
        return out

    c2 = tiles.cutoff2
    buf = dict(neighbour=padded((nb * cap + j).to(torch.int32), 0),
               disp=padded(disp, 0.0), r2=padded(r2, c2),
               sigma_i=padded(tiles.own_diam[cell_i, i], 1.0),
               sigma_j=padded(tiles.diam[nb, j], 1.0))
    start, total, overflow = _finish(count, capacity)
    return PairList(start=start, total=total, overflow=overflow, count=count,
                    **buf)


def pair_reduce(plist, f_over_r, u=None, out=None, scalars_out=None):
    """``(energy, virial, slot_forces)`` from the list and the potential's
    values on it: per slot the sum of ``f_over_r * disp`` over its segment
    in list order, ``0.5 sum u`` and ``0.5 sum f_over_r r2`` (``u=None``: a
    lean reduction, energy and virial one zero made once,
    :func:`~mdtpu_torch.ops.cell_sweep.lean_zero`). ``out``: the ``(d,
    n_slots)`` tensor the forces go into; ``scalars_out``: the ``(energy,
    virial)`` 0-d tensors a full reduction writes (new ones where None), as
    B1 writes the caller's. CUDA tensors launch the kernel (or raise), one
    launch a call, which writes them there; a list of long segments takes
    its staged variant (:func:`staged_reduce`), with the same bits. CPU
    tensors take :func:`pair_reduce_plain`, its results copied in. Each
    launch adds one to ``pair_reduce.launches``, a lean one also to
    ``pair_reduce.lean_launches``. The full kernel finds its last block
    with one counter per card, so two full reductions must not run at once
    on two streams of one card."""
    dim, capacity = plist.disp.shape
    n_slots = plist.count.shape[0]
    dtype, device = plist.r2.dtype, plist.r2.device
    if out is not None and (tuple(out.shape) != (dim, n_slots)
                            or out.dtype != dtype or out.device != device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({dim}, {n_slots}) "
                         f"tensor of the list's dtype and device")
    if scalars_out is not None and (u is None or any(
            t.dim() != 0 or t.dtype != dtype or t.device != device
            for t in scalars_out)):
        raise ValueError("scalars_out takes a full reduction's energy and "
                         "virial: two 0-d tensors of the list's dtype and "
                         "device")
    if device.type == "cpu":
        energy, virial, force = pair_reduce_plain(plist, f_over_r, u)
        if scalars_out is not None:
            energy, virial = (d.copy_(t) for d, t in
                              zip(scalars_out, (energy, virial)))
        return energy, virial, force if out is None else out.copy_(force)
    tensors = (plist.disp, plist.r2, f_over_r) + (() if u is None else (u,))
    check_cuda(tensors, (torch.float32, torch.float64))
    if f_over_r.shape != plist.r2.shape or (u is not None
                                            and u.shape != plist.r2.shape):
        raise ValueError("the potential's values must be (capacity,)")
    lib = _library()
    fn = (lib.mdtpu_pair_reduce_f32 if dtype == torch.float32
          else lib.mdtpu_pair_reduce_f64)
    force = (torch.empty((dim, n_slots), dtype=dtype, device=device)
             if out is None else out)
    blocks = -(-n_slots // REDUCE_THREADS)
    if u is not None:
        # The partials (energy's, then the virial's, one a block), then
        # energy and virial where the caller gives none: one allocation,
        # no launch.
        part = torch.empty(2 * blocks + (2 if scalars_out is None else 0),
                           dtype=dtype, device=device)
        if scalars_out is None:
            scalars_out = (part[2 * blocks], part[2 * blocks + 1])
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(plist.start.data_ptr(), plist.count.data_ptr(),
                int(capacity), int(n_slots), dim,
                None if u is None else u.data_ptr(), f_over_r.data_ptr(),
                plist.disp.data_ptr(), plist.r2.data_ptr(), force.data_ptr(),
                *((None,) * 4 if u is None else
                  (part.data_ptr(), part[blocks:].data_ptr(),
                   scalars_out[0].data_ptr(), scalars_out[1].data_ptr())),
                int(staged_reduce(capacity, n_slots)), stream)
    _cuda_build.check(lib, NAME, rc, "pair_reduce")
    pair_reduce.launches += 1
    if u is None:
        pair_reduce.lean_launches += 1
        zero = lean_zero(dtype, device)
        return zero, zero, force
    return scalars_out[0], scalars_out[1], force


def staged_reduce(capacity, n_slots):
    """Whether :func:`pair_reduce` takes the staged kernel for a list of
    ``capacity`` entries over ``n_slots`` slots: more than
    :data:`STAGED_ENTRIES_PER_SLOT` entries a slot."""
    return capacity > STAGED_ENTRIES_PER_SLOT * n_slots


def pair_reduce_plain(plist, f_over_r, u=None):
    """:func:`pair_reduce` in plain PyTorch: each entry's ``f_over_r *
    disp`` added to its own slot with ``index_add_`` (in list order on the
    CPU), energy and virial summed over the entries of every segment."""
    dim, capacity = plist.disp.shape
    n_slots = plist.count.shape[0]
    own = torch.repeat_interleave(
        torch.arange(n_slots, device=plist.r2.device),
        plist.count.to(torch.int64))[:capacity]
    m = own.shape[0]
    f = f_over_r[:m]
    force = torch.zeros((dim, n_slots), dtype=f.dtype, device=f.device)
    force.index_add_(1, own, f * plist.disp[:, :m])
    if u is None:
        zero = force.new_zeros(())
        return zero, zero, force
    return (0.5 * torch.sum(u[:m]), 0.5 * torch.sum(f * plist.r2[:m]),
            force)


def pair_sweep(slot_pos, slot_diam, counts, box, grid, cutoff, potential,
               capacity, observables=True, slot_lo=None, interior=None,
               workspace=None, out=None, scalars_out=None):
    """The pair sweep of any potential through the list: :func:`pair_list`,
    the potential's ``evaluate_r2`` (``force_r2`` when ``observables`` is
    False) on every entry (:func:`~mdtpu_torch.potentials.base.
    potential_values`), :func:`pair_reduce`. Returns ``(energy, virial,
    slot_forces, overflow)``; ``overflow`` (a 0-d bool tensor, not read
    here) says the list outgrew ``capacity`` and the forces are short.
    ``interior`` and ``workspace`` as in :func:`pair_list`: over a run of
    cells the forces are those of its slots and energy and virial its
    half-sums. ``out`` and ``scalars_out`` as in :func:`pair_reduce`."""
    plist = pair_list(slot_pos, slot_diam, counts, box, grid, cutoff,
                      capacity, slot_lo, interior, workspace)
    if observables:
        u, f_over_r = potential_values(potential, "evaluate_r2", plist.r2,
                                       plist.sigma_i, plist.sigma_j)
    else:
        u, f_over_r = None, potential_values(potential, "force_r2",
                                             plist.r2, plist.sigma_i,
                                             plist.sigma_j)
    energy, virial, force = pair_reduce(plist, f_over_r, u, out, scalars_out)
    return energy, virial, force, plist.overflow


def list_capacity(n_particles, volume, cutoff, dim):
    """Room for the hits of ``n_particles`` at uniform density in a box of
    ``volume``: each sees the others within ``cutoff`` (from both sides),
    1.3 times that, plus 1024."""
    ball = math.pi * cutoff ** 2 if dim == 2 else 4.0 / 3.0 * math.pi \
        * cutoff ** 3
    return int(math.ceil(1.3 * n_particles * n_particles / volume * ball)) \
        + 1024


def reset_launches():
    """Set the list's and the reduction's launch counts to 0."""
    pair_list.launches = pair_list.slab_launches = 0
    pair_reduce.launches = pair_reduce.lean_launches = 0


reset_launches()
# A captured step or minimization of a potential without a kernel functor
# launches both (the list inside a rebuild too, where the sharded engine's
# full step rebuilds inline).
counters.register(pair_list, "launches", "slab_launches")
counters.register(pair_reduce, "launches", "lean_launches")
