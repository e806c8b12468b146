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
      sweep, then rounded.
  (b) the user's potential on the flat list, in torch:
      ``potential.evaluate_r2(r2, sigma_i, sigma_j)``, or ``force_r2`` on
      lean steps. This is the user's own arithmetic.
  (c) :func:`pair_reduce`, a kernel of the same source: per own slot a
      fixed-order sum over its segment gives the force, and a fixed-order
      block reduction gives 0.5 sum u and 0.5 sum f r^2 (partials per block,
      summed on the device). No atomics: the result repeats bit for bit.

The list lives in buffers of ``capacity`` entries that the engine sizes
(:attr:`CellGridEngine.pair_list_capacity`). A list longer than that is
flagged on the device (``overflow``), never read on the host here: the
engine folds it into its sticky capacity-overflow flag, which the driver
and FIRE already read, and they rerun on a grown engine.

CUDA tensors launch the kernels (or raise); CPU tensors take the plain
versions :func:`pair_list_plain` and :func:`pair_reduce_plain`, which give
the same list in the same order. Each wrapper adds one to its ``launches``
where it launches its kernels (the list's count and fill passes count as
one launch of the list).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from mdtpu_torch.ops import _cuda_build
from mdtpu_torch.ops.cell_sweep import (MAX_CAPACITY, MAX_SHARED_BYTES,
                                        PairTiles, as_cell, candidate_words,
                                        check_cuda, check_inputs,
                                        stencil_cells)

NAME = "cell_pairs"
_META_CELLS = 32          # per-cell records of the stencil, padded
_LIST_PAD = 2             # candidates at infinity after a stage
REDUCE_THREADS = 256      # threads of a reduction block

_P, _I, _D, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                  ctypes.c_longlong)
# Pointers in (positions, [lo,] diameters, counts, cell matrix), the grid
# (nz = 1 in 2D) and capacity, the cutoff, the per-slot counts and starts,
# the list's capacity, its five buffers, the plan (list_len, smem_bytes,
# threads), the pass (0 count, 1 fill), the stream.
_LIST_ARGS = ((_P,) * 4 + (_I,) * 4 + (_D,) + (_P,) * 2 + (_L,) + (_P,) * 5
              + (_I,) * 4 + (_P,))
# Per-slot starts and counts, the capacity and slot count, the dimension,
# u (or null), f, the displacements and r^2, the force, the energy and
# virial partials, the stream.
_REDUCE_ARGS = (_P,) * 2 + (_L,) * 2 + (_I,) + (_P,) * 7 + (_P,)
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


@functools.lru_cache(maxsize=None)
def pairs_stage_plan(cap, dtype, hilo=False, dim=3):
    """``(list_len, smem_bytes, threads)`` of the list kernel at cell
    capacity ``cap``: one thread per own slot (a power of two, at least a
    warp); the whole stencil (3^d ``cap`` candidates) in one stage where it
    fits in a block's shared memory beside the stencil's records, else as
    many as fit (the kernel then stages 9, 3 or 1 cells at a time, as the
    sweep does). As ``plan_ok`` in ``csrc/cell_pairs.cu``."""
    if not 1 <= cap <= MAX_CAPACITY:
        raise ValueError(f"cell capacity {cap} outside [1, {MAX_CAPACITY}]")
    esize = torch.finfo(dtype).bits // 8
    threads = max(32, 1 << (cap - 1).bit_length())
    fixed = 3 * _META_CELLS * esize + 2 * _META_CELLS * 4
    per_candidate = candidate_words(dim, hilo) * esize
    fits = (MAX_SHARED_BYTES - fixed) // per_candidate - _LIST_PAD
    list_len = min(stencil_cells(dim) * cap, fits)
    if list_len < cap:
        raise ValueError(f"no staging plan fits capacity {cap}")
    return list_len, per_candidate * (list_len + _LIST_PAD) + fixed, threads


def _empty_list(capacity, n_slots, dim, dtype, device):
    def floats(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    return dict(neighbour=torch.empty(capacity, dtype=torch.int32,
                                      device=device),
                disp=floats(dim, capacity), r2=floats(capacity),
                sigma_i=floats(capacity), sigma_j=floats(capacity),
                count=torch.empty(n_slots, dtype=torch.int32, device=device))


def _finish(buffers, count):
    """Starts (an exclusive cumulative sum of the counts), total and the
    overflow flag, all on the device."""
    count64 = count.to(torch.int64)
    start = torch.cumsum(count64, 0) - count64
    total = count64.sum()
    return start, total, total > buffers["r2"].shape[0]


def pair_list(slot_pos, slot_diam, counts, box, grid, cutoff, capacity,
              slot_lo=None):
    """The list of hits (a :class:`PairList`). CUDA tensors launch the count
    and fill kernels (or raise); CPU tensors take :func:`pair_list_plain`.
    ``slot_lo``: the positions' lo words (float32), for the hi/lo
    displacement. Each call on the card adds one to
    ``pair_list.launches``."""
    n_cells, cap = check_inputs(slot_pos, slot_diam, counts, box, grid,
                                MAX_CAPACITY)
    if slot_lo is not None and tuple(slot_lo.shape) != tuple(slot_pos.shape):
        raise ValueError("slot_lo must have the shape of slot_pos")
    if capacity < 1:
        raise ValueError(f"list capacity {capacity} < 1")
    if slot_pos.device.type == "cpu":
        return pair_list_plain(slot_pos, slot_diam, counts, box, grid,
                               cutoff, capacity, slot_lo)
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
    buf = _empty_list(capacity, slot_pos.shape[1], dim, dtype,
                      slot_pos.device)
    nx, ny, nz = (*(int(g) for g in grid), 1)[:3]
    plan = pairs_stage_plan(cap, dtype, hilo, dim)
    out_ptrs = tuple(buf[k].data_ptr() for k in
                     ("neighbour", "disp", "r2", "sigma_i", "sigma_j"))
    stream = torch.cuda.current_stream(slot_pos.device).cuda_stream
    start = None
    with torch.cuda.device(slot_pos.device):
        for fill in (0, 1):
            if fill:
                start, total, overflow = _finish(buf, buf["count"])
            rc = fn(*(t.data_ptr() for t in inputs), nx, ny, nz, cap,
                    float(cutoff), buf["count"].data_ptr(),
                    None if start is None else start.data_ptr(),
                    int(capacity), *out_ptrs, *plan, fill, stream)
            _cuda_build.check(lib, NAME, rc, "cell_pairs")
    pair_list.launches += 1
    return PairList(start=start, total=total, overflow=overflow, **buf)


def pair_list_plain(slot_pos, slot_diam, counts, box, grid, cutoff,
                    capacity, slot_lo=None):
    """:func:`pair_list` in plain PyTorch: the pair tiles of the plain sweep
    (:class:`~mdtpu_torch.ops.cell_sweep.PairTiles`) for every stencil
    offset, their hits taken in (own slot, stencil offset, neighbour slot)
    order, the first ``capacity`` kept, the rest padded as the kernel pads
    them."""
    check_inputs(slot_pos, slot_diam, counts, box, grid, MAX_CAPACITY)
    tiles = PairTiles(slot_pos, slot_diam, counts, box, grid, cutoff, None,
                      slot_lo=slot_lo)
    dim, nc, cap = tiles.dim, tiles.n_cells, tiles.cap
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
    diam = tiles.diam
    count = mask.sum(dim=(2, 3)).reshape(-1).to(torch.int32)
    n = min(int(r2.shape[0]), capacity)

    def padded(values, fill):
        out = values.new_full(values.shape[:-1] + (capacity,), fill)
        out[..., :n] = values[..., :n]
        return out

    c2 = tiles.cutoff2
    buf = dict(neighbour=padded((nb * cap + j).to(torch.int32), 0),
               disp=padded(disp, 0.0), r2=padded(r2, c2),
               sigma_i=padded(diam[cell_i, i], 1.0),
               sigma_j=padded(diam[nb, j], 1.0))
    start, total, overflow = _finish(buf, count)
    return PairList(start=start, total=total, overflow=overflow, count=count,
                    **buf)


def pair_reduce(plist, f_over_r, u=None):
    """``(energy, virial, slot_forces)`` from the list and the potential's
    values on it: per slot the sum of ``f_over_r * disp`` over its segment
    in list order, ``0.5 sum u`` and ``0.5 sum f_over_r r2`` (``u=None``: a
    lean reduction, energy and virial zero). CUDA tensors launch the
    kernel (or raise); CPU tensors take :func:`pair_reduce_plain`. Each
    launch adds one to ``pair_reduce.launches``, a lean one also to
    ``pair_reduce.lean_launches``."""
    if plist.r2.device.type == "cpu":
        return pair_reduce_plain(plist, f_over_r, u)
    dim, capacity = plist.disp.shape
    n_slots = plist.count.shape[0]
    tensors = (plist.disp, plist.r2, f_over_r) + (() if u is None else (u,))
    _, dtype = check_cuda(tensors, (torch.float32, torch.float64))
    if f_over_r.shape != plist.r2.shape or (u is not None
                                            and u.shape != plist.r2.shape):
        raise ValueError("the potential's values must be (capacity,)")
    lib = _library()
    fn = (lib.mdtpu_pair_reduce_f32 if dtype == torch.float32
          else lib.mdtpu_pair_reduce_f64)
    device = plist.r2.device
    force = torch.empty((dim, n_slots), dtype=dtype, device=device)
    blocks = -(-n_slots // REDUCE_THREADS)
    partials = (torch.empty((2, blocks), dtype=dtype, device=device)
                if u is not None else None)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(plist.start.data_ptr(), plist.count.data_ptr(),
                int(capacity), int(n_slots), dim,
                None if u is None else u.data_ptr(), f_over_r.data_ptr(),
                plist.disp.data_ptr(), plist.r2.data_ptr(), force.data_ptr(),
                *((None, None) if partials is None else
                  (partials[0].data_ptr(), partials[1].data_ptr())), stream)
    _cuda_build.check(lib, NAME, rc, "pair_reduce")
    pair_reduce.launches += 1
    if u is None:
        pair_reduce.lean_launches += 1
        zero = force.new_zeros(())
        return zero, zero, force
    return 0.5 * partials[0].sum(), 0.5 * partials[1].sum(), force


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
               capacity, observables=True, slot_lo=None):
    """The pair sweep of any potential through the list: :func:`pair_list`,
    the potential's ``evaluate_r2`` (``force_r2`` when ``observables`` is
    False) on every entry, :func:`pair_reduce`. Returns ``(energy, virial,
    slot_forces, overflow)``; ``overflow`` (a 0-d bool tensor, not read
    here) says the list outgrew ``capacity`` and the forces are short."""
    plist = pair_list(slot_pos, slot_diam, counts, box, grid, cutoff,
                      capacity, slot_lo)
    if observables:
        u, f_over_r = potential.evaluate_r2(plist.r2, plist.sigma_i,
                                            plist.sigma_j)
    else:
        u, f_over_r = None, potential.force_r2(plist.r2, plist.sigma_i,
                                               plist.sigma_j)
    energy, virial, force = pair_reduce(plist, f_over_r, u)
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
    pair_list.launches = 0
    pair_reduce.launches = pair_reduce.lean_launches = 0


reset_launches()
