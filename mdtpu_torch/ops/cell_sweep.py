"""The cell-list pair sweep: a hand-written CUDA kernel and its plain version.

Counterpart of the Pallas kernel
``mdtpu/ops/experimental/pallas_cell.py::_pair_row_kernel``: forces, energy
and virial of every pair within the cutoff, over particles sorted into the
slots of a periodic cell grid, with the full stencil (each pair seen from
both sides; energy and virial halved). In 3D the stencil has 27 cells; in 2D
9, the counterpart of the JAX package's XLA y-window sweep
(``mdtpu/ops/cell_grid.py:556``), which no Pallas kernel covers. The box may
be tilted: a neighbour cell across the grid's edge along axis ``a`` is
shifted by the cell vector ``w_a cell[:, a]`` (``w_a = +-1``), the JAX
sweeps' ghost shift (``cell_grid.py:736-739``).

Inputs (the slot layout of :meth:`CellGridEngine.allocate`), ``d`` = 2 or 3:
  * ``slot_pos``  (d, n_cells * C) slot coordinates, component-major; the
    slots [0, count) of each cell are occupied, the rest are never read;
  * ``slot_diam`` (n_cells * C,) slot diameters;
  * ``counts``    (n_cells,) int64 occupied slots per cell (clamped to C);
  * ``box``       the (d, d) cell matrix (its columns are the box vectors),
    or the (d,) box lengths of an orthorhombic box;
  * ``grid`` of d axes, at least 3 cells each, and the engine cutoff.
Returns ``(energy, virial, slot_forces)`` with ``slot_forces`` (d, n_cells * C)
(zero on vacant slots).

:func:`cell_sweep_hilo` is the hi/lo (double-f32) variant of the JAX
package's f32x2 mode: ``slot_pos`` is the hi word, ``slot_lo`` (d, n_cells *
C) the lo word, and each displacement is formed error-free from the two
(see ``csrc/cell_sweep.cu``). float32 only.

Potentials: the kernels evaluate the potentials they have a functor for
(``csrc/pair_potentials.cuh``; :func:`kernel_params`). Any other potential
takes the pair-list route of :mod:`mdtpu_torch.ops.cell_pairs`, chosen by
:class:`CellGridEngine` from the potential's type.

``observables=False`` runs the lean variant of either sweep (the XLA sweep's
``observables`` flag, ``mdtpu/ops/cell_grid.py:711-717``): forces only, the
energy and virial returned as zeros. Its forces are the full variant's bits.
On the card the full variant sums its per-block energy and virial in its
last block (a fixed order, in float64, rounded once), so a full call is one
launch; ``scalars_out`` gives the two 0-d tensors it writes them into.

:func:`cell_sweep` and :func:`cell_sweep_hilo` launch the kernels in
``csrc/cell_sweep.cu`` for CUDA tensors and take the plain versions only for
CPU tensors. The kernels are compiled with ``nvcc`` for ``sm_90a`` into
``mdtpu_torch/_build`` at first use and bound with ctypes
(:mod:`mdtpu_torch.ops._cuda_build`).

The kernel (one block per cell) stages the occupied slots of the stencil's
cells in shared memory as one candidate list, gives each particle of the
cell several threads that share the list, and splits the inner loop in a
filter (r^2 only, hits queued per thread) and a drain (the potential, on
lanes that all hold a hit); see the note at the head of the source. What
that needs from the host is here: :func:`stage_plan` sizes the block, the
list and the shared memory from the capacity; :func:`hilo_filter_margin`
derives how far the hi/lo filter, which sees the hi words only, must widen
the cutoff, and :func:`hilo_filter_cutoff2` is the filter's squared cutoff
as the kernel computes it. The CPU tests hold all three
(``tests/test_torch_sweep_plan.py``).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math

import torch

from mdtpu_torch.ops import _cuda_build
from mdtpu_torch.potentials.base import rounded
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.potentials.overlap import OverlapPotential
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from mdtpu_torch.potentials.xplor import LennardJonesXPLOR
from mdtpu_torch.utils import counters
from mdtpu_torch.utils.math import two_sum

NAME = "cell_sweep"
MAX_CAPACITY = 1024  # one thread per own slot, at most 1024 a block

# The kernel's staging plan (csrc/cell_sweep.cu keeps the same layout).
MAX_SHARED_BYTES = 232448   # shared memory a block may use on sm_90 (227 KB)
STAGE_CELLS = (27, 9, 3, 1)  # stencil cells staged together, most first
LIST_FILL = 2.0 / 3.0       # share of the stencil's 3^d C slots a stage holds
THREADS_PER_SLOT = 2        # block size over the capacity, before rounding
QUEUE_DEPTH = 32            # hits a thread queues between two drains
FILTER_UNROLL = 8           # candidates filtered between two votes (kUnroll)
_META_CELLS = 32            # per-cell records of the stencil (27 used), padded

# The hi/lo filter's contract: every lo word is at most this many eps * L
# (L the box's extent, :func:`box_extent`; eps * L bounds the ulp of any
# coordinate up to L), and every coordinate, image shift included, at most
# 2 L in magnitude.
HILO_LO_BOUND = 4.0

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# Pointers in (the fourth the cell matrix), grid (nz = 1 in 2D) and
# capacity, cutoff and potential kind, four float and
# three int potential parameters, pointers out (forces, the partials,
# energy and virial), the launched cells (first_cell, n_blocks), the staging
# plan (list_len, queue_depth, smem_bytes, threads), the observables flag,
# the stream.
_SWEEP_ARGS = ((_P,) * 4 + (_I,) * 4 + (_D, _I) + (_D,) * 4 + (_I,) * 3
               + (_P,) * 5 + (_I,) * 7 + (_P,))
# The hi/lo entry takes the lo words after the hi words and the filter margin
# after the plan.
_SIGNATURES = (("mdtpu_cell_sweep_f32", _SWEEP_ARGS),
               ("mdtpu_cell_sweep_f64", _SWEEP_ARGS),
               ("mdtpu_cell_sweep_hilo_f32",
                (_P,) + _SWEEP_ARGS[:-2] + (_D, _I, _P)),
               ("mdtpu_cell_sweep_occupancy", (_I,) * 13 + (_P,)))


def _library():
    return _cuda_build.load(NAME, _SIGNATURES)


def build_report() -> str:
    """Build (if needed) the kernels; return the compiler's report."""
    return _cuda_build.build_report(NAME)


def kernel_params(potential):
    """(kind, four float parameters, three int parameters) of a potential the
    kernels have a functor for, or None: the pair-list route
    (:mod:`mdtpu_torch.ops.cell_pairs`) takes every other potential. The
    route is chosen by the potential's type alone."""
    kind = type(potential)
    mix = int(getattr(potential, "mixing", "lorentz") != "none")
    if kind is LennardJones:
        return 0, (potential.epsilon, potential.sigma, potential.r_cut, 0.0), \
            (int(potential.shift), int(potential.force_shift), mix)
    if kind is PseudoHS:
        if not isinstance(potential.lam, int) or potential.lam < 2:
            raise ValueError(f"PseudoHS lam must be an int >= 2, got "
                             f"{potential.lam!r}")
        return 1, (0.0, 0.0, 0.0, 0.0), \
            (potential.lam, int(potential.sigma_scaled_cutoff), mix)
    if kind is LennardJonesXPLOR:
        return 2, (potential.epsilon, potential.sigma, potential.r_on,
                   potential.r_cut), (0, 0, mix)
    if kind is OverlapPotential:
        return 3, (potential.tol, 0.0, 0.0, 0.0), (0, 0, 0)
    return None


def functor_params(potential):
    """:func:`kernel_params` of a potential the sweep kernels must have a
    functor for; ``ValueError`` naming the pair-list route otherwise."""
    params = kernel_params(potential)
    if params is None:
        raise ValueError(
            f"the pair-sweep kernels have no functor for "
            f"{type(potential).__name__}: CellGridEngine evaluates it on the "
            f"pair list (mdtpu_torch.ops.cell_pairs.pair_sweep)")
    return params


def stencil_cells(dim):
    """Cells of the full stencil: 27 in 3D, 9 in 2D."""
    if dim not in (2, 3):
        raise ValueError(f"the cell grid is 2D or 3D, got {dim} axes")
    return 3 ** dim


def candidate_words(dim, hilo):
    """Words a staged candidate takes in shared memory: (x, y[, z],
    diameter), and under hi/lo the lo words (4 in 3D, padded for one vector
    load; 2 in 2D)."""
    return dim + 1 + ((4 if dim == 3 else 2) if hilo else 0)


@functools.lru_cache(maxsize=None)
def stage_plan(cap, dtype, hilo=False, dim=3):
    """``(list_len, smem_bytes, threads)`` for a launch at cell capacity
    ``cap`` on a ``dim``-dimensional grid.

    ``threads``: ``THREADS_PER_SLOT`` threads per slot of a cell, rounded up
    to a power of two (at least a warp, at most 1024). A cell holds about
    half its capacity on average, so a block has several threads for each of
    its particles, and they share the particle's candidates.

    ``list_len``: how many candidates one stage holds in shared memory.
    ``LIST_FILL`` of the stencil's 3^d ``cap`` slots (the engine sizes
    ``cap`` at the mean occupancy plus 3.5 sigma, so the cells around a block
    hold about half of their slots), at least one full cell, at most what
    fits in a block's shared memory beside the threads' hit queues and the
    reduction scratch. A block whose neighbourhood holds more stages it in
    3, 9 (or 27) parts (:func:`stage_cells`). A staged candidate takes
    :func:`candidate_words` values (3D: four, eight with the lo words; 2D:
    three, five), and the list is padded by two filter chunks. The rest of
    the layout is the same in both dimensions."""
    if not 1 <= cap <= MAX_CAPACITY:
        raise ValueError(f"cell capacity {cap} outside [1, {MAX_CAPACITY}]")
    cells = stencil_cells(dim)
    esize = torch.finfo(dtype).bits // 8
    threads = min(1024, max(32, 1 << (THREADS_PER_SLOT * cap - 1).bit_length()))
    fixed = ((5 * threads + 3 * _META_CELLS) * esize + 2 * _META_CELLS * 4
             + QUEUE_DEPTH * threads * 2)
    per_candidate = candidate_words(dim, hilo) * esize
    fits = (MAX_SHARED_BYTES - fixed) // per_candidate - 2 * FILTER_UNROLL
    list_len = min(max(cap, math.ceil(LIST_FILL * cells * cap)), cells * cap,
                   fits)
    if list_len < cap:
        raise ValueError(f"no staging plan fits capacity {cap}")
    smem = per_candidate * (list_len + 2 * FILTER_UNROLL) + fixed
    return list_len, smem, threads


def stage_cells(stencil_counts, list_len):
    """How many of the stencil's cells (27, or 9 in 2D) a block stages
    together, given the occupied slots of each (in stencil order) and the
    stage's length: the most of 27, 9, 3, 1 (at most the stencil) whose
    every group of consecutive cells fits. What the kernel works out per
    block."""
    n = len(stencil_counts)
    for cells in STAGE_CELLS:
        if cells <= n and all(sum(stencil_counts[c:c + cells]) <= list_len
                              for c in range(0, n, cells)):
            return cells
    raise ValueError("a single cell exceeds the stage's length")


def blocks_per_sm(cap, dtype, hilo, potential, observables=True,
                  dim=3) -> int:
    """How many blocks of the kernel that a launch at capacity ``cap`` on a
    ``dim``-dimensional grid would run are resident on one SM together (asks
    the CUDA runtime; needs a card)."""
    lib = _library()
    kind, _, ip = functor_params(potential)
    list_len, smem, threads = stage_plan(cap, dtype, hilo, dim)
    out = ctypes.c_int(0)
    rc = lib.mdtpu_cell_sweep_occupancy(
        torch.finfo(dtype).bits // 8, int(hilo), cap, kind, *ip, list_len,
        QUEUE_DEPTH, smem, threads, int(observables), dim,
        ctypes.addressof(out))
    _cuda_build.check(lib, NAME, rc, "cell_sweep occupancy query")
    return out.value


def box_extent(cell):
    """The box's extent along the coordinate axes: ``max_k sum_a |cell[k,
    a]|`` (the sum in axis order, in the cell's dtype), as the kernel
    computes it. Every coordinate of a slot in the box, and of its image
    shifted by the cell vectors of a stencil's wrap, is below twice this in
    magnitude. For an orthorhombic box it is the longest box length."""
    ext = torch.abs(cell[:, 0])
    for a in range(1, cell.shape[1]):
        ext = ext + torch.abs(cell[:, a])
    return ext.max()


def hilo_filter_margin(dtype) -> float:
    """How far the hi/lo filter widens the cutoff radius, per unit of the
    box's extent L (:func:`box_extent`; the longest box length of an
    orthorhombic box). The filter takes the plain difference ``p`` of two
    staged hi words where the sweep forms ``d = s + (e + (lo_i - lo_j))``
    with ``s + e = hi_i - hi_j`` exactly. Per component ``|p - d|`` is at
    most ``|e| + |lo_i| + |lo_j|`` plus the rounding of ``d`` itself, with
    (eps = ulp(1), so eps * |x| bounds ulp(x)):
      * ``|e| <= ulp(s) / 2 <= eps L`` for ``|s| <= 2 L``;
      * ``|lo_i| <= HILO_LO_BOUND eps L``, the contract on the own lo word;
      * ``|lo_j| <= (HILO_LO_BOUND + 1) eps L``: the staged neighbour's lo
        word takes the residual of its image shift, at most ulp(2 L) / 2.
    That is ``(2 HILO_LO_BOUND + 2) eps L`` a component (10 eps L; 12 are
    taken), and sqrt(3) times it on the length of the displacement (sqrt(2)
    would do in 2D; one margin serves both). The
    relative rounding of ``d`` and of the two ``r2`` goes into the factors
    of :func:`hilo_filter_cutoff2`."""
    return 3.0 ** 0.5 * (2.0 * HILO_LO_BOUND + 4.0) * torch.finfo(dtype).eps


def hilo_filter_cutoff2(cutoff, box, dtype=torch.float32):
    """The squared cutoff of the hi/lo sweep's filter, a 0-dim tensor of
    ``dtype``: ``(r_c (1 + 2 eps) + margin L)^2 (1 + 16 eps)`` with L the
    box's extent (:func:`box_extent` of the cell matrix, or of the diagonal
    one of box lengths) and the margin of :func:`hilo_filter_margin`, in
    ``dtype`` arithmetic, operation for operation what the kernel computes
    from the cell matrix on the device. Every pair whose hi/lo ``r2`` is
    below the squared engine cutoff has its plain hi-word ``r2`` below this:
    a computed ``r2 < r_c^2`` means a true length below ``r_c (1 + 2 eps)``;
    the plain displacement is longer by at most ``margin L``; and its
    computed ``r2`` exceeds the true square by less than 4 eps relative.
    The remaining factor covers the rounding of these few operations."""
    box = torch.as_tensor(box, dtype=dtype)
    cell = as_cell(box, box.shape[0])
    eps = torch.finfo(dtype).eps

    def t(value):
        return torch.tensor(value, dtype=dtype, device=box.device)

    rc_wide = (t(cutoff) * (t(1.0) + t(2.0) * t(eps))
               + t(hilo_filter_margin(dtype)) * box_extent(cell))
    return rc_wide * rc_wide * (t(1.0) + t(16.0) * t(eps))


def as_cell(box, dim):
    """The (dim, dim) cell matrix of ``box``: the matrix itself, or the
    diagonal one of (dim,) box lengths."""
    if tuple(box.shape) == (dim,):
        return torch.diag(box)
    if tuple(box.shape) != (dim, dim):
        raise ValueError(f"box must be the ({dim}, {dim}) cell matrix or the "
                         f"{dim} box lengths, got {tuple(box.shape)}")
    return box


def check_inputs(slot_pos, slot_diam, counts, box, grid, max_capacity):
    """Validate the slot layout (a 2D or 3D grid); returns ``(n_cells,
    capacity)``."""
    dim = len(grid)
    if dim not in (2, 3) or min(grid) < 3:
        raise ValueError(f"the sweep needs a 2D or 3D grid with >= 3 cells "
                         f"per axis, got {tuple(grid)}")
    n_cells = math.prod(grid)
    if slot_pos.dim() != 2 or slot_pos.shape[0] != dim \
            or slot_pos.shape[1] % n_cells:
        raise ValueError(f"slot_pos must be ({dim}, n_cells * C), got "
                         f"{tuple(slot_pos.shape)} for {n_cells} cells")
    cap = slot_pos.shape[1] // n_cells
    if not 1 <= cap <= max_capacity:
        raise ValueError(f"cell capacity {cap} outside [1, {max_capacity}]")
    if tuple(slot_diam.shape) != (slot_pos.shape[1],):
        raise ValueError("slot_diam must be (n_cells * C,)")
    if tuple(counts.shape) != (n_cells,) or counts.dtype != torch.int64:
        raise ValueError("counts must be int64 of shape (n_cells,)")
    as_cell(box, dim)
    return n_cells, cap


def check_cuda(tensors, dtypes):
    """Raise unless every tensor is a contiguous CUDA tensor on the first
    one's device and the float tensors share one of ``dtypes``; returns
    the device and the dtype."""
    device, dtype = tensors[0].device, tensors[0].dtype
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if dtype not in dtypes:
        raise TypeError(f"the kernel takes {dtypes}, got {dtype}")
    for t in tensors:
        if t.is_floating_point() and t.dtype != dtype:
            raise TypeError("the float inputs must share one dtype")
        if t.device != device:
            raise ValueError("all sweep inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("sweep inputs must be contiguous")
    return device, dtype


def check_interior(interior, n_cells):
    """``(first_cell, n_blocks)`` of a launch: the whole grid for None,
    else a non-empty run of cells inside it."""
    if interior is None:
        return 0, n_cells
    first, count = (int(v) for v in interior)
    if first < 0 or count < 1 or first + count > n_cells:
        raise ValueError(f"interior cells [{first}, {first + count}) outside "
                         f"the grid's {n_cells}")
    return first, count


def cell_sweep(slot_pos, slot_diam, counts, box, grid, cutoff, potential,
               observables=True, interior=None, out=None, scalars_out=None):
    """The pair sweep. CUDA tensors launch the kernel (or raise); CPU tensors
    take :func:`cell_sweep_plain`. Each launch adds one to
    ``cell_sweep.launches``, and a launch of the lean variant
    (``observables=False``) also to ``cell_sweep.lean_launches``. The lean
    variant's energy and virial are one zero made once (:func:`lean_zero`).
    ``out``: a contiguous tensor of the forces' shape and dtype that the
    kernel writes them into (the slot advance's buffer), returned as the
    forces. On the card the full variant sums energy and virial in its last
    block (one launch, no sum after it); ``scalars_out``: the ``(energy,
    virial)`` 0-d tensors of the positions' dtype it writes them into,
    returned as they are (a full sweep only; on the CPU the plain version's
    are copied in).

    ``interior=(first_cell, n_cells_out)``: the sweep of those cells only
    (one block each), every cell of the grid still read as a neighbour. The
    forces come back for their slots, ``(d, n_cells_out * C)``, and energy
    and virial sum their pairs (each halved, as always). The slab of
    :class:`mdtpu_torch.parallel.HaloSlotEngine` is such a run: the
    interior x-planes of a grid with a ghost plane on each side. Such a
    launch also adds one to ``cell_sweep.slab_launches`` (and a lean one to
    ``cell_sweep.slab_lean_launches``)."""
    n_cells, cap = check_inputs(slot_pos, slot_diam, counts, box, grid,
                                MAX_CAPACITY)
    first, n_out = check_interior(interior, n_cells)
    _check_scalars_out(scalars_out, observables)
    if slot_pos.device.type == "cpu":
        return _into(out, scalars_out, cell_sweep_plain(
            slot_pos, slot_diam, counts, box, grid, cutoff, potential,
            observables, interior))
    cell = as_cell(box, len(grid)).contiguous()
    device, dtype = check_cuda((slot_pos, slot_diam, counts, cell),
                               (torch.float32, torch.float64))
    lib = _library()
    fn = (lib.mdtpu_cell_sweep_f32 if dtype == torch.float32
          else lib.mdtpu_cell_sweep_f64)
    result = launch_sweep(lib, NAME, fn, (slot_pos, slot_diam, counts, cell),
                          grid, cap, cutoff, potential, n_out, "cell_sweep",
                          plan=(first, n_out,
                                *_plan_args(cap, dtype, False, len(grid)),
                                int(observables)),
                          observables=observables, out=out, folds=True,
                          scalars_out=scalars_out)
    _count(cell_sweep, observables, interior)
    return result


def cell_sweep_hilo(slot_pos, slot_lo, slot_diam, counts, box, grid, cutoff,
                    potential, observables=True, interior=None, out=None,
                    scalars_out=None):
    """The hi/lo pair sweep (float32). CUDA tensors launch the kernel (or
    raise); CPU tensors take :func:`cell_sweep_hilo_plain`. Each launch adds
    one to ``cell_sweep_hilo.launches``, and a launch of the lean variant
    also to ``cell_sweep_hilo.lean_launches``. ``interior``, ``out`` and
    ``scalars_out`` as in :func:`cell_sweep` (counted in
    ``cell_sweep_hilo.slab_launches``)."""
    n_cells, cap = check_inputs(slot_pos, slot_diam, counts, box, grid,
                                MAX_CAPACITY)
    first, n_out = check_interior(interior, n_cells)
    _check_scalars_out(scalars_out, observables)
    if tuple(slot_lo.shape) != tuple(slot_pos.shape):
        raise ValueError("slot_lo must have the shape of slot_pos")
    if slot_pos.device.type == "cpu":
        return _into(out, scalars_out, cell_sweep_hilo_plain(
            slot_pos, slot_lo, slot_diam, counts, box, grid, cutoff,
            potential, observables, interior))
    cell = as_cell(box, len(grid)).contiguous()
    check_cuda((slot_pos, slot_lo, slot_diam, counts, cell), (torch.float32,))
    lib = _library()
    result = launch_sweep(
        lib, NAME, lib.mdtpu_cell_sweep_hilo_f32,
        (slot_pos, slot_lo, slot_diam, counts, cell), grid, cap, cutoff,
        potential, n_out, "cell_sweep_hilo",
        plan=(first, n_out, *_plan_args(cap, torch.float32, True, len(grid)),
              hilo_filter_margin(torch.float32), int(observables)),
        observables=observables, out=out, folds=True,
        scalars_out=scalars_out)
    _count(cell_sweep_hilo, observables, interior)
    return result


def _check_scalars_out(scalars_out, observables):
    if scalars_out is not None and not observables:
        raise ValueError("a lean sweep writes no energy and virial")


def _into(out, scalars_out, result):
    """A plain sweep's ``(energy, virial, forces)`` with the forces copied
    into ``out`` and energy and virial into ``scalars_out`` where given."""
    energy, virial, force = result
    if scalars_out is not None:
        energy, virial = (dst.copy_(src) for dst, src in
                          zip(scalars_out, (energy, virial)))
    return energy, virial, force if out is None else out.copy_(force)


_ZEROS = {}


def lean_zero(dtype, device):
    """The 0-d zero a lean launch returns as its energy and virial: made
    once per dtype and card, outside any CUDA-graph capture (a zero made
    during one is the graph's alone and is not kept), so a lean launch
    adds no fill to a step. Callers read it and never write it."""
    key = (dtype, torch.device(device))
    zero = _ZEROS.get(key)
    if zero is None:
        zero = torch.zeros((), dtype=dtype, device=device)
        if not (zero.is_cuda and torch.cuda.is_current_stream_capturing()):
            _ZEROS[key] = zero
    return zero


def _count(wrapper, observables, interior=None):
    wrapper.launches += 1
    if not observables:
        wrapper.lean_launches += 1
    if interior is not None:
        wrapper.slab_launches += 1
        if not observables:
            wrapper.slab_lean_launches += 1


def reset_launches():
    """Set both sweeps' launch counts to 0."""
    for wrapper in (cell_sweep, cell_sweep_hilo):
        wrapper.launches = wrapper.lean_launches = 0
        wrapper.slab_launches = wrapper.slab_lean_launches = 0


reset_launches()
for _wrapper in (cell_sweep, cell_sweep_hilo):
    counters.register(_wrapper, "launches", "lean_launches", "slab_launches",
                      "slab_lean_launches")


def _plan_args(cap, dtype, hilo, dim):
    list_len, smem, threads = stage_plan(cap, dtype, hilo, dim)
    return list_len, QUEUE_DEPTH, smem, threads


def launch_sweep(lib, name, fn, inputs, grid, cap, cutoff, potential,
                 n_cells, what, scratch=(), plan=(), observables=True,
                 out=None, folds=False, scalars_out=None):
    """Launch a sweep entry point of the library of ``csrc/<name>.cu`` on
    the current stream: ``fn(inputs..., nx, ny, nz, cap, cutoff, kind,
    p0..p3, i0..i2, force, e_part, w_part, scratch..., plan..., stream)``
    (``scratch`` tensors, ``plan`` numbers; a 2D grid goes as nx x ny x 1).
    Allocates the outputs for ``n_cells`` cells (the grid's, or the run a
    launch covers), raises on a launch error, and returns ``(energy,
    virial, slot_forces)`` with the per-cell partials summed on the device;
    ``observables=False`` (a lean launch) passes no partials and returns
    :func:`lean_zero` for both scalars. ``out``: the forces' tensor, where
    the caller gives one. ``folds``: the entry point takes two more
    pointers after the partials, the energy and the virial, which its last
    block sums them into (null on a lean launch); else the partials are
    summed by ``torch.sum``. ``scalars_out`` (``folds`` only): the
    ``(energy, virial)`` 0-d tensors to write (new ones where None)."""
    kind, fp, ip = functor_params(potential)
    slot_pos = inputs[0]
    dtype, device = slot_pos.dtype, slot_pos.device
    shape = (slot_pos.shape[0], n_cells * cap)
    if out is None:
        force = torch.empty(shape, dtype=dtype, device=device)
    elif (tuple(out.shape) != shape or out.dtype != dtype
          or out.device != device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {shape} tensor of the "
                         f"positions' dtype and device")
    else:
        force = out
    if observables:
        e_part = torch.empty((n_cells,), dtype=dtype, device=device)
        w_part = torch.empty((n_cells,), dtype=dtype, device=device)
        partials = (e_part.data_ptr(), w_part.data_ptr())
        if folds:
            if scalars_out is None:
                scalars_out = (torch.empty((), dtype=dtype, device=device),
                               torch.empty((), dtype=dtype, device=device))
            for t in scalars_out:
                if t.dim() != 0 or t.dtype != dtype or t.device != device:
                    raise ValueError("energy and virial outputs must be 0-d "
                                     "tensors of the positions' dtype and "
                                     "device")
            partials += tuple(t.data_ptr() for t in scalars_out)
    else:
        partials = (None, None) + ((None, None) if folds else ())
    nx, ny, nz = (*(int(g) for g in grid), 1)[:3]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*(t.data_ptr() for t in inputs), nx, ny, nz, cap,
                float(cutoff), kind, *(float(v) for v in fp), *ip,
                force.data_ptr(), *partials,
                *(t.data_ptr() for t in scratch), *plan, stream)
    _cuda_build.check(lib, name, rc, what)
    if not observables:
        zero = lean_zero(dtype, device)
        return zero, zero, force
    if not folds:
        return torch.sum(e_part), torch.sum(w_part), force
    return scalars_out[0], scalars_out[1], force


def _neighbour_cells(grid, off, cell, device, cells=None):
    """For stencil offset ``off``: the periodic index of each cell's
    neighbour (n_cells,), and the image shift of its coordinates as terms:
    ``terms[k][a]`` (n_cells,) is ``w_a cell[k, a]``, ``w_a`` in {-1, 0, +1}
    the neighbour's wrap along grid axis ``a``. ``cells``: the run of cells
    (a ``range``) to do it for, all by default."""
    dim = len(grid)
    cells = range(math.prod(grid)) if cells is None else cells
    c = torch.arange(cells.start, cells.stop, device=device)
    idx, wraps, stride = 0, [], 1
    for a in reversed(range(dim)):
        n = int(grid[a])
        j = (c // stride) % n + off[a]
        wraps.append((j >= n).to(cell.dtype) - (j < 0).to(cell.dtype))
        idx = idx + torch.remainder(j, n) * stride
        stride *= n
    wraps.reverse()
    terms = [[wraps[a] * cell[k, a] for a in range(dim)] for k in range(dim)]
    return idx, terms


def _summed_shift(terms_k):
    """``sum_a terms_k[a]`` in axis order, as the kernel sums a staged
    neighbour's plain image shift."""
    shift = terms_k[0]
    for t in terms_k[1:]:
        shift = shift + t
    return shift


class PairTiles:
    """The plain sweeps' pair arithmetic: one (n_cells, C, C) tile of own
    slots against one neighbour cell per stencil offset, loops bounded by the
    per-cell counts through masks. With ``slot_lo`` the displacements are
    the hi/lo ones of the kernel's HILO variant: the image shift goes onto
    the hi word one cell vector at a time through ``two_sum``, its residuals
    into the lo word. ``interior=(first_cell, n)``: the own cells are that
    run only (the tiles are (n, C, C)); every cell is still a neighbour."""

    def __init__(self, slot_pos, slot_diam, counts, box, grid, cutoff,
                 potential, slot_lo=None, interior=None):
        self.dim = len(grid)
        self.n_cells = math.prod(grid)
        self.cap = slot_pos.shape[1] // self.n_cells
        self.grid, self.potential = grid, potential
        self.cell = as_cell(box, self.dim)
        self.dtype, self.device = slot_pos.dtype, slot_pos.device
        nc, cap, dim = self.n_cells, self.cap, self.dim
        first, n_own = check_interior(interior, nc)
        self.cells = range(first, first + n_own)
        self.n_own = n_own
        own = slice(first, first + n_own)
        self.pos = slot_pos.reshape(dim, nc, cap)
        self.lo = None if slot_lo is None else slot_lo.reshape(dim, nc, cap)
        self.diam = slot_diam.reshape(nc, cap)
        self.own_pos = self.pos[:, own]
        self.own_lo = None if self.lo is None else self.lo[:, own]
        self.own_diam = self.diam[own]
        slot = torch.arange(cap, device=self.device)
        self.occ = slot[None, :] < counts.clamp(max=cap)[:, None]
        self.own_occ = self.occ[own]
        self.not_self = ~torch.eye(cap, dtype=torch.bool, device=self.device)
        c_eng = rounded(cutoff, self.dtype)
        self.cutoff2 = rounded(c_eng * c_eng, self.dtype)

    def offsets(self):
        """The stencil's offsets in the kernel's order (the last axis
        fastest)."""
        return list(itertools.product((-1, 0, 1), repeat=self.dim))

    def pairs(self, off):
        """``(nb, d, r2, mask)`` for stencil offset ``off``: the neighbour
        index per cell, the displacement components and r^2 of own slot i
        against neighbour slot j as (n_cells, C, C) tiles, and the pairs
        inside the engine cutoff (both occupied, not the self pair)."""
        nb, terms = _neighbour_cells(self.grid, off, self.cell, self.device,
                                     self.cells)
        d = []
        for k in range(self.dim):
            if self.lo is None:
                w = self.pos[k][nb] + _summed_shift(terms[k])[:, None]
                d.append(self.own_pos[k][:, :, None] - w[:, None, :])
            else:
                w, w_lo = self.pos[k][nb], self.lo[k][nb]
                for a in range(self.dim):
                    w, r = two_sum(w, terms[k][a][:, None])
                    w_lo = w_lo + r
                s, e = two_sum(self.own_pos[k][:, :, None], -w[:, None, :])
                d.append(s + (e + (self.own_lo[k][:, :, None]
                                   - w_lo[:, None, :])))
        r2 = d[0] * d[0]
        for dk in d[1:]:
            r2 = r2 + dk * dk
        mask = (self.own_occ[:, :, None] & self.occ[nb][:, None, :]
                & (r2 < self.cutoff2))
        if not any(off):
            mask = mask & self.not_self
        return nb, d, r2, mask

    def tile(self, off):
        """``(nb, u, f_over_r, r2, d)`` for stencil offset ``off``: the
        neighbour index per cell, and (n_cells, C, C) pair tiles of own slot
        i against neighbour slot j (zero outside the masks)."""
        nb, d, r2, mask = self.pairs(off)
        r2s = torch.where(mask, r2, torch.ones_like(r2))
        u, f = self.potential.evaluate_r2(r2s, self.own_diam[:, :, None],
                                          self.diam[nb][:, None, :])
        u = torch.where(mask, u, torch.zeros_like(u))
        f = torch.where(mask, f, torch.zeros_like(f))
        return nb, u, f, r2s, d


def _full_stencil_plain(tiles, observables=True):
    zero = torch.zeros((), dtype=tiles.dtype, device=tiles.device)
    energy, virial = zero, zero
    force = torch.zeros((tiles.dim, tiles.n_own, tiles.cap),
                        dtype=tiles.dtype, device=tiles.device)
    for off in tiles.offsets():
        _, u, f, r2s, d = tiles.tile(off)
        if observables:
            energy = energy + 0.5 * torch.sum(u)
            virial = virial + 0.5 * torch.sum(f * r2s)
        for k in range(tiles.dim):
            force[k] += torch.sum(f * d[k], dim=2)
    return energy, virial, force.reshape(tiles.dim, -1)


def cell_sweep_plain(slot_pos, slot_diam, counts, box, grid, cutoff,
                     potential, observables=True, interior=None):
    """The sweep in plain PyTorch, same arguments and results as
    :func:`cell_sweep`: one (n_cells, C, C) pair tile per stencil offset,
    neighbour cells found by periodic index with their image shift (the
    summed cell vectors of their wrap) added, loops bounded by the per-cell
    counts through masks."""
    check_inputs(slot_pos, slot_diam, counts, box, grid, MAX_CAPACITY)
    return _full_stencil_plain(PairTiles(slot_pos, slot_diam, counts, box,
                                         grid, cutoff, potential,
                                         interior=interior), observables)


def cell_sweep_hilo_plain(slot_pos, slot_lo, slot_diam, counts, box, grid,
                          cutoff, potential, observables=True,
                          interior=None):
    """The hi/lo sweep in plain PyTorch, same arguments and results as
    :func:`cell_sweep_hilo`: the image shift goes onto the hi word through
    ``two_sum``, one cell vector at a time, with the residuals folded into
    the lo word, and each displacement is ``s + (e + (lo_i - lo_j))`` with
    ``(s, e) = two_sum(hi_i, -hi_j)``."""
    check_inputs(slot_pos, slot_diam, counts, box, grid, MAX_CAPACITY)
    return _full_stencil_plain(PairTiles(slot_pos, slot_diam, counts, box,
                                         grid, cutoff, potential,
                                         slot_lo=slot_lo, interior=interior),
                               observables)
