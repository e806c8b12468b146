"""Cell-binned Verlet neighbour-list engine for orthorhombic 2D and 3D boxes.

Counterpart of ``mdtpu/ops/neighbor_list.py`` (``estimate_capacities``,
``NeighborState`` and ``NeighborListEngine``: ``create``,
``with_grown_capacity``, ``allocate``, ``needs_rebuild``, ``compute``).

  *Build* (:meth:`NeighborListEngine.allocate`, at rebuilds): particles are
  binned on their fractional coordinates into the cell grid of
  :func:`~mdtpu_torch.ops.cell_grid.grid_for_box` (a stable argsort, counts
  by ``scatter_add_``, an ``(n_cells, C)`` bucket with sentinel N, ranks at
  or past C dropped), then :func:`nl_build` lists for every particle the
  particles of the 3^d stencil cells within ``cutoff + skin`` into a padded
  ``(N, K)`` index array (sentinel N) and a per-row count. The argsort
  (``order``, the particles sorted by cell) is kept in the state.
  *Forces* (:meth:`NeighborListEngine.compute`, every step): for every row,
  the pairs inside the cutoff, computed from both sides (energy and virial
  halved), forces summed per row: no scatter. The kernel takes the rows in
  the state's ``order``, so the rows of a block are neighbours in space.

Both are hand-written CUDA kernels (``csrc/neighbor_list.cu``): K1
:func:`nl_build` and K2 :func:`nl_forces`. CUDA tensors launch them (or
raise); CPU tensors take the plain versions :func:`nl_build_plain` (the JAX
algorithm: the candidates' distances, then the K closest by ``torch.topk``)
and :func:`nl_forces_plain` (the JAX function's ``(N, K)`` tiles). A
potential without a kernel functor
(:func:`~mdtpu_torch.ops.cell_sweep.kernel_params` is None, a choice by
type) takes :func:`nl_forces_plain` on every device: it is the potential's
own ``evaluate_r2`` on the gathered tiles.

Rows: K1 keeps each row's first K hits in stencil order (then slot order),
the JAX build and :func:`nl_build_plain` the K closest, sorted by r^2;
``nl_build_plain(..., stencil_order=True)`` keeps K1's. Without overflow
they hold the same neighbours (rows equal as sets) and the forces differ
only in the order of their sums. Under overflow (a cell holds more than C,
or a row more than K hits) the kept subsets may differ, but no result is
taken from an overflowed list: the flag is sticky, and the driver and FIRE
rerun on :meth:`NeighborListEngine.with_grown_capacity`.

The minimum image is the orthorhombic one, ``d - L rint(d / L)`` per
component; :meth:`NeighborListEngine.create` refuses a tilted box.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from mdtpu_torch.core.box import _mm, is_orthorhombic
from mdtpu_torch.ops import _cuda_build
from mdtpu_torch.ops.cell_grid import cell_ids, grid_for_box
from mdtpu_torch.ops.cell_sweep import (check_cuda, functor_params,
                                        kernel_params)
from mdtpu_torch.ops.philox_draws import rebuild_flag_rows
from mdtpu_torch.potentials.base import (check_engine_cutoff,
                                         potential_values, rounded)
from mdtpu_torch.utils import counters

NAME = "neighbor_list"
THREADS = 256                # kThreads of K2: THREADS / LANES rows a block
LANES = 4                    # kLanes of K2: lanes a row
BUILD_STAGE_BYTES = 48 * 1024  # K1's budget for a stage of the stencil
PLAIN_CHUNK = 1 << 22        # candidate entries of one plain build chunk

_UNIT_BALL_VOLUME = {1: 2.0, 2: math.pi, 3: 4.0 * math.pi / 3.0}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# positions, order, starts, cell_buf, counts, lengths, n, dim, nx, ny, nz,
# cap, K, r_list^2, stage cells, idx, count, overflow, stream
_BUILD_ARGS = (_P,) * 6 + (_I,) * 7 + (_D, _I) + (_P,) * 4
# positions, diameters, idx, count, order, lengths, n, dim, K, cutoff,
# potential kind, four float and three int parameters, force, energy and
# virial partials, stream
_FORCES_ARGS = ((_P,) * 6 + (_I,) * 3 + (_D, _I) + (_D,) * 4 + (_I,) * 3
                + (_P,) * 4)
_SIGNATURES = (("mdtpu_nl_build_f32", _BUILD_ARGS),
               ("mdtpu_nl_build_f64", _BUILD_ARGS),
               ("mdtpu_nl_forces_f32", _FORCES_ARGS),
               ("mdtpu_nl_forces_f64", _FORCES_ARGS))


def _library():
    return _cuda_build.load(NAME, _SIGNATURES)


def build_report() -> str:
    """Build (if needed) the kernels; return the compiler's report."""
    return _cuda_build.build_report(NAME)


def estimate_capacities(n_particles: int, unitcell, cutoff: float,
                        skin: float, grid: Tuple[int, ...]):
    """Heuristic (cell capacity C, max neighbours K) with headroom for
    density fluctuations, as the JAX package's: C = ceil(2.5 mean
    occupancy + 8), K = ceil(1.6 mean list length + 8) rounded up to a
    multiple of 8."""
    dim = len(grid)
    volume = abs(float(np.linalg.det(np.asarray(unitcell, dtype=np.float64))))
    density = n_particles / volume
    cell_volume = volume / int(np.prod(grid))
    avg_cell = density * cell_volume
    c = int(math.ceil(avg_cell * 2.5 + 8))
    r_list = cutoff + skin
    n_ball = density * _UNIT_BALL_VOLUME[dim] * r_list ** dim
    k = int(math.ceil(n_ball * 1.6 + 8))
    k = ((k + 7) // 8) * 8
    return c, k


@dataclass(frozen=True)
class NeighborState:
    idx: torch.Tensor            # (N, K) int32 neighbour ids, sentinel N
    ref_positions: torch.Tensor  # (N, d) positions at build time
    overflow: torch.Tensor       # () bool: capacities exceeded at build
    count: torch.Tensor          # (N,) int32 entries of each row (<= K)
    # (N,) int32 the particles sorted by cell at build time (K2 takes its
    # rows in this order); None: particle order.
    order: Optional[torch.Tensor] = None


def _check_build(positions, cid, cell_buf, counts, lengths, grid):
    n, dim = positions.shape
    if len(grid) != dim or dim not in (2, 3) or min(grid) < 3:
        raise ValueError(f"the list takes a 2D or 3D grid of >= 3 cells per "
                         f"axis matching the positions, got {tuple(grid)}")
    n_cells = math.prod(grid)
    if cell_buf.dim() != 2 or cell_buf.shape[0] != n_cells:
        raise ValueError(f"cell_buf must be ({n_cells}, C)")
    if tuple(counts.shape) != (n_cells,) or counts.dtype != torch.int64:
        raise ValueError("counts must be int64 of shape (n_cells,)")
    if tuple(cid.shape) != (n,) or tuple(lengths.shape) != (dim,):
        raise ValueError("cid must be (N,) and lengths (d,)")


def build_plan(cap, dim, dtype):
    """K1's stage: the stencil cells a stage of shared memory holds, all
    3^d where ``3^d C`` candidates (an id and d coordinates each) fit
    :data:`BUILD_STAGE_BYTES`, else 3^(d-1), 3 or 1 (a smaller stage is
    refilled for each part of the stencil). One cell's stage may pass the
    budget up to the block's shared memory, which bounds C: at most 14,464
    (f32) or 8,265 (f64) in 3D, 19,285 or 11,571 in 2D; past it
    :func:`nl_build` raises ``RuntimeError``."""
    record = 4 + dim * torch.finfo(dtype).bits // 8
    cells = 3 ** dim
    while cells > 1 and cells * cap * record > BUILD_STAGE_BYTES:
        cells //= 3
    return cells


def sort_by_cell(cid, counts):
    """``(order (N,) int32, starts (n_cells,) int64)``: the particles
    sorted by cell (a stable argsort of ``cid``) and where each cell's run
    of them begins."""
    order = torch.argsort(cid, stable=True).to(torch.int32)
    return order, torch.cumsum(counts, 0) - counts


def nl_build(positions, cid, cell_buf, counts, lengths, grid, r_list,
             max_neighbors, *, order=None, starts=None):
    """The list: ``(idx (N, K) int32, count (N,) int32, overflow () bool)``
    from ``positions`` (N, d), each particle's cell ``cid`` (N,), the bucket
    ``cell_buf`` (n_cells, C) int32 of particle ids by cell (sentinel N),
    ``counts`` (n_cells,) int64 of particles binned per cell (may exceed C),
    the box ``lengths`` (d,), the ``grid``, the list radius ``r_list`` (the
    test is ``r^2 < r_list * r_list``, the product in float64 rounded to the
    dtype, as the JAX build compares) and K. ``order`` (N,) int32 and
    ``starts`` (n_cells,) int64, the particles sorted by cell and where each
    cell's run begins (:func:`sort_by_cell`, which derives them where they
    are not given), tell K1's blocks their own particles. CUDA tensors
    launch K1 (or raise); CPU tensors take :func:`nl_build_plain`. Each
    launch adds one to ``nl_build.launches``."""
    _check_build(positions, cid, cell_buf, counts, lengths, grid)
    if positions.device.type == "cpu":
        return nl_build_plain(positions, cid, cell_buf, counts, lengths,
                              grid, r_list, max_neighbors)
    if order is None or starts is None:
        order, starts = sort_by_cell(cid, counts)
    _, dtype = check_cuda((positions, order, starts, cell_buf, counts,
                           lengths), (torch.float32, torch.float64))
    if cell_buf.dtype != torch.int32 or order.dtype != torch.int32:
        raise TypeError("cell_buf and order must be int32")
    n, dim = positions.shape
    if tuple(order.shape) != (n,) or starts.shape != counts.shape \
            or starts.dtype != torch.int64:
        raise ValueError("order must be (N,) and starts int64 (n_cells,)")
    device = positions.device
    k_max = int(max_neighbors)
    cap = int(cell_buf.shape[1])
    stage_cells = build_plan(cap, dim, dtype)
    idx = torch.empty((n, k_max), dtype=torch.int32, device=device)
    count = torch.empty(n, dtype=torch.int32, device=device)
    flag = torch.zeros(1, dtype=torch.int32, device=device)
    lib = _library()
    fn = lib.mdtpu_nl_build_f32 if dtype == torch.float32 \
        else lib.mdtpu_nl_build_f64
    nx, ny, nz = (*(int(g) for g in grid), 1)[:3]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(positions.data_ptr(), order.data_ptr(), starts.data_ptr(),
                cell_buf.data_ptr(), counts.data_ptr(), lengths.data_ptr(),
                n, dim, nx, ny, nz, cap, k_max,
                float(r_list) * float(r_list), stage_cells, idx.data_ptr(),
                count.data_ptr(), flag.data_ptr(), stream)
    _cuda_build.check(lib, NAME, rc, "nl_build")
    nl_build.launches += 1
    return idx, count, flag[0] != 0


def _stencil(dim, device):
    """The 3^d stencil offsets (S, d), the last axis fastest (the kernel's
    order and the JAX meshgrid's)."""
    return torch.tensor(list(itertools.product((-1, 0, 1), repeat=dim)),
                        dtype=torch.int64, device=device)


def nl_build_plain(positions, cid, cell_buf, counts, lengths, grid, r_list,
                   max_neighbors, stencil_order=False):
    """:func:`nl_build` in plain PyTorch, the JAX build's algorithm: each
    row's candidates (the stencil cells' buckets), their minimum-image r^2,
    the hits (not self, below ``r_list^2``) scored -r^2 and the K best kept
    by ``torch.topk``, so a row holds its K closest neighbours sorted by
    r^2. With ``stencil_order`` a row keeps K1's entries instead: its first
    K hits in stencil order, then slot order (a stable compaction of the
    same hits). Rows are taken in chunks of about ``PLAIN_CHUNK``
    candidates."""
    _check_build(positions, cid, cell_buf, counts, lengths, grid)
    n, dim = positions.shape
    device, dtype = positions.device, positions.dtype
    k_max = int(max_neighbors)
    cap = cell_buf.shape[1]
    g = torch.tensor(grid, dtype=torch.int64, device=device)
    strides = [math.prod(grid[a + 1:]) for a in range(dim)]
    cid = cid.to(torch.int64)
    coords = torch.stack([(cid // s) % int(ga) for s, ga in
                          zip(strides, grid)], dim=1)
    offsets = _stencil(dim, device)
    stride_t = torch.tensor(strides, dtype=torch.int64, device=device)
    buf = cell_buf.to(torch.int64)
    threshold = rounded(float(r_list) * float(r_list), dtype)
    n_cand = offsets.shape[0] * cap
    kk = min(k_max, n_cand)
    idx = torch.full((n, k_max), n, dtype=torch.int32, device=device)
    count = torch.empty(n, dtype=torch.int32, device=device)
    over_k = torch.zeros((), dtype=torch.bool, device=device)
    rows = max(1, PLAIN_CHUNK // n_cand)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        own = torch.arange(r0, r1, device=device)
        nbr = (coords[r0:r1, None, :] + offsets[None]) % g
        cand = buf[(nbr * stride_t).sum(-1)].reshape(r1 - r0, n_cand)
        cand_safe = torch.where(cand < n, cand, torch.zeros_like(cand))
        r2 = torch.zeros(cand.shape, dtype=dtype, device=device)
        for k in range(dim):
            ck = positions[:, k]
            dk = ck[r0:r1, None] - ck[cand_safe]
            dk = dk - lengths[k] * torch.round(dk / lengths[k])
            r2 = r2 + dk * dk
        valid = (cand < n) & (cand != own[:, None]) & (r2 < threshold)
        if stencil_order:
            ti = torch.argsort(~valid, dim=1, stable=True)[:, :kk]
            kept = torch.take_along_dim(valid, ti, dim=1)
        else:
            score = torch.where(valid, -r2, torch.full_like(r2, -math.inf))
            vals, ti = torch.topk(score, kk, dim=1)
            kept = torch.isfinite(vals)
        sel = torch.take_along_dim(cand, ti, dim=1)
        idx[r0:r1, :kk] = torch.where(kept, sel,
                                      torch.full_like(sel, n)).to(torch.int32)
        hits = valid.sum(dim=1)
        count[r0:r1] = hits.clamp(max=k_max).to(torch.int32)
        over_k = over_k | torch.any(hits > k_max)
    return idx, count, torch.any(counts > cap) | over_k


def nl_forces(positions, diameters, idx, count, lengths, cutoff, potential,
              order=None):
    """``(energy, virial, forces (N, d))`` of the pairs of the list within
    ``cutoff`` (``r^2 < c^2``, the product in the dtype), each pair in both
    rows, energy and virial halved. ``order`` (N,) int32, a permutation of
    the rows (the state's particles sorted by cell), is the order in which
    K2's workers take them (None: particle order); it changes no row's sum.
    CUDA tensors launch K2 (or raise; the potential must have a kernel
    functor); CPU tensors take :func:`nl_forces_plain`. Each launch adds one
    to ``nl_forces.launches``."""
    n, dim = positions.shape
    if idx.dim() != 2 or idx.shape[0] != n or tuple(count.shape) != (n,):
        raise ValueError("idx must be (N, K) and count (N,)")
    if positions.device.type == "cpu":
        return nl_forces_plain(positions, diameters, idx, count, lengths,
                               cutoff, potential)
    kind, fp, ip = functor_params(potential)
    _, dtype = check_cuda((positions, diameters, idx, count, lengths)
                          + (() if order is None else (order,)),
                          (torch.float32, torch.float64))
    if idx.dtype != torch.int32 or count.dtype != torch.int32:
        raise TypeError("idx and count must be int32")
    if order is not None and (order.dtype != torch.int32
                              or tuple(order.shape) != (n,)):
        raise ValueError("order must be int32 of shape (N,)")
    device = positions.device
    force = torch.empty((n, dim), dtype=dtype, device=device)
    blocks = -(-n // (THREADS // LANES))
    partials = torch.empty((2, blocks), dtype=dtype, device=device)
    lib = _library()
    fn = lib.mdtpu_nl_forces_f32 if dtype == torch.float32 \
        else lib.mdtpu_nl_forces_f64
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(positions.data_ptr(), diameters.data_ptr(), idx.data_ptr(),
                count.data_ptr(), 0 if order is None else order.data_ptr(),
                lengths.data_ptr(), n, dim, int(idx.shape[1]), float(cutoff),
                kind,
                *(float(v) for v in fp), *ip, force.data_ptr(),
                partials[0].data_ptr(), partials[1].data_ptr(), stream)
    _cuda_build.check(lib, NAME, rc, "nl_forces")
    nl_forces.launches += 1
    return 0.5 * partials[0].sum(), 0.5 * partials[1].sum(), force


def nl_forces_plain(positions, diameters, idx, count, lengths, cutoff,
                    potential):
    """:func:`nl_forces` in plain PyTorch, the JAX ``compute``: component
    tiles ``(N, K)`` of the gathered minimum-image displacements, the
    cutoff mask, the potential's ``evaluate_r2`` on the tiles (1 where
    masked), row sums. The entries past each row's count are the sentinel
    N, so ``count`` is not read. This is also the route of a potential
    without a kernel functor, on every device."""
    n, dim = positions.shape
    dtype = positions.dtype
    valid = idx < n
    idx_safe = torch.where(valid, idx, torch.zeros_like(idx)).to(torch.int64)
    d_comps = []
    r2 = torch.zeros(idx.shape, dtype=dtype, device=positions.device)
    for k in range(dim):
        ck = positions[:, k]
        dk = ck[:, None] - ck[idx_safe]
        dk = dk - lengths[k] * torch.round(dk / lengths[k])
        d_comps.append(dk)
        r2 = r2 + dk * dk
    c = rounded(cutoff, dtype)
    mask = valid & (r2 < rounded(c * c, dtype))
    r2_safe = torch.where(mask, r2, torch.ones_like(r2))
    u, f_over_r = potential_values(potential, "evaluate_r2", r2_safe,
                                   diameters[:, None], diameters[idx_safe])
    u = torch.where(mask, u, torch.zeros_like(u))
    f_over_r = torch.where(mask, f_over_r, torch.zeros_like(f_over_r))
    energy = 0.5 * torch.sum(u)
    virial = 0.5 * torch.sum(f_over_r * r2_safe)
    forces = torch.stack([torch.sum(f_over_r * dk, dim=1) for dk in d_comps],
                         dim=-1)
    return energy, virial, forces


def reset_launches():
    """Set both kernels' launch counts to 0."""
    nl_build.launches = 0
    nl_forces.launches = 0


reset_launches()
# A captured particle-order step launches both.
counters.register(nl_build, "launches")
counters.register(nl_forces, "launches")


@dataclass(frozen=True)
class NeighborListEngine:
    potential: Any
    cutoff: float = 1.5
    skin: float = 0.3
    grid: Tuple[int, ...] = (3, 3, 3)
    cell_capacity: int = 16
    max_neighbors: int = 48

    @classmethod
    def create(cls, potential, cutoff, skin, unitcell, n_particles,
               cell_capacity=None, max_neighbors=None, max_sigma=1.0):
        """The engine for a box: ``ValueError`` for a tilted box (the
        minimum image uses the box lengths only; ``CellGridEngine`` takes
        tilted boxes) and for a box too small for 3 cells of ``cutoff +
        skin`` on an axis; C and K from :func:`estimate_capacities` unless
        given."""
        if isinstance(unitcell, torch.Tensor):
            unitcell = unitcell.detach().cpu().numpy()
        unitcell = np.asarray(unitcell, np.float64)
        check_engine_cutoff(potential, cutoff, max_sigma)
        if not is_orthorhombic(unitcell):
            raise ValueError(
                "NeighborListEngine is orthorhombic-only; use CellGridEngine "
                "for tilted (triclinic) cells")
        grid = grid_for_box(unitcell, cutoff, skin)
        if grid is None:
            raise ValueError(
                "box too small for a cell grid at this cutoff; use "
                "NaivePairEngine")
        c_est, k_est = estimate_capacities(n_particles, unitcell, cutoff,
                                           skin, grid)
        return cls(potential=potential, cutoff=float(cutoff),
                   skin=float(skin), grid=grid,
                   cell_capacity=int(cell_capacity or c_est),
                   max_neighbors=int(max_neighbors or k_est))

    def with_grown_capacity(self):
        """C -> int(1.5 C + 4), K -> int(1.5 K + 4) rounded up to a
        multiple of 8, as the JAX engine grows (K1 takes C up to the
        bound :func:`build_plan` states)."""
        return dataclasses.replace(
            self, cell_capacity=int(self.cell_capacity * 1.5 + 4),
            max_neighbors=((int(self.max_neighbors * 1.5 + 4) + 7) // 8) * 8)

    @property
    def uses_kernel(self) -> bool:
        """Whether the force pass is K2: the potential has a kernel functor
        (a choice by type)."""
        return kernel_params(self.potential) is not None

    # ------------------------------------------------------------------ build
    def bin(self, positions, cell_inv):
        """``(cid (N,) int64, cell_buf (n_cells, C) int32, counts
        (n_cells,) int64)``: each particle's cell from its fractional
        coordinates (wrapped, clipped into the grid), the particle ids of
        every cell in id order (sentinel N, ranks at or past C dropped),
        and the particles binned per cell."""
        return self.bin_sorted(positions, cell_inv)[:3]

    def bin_sorted(self, positions, cell_inv):
        """:meth:`bin`'s ``(cid, cell_buf, counts)`` and the sort it makes
        on the way (:func:`sort_by_cell`): ``order`` (N,) int32, the
        particles sorted by cell, and ``starts`` (n_cells,) int64."""
        n = positions.shape[0]
        device = positions.device
        n_cells = math.prod(self.grid)
        cap = self.cell_capacity
        frac = _mm(positions, cell_inv.T)
        frac = frac - torch.floor(frac)
        cid = cell_ids([frac[:, k] for k in range(frac.shape[1])], self.grid)
        counts = torch.zeros(n_cells, dtype=torch.int64, device=device)
        counts.scatter_add_(0, cid, torch.ones_like(cid))
        order, starts = sort_by_cell(cid, counts)
        cid_sorted = cid[order]
        rank = torch.arange(n, device=device) - starts[cid_sorted]
        addr = torch.where(rank < cap, cid_sorted * cap + rank,
                           torch.full_like(rank, n_cells * cap))
        buf = torch.full((n_cells * cap + 1,), n, dtype=torch.int32,
                         device=device)
        buf[addr] = order
        return cid, buf[:-1].reshape(n_cells, cap), counts, order, starts

    def allocate(self, positions, diameters, cell, cell_inv):
        cid, cell_buf, counts, order, starts = self.bin_sorted(positions,
                                                               cell_inv)
        idx, count, overflow = nl_build(
            positions.contiguous(), cid, cell_buf, counts,
            torch.diagonal(cell).contiguous(), self.grid,
            self.cutoff + self.skin, self.max_neighbors, order=order,
            starts=starts)
        return NeighborState(idx=idx, ref_positions=positions,
                             overflow=overflow, count=count, order=order)

    # ---------------------------------------------------------------- rebuild
    def needs_rebuild(self, positions, nbrs: NeighborState, cell, cell_inv,
                      out=None, handle=None):
        """Whether a particle moved more than skin/2 since the build (a 0-d
        bool tensor; the displacement minimum-imaged by the box lengths:
        positions are wrapped), written into ``out`` where given: on the
        card one launch of
        :func:`~mdtpu_torch.ops.philox_draws.rebuild_flag_rows`, which also
        sets ``handle``, an IF node's, inside a captured step; on the CPU
        its plain version."""
        return rebuild_flag_rows(positions, nbrs.ref_positions, self.skin,
                                 lengths=torch.diagonal(cell), out=out,
                                 handle=handle)

    # ---------------------------------------------------------------- forces
    def compute(self, positions, diameters, cell, cell_inv,
                nbrs: NeighborState):
        """``(energy, virial, forces, nbrs)``: K2 for a potential with a
        kernel functor, the plain tiles for any other."""
        lengths = torch.diagonal(cell).contiguous()
        args = (positions.contiguous(), diameters.contiguous(), nbrs.idx,
                nbrs.count, lengths, self.cutoff, self.potential)
        if self.uses_kernel:
            energy, virial, forces = nl_forces(*args, order=nbrs.order)
        else:
            energy, virial, forces = nl_forces_plain(*args)
        return energy, virial, forces, nbrs
