"""The sharded slot engine: the whole state in cell-sorted slot order, split
over the ranks of a shard ring by x-slabs of the cell grid.

Counterpart of ``mdtpu/parallel/halo_slot.py``. Cell ids are x-major, so the
global slot range ``[p S, (p + 1) S)`` of ``S = mx * ny [* nz] * C`` slots is
slab ``p``: a global :func:`~mdtpu_torch.integrate.slot_step.slotify` with
the global grid, each rank keeping its block, is the sharded layout. The
single-device slot loop (``make_slot_advance``, ``make_slot_fire``) runs
unchanged on each rank's block, with a ring that turns its global
reductions into all-reduces.

Per step :meth:`HaloSlotEngine.compute_slots` sends the slab's first x-plane
to the left neighbour and its last to the right one (positions, lo words
under hi/lo, diameters and the cells' counts), lays the two planes it
receives out as ghost x-planes 0 and mx + 1 of a local grid ``(mx + 2, ny[,
nz])`` and launches B1 (``csrc/cell_sweep.cu``) over the interior cells
only. From those cells no x-neighbour wraps, so the kernel's wrap and image
shift serve y and z as on one device; a ghost plane that came across the
box's edge (rank 0's left one, rank P-1's right one) is shifted by the cell
vector ``unitcell[:, 0]`` first (under hi/lo through ``two_sum``, the
residual into the lo word). The JAX package instead runs the Newton half
stencil, sends one plane and gets its reactions back; here each pair is seen
from both sides, so the forces of the local slots are complete with no
reactions to return, and energy and virial (half-sums per side) need one
all-reduce, on full steps only.

A potential without a kernel functor takes the pair-list route on the same
extended grid: the list kernel (``csrc/cell_pairs.cu``) over the interior
cells, the user's ``evaluate_r2`` (``force_r2`` on lean steps) in torch on
the list, and the list's reduction; the list's overflow joins the state's
overflow flag, which the driver all-reduces, so every rank grows the engine
(its ``pair_capacity`` too) and reruns alike.

Each rebuild (:meth:`HaloSlotEngine.slot_rebin`) first migrates the rows
whose x-plane left the slab to the neighbouring rank, in fixed-size buffers
of ``migration_capacity`` columns, on the device: a rebuild comes at least
every skin/2 of drift, so a row never goes further than a neighbour.
Overflow of the buffer raises the state's overflow flag (the driver
restores the segment and grows the engine).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, ClassVar, Tuple

import numpy as np
import torch

from mdtpu_torch.core.types import SimulationState
from mdtpu_torch.integrate import slot_step as slots
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.cell_pairs import (PairListWorkspace, list_capacity,
                                        pair_sweep)
from mdtpu_torch.ops.cell_sweep import (cell_sweep, cell_sweep_hilo,
                                        kernel_params)
from mdtpu_torch.parallel.geometry import sharded_geometry
from mdtpu_torch.potentials.base import check_engine_cutoff
from mdtpu_torch.utils.math import kahan_add, two_sum


@dataclass(frozen=True)
class HaloSlotEngine:
    """Slot-layout cell-grid engine over a shard ring (see the module
    docstring). ``grid`` is the global grid, its x axis a multiple of the
    ring's size; a rank's slot tensors are its slab's ``(d, local_slots)``
    block."""

    potential: Any
    cutoff: float = 1.5
    skin: float = 0.3
    grid: Tuple[int, ...] = (8, 3, 3)
    cell_capacity: int = 16
    # Rows migrated per direction per rebuild at most (fixed-size buffers);
    # more raise the overflow flag.
    migration_capacity: int = 512
    # Entries of a slab's pair list (potentials without a kernel functor);
    # 0: room for 8 hits a slot.
    pair_capacity: int = 0
    ring: Any = field(default=None, compare=False, repr=False)
    pair_workspace: Any = field(default_factory=PairListWorkspace,
                                compare=False, repr=False)
    # The rebuild exchanges rows, so every rank rebuilds at the same steps:
    # the slot advance takes the JAX package's schedule for it.
    rebin_unconditional: ClassVar[bool] = True

    @classmethod
    def create(cls, potential, cutoff, unitcell, n_particles, ring,
               min_skin=0.3, cell_capacity=None, diameters=None,
               max_sigma=1.0):
        """The engine for ``ring`` (:class:`mdtpu_torch.parallel.mesh
        .ShardRing`): the geometry of
        :func:`mdtpu_torch.parallel.geometry.sharded_geometry`, a migration
        buffer of a quarter of a slab's particles (at least 128 columns), as
        the JAX package sizes it, and for a potential without a kernel
        functor a pair list with room for a slab's hits
        (:func:`~mdtpu_torch.ops.cell_pairs.list_capacity` of ``n / P``
        particles in ``V / P``)."""
        if isinstance(unitcell, torch.Tensor):
            unitcell = unitcell.detach().cpu().numpy()
        if diameters is not None:
            d = (diameters.detach().cpu().numpy()
                 if isinstance(diameters, torch.Tensor) else diameters)
            max_sigma = max(max_sigma, float(np.max(np.asarray(d))))
        check_engine_cutoff(potential, cutoff, max_sigma)
        grid, cap, skin = sharded_geometry(cutoff, unitcell, n_particles,
                                           ring.size, min_skin, cell_capacity)
        k = max(128, -(-int(n_particles / ring.size * 0.25) // 128) * 128)
        pair_capacity = 0
        if kernel_params(potential) is None:
            volume = abs(float(np.linalg.det(np.asarray(unitcell,
                                                        np.float64))))
            pair_capacity = list_capacity(n_particles / ring.size,
                                          volume / ring.size, float(cutoff),
                                          len(grid))
        return cls(potential=potential, cutoff=float(cutoff), skin=skin,
                   grid=grid, cell_capacity=cap, migration_capacity=k,
                   pair_capacity=pair_capacity, ring=ring)

    def with_grown_capacity(self):
        """1.4 times the cell capacity (plus 4), twice the migration buffer
        and, on the pair-list route, 1.4 times the list's room (plus 1024):
        the three overflows raise the same flag."""
        return dataclasses.replace(
            self, cell_capacity=int(self.cell_capacity * 1.4 + 4),
            migration_capacity=self.migration_capacity * 2,
            pair_capacity=(int(self.pair_capacity * 1.4) + 1024
                           if self.pair_capacity else 0))

    @property
    def uses_pair_list(self) -> bool:
        """Whether the slab's sweep goes through the pair list: the
        potential has no functor in the sweep kernels (a choice by type)."""
        return kernel_params(self.potential) is None

    @property
    def pair_list_capacity(self) -> int:
        """Entries of a slab's pair list."""
        return self.pair_capacity or 8 * self.local_slots

    @property
    def n_shards(self) -> int:
        return self.ring.size

    @property
    def mx(self) -> int:
        """x-planes of a slab."""
        return self.grid[0] // self.n_shards

    @property
    def plane_cells(self) -> int:
        return math.prod(self.grid[1:])

    @property
    def local_cells(self) -> int:
        return self.mx * self.plane_cells

    @property
    def local_slots(self) -> int:
        return self.local_cells * self.cell_capacity

    def as_single_chip(self) -> CellGridEngine:
        """The single-device engine of the same global geometry: the global
        slotify that starts a run, and the sweep the slab launch is held
        to."""
        return CellGridEngine(potential=self.potential, cutoff=self.cutoff,
                              skin=self.skin, grid=self.grid,
                              cell_capacity=self.cell_capacity,
                              pair_capacity=self.pair_capacity
                              * self.n_shards)

    # ------------------------------------------------------------- rebuild
    def _local_cid(self, x_plane, frac_in):
        """Local cell ids from a slab-local x-plane and the other axes'
        in-box fractional coordinates."""
        cid = x_plane.clamp(0, self.mx - 1)
        for k in range(1, len(self.grid)):
            g = self.grid[k]
            cid = cid * g + (frac_in[k] * g).long().clamp(0, g - 1)
        return cid

    def slot_rebin(self, state: SimulationState) -> SimulationState:
        """Migration, then the local packed re-sort of this rank's block.

        Rows whose global x-plane (of their folded position) lies outside
        the slab travel unfolded to the neighbour on that side, the
        periodic-minimal one (rank 0's slab neighbours rank P-1's), in
        buffers of ``migration_capacity`` columns picked in slot order. The
        receiver folds them (compensated add, crossings into ``images``) and
        bins them; the local rows fold as on one device. One packed re-sort
        takes the local rows, then those from the left, then those from the
        right. Rows beyond a buffer's room stay, clamped into the edge
        plane, and raise the overflow flag."""
        ring = self.ring
        dim = state.positions.shape[0]
        nx, mx, n_sh = self.grid[0], self.mx, self.n_shards
        n_cells = self.local_cells
        n_slots = self.local_slots
        k_mig = min(self.migration_capacity, n_slots)
        p = ring.rank
        occ = state.nbrs.occupied
        cell, cell_inv = state.unitcell, state.unitcell_inv

        frac = slots._frac_components(state.positions, cell_inv)
        n_cross = [torch.where(occ, torch.floor(f), torch.zeros_like(f))
                   for f in frac]
        frac_in = [f - n for f, n in zip(frac, n_cross)]
        gx = (frac_in[0] * nx).long().clamp(0, nx - 1)
        ix = gx - p * mx
        if n_sh > 1:
            # The periodic-minimal slab offset, and the fold along x that
            # goes with it for a row that stays.
            above = ix > nx // 2
            below = ix < -(nx - nx // 2)
            ix = torch.where(above, ix - nx, torch.where(below, ix + nx, ix))
            adj = (above.to(n_cross[0].dtype) - below.to(n_cross[0].dtype))
            esc_right = occ & (ix >= mx)
            esc_left = occ & (ix < 0)
        else:
            adj = torch.zeros_like(n_cross[0])
            esc_right = esc_left = torch.zeros_like(occ)

        floats, ints = slots.pack_state_rows(state)
        iota = torch.arange(n_slots, device=occ.device)

        def select(mask):
            # The first k_mig set entries in slot order, on the device.
            rank = torch.cumsum(mask.long(), 0) - 1
            take = mask & (rank < k_mig)
            idx = torch.zeros(k_mig + 1, dtype=torch.long, device=occ.device)
            idx.scatter_(0, torch.where(take, rank, k_mig), iota)
            idx = idx[:k_mig]
            count = mask.sum()
            got = torch.arange(k_mig, device=occ.device) < count
            # Columns past the count read as vacant at the receiver.
            buf = (floats[:, idx], torch.cat([ints[:, idx],
                                              got.long()[None]]))
            return buf, take, count > k_mig

        buf_r, sent_r, lost_r = select(esc_right)
        buf_l, sent_l, lost_l = select(esc_left)
        from_left, from_right = ring.exchange(list(buf_l), list(buf_r))
        e_floats = torch.cat([from_left[0], from_right[0]], dim=1)
        e_ints = torch.cat([from_left[1], from_right[1]], dim=1)

        occ = occ & ~(sent_r | sent_l)
        state = state.replace(nbrs=dataclasses.replace(state.nbrs,
                                                       occupied=occ))

        # Fold the local rows; rows kept past a full buffer fold with the
        # slab offset's correction.
        n_cross[0] = n_cross[0] + torch.where(occ, adj, torch.zeros_like(adj))
        n_cross = [torch.where(occ, n, torch.zeros_like(n)) for n in n_cross]
        delta = torch.stack([
            -sum(cell[k, j] * n_cross[j] for j in range(dim))
            for k in range(dim)])
        positions, pos_comp = kahan_add(state.positions, state.pos_comp,
                                        delta)
        images = state.images + torch.stack(n_cross).to(state.images.dtype)
        state = state.replace(positions=positions, pos_comp=pos_comp,
                              images=images)
        cid = torch.where(occ, self._local_cid(ix, frac_in), n_cells)

        # Fold and bin the received rows.
        e_occ = e_ints[dim + 1] != 0
        e_pos = e_floats[0:dim]
        e_comp = e_floats[3 * dim:4 * dim]
        e_frac = slots._frac_components(e_pos, cell_inv)
        e_cross = [torch.where(e_occ, torch.floor(f), torch.zeros_like(f))
                   for f in e_frac]
        e_frac_in = [f - n for f, n in zip(e_frac, e_cross)]
        e_delta = torch.stack([
            -sum(cell[k, j] * e_cross[j] for j in range(dim))
            for k in range(dim)])
        e_pos, e_comp = kahan_add(e_pos, e_comp, e_delta)
        e_floats = torch.cat([e_pos, e_floats[dim:3 * dim], e_comp,
                              e_floats[4 * dim:]])
        e_ints = torch.cat([e_ints[0:dim] + torch.stack(e_cross).long(),
                            e_ints[dim:dim + 1]])
        e_gx = (e_frac_in[0] * nx).long().clamp(0, nx - 1)
        e_cid = torch.where(e_occ, self._local_cid(e_gx - p * mx, e_frac_in),
                            n_cells)

        state, cap_overflow = slots.packed_resort(
            state, cid, n_cells, self.cell_capacity,
            extra_rows=(e_floats, e_ints), extra_cid=e_cid)
        return state.replace(nbrs=dataclasses.replace(
            state.nbrs, overflow=(state.nbrs.overflow | cap_overflow | lost_r
                                  | lost_l)))

    # --------------------------------------------------------------- sweep
    def slab_inputs(self, positions, diameters, counts, cell, pos_lo=None):
        """The ghost exchange: this rank's first x-plane goes to the left
        neighbour and its last to the right one, and the planes received
        become x-planes 0 and mx + 1 of the ghost-extended grid, shifted by
        the cell vector ``cell[:, 0]`` where they came across the box's edge.
        Returns B1's arguments for the slab, ``(slot_pos, slot_lo or None,
        slot_diam, counts, grid, interior)``: slot tensors of the extended
        grid ``(mx + 2, ny[, nz])`` and the run of its interior cells."""
        ring = self.ring
        dim = positions.shape[0]
        hilo = pos_lo is not None
        plane = self.plane_cells * self.cell_capacity
        n_loc = positions.shape[1]
        parts = [positions] + ([pos_lo] if hilo else []) + [diameters[None]]
        # One (rows, (mx + 2) planes) buffer: the slab in the middle, the
        # ghost planes written beside it; its rows are B1's inputs.
        ext = positions.new_empty((sum(t.shape[0] for t in parts),
                                   n_loc + 2 * plane))
        row = 0
        for t in parts:
            ext[row:row + t.shape[0], plane:plane + n_loc] = t
            row += t.shape[0]
        pc = self.plane_cells
        (g_left, c_left), (g_right, c_right) = ring.exchange(
            [ext[:, plane:2 * plane], counts[:pc]],
            [ext[:, n_loc:n_loc + plane], counts[-pc:]])
        ext[:, :plane] = g_left
        ext[:, n_loc + plane:] = g_right
        shift = cell[:, 0:1]
        if ring.rank == 0:
            _shift_ghost(ext[:, :plane], -shift, dim, hilo)
        if ring.rank == ring.size - 1:
            _shift_ghost(ext[:, n_loc + plane:], shift, dim, hilo)
        return (ext[0:dim], ext[dim:2 * dim] if hilo else None, ext[-1],
                torch.cat([c_left, counts, c_right]),
                (self.mx + 2,) + tuple(self.grid[1:]),
                (self.plane_cells, self.local_cells))

    def compute_slots(self, positions, diameters, cell, cell_inv, nbrs,
                      observables=True, pos_lo=None, out=None,
                      scalars_out=None):
        """``(energy, virial, forces, nbrs)`` of this rank's slab: the ghost
        exchange (:meth:`slab_inputs`) and B1's launch over the interior
        cells of the ghost-extended grid, or for a potential without a
        functor the pair list over them, the potential on the list and the
        list's reduction (its overflow joins ``nbrs.overflow``). Energy and
        virial are summed over the ring on full steps (``observables``);
        lean steps return zeros. ``pos_lo``: the lo words, for the hi/lo
        sweep. ``out``: a tensor the forces go into (B1 and the list's
        reduction write them there on the card); ``scalars_out``: the
        ``(energy, virial)`` 0-d tensors the ring's sums are copied into,
        on a full sweep. ``cell_inv`` is unused; it keeps the single-device
        signature."""
        cell = cell.contiguous()
        pos, lo, diam, counts, grid, interior = self.slab_inputs(
            positions, diameters, nbrs.counts, cell, pos_lo)
        into = {"out": out} if positions.is_cuda else {}
        if self.uses_pair_list:
            energy, virial, forces, over = pair_sweep(
                pos, diam, counts, cell, grid, self.cutoff, self.potential,
                self.pair_list_capacity, observables, lo, interior=interior,
                workspace=self.pair_workspace, out=out)
            nbrs = dataclasses.replace(nbrs, overflow=nbrs.overflow | over)
        elif lo is not None:
            energy, virial, forces = cell_sweep_hilo(
                pos, lo, diam, counts, cell, grid, self.cutoff,
                self.potential, observables, interior=interior, **into)
        else:
            energy, virial, forces = cell_sweep(
                pos, diam, counts, cell, grid, self.cutoff, self.potential,
                observables, interior=interior, **into)
        if observables:
            energy, virial = self.ring.sum_(
                torch.stack([energy, virial])).unbind()
            if scalars_out is not None:
                energy, virial = (d.copy_(t) for d, t in
                                  zip(scalars_out, (energy, virial)))
        if out is not None and forces is not out:
            forces = out.copy_(forces)
        return energy, virial, forces, nbrs


def _shift_ghost(ghost, shift, dim, hilo):
    """Carry a ghost plane's rows (positions, lo words under hi/lo, then the
    diameters), in place, to the image across the box's edge: plus
    ``shift``, the ``(d, 1)`` cell vector; under hi/lo through ``two_sum``,
    its residual into the lo word."""
    if hilo:
        hi, r = two_sum(ghost[0:dim], shift)
        ghost[dim:2 * dim] += r
        ghost[0:dim] = hi
    else:
        ghost[0:dim] += shift


# ---------------------------------------------------------------------------
# The glue: the sharded state, its advance, and the way back.
# ---------------------------------------------------------------------------


def build_sharded_slot_state(state: SimulationState,
                             engine: HaloSlotEngine) -> SimulationState:
    """Global slotify of an ``(N, d)`` particle-order state (the same on
    every rank) with the global geometry, this rank's slot block kept, then
    one sharded sweep for the initial forces, energy and virial.
    ``CapacityOverflowError`` where the initial binning overflows (every
    rank sees the same global binning)."""
    ring = engine.ring
    st = slots.slotify(state, engine.as_single_chip())
    if bool(st.nbrs.overflow):
        raise slots.CapacityOverflowError(
            "initial slotify overflowed cell capacity: grow the engine's "
            "capacity")
    p, s, c = ring.rank, engine.local_slots, engine.local_cells
    block = slice(p * s, (p + 1) * s)

    def mine(t):
        return t[..., block].contiguous()

    nb = st.nbrs
    nbrs = dataclasses.replace(
        nb, counts=nb.counts[p * c:(p + 1) * c].contiguous(),
        sorted_diam=mine(nb.sorted_diam), ref_positions=mine(nb.ref_positions),
        occupied=mine(nb.occupied),
        overflow=torch.zeros((), dtype=torch.bool, device=st.device))
    st = st.replace(
        positions=nbrs.ref_positions, velocities=mine(st.velocities),
        forces=mine(st.forces), images=mine(st.images),
        diameters=nbrs.sorted_diam, pos_comp=mine(st.pos_comp),
        vel_comp=mine(st.vel_comp), ids=mine(st.ids), nbrs=nbrs)
    return slots.slot_forces(st, engine)


def make_sharded_slot_advance(params, ensemble, engine: HaloSlotEngine,
                              compensated: bool = True, lean: bool = True,
                              hilo: bool = False, graph=None):
    """``advance(state, k)`` of a sharded slot state: the single-device
    ``make_slot_advance`` on each rank's block, with the engine's ring
    (:class:`~mdtpu_torch.integrate.slot_step.ShardedSlotAdvance`):
    rebuilds (with their migration) on the JAX package's schedule, every
    decision the ring's, Bussi and temperature reductions summed over the
    ring. ``graph`` as in ``make_slot_advance``: on the card each segment
    variant is one CUDA graph launch, the ring's all-reduces captured
    inside."""
    return slots.make_slot_advance(params, ensemble, engine,
                                   compensated=compensated, lean=lean,
                                   hilo=hilo, ring=engine.ring, graph=graph)


_SLOT_FIELDS = ("positions", "velocities", "forces", "images", "diameters",
                "pos_comp", "vel_comp", "ids")


def unshard_slot_state(state: SimulationState, ring) -> SimulationState:
    """The ``(N, d)`` particle-order state (rows sorted by ``ids``) on every
    rank: each slot tensor's blocks put end to end (rank order is slot
    order, the blocks being x-slabs), then the single-device
    ``unslotify_state``."""
    changes = {name: ring.gather_blocks(getattr(state, name))
               for name in _SLOT_FIELDS}
    nbrs = dataclasses.replace(
        state.nbrs, occupied=ring.gather_blocks(state.nbrs.occupied))
    return slots.unslotify_state(state.replace(nbrs=nbrs, **changes))
