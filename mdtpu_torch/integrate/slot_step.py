"""Slot-space loop: the whole simulation state in cell-sorted slot order,
component-major.

Counterpart of ``mdtpu/integrate/slot_step.py``. The particle-order step
scatters the positions into the cell grid's slots, runs the pair sweep and
gathers the forces back, every step. Here positions, velocities, forces and
the rest stay in slot order for the whole run, so a step runs the B1 kernel
(:meth:`CellGridEngine.compute_slots`) on them as they are, and the
integrator works on ``(d, n_slots)`` rows, vacant slots included (d = 2 or
3; the box may be tilted).

Layout contract:
  * per-particle tensors are ``(d, n_slots)`` (diameters ``(n_slots,)``,
    ``ids`` int64 ``(n_slots,)``), ``n_slots = n_cells * C``, in cell-sorted
    order; the occupied slots of cell ``c`` are ``c*C .. c*C + counts[c] -
    1``, contiguous from the cell's first slot, because the kernel stops at
    ``counts[c]``;
  * vacant slots hold zero positions, velocities, forces and compensations,
    unit diameters and id -1. Their positions never move, so
    ``ref_positions == positions`` there and the drift test and the
    non-finite check stay exact. (The JAX package fills them with a far-pad
    coordinate ramp so that its mask-free sweep never pairs them; the kernel
    here never reads past a cell's count, so it needs none.);
  * ``state.nbrs.occupied`` marks the real slots; ``state.nf`` still holds
    the true degrees of freedom, so temperature and thermostat are unchanged;
  * the periodic wrap is deferred to rebuild time: between rebuilds positions
    drift unwrapped (at most skin/2), which is the kernel's contract (every
    slot within skin/2 of its home cell, so the image shift of a wrapped
    neighbour cell, the cell vectors of its wrap, gives true
    displacements). A rebuild folds the occupied
    rows through the compensated add and adds the crossings to ``images``;
    outputs fold the rest on the host;
  * when a particle drifts past skin/2 the loop re-bins: a stable sort of the
    cell keys, per-cell run starts by binary search, and one gather of all
    float rows and one of the integer rows (:func:`packed_resort`).
    :func:`make_slot_advance` checks for a rebuild once a step, on the
    device (:class:`SlotAdvance`: on the card a conditional node of the
    step's CUDA graph).

Slot order within a cell follows the previous slot order (the sort is
stable), so a run repeats bit for bit; parity with the JAX package is held
in particle order through ``ids``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mdtpu_torch.core.box import _mm
from mdtpu_torch.core.types import NVE, NVT, Brownian, Parameters, SimulationState
from mdtpu_torch.integrate import verlet_update
from mdtpu_torch.integrate.device_advance import (STATE_TENSORS,
                                                  DeviceAdvance, clone,
                                                  copy_into)
from mdtpu_torch.integrate.device_advance import device_if  # noqa: F401
from mdtpu_torch.integrate.step import finish_scalars
from mdtpu_torch.integrate.velocity_finish import finish_pair
from mdtpu_torch.ops import philox_draws
from mdtpu_torch.ops.cell_grid import CellGridEngine, CellGridState, cell_ids
from mdtpu_torch.utils import counters
from mdtpu_torch.utils.math import kahan_add


MAX_GROWS = 8


class CapacityOverflowError(ValueError):
    """The initial binning still overflows the engine's cell capacity after
    :data:`MAX_GROWS` grows (:func:`slotify_grown`)."""


def _frac_components(x, cell_inv):
    dim = x.shape[0]
    return [sum(cell_inv[k, j] * x[j] for j in range(dim))
            for k in range(dim)]


def _fold_into_box(state: SimulationState) -> SimulationState:
    """Particle-order positions outside the box folded in (through the
    compensated add, crossings into ``images``): the slot layout bins and
    sweeps a position as it is, so it must lie in its home cell. The
    driver's own states always do; this reads one flag on the host."""
    n = torch.floor(_mm(state.positions, state.unitcell_inv.T))
    if not bool(torch.any(n != 0)):
        return state
    x, comp = kahan_add(state.positions, state.pos_comp,
                        -_mm(n, state.unitcell.T))
    moved = n != 0
    return state.replace(
        positions=torch.where(moved, x, state.positions),
        pos_comp=torch.where(moved, comp, state.pos_comp),
        images=state.images + n.to(state.images.dtype))


def slotify(state: SimulationState, engine: CellGridEngine) -> SimulationState:
    """Convert an ``(N, d)`` particle-order state into slot order."""
    state = _fold_into_box(state)
    n = state.positions.shape[0]
    n_slots = engine.n_cells * engine.cell_capacity
    nbrs = engine.allocate(state.positions, state.diameters, state.unitcell,
                           state.unitcell_inv)
    addr = nbrs.addr  # (N,) slot, or the trash slot n_slots on overflow

    def put(a, fill=0):
        out = a.new_full((a.shape[1], n_slots + 1), fill)
        out[:, addr] = a.T
        return out[:, :n_slots].contiguous()

    def put1(a, fill):
        out = a.new_full((n_slots + 1,), fill)
        out[addr] = a
        return out[:n_slots].contiguous()

    positions = put(state.positions)
    diameters = put1(state.diameters, 1)
    occupied = put1(torch.ones_like(addr, dtype=torch.bool), False)
    slot_nbrs = CellGridState(addr=None, counts=nbrs.counts,
                              sorted_diam=diameters, ref_positions=positions,
                              overflow=nbrs.overflow, occupied=occupied)
    return state.replace(
        positions=positions,
        velocities=put(state.velocities),
        forces=put(state.forces),
        images=put(state.images),
        diameters=diameters,
        pos_comp=put(state.pos_comp),
        vel_comp=put(state.vel_comp),
        ids=put1(torch.arange(n, device=addr.device), -1),
        nbrs=slot_nbrs)


def slotify_grown(state: SimulationState, engine: CellGridEngine):
    """:func:`slotify`, growing the engine's capacity until the initial
    binning fits: an overflowing binning drops particles to the trash slot.
    Returns ``(slot_state, engine)``."""
    for _ in range(MAX_GROWS + 1):
        slots = slotify(state, engine)
        if not bool(slots.nbrs.overflow):
            return slots, engine
        engine = engine.with_grown_capacity()
    raise CapacityOverflowError(
        f"cell capacity still overflowing after {MAX_GROWS} grows")


def _sweep_in(engine, x, diameters, cell, cell_inv, nbrs, observables,
              force_dtype=None, pos_lo=None, out=None, scalars_out=None):
    """``engine.compute_slots`` with the sweep's inputs cast to
    ``force_dtype`` (up or down) where it differs from the positions', and
    the forces (into ``out`` where given) and, on a full sweep, energy and
    virial (into ``scalars_out`` where given) cast back."""
    dtype = x.dtype
    into = {} if scalars_out is None else {"scalars_out": scalars_out}
    if force_dtype is None or force_dtype == dtype:
        return engine.compute_slots(x, diameters, cell, cell_inv, nbrs,
                                    observables, pos_lo, out=out, **into)
    e, w, f, nbrs = engine.compute_slots(
        x.to(force_dtype), diameters.to(force_dtype), cell.to(force_dtype),
        cell_inv.to(force_dtype), nbrs, observables)
    f = f.to(dtype) if out is None else out.copy_(f)
    if observables:
        e, w = ((e.to(dtype), w.to(dtype)) if scalars_out is None else
                (d.copy_(t) for d, t in zip(scalars_out, (e, w))))
    return e, w, f, nbrs


def slot_forces(state: SimulationState, engine: CellGridEngine,
                observables=True, force_dtype=None) -> SimulationState:
    """Forces (and energy and virial) of a slot-layout state, at its
    positions; ``force_dtype`` as in :func:`make_slot_step`."""
    e, w, f, nbrs = _sweep_in(engine, state.positions, state.diameters,
                              state.unitcell, state.unitcell_inv, state.nbrs,
                              observables, force_dtype)
    if not observables:
        e, w = state.energy, state.virial
    return state.replace(forces=f, energy=e, virial=w, nbrs=nbrs)


def _host_wrap(pos, images, cell):
    """Fold ``(N, d)`` positions into the box, adding the crossings to
    ``images`` (numpy, float64 arithmetic, as the JAX package does): deferred
    wrap leaves up to skin/2 of unwrapped drift between rebuilds, which
    outputs and returned states fold here."""
    cell64 = np.asarray(cell, np.float64)
    frac = np.asarray(pos, np.float64) @ np.linalg.inv(cell64).T
    n = np.floor(frac)
    pos = (np.asarray(pos, np.float64) - n @ cell64.T).astype(
        np.asarray(pos).dtype)
    return pos, np.asarray(images) + n.astype(np.asarray(images).dtype)


def _numpy(t):
    return t.detach().cpu().numpy()


def unslotify_arrays(state: SimulationState):
    """``(positions, velocities, diameters, images)`` of the real slots as
    numpy ``(N, d)`` arrays, in the current slot order (not particle order),
    positions folded into the box."""
    occ = _numpy(state.nbrs.occupied)
    pos = _numpy(state.positions).T[occ]
    vel = _numpy(state.velocities).T[occ]
    diam = _numpy(state.diameters)[occ]
    images = _numpy(state.images).T[occ]
    pos, images = _host_wrap(pos, images, _numpy(state.unitcell))
    return pos, vel, diam, images


def unslotify_state(state: SimulationState) -> SimulationState:
    """The slot-layout state back in ``(N, d)`` particle order, rows sorted
    by ``ids``, positions folded into the box on the host (``pos_comp``
    keeps its role of an approximate low word). ``ids`` and ``nbrs`` are
    dropped."""
    occ = _numpy(state.nbrs.occupied)
    order = np.argsort(_numpy(state.ids)[occ], kind="stable")
    device = state.device

    def take2(a):
        return _numpy(a).T[occ][order]

    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    pos, images = _host_wrap(take2(state.positions), take2(state.images),
                             _numpy(state.unitcell))
    return state.replace(
        positions=tensor(pos),
        velocities=tensor(take2(state.velocities)),
        forces=tensor(take2(state.forces)),
        images=tensor(images),
        pos_comp=tensor(take2(state.pos_comp)),
        vel_comp=tensor(take2(state.vel_comp)),
        diameters=tensor(_numpy(state.diameters)[occ][order]),
        ids=None,
        nbrs=None)


def fold_wrap(state: SimulationState):
    """Deferred-wrap fold: every occupied position into the box through the
    compensated add, crossings into ``images``. Returns the state and the
    in-box fractional components, the rebin's binning input."""
    dim = state.positions.shape[0]
    occ = state.nbrs.occupied
    frac = _frac_components(state.positions, state.unitcell_inv)
    n_cross = [torch.where(occ, torch.floor(f), torch.zeros_like(f))
               for f in frac]
    delta = torch.stack([
        -sum(state.unitcell[k, j] * n_cross[j] for j in range(dim))
        for k in range(dim)])
    positions, pos_comp = kahan_add(state.positions, state.pos_comp, delta)
    images = state.images + torch.stack(n_cross).to(state.images.dtype)
    state = state.replace(positions=positions, pos_comp=pos_comp,
                          images=images)
    return state, [f - n for f, n in zip(frac, n_cross)]


def pack_state_rows(state: SimulationState):
    """The per-slot rows a resort moves, as two tensors: the float rows
    (positions, velocities, forces, pos_comp, vel_comp, diameters:
    ``(5d + 1, n_slots)``) and the integer rows (images, ids: ``(d + 1,
    n_slots)`` int64). Ids stay integers, so no split into exact float rows
    is needed."""
    floats = torch.cat([state.positions, state.velocities, state.forces,
                        state.pos_comp, state.vel_comp, state.diameters[None]])
    ints = torch.cat([state.images, state.ids[None]])
    return floats, ints


def unpack_state_rows(state: SimulationState, floats, ints, occupied,
                      counts) -> SimulationState:
    """Inverse of :func:`pack_state_rows` on resorted rows, with the new
    occupancy and per-cell counts."""
    d = state.positions.shape[0]
    positions, diameters = floats[0:d], floats[5 * d]
    nbrs = dataclasses.replace(state.nbrs, counts=counts, occupied=occupied,
                               sorted_diam=diameters,
                               ref_positions=positions)
    return state.replace(
        positions=positions, velocities=floats[d:2 * d],
        forces=floats[2 * d:3 * d], pos_comp=floats[3 * d:4 * d],
        vel_comp=floats[4 * d:5 * d], diameters=diameters,
        images=ints[0:d], ids=ints[d], nbrs=nbrs)


def packed_resort(state: SimulationState, cid, n_cells: int, cap: int,
                  extra_rows=None, extra_cid=None):
    """Re-sort all slot rows by target cell ``cid`` (``n_cells`` for vacant
    rows): a stable sort of the keys carrying the source index, per-cell run
    starts by binary search, then slot ``c*cap + k`` takes source row
    ``order[starts[c] + k]`` for ``k < counts[c]``. Vacant slots read an
    appended fill column (zeros, diameter 1, id -1). Every cell's occupied
    slots are contiguous from its first, and ``counts`` comes from the run
    starts. ``extra_rows``: more rows, ``(floats, ints)`` as
    :func:`pack_state_rows` packs them (the migration buffers a shard
    received), sorted in after the state's own with their cells
    ``extra_cid``. Returns ``(state, overflow)``: overflow is a cell whose
    run is longer than ``cap`` (its rows past ``cap`` are dropped)."""
    floats, ints = pack_state_rows(state)
    if extra_rows is not None:
        floats = torch.cat([floats, extra_rows[0]], dim=1)
        ints = torch.cat([ints, extra_rows[1]], dim=1)
        cid = torch.cat([cid, extra_cid])
    m = floats.shape[1]
    device = cid.device
    cid_sorted, order = torch.sort(cid, stable=True)
    starts = torch.searchsorted(
        cid_sorted, torch.arange(n_cells + 1, device=device,
                                 dtype=cid.dtype))
    counts = starts[1:] - starts[:-1]
    overflow = torch.any(counts > cap)
    idx = starts[:-1, None] + torch.arange(cap, device=device)[None, :]
    valid = (idx < starts[1:, None]).reshape(-1)
    src = torch.where(valid, order[idx.reshape(-1).clamp(max=m - 1)], m)

    d = state.positions.shape[0]
    fill_f = floats.new_zeros((5 * d + 1, 1))
    fill_f[5 * d] = 1.0
    fill_i = ints.new_zeros((d + 1, 1))
    fill_i[d] = -1
    floats = torch.cat([floats, fill_f], dim=1)[:, src]
    ints = torch.cat([ints, fill_i], dim=1)[:, src]
    return unpack_state_rows(state, floats, ints, valid, counts), overflow


def _rebin(state: SimulationState, engine: CellGridEngine) -> SimulationState:
    """The rebuild: deferred-wrap fold, cell binning of the folded
    fractional coordinates (a coordinate that rounds to the box edge bins
    into the last cell), :func:`packed_resort`. The overflow flag is sticky."""
    cap = engine.cell_capacity
    n_cells = engine.n_cells
    state, frac = fold_wrap(state)
    cid = torch.where(state.nbrs.occupied, cell_ids(frac, engine.grid),
                      n_cells)
    state, overflow = packed_resort(state, cid, n_cells, cap)
    return state.replace(nbrs=dataclasses.replace(
        state.nbrs, overflow=state.nbrs.overflow | overflow))


def slot_needs_rebin(state: SimulationState, engine: CellGridEngine):
    """True (a 0-d bool tensor) when a particle drifted past skin/2 from its
    binning reference. Deferred wrap makes it a plain Cartesian distance.
    On the card one kernel pass (:func:`philox_draws.rebuild_flag`)."""
    return philox_draws.rebuild_flag(state.positions,
                                     state.nbrs.ref_positions, engine.skin)


def _engine_rebin(state, engine):
    """The rebuild: an engine's own ``slot_rebin`` where it has one (the
    sharded :class:`mdtpu_torch.parallel.HaloSlotEngine`, which migrates
    rows between ranks first), else :func:`_rebin`."""
    fn = getattr(engine, "slot_rebin", None)
    return fn(state) if fn is not None else _rebin(state, engine)


def make_slot_step(params: Parameters, ensemble, engine: CellGridEngine,
                   compensated: bool = True, observables: bool = True,
                   hilo: bool = False, force_dtype=None, ring=None,
                   in_place: bool = False):
    """One fused step over a slot-layout state (see the module docstring).

    The step never rebins: :func:`make_slot_advance` decides when to, so
    the state must lie within skin/2 of its binning. ``observables=False``: a
    lean step, whose sweep computes forces only (the same bits) and which
    carries the last energy and virial. Brownian steps always observe (the
    virial is sampled every 10 steps). ``hilo``: the hi/lo sweep on
    ``(positions, -pos_comp)``; needs ``compensated``. ``force_dtype``: the
    pair sweep runs in this dtype (up or down: positions, diameters and cell
    cast for it, energy, virial and forces cast back) while the state keeps
    its own; not with ``hilo``. ``ring``: the shard ring of a sharded
    state (:class:`mdtpu_torch.parallel.HaloSlotEngine`, whose sweep does
    its own exchange): the kinetic energy is summed over it, and each rank
    draws Brownian noise of its own. Each call adds one to
    ``make_slot_step.steps``.

    An MD step runs its velocity-Verlet chain through
    :mod:`mdtpu_torch.integrate.verlet_update`: on the card three launches
    of one kernel (kick-drift, kick, and NVT's rescale) around the sweep
    and the velocity finish, on the CPU their plain versions, the torch
    composition. A Brownian step runs the sweep and
    :func:`~mdtpu_torch.integrate.verlet_update.brownian_update`: on the
    card one launch that draws the noise and moves the positions, on the
    CPU its plain version. ``in_place``: the step writes its results into
    the state's own tensors (the slot advance's buffers: positions,
    velocities, compensations, forces, a full sweep's energy and virial,
    the Brownian accumulators, the step counter, and the temperature,
    which must be a
    :func:`~mdtpu_torch.integrate.velocity_finish.finish_buffer`) and
    returns a state of the same tensors; else it returns new tensors and
    leaves the state as it was.

    ``step(state, ktemp=None)``: ``state.step`` is a host int or a 0-d
    int64 device tensor (the advance's counter), which the step draws from
    and returns plus one; ``ktemp`` is NVT's target for this step as a 0-d
    tensor (None: evaluated on the host from an int step)."""
    is_brownian = isinstance(ensemble, Brownian)
    if not is_brownian and not isinstance(ensemble, (NVT, NVE)):
        raise TypeError(f"unknown ensemble type: {type(ensemble).__name__}")
    obs = True if is_brownian else observables
    noise_rank = None if ring is None else ring.rank
    if hilo and (force_dtype is not None or not compensated):
        raise ValueError("the hi/lo pair sweep needs compensated=True (the "
                         "Kahan compensation is its low word) and no "
                         "force_dtype (it is the precision mechanism)")

    def sweep(x, lo, state):
        """The sweep at ``x`` (``lo``: the hi/lo sweep's low words), into
        the state's forces, energy and virial where ``in_place`` (a full
        sweep's scalars; a lean one's are the state's own)."""
        energy, virial, forces, nbrs = _sweep_in(
            engine, x, state.diameters, state.unitcell, state.unitcell_inv,
            state.nbrs, obs, force_dtype, lo,
            out=state.forces if in_place else None,
            scalars_out=(state.energy, state.virial) if in_place and obs
            else None)
        if not obs:
            energy, virial = state.energy, state.virial
        return energy, virial, forces, nbrs

    def brownian(state, ktemp=None):
        drift, sigma, ktemp = verlet_update.brownian_coefficients(
            params.dt, ensemble.ktemp, state.dtype)
        energy, virial, forces, nbrs = sweep(
            state.positions, -state.pos_comp if hilo else None, state)
        # Deferred wrap: positions drift unwrapped until the next rebin.
        x, xc, step, virial_accum, nprom, temperature = \
            verlet_update.brownian_update(forces, virial, state, drift, sigma,
                                          ktemp, compensated, noise_rank,
                                          in_place)
        return state.replace(
            positions=x, forces=forces, step=step, energy=energy,
            virial=virial, temperature=temperature, pos_comp=xc, nbrs=nbrs,
            virial_accum=virial_accum, nprom=nprom)

    def md(state, ktemp):
        dt = float(params.dt)
        half = 0.5 * dt
        nvt = isinstance(ensemble, NVT)
        # Deferred wrap: positions drift unwrapped until the next rebin.
        lo = torch.empty_like(state.pos_comp) if hilo else None
        v, vc, x, xc = verlet_update.kick_drift(
            state.forces, state.velocities, state.vel_comp, state.positions,
            state.pos_comp, half, dt, compensated, lo=lo,
            out=(state.velocities, state.vel_comp, state.positions,
                 state.pos_comp) if in_place else None)
        energy, virial, forces, nbrs = sweep(x, lo, state)
        # The chain's last launch advances a device counter: the velocity
        # finish between the kick and the rescale reads this step's.
        step, counter = state.step, ()
        if isinstance(step, torch.Tensor):
            counter = (step, step if in_place else torch.empty_like(step))
            step = counter[1]
        else:
            step = step + 1
        verlet_update.kick(forces, v, vc, half, compensated,
                           *(() if nvt else counter))
        # Vacant slots hold zero velocity, so the kinetic sum is exact.
        scale, temperature = finish_scalars(
            ensemble, v, state, dt, ring, ktemp,
            out=finish_pair(state.temperature) if in_place else None)
        if in_place:
            temperature = state.temperature
        if nvt:
            verlet_update.rescale(v, vc, scale, compensated, *counter)
        return state.replace(
            positions=x, velocities=v, forces=forces, step=step,
            energy=energy, virial=virial, temperature=temperature,
            pos_comp=xc, vel_comp=vc, nbrs=nbrs)

    advance_one = brownian if is_brownian else md

    def step(state: SimulationState, ktemp=None) -> SimulationState:
        make_slot_step.steps += 1
        return advance_one(state, ktemp)

    return step


make_slot_step.steps = 0
counters.register(make_slot_step, "steps")




# The tensors of a slot state and of its binning that a step or a rebuild
# may replace: the advance's buffers hold one copy of each.
_STATE_TENSORS = STATE_TENSORS
_NBRS_TENSORS = ("counts", "sorted_diam", "ref_positions", "overflow",
                 "occupied")


class SlotAdvance(DeviceAdvance):
    """``advance(state, k) -> state`` after ``k`` slot steps on one device,
    as the JAX package's ``make_slot_advance`` runs a segment: the step
    counter, the rebuild decision and every draw stay on the device
    (:class:`~mdtpu_torch.integrate.device_advance.DeviceAdvance`).

    Each step reads the buffers and writes its results back in place (an
    MD step's Verlet chain, sweep and velocity finish, and a Brownian
    step's sweep and update, write straight into them, ``make_slot_step(...,
    in_place=True)``, so a step copies nothing): the drift test
    (:func:`philox_draws.rebuild_flag`) and a rebuild where it is set
    (:func:`device_if` around :func:`_engine_rebin`), then the step (NVT's
    target from the device table, read at the counter by the velocity
    finish's kernel).

    ``graph``: on the card each step variant (lean, and the segment's full
    last step) is captured once into a CUDA graph; ``census[name]`` holds
    each variant's nodes. Eagerly the same code runs step by step, the flag
    read on the host."""

    def __init__(self, step, last_step, engine, ensemble, lean, graph):
        super().__init__(engine, ensemble, graph)
        self.step_fn, self.last_fn = step, last_step
        self.lean = lean

    def _test(self, b, flag, handle):
        philox_draws.rebuild_flag(b.positions, b.nbrs.ref_positions,
                                  self.engine.skin, out=flag, handle=handle)

    def _rebuilt(self, b):
        return _engine_rebin(b, self.engine)

    def _step(self, b, step_fn, refresh):
        refresh()
        copy_into(b, step_fn(b, self._target()))

    def __call__(self, state: SimulationState, k: int) -> SimulationState:
        if k <= 0:
            return state
        self._resolve_graph(state)
        base = state.step
        self._load(state)
        self._fill_table(base, k)
        b = self.bufs
        if self.lean:
            self._run("lean", self.step_fn, k - 1)
            self._run("last", self.last_fn, 1)
        else:
            self._run("full", self.last_fn, k)
        return clone(b, base + k)


class ShardedSlotAdvance(SlotAdvance):
    """:class:`SlotAdvance` over a shard ring (the engine a
    :class:`mdtpu_torch.parallel.HaloSlotEngine`, whose rebuild migrates
    rows between ranks), as the JAX package runs ``make_slot_advance``
    under one ``shard_map``: a rebuild (with its migration) at the
    segment's start, after every lean step that any rank flagged, and
    before the segment's full last step.

    Each lean step's test is the drift test's flag, the ring's all-reduced
    maximum of it (``ShardRing.max_``) and :func:`philox_draws.
    rebuild_vote`, which sets the rebuild's flag (and under capture the IF
    node's handle) from the vote or the segment's first step; the full last
    step rebuilds without a test. Only the ring's values decide a branch,
    so every rank replays the same collectives in the same order. On the
    card each segment variant is one graph launch, the ring's all-reduces
    captured in the WHILE node's body; eagerly one host read a lean
    step."""

    def __init__(self, step, last_step, engine, ensemble, lean, graph):
        super().__init__(step, last_step, engine, ensemble, lean, graph)
        self.ring = engine.ring
        self.votes = None

    def _load(self, state):
        super()._load(state)
        if self.votes is None or self.votes.device != state.device:
            self.votes = torch.zeros((), dtype=torch.int32,
                                     device=state.device)

    def _test(self, b, flag, handle):
        philox_draws.rebuild_flag(b.positions, b.nbrs.ref_positions,
                                  self.engine.skin, out=flag)
        self.votes.copy_(flag)
        self.ring.max_(self.votes)
        philox_draws.rebuild_vote(self.votes, b.step, self.base, flag,
                                  handle)

    def _one(self, step_fn):
        if self.lean and step_fn is self.last_fn:
            self._step(self.bufs, step_fn, self._rebuild)
        else:
            super()._one(step_fn)


def make_slot_advance(params: Parameters, ensemble, engine: CellGridEngine,
                      compensated: bool = True, lean: bool = True,
                      hilo: bool = False, force_dtype=None, ring=None,
                      graph=None):
    """``advance(state, k) -> state`` after ``k`` slot steps.

    The rebuild happens at the start of exactly the steps whose state has
    drifted past skin/2, as a check before every step would have it. With
    ``lean`` all but the last step are lean (forces only, the same bits)
    and the last is full, so energy and virial are fresh at every segment
    boundary. ``hilo`` and ``force_dtype`` as in :func:`make_slot_step`.

    On one device this is a :class:`SlotAdvance`: the step counter, NVT's
    target temperature, every draw and the rebuild decision on the device.
    ``graph``: None captures the steps into CUDA graphs on the card (one
    graph launch a segment variant, no host read inside a segment), a
    potential without a kernel functor too (the pair list's route, the
    user's ``evaluate_r2`` captured in the WHILE node's body under the
    capture contract of :mod:`mdtpu_torch.potentials.base`), and runs them
    eagerly on the CPU; False runs eagerly on the card too (the flag read on
    the host once a step); True asks for the graphs (raises on the CPU).

    An engine whose rebuild moves rows between ranks
    (``rebin_unconditional``, the sharded
    :class:`mdtpu_torch.parallel.HaloSlotEngine`) takes the JAX package's
    schedule for it (:class:`ShardedSlotAdvance`), so the slot order and
    sums follow the reference's. ``ring``: the shard ring
    (:func:`make_slot_step`)."""
    step = make_slot_step(params, ensemble, engine, compensated=compensated,
                          observables=not lean, hilo=hilo,
                          force_dtype=force_dtype, ring=ring, in_place=True)
    last_step = make_slot_step(params, ensemble, engine,
                               compensated=compensated, hilo=hilo,
                               force_dtype=force_dtype, ring=ring,
                               in_place=True)
    sharded = getattr(engine, "rebin_unconditional", False)
    return (ShardedSlotAdvance if sharded else SlotAdvance)(
        step, last_step, engine, ensemble, lean, graph)
