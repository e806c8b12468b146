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
    :func:`make_slot_advance` checks for a rebuild once a step, with one
    host read.

Slot order within a cell follows the previous slot order (the sort is
stable), so a run repeats bit for bit; parity with the JAX package is held
in particle order through ``ids``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mdtpu_torch.core.box import _mm
from mdtpu_torch.core.types import NVE, NVT, Brownian, Parameters, SimulationState
from mdtpu_torch.integrate import step as _step
from mdtpu_torch.integrate.step import (_add, brownian_virial_sample,
                                        md_velocity_finish)
from mdtpu_torch.ops.cell_grid import CellGridEngine, CellGridState, cell_ids
from mdtpu_torch.potentials.base import rounded
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
              force_dtype=None, pos_lo=None):
    """``engine.compute_slots`` with the sweep's inputs cast to
    ``force_dtype`` (up or down) where it differs from the positions', and
    the energy, virial and forces cast back."""
    dtype = x.dtype
    if force_dtype is None or force_dtype == dtype:
        return engine.compute_slots(x, diameters, cell, cell_inv, nbrs,
                                    observables, pos_lo)
    e, w, f, nbrs = engine.compute_slots(
        x.to(force_dtype), diameters.to(force_dtype), cell.to(force_dtype),
        cell_inv.to(force_dtype), nbrs, observables)
    return e.to(dtype), w.to(dtype), f.to(dtype), nbrs


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
    binning reference. Deferred wrap makes it a plain Cartesian distance."""
    d = state.positions - state.nbrs.ref_positions
    d = d * d
    d2 = d[0]
    for dk in d[1:]:
        d2 = d2 + dk
    half_skin = 0.5 * engine.skin
    return torch.any(d2 > half_skin * half_skin)


def _engine_rebin(state, engine):
    """The rebuild: an engine's own ``slot_rebin`` where it has one (the
    sharded :class:`mdtpu_torch.parallel.HaloSlotEngine`, which migrates
    rows between ranks first), else :func:`_rebin`."""
    fn = getattr(engine, "slot_rebin", None)
    return fn(state) if fn is not None else _rebin(state, engine)


def _engine_needs_rebin(state, engine, ring=None):
    """:func:`slot_needs_rebin`, on a shard ring true where any rank's is:
    every rank then takes the same branch."""
    local = slot_needs_rebin(state, engine)
    return local if ring is None else ring.any(local)


def make_slot_step(params: Parameters, ensemble, engine: CellGridEngine,
                   compensated: bool = True, observables: bool = True,
                   hilo: bool = False, force_dtype=None, ring=None):
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
    ``make_slot_step.steps``."""
    is_brownian = isinstance(ensemble, Brownian)
    if not is_brownian and not isinstance(ensemble, (NVT, NVE)):
        raise TypeError(f"unknown ensemble type: {type(ensemble).__name__}")
    obs = True if is_brownian else observables
    noise_rank = () if ring is None else (ring.rank,)
    if hilo and (force_dtype is not None or not compensated):
        raise ValueError("the hi/lo pair sweep needs compensated=True (the "
                         "Kahan compensation is its low word) and no "
                         "force_dtype (it is the precision mechanism)")

    def sweep(x, xc, state):
        return _sweep_in(engine, x, state.diameters, state.unitcell,
                         state.unitcell_inv, state.nbrs, obs, force_dtype,
                         -xc if hilo else None)

    def brownian(state):
        dtype = state.dtype
        dt = rounded(params.dt, dtype)
        ktemp = rounded(ensemble.ktemp, dtype)
        drift = rounded(dt / ktemp, dtype)
        sigma = rounded(math.sqrt(rounded(2.0 * dt, dtype)), dtype)
        energy, virial, forces, nbrs = sweep(state.positions, state.pos_comp,
                                             state)
        noise = torch.where(
            state.nbrs.occupied[None, :],
            _step.brownian_noise(state.seed, state.step,
                                 state.positions.shape, dtype, state.device,
                                 *noise_rank),
            0.0)
        # Deferred wrap: positions drift unwrapped until the next rebin.
        x, xc = _add(state.positions, state.pos_comp,
                     forces * drift + noise * sigma, compensated)
        virial_accum, nprom = brownian_virial_sample(state, virial)
        return state.replace(
            positions=x, forces=forces, step=state.step + 1, energy=energy,
            virial=virial,
            temperature=torch.full((), ktemp, dtype=dtype,
                                   device=state.device),
            pos_comp=xc, nbrs=nbrs, virial_accum=virial_accum, nprom=nprom)

    def md(state):
        dt = float(params.dt)
        half = 0.5 * dt
        v, vc = _add(state.velocities, state.vel_comp, state.forces * half,
                     compensated)
        # Deferred wrap: positions drift unwrapped until the next rebin.
        x, xc = _add(state.positions, state.pos_comp, v * dt, compensated)
        energy, virial, forces, nbrs = sweep(x, xc, state)
        if not obs:
            energy, virial = state.energy, state.virial
        v, vc = _add(v, vc, forces * half, compensated)
        # Vacant slots hold zero velocity, so the kinetic sum is exact.
        v, vc, temperature = md_velocity_finish(ensemble, v, vc, state, dt,
                                                compensated, ring)
        return state.replace(
            positions=x, velocities=v, forces=forces, step=state.step + 1,
            energy=energy, virial=virial, temperature=temperature,
            pos_comp=xc, vel_comp=vc, nbrs=nbrs)

    advance_one = brownian if is_brownian else md

    def step(state: SimulationState) -> SimulationState:
        make_slot_step.steps += 1
        return advance_one(state)

    return step


make_slot_step.steps = 0


def make_slot_advance(params: Parameters, ensemble, engine: CellGridEngine,
                      compensated: bool = True, lean: bool = True,
                      hilo: bool = False, force_dtype=None, ring=None):
    """``advance(state, k) -> state`` after ``k`` slot steps.

    The rebuild happens at the start of exactly the steps whose state has
    drifted past skin/2, as a check before every step would have it. With
    ``lean`` all but the last step are lean (forces only, the same bits)
    and the last is full, so energy and virial are fresh at every segment
    boundary. The rebuild decision is one host read a step: it is read
    after each step and carried to the next, plus one read at the start of
    the segment. ``hilo`` and ``force_dtype`` as in
    :func:`make_slot_step`.

    An engine whose rebuild moves rows between ranks
    (``rebin_unconditional``, the sharded
    :class:`mdtpu_torch.parallel.HaloSlotEngine`) takes the JAX package's
    schedule for it: a rebuild at the start of the segment, after every
    step that any rank flagged, and before the segment's last step, so the
    slot order and sums follow the reference's. ``ring``: the shard ring
    (:func:`make_slot_step`); every flag read on the host is then the
    ring's."""
    step = make_slot_step(params, ensemble, engine, compensated=compensated,
                          observables=not lean, hilo=hilo,
                          force_dtype=force_dtype, ring=ring)
    last_step = make_slot_step(params, ensemble, engine,
                               compensated=compensated, hilo=hilo,
                               force_dtype=force_dtype, ring=ring)

    def needs(state):
        return bool(_engine_needs_rebin(state, engine, ring))

    if getattr(engine, "rebin_unconditional", False):
        def advance_sharded(state: SimulationState, k: int):
            n_lean = k - 1 if lean else k
            i = 0
            while i < n_lean:
                state = _engine_rebin(state, engine)
                while True:
                    state = step(state)
                    i += 1
                    if i >= n_lean or needs(state):
                        break
            if lean and k > 0:
                state = last_step(_engine_rebin(state, engine))
            return state

        return advance_sharded

    def advance(state: SimulationState, k: int) -> SimulationState:
        if k <= 0:
            return state
        rebuild = needs(state)
        for _ in range(k - 1 if lean else k):
            if rebuild:
                state = _rebin(state, engine)
            state = step(state)
            rebuild = needs(state)
        if lean:
            if rebuild:
                state = _rebin(state, engine)
            state = last_step(state)
        return state

    return advance
