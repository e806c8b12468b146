"""Simulation driver: ``run_simulation``.

Counterpart of ``mdtpu/sim/driver.py`` for NVT, NVE and Brownian dynamics on
one device. The output schedule (thermo, trajectory and log-time snapshot
events) is computed on the host up front; the state advances event by event,
and after each event's segment the driver reads its health in one host
synchronisation:

  * non-finite positions: the run diverged, raise;
  * engine capacity overflow: a cell held more particles than its slots, so
    some particles got no forces (in the slot layout, were dropped). The
    segment is rerun from its start state with a grown engine (up to 8
    times);
  * in the slot layout, the count of occupied slots: a particle lost
    without the overflow flag raises.

Like the JAX package, a cell-grid engine with ``compensated=True`` runs the
slot-space loop (:mod:`mdtpu_torch.integrate.slot_step`): the state is put
in slot order once, advanced by ``make_slot_advance`` (no per-step scatter or
gather, the rebuild check a host read a step, lean steps inside a segment),
ordered by ``ids`` for frames and put back in particle order at the end. Other
engines, ``PlaneEngine`` and ``compensated=False`` take the particle-order
step.

Files match the JAX package's: ``thermo.txt`` rows ``"{s} {e:.6f} {t:.6f}
{p:.6f}"``, LAMMPS dump frames in ``trajectory.xyz`` and ``snapshot.{s}``
(positions written as float32, as the JAX package ships them),
``new-log-times.txt`` and ``final.xyz``. Outputs for label ``s`` are written
after executing loop iteration ``s``, including s = 0.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch

from mdtpu_torch.core.box import box_volume
from mdtpu_torch.core.types import (NVE, Brownian, Parameters, SimulationState,
                                    state_to)
from mdtpu_torch.integrate import slot_step as slots
from mdtpu_torch.integrate.step import make_step
from mdtpu_torch.io.logtimes import generate_log_times
from mdtpu_torch.io.writer import TrajectoryWriter
from mdtpu_torch.io.xyz import write_xyz
from mdtpu_torch.utils.device import resolve_device

THERMO_HEADER = "# Step Energy Temperature Pressure\n"
_MAX_GROWS = 8


def _event_schedule(start_step, total_steps, frequency, traj_frequency,
                    log_times, pathname):
    """Thermo, trajectory and snapshot steps in [start_step, start_step +
    total_steps). With ``log_times`` the snapshot steps are 0 and the
    log-spaced times of :func:`generate_log_times` (saved to
    ``new-log-times.txt`` in ``pathname``), on the schedule of a run that
    started at step 0."""
    end_step = start_step + total_steps
    thermo_steps = set(range(start_step + (-start_step) % frequency,
                             end_step, frequency))
    if traj_frequency is None:
        traj_frequency = frequency
    traj_steps = set(range(start_step + (-start_step) % traj_frequency,
                           end_step, traj_frequency))
    snap_steps = set()
    if log_times:
        snaps = generate_log_times(save_dir=pathname, max_step=end_step)
        snap_steps = {s for s in [0] + snaps if start_step <= s < end_step}
    return thermo_steps, traj_steps, snap_steps


def _segments(start_step, end_step, event_steps):
    """[(label, steps to advance)]: each event's output is taken after loop
    iteration ``label``; a tail past the last event writes nothing (its
    label, end_step, is in no output set)."""
    segs, prev = [], start_step
    for ev in sorted(event_steps):
        segs.append((ev, ev - prev + 1))
        prev = ev + 1
    if prev < end_step:
        segs.append((end_step, end_step - prev))
    return segs


def _thermo_values(e, t, virial, virial_accum, nprom, *, ensemble, n, dim,
                   volume, density, e_lrc, p_lrc):
    """``(energy_per_particle, temperature, pressure)`` of one thermo row.
    Brownian rows: energy per particle without the tail correction, the
    virial averaged over its 10-step samples, and ``ktemp`` in the
    temperature column."""
    if isinstance(ensemble, Brownian):
        ktemp = float(ensemble.ktemp)
        pressure = (float(virial_accum) / (dim * max(int(nprom), 1) * volume)
                    + density * ktemp)
        return e / n, ktemp, pressure
    ener = (e + e_lrc) / n
    pressure = float(virial) / (dim * volume) + density * t + p_lrc
    return ener, t, pressure


def _slot_route(engine, state, compensated):
    """Whether the run takes the slot-space loop: a cell-grid engine that
    runs in slots (not ``PlaneEngine``), the state's dimension that of its
    grid, and ``compensated=True``, as in the JAX package."""
    return (getattr(engine, "runs_in_slots", False)
            and state.dimension == len(engine.grid) and compensated)


def _hilo_route(engine, state, ensemble, precision, compensated):
    """Whether the hi/lo (f32x2) pair sweep runs: ``"auto"`` takes it for
    float32 NVE on a cell-grid engine with ``compensated=True``, as the JAX
    package's slot path does; ``"f32x2"`` forces it and raises where it
    cannot run."""
    from mdtpu_torch.ops.cell_grid import CellGridEngine

    route = (isinstance(engine, CellGridEngine) and compensated
             and state.dimension == len(engine.grid))
    if precision == "f32x2":
        if not route:
            raise ValueError(
                "precision='f32x2' (the hi/lo pair sweep) requires a "
                "CellGridEngine matching the state's dimension and "
                f"compensated=True — got {type(engine).__name__}, "
                f"dimension={state.dimension}, compensated={compensated}. "
                "Use precision='auto' to apply it opportunistically.")
        if state.dtype != torch.float32:
            raise ValueError("precision='f32x2' takes a float32 state, got "
                             f"{state.dtype}")
        return True
    return (precision == "auto" and route and isinstance(ensemble, NVE)
            and state.dtype == torch.float32)


def _capacity_overflow(state):
    flag = getattr(state.nbrs, "overflow", None)
    if flag is None:
        return torch.zeros((), dtype=torch.bool, device=state.device)
    return flag


def _health(state, use_slot):
    """``[diverged, overflow, occupied slots]`` as Python ints, in one host
    read (the occupied count -1 in particle order)."""
    occupied = (state.nbrs.occupied.sum() if use_slot
                else torch.full((), -1, dtype=torch.int64,
                                device=state.device))
    return torch.stack([(~torch.all(torch.isfinite(state.positions))).long(),
                        _capacity_overflow(state).long(),
                        occupied]).tolist()


def _frame_rows(state, use_slot, n, unitcell_np):
    """A frame's ``(positions float32 (n, d), images int32 (n, d))`` in
    particle order. Slot states are ordered by ``ids`` on the device and
    their deferred-wrap drift folded on the host (``_host_wrap``), from the
    float32 positions, as the JAX package does."""
    if not use_slot:
        return (state.positions.to(torch.float32).cpu().numpy(),
                state.images.cpu().numpy().astype(np.int32))
    key = torch.where(state.ids < 0, torch.iinfo(torch.int64).max, state.ids)
    perm = torch.argsort(key)[:n]
    pos = state.positions.to(torch.float32)[:, perm].T.cpu().numpy()
    images = state.images[:, perm].T.cpu().numpy()
    pos, images = slots._host_wrap(pos, images, unitcell_np)
    return pos, images.astype(np.int32)


def _not_ported(what, queue):
    return NotImplementedError(f"{what} is not ported yet (queue {queue})")


def run_simulation(
    state: SimulationState,
    params: Parameters,
    ensemble,
    total_steps: int,
    frequency: int,
    pathname: str,
    *,
    traj_name: str = "trajectory.xyz",
    thermo_name: str = "thermo.txt",
    compress: bool = False,
    log_times: bool = False,
    engine=None,
    compensated: bool = True,
    checkpoint_every: Optional[int] = None,
    perf_log: bool = False,
    precision: str = "auto",
    traj_frequency: Optional[int] = None,
    device=None,
) -> SimulationState:
    """Run ``total_steps`` of NVT, NVE or Brownian dynamics, writing thermo
    rows every ``frequency`` steps and trajectory frames every
    ``traj_frequency`` steps (default: ``frequency``); with ``log_times``
    also ``snapshot.{step}`` frames at log-spaced steps. Returns the final
    state.

    ``device``: where the run happens, ``"cuda"`` by default; raises when no
    card is present unless the caller passes ``device="cpu"``.

    ``engine``: any engine of :mod:`mdtpu_torch.ops`, e.g. the Newton
    half-stencil :class:`mdtpu_torch.ops.experimental.PlaneEngine`
    (``select_engine`` does not pick it). A ``CellGridEngine`` with
    ``compensated=True`` runs the slot-space loop; every other combination
    the particle-order step.

    ``precision``: ``"auto"`` runs the hi/lo (f32x2) pair sweep for float32
    NVE on a cell-grid engine with ``compensated=True``, as the JAX package
    does; ``"f32x2"`` forces it (``ValueError`` where it cannot run);
    ``"plain"`` turns it off.

    Not ported yet: ``compress``, ``checkpoint_every``, ``perf_log`` and
    resuming into a directory that holds an earlier run's thermo file
    (queue A8)."""
    from mdtpu_torch.ops import select_engine

    # Validate before any output file is touched.
    if precision not in ("auto", "f32x2", "plain"):
        raise ValueError(f"precision must be auto/f32x2/plain, got {precision!r}")
    for flag, name in ((compress, "compress"),
                       (checkpoint_every is not None, "checkpoint_every"),
                       (perf_log, "perf_log")):
        if flag:
            raise _not_ported(name, "A8")
    thermo_file = os.path.join(pathname, thermo_name)
    if state.step > 0 and os.path.isfile(thermo_file):
        raise _not_ported("resuming into a directory with earlier output",
                          "A8")
    device = resolve_device(device)
    state = state_to(state, device)
    if engine is None:
        engine = select_engine(params.potential, state.cutoff, state)
    hilo = _hilo_route(engine, state, ensemble, precision, compensated)
    use_slot = _slot_route(engine, state, compensated)
    is_brownian = isinstance(ensemble, Brownian)

    potential = params.potential
    volume = box_volume(state.unitcell)
    dim, n = state.dimension, state.n_particles
    consts = dict(n=n, dim=dim, volume=volume, density=float(params.density),
                  e_lrc=float(potential.energy_lrc(n, volume)),
                  p_lrc=float(potential.pressure_lrc(n, volume)))
    # Run constants kept host-side: never transferred per event.
    diameters_np = state.diameters.cpu().numpy()
    unitcell_np = state.unitcell.cpu().numpy()

    # Engine state and, for MD, initial forces (the reference's first
    # half-kick uses zero forces; a Brownian step computes its forces
    # first); grow the engine until the initial binning fits.
    if use_slot:
        state, engine = slots.slotify_grown(state, engine)
        state = slots.slot_forces(state, engine)
    else:
        for _ in range(_MAX_GROWS + 1):
            nbrs = engine.allocate(state.positions, state.diameters,
                                   state.unitcell, state.unitcell_inv)
            if is_brownian:
                state = state.replace(nbrs=nbrs)
            else:
                e0, w0, f0, nbrs = engine.compute(
                    state.positions, state.diameters, state.unitcell,
                    state.unitcell_inv, nbrs)
                state = state.replace(forces=f0, energy=e0, virial=w0,
                                      nbrs=nbrs)
            if not bool(_capacity_overflow(state)):
                break
            engine = engine.with_grown_capacity()
        else:
            raise RuntimeError("cell capacity still overflowing after 8 grows")

    def make_advance(engine):
        """``advance(state, k)``: k steps of the run's route."""
        if use_slot:
            return slots.make_slot_advance(params, ensemble, engine,
                                           compensated=compensated, hilo=hilo)
        step_fn = make_step(params, ensemble, engine, compensated, hilo=hilo)

        def advance(state, k):
            for _ in range(k):
                state = step_fn(state)
            return state

        return advance

    def restore(seg_start, engine):
        """The segment's start state for a grown engine."""
        if use_slot:
            state, engine = slots.slotify_grown(
                slots.unslotify_state(seg_start), engine)
            return slots.slot_forces(state, engine), engine
        return seg_start.replace(nbrs=engine.allocate(
            seg_start.positions, seg_start.diameters, seg_start.unitcell,
            seg_start.unitcell_inv)), engine

    os.makedirs(pathname, exist_ok=True)
    trajectory_file = os.path.join(pathname, traj_name)
    if os.path.isfile(trajectory_file):
        os.remove(trajectory_file)
    with open(thermo_file, "w") as f:
        f.write(THERMO_HEADER)
    writer = TrajectoryWriter(trajectory_file)

    start_step = state.step
    end_step = start_step + total_steps
    thermo_steps, traj_steps, snap_steps = _event_schedule(
        start_step, total_steps, frequency, traj_frequency, log_times,
        pathname)
    advance = make_advance(engine)
    try:
        for label, n_adv in _segments(start_step, end_step,
                                      thermo_steps | traj_steps | snap_steps):
            seg_start = state
            for attempt in range(_MAX_GROWS + 1):
                s = advance(seg_start, n_adv)
                diverged, overflow, occupied = _health(s, use_slot)
                if diverged:
                    raise RuntimeError(
                        f"simulation diverged (non-finite positions) at or "
                        f"before step {label}: check the starting "
                        f"configuration for overlaps, reduce dt or use "
                        f"dtype=float64")
                if not overflow:
                    break
                if attempt == _MAX_GROWS:
                    raise RuntimeError(
                        "engine capacity still overflowing after 8 grows")
                seg_start, engine = restore(seg_start,
                                            engine.with_grown_capacity())
                warnings.warn(
                    f"engine capacity overflow in the segment ending step "
                    f"{label}: restoring its start state and re-running with "
                    f"cell capacity {engine.cell_capacity}")
                advance = make_advance(engine)
            if use_slot and occupied != n:
                raise RuntimeError(
                    f"slot state holds {occupied} of {n} particles at step "
                    f"{label}: capacity overflow recovery failed")
            state = s
            if label in thermo_steps:
                values = [state.energy, state.temperature, state.virial]
                if is_brownian:
                    values += [state.virial_accum,
                               state.nprom.to(state.dtype)]
                e, t, w, *accum = torch.stack(values).tolist()
                w_acc, nprom = accum or (0.0, 0)
                ener, t, pressure = _thermo_values(
                    e, t, w, w_acc, nprom, ensemble=ensemble, **consts)
                with open(thermo_file, "a") as f:
                    f.write(f"{label} {ener:.6f} {t:.6f} {pressure:.6f}\n")
                if is_brownian:
                    # The pressure average restarts after each thermo row.
                    state = state.replace(
                        virial_accum=torch.zeros_like(state.virial_accum),
                        nprom=torch.zeros_like(state.nprom))
            if label in traj_steps or label in snap_steps:
                rows = (label, unitcell_np,
                        *_frame_rows(state, use_slot, n, unitcell_np),
                        diameters_np)
                if label in traj_steps:
                    writer.write_frame(*rows)
                if label in snap_steps:
                    writer.write_snapshot(
                        os.path.join(pathname, f"snapshot.{label}"), *rows)
    finally:
        writer.close()

    if use_slot:
        # Back to particle order (original order through ids) with
        # particle-order engine state, as the other routes return it.
        state = slots.unslotify_state(state)
        state = state.replace(nbrs=engine.allocate(
            state.positions, state.diameters, state.unitcell,
            state.unitcell_inv))
    write_xyz(os.path.join(pathname, "final.xyz"), end_step, state.unitcell,
              state.positions, state.diameters, mode="w")
    return state
