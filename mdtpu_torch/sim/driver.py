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
{p:.6f}"``, LAMMPS dump frames in ``trajectory.xyz`` (``trajectory.xyz.zst``
with ``compress``) and ``snapshot.{s}`` (positions written as float32, as
the JAX package ships them), ``new-log-times.txt``, ``final.xyz``,
``checkpoint.{s}.npz`` every ``checkpoint_every`` steps and ``perf.txt``
with ``perf_log``. Outputs for label ``s`` are written after executing loop
iteration ``s``, including s = 0; the checkpoint of label ``s`` holds the
state after it, at step ``s + 1``.

A fresh state (step 0) truncates the run's files. A resumed state (step >
0, e.g. from a checkpoint) into a directory that holds an earlier run keeps
the thermo rows and trajectory frames labelled below its step and appends
after them, as the JAX package does: the rows at and past the step are a
crashed run's tail, which the resumed run writes again.
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
from mdtpu_torch.io.checkpoint import save_checkpoint
from mdtpu_torch.io.compress import (ZstdWriter, decompressed_lines,
                                     require_libzstd)
from mdtpu_torch.io.logtimes import generate_log_times
from mdtpu_torch.io.writer import TrajectoryWriter
from mdtpu_torch.io.xyz import write_xyz
from mdtpu_torch.utils.device import resolve_device
from mdtpu_torch.utils.profiling import StepRateMeter

THERMO_HEADER = "# Step Energy Temperature Pressure\n"
_MAX_GROWS = 8


def _cadence(start_step, end_step, every):
    """The multiples of ``every`` in [start_step, end_step)."""
    return set(range(start_step + (-start_step) % every, end_step, every))


def _event_schedule(start_step, total_steps, frequency, traj_frequency,
                    log_times, checkpoint_every, pathname):
    """Thermo, trajectory, snapshot and checkpoint steps in [start_step,
    start_step + total_steps). With ``log_times`` the snapshot steps are 0
    and the log-spaced times of :func:`generate_log_times` (saved to
    ``new-log-times.txt`` in ``pathname``, unless it is None), on the
    schedule of a run that started at step 0. Checkpoints are events of
    their own, not aligned to the output cadence."""
    end_step = start_step + total_steps
    thermo_steps = _cadence(start_step, end_step, frequency)
    traj_steps = _cadence(start_step, end_step, frequency
                          if traj_frequency is None else traj_frequency)
    snap_steps = set()
    if log_times:
        snaps = generate_log_times(save_dir=pathname, max_step=end_step)
        snap_steps = {s for s in [0] + snaps if start_step <= s < end_step}
    checkpoint_steps = (set() if checkpoint_every is None else
                        _cadence(start_step, end_step, checkpoint_every))
    return thermo_steps, traj_steps, snap_steps, checkpoint_steps


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


def _filter_thermo_rows(thermo_file, state_step):
    """Drop the thermo rows labelled ``>= state_step`` in place (a stale
    rerun's, or the tail of the crashed run being resumed); header and
    comment lines stay."""
    try:
        with open(thermo_file) as f:
            lines = f.readlines()
    except OSError:
        return
    kept, dropped = [], 0
    for line in lines:
        s = line.strip()
        if s and not s.startswith("#"):
            try:
                if int(s.split()[0]) >= state_step:
                    dropped += 1
                    continue
            except ValueError:
                pass
        kept.append(line)
    if dropped:
        with open(thermo_file, "w") as f:
            f.writelines(kept)


def _copy_frames_below(lines, write, state_step):
    """Stream LAMMPS-dump lines to ``write``, keeping only the frames whose
    TIMESTEP label is below ``state_step``. Returns the frames dropped."""
    dropped = 0
    frame, keep, expect_step = [], True, False

    def flush():
        nonlocal dropped
        if frame:
            if keep:
                write("".join(frame))
            else:
                dropped += 1

    for line in lines:
        if line.startswith("ITEM: TIMESTEP"):
            flush()
            frame, keep, expect_step = [line], True, True
            continue
        if expect_step:
            expect_step = False
            try:
                keep = int(line.split()[0]) < state_step
            except (ValueError, IndexError):
                keep = True
        if frame:
            frame.append(line)
        else:
            write(line)
    flush()
    return dropped


def _filter_trajectory_frames(traj_path, state_step, compressed):
    """Drop the trajectory frames labelled ``>= state_step`` in place, from
    the plain file or the zstd stream (decompress, filter, compress). A
    failed write leaves the file as it was and raises."""
    tmp = traj_path + ".resume-tmp"
    try:
        if compressed:
            with open(traj_path, "rb") as fin, open(tmp, "wb") as fout:
                out = ZstdWriter(fout)
                try:
                    dropped = _copy_frames_below(
                        decompressed_lines(fin),
                        lambda text: out.write(text.encode()), state_step)
                finally:
                    out.close()
        else:
            with open(traj_path) as fin, open(tmp, "w") as fout:
                dropped = _copy_frames_below(fin, fout.write, state_step)
        if dropped:
            os.replace(tmp, traj_path)
        else:
            os.remove(tmp)
    except OSError:
        if os.path.isfile(tmp):
            os.remove(tmp)
        raise


def prepare_output_files(pathname, traj_name, thermo_name, state_step,
                         compress):
    """The run's thermo file and trajectory writer, reconciled with the
    state about to run. A fresh state (step <= 0, or no thermo file yet)
    truncates, a stale ``trajectory.xyz.zst`` included; a resumed state
    keeps the rows and frames labelled below its step and appends after
    them. Returns ``(thermo_file, writer)``."""
    os.makedirs(pathname, exist_ok=True)
    trajectory_file = os.path.join(pathname, traj_name)
    thermo_file = os.path.join(pathname, thermo_name)
    traj_path = trajectory_file + ".zst" if compress else trajectory_file
    fresh = state_step <= 0 or not os.path.isfile(thermo_file)
    if fresh:
        for f in {trajectory_file, thermo_file, trajectory_file + ".zst"}:
            if os.path.isfile(f):
                os.remove(f)
        with open(thermo_file, "w") as f:
            f.write(THERMO_HEADER)
    else:
        _filter_thermo_rows(thermo_file, state_step)
        if os.path.isfile(traj_path):
            _filter_trajectory_frames(traj_path, state_step, compress)
    append = not fresh and os.path.isfile(traj_path)
    return thermo_file, TrajectoryWriter(traj_path, compress=compress,
                                         append=append)


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

    ``compress``: the trajectory goes to ``trajectory.xyz.zst`` through
    libzstd (``RuntimeError`` before any file is touched where the system
    has no libzstd). ``checkpoint_every``: ``checkpoint.{s}.npz`` of the
    particle-order state every so many steps
    (:func:`mdtpu_torch.io.checkpoint.load_checkpoint` reads it back).
    ``perf_log``: steps per second of every segment in ``perf.txt``
    (appended to on a resumed state)."""
    from mdtpu_torch.ops import select_engine

    # Validate before any output file is touched.
    if precision not in ("auto", "f32x2", "plain"):
        raise ValueError(f"precision must be auto/f32x2/plain, got {precision!r}")
    if compress:
        require_libzstd()
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

    start_step = state.step
    end_step = start_step + total_steps
    thermo_file, writer = prepare_output_files(
        pathname, traj_name, thermo_name, start_step, compress)
    state, engine = _drive_events(
        state, engine, make_advance=make_advance, restore=restore,
        health=lambda s: _health(s, use_slot),
        frame_rows=lambda s: _frame_rows(s, use_slot, n, unitcell_np),
        particle_state=slots.unslotify_state if use_slot else (lambda s: s),
        use_slot=use_slot, is_brownian=is_brownian, ensemble=ensemble,
        consts=consts, unitcell_np=unitcell_np, diameters_np=diameters_np,
        schedule=_event_schedule(start_step, total_steps, frequency,
                                 traj_frequency, log_times, checkpoint_every,
                                 pathname),
        start_step=start_step, end_step=end_step, pathname=pathname,
        thermo_file=thermo_file, writer=writer,
        meter=(StepRateMeter(os.path.join(pathname, "perf.txt"),
                             append=start_step > 0) if perf_log else None))

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


def _drive_events(state, engine, *, make_advance, restore, health,
                  frame_rows, particle_state, use_slot, is_brownian,
                  ensemble, consts, unitcell_np, diameters_np, schedule,
                  start_step, end_step, pathname, thermo_file, writer, meter):
    """The event loop shared by :func:`run_simulation` and
    :func:`mdtpu_torch.parallel.run_simulation_sharded`, as the JAX
    package's ``_drive_events``: advance from event to event of
    ``schedule`` (thermo, trajectory, snapshot and checkpoint steps), read
    the segment's health, rerun it from its start on a grown engine after
    a capacity overflow, and write the event's outputs.

    The route enters through callbacks: ``make_advance(engine)`` gives
    ``advance(state, k)``; ``restore(seg_start, engine)`` the segment's
    start for a grown engine, ``(state, engine)``; ``health(state)`` the
    ``[diverged, overflow, occupied slots]`` ints every rank agrees on;
    ``frame_rows(state)`` a frame's particle-order rows and
    ``particle_state(state)`` the particle-order state of a checkpoint
    (both collective on a shard ring: every rank calls them). Files are
    written where ``thermo_file`` is not None (one rank of a ring), and the
    writer and ``meter`` may be None on the others. Returns ``(state,
    engine)``."""
    thermo_steps, traj_steps, snap_steps, checkpoint_steps = schedule
    n = consts["n"]
    writes = thermo_file is not None
    advance = make_advance(engine)
    try:
        for label, n_adv in _segments(
                start_step, end_step,
                thermo_steps | traj_steps | snap_steps | checkpoint_steps):
            seg_start = state
            for attempt in range(_MAX_GROWS + 1):
                s = advance(seg_start, n_adv)
                diverged, overflow, occupied = health(s)
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
                if writes:
                    with open(thermo_file, "a") as f:
                        f.write(f"{label} {ener:.6f} {t:.6f} "
                                f"{pressure:.6f}\n")
                if is_brownian:
                    # The pressure average restarts after each thermo row.
                    state = state.replace(
                        virial_accum=torch.zeros_like(state.virial_accum),
                        nprom=torch.zeros_like(state.nprom))
            if label in traj_steps or label in snap_steps:
                rows = (label, unitcell_np, *frame_rows(state), diameters_np)
                if writes and label in traj_steps:
                    writer.write_frame(*rows)
                if writes and label in snap_steps:
                    writer.write_snapshot(
                        os.path.join(pathname, f"snapshot.{label}"), *rows)
            if meter is not None:
                meter.tick(label, n_adv)
            if label in checkpoint_steps:
                particles = particle_state(state)
                if writes:
                    save_checkpoint(particles, os.path.join(
                        pathname, f"checkpoint.{label}.npz"))
    finally:
        if writer is not None:
            writer.close()
    return state, engine
