"""Simulation driver: ``run_simulation``.

Counterpart of ``mdtpu/sim/driver.py`` for NVT and NVE on one device. The
output schedule (thermo and trajectory events) is computed on the host up
front; the state advances event by event through the velocity-Verlet step,
and after each event's segment the driver reads two health flags (one
host synchronisation per event):

  * non-finite positions: the run diverged, raise;
  * engine capacity overflow: a cell held more particles than its slots, so
    some particles got no forces. The segment is rerun from its start state
    with a grown engine (up to 8 times).

Files match the JAX package's: ``thermo.txt`` rows ``"{s} {e:.6f} {t:.6f}
{p:.6f}"``, LAMMPS dump frames in ``trajectory.xyz`` (positions written as
float32, as the JAX package ships them) and ``final.xyz``. Outputs for label
``s`` are written after executing loop iteration ``s``, including s = 0.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch

from mdtpu_torch.core.box import box_volume
from mdtpu_torch.core.types import Brownian, Parameters, SimulationState, state_to
from mdtpu_torch.integrate.step import make_md_step
from mdtpu_torch.io.writer import TrajectoryWriter
from mdtpu_torch.io.xyz import write_xyz
from mdtpu_torch.utils.device import resolve_device

THERMO_HEADER = "# Step Energy Temperature Pressure\n"
_MAX_GROWS = 8


def _event_schedule(start_step, total_steps, frequency, traj_frequency):
    """Thermo and trajectory steps in [start_step, start_step + total_steps)."""
    end_step = start_step + total_steps
    thermo_steps = set(range(start_step + (-start_step) % frequency,
                             end_step, frequency))
    if traj_frequency is None:
        traj_frequency = frequency
    traj_steps = set(range(start_step + (-start_step) % traj_frequency,
                           end_step, traj_frequency))
    return thermo_steps, traj_steps


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


def _thermo_values(e, t, virial, *, n, dim, volume, density, e_lrc, p_lrc):
    """``(energy_per_particle, temperature, pressure)`` of one thermo row."""
    ener = (e + e_lrc) / n
    pressure = float(virial) / (dim * volume) + density * t + p_lrc
    return ener, t, pressure


def _capacity_overflow(state):
    flag = getattr(state.nbrs, "overflow", None)
    if flag is None:
        return torch.zeros((), dtype=torch.bool, device=state.device)
    return flag


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
    """Run ``total_steps`` of NVT or NVE dynamics, writing thermo rows every
    ``frequency`` steps and trajectory frames every ``traj_frequency`` steps
    (default: ``frequency``). Returns the final state.

    ``device``: where the run happens, ``"cuda"`` by default; raises when no
    card is present unless the caller passes ``device="cpu"``.

    ``precision``: ``"auto"`` and ``"plain"`` run the plain pair sweep. The
    JAX package's ``"auto"`` runs the hi/lo (f32x2) sweep for f32 NVE on its
    slot path; that sweep and ``"f32x2"`` are queue A7.

    Not ported yet: Brownian dynamics, ``compress``, ``log_times``,
    ``checkpoint_every``, ``perf_log`` and resuming into a directory that
    holds an earlier run's thermo file (queue A8)."""
    from mdtpu_torch.ops import select_engine

    # Validate before any output file is touched.
    if precision == "f32x2":
        raise _not_ported("the hi/lo (f32x2) pair sweep", "A7")
    if precision not in ("auto", "plain"):
        raise ValueError(f"precision must be auto/f32x2/plain, got {precision!r}")
    if isinstance(ensemble, Brownian):
        raise _not_ported("Brownian dynamics", "A8")
    for flag, name in ((compress, "compress"), (log_times, "log_times"),
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

    potential = params.potential
    volume = box_volume(state.unitcell)
    dim, n = state.dimension, state.n_particles
    consts = dict(n=n, dim=dim, volume=volume, density=float(params.density),
                  e_lrc=float(potential.energy_lrc(n, volume)),
                  p_lrc=float(potential.pressure_lrc(n, volume)))
    # Run constants kept host-side: never transferred per event.
    diameters_np = state.diameters.cpu().numpy()
    unitcell_np = state.unitcell.cpu().numpy()

    # Engine state and initial forces (the reference's first half-kick uses
    # zero forces); grow the engine until the initial binning fits.
    for _ in range(_MAX_GROWS + 1):
        nbrs = engine.allocate(state.positions, state.diameters,
                               state.unitcell, state.unitcell_inv)
        e0, w0, f0, nbrs = engine.compute(state.positions, state.diameters,
                                          state.unitcell, state.unitcell_inv,
                                          nbrs)
        state = state.replace(forces=f0, energy=e0, virial=w0, nbrs=nbrs)
        if not bool(_capacity_overflow(state)):
            break
        engine = engine.with_grown_capacity()
    else:
        raise RuntimeError("cell capacity still overflowing after 8 grows")

    os.makedirs(pathname, exist_ok=True)
    trajectory_file = os.path.join(pathname, traj_name)
    if os.path.isfile(trajectory_file):
        os.remove(trajectory_file)
    with open(thermo_file, "w") as f:
        f.write(THERMO_HEADER)
    writer = TrajectoryWriter(trajectory_file)

    start_step = state.step
    end_step = start_step + total_steps
    thermo_steps, traj_steps = _event_schedule(start_step, total_steps,
                                               frequency, traj_frequency)
    step_fn = make_md_step(params, ensemble, engine, compensated)
    try:
        for label, n_adv in _segments(start_step, end_step,
                                      thermo_steps | traj_steps):
            seg_start = state
            for attempt in range(_MAX_GROWS + 1):
                s = seg_start
                for _ in range(n_adv):
                    s = step_fn(s)
                diverged, overflow = torch.stack([
                    ~torch.all(torch.isfinite(s.positions)),
                    _capacity_overflow(s)]).tolist()
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
                engine = engine.with_grown_capacity()
                warnings.warn(
                    f"engine capacity overflow in the segment ending step "
                    f"{label}: restoring its start state and re-running with "
                    f"cell capacity {engine.cell_capacity}")
                step_fn = make_md_step(params, ensemble, engine, compensated)
                seg_start = seg_start.replace(nbrs=engine.allocate(
                    seg_start.positions, seg_start.diameters,
                    seg_start.unitcell, seg_start.unitcell_inv))
            state = s
            if label in thermo_steps:
                e, t, w = torch.stack([state.energy, state.temperature,
                                       state.virial]).tolist()
                ener, t, pressure = _thermo_values(e, t, w, **consts)
                with open(thermo_file, "a") as f:
                    f.write(f"{label} {ener:.6f} {t:.6f} {pressure:.6f}\n")
            if label in traj_steps:
                writer.write_frame(
                    label, unitcell_np,
                    state.positions.to(torch.float32).cpu().numpy(),
                    state.images.cpu().numpy().astype(np.int32),
                    diameters_np)
    finally:
        writer.close()

    write_xyz(os.path.join(pathname, "final.xyz"), end_step, state.unitcell,
              state.positions, state.diameters, mode="w")
    return state
