"""The velocity-Verlet step with NVE/NVT ensemble logic.

Counterpart of ``mdtpu/integrate/step.py`` (``engine_forces``,
``md_velocity_finish``, ``make_md_step``), for NVT and NVE. PyTorch runs
eagerly, so a step is a plain function ``step(state) -> state``; the driver
calls it in a Python loop.

Initial forces are computed at state construction (the reference starts its
first half-kick with zero forces).
"""

from __future__ import annotations

import dataclasses

from mdtpu_torch.core.box import wrap_positions, wrap_positions_compensated
from mdtpu_torch.core.types import NVE, NVT, Brownian, Parameters, SimulationState
from mdtpu_torch.integrate import thermostat
from mdtpu_torch.utils.math import kahan_add


def engine_forces(engine, positions, diameters, cell, cell_inv, nbrs):
    """Evaluate forces, rebuilding the engine's neighbour state when stale.

    A rebuild decision that is a tensor is read on the host (one
    synchronisation per step). A rebuilt binning keeps an earlier
    overflow flag set, so the driver sees every overflow of a segment."""
    if nbrs is None:
        nbrs = engine.allocate(positions, diameters, cell, cell_inv)
    else:
        rebuild = engine.needs_rebuild(positions, nbrs, cell, cell_inv)
        if bool(rebuild):
            fresh = engine.allocate(positions, diameters, cell, cell_inv)
            nbrs = dataclasses.replace(fresh,
                                       overflow=fresh.overflow | nbrs.overflow)
    return engine.compute(positions, diameters, cell, cell_inv, nbrs)


def _add(x, comp, dx, compensated: bool):
    if compensated:
        return kahan_add(x, comp, dx)
    return x + dx, comp


def md_velocity_finish(ensemble, v, vc, state, dt, compensated: bool):
    """Post-kick ensemble logic: Bussi rescale and temperature for NVT (one
    kinetic reduction serves both, T_after = scale^2 * 2K/nf), plain
    temperature for NVE. Returns ``(v, vc, temperature)``."""
    if isinstance(ensemble, NVT):
        ktemp_t = ensemble.ktemp(state.step + 1)
        r1, r2 = thermostat.bussi_noise(state.seed, state.step, state.nf,
                                        v.dtype, v.device)
        kinetic = thermostat.compute_kinetic(v)
        scale = thermostat.bussi_scale_from_kinetic(
            kinetic, ktemp_t, state.nf, dt, ensemble.tau, r1, r2)
        v = v * scale
        temperature = scale * scale * 2.0 * kinetic / state.nf
        if compensated:
            # Rescaling invalidates the velocity compensation buffer.
            vc = vc.new_zeros(vc.shape)
    else:
        temperature = thermostat.compute_temperature(v, state.nf)
    return v, vc, temperature


def make_md_step(params: Parameters, ensemble, engine,
                 compensated: bool = True):
    """Velocity-Verlet step with NVE/NVT ensemble logic."""
    if isinstance(ensemble, Brownian):
        raise TypeError("Brownian dynamics is not ported yet (queue A8)")
    if not isinstance(ensemble, (NVT, NVE)):
        raise TypeError(f"unknown ensemble type: {type(ensemble).__name__}")

    def step(state: SimulationState) -> SimulationState:
        dt = float(params.dt)
        half = 0.5 * dt
        cell, cell_inv = state.unitcell, state.unitcell_inv

        # First half-kick + drift.
        v, vc = _add(state.velocities, state.vel_comp, state.forces * half,
                     compensated)
        x, xc = _add(state.positions, state.pos_comp, v * dt, compensated)
        if compensated:
            x, xc, images = wrap_positions_compensated(x, xc, state.images,
                                                       cell, cell_inv)
        else:
            x, images = wrap_positions(x, state.images, cell, cell_inv)

        energy, virial, forces, nbrs = engine_forces(
            engine, x, state.diameters, cell, cell_inv, state.nbrs)

        # Second half-kick.
        v, vc = _add(v, vc, forces * half, compensated)
        v, vc, temperature = md_velocity_finish(ensemble, v, vc, state, dt,
                                                compensated)
        return state.replace(
            positions=x, velocities=v, forces=forces, images=images,
            step=state.step + 1, energy=energy, virial=virial,
            temperature=temperature, pos_comp=xc, vel_comp=vc, nbrs=nbrs)

    return step
