"""The velocity-Verlet step with NVE/NVT ensemble logic, and the overdamped
Brownian step.

Counterpart of ``mdtpu/integrate/step.py`` (``engine_forces``,
``md_velocity_finish``, ``brownian_noise``, ``brownian_virial_sample``,
``make_md_step``, ``make_brownian_step``, ``make_step``). PyTorch runs
eagerly, so a step is a plain function ``step(state) -> state``; the driver
calls it in a Python loop.

Initial forces of MD runs are computed at state construction (the reference
starts its first half-kick with zero forces); a Brownian step computes its
forces first.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mdtpu_torch.core.box import wrap_positions, wrap_positions_compensated
from mdtpu_torch.core.types import NVE, NVT, Brownian, Parameters, SimulationState
from mdtpu_torch.integrate import thermostat
from mdtpu_torch.potentials.base import rounded
from mdtpu_torch.utils.math import kahan_add

SQRT3 = math.sqrt(3.0)


def engine_forces(engine, positions, diameters, cell, cell_inv, nbrs,
                  pos_lo=None, force_dtype=None):
    """Evaluate forces, rebuilding the engine's neighbour state when stale.

    A rebuild decision that is a tensor is read on the host (one
    synchronisation per step). A rebuilt binning keeps an earlier
    overflow flag set, so the driver sees every overflow of a segment.
    ``pos_lo``: the positions' low words, for the hi/lo sweep of a cell-grid
    engine. ``force_dtype``: positions, diameters and cell are cast to it
    first, so the whole evaluation (and the engine state) runs in that
    dtype; the results come back in it."""
    if force_dtype is not None and positions.dtype != force_dtype:
        positions = positions.to(force_dtype)
        diameters = diameters.to(force_dtype)
        cell = cell.to(force_dtype)
        cell_inv = cell_inv.to(force_dtype)
    if nbrs is None:
        nbrs = engine.allocate(positions, diameters, cell, cell_inv)
    else:
        rebuild = engine.needs_rebuild(positions, nbrs, cell, cell_inv)
        if bool(rebuild):
            fresh = engine.allocate(positions, diameters, cell, cell_inv)
            nbrs = dataclasses.replace(fresh,
                                       overflow=fresh.overflow | nbrs.overflow)
    if pos_lo is None:
        return engine.compute(positions, diameters, cell, cell_inv, nbrs)
    return engine.compute(positions, diameters, cell, cell_inv, nbrs,
                          pos_lo=pos_lo)


def _add(x, comp, dx, compensated: bool):
    if compensated:
        return kahan_add(x, comp, dx)
    return x + dx, comp


def md_velocity_finish(ensemble, v, vc, state, dt, compensated: bool,
                       ring=None):
    """Post-kick ensemble logic: Bussi rescale and temperature for NVT (one
    kinetic reduction serves both, T_after = scale^2 * 2K/nf), plain
    temperature for NVE. Returns ``(v, vc, temperature)``. ``ring``: a
    shard ring, over which the kinetic energy is summed (one all-reduce a
    step); Bussi's draws are the same on every rank."""
    if isinstance(ensemble, NVT):
        ktemp_t = ensemble.ktemp(state.step + 1)
        r1, r2 = thermostat.bussi_noise(state.seed, state.step, state.nf,
                                        v.dtype, v.device)
        kinetic = thermostat.compute_kinetic(v, ring)
        scale = thermostat.bussi_scale_from_kinetic(
            kinetic, ktemp_t, state.nf, dt, ensemble.tau, r1, r2)
        v = v * scale
        temperature = scale * scale * 2.0 * kinetic / state.nf
        if compensated:
            # Rescaling invalidates the velocity compensation buffer.
            vc = vc.new_zeros(vc.shape)
    else:
        temperature = thermostat.compute_temperature(v, state.nf, ring)
    return v, vc, temperature


def make_md_step(params: Parameters, ensemble, engine,
                 compensated: bool = True, hilo: bool = False,
                 force_dtype=None):
    """Velocity-Verlet step with NVE/NVT ensemble logic. ``hilo``: the pair
    sweep takes each position as the pair (x, -pos_comp), the hi/lo
    (f32x2) sweep of a cell-grid engine; needs ``compensated``.
    ``force_dtype``: mixed precision, the pair sweep in this dtype (up or
    down) while the state integrates in its own; energy, virial and forces
    are cast back. Not with ``hilo``."""
    if isinstance(ensemble, Brownian):
        raise TypeError("use make_brownian_step for Brownian dynamics")
    if not isinstance(ensemble, (NVT, NVE)):
        raise TypeError(f"unknown ensemble type: {type(ensemble).__name__}")
    if hilo and (force_dtype is not None or not compensated):
        raise ValueError("the hi/lo pair sweep needs compensated=True (the "
                         "Kahan compensation is its low word) and no "
                         "force_dtype (it is the precision mechanism)")

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

        # The compensation holds the negated low word (true = x - comp).
        energy, virial, forces, nbrs = engine_forces(
            engine, x, state.diameters, cell, cell_inv, state.nbrs,
            pos_lo=-xc if hilo else None, force_dtype=force_dtype)
        if forces.dtype != x.dtype:
            forces, energy, virial = (t.to(x.dtype)
                                      for t in (forces, energy, virial))

        # Second half-kick.
        v, vc = _add(v, vc, forces * half, compensated)
        v, vc, temperature = md_velocity_finish(ensemble, v, vc, state, dt,
                                                compensated)
        return state.replace(
            positions=x, velocities=v, forces=forces, images=images,
            step=state.step + 1, energy=energy, virial=virial,
            temperature=temperature, pos_comp=xc, vel_comp=vc, nbrs=nbrs)

    return step


def brownian_noise(seed: int, step: int, shape, dtype, device, rank=None):
    """The reference's variance-matched uniform noise, xi on [-sqrt(3),
    sqrt(3)], drawn on ``device`` from a generator seeded from ``(seed,
    step)``, and on a shard ring also from the rank (each rank draws for its
    own slots): the one seam where Brownian random numbers enter (tests
    replace it to replay the JAX package's draws)."""
    g = thermostat.step_generator(seed, step, device, rank)
    u = torch.rand(shape, generator=g, device=device, dtype=dtype)
    return (2.0 * u - 1.0) * SQRT3


def brownian_virial_sample(state, virial):
    """Virial sampled every 10 steps for the averaged Brownian pressure;
    returns the updated ``(virial_accum, nprom)``."""
    accum, nprom = state.virial_accum, state.nprom
    if state.step % 10 == 0:
        return accum + virial.to(accum.dtype), nprom + 1
    return accum, nprom


def make_brownian_step(params: Parameters, ensemble: Brownian, engine,
                       compensated: bool = True, hilo: bool = False):
    """Overdamped Euler-Maruyama (Ermak-McCammon) step: forces first, then
    the move ``dx = F dt / kT + xi sqrt(2 dt)`` with xi uniform on
    [-sqrt(3), sqrt(3)] (see :func:`brownian_noise`). ``hilo`` as in
    :func:`make_md_step`."""
    if hilo and not compensated:
        raise ValueError("the hi/lo pair sweep needs compensated=True: the "
                         "Kahan compensation is its low word")

    def step(state: SimulationState) -> SimulationState:
        dtype = state.dtype
        # Scalars rounded to the working dtype, as the JAX package casts
        # them before the arithmetic.
        dt = rounded(params.dt, dtype)
        ktemp = rounded(ensemble.ktemp, dtype)
        drift = rounded(dt / ktemp, dtype)
        sigma = rounded(math.sqrt(rounded(2.0 * dt, dtype)), dtype)
        cell, cell_inv = state.unitcell, state.unitcell_inv

        energy, virial, forces, nbrs = engine_forces(
            engine, state.positions, state.diameters, cell, cell_inv,
            state.nbrs, pos_lo=-state.pos_comp if hilo else None)
        noise = brownian_noise(state.seed, state.step, state.positions.shape,
                               dtype, state.device)
        dx = forces * drift + noise * sigma
        x, xc = _add(state.positions, state.pos_comp, dx, compensated)
        if compensated:
            x, xc, images = wrap_positions_compensated(x, xc, state.images,
                                                       cell, cell_inv)
        else:
            x, images = wrap_positions(x, state.images, cell, cell_inv)
        virial_accum, nprom = brownian_virial_sample(state, virial)
        return state.replace(
            positions=x, forces=forces, images=images, step=state.step + 1,
            energy=energy, virial=virial,
            temperature=torch.full((), ktemp, dtype=dtype,
                                   device=state.device),
            pos_comp=xc, nbrs=nbrs, virial_accum=virial_accum, nprom=nprom)

    return step


def make_step(params: Parameters, ensemble, engine, compensated: bool = True,
              hilo: bool = False, force_dtype=None):
    """Dispatch on the ensemble: :func:`make_brownian_step` or
    :func:`make_md_step` (``force_dtype`` is the latter's, as in the JAX
    package)."""
    if isinstance(ensemble, Brownian):
        return make_brownian_step(params, ensemble, engine, compensated,
                                  hilo=hilo)
    return make_md_step(params, ensemble, engine, compensated, hilo=hilo,
                        force_dtype=force_dtype)
