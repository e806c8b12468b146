"""The velocity-Verlet step with NVE/NVT ensemble logic, and the overdamped
Brownian step.

Counterpart of ``mdtpu/integrate/step.py`` (``engine_forces``,
``md_velocity_finish``, ``brownian_noise``, ``brownian_virial_sample``,
``make_md_step``, ``make_brownian_step``, ``make_step``). A step is a
plain function ``step(state) -> state``; its chain runs through the
kernels of :mod:`mdtpu_torch.integrate.verlet_update` on the card and
their plain versions on the CPU. The driver advances a segment of them
with :func:`make_particle_advance`, as the JAX package's ``fori_loop``
over ``make_step``: on the card one CUDA graph a step, the rebuild decided
on the device.

Initial forces of MD runs are computed at state construction (the reference
starts its first half-kick with zero forces); a Brownian step computes its
forces first.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mdtpu_torch.core.types import (NVE, NVT, Brownian, ConstantSchedule,
                                    Parameters, SimulationState)
from mdtpu_torch.integrate import thermostat, verlet_update
from mdtpu_torch.integrate.device_advance import (DeviceAdvance, clone,
                                                  copy_into)
from mdtpu_torch.integrate.velocity_finish import (finish_pair,
                                                   velocity_finish)
from mdtpu_torch.ops import philox_draws
from mdtpu_torch.utils import counters
from mdtpu_torch.utils.math import kahan_add

SQRT3 = math.sqrt(3.0)


def refresh_nbrs(engine, positions, diameters, cell, cell_inv, nbrs):
    """The engine state for ``positions``: a first build where ``nbrs`` is
    None, else a rebuild where the engine's drift test says so. A test
    that is a tensor is read on the host (one synchronisation); a static
    answer (the naive engine's False) makes no test. A rebuilt binning
    keeps an earlier overflow flag set, so the driver sees every overflow
    of a segment."""
    if nbrs is None:
        return engine.allocate(positions, diameters, cell, cell_inv)
    rebuild = engine.needs_rebuild(positions, nbrs, cell, cell_inv)
    if bool(rebuild):
        fresh = engine.allocate(positions, diameters, cell, cell_inv)
        nbrs = dataclasses.replace(fresh,
                                   overflow=fresh.overflow | nbrs.overflow)
    return nbrs


def _compute(engine, positions, diameters, cell, cell_inv, nbrs, pos_lo):
    if pos_lo is None:
        return engine.compute(positions, diameters, cell, cell_inv, nbrs)
    return engine.compute(positions, diameters, cell, cell_inv, nbrs,
                          pos_lo=pos_lo)


def engine_forces(engine, positions, diameters, cell, cell_inv, nbrs,
                  pos_lo=None, force_dtype=None):
    """Evaluate forces, rebuilding the engine's neighbour state when stale
    (:func:`refresh_nbrs`). ``pos_lo``: the positions' low words, for the
    hi/lo sweep of a cell-grid engine. ``force_dtype``: positions,
    diameters and cell are cast to it first, so the whole evaluation (and
    the engine state) runs in that dtype; the results come back in it."""
    if force_dtype is not None and positions.dtype != force_dtype:
        positions = positions.to(force_dtype)
        diameters = diameters.to(force_dtype)
        cell = cell.to(force_dtype)
        cell_inv = cell_inv.to(force_dtype)
    nbrs = refresh_nbrs(engine, positions, diameters, cell, cell_inv, nbrs)
    return _compute(engine, positions, diameters, cell, cell_inv, nbrs,
                    pos_lo)


def _step_forces(engine, x, state, refresh, pos_lo=None, force_dtype=None):
    """A step's forces at ``x``: :func:`engine_forces` where ``refresh`` is
    None; else ``refresh()`` first, the particle advance's drift test and
    rebuild on its buffers (``state.nbrs``, rebuilt in place), then the
    engine's sweep."""
    if refresh is None:
        return engine_forces(engine, x, state.diameters, state.unitcell,
                             state.unitcell_inv, state.nbrs, pos_lo=pos_lo,
                             force_dtype=force_dtype)
    refresh()
    return _compute(engine, x, state.diameters, state.unitcell,
                    state.unitcell_inv, state.nbrs, pos_lo)


def _add(x, comp, dx, compensated: bool):
    if compensated:
        return kahan_add(x, comp, dx)
    return x + dx, comp


def finish_scalars(ensemble, v, state, dt, ring=None, ktemp=None,
                   out=None):
    """``(scale, temperature)`` of the post-kick ensemble logic as 0-d
    tensors: Bussi's factor and the temperature after it for NVT (one
    kinetic reduction serves both, T_after = scale^2 * 2K/nf), ``(1, the
    temperature)`` for NVE. ``ring``: a shard ring, over which the kinetic
    energy is summed (one all-reduce a step); Bussi's draws are the same on
    every rank. ``state.step`` is a host int or a 0-d int64 device tensor;
    ``ktemp``: NVT's target for this step, ``ensemble.ktemp(step + 1)`` (a
    0-d tensor or a
    :class:`~mdtpu_torch.integrate.velocity_finish.TargetTable`, as the
    slot advance reads it from its device table; evaluated here from a host
    step where it is None). ``out``: a ``(2,)`` tensor that receives both.

    The scalar tail is :func:`~mdtpu_torch.integrate.velocity_finish.
    velocity_finish`: on the card one kernel, which also sums the kinetic
    energy off a ring; on the CPU the torch composition on
    ``thermostat.compute_kinetic``."""
    nvt = isinstance(ensemble, NVT)
    if nvt and ktemp is None:
        ktemp = ensemble.ktemp(state.step + 1)
    kinetic = None if v.is_cuda and ring is None else \
        thermostat.compute_kinetic(v, ring)
    return velocity_finish(
        v if kinetic is None else None, kinetic, state.seed, state.step,
        state.nf, dt, ensemble.tau if nvt else None, ktemp if nvt else None,
        out)


def md_velocity_finish(ensemble, v, vc, state, dt, compensated: bool,
                       ring=None, ktemp=None):
    """Post-kick ensemble logic: :func:`finish_scalars`, then for NVT the
    velocities times the scale and the compensation zeroed. Returns ``(v,
    vc, temperature)``."""
    scale, temperature = finish_scalars(ensemble, v, state, dt, ring, ktemp)
    if isinstance(ensemble, NVT):
        v = v * scale
        if compensated:
            # Rescaling invalidates the velocity compensation buffer.
            vc = vc.new_zeros(vc.shape)
    return v, vc, temperature


def make_md_step(params: Parameters, ensemble, engine,
                 compensated: bool = True, hilo: bool = False,
                 force_dtype=None, in_place: bool = False):
    """Velocity-Verlet step with NVE/NVT ensemble logic. ``hilo``: the pair
    sweep takes each position as the pair (x, -pos_comp), the hi/lo
    (f32x2) sweep of a cell-grid engine; needs ``compensated``.
    ``force_dtype``: mixed precision, the pair sweep in this dtype (up or
    down) while the state integrates in its own; energy, virial and forces
    are cast back. Not with ``hilo``.

    The chain runs through :mod:`mdtpu_torch.integrate.verlet_update`: on
    the card the half-kick, drift and wrap as one launch
    (:func:`~mdtpu_torch.integrate.verlet_update.kick_drift_wrap`), the
    engine's forces, the kick, the velocity finish and NVT's rescale, the
    chain's last launch advancing a device step counter; on the CPU their
    plain versions, the torch composition. ``in_place``: the step writes
    into the state's own tensors (the particle advance's buffers:
    positions, velocities, compensations, images, the step counter and the
    temperature, a :func:`~mdtpu_torch.integrate.velocity_finish.
    finish_buffer`); else it returns new tensors and leaves the state as
    it was.

    ``step(state, ktemp=None, refresh=None)``: ``state.step`` a host int or
    a 0-d int64 device tensor; ``ktemp``: NVT's target for this step (None:
    evaluated from the step); ``refresh``: called between the drift and
    the sweep in place of the engine's own test and rebuild (the particle
    advance's, on its buffers; not with ``force_dtype``)."""
    if isinstance(ensemble, Brownian):
        raise TypeError("use make_brownian_step for Brownian dynamics")
    if not isinstance(ensemble, (NVT, NVE)):
        raise TypeError(f"unknown ensemble type: {type(ensemble).__name__}")
    if hilo and (force_dtype is not None or not compensated):
        raise ValueError("the hi/lo pair sweep needs compensated=True (the "
                         "Kahan compensation is its low word) and no "
                         "force_dtype (it is the precision mechanism)")
    nvt = isinstance(ensemble, NVT)

    def step(state: SimulationState, ktemp=None,
             refresh=None) -> SimulationState:
        if refresh is not None and force_dtype is not None:
            raise ValueError("refresh takes no force_dtype")
        dt = float(params.dt)
        half = 0.5 * dt

        # First half-kick, drift and wrap. The compensation holds the
        # negated low word (true = x - comp), the hi/lo sweep's lo.
        lo = torch.empty_like(state.pos_comp) if hilo else None
        v, vc, x, xc, images = verlet_update.kick_drift_wrap(
            state.forces, state.velocities, state.vel_comp, state.positions,
            state.pos_comp, state.images, state.unitcell, state.unitcell_inv,
            half, dt, compensated, lo=lo,
            out=(state.velocities, state.vel_comp, state.positions,
                 state.pos_comp, state.images) if in_place else None)

        energy, virial, forces, nbrs = _step_forces(
            engine, x, state, refresh, lo, force_dtype)
        if forces.dtype != x.dtype:
            forces, energy, virial = (t.to(x.dtype)
                                      for t in (forces, energy, virial))

        # Second half-kick and the ensemble logic; a device counter is
        # advanced by the chain's last launch, since the velocity finish
        # reads the step's own.
        step, counter = state.step, ()
        if isinstance(step, torch.Tensor):
            counter = (step, step if in_place else torch.empty_like(step))
            step = counter[1]
        else:
            step = step + 1
        verlet_update.kick(forces, v, vc, half, compensated,
                           *(() if nvt else counter))
        scale, temperature = finish_scalars(
            ensemble, v, state, dt, None, ktemp,
            out=finish_pair(state.temperature) if in_place else None)
        if in_place:
            temperature = state.temperature
        if nvt:
            verlet_update.rescale(v, vc, scale, compensated, *counter)
        return state.replace(
            positions=x, velocities=v, forces=forces, images=images,
            step=step, energy=energy, virial=virial,
            temperature=temperature, pos_comp=xc, vel_comp=vc, nbrs=nbrs)

    return step


def brownian_noise(seed: int, step, shape, dtype, device, rank=None):
    """The reference's variance-matched uniform noise, xi on [-sqrt(3),
    sqrt(3)], of ``shape`` on ``device``, a function of ``(seed, step)``
    and on a shard ring also of the rank (each rank draws for its own
    slots): the one seam where Brownian random numbers enter (tests replace
    it to replay the JAX package's draws). ``step``: a host int or a 0-d
    int64 device tensor. On the card a kernel draws it
    (:func:`mdtpu_torch.ops.philox_draws.uniform_noise`), on the CPU its
    plain version, with the same bits."""
    return philox_draws.uniform_noise(seed, step, shape, dtype, rank,
                                      device=device)


def brownian_virial_sample(state, virial):
    """Virial sampled every 10 steps for the averaged Brownian pressure;
    returns the updated ``(virial_accum, nprom)``. The cadence is decided
    on the device (``state.step`` may be a device tensor)."""
    take = state.step % 10 == 0
    if not isinstance(take, torch.Tensor):
        take = torch.full((), take, dtype=torch.bool, device=virial.device)
    accum, nprom = state.virial_accum, state.nprom
    return (accum + torch.where(take, virial.to(accum.dtype), 0.0),
            nprom + take.to(nprom.dtype))


def make_brownian_step(params: Parameters, ensemble: Brownian, engine,
                       compensated: bool = True, hilo: bool = False,
                       in_place: bool = False):
    """Overdamped Euler-Maruyama (Ermak-McCammon) step: forces first, then
    the move ``dx = F dt / kT + xi sqrt(2 dt)`` with xi uniform on
    [-sqrt(3), sqrt(3)] (see :func:`brownian_noise`) and the wrap. ``hilo``
    as in :func:`make_md_step`.

    The move runs through :func:`mdtpu_torch.integrate.verlet_update.
    brownian_rows`: on the card one launch that draws the noise, moves and
    wraps the positions and writes the step's scalars; on the CPU its
    plain version, the torch composition (the noise through
    :func:`brownian_noise`). ``in_place`` and ``step(state, ktemp=None,
    refresh=None)`` as in :func:`make_md_step` (``ktemp`` unused;
    ``refresh`` called before the sweep)."""
    if hilo and not compensated:
        raise ValueError("the hi/lo pair sweep needs compensated=True: the "
                         "Kahan compensation is its low word")

    def step(state: SimulationState, ktemp=None,
             refresh=None) -> SimulationState:
        drift, sigma, kt = verlet_update.brownian_coefficients(
            params.dt, ensemble.ktemp, state.dtype)
        energy, virial, forces, nbrs = _step_forces(
            engine, state.positions, state, refresh,
            -state.pos_comp if hilo else None)
        x, xc, images, step, virial_accum, nprom, temperature = \
            verlet_update.brownian_rows(forces, virial, state, drift, sigma,
                                        kt, compensated, in_place)
        return state.replace(
            positions=x, forces=forces, images=images, step=step,
            energy=energy, virial=virial, temperature=temperature,
            pos_comp=xc, nbrs=nbrs, virial_accum=virial_accum, nprom=nprom)

    return step


def make_step(params: Parameters, ensemble, engine, compensated: bool = True,
              hilo: bool = False, force_dtype=None, in_place: bool = False):
    """Dispatch on the ensemble: :func:`make_brownian_step` or
    :func:`make_md_step` (``force_dtype`` is the latter's, as in the JAX
    package)."""
    if isinstance(ensemble, Brownian):
        return make_brownian_step(params, ensemble, engine, compensated,
                                  hilo=hilo, in_place=in_place)
    return make_md_step(params, ensemble, engine, compensated, hilo=hilo,
                        force_dtype=force_dtype, in_place=in_place)


class ParticleAdvance(DeviceAdvance):
    """``advance(state, k) -> state`` after ``k`` particle-order steps on
    one device, as the JAX package runs a segment (``fori_loop`` over
    ``make_step``): the step counter, NVT's target and the rebuild
    decision on the device
    (:class:`~mdtpu_torch.integrate.device_advance.DeviceAdvance`).

    Each step runs on the buffers in place (``make_step(...,
    in_place=True)``): the kick-drift-wrap, then the engine's drift test
    (its ``needs_rebuild`` with ``out=`` and ``handle=``) and
    ``engine.allocate`` inside :func:`device_if`, then the sweep, the
    kick, the velocity finish and NVT's rescale; a Brownian step tests and
    rebuilds first, then sweeps and moves. A rebuild copies the new engine
    state into the buffers, the reference positions into a tensor of
    their own, the overflow kept sticky. An engine whose test is the static
    ``False`` (the naive engine's) makes no test and has no IF node.
    ``graph`` as :func:`make_particle_advance` says; ``census["step"]``
    holds a captured step's nodes. ``steps`` and ``graph_steps`` count the
    steps all advances ran, and those of them run as graph launches."""

    steps = graph_steps = 0

    def __init__(self, step_fn, first_fn, engine, ensemble, graph):
        super().__init__(engine, ensemble, graph)
        self.step_fn, self.first_fn = step_fn, first_fn
        self._untested = False
        # A constant target goes to the finish as the host number the step
        # loop gives it (a number is rounded as the step loop rounds it); a
        # schedule's targets come from the device table.
        self._constant = None
        if isinstance(self.schedule, ConstantSchedule):
            self._constant, self.schedule = float(self.schedule.value), None

    def _target(self):
        return (self._constant if self._constant is not None
                else super()._target())

    def _test(self, b, flag, handle):
        if not self._untested:
            self.engine.needs_rebuild(b.positions, b.nbrs, b.unitcell,
                                      b.unitcell_inv, out=flag,
                                      handle=handle)

    def _rebuilt(self, b):
        if self._untested:
            return b
        fresh = self.engine.allocate(b.positions, b.diameters, b.unitcell,
                                     b.unitcell_inv)
        return b.replace(nbrs=dataclasses.replace(
            fresh, overflow=fresh.overflow | b.nbrs.overflow))

    def _refresh(self):
        if not self._untested:
            super()._refresh()

    def _step(self, b, step_fn, refresh):
        copy_into(b, step_fn(b, self._target(), refresh))

    def _never_rebuilds(self, state):
        """Whether the engine's drift test is the static ``False`` (the
        naive engine's: no test a step, no IF node); its launch, if any, is
        not counted."""
        before = counters.snapshot()
        answer = self.engine.needs_rebuild(state.positions, state.nbrs,
                                           state.unitcell,
                                           state.unitcell_inv)
        counters.restore(before)
        return answer is False

    def _run(self, name, step_fn, times):
        super()._run(name, step_fn, times)
        ParticleAdvance.steps += max(times, 0)
        if self.graph:
            ParticleAdvance.graph_steps += max(times, 0)

    def __call__(self, state: SimulationState, k: int) -> SimulationState:
        if k <= 0:
            return state
        if state.nbrs is None:
            # The first build comes with the first step, as the JAX
            # package's structure-changing first build does.
            state, k = self.first_fn(state), k - 1
            if k == 0:
                return state
        self._resolve_graph(state)
        if self.bufs is None:
            self._untested = self._never_rebuilds(state)
        base = state.step
        self._load(state)
        self._fill_table(base, k)
        self._run("step", self.step_fn, k)
        return clone(self.bufs, base + k)


def make_particle_advance(params: Parameters, ensemble, engine,
                          compensated: bool = True, hilo: bool = False,
                          graph=None):
    """``advance(state, k) -> state`` after ``k`` particle-order steps of
    :func:`make_step`, a :class:`ParticleAdvance`: the route of every
    engine that does not run in slots (``PlaneEngine``, the neighbour
    list, the naive engine) and of any run with ``compensated=False``.

    ``graph``: None captures the segment into a CUDA graph on the card (one
    graph launch a segment, no host read inside it), a potential without a
    kernel functor too (its ``evaluate_r2`` on the naive engine's or the
    neighbour list's tiles captured, under the capture contract of
    :mod:`mdtpu_torch.potentials.base`), and runs eagerly on the CPU;
    False runs eagerly on the card too (the rebuild flag read on the host
    once a step); True asks for the graphs (raises on the CPU). The steps,
    the rebuild steps and the bits are those of :func:`make_step` in a
    loop."""
    step = make_step(params, ensemble, engine, compensated, hilo=hilo,
                     in_place=True)
    first = make_step(params, ensemble, engine, compensated, hilo=hilo)
    return ParticleAdvance(step, first, engine, ensemble, graph)
