"""FIRE (Fast Inertial Relaxation Engine) energy minimizer.

Counterpart of ``mdtpu/minimize/fire.py``: the defaults of the reference's
code (f_inc 1.2, f_dec 0.2, dt in [0.01, 0.1], alpha0 0.1, Nmin 5, tol 1e-6
on the RMS force |F| / sqrt(ndof), ndof = d (N - 1)), a per-particle
displacement cap ``dmax``, velocities reset to true zeros when the power
turns negative, and one return shape ``(state, energy, converged, n_steps)``
whether or not it converged.

A cell-grid engine runs FIRE in the slot layout (:func:`make_slot_fire`, as
the dynamics' slot loop: no scatter or gather per force evaluation, the wrap
deferred to rebuilds, the lean sweep inside the loop and one full sweep at
exit); other engines run it in particle order (:func:`_fire_once`). The
iteration's scalars (dt, alpha, the steps since the power turned negative)
stay on the device; each iteration reads one stack of flags on the host
(the force test, and in slots the rebuild and overflow flags).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mdtpu_torch.core.box import wrap_positions
from mdtpu_torch.core.types import Parameters, SimulationState
from mdtpu_torch.integrate import slot_step as slots
from mdtpu_torch.integrate.step import engine_forces
from mdtpu_torch.utils.device import resolve_device


def fire_minimize(state: SimulationState, params: Parameters, engine, *,
                  max_steps: int = 10000, tol: float = 1e-6,
                  dt_initial: float = 0.01, dt_max: float = 0.1,
                  alpha0: float = 0.1, f_inc: float = 1.2, f_dec: float = 0.2,
                  n_min: int = 5, dmax: float = 0.1, device=None):
    """Minimize the potential energy of ``state``. Returns ``(new_state,
    energy, converged, n_steps)``. ``device``: where it runs, ``"cuda"`` by
    default (raises without a card unless the caller passes ``"cpu"``).

    Engine capacity overflow would truncate forces and let the force test
    converge on a configuration that still has contacts: the run is retried
    from the start with a grown capacity until the overflow flag clears."""
    from mdtpu_torch.core.types import state_to

    state = state_to(state, resolve_device(device))
    hyper = dict(max_steps=max_steps, tol=tol, dt_initial=dt_initial,
                 dt_max=dt_max, alpha0=alpha0, f_inc=f_inc, f_dec=f_dec,
                 n_min=n_min, dmax=dmax)
    if getattr(engine, "runs_in_slots", False):
        return _fire_slots_with_retries(state, params, engine, **hyper)
    caller_engine = engine
    grew = False
    for _ in range(slots.MAX_GROWS):
        out = _fire_once(state, params, engine, **hyper)
        new_state = out[0]
        over = getattr(new_state.nbrs, "overflow", None)
        grow = getattr(engine, "with_grown_capacity", None)
        if over is None or not bool(over) or grow is None:
            if grew:
                # The state's engine state must match the caller's engine.
                nbrs = caller_engine.allocate(
                    new_state.positions, new_state.diameters,
                    new_state.unitcell, new_state.unitcell_inv)
                return (new_state.replace(nbrs=nbrs),) + tuple(out[1:])
            return out
        grew = True
        engine = grow()
        state = state.replace(nbrs=None)
    raise RuntimeError(
        "engine capacity still overflowing after 8 grows during FIRE "
        "minimization: forces would be silently truncated")


def _safe_norm(a, dim=None, keepdim=False):
    """The Euclidean norm scaled by max |a| first, so that no intermediate
    squares a raw value (the forces of an overlapping start can be ~1e25)."""
    if dim is None:
        m = torch.max(torch.abs(a))
        m_safe = torch.where(m > 0, m, torch.ones_like(m))
        return torch.sqrt(torch.sum((a / m_safe) ** 2)) * m
    m = torch.amax(torch.abs(a), dim=dim, keepdim=True)
    m_safe = torch.where(m > 0, m, torch.ones_like(m))
    r = torch.sqrt(torch.sum((a / m_safe) ** 2, dim=dim, keepdim=True)) * m
    return r if keepdim else r.squeeze(dim)


class _Scalars(NamedTuple):
    """FIRE's adaptive scalars, 0-d tensors on the device."""

    dt: torch.Tensor
    alpha: torch.Tensor
    steps_since_neg: torch.Tensor


def _identity(x):
    return x


def _fire_update(v, forces, sc: _Scalars, *, alpha0, f_inc, f_dec, n_min,
                 dt_initial, dt_max, dmax, disp_dim, gmax=_identity,
                 gsum=_identity):
    """One FIRE update on the device, shared by both layouts: the inertia
    mix, the dt / alpha adaptation and the capped displacement. ``v`` is the
    velocity after the kick; ``disp_dim`` the axis of a particle's
    components (-1 in particle order, 0 in slots). ``gmax`` and ``gsum``
    take a rank's maximum and sum to the global ones (a shard ring's
    all-reduces). Returns ``(v, disp, scalars)``."""
    vmax = gmax(torch.max(torch.abs(v)))
    fmax = gmax(torch.max(torch.abs(forces)))
    vmax_s = torch.where(vmax > 0, vmax, torch.ones_like(vmax))
    fmax_s = torch.where(fmax > 0, fmax, torch.ones_like(fmax))
    # Only the sign of P = sum(v . F) matters: computed on max-normalised
    # copies.
    power = gsum(torch.sum((v / vmax_s) * (forces / fmax_s)))
    vn = torch.sqrt(gsum(torch.sum((v / vmax_s) ** 2)))
    fn = torch.sqrt(gsum(torch.sum((forces / fmax_s) ** 2)))
    do_mix = (vmax > 0) & (fmax > 0)
    scale = sc.alpha * (vmax_s / fmax_s) * (
        vn / torch.where(fn > 0, fn, torch.ones_like(fn)))
    v = torch.where(do_mix, (1.0 - sc.alpha) * v + scale * forces, v)

    positive = power > 0
    ssn_pos = sc.steps_since_neg + 1
    grow = ssn_pos > n_min
    dt_pos = torch.where(grow, torch.clamp(sc.dt * f_inc, max=dt_max), sc.dt)
    alpha_pos = torch.where(grow, sc.alpha * 0.99, sc.alpha)
    dt_neg = torch.clamp(sc.dt * f_dec, min=dt_initial)
    dt = torch.where(positive, dt_pos, dt_neg)
    alpha = torch.where(positive, alpha_pos,
                        torch.full_like(sc.alpha, alpha0))
    ssn = torch.where(positive, ssn_pos, torch.zeros_like(ssn_pos))
    v = torch.where(positive, v, torch.zeros_like(v))

    # LAMMPS-style per-particle displacement cap, so steep potentials (or
    # overlapping float32 starts) cannot explode the step.
    disp = dt * v
    dnorm = _safe_norm(disp, dim=disp_dim, keepdim=True)
    dnorm = torch.where(torch.isfinite(dnorm), dnorm,
                        torch.full_like(dnorm, float("inf")))
    cap = torch.clamp(dmax / torch.clamp(dnorm, min=1e-30), max=1.0)
    disp = torch.where(torch.isfinite(disp), disp * cap,
                       torch.zeros_like(disp))
    return v, disp, _Scalars(dt, alpha, ssn)


def _initial_scalars(dtype, device, dt_initial, alpha0):
    return _Scalars(torch.full((), dt_initial, dtype=dtype, device=device),
                    torch.full((), alpha0, dtype=dtype, device=device),
                    torch.zeros((), dtype=torch.int64, device=device))


def _fire_once(state: SimulationState, params: Parameters, engine, *,
               max_steps, tol, dt_initial, dt_max, alpha0, f_inc, f_dec,
               n_min, dmax):
    """FIRE in particle order (the loop of ``NaivePairEngine``); each
    iteration reads the force test on the host."""
    n, dim = state.n_particles, state.dimension
    ndof = float(dim * (n - 1.0))
    cell, cell_inv = state.unitcell, state.unitcell_inv
    diameters = state.diameters
    nbrs = state.nbrs
    if nbrs is None:
        nbrs = engine.allocate(state.positions, diameters, cell, cell_inv)

    energy, virial, forces, nbrs = engine_forces(
        engine, state.positions, diameters, cell, cell_inv, nbrs)
    f_rms = _safe_norm(forces) / ndof ** 0.5
    positions, images = state.positions, state.images
    v = torch.zeros_like(positions)
    sc = _initial_scalars(state.dtype, state.device, dt_initial, alpha0)
    step = 0
    while step < max_steps and bool(f_rms >= tol):
        v, disp, sc = _fire_update(
            v + sc.dt * forces, forces, sc, alpha0=alpha0, f_inc=f_inc,
            f_dec=f_dec, n_min=n_min, dt_initial=dt_initial, dt_max=dt_max,
            dmax=dmax, disp_dim=-1)
        positions, images = wrap_positions(positions + disp, images, cell,
                                           cell_inv)
        energy, virial, forces, nbrs = engine_forces(
            engine, positions, diameters, cell, cell_inv, nbrs)
        f_rms = _safe_norm(forces) / ndof ** 0.5
        step += 1

    new_state = state.replace(positions=positions, images=images,
                              forces=forces, energy=energy, virial=virial,
                              nbrs=nbrs)
    return new_state, energy, bool(f_rms < tol), step


# --------------------------------------------------------------- slot space


def make_slot_fire(engine, *, max_steps=10000, tol=1e-6, dt_initial=0.01,
                   dt_max=0.1, alpha0=0.1, f_inc=1.2, f_dec=0.2, n_min=5,
                   dmax=0.1, ring=None):
    """``run(slot_state) -> (slot_state, f_rms, converged, n_steps,
    overflow)``: the whole minimization over a slot-layout state, whose
    ``velocities`` carry FIRE's own velocity (vacant slots hold zeros and
    never move, so every reduction is exact).

    Each iteration reads ``[f_rms >= tol, rebuild, overflow]`` in one host
    read. A rebuild (unconditional on entry, then whenever a particle
    drifted past skin/2) reads its overflow flag once more. Forces inside
    the loop come from the lean sweep; one full sweep at exit refreshes
    energy and virial. ``overflow`` is sticky: a True run must be retried
    from the original state at a grown capacity (an overflowed rebin drops
    rows).

    ``ring``: the shard ring of a sharded state (the engine a
    :class:`mdtpu_torch.parallel.HaloSlotEngine`, whose rebuild migrates
    rows): the RMS force, the power and the norms are summed over it, the
    maxima taken over it, and every flag read on the host is the ring's,
    so all ranks run the same iterations."""
    gsum = _identity if ring is None else ring.sum
    gmax = _identity if ring is None else ring.max
    update = dict(alpha0=alpha0, f_inc=f_inc, f_dec=f_dec, n_min=n_min,
                  dt_initial=dt_initial, dt_max=dt_max, dmax=dmax,
                  disp_dim=0, gmax=gmax, gsum=gsum)

    def f_rms_of(forces, ndof):
        m = gmax(torch.max(torch.abs(forces)))
        m_safe = torch.where(m > 0, m, torch.ones_like(m))
        norm = torch.sqrt(gsum(torch.sum((forces / m_safe) ** 2))) * m
        return norm / ndof ** 0.5

    def flags(*values):
        local = torch.stack([torch.as_tensor(v, device=values[0].device)
                             for v in values])
        return (local if ring is None else ring.any(local)).tolist()

    def run(state):
        ndof = float(state.nf)
        state = state.replace(velocities=torch.zeros_like(state.velocities),
                              vel_comp=torch.zeros_like(state.vel_comp))
        state = slots.slot_forces(state, engine)
        f_rms = f_rms_of(state.forces, ndof)
        sc = _initial_scalars(state.dtype, state.device, dt_initial, alpha0)
        step = 0
        going, ovf = flags(f_rms >= tol, state.nbrs.overflow)
        while step < max_steps and going and not ovf:
            state = slots._engine_rebin(state, engine)
            ovf, = flags(state.nbrs.overflow)
            rebuild = False
            while step < max_steps and going and not rebuild and not ovf:
                v, disp, sc = _fire_update(
                    state.velocities + sc.dt * state.forces, state.forces,
                    sc, **update)
                # The wrap is deferred to the rebin, as in the dynamics.
                state = slots.slot_forces(
                    state.replace(positions=state.positions + disp,
                                  velocities=v), engine, observables=False)
                f_rms = f_rms_of(state.forces, ndof)
                step += 1
                going, rebuild, ovf = flags(
                    f_rms >= tol, slots.slot_needs_rebin(state, engine),
                    state.nbrs.overflow)
        state = slots.slot_forces(state, engine)
        return state, f_rms, bool(f_rms < tol) and not ovf, step, ovf

    return run


def fire_minimize_slots(state: SimulationState, engine, **hyper):
    """FIRE over an already slotified state. Returns ``(slot_state, f_rms,
    converged, n_steps, overflow)``; the state's ``velocities`` hold FIRE's
    own velocity."""
    return make_slot_fire(engine, **hyper)(state)


def _fire_slots_with_retries(state, params, engine, **hyper):
    """Particle order in and out over the slot FIRE: slotify, run,
    unslotify, restore the caller's velocities. On capacity overflow
    (initial binning or a rebin in the loop) retry from the original state
    at a grown capacity."""
    velocities0 = state.velocities
    start = state.replace(nbrs=None)
    for _ in range(slots.MAX_GROWS):
        slot_state, engine = slots.slotify_grown(start, engine)
        slot_state, _, converged, n_steps, ovf = fire_minimize_slots(
            slot_state, engine, **hyper)
        if not ovf:
            out = slots.unslotify_state(slot_state)
            out = out.replace(velocities=velocities0)
            return out, out.energy, converged, n_steps
        engine = engine.with_grown_capacity()
    raise RuntimeError(
        "engine capacity still overflowing after 8 grows during FIRE "
        "minimization: forces would be silently truncated")


def fire_minimize_sharded(state: SimulationState, params: Parameters,
                          engine=None, group=None, *, device=None, **hyper):
    """FIRE over the ranks of a shard ring, the counterpart of the JAX
    package's ``fire_minimize_sharded``: ``state`` is an ``(N, d)``
    particle-order state (the same on every rank), ``engine`` a
    :class:`mdtpu_torch.parallel.HaloSlotEngine` (default: one made over
    the ring of ``group`` and ``device``, as ``run_simulation_sharded``
    makes it). The slot FIRE of :func:`make_slot_fire` runs on each rank's
    slab with the ring's reductions. Returns ``(state, energy, converged,
    n_steps)`` in particle order on every rank, with the caller's
    velocities; on a capacity or migration overflow the run is retried from
    the start on a grown engine."""
    from mdtpu_torch.core.types import state_to
    from mdtpu_torch.parallel.driver import build_grown, sharded_engine
    from mdtpu_torch.parallel.halo_slot import unshard_slot_state

    engine = sharded_engine(state, params.potential, engine, group, device)
    ring = engine.ring
    start = state_to(state.replace(nbrs=None, ids=None), ring.device)
    velocities0 = start.velocities
    for _ in range(slots.MAX_GROWS):
        sh, engine = build_grown(start, engine)
        sh, _, converged, n_steps, ovf = make_slot_fire(
            engine, ring=ring, **hyper)(sh)
        if not ovf:
            out = unshard_slot_state(sh, ring).replace(velocities=velocities0)
            return out, out.energy, converged, n_steps
        engine = engine.with_grown_capacity()
    raise RuntimeError(
        "engine capacity still overflowing after 8 grows during sharded "
        "FIRE minimization: forces would be silently truncated")
