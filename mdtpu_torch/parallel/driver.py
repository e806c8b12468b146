"""``run_simulation_sharded``: ``run_simulation`` over the ranks of a shard
ring.

Counterpart of ``mdtpu/parallel/driver.py``. The state lives sharded in
cell-sorted slot order (:class:`~mdtpu_torch.parallel.halo_slot
.HaloSlotEngine`): rows migrate between ranks on the device at every
rebuild, and the event loop is the single-device driver's
(``mdtpu_torch.sim.driver._drive_events``): the same schedule, health reads
(all-reduced, so every rank takes the same branch), restore-and-grow after
an overflow of a cell or of a migration buffer, and the same files. Rank 0
opens and writes every file; every rank takes part in the gathers that
frames and checkpoints need. Particle identity rides the ``ids`` rows, so
frames come out in the original particle order.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from mdtpu_torch.core.box import box_volume
from mdtpu_torch.core.types import NVE, Brownian, SimulationState, state_to
from mdtpu_torch.integrate import slot_step as slots
from mdtpu_torch.io.compress import require_libzstd
from mdtpu_torch.io.xyz import write_xyz
from mdtpu_torch.parallel.halo_slot import (HaloSlotEngine,
                                            build_sharded_slot_state,
                                            make_sharded_slot_advance,
                                            unshard_slot_state)
from mdtpu_torch.parallel.mesh import ShardRing
from mdtpu_torch.utils.profiling import StepRateMeter


def sharded_engine(state, potential, engine, group, device):
    """The run's engine: ``engine`` (a :class:`HaloSlotEngine`, which
    carries its ring) or one made for ``state`` over the ring of ``group``
    and ``device``. ``TypeError`` for any other engine."""
    if engine is None:
        ring = ShardRing(group, device)
        return HaloSlotEngine.create(potential, float(state.cutoff),
                                     state.unitcell, state.n_particles, ring,
                                     diameters=state.diameters)
    if not isinstance(engine, HaloSlotEngine):
        raise TypeError(
            f"the sharded driver runs the slot-layout HaloSlotEngine only "
            f"(got {type(engine).__name__})")
    return engine


def build_grown(state, engine):
    """:func:`build_sharded_slot_state`, growing the engine until the
    initial binning fits. Returns ``(sharded_state, engine)``."""
    for _ in range(slots.MAX_GROWS + 1):
        try:
            return build_sharded_slot_state(state, engine), engine
        except slots.CapacityOverflowError:
            engine = engine.with_grown_capacity()
    raise RuntimeError(
        f"cell capacity still overflowing after {slots.MAX_GROWS} grows")


def run_simulation_sharded(
    state: SimulationState,
    params,
    ensemble,
    total_steps: int,
    frequency: int,
    pathname: str,
    *,
    group=None,
    device=None,
    engine: Optional[HaloSlotEngine] = None,
    compensated: bool = True,
    traj_name: str = "trajectory.xyz",
    thermo_name: str = "thermo.txt",
    compress: bool = False,
    log_times: bool = False,
    checkpoint_every: Optional[int] = None,
    precision: str = "auto",
    traj_frequency: Optional[int] = None,
    perf_log: bool = False,
) -> SimulationState:
    """Run ``total_steps`` over the ranks of ``group`` (a
    ``torch.distributed`` group; the default group where one is initialised;
    else a ring of one). Every rank calls it with the same ``(N, d)``
    particle-order state and gets the final state back in particle order,
    as ``run_simulation`` returns it (without engine state). The keywords
    are ``run_simulation``'s.

    ``device``: the rank's device, ``cuda:{rank % device_count}`` by
    default; ``"cpu"`` for the CPU ranks of a gloo group. ``engine``: a
    :class:`HaloSlotEngine` (default: ``HaloSlotEngine.create`` over the
    ring), whose ring then is the run's. ``precision``: as in
    ``run_simulation``; ``"auto"`` runs the hi/lo sweep for float32 NVE."""
    from mdtpu_torch.sim.driver import (_drive_events, _event_schedule,
                                        _frame_rows, prepare_output_files)

    if precision not in ("auto", "f32x2", "plain"):
        raise ValueError(
            f"precision must be auto/f32x2/plain, got {precision!r}")
    if compress:
        require_libzstd()
    engine = sharded_engine(state, params.potential, engine, group, device)
    ring = engine.ring
    state = state_to(state.replace(nbrs=None, ids=None), ring.device)
    if precision == "f32x2" and (state.dtype != torch.float32
                                 or not compensated):
        raise ValueError("precision='f32x2' (the hi/lo pair sweep) takes a "
                         "float32 state and compensated=True")
    hilo = (precision == "f32x2"
            or (precision == "auto" and isinstance(ensemble, NVE)
                and state.dtype == torch.float32 and compensated))

    potential = params.potential
    volume = box_volume(state.unitcell)
    dim, n = state.dimension, state.n_particles
    consts = dict(n=n, dim=dim, volume=volume, density=float(params.density),
                  e_lrc=float(potential.energy_lrc(n, volume)),
                  p_lrc=float(potential.pressure_lrc(n, volume)))
    diameters_np = state.diameters.cpu().numpy()
    unitcell_np = state.unitcell.cpu().numpy()
    is_brownian = isinstance(ensemble, Brownian)

    sh, engine = build_grown(state, engine)

    def make_advance(engine):
        return make_sharded_slot_advance(params, ensemble, engine,
                                         compensated=compensated, hilo=hilo)

    def restore(seg_start, engine):
        return build_grown(unshard_slot_state(seg_start, ring), engine)

    def health(s):
        # One all-reduce: any rank's divergence or overflow, and the sum of
        # the occupied slots.
        local = torch.stack([
            (~torch.all(torch.isfinite(s.positions))).long(),
            s.nbrs.overflow.long(), s.nbrs.occupied.sum()])
        diverged, overflow, occupied = ring.sum(local).tolist()
        return diverged, overflow, occupied

    def frame_rows(s):
        gathered = s.replace(
            positions=ring.gather_blocks(s.positions.to(torch.float32)),
            images=ring.gather_blocks(s.images),
            ids=ring.gather_blocks(s.ids))
        return _frame_rows(gathered, True, n, unitcell_np)

    root = ring.rank == 0
    start_step = state.step
    end_step = start_step + total_steps
    thermo_file, writer = (
        prepare_output_files(pathname, traj_name, thermo_name, start_step,
                             compress) if root else (None, None))
    sh, engine = _drive_events(
        sh, engine, make_advance=make_advance, restore=restore,
        health=health, frame_rows=frame_rows,
        particle_state=lambda s: unshard_slot_state(s, ring),
        use_slot=True, is_brownian=is_brownian, ensemble=ensemble,
        consts=consts, unitcell_np=unitcell_np, diameters_np=diameters_np,
        schedule=_event_schedule(start_step, total_steps, frequency,
                                 traj_frequency, log_times, checkpoint_every,
                                 pathname if root else None),
        start_step=start_step, end_step=end_step, pathname=pathname,
        thermo_file=thermo_file, writer=writer,
        meter=(StepRateMeter(os.path.join(pathname, "perf.txt"),
                             append=start_step > 0)
               if perf_log and root else None))
    final = unshard_slot_state(sh, ring)
    if root:
        write_xyz(os.path.join(pathname, "final.xyz"), end_step,
                  final.unitcell, final.positions, final.diameters, mode="w")
    return final
