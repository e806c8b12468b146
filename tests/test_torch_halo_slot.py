"""The sharded slot engine (``mdtpu_torch.parallel.HaloSlotEngine``) on the
CPU: a 2-rank gloo group of spawned processes against the JAX package's
``HaloSlotEngine`` on a 2-device CPU mesh, at f64, with the same explicit
geometry (N = 1,200 Lennard-Jones at rho 0.4, r_c 1.5, 8^3 cells in 3D):

  * the slab sweep (each rank's ghost planes, B1's interior launch, its
    plain version here) against JAX's ``compute_slots`` and against the
    port's periodic ``cell_sweep_plain`` on the same state: energy and
    virial rel 1e-12, forces 1e-10, in 3D, 2D, a tilted box; the hi/lo
    sweep (f32 hi/lo words of an f64 state) to 1e-5 against both and held
    to the f64 sweep of hi + lo;
  * 40-step NVE and NVT advances through rebuilds, one particle aimed
    across the slab boundary (asserted to change rank): positions 1e-9
    against JAX's ``make_sharded_slot_advance`` and the port's
    single-device ``make_slot_advance``; the NVT children replay JAX's
    Bussi draws at the ``bussi_noise`` seam;
  * NVT segments of 13 and 17 lean steps and 10 full ones: the sharded
    advance's rebuild steps (its device log) and positions equal to a host
    loop of the JAX package's nesting of ``make_slot_advance`` on the
    port's steps (a rebin at the segment's start, after every step any
    rank flagged, before the full last step);
  * a migration buffer of one column raises the overflow flag and loses no
    particle (JAX ``test_halo_slot_migration_capacity_overflow_flags``);
  * a user potential (``examples/03_polydisperse_2d.py``'s non-additive
    pseudo-hard spheres, diameters U(0.8, 1.2), N = 1,200) through the pair
    list's slab launch: the sweep in 2D (rho 0.9, r_c 1.8) and in a tilted
    3D box (rho 0.8, r_c 1.5) against JAX's ``compute_slots`` and the
    port's periodic list route at the LJ tolerances, the 2D hi/lo sweep to
    1e-5 and held to the f64 sweep of hi + lo, a 40-step 2D NVT advance
    (one particle aimed across the slab boundary) to 1e-9 against JAX's,
    and a list of one entry raising the overflow flag;
  * the ring of one: the same cases in this process, without spawning.

One spawn (both ranks run every case) and one set of JAX runs serve the
module. The children import no JAX: this module imports it inside its
fixtures only. Every rank's gloo group times out after
``RANK_TIMEOUT`` s and the parent kills both after ``JOIN_TIMEOUT`` s, so a
hung collective fails the tests instead of holding the suite."""

import datetime
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import mdtpu_torch as mt
from mdtpu_torch.integrate import slot_step as slots
from mdtpu_torch.integrate import thermostat as tthermo
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.cell_sweep import cell_sweep_hilo_plain, cell_sweep_plain
from mdtpu_torch.parallel import HaloSlotEngine, ShardRing
from mdtpu_torch.parallel.geometry import sharded_geometry
from mdtpu_torch.parallel.halo_slot import (build_sharded_slot_state,
                                            make_sharded_slot_advance,
                                            unshard_slot_state)
from mdtpu_torch.ops.cell_pairs import list_capacity, pair_sweep
from mdtpu_torch.sim.initialization import build_state_from_arrays
from tests.test_torch_gpu import NonAdditivePHS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RANK_TIMEOUT = 90      # seconds a gloo collective may wait
JOIN_TIMEOUT = 300     # seconds the parent waits for its children
N, RHO, CUTOFF, DT, STEPS = 1200, 0.4, 1.5, 0.002, 40
KEY_SEED = 1
MIGRATION = 384        # columns of a migration buffer (the JAX default rule)

# name -> (dimension, tilted, hi/lo); the geometry of each, both packages.
SWEEPS = {"3d": (3, False, False), "2d": (2, False, False),
          "tilted": (3, True, False), "hilo": (3, False, True)}
ADVANCES = ("nve", "nvt")
# The user potential's cases: name -> (dimension, tilted, hi/lo); density
# and engine cutoff by dimension (2D: config 4's), the advance's step.
USER_SWEEPS = {"user_2d": (2, False, False), "user_tilted": (3, True, False),
               "user_hilo": (2, False, True)}
USER_RHO, USER_CUTOFF = {2: 0.9, 3: 0.8}, {2: 1.8, 3: 1.5}
USER_DT = 0.001


# --------------------------------------------------------------- systems


def fluid_arrays(dim=3, tilted=False, seed=3):
    """A jittered lattice at rho 0.4 (N = 1,200), Maxwellian velocities at
    T ~ 0.75; particle ``AIMED`` (the closest below the slab boundary at
    x = L/2) moves along +x at speed 10, 0.8 over the advance. Tilted: the
    cube's columns carry off-diagonals (1.8, 1.2, 2.4), positions mapped
    from the lattice's fractional coordinates."""
    rng = np.random.default_rng(seed)
    L = (N / RHO) ** (1.0 / dim)
    per = int(np.ceil(N ** (1.0 / dim)))
    frac = (np.indices((per,) * dim).reshape(dim, -1).T[:N] + 0.5) / per
    cell = np.eye(dim) * L
    if tilted:
        cell[0, 1], cell[0, 2], cell[1, 2] = 1.8, 1.2, 2.4
    pos = frac @ cell.T + 0.05 * rng.normal(size=(N, dim))
    vel = 0.87 * rng.normal(size=(N, dim))
    vel -= vel.mean(axis=0)
    vel[aimed(pos, L)] = np.eye(dim)[0] * 10.0
    return pos, vel, cell


def user_arrays(dim=2, tilted=False, seed=8):
    """Config 4's kind at N = 1,200: a lattice jittered by 0.05 at rho 0.9
    (2D) or 0.8 (3D), diameters U(0.8, 1.2), velocities at T ~ 0.5; particle
    ``AIMED`` moves along +x at speed 10. Tilted: the 3D cube's columns
    carry off-diagonals (1.8, 1.2, 2.4)."""
    rng = np.random.default_rng(seed)
    L = (N / USER_RHO[dim]) ** (1.0 / dim)
    per = int(np.ceil(N ** (1.0 / dim)))
    frac = (np.indices((per,) * dim).reshape(dim, -1).T[:N] + 0.5) / per
    cell = np.eye(dim) * L
    if tilted:
        cell[0, 1], cell[0, 2], cell[1, 2] = 1.8, 1.2, 2.4
    pos = frac @ cell.T + 0.05 * rng.normal(size=(N, dim))
    diam = rng.uniform(0.8, 1.2, N)
    vel = 0.7 * rng.normal(size=(N, dim))
    vel -= vel.mean(axis=0)
    vel[aimed(pos, L)] = np.eye(dim)[0] * 10.0
    return pos, vel, diam, cell


def aimed(pos, L):
    below = np.where(pos[:, 0] < L / 2, pos[:, 0], -np.inf)
    return int(np.argmax(below))


def geometry(cell):
    """``(grid, cell_capacity, skin)``: the port's sharded rule for two
    ranks, used by both packages."""
    return sharded_geometry(CUTOFF, cell, N, WORLD)


def port_state(pos, vel, cell, dtype=torch.float64, lo=None, diam=None,
               cutoff=CUTOFF):
    st = build_state_from_arrays(pos, np.ones(len(pos)) if diam is None
                                 else diam, cell, velocities=vel,
                                 dtype=dtype, cutoff=cutoff, device="cpu")
    if lo is not None:
        st = st.replace(pos_comp=-torch.as_tensor(lo, dtype=dtype))
    return st


def hilo_words(pos):
    hi = pos.astype(np.float32)
    lo = (pos - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def port_engine(ring, cell, migration=MIGRATION):
    grid, cap, skin = geometry(cell)
    return HaloSlotEngine(potential=mt.LennardJones(r_cut=CUTOFF,
                                                    force_shift=True),
                          cutoff=CUTOFF, skin=skin, grid=grid,
                          cell_capacity=cap, migration_capacity=migration,
                          ring=ring)


def user_geometry(cell):
    """``(grid, cell_capacity, skin)`` of a user case: the port's sharded
    rule for two ranks at the dimension's engine cutoff."""
    return sharded_geometry(USER_CUTOFF[len(cell)], cell, N, WORLD)


def user_engine(ring, cell, pair_capacity=None):
    """The sharded engine of a user case: the two-rank geometry, and a list
    with room for a slab's hits on ``ring`` (the whole box on a ring of
    one)."""
    dim = len(cell)
    grid, cap, skin = user_geometry(cell)
    if pair_capacity is None:
        volume = abs(float(np.linalg.det(cell)))
        pair_capacity = list_capacity(N / ring.size, volume / ring.size,
                                      USER_CUTOFF[dim], dim)
    return HaloSlotEngine(potential=NonAdditivePHS(),
                          cutoff=USER_CUTOFF[dim], skin=skin, grid=grid,
                          cell_capacity=cap, migration_capacity=MIGRATION,
                          pair_capacity=pair_capacity, ring=ring)


def user_port_state(pos, vel, diam, cell, dtype=torch.float64, lo=None):
    return port_state(pos, vel, cell, dtype, lo, diam,
                      USER_CUTOFF[len(cell)])


def case_arrays(name):
    dim, tilted, hilo = SWEEPS[name]
    return fluid_arrays(dim, tilted) + (hilo,)


def replaying(draws):
    """A ``bussi_noise`` that replays a table of JAX's draws by step."""
    def noise(seed, step, nf, dtype, device):
        r1, r2 = draws[int(step)]
        return (torch.tensor(r1, dtype=dtype, device=device),
                torch.tensor(r2, dtype=dtype, device=device))
    return noise


# ------------------------------------------- what every rank runs (no JAX)


def sweep_case(ring, name):
    """The slab sweep of case ``name`` on ``ring``: energy, virial and the
    particle-order forces."""
    pos, vel, cell, hilo = case_arrays(name)
    eng = port_engine(ring, cell)
    if hilo:
        hi, lo = hilo_words(pos)
        st = port_state(hi, vel, cell, torch.float32, lo=lo)
        sh = build_sharded_slot_state(st, eng)
        e, w, f, _ = eng.compute_slots(sh.positions, sh.diameters,
                                       sh.unitcell, sh.unitcell_inv, sh.nbrs,
                                       pos_lo=-sh.pos_comp)
        sh = sh.replace(forces=f, energy=e, virial=w)
    else:
        sh = build_sharded_slot_state(port_state(pos, vel, cell), eng)
    out = unshard_slot_state(sh, ring)
    return {"energy": float(sh.energy), "virial": float(sh.virial),
            "forces": out.forces.numpy()}


def advance_case(ring, name, draws, steps=STEPS):
    """``steps`` NVE or NVT steps of the 3D case on ``ring`` (NVT replays
    ``draws``): final particle-order positions, velocities, energy, and
    each rank's particle ids before and after."""
    pos, vel, cell = fluid_arrays()
    eng = port_engine(ring, cell)
    params = mt.Parameters(RHO, N, DT, eng.potential)
    ens = mt.NVE() if name == "nve" else mt.NVT(0.75, 0.2)
    sh = build_sharded_slot_state(port_state(pos, vel, cell), eng)
    ids0 = sh.ids[sh.nbrs.occupied].numpy()
    saved = tthermo.bussi_noise
    tthermo.bussi_noise = replaying(draws)
    try:
        sh = make_sharded_slot_advance(params, ens, eng)(sh, steps)
    finally:
        tthermo.bussi_noise = saved
    out = unshard_slot_state(sh, ring)
    return {"positions": out.positions.numpy(),
            "velocities": out.velocities.numpy(),
            "energy": float(sh.energy), "temperature": float(sh.temperature),
            "overflow": bool(ring.any(sh.nbrs.overflow)),
            "ids_before": ids0, "ids_after": sh.ids[sh.nbrs.occupied].numpy()}


def jax_nesting(sh, params, ens, eng, ring, k, lean=True):
    """The JAX package's nesting of ``make_slot_advance`` under
    ``shard_map`` (``mdtpu/integrate/slot_step.py:640-690``), step by step
    on the host with the port's steps: a rebin at each outer pass and
    before the full last step, the inner loop ending on the ring's drift
    flag. Returns the state after ``k`` steps and the steps at which it
    rebinned."""
    step = slots.make_slot_step(params, ens, eng, observables=not lean,
                                ring=ring)
    last = slots.make_slot_step(params, ens, eng, ring=ring)
    rebins, i, n_lean = [], 0, k - 1 if lean else k
    while i < n_lean:
        rebins.append(sh.step)
        sh = slots._engine_rebin(sh, eng)
        while True:
            sh = step(sh)
            i += 1
            if i >= n_lean or bool(ring.any(slots.slot_needs_rebin(sh,
                                                                   eng))):
                break
    if lean:
        rebins.append(sh.step)
        sh = last(slots._engine_rebin(sh, eng))
    return sh, rebins


# The schedule case's segments: (steps, lean).
SCHEDULE = ((13, True), (17, True), (10, False))


def schedule_case(ring, draws):
    """NVT segments of :data:`SCHEDULE` through the sharded advance (one
    advance each for lean and full segments) and through
    :func:`jax_nesting` from the same start (both replaying ``draws``): each
    one's rebuild steps and final particle-order positions."""
    pos, vel, cell = fluid_arrays()
    eng = port_engine(ring, cell)
    params = mt.Parameters(RHO, N, DT, eng.potential)
    ens = mt.NVT(0.75, 0.2)
    advances = {lean: make_sharded_slot_advance(params, ens, eng, lean=lean)
                for lean in (True, False)}
    saved = tthermo.bussi_noise
    tthermo.bussi_noise = replaying(draws)
    try:
        out = {}
        for route in ("advance", "host"):
            sh = build_sharded_slot_state(port_state(pos, vel, cell), eng)
            rebins = []
            for k, lean in SCHEDULE:
                if route == "advance":
                    sh = advances[lean](sh, k)
                else:
                    sh, more = jax_nesting(sh, params, ens, eng, ring, k,
                                           lean)
                    rebins += more
            if route == "advance":
                # Each advance logs every rebuild of its life; the lean
                # segments come first.
                rebins = (advances[True].rebuild_steps()
                          + advances[False].rebuild_steps())
            out[route] = {"rebins": rebins, "step": sh.step,
                          "positions": unshard_slot_state(sh, ring)
                          .positions.numpy()}
    finally:
        tthermo.bussi_noise = saved
    return out


def overflow_case(ring, steps=20):
    """NVT with a migration buffer of one column: the ring's overflow flag
    and the particles still present."""
    pos, vel, cell = fluid_arrays()
    eng = port_engine(ring, cell, migration=1)
    params = mt.Parameters(RHO, N, DT, eng.potential)
    sh = build_sharded_slot_state(port_state(pos, vel, cell), eng)
    sh = make_sharded_slot_advance(params, mt.NVT(0.75, 0.2), eng)(sh, steps)
    return {"overflow": bool(ring.any(sh.nbrs.overflow)),
            "occupied": int(ring.sum(sh.nbrs.occupied.sum()))}


def user_sweep_case(ring, name):
    """The slab sweep of user case ``name`` on ``ring`` (the pair list's
    slab launch): energy, virial, the particle-order forces, the overflow
    flag."""
    dim, tilted, hilo = USER_SWEEPS[name]
    pos, vel, diam, cell = user_arrays(dim, tilted)
    eng = user_engine(ring, cell)
    assert eng.uses_pair_list
    if hilo:
        hi, lo = hilo_words(pos)
        st = user_port_state(hi, vel, diam, cell, torch.float32, lo=lo)
        sh = build_sharded_slot_state(st, eng)
        e, w, f, nbrs = eng.compute_slots(sh.positions, sh.diameters,
                                          sh.unitcell, sh.unitcell_inv,
                                          sh.nbrs, pos_lo=-sh.pos_comp)
        sh = sh.replace(forces=f, energy=e, virial=w, nbrs=nbrs)
    else:
        sh = build_sharded_slot_state(user_port_state(pos, vel, diam, cell),
                                      eng)
    out = unshard_slot_state(sh, ring)
    return {"energy": float(sh.energy), "virial": float(sh.virial),
            "forces": out.forces.numpy(),
            "overflow": bool(ring.any(sh.nbrs.overflow))}


def user_advance_case(ring, draws, steps=STEPS):
    """``steps`` NVT steps of the 2D user case on ``ring``, replaying
    ``draws``: as :func:`advance_case`."""
    pos, vel, diam, cell = user_arrays()
    eng = user_engine(ring, cell)
    params = mt.Parameters(USER_RHO[2], N, USER_DT, eng.potential)
    sh = build_sharded_slot_state(user_port_state(pos, vel, diam, cell), eng)
    ids0 = sh.ids[sh.nbrs.occupied].numpy()
    saved = tthermo.bussi_noise
    tthermo.bussi_noise = replaying(draws)
    try:
        sh = make_sharded_slot_advance(params, mt.NVT(0.5, 0.2), eng)(sh,
                                                                       steps)
    finally:
        tthermo.bussi_noise = saved
    out = unshard_slot_state(sh, ring)
    return {"positions": out.positions.numpy(),
            "energy": float(sh.energy), "temperature": float(sh.temperature),
            "overflow": bool(ring.any(sh.nbrs.overflow)),
            "ids_before": ids0, "ids_after": sh.ids[sh.nbrs.occupied].numpy()}


def user_overflow_case(ring):
    """The 2D user case's first sweep with a list of one entry: the ring's
    overflow flag."""
    pos, vel, diam, cell = user_arrays()
    sh = build_sharded_slot_state(user_port_state(pos, vel, diam, cell),
                                  user_engine(ring, cell, pair_capacity=1))
    return {"overflow": bool(ring.any(sh.nbrs.overflow))}


def run_cases(ring, draws, user_draws):
    out = {("sweep", name): sweep_case(ring, name) for name in SWEEPS}
    for name in ADVANCES:
        out[("advance", name)] = advance_case(ring, name, draws)
    out["overflow"] = overflow_case(ring)
    out["schedule"] = schedule_case(ring, draws)
    for name in USER_SWEEPS:
        out[("sweep", name)] = user_sweep_case(ring, name)
    out[("advance", "user")] = user_advance_case(ring, user_draws)
    out["user_overflow"] = user_overflow_case(ring)
    return out


def _child(rank, world, workdir):
    """One rank of the spawned group: ``target(ring, *args)`` of its
    inputs, the result to ``rank{rank}.pkl``."""
    import importlib

    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    module, name = inputs["target"]
    target = getattr(importlib.import_module(module), name)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    try:
        out = target(ShardRing(device="cpu"), *inputs["args"])
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_ranks(workdir, target, args=(), world=WORLD):
    """Start ``world`` processes that each run ``target(ring, *args)`` in a
    gloo group (``target`` = (module, function name), a module under the
    repository's root that imports no JAX at import). Returns ``wait()``,
    which joins them within ``JOIN_TIMEOUT`` s (killing all past it) and
    returns each rank's result."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump({"target": target, "args": args}, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "from tests.test_torch_halo_slot import _child; "
            "_child({rank}, {world}, {workdir!r})")
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(root=ROOT, rank=r, world=world,
                                           workdir=workdir)],
        cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    start = time.monotonic()

    def wait():
        try:
            for p in procs:
                p.wait(timeout=max(1.0, JOIN_TIMEOUT
                                   - (time.monotonic() - start)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        results = []
        for r, p in enumerate(procs):
            path = os.path.join(workdir, f"rank{r}.pkl")
            if p.returncode != 0 or not os.path.isfile(path):
                with open(os.path.join(workdir, f"rank{r}.log")) as f:
                    tail = f.read()[-3000:]
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n{tail}")
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results

    return wait


# ------------------------------------------------------ the parent's side


def jax_draws(steps=STEPS, dim=3):
    from tests.test_torch_thermostat import jax_bussi_draws
    import jax
    key = jax.random.PRNGKey(KEY_SEED)
    return {s: jax_bussi_draws(key, s, dim * (N - 1.0))
            for s in range(steps)}


def jax_engine(cell, migration=MIGRATION):
    from mdtpu.parallel.halo_slot import HaloSlotEngine as JHalo
    from mdtpu.potentials.lennard_jones import LennardJones as JLJ
    grid, cap, skin = geometry(cell)
    return JHalo(potential=JLJ(r_cut=CUTOFF, force_shift=True),
                 cutoff=CUTOFF, skin=skin, grid=grid, cell_capacity=cap,
                 n_shards=WORLD, migration_capacity=migration)


def jax_user_engine(cell):
    from mdtpu.parallel.halo_slot import HaloSlotEngine as JHalo
    from tests.test_torch_geometry import JNonAdditivePHS
    grid, cap, skin = user_geometry(cell)
    return JHalo(potential=JNonAdditivePHS(), cutoff=USER_CUTOFF[len(cell)],
                 skin=skin, grid=grid, cell_capacity=cap, n_shards=WORLD,
                 migration_capacity=MIGRATION)


def jax_state(pos, vel, cell, dtype="float64", lo=None, diam=None,
              cutoff=CUTOFF):
    import jax
    import jax.numpy as jnp
    from mdtpu.sim.initialization import build_state_from_arrays as jbuild
    st = jbuild(pos, np.ones(len(pos)) if diam is None else diam, cell,
                jax.random.PRNGKey(KEY_SEED), velocities=vel,
                dtype=getattr(jnp, dtype), cutoff=cutoff)
    if lo is not None:
        st = st.replace(pos_comp=-jnp.asarray(lo))
    return st


def jax_sweep(mesh, name):
    import jax
    from jax.sharding import PartitionSpec as P
    from mdtpu.parallel.halo_slot import (build_sharded_slot_state as jbuild,
                                          slot_state_specs,
                                          unshard_slot_state as junshard)
    if name in USER_SWEEPS:
        dim, tilted, hilo = USER_SWEEPS[name]
        pos, vel, diam, cell = user_arrays(dim, tilted)
        eng, cutoff = jax_user_engine(cell), USER_CUTOFF[dim]
    else:
        pos, vel, cell, hilo = case_arrays(name)
        diam, eng, cutoff = None, jax_engine(cell), CUTOFF
    if hilo:
        hi, lo = hilo_words(pos)
        sh = jbuild(jax_state(hi, vel, cell, "float32", lo=lo, diam=diam,
                              cutoff=cutoff), eng, mesh)
        specs = slot_state_specs(eng, sh, cutoff)
        ax = eng.axis_name
        fn = jax.jit(jax.shard_map(
            lambda x, xl, d, c, ci, nb: eng.compute_slots(
                x, d, c, ci, nb, pos_lo=xl)[:3],
            mesh=mesh, in_specs=(P(None, ax), P(None, ax), P(ax), P(), P(),
                                 specs.nbrs),
            out_specs=(P(), P(), P(None, ax)), check_vma=False))
        e, w, f = fn(sh.positions, -sh.pos_comp, sh.diameters, sh.unitcell,
                     sh.unitcell_inv, sh.nbrs)
        sh = sh.replace(forces=f, energy=e, virial=w)
    else:
        sh = jbuild(jax_state(pos, vel, cell, diam=diam, cutoff=cutoff), eng,
                    mesh)
    out = junshard(sh)
    return {"energy": float(sh.energy), "virial": float(sh.virial),
            "forces": np.asarray(out.forces)}


def jax_advance(mesh, name):
    import jax
    from mdtpu.core.types import NVE as JNVE
    from mdtpu.core.types import NVT as JNVT
    from mdtpu.core.types import Parameters as JParameters
    from mdtpu.parallel.halo_slot import (build_sharded_slot_state as jbuild,
                                          make_sharded_slot_advance as jadv,
                                          unshard_slot_state as junshard)
    pos, vel, cell = fluid_arrays()
    eng = jax_engine(cell)
    params = JParameters(density=RHO, n_particles=N, dt=DT,
                         potential=eng.potential)
    sh = jbuild(jax_state(pos, vel, cell), eng, mesh)
    ens = JNVE() if name == "nve" else JNVT(0.75, 0.2)
    sh = jadv(params, ens, eng, mesh, sh)(sh, STEPS)
    jax.block_until_ready(sh.positions)
    out = junshard(sh)
    return {"positions": np.asarray(out.positions),
            "energy": float(sh.energy), "temperature": float(sh.temperature)}


def jax_user_advance(mesh):
    import jax
    from mdtpu.core.types import NVT as JNVT
    from mdtpu.core.types import Parameters as JParameters
    from mdtpu.parallel.halo_slot import (build_sharded_slot_state as jbuild,
                                          make_sharded_slot_advance as jadv,
                                          unshard_slot_state as junshard)
    pos, vel, diam, cell = user_arrays()
    eng = jax_user_engine(cell)
    params = JParameters(density=USER_RHO[2], n_particles=N, dt=USER_DT,
                         potential=eng.potential)
    sh = jbuild(jax_state(pos, vel, cell, diam=diam, cutoff=USER_CUTOFF[2]),
                eng, mesh)
    sh = jadv(params, JNVT(0.5, 0.2), eng, mesh, sh)(sh, STEPS)
    jax.block_until_ready(sh.positions)
    out = junshard(sh)
    return {"positions": np.asarray(out.positions),
            "energy": float(sh.energy), "temperature": float(sh.temperature)}


def periodic_user_sweep(name):
    """The port's periodic list route on user case ``name`` (plain on the
    CPU): f64; for hi/lo the hi/lo list on the f32 words and the f64 list
    on hi + lo."""
    dim, tilted, hilo = USER_SWEEPS[name]
    pos, vel, diam, cell = user_arrays(dim, tilted)
    grid, cap, skin = user_geometry(cell)
    cutoff = USER_CUTOFF[dim]
    pot = NonAdditivePHS()
    capacity = list_capacity(N, abs(float(np.linalg.det(cell))), cutoff,
                             dim)
    eng = CellGridEngine(potential=pot, cutoff=cutoff, skin=skin, grid=grid,
                         cell_capacity=cap, pair_capacity=capacity)
    if not hilo:
        st = slots.slot_forces(slots.slotify(
            user_port_state(pos, vel, diam, cell), eng), eng)
        assert not bool(st.nbrs.overflow)
        out = slots.unslotify_state(st)
        return {"energy": float(st.energy), "virial": float(st.virial),
                "forces": out.forces.numpy()}
    hi, lo = hilo_words(pos)
    st = slots.slotify(user_port_state(hi, vel, diam, cell, torch.float32,
                                       lo=lo), eng)
    args = (st.nbrs.counts, st.unitcell, eng.grid, cutoff, pot, capacity)
    e, w, f, _ = pair_sweep(st.positions, st.diameters, *args,
                            slot_lo=-st.pos_comp)
    exact = st.positions.double() - st.pos_comp.double()
    e64, w64, f64, _ = pair_sweep(exact, st.diameters.double(),
                                  st.nbrs.counts, st.unitcell.double(),
                                  *args[2:])
    order = np.argsort(st.ids[st.nbrs.occupied].numpy(), kind="stable")
    occ = st.nbrs.occupied.numpy()
    return {"energy": float(e), "virial": float(w),
            "forces": f.numpy().T[occ][order],
            "f64": {"energy": float(e64), "virial": float(w64),
                    "forces": f64.numpy().T[occ][order]}}


def periodic_sweep(name):
    """The port's single-device sweep of the case: plain f64 (or, for hi/lo,
    its hi/lo plain version, and the f64 plain sweep of hi + lo)."""
    pos, vel, cell, hilo = case_arrays(name)
    grid, cap, skin = geometry(cell)
    eng = CellGridEngine(potential=mt.LennardJones(r_cut=CUTOFF,
                                                   force_shift=True),
                         cutoff=CUTOFF, skin=skin, grid=grid,
                         cell_capacity=cap)
    if not hilo:
        st = slots.slot_forces(slots.slotify(port_state(pos, vel, cell), eng),
                               eng)
        out = slots.unslotify_state(st)
        return {"energy": float(st.energy), "virial": float(st.virial),
                "forces": out.forces.numpy()}
    hi, lo = hilo_words(pos)
    st = slots.slotify(port_state(hi, vel, cell, torch.float32, lo=lo), eng)
    args = (st.diameters, st.nbrs.counts, st.unitcell, eng.grid, CUTOFF,
            eng.potential)
    e, w, f = cell_sweep_hilo_plain(st.positions, -st.pos_comp, *args)
    exact = st.positions.double() - st.pos_comp.double()
    e64, w64, f64 = cell_sweep_plain(exact, st.diameters.double(),
                                     st.nbrs.counts, st.unitcell.double(),
                                     eng.grid, CUTOFF, eng.potential)
    order = np.argsort(st.ids[st.nbrs.occupied].numpy(), kind="stable")
    occ = st.nbrs.occupied.numpy()
    return {"energy": float(e), "virial": float(w),
            "forces": f.numpy().T[occ][order],
            "f64": {"energy": float(e64), "virial": float(w64),
                    "forces": f64.numpy().T[occ][order]}}


def single_advance(name):
    """The port's single-device slot advance of the 3D case (NVT replaying
    JAX's draws)."""
    pos, vel, cell = fluid_arrays()
    grid, cap, skin = geometry(cell)
    pot = mt.LennardJones(r_cut=CUTOFF, force_shift=True)
    eng = CellGridEngine(potential=pot, cutoff=CUTOFF, skin=skin, grid=grid,
                         cell_capacity=cap)
    params = mt.Parameters(RHO, N, DT, pot)
    ens = mt.NVE() if name == "nve" else mt.NVT(0.75, 0.2)
    st = slots.slot_forces(slots.slotify(port_state(pos, vel, cell), eng),
                           eng)
    st = slots.make_slot_advance(params, ens, eng)(st, STEPS)
    return {"positions": slots.unslotify_state(st).positions.numpy(),
            "energy": float(st.energy)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the 2-rank children (started first, so that they run
    while this process does the rest), the ring of one here, the JAX
    package's runs on a 2-device mesh and the port's single-device ones."""
    draws, user_draws = jax_draws(), jax_draws(dim=2)
    wait = spawn_ranks(str(tmp_path_factory.mktemp("ranks")),
                       ("tests.test_torch_halo_slot", "run_cases"),
                       (draws, user_draws))
    torch.set_num_threads(1)
    try:
        from mdtpu.parallel.mesh import make_mesh
        mesh = make_mesh(WORLD)
        jax_out = {("sweep", k): jax_sweep(mesh, k)
                   for k in (*SWEEPS, *USER_SWEEPS)}
        for k in ADVANCES:
            jax_out[("advance", k)] = jax_advance(mesh, k)
        jax_out[("advance", "user")] = jax_user_advance(mesh)
        port = {("sweep", k): periodic_sweep(k) for k in SWEEPS}
        port.update({("sweep", k): periodic_user_sweep(k)
                     for k in USER_SWEEPS})
        saved = tthermo.bussi_noise
        tthermo.bussi_noise = replaying(draws)
        try:
            for k in ADVANCES:
                port[("advance", k)] = single_advance(k)
        finally:
            tthermo.bussi_noise = saved
        one = run_cases(ShardRing(device="cpu"), draws, user_draws)
    finally:
        ranks = wait()
    return {"ranks": ranks, "one": one, "jax": jax_out, "port": port}


def _forces_close(a, b, tol):
    scale = np.sqrt(np.mean(np.sum(b * b, axis=1)))
    err = np.max(np.linalg.norm(a - b, axis=1))
    assert err <= tol * max(scale, 1.0), (err, scale)


def _forces_close_each(a, b, tol):
    """Each particle's force error within ``tol`` of the larger of its own
    force and the RMS force (the user potential's contact forces range over
    two decades, so an error at the RMS scale would hide the small ones and
    over-weigh the large)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    mag = np.linalg.norm(b, axis=1)
    rms = np.sqrt(np.mean(mag * mag))
    err = np.linalg.norm(a - b, axis=1) / np.maximum(mag, rms)
    assert err.max() <= tol, (err.max(), rms)


RINGS = ("two_ranks", "one_rank")


def _ring_out(runs, ring):
    return runs["ranks"][0] if ring == "two_ranks" else runs["one"]


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("name", ["3d", "2d", "tilted"])
def test_slab_sweep_matches_jax_and_the_periodic_sweep(runs, name, ring):
    got = _ring_out(runs, ring)[("sweep", name)]
    if ring == "two_ranks":
        # Every rank returns the ring's sums and the gathered state.
        other = runs["ranks"][1][("sweep", name)]
        assert other["energy"] == got["energy"]
        np.testing.assert_array_equal(other["forces"], got["forces"])
    for ref in (runs["jax"][("sweep", name)], runs["port"][("sweep", name)]):
        np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-12)
        np.testing.assert_allclose(got["virial"], ref["virial"], rtol=1e-12)
        np.testing.assert_allclose(got["forces"], ref["forces"], rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("ring", RINGS)
def test_slab_hilo_sweep_matches_jax_and_holds_to_f64(runs, ring):
    got = _ring_out(runs, ring)[("sweep", "hilo")]
    plain = runs["port"][("sweep", "hilo")]
    for ref in (runs["jax"][("sweep", "hilo")], plain):
        np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-5)
        np.testing.assert_allclose(got["virial"], ref["virial"], rtol=1e-5)
        _forces_close(got["forces"], ref["forces"], 1e-5)
    # Against the f64 sweep of hi + lo: no worse than the single-device
    # hi/lo sweep, within a few f32 roundings; energy and virial are f32
    # sums.
    f64 = plain["f64"]
    err = np.max(np.abs(got["forces"] - f64["forces"]))
    ref_err = np.max(np.abs(plain["forces"] - f64["forces"]))
    assert err <= 4 * ref_err + 1e-12
    np.testing.assert_allclose(got["energy"], f64["energy"], rtol=1e-5)
    np.testing.assert_allclose(got["virial"], f64["virial"], rtol=1e-5)


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("name", ADVANCES)
def test_advance_matches_jax_and_the_single_device_advance(runs, name, ring):
    got = _ring_out(runs, ring)[("advance", name)]
    assert not got["overflow"]
    for ref in (runs["jax"][("advance", name)],
                runs["port"][("advance", name)]):
        np.testing.assert_allclose(got["positions"], ref["positions"],
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-10)
    jax_t = runs["jax"][("advance", name)]["temperature"]
    np.testing.assert_allclose(got["temperature"], jax_t, rtol=1e-10)


@pytest.mark.parametrize("ring", RINGS)
def test_advance_rebuilds_where_the_jax_nesting_does(runs, ring):
    """The sharded advance's rebuild steps (its device log) over lean and
    full segments are those of a host loop of the JAX package's nesting,
    and its positions that loop's, bit for bit (the same plain kernels in
    the same order)."""
    got = _ring_out(runs, ring)["schedule"]
    adv, host = got["advance"], got["host"]
    assert adv["step"] == host["step"] == sum(k for k, _ in SCHEDULE)
    assert adv["rebins"] == host["rebins"]
    # A rebuild at each segment's start and before each lean segment's
    # last step, and more between.
    starts = np.cumsum([0] + [k for k, _ in SCHEDULE])[:-1].tolist()
    lasts = [a + k - 1 for a, (k, lean) in zip(starts, SCHEDULE) if lean]
    assert set(starts) | set(lasts) < set(adv["rebins"])
    np.testing.assert_array_equal(adv["positions"], host["positions"])
    if ring == "two_ranks":
        other = runs["ranks"][1]["schedule"]["advance"]
        assert other["rebins"] == adv["rebins"]


@pytest.mark.parametrize("name", ADVANCES)
def test_particles_change_rank_during_the_advance(runs, name):
    a, b = (r[("advance", name)] for r in runs["ranks"])
    # Each rank holds a disjoint part of the particles, before and after.
    for key in ("ids_before", "ids_after"):
        assert len(a[key]) + len(b[key]) == N
        assert not set(a[key]) & set(b[key])
    moved = set(a["ids_before"]) - set(a["ids_after"])
    pos, _, cell = fluid_arrays()
    assert aimed(pos, cell[0, 0]) in moved  # from slab 0 into slab 1


@pytest.mark.parametrize("ring", RINGS)
def test_migration_buffer_overflow_raises_the_flag(runs, ring):
    got = _ring_out(runs, ring)["overflow"]
    if ring == "two_ranks":
        assert got["overflow"]
    else:
        # One rank owns the box: nothing migrates, nothing overflows.
        assert not got["overflow"]
    assert got["occupied"] == N


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("name", ["user_2d", "user_tilted"])
def test_slab_pair_list_sweep_matches_jax_and_the_periodic_list(runs, name,
                                                                ring):
    got = _ring_out(runs, ring)[("sweep", name)]
    assert not got["overflow"]
    if ring == "two_ranks":
        other = runs["ranks"][1][("sweep", name)]
        assert other["energy"] == got["energy"]
        np.testing.assert_array_equal(other["forces"], got["forces"])
    for ref in (runs["jax"][("sweep", name)], runs["port"][("sweep", name)]):
        np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-12)
        np.testing.assert_allclose(got["virial"], ref["virial"], rtol=1e-12)
        np.testing.assert_allclose(got["forces"], ref["forces"], rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("ring", RINGS)
def test_slab_pair_list_hilo_sweep_matches_jax_and_holds_to_f64(runs, ring):
    got = _ring_out(runs, ring)[("sweep", "user_hilo")]
    plain = runs["port"][("sweep", "user_hilo")]
    assert not got["overflow"]
    for ref in (runs["jax"][("sweep", "user_hilo")], plain):
        np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-5)
        np.testing.assert_allclose(got["virial"], ref["virial"], rtol=1e-5)
        _forces_close_each(got["forces"], ref["forces"], 1e-5)
    f64 = plain["f64"]
    err = np.max(np.abs(got["forces"] - f64["forces"]))
    ref_err = np.max(np.abs(plain["forces"] - f64["forces"]))
    assert err <= 4 * ref_err + 1e-12
    np.testing.assert_allclose(got["energy"], f64["energy"], rtol=1e-5)
    np.testing.assert_allclose(got["virial"], f64["virial"], rtol=1e-5)


@pytest.mark.parametrize("ring", RINGS)
def test_user_advance_matches_jax(runs, ring):
    got = _ring_out(runs, ring)[("advance", "user")]
    ref = runs["jax"][("advance", "user")]
    assert not got["overflow"]
    np.testing.assert_allclose(got["positions"], ref["positions"], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-10)
    np.testing.assert_allclose(got["temperature"], ref["temperature"],
                               rtol=1e-10)
    if ring == "two_ranks":
        a, b = (r[("advance", "user")] for r in runs["ranks"])
        for key in ("ids_before", "ids_after"):
            assert len(a[key]) + len(b[key]) == N
            assert not set(a[key]) & set(b[key])
        moved = set(a["ids_before"]) - set(a["ids_after"])
        pos, _, _, cell = user_arrays()
        assert aimed(pos, cell[0, 0]) in moved


@pytest.mark.parametrize("ring", RINGS)
def test_pair_list_of_one_entry_raises_the_overflow_flag(runs, ring):
    assert _ring_out(runs, ring)["user_overflow"]["overflow"]


def test_create_rejects_the_pair_list_route_and_small_boxes():
    """``create`` takes a potential without a kernel functor (the pair
    list's slab launch) with a list sized for a slab's hits, grown by 1.4
    plus 1024; a box too small to shard is still refused."""
    ring = ShardRing(device="cpu")

    class Soft(mt.Potential):
        def evaluate(self, r, si, sj):
            return r * 0, r * 0

    soft = HaloSlotEngine.create(Soft(), 1.5, np.eye(3) * 14.0, 1000, ring)
    assert soft.uses_pair_list
    assert soft.pair_capacity == list_capacity(1000, 14.0 ** 3, 1.5, 3)
    assert soft.pair_list_capacity == soft.pair_capacity
    grown = soft.with_grown_capacity()
    assert grown.pair_capacity == int(soft.pair_capacity * 1.4) + 1024
    assert grown.cell_capacity == int(soft.cell_capacity * 1.4 + 4)
    with pytest.raises(ValueError, match="box too small to shard"):
        HaloSlotEngine.create(mt.LennardJones(r_cut=2.5), 2.5,
                              np.eye(3) * 6.0, 100, ring)
    eng = HaloSlotEngine.create(mt.LennardJones(r_cut=1.5), 1.5,
                                np.eye(3) * 14.42, N, ring)
    assert not eng.uses_pair_list and eng.pair_capacity == 0
    assert eng.grid == (8, 8, 8) and eng.as_single_chip().grid == eng.grid
    grown = eng.with_grown_capacity()
    assert grown.cell_capacity == int(eng.cell_capacity * 1.4 + 4)
    assert grown.migration_capacity == 2 * eng.migration_capacity
    assert grown.ring is ring
