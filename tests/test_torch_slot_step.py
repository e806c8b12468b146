"""The slot-space loop (``mdtpu_torch.integrate.slot_step``) on the CPU:

  * layout: ``slotify`` then ``unslotify_state`` gives the state back bit for
    bit; after a rebin with crossings of cells and of the box edge, every
    cell's occupied slots are contiguous from its first, ``counts`` equals
    ``CellGridEngine.allocate``'s counts of the folded positions, and every
    particle keeps its identity and its (folded) coordinates; a state given
    partly outside the box slotifies as its wrapped copy;
  * the slot step against the port's own particle-order step, 50 NVE and
    NVT steps (N = 1000, LJ r_c 1.5, f64, several rebins): positions,
    velocities and energies to rel 1e-10;
  * lean steps: ``compute_slots(observables=False)`` gives the full sweep's
    forces bit for bit (zero energy and virial), and a lean advance the
    positions of a full one bit for bit;
  * Brownian dynamics on the slot route against the JAX package's slot route
    (N = 512 pseudo-hard spheres, f64), with noise equal for every particle
    on both sides (a vector that depends on the step only: slot order then
    cannot matter) moving the lattice across cell and box edges: thermo rows
    (the pressure averages the virial sampled every 10 steps) to rel 1e-9,
    final positions to 1e-9, through at least two rebins;
  * ``force_dtype`` (the pair sweep in another dtype than the state's):
    20 NVE steps of ``make_slot_advance`` (cell grid) and of
    ``make_md_step`` (naive engine) against the JAX package's on the N =
    1000 system, a float32 state with float64 forces and a float64 state
    with float32 forces: positions to rel 1e-6 (of the box length), and
    the ``ValueError`` of both packages with the hi/lo sweep."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdtpu_torch
from mdtpu.core.types import Brownian as JBrownian
from mdtpu.core.types import Parameters as JParameters
from mdtpu.core.types import NVE as JNVE
from mdtpu.integrate import slot_step as j_slot_step
from mdtpu.integrate import step as j_step
from mdtpu.ops.cell_grid import CellGridEngine as JCellGrid
from mdtpu.ops.naive import NaivePairEngine as JNaive
from mdtpu.potentials.lennard_jones import LennardJones as JLJ
from mdtpu.potentials.pseudo_hs import PseudoHS as JPHS
from mdtpu.sim import driver as j_driver
from mdtpu.sim.initialization import build_state_from_arrays as j_build_state
from mdtpu_torch.integrate import slot_step
from mdtpu_torch.integrate import step as tstep
from mdtpu_torch.integrate.step import make_step
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.naive import NaivePairEngine
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from mdtpu_torch.sim.initialization import build_state_from_arrays
from tests.test_torch_brownian import RHO as BD_RHO
from tests.test_torch_brownian import _arrays as bd_arrays
from tests.test_torch_driver import _assert_same_numbers, _initial_arrays
from tests.test_torch_driver import one_torch_thread  # noqa: F401

N_SMALL, RHO_SMALL = 1000, 0.8


def _lattice_state(n=4096, dtype=torch.float64):
    pos, vel, cell = _initial_arrays()
    return build_state_from_arrays(pos, np.ones(len(pos)), cell,
                                   velocities=vel, dtype=dtype, cutoff=2.5,
                                   device="cpu")


def _small_arrays(seed):
    rng = np.random.default_rng(seed)
    L = (N_SMALL / RHO_SMALL) ** (1 / 3)
    idx = np.indices((10,) * 3).reshape(3, -1).T
    pos = (idx + 0.5) / 10 * L + 0.03 * rng.normal(size=(N_SMALL, 3))
    vel = rng.normal(size=(N_SMALL, 3))
    vel -= vel.mean(axis=0)
    return pos, vel, L


def _small_system(seed=11):
    """N = 1000 jittered lattice at rho 0.8, LJ r_c 1.5, on a 5^3 grid."""
    pos, vel, L = _small_arrays(seed)
    state = build_state_from_arrays(pos, np.ones(N_SMALL), np.eye(3) * L,
                                    velocities=vel, dtype=torch.float64,
                                    cutoff=1.5, device="cpu")
    pot = LennardJones(r_cut=1.5)
    engine = CellGridEngine.create(pot, 1.5, 0.1, state.unitcell, N_SMALL)
    return state, mdtpu_torch.Parameters(RHO_SMALL, N_SMALL, 0.002, pot), \
        engine


def test_slotify_round_trip_is_bit_exact():
    state = _lattice_state()
    state = state.replace(images=torch.randint(-3, 4, (4096, 3)),
                          pos_comp=torch.randn(4096, 3) * 1e-17)
    engine = CellGridEngine.create(LennardJones(r_cut=2.5), 2.5, 0.3,
                                   state.unitcell, 4096)
    slots = slot_step.slotify(state, engine)
    assert slots.positions.shape == (3, engine.n_cells * engine.cell_capacity)
    assert int(slots.nbrs.occupied.sum()) == 4096
    back = slot_step.unslotify_state(slots)
    for name in ("positions", "velocities", "forces", "images", "diameters",
                 "pos_comp", "vel_comp"):
        assert torch.equal(getattr(back, name), getattr(state, name)), name
    assert back.ids is None and back.nbrs is None


def test_slotify_folds_positions_outside_the_box():
    """A state given in [-L/2, L/2) slotifies as its wrapped copy: the slot
    layout sweeps positions as they are, so they must lie in their cells."""
    state = _lattice_state()
    L = float(state.unitcell[0, 0])
    shifted = state.replace(positions=state.positions - L / 2)
    engine = CellGridEngine.create(LennardJones(r_cut=2.5), 2.5, 0.3,
                                   state.unitcell, 4096)
    wrapped = state.replace(positions=torch.remainder(shifted.positions, L),
                            images=torch.where(shifted.positions < 0, -1, 0))
    a = slot_step.slot_forces(slot_step.slotify(shifted, engine), engine)
    b = slot_step.slot_forces(slot_step.slotify(wrapped, engine), engine)
    np.testing.assert_allclose(a.positions.numpy(), b.positions.numpy(),
                               rtol=0, atol=1e-12)
    assert torch.equal(a.images, b.images)
    np.testing.assert_allclose(a.forces.numpy(), b.forces.numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(float(a.energy), float(b.energy), rtol=1e-12)
    pos, _, _, images = slot_step.unslotify_arrays(a)
    assert pos.min() >= 0.0 and pos.max() < L
    assert int((images == -1).sum()) == int((shifted.positions < 0).sum())


def _contiguous(occupied, counts, cap):
    slot = torch.arange(cap)[None, :]
    want = slot < counts.clamp(max=cap)[:, None]
    return torch.equal(occupied.reshape(-1, cap), want)


def test_rebin_keeps_cells_contiguous_and_counts_as_allocate():
    state = _lattice_state()
    engine = CellGridEngine.create(LennardJones(r_cut=2.5), 2.5, 0.3,
                                   state.unitcell, 4096, cell_capacity=60)
    slots = slot_step.slotify(state, engine)
    cap = engine.cell_capacity
    assert _contiguous(slots.nbrs.occupied, slots.nbrs.counts, cap)
    # Move every particle by up to 0.7 in each direction: many cross a cell
    # face, and those near the box edge leave the box (deferred wrap).
    rng = np.random.default_rng(5)
    shift = torch.as_tensor(rng.uniform(-0.7, 0.7, slots.positions.shape))
    moved = slots.replace(positions=torch.where(slots.nbrs.occupied[None, :],
                                                slots.positions + shift, 0.0))
    rebinned = slot_step._rebin(moved, engine)
    assert not bool(rebinned.nbrs.overflow)
    assert _contiguous(rebinned.nbrs.occupied, rebinned.nbrs.counts, cap)
    assert torch.equal(rebinned.nbrs.ref_positions, rebinned.positions)

    # Particle order of the moved state, folded on the host.
    expect = slot_step.unslotify_state(moved)
    assert int((expect.images != 0).sum()) > 100          # box crossings
    got = slot_step.unslotify_state(rebinned)
    np.testing.assert_allclose(got.positions.numpy(),
                               expect.positions.numpy(), rtol=0, atol=1e-12)
    assert torch.equal(got.images, expect.images)
    assert torch.equal(got.velocities, expect.velocities)
    nbrs = engine.allocate(expect.positions, expect.diameters,
                           expect.unitcell, expect.unitcell_inv)
    assert torch.equal(rebinned.nbrs.counts, nbrs.counts)
    assert not torch.equal(rebinned.nbrs.counts, slots.nbrs.counts)
    # Every occupied slot lies in the box now, and in its own cell.
    occ = rebinned.nbrs.occupied
    L = float(state.unitcell[0, 0])
    pos = rebinned.positions[:, occ]
    assert float(pos.min()) >= 0.0 and float(pos.max()) < L
    grid = engine.grid[0]
    cell_of = (pos / L * grid).long().clamp(0, grid - 1)
    cid = (cell_of[0] * grid + cell_of[1]) * grid + cell_of[2]
    assert torch.equal(cid, torch.nonzero(occ)[:, 0] // cap)


@pytest.mark.parametrize("ensemble", [mdtpu_torch.NVE(),
                                      mdtpu_torch.NVT(1.0, 0.1)],
                         ids=["nve", "nvt"])
def test_slot_step_matches_particle_order_step(ensemble, monkeypatch):
    rebins = []
    rebin = slot_step._rebin
    monkeypatch.setattr(slot_step, "_rebin",
                        lambda s, e: rebins.append(1) or rebin(s, e))
    state, params, engine = _small_system()
    e0, w0, f0, nbrs = engine.compute(
        state.positions, state.diameters, state.unitcell, state.unitcell_inv,
        engine.allocate(state.positions, state.diameters, state.unitcell,
                        state.unitcell_inv))
    particle = state.replace(forces=f0, energy=e0, virial=w0, nbrs=nbrs)
    slots = slot_step.slot_forces(slot_step.slotify(state, engine), engine)
    step = make_step(params, ensemble, engine)
    advance = slot_step.make_slot_advance(params, ensemble, engine)
    for k in (1, 24, 25):               # segments end on full steps
        for _ in range(k):
            particle = step(particle)
        slots = advance(slots, k)
        got = slot_step.unslotify_state(slots)
        assert got.step == particle.step
        for name in ("positions", "velocities", "forces"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       getattr(particle, name).numpy(),
                                       rtol=1e-10, atol=1e-10)
        for name in ("energy", "virial", "temperature"):
            np.testing.assert_allclose(float(getattr(got, name)),
                                       float(getattr(particle, name)),
                                       rtol=1e-10)
        assert torch.equal(got.images, particle.images)
    assert len(rebins) >= 2


def test_lean_sweep_and_lean_steps_are_bit_equal_to_full():
    state, params, engine = _small_system(seed=3)
    slots = slot_step.slot_forces(slot_step.slotify(state, engine), engine)
    full = engine.compute_slots(slots.positions, slots.diameters,
                                slots.unitcell, slots.unitcell_inv,
                                slots.nbrs)
    lean = engine.compute_slots(slots.positions, slots.diameters,
                                slots.unitcell, slots.unitcell_inv,
                                slots.nbrs, observables=False)
    assert torch.equal(lean[2], full[2])
    assert float(lean[0]) == float(lean[1]) == 0.0 and float(full[0]) < 0
    # The same with the hi/lo sweep on float32 words.
    hi = slots.positions.float()
    lo = (slots.positions - hi.double()).float()
    args = (hi, slots.diameters.float(), slots.unitcell.float(),
            slots.unitcell_inv.float(), slots.nbrs)
    full32 = engine.compute_slots(*args, pos_lo=lo)
    lean32 = engine.compute_slots(*args, observables=False, pos_lo=lo)
    assert torch.equal(lean32[2], full32[2])

    ensemble = mdtpu_torch.NVT(1.0, 0.1)
    lean_adv = slot_step.make_slot_advance(params, ensemble, engine)
    full_adv = slot_step.make_slot_advance(params, ensemble, engine,
                                           lean=False)
    a, b = lean_adv(slots, 12), full_adv(slots, 12)
    for name in ("positions", "velocities", "forces", "energy", "virial"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


BD_N, BD_DT, BD_STEPS, BD_FREQ, BD_SKIN = 512, 1e-5, 30, 10, 0.04
BD_DRIFT = (6.0, -4.0, 2.0)


def _drift(step):
    """The noise vector of one step, the same for every particle."""
    return [c * (1.0 + 0.1 * (step % 3)) for c in BD_DRIFT]


def test_brownian_slot_route_matches_jax(tmp_path, monkeypatch):
    pos, diam, cell = bd_arrays(BD_N, seed=12)
    key = jax.random.PRNGKey(4)
    jengine = JCellGrid.create(JPHS(), 1.5, BD_SKIN, cell, BD_N)

    def j_noise(key, step, shape, dtype, axis_name):
        vec = jnp.asarray(BD_DRIFT, dtype) * (1.0 + 0.1 * (step % 3))
        return jnp.broadcast_to(vec[:, None], shape)

    monkeypatch.setattr(j_slot_step, "brownian_noise", j_noise)
    monkeypatch.setattr(j_driver, "_ADVANCE_CACHE", {})
    jstate = j_build_state(pos, diam, cell, key, dtype=jnp.float64,
                           cutoff=1.5)
    jparams = JParameters(density=BD_RHO, n_particles=BD_N, dt=BD_DT,
                          potential=JPHS())
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jout = j_driver.run_simulation(jstate, jparams, JBrownian(1.0), BD_STEPS,
                                   BD_FREQ, jdir, engine=jengine)

    def t_noise(seed, step, shape, dtype, device):
        vec = torch.tensor(_drift(step), dtype=dtype, device=device)
        return vec[:, None].expand(shape)

    monkeypatch.setattr(tstep, "brownian_noise", t_noise)
    rebins = []
    rebin = slot_step._rebin
    monkeypatch.setattr(slot_step, "_rebin",
                        lambda s, e: rebins.append(1) or rebin(s, e))
    engine = CellGridEngine(potential=PseudoHS(), cutoff=1.5, skin=BD_SKIN,
                            grid=jengine.grid,
                            cell_capacity=jengine.cell_capacity)
    tstate = build_state_from_arrays(pos, diam, cell, dtype=torch.float64,
                                     cutoff=1.5, device="cpu")
    tparams = mdtpu_torch.Parameters(BD_RHO, BD_N, BD_DT, PseudoHS())
    tout = mdtpu_torch.run_simulation(tstate, tparams,
                                      mdtpu_torch.Brownian(1.0), BD_STEPS,
                                      BD_FREQ, tdir, engine=engine,
                                      device="cpu")
    assert len(rebins) >= 2 and tout.step == BD_STEPS
    rows_t = np.loadtxt(os.path.join(tdir, "thermo.txt"))
    rows_j = np.loadtxt(os.path.join(jdir, "thermo.txt"))
    assert rows_t.shape == (BD_STEPS // BD_FREQ, 4)
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-9, atol=0)
    assert np.all(rows_t[:, 1] > 0)               # pairs interacted
    np.testing.assert_allclose(tout.positions.numpy(),
                               np.asarray(jout.positions), rtol=0, atol=1e-9)
    assert torch.equal(tout.images, torch.as_tensor(np.array(jout.images),
                                                    dtype=torch.int64))
    assert int((tout.images != 0).sum()) > 0      # crossed the box edge
    _assert_same_numbers(os.path.join(tdir, "final.xyz"),
                         os.path.join(jdir, "final.xyz"), 1e-9)


FORCE_DTYPE_CASES = {"f32_state_f64_forces": (torch.float32, torch.float64),
                     "f64_state_f32_forces": (torch.float64, torch.float32)}
_JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _force_dtype_states(dtype):
    pos, vel, L = _small_arrays(seed=21)
    cell = np.eye(3) * L
    jstate = j_build_state(pos, np.ones(N_SMALL), cell, jax.random.PRNGKey(0),
                           velocities=vel, dtype=_JAX_DTYPE[dtype],
                           cutoff=1.5)
    tstate = build_state_from_arrays(pos, np.ones(N_SMALL), cell,
                                     velocities=vel, dtype=dtype, cutoff=1.5,
                                     device="cpu")
    return jstate, tstate, L


@pytest.mark.parametrize("route", ["slot", "particle"])
@pytest.mark.parametrize("case", list(FORCE_DTYPE_CASES))
def test_force_dtype_matches_jax(route, case):
    dtype, force_dtype = FORCE_DTYPE_CASES[case]
    jfd = _JAX_DTYPE[force_dtype]
    jstate, tstate, L = _force_dtype_states(dtype)
    jparams = JParameters(density=RHO_SMALL, n_particles=N_SMALL, dt=0.002,
                          potential=JLJ(r_cut=1.5))
    tparams = mdtpu_torch.Parameters(RHO_SMALL, N_SMALL, 0.002,
                                     LennardJones(r_cut=1.5))
    steps = 20
    if route == "slot":
        jengine = JCellGrid.create(JLJ(r_cut=1.5), 1.5, 0.1,
                                   np.eye(3) * L, N_SMALL)
        js = j_slot_step.slot_forces(j_slot_step.slotify(jstate, jengine),
                                     jengine, force_dtype=jfd)
        jadv = jax.jit(j_slot_step.make_slot_advance(
            jparams, JNVE(), jengine, force_dtype=jfd))
        jout = j_slot_step.unslotify_state(jadv(js, steps))
        engine = CellGridEngine(potential=tparams.potential, cutoff=1.5,
                                skin=0.1, grid=jengine.grid,
                                cell_capacity=jengine.cell_capacity)
        ts = slot_step.slot_forces(slot_step.slotify(tstate, engine), engine,
                                   force_dtype=force_dtype)
        assert ts.forces.dtype == dtype
        advance = slot_step.make_slot_advance(tparams, mdtpu_torch.NVE(),
                                              engine, force_dtype=force_dtype)
        tout = slot_step.unslotify_state(advance(ts, steps))
    else:
        jengine = JNaive(potential=JLJ(r_cut=1.5), cutoff=1.5)
        e, w, f, nb = j_step.engine_forces(
            jengine, jstate.positions, jstate.diameters, jstate.unitcell,
            jstate.unitcell_inv, None, force_dtype=jfd)
        jstate = jstate.replace(forces=f.astype(jstate.positions.dtype),
                                nbrs=nb)
        jstep = j_step.make_md_step(jparams, JNVE(), jengine,
                                    force_dtype=jfd)
        jout = jax.jit(lambda s: jax.lax.fori_loop(
            0, steps, lambda i, x: jstep(x), s))(jstate)
        engine = NaivePairEngine(potential=tparams.potential, cutoff=1.5)
        e, w, f, nb = tstep.engine_forces(
            engine, tstate.positions, tstate.diameters, tstate.unitcell,
            tstate.unitcell_inv, None, force_dtype=force_dtype)
        tout = tstate.replace(forces=f.to(dtype), nbrs=nb)
        step = tstep.make_md_step(tparams, mdtpu_torch.NVE(), engine,
                                  force_dtype=force_dtype)
        for _ in range(steps):
            tout = step(tout)
        assert tout.energy.dtype == dtype
    assert tout.step == int(jout.step) == steps
    assert tout.positions.dtype == dtype and tout.forces.dtype == dtype
    moved = np.abs(tout.positions.numpy() - tstate.positions.numpy()).max()
    assert moved > 1e-3
    np.testing.assert_allclose(tout.positions.numpy(),
                               np.asarray(jout.positions), rtol=1e-6,
                               atol=1e-6 * L)


def test_force_dtype_with_hilo_raises_as_in_jax():
    _, tstate, L = _force_dtype_states(torch.float32)
    tparams = mdtpu_torch.Parameters(RHO_SMALL, N_SMALL, 0.002,
                                     LennardJones(r_cut=1.5))
    engine = CellGridEngine.create(tparams.potential, 1.5, 0.1,
                                   tstate.unitcell, N_SMALL)
    jengine = JCellGrid.create(JLJ(r_cut=1.5), 1.5, 0.1, np.eye(3) * L,
                               N_SMALL)
    jparams = JParameters(density=RHO_SMALL, n_particles=N_SMALL, dt=0.002,
                          potential=JLJ(r_cut=1.5))
    with pytest.raises(ValueError, match="hilo"):
        j_slot_step.make_slot_advance(jparams, JNVE(), jengine,
                                      force_dtype=jnp.float64, hilo=True)
    for make in (slot_step.make_slot_advance, slot_step.make_slot_step,
                 tstep.make_md_step):
        with pytest.raises(ValueError, match="force_dtype"):
            make(tparams, mdtpu_torch.NVE(), engine, hilo=True,
                 force_dtype=torch.float64)
