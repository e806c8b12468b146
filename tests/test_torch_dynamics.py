"""Dynamics integration tests through the port, as ``tests/test_dynamics.py``
holds the JAX package, with the same systems and thresholds on the port's
``make_step``, ``fire_minimize`` and ``pack_positions`` (its own packing and
draws, so the numbers are not the JAX package's; the thresholds are):

  * NVE at f64 (force-shifted LJ): window-averaged energy drift per
    particle < 5e-5 over 2000 steps;
  * NVT (Bussi, pseudo-hard spheres): mean temperature within 10% of the
    target;
  * NVE total momentum kept to 1e-9 (absolute, f64);
  * Brownian free diffusion: MSD within 10% of 2 d dt n;
  * the Brownian virial sampled at steps 0, 10 and 20 of 25 (``nprom`` 3);
  * FIRE: two LJ particles relax to r = 2^(1/6) (rel 1e-5), a dense fluid
    converges or gets its RMS force below 1e-4, a capacity grow leaks no
    grown engine state, and steep overlaps whose |F|^2 overflows f32 are
    resolved (energy below 1e-6 of its start);
  * packing leaves no pair closer than 0.97 (tol 1);
  * Kahan-compensated f32 NVE drifts < 2e-4 per particle over 3000 steps;
  * ``force_dtype=float32`` on an f64 state stays within 5e-4 of the f64
    trajectory over 100 steps, total energy within rel 1e-4.

The JAX package's own numbers for these steps, draws replayed, are held by
the port's parity tests: ``make_md_step`` NVE and NVT in
``tests/test_torch_driver.py``, the Brownian step and run in
``tests/test_torch_brownian.py``, FIRE step for step (and its retry on a
grown engine) in ``tests/test_torch_fire.py``, packing in
``tests/test_torch_pack.py`` and ``force_dtype`` in
``tests/test_torch_slot_step.py::test_force_dtype_matches_jax``."""

import numpy as np
import torch

from mdtpu_torch.core.box import unwrapped_positions
from mdtpu_torch.core.types import NVE, NVT, Brownian, Parameters
from mdtpu_torch.integrate.step import engine_forces, make_step
from mdtpu_torch.minimize.fire import fire_minimize
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.naive import NaivePairEngine
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                            initialize_velocities)
from mdtpu_torch.sim.pack import pack_positions
from tests.test_torch_driver import one_torch_thread  # noqa: F401


def make_fluid_state(n=128, rho=0.5, d=3, temp=1.0, dtype=torch.float64,
                     seed=0, cutoff=2.5):
    """``tests/test_dynamics.py``'s fluid through the port: packed at tol
    1, Maxwell velocities at ``temp``."""
    L = (n / rho) ** (1.0 / d)
    cell = np.eye(d) * L
    pos = pack_positions(3 * seed, cell, n, d, tol=1.0, dtype=dtype,
                         device="cpu")
    state = build_state_from_arrays(pos, np.ones(n), cell, 3 * seed + 2,
                                    dtype=dtype, cutoff=cutoff, device="cpu")
    v = initialize_velocities(temp, 3 * seed + 1, n, d, dtype=dtype,
                              device="cpu")
    return state.replace(velocities=v)


def run_steps(state, step_fn, n):
    for _ in range(n):
        state = step_fn(state)
    return state


def _with_forces(state, engine):
    e, w, f, nbrs = engine_forces(engine, state.positions, state.diameters,
                                  state.unitcell, state.unitcell_inv,
                                  state.nbrs)
    return state.replace(forces=f, energy=e, virial=w, nbrs=nbrs)


def _total_energy(s):
    return float(s.energy) + 0.5 * float(torch.sum(s.velocities ** 2))


def test_nve_energy_conservation_f64():
    # Force-shifted LJ: smooth at the cutoff, so total energy is conserved
    # up to the bounded Verlet oscillation.
    state = make_fluid_state(n=64, rho=0.4, temp=0.75)
    pot = LennardJones(r_cut=2.5, force_shift=True)
    params = Parameters(density=0.4, n_particles=64, dt=0.002, potential=pot)
    engine = NaivePairEngine(potential=pot, cutoff=2.5)
    state = _with_forces(state, engine)
    state = run_steps(state, make_step(params, NVT(0.75, 0.2), engine), 200)

    nve_step = make_step(params, NVE(), engine)
    state = _with_forces(state, engine)

    # Window-averaged energies (pointwise samples alias the bounded Verlet
    # oscillation; the secular drift is what matters).
    def window_mean(s, n_samples=20, stride=10):
        es = []
        for _ in range(n_samples):
            s = run_steps(s, nve_step, stride)
            es.append(_total_energy(s))
        return s, float(np.mean(es))

    state, e0 = window_mean(state)
    state = run_steps(state, nve_step, 2000)
    state, e1 = window_mean(state)
    drift = abs(e1 - e0) / 64
    assert drift < 5e-5, f"NVE drift per particle too large: {drift}"


def test_nvt_reaches_target_temperature():
    # The thermostat's own drive to target (its scale function on random
    # velocities) is tests/test_torch_thermostat.py::
    # test_bussi_drives_to_target_temperature; here through make_step.
    target = 1.4737
    state = make_fluid_state(n=128, rho=0.5, temp=0.5, cutoff=1.5)
    pot = PseudoHS()
    params = Parameters(density=0.5, n_particles=128, dt=0.001, potential=pot)
    engine = NaivePairEngine(potential=pot, cutoff=1.5)
    state = _with_forces(state, engine)
    step = make_step(params, NVT(target, 100 * 0.001), engine)

    state = run_steps(state, step, 300)
    temps = []
    for _ in range(50):
        state = run_steps(state, step, 10)
        temps.append(float(state.temperature))
    assert abs(np.mean(temps) - target) < 0.1 * target


def test_nve_momentum_conservation():
    state = make_fluid_state(n=64, rho=0.4, temp=1.0)
    pot = LennardJones(r_cut=2.5)
    params = Parameters(density=0.4, n_particles=64, dt=0.002, potential=pot)
    engine = NaivePairEngine(potential=pot, cutoff=2.5)
    state = _with_forces(state, engine)
    step = make_step(params, NVE(), engine)
    p0 = torch.sum(state.velocities, dim=0).numpy()
    state = run_steps(state, step, 500)
    p1 = torch.sum(state.velocities, dim=0).numpy()
    np.testing.assert_allclose(p1, p0, atol=1e-9)


def test_brownian_free_diffusion():
    # With no interactions, MSD per dimension = 2 t (sigma^2 = 2 dt a step).
    n, d = 1024, 3
    L = 200.0
    cell = np.eye(d) * L
    pos = np.random.default_rng(3).uniform(0.0, L, (n, d))
    state = build_state_from_arrays(pos, np.ones(n), cell, 3,
                                    dtype=torch.float64, cutoff=1.0,
                                    device="cpu")
    pot = LennardJones(epsilon=0.0, r_cut=0.5)
    params = Parameters(density=n / L ** 3, n_particles=n, dt=0.01,
                        potential=pot)
    engine = NaivePairEngine(potential=pot, cutoff=0.5)
    nsteps = 200
    state = run_steps(state, make_step(params, Brownian(1.0), engine),
                      nsteps)
    end = unwrapped_positions(state.positions, state.images,
                              state.unitcell).numpy()
    msd = np.mean(np.sum((end - pos) ** 2, axis=1))
    expected = 2 * d * params.dt * nsteps
    assert abs(msd - expected) / expected < 0.1


def test_brownian_accumulates_virial_every_10():
    state = make_fluid_state(n=64, rho=0.4, temp=1.0, cutoff=1.5)
    pot = PseudoHS()
    params = Parameters(density=0.4, n_particles=64, dt=1e-5, potential=pot)
    engine = NaivePairEngine(potential=pot, cutoff=1.5)
    state = run_steps(state, make_step(params, Brownian(1.0), engine), 25)
    assert int(state.nprom) == 3  # steps 0, 10, 20


def test_fire_minimizes_to_local_minimum():
    # Two LJ particles starting off-minimum must relax to r = 2^(1/6).
    pos = np.array([[4.0, 5.0, 5.0], [5.4, 5.0, 5.0]])
    state = build_state_from_arrays(pos, np.ones(2), np.eye(3) * 10.0, 0,
                                    dtype=torch.float64, cutoff=3.0,
                                    device="cpu")
    pot = LennardJones(r_cut=3.0)
    params = Parameters(density=0.01, n_particles=2, dt=0.001, potential=pot)
    engine = NaivePairEngine(potential=pot, cutoff=3.0)
    state2, energy, converged, n_steps = fire_minimize(
        state, params, engine, tol=1e-8, max_steps=5000, device="cpu")
    assert converged
    r = float(torch.linalg.norm(state2.positions[0] - state2.positions[1]))
    np.testing.assert_allclose(r, 2 ** (1 / 6), rtol=1e-5)
    np.testing.assert_allclose(float(energy), -1.0, rtol=1e-5)


def test_fire_minimizes_dense_fluid():
    state = make_fluid_state(n=96, rho=0.6, temp=1.0, cutoff=1.5, seed=5)
    pot = PseudoHS()
    params = Parameters(density=0.6, n_particles=96, dt=0.001, potential=pot)
    engine = NaivePairEngine(potential=pot, cutoff=1.5)
    e_before = float(engine.compute(state.positions, state.diameters,
                                    state.unitcell, state.unitcell_inv)[0])
    state2, energy, converged, _ = fire_minimize(state, params, engine,
                                                 tol=1e-6, max_steps=3000,
                                                 device="cpu")
    assert float(energy) <= e_before + 1e-9
    f_rms = float(torch.linalg.norm(state2.forces)) / np.sqrt(3 * 95)
    assert converged or f_rms < 1e-4


def test_fire_grow_does_not_leak_mismatched_nbrs():
    """When FIRE retries on engine capacity overflow it grows a PRIVATE
    engine copy; the returned state must not carry that grown engine's
    neighbour state (the caller's engine would read a wrong capacity)."""
    state = make_fluid_state(n=96, rho=0.6, temp=1.0, cutoff=1.5, seed=5)
    pot = PseudoHS()
    params = Parameters(density=0.6, n_particles=96, dt=0.001, potential=pot)
    tight = CellGridEngine.create(pot, 1.5, 0.3, state.unitcell, 96,
                                  cell_capacity=1)  # guaranteed overflow
    state2, energy, converged, _ = fire_minimize(state, params, tight,
                                                 tol=1e-6, max_steps=500,
                                                 device="cpu")
    assert state2.nbrs is None
    assert bool(torch.isfinite(state2.positions).all())
    assert np.isfinite(float(energy))


def test_pack_positions_removes_overlaps():
    n, d, rho = 256, 3, 0.5
    L = (n / rho) ** (1 / d)
    pos = pack_positions(7, np.eye(d) * L, n, d, tol=1.0,
                         dtype=torch.float64, device="cpu").numpy()
    dr = pos[:, None, :] - pos[None, :, :]
    dr -= L * np.round(dr / L)
    r = np.sqrt((dr ** 2).sum(-1) + np.eye(n) * 1e6)
    assert r.min() > 0.97
    assert pos.min() >= -1e-9 and pos.max() <= L + 1e-9


def test_kahan_compensation_improves_f32_drift():
    # The compensated integrator keeps NVE drift small in f32 over
    # thousands of steps.
    state = make_fluid_state(n=64, rho=0.4, temp=0.75, dtype=torch.float32)
    pot = LennardJones(r_cut=2.5, force_shift=True)
    params = Parameters(density=0.4, n_particles=64, dt=0.002, potential=pot)
    engine = NaivePairEngine(potential=pot, cutoff=2.5)
    state = _with_forces(state, engine)
    state = run_steps(state, make_step(params, NVT(0.75, 0.2), engine), 200)

    s = _with_forces(state, engine)
    step = make_step(params, NVE(), engine, compensated=True)
    s = run_steps(s, step, 1)
    e0 = _total_energy(s)
    s = run_steps(s, step, 3000)
    drift = abs(_total_energy(s) - e0) / 64
    assert drift < 2e-4, f"f32 compensated drift too large: {drift}"


def test_mixed_precision_nve():
    """f64 state + f32 forces (``force_dtype``): the trajectory stays within
    the f32 force-error envelope of the all-f64 run and its energy with it
    (the gate mode: f32-speed sweep, f64 integration)."""
    n = 256
    state = make_fluid_state(n=n, rho=0.5, temp=1.0, cutoff=1.5)
    pot = PseudoHS()
    params = Parameters(density=0.5, n_particles=n, dt=0.001, potential=pot)
    engine = CellGridEngine.create(pot, 1.5, 0.3, state.unitcell, n)
    s64 = _with_forces(state, engine)
    e, w, f, nbrs = engine_forces(engine, state.positions, state.diameters,
                                  state.unitcell, state.unitcell_inv, None,
                                  force_dtype=torch.float32)
    smx = state.replace(forces=f.to(torch.float64),
                        energy=e.to(torch.float64),
                        virial=w.to(torch.float64), nbrs=nbrs)
    step64 = make_step(params, NVE(), engine)
    stepmx = make_step(params, NVE(), engine, force_dtype=torch.float32)
    for _ in range(100):
        s64 = step64(s64)
        smx = stepmx(smx)

    assert smx.positions.dtype == torch.float64
    assert bool(torch.isfinite(smx.positions).all())
    np.testing.assert_allclose(smx.positions.numpy(), s64.positions.numpy(),
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(_total_energy(smx), _total_energy(s64),
                               rtol=1e-4)


def test_fire_survives_norm_overflow():
    """Steep-potential overlaps give |F| ~ 1e20+; a naive ||F||^2 overflows
    to inf in f32 and FIRE would stall at scale = inf/inf = nan. The
    max-scaled norms must keep minimizing."""
    state = make_fluid_state(n=128, rho=0.4, temp=0.0, dtype=torch.float32,
                             cutoff=1.5)
    # Plant a deep overlap: r = 0.4 -> pair energy ~ (2.5)^50 ~ 6e19 and
    # |F| ~ 1e22, whose square overflows f32.
    pos = state.positions.clone()
    pos[1] = pos[0] + torch.tensor([0.4, 0.0, 0.0])
    state = state.replace(positions=pos)
    pot = PseudoHS()
    params = Parameters(density=0.4, n_particles=128, dt=0.001, potential=pot)
    eng = NaivePairEngine(potential=pot, cutoff=1.5)
    e0, _, f0, _ = eng.compute(state.positions, state.diameters,
                               state.unitcell, state.unitcell_inv)
    assert not np.isfinite(float(torch.sum(f0 * f0)))  # the overflow is real
    out, e, conv, steps = fire_minimize(state, params, eng, max_steps=2000,
                                        tol=1e-4, device="cpu")
    assert np.isfinite(float(e))
    assert float(e) < float(e0) * 1e-6  # overlap resolved
    assert bool(torch.all(torch.isfinite(out.positions)))
