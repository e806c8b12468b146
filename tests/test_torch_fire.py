"""FIRE (``mdtpu_torch.minimize``) against the JAX package on the CPU, from
one packed Lennard-Jones fluid (N = 256, rho 0.5, force-shifted r_c 1.5,
f64), stepwise at fixed iteration counts as ``tests/test_fire_slots.py``
holds the JAX package's own (FIRE on a stiff fluid is chaotic, so equal
energies after equal iterations are the meaningful check):

  * the slot FIRE (cell grid) against the JAX package's slot FIRE, through
    several rebins (counted): energy to rel 1e-10, the same iteration count,
    positions to 1e-9, the caller's velocities restored; from a capacity too
    small for the start, the retry on a grown engine gives the same;
  * the particle-order FIRE (``_fire_once``, the naive engine) against the
    JAX package's;
  * ``minimize`` writes ``minimized.xyz`` byte for byte as the JAX package's,
    and checks its ``method`` and ``dimension`` arguments;
  * on ``bench_fire.py``'s dense jittered lattice (rho 0.8, LJ r_c 2.5, here
    N = 500), FIRE with the reference's step limits overshoots: the energy
    falls for ~20 iterations, then climbs above the start's. The JAX
    package's slot FIRE does so and the port's follows it step for step.

Run as a script (``python -m tests.test_torch_fire`` from the repository
root) it prints that climb's energies, the JAX package's beside the port's,
out to 200 iterations, where FIRE's chaos has long parted the two
trajectories."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdtpu
import mdtpu_torch
from mdtpu.core.types import Parameters as JParameters
from mdtpu.minimize.fire import _fire_once as j_fire_once
from mdtpu.minimize.fire import fire_minimize as j_fire_minimize
from mdtpu.ops.cell_grid import CellGridEngine as JCellGrid
from mdtpu.ops.naive import NaivePairEngine as JNaive
from mdtpu.potentials.lennard_jones import LennardJones as JLJ
from mdtpu.sim.initialization import \
    lattice_fluid_state as j_lattice_fluid_state
from mdtpu_torch.integrate import slot_step
from mdtpu_torch.minimize import fire as fire_mod
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.sim.initialization import build_state_from_arrays
from tests.test_dynamics import make_fluid_state
from tests.test_torch_driver import one_torch_thread  # noqa: F401

N, RHO = 256, 0.5
HYPER = dict(dt_initial=0.01, dt_max=0.1, alpha0=0.1, f_inc=1.2, f_dec=0.2,
             n_min=5, dmax=0.1)


@pytest.fixture(scope="module")
def system():
    """The JAX state and parameters, and the port's copies."""
    jstate = make_fluid_state(n=N, rho=RHO, temp=0.75, dtype=jnp.float64,
                              cutoff=1.5, seed=3)
    jpot = JLJ(r_cut=1.5, force_shift=True)
    jparams = JParameters(density=RHO, n_particles=N, dt=0.002,
                          potential=jpot)
    pot = LennardJones(r_cut=1.5, force_shift=True)
    state = build_state_from_arrays(
        np.array(jstate.positions), np.ones(N), np.array(jstate.unitcell),
        velocities=np.array(jstate.velocities), dtype=torch.float64,
        cutoff=1.5, device="cpu")
    params = mdtpu_torch.Parameters(RHO, N, 0.002, pot)
    return jstate, jparams, state, params


@pytest.mark.parametrize("capacity", [None, 3], ids=["fits", "grows"])
def test_slot_fire_stepwise_matches_jax(system, monkeypatch, capacity):
    jstate, jparams, state, params = system
    jengine = JCellGrid.create(jparams.potential, 1.5, 0.3,
                               np.array(jstate.unitcell), N)
    engine = CellGridEngine(potential=params.potential, cutoff=1.5, skin=0.3,
                            grid=jengine.grid,
                            cell_capacity=capacity or jengine.cell_capacity)
    rebins = []
    rebin = slot_step._rebin
    monkeypatch.setattr(slot_step, "_rebin",
                        lambda s, e: rebins.append(1) or rebin(s, e))
    for max_steps in (10, 60):
        jout, je, _, jn = j_fire_minimize(jstate, jparams, jengine,
                                          max_steps=max_steps, tol=1e-9)
        out, e, converged, n = mdtpu_torch.fire_minimize(
            state, params, engine, max_steps=max_steps, tol=1e-9,
            device="cpu")
        assert n == int(jn) == max_steps and not converged
        np.testing.assert_allclose(float(e), float(je), rtol=1e-10)
        np.testing.assert_allclose(out.positions.numpy(),
                                   np.array(jout.positions), rtol=0,
                                   atol=1e-9)
        assert out.positions.shape == (N, 3) and out.ids is None
        assert torch.equal(out.velocities, state.velocities)
    assert len(rebins) >= 4


def climb_system(n=500, dtype=jnp.float64):
    """``bench_fire.py``'s system at ``n`` particles: the JAX state, params
    and engine, and the port's copies on the same cell grid."""
    jstate = j_lattice_fluid_state(n, 0.8, 1.0, dtype=dtype, cutoff=2.5,
                                   jitter=0.05)
    jparams = JParameters(density=0.8, n_particles=n, dt=0.002,
                          potential=JLJ(r_cut=2.5))
    jengine = JCellGrid.create(jparams.potential, 2.5, 0.3,
                               np.array(jstate.unitcell), n)
    state = build_state_from_arrays(
        np.array(jstate.positions), np.ones(n), np.array(jstate.unitcell),
        velocities=np.array(jstate.velocities), dtype=torch.float64,
        cutoff=2.5, device="cpu")
    params = mdtpu_torch.Parameters(0.8, n, 0.002, LennardJones(r_cut=2.5))
    engine = CellGridEngine(potential=params.potential, cutoff=2.5, skin=0.3,
                            grid=jengine.grid,
                            cell_capacity=jengine.cell_capacity)
    return (jstate, jparams, jengine), (state, params, engine)


def climb_energies(jax_side, port_side, max_steps):
    """Both FIREs' energies and positions after ``max_steps`` iterations at
    ``tol=0``."""
    jout = j_fire_minimize(*jax_side, max_steps=max_steps, tol=0.0)
    out = mdtpu_torch.fire_minimize(*port_side, max_steps=max_steps, tol=0.0,
                                    device="cpu")
    assert out[3] == int(jout[3]) == max_steps
    return (float(jout[1]), np.array(jout[0].positions), float(out[1]),
            out[0].positions.numpy())


def test_slot_fire_climb_on_dense_lattice_matches_jax():
    jax_side, port_side = climb_system()
    energies = {}
    for max_steps in (0, 20, 40):
        je, jpos, e, pos = climb_energies(jax_side, port_side, max_steps)
        np.testing.assert_allclose(e, je, rtol=1e-10)
        np.testing.assert_allclose(pos, jpos, rtol=0, atol=1e-9)
        energies[max_steps] = je
    assert energies[20] < energies[0] < energies[40]


def test_particle_order_fire_matches_jax(system):
    jstate, jparams, state, params = system
    jout = j_fire_once(jstate, jparams,
                       JNaive(potential=jparams.potential, cutoff=1.5),
                       max_steps=40, tol=1e-9, **HYPER)
    out = fire_mod._fire_once(
        state, params,
        mdtpu_torch.NaivePairEngine(potential=params.potential, cutoff=1.5),
        max_steps=40, tol=1e-9, **HYPER)
    assert out[3] == int(jout[3]) == 40
    np.testing.assert_allclose(float(out[1]), float(jout[1]), rtol=1e-10)
    np.testing.assert_allclose(out[0].positions.numpy(),
                               np.array(jout[0].positions), rtol=0,
                               atol=1e-9)
    assert torch.equal(out[0].images,
                       torch.as_tensor(np.array(jout[0].images),
                                       dtype=torch.int64))


def test_minimize_writes_minimized_xyz_like_jax(system, tmp_path):
    jstate, jparams, state, params = system
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    jout = mdtpu.minimize(jstate, jparams, str(jdir), 3, max_steps=25)
    out = mdtpu_torch.minimize(state, params, str(tdir), 3, max_steps=25,
                               device="cpu")
    assert out[3] == int(jout[3]) == 25
    np.testing.assert_allclose(float(out[1]), float(jout[1]), rtol=1e-10)
    assert (tdir / "minimized.xyz").read_bytes() == \
        (jdir / "minimized.xyz").read_bytes()
    with pytest.raises(ValueError, match="method"):
        mdtpu_torch.minimize(state, params, str(tdir), method="CG",
                             device="cpu")
    with pytest.raises(ValueError, match="dimension"):
        mdtpu_torch.minimize(state, params, str(tdir), 2, device="cpu")
    with pytest.raises(ValueError, match="workload"):
        mdtpu_torch.select_engine(params.potential, 1.5, state,
                                  workload="sampling")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    jax_side, port_side = climb_system()
    print("bench_fire.py's system, N = 500, f64, CPU: FIRE energy")
    print(f"{'iterations':>10} {'JAX package':>22} {'port':>22} "
          f"{'max |dx|':>9}")
    for max_steps in (0, 20, 40, 50, 100, 200):
        je, jpos, e, pos = climb_energies(jax_side, port_side, max_steps)
        print(f"{max_steps:>10} {je!r:>22} {e!r:>22} "
              f"{np.abs(pos - jpos).max():9.2e}", flush=True)
