"""A user potential's routes, eager on the CPU, against the JAX package.

On the card every route of a potential without a kernel functor runs its
loop captured (one graph launch a segment variant or a minimization), as
the JAX package traces a user's ``evaluate`` into its jitted loops. The
routes here run the same ``DeviceAdvance`` and ``DeviceFire`` programs
eagerly, the kernels' plain versions in place of the kernels, with
``examples/03_polydisperse_2d.py``'s potential in each package's copy (the
port's ``NonAdditivePHS`` of ``tests/test_torch_gpu.py``, the JAX
package's ``JNonAdditivePHS`` of ``tests/test_torch_geometry.py``), 600
disks at rho 0.9, diameters U(0.8, 1.2), f64:

  * NVT in slots on the cell grid (the pair list), 20 steps through
    ``run_simulation`` with a small skin (so the run rebins), the port's
    Bussi draws replaced by the JAX package's;
  * the slot FIRE on the cell grid, 30 iterations;
  * NVT in particle order on the neighbour list (its tiles in torch, K1's
    plain build at rebuilds), 20 steps.

Rows to rel 1e-10, energies to rel 1e-10, positions to 1e-10 of the box
length. The naive engine's route (config 4 as written, N = 1200) is held in
``tests/test_torch_geometry_driver.py`` and the sharded route at 2 gloo
ranks in ``tests/test_torch_sharded_driver.py``."""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdtpu
import mdtpu_torch
from mdtpu.core.types import NVT as JNVT
from mdtpu.core.types import Parameters as JParameters
from mdtpu.minimize.fire import fire_minimize as j_fire_minimize
from mdtpu.ops.cell_grid import CellGridEngine as JCellGrid
from mdtpu.ops.neighbor_list import NeighborListEngine as JNeighborList
from mdtpu.sim.driver import run_simulation as j_run_simulation
from mdtpu.sim.initialization import build_state_from_arrays as j_build_state
from mdtpu_torch.integrate import slot_step
from mdtpu_torch.integrate import thermostat as tthermo
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.neighbor_list import NeighborListEngine, NeighborState
from mdtpu_torch.sim.initialization import build_state_from_arrays
from tests.test_torch_driver import _assert_same_numbers
from tests.test_torch_driver import one_torch_thread  # noqa: F401
from tests.test_torch_geometry import JNonAdditivePHS, lattice
from tests.test_torch_gpu import NonAdditivePHS
from tests.test_torch_thermostat import jax_bussi_draws

N, RHO, CUTOFF = 600, 0.9, 1.8
STEPS, FREQ, KEY_SEED = 20, 5, 3
REL = 1e-10


def _system():
    """A jittered lattice, diameters U(0.8, 1.2), velocities at T ~ 0.5."""
    L = (N / RHO) ** 0.5
    cell = np.eye(2) * L
    pos, diam = lattice(N, cell, 0.05, 12, poly=0.2)
    vel = np.random.default_rng(13).normal(size=(N, 2)) * 0.7
    vel -= vel.mean(axis=0)
    return pos, vel, diam, cell


def _states(dtype=jnp.float64):
    pos, vel, diam, cell = _system()
    jstate = j_build_state(pos, diam, cell, jax.random.PRNGKey(KEY_SEED),
                           velocities=vel, dtype=dtype, cutoff=CUTOFF)
    state = build_state_from_arrays(pos, diam, cell, velocities=vel,
                                    dtype=torch.float64, cutoff=CUTOFF,
                                    device="cpu")
    jparams = JParameters(density=RHO, n_particles=N, dt=0.002,
                          potential=JNonAdditivePHS())
    params = mdtpu_torch.Parameters(RHO, N, 0.002, NonAdditivePHS())
    return jstate, jparams, state, params, cell


def _replay_bussi(monkeypatch):
    key = jax.random.PRNGKey(KEY_SEED)

    def replay(seed, step, nf, dtype, device):
        r1, r2 = jax_bussi_draws(key, step, nf)
        return (torch.tensor(r1, dtype=dtype, device=device),
                torch.tensor(r2, dtype=dtype, device=device))

    monkeypatch.setattr(tthermo, "bussi_noise", replay)


def _rows(path):
    return np.loadtxt(os.path.join(path, "thermo.txt"))


def _compare_runs(jdir, tdir, box):
    rows_j, rows_t = _rows(jdir), _rows(tdir)
    assert rows_t.shape == (STEPS // FREQ, 4)
    np.testing.assert_array_equal(rows_t[:, 0], rows_j[:, 0])
    np.testing.assert_allclose(rows_t, rows_j, rtol=REL, atol=0)
    _assert_same_numbers(os.path.join(tdir, "final.xyz"),
                         os.path.join(jdir, "final.xyz"), REL * box)


def test_user_nvt_in_slots_matches_jax(tmp_path, monkeypatch):
    """The slot route on the pair list (``SlotAdvance``'s program, eager
    here), rebinning, against the JAX package's slot route on its cell
    grid."""
    jstate, jparams, state, params, cell = _states()
    jeng = JCellGrid.create(jparams.potential, CUTOFF, 0.02, cell, N,
                            diameters=state.diameters.numpy())
    eng = CellGridEngine.create(params.potential, CUTOFF, 0.02, cell, N,
                                cell_capacity=jeng.cell_capacity)
    assert eng.grid == tuple(jeng.grid) and eng.uses_pair_list
    jdir = str(tmp_path / "jax")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_run_simulation(jstate, jparams, JNVT(0.5, 0.01), STEPS, FREQ, jdir,
                         engine=jeng)
    _replay_bussi(monkeypatch)
    rebins = []
    rebin = slot_step._rebin
    monkeypatch.setattr(slot_step, "_rebin",
                        lambda s, e: rebins.append(1) or rebin(s, e))
    tdir = str(tmp_path / "port")
    out = mdtpu_torch.run_simulation(state, params,
                                     mdtpu_torch.NVT(0.5, 0.01), STEPS, FREQ,
                                     tdir, engine=eng, device="cpu")
    assert out.step == STEPS and len(rebins) >= 2
    _compare_runs(jdir, tdir, cell[0, 0])


def test_user_slot_fire_matches_jax():
    """The slot FIRE on the pair list (``SlotFire``'s program, eager here)
    against the JAX package's slot FIRE on its cell grid: 30 iterations,
    energy and positions."""
    jstate, jparams, state, params, cell = _states()
    jeng = JCellGrid.create(jparams.potential, CUTOFF, 0.3, cell, N,
                            diameters=state.diameters.numpy())
    eng = CellGridEngine.create(params.potential, CUTOFF, 0.3, cell, N,
                                cell_capacity=jeng.cell_capacity)
    jout, je, _, jn = j_fire_minimize(jstate, jparams, jeng, max_steps=30,
                                      tol=0.0)
    out, e, _, n = mdtpu_torch.fire_minimize(state, params, eng,
                                             max_steps=30, tol=0.0,
                                             device="cpu")
    assert n == int(jn) == 30
    np.testing.assert_allclose(float(e), float(je), rtol=REL)
    np.testing.assert_allclose(out.positions.numpy(),
                               np.asarray(jout.positions), rtol=0,
                               atol=REL * cell[0, 0])


def test_user_nvt_on_the_neighbour_list_matches_jax(tmp_path, monkeypatch):
    """Particle order on the neighbour list (``ParticleAdvance``'s program,
    eager here; the potential on the list's tiles in torch), rebuilding,
    against the JAX package's run on its list of the same capacities."""
    jstate, jparams, state, params, cell = _states()
    jeng = JNeighborList.create(jparams.potential, CUTOFF, 0.05, cell, N)
    eng = NeighborListEngine.create(params.potential, CUTOFF, 0.05, cell, N,
                                    cell_capacity=jeng.cell_capacity,
                                    max_neighbors=jeng.max_neighbors)
    assert eng.grid == tuple(jeng.grid) and not eng.uses_kernel
    jdir = str(tmp_path / "jax")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_run_simulation(jstate, jparams, JNVT(0.5, 0.01), STEPS, FREQ, jdir,
                         engine=jeng)
    _replay_bussi(monkeypatch)
    built = []
    allocate = NeighborListEngine.allocate
    monkeypatch.setattr(NeighborListEngine, "allocate",
                        lambda self, *a: built.append(1) or allocate(self,
                                                                     *a))
    tdir = str(tmp_path / "port")
    out = mdtpu_torch.run_simulation(state, params,
                                     mdtpu_torch.NVT(0.5, 0.01), STEPS, FREQ,
                                     tdir, engine=eng, device="cpu")
    assert isinstance(out.nbrs, NeighborState) and out.step == STEPS
    assert len(built) >= 2
    _compare_runs(jdir, tdir, cell[0, 0])


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    pytest.main([__file__, "-q"])
