"""The slot route of ``run_simulation`` against the JAX package's slot route,
both on a cell-grid engine of skin 0.04 (so that the run re-bins several
times), from one jittered-lattice state (N = 4096, rho = 0.8, LJ r_c = 2.5):

  * f64 NVE and NVT (the port's Bussi draws replaced by JAX's): thermo rows
    to rel 1e-9, trajectory frames and ``final.xyz`` to 1e-9, through at
    least two rebins of the port (counted);
  * f32 NVE takes the hi/lo sweep on both sides (counted on the port's):
    thermo rows within 1e-5 (relative, or absolute below 1), as
    ``tests/test_torch_hilo.py`` holds the particle-order route: the two
    sweeps sum the float32 virial in different orders;
  * a capacity overflow in the middle of the run: the capacity is that of
    the fullest cell, and one particle, moved to just outside a full cell's
    face, walks in (as ``tests/test_driver.py`` aims one); both packages
    restore and rerun on a grown engine, and the rows agree to rel 1e-9.

The JAX runs are module fixtures, one per case."""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdtpu_torch
from mdtpu.core.types import NVE as JNVE
from mdtpu.core.types import NVT as JNVT
from mdtpu.core.types import Parameters as JParameters
from mdtpu.ops.cell_grid import CellGridEngine as JCellGrid
from mdtpu.potentials.lennard_jones import LennardJones as JLJ
from mdtpu.sim.driver import run_simulation as j_run_simulation
from mdtpu.sim.initialization import build_state_from_arrays as j_build_state
from mdtpu_torch.integrate import slot_step
from mdtpu_torch.integrate import thermostat as tthermo
from mdtpu_torch.ops import cell_grid as grid_mod
from mdtpu_torch.ops.cell_grid import CellGridEngine, CellGridState
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.sim.initialization import build_state_from_arrays
from tests.test_torch_driver import (KEY_SEED, N, RHO, _assert_same_numbers,
                                     _initial_arrays)
from tests.test_torch_driver import one_torch_thread  # noqa: F401
from tests.test_torch_thermostat import jax_bussi_draws

DT, STEPS, FREQ, SKIN = 0.002, 9, 3, 0.04
CASES = {
    "nve": (JNVE(), jnp.float64, False),
    "nvt": (JNVT(1.0, 0.4), jnp.float64, False),
    "nve_f32": (JNVE(), jnp.float32, False),
    "overflow": (JNVE(), jnp.float64, True),
}
GRID = 6   # cells per axis of the engine: 16 lattice planes in 6 cells


def _jax_engine(capacity=None):
    _, _, cell = _initial_arrays()
    return JCellGrid.create(JLJ(r_cut=2.5), 2.5, SKIN, cell, N,
                            cell_capacity=capacity)


def _overflow_arrays():
    """The lattice with one particle moved into the hollow on the face
    between two full cells along x (8 lattice neighbours at ~0.93), 0.033
    outside the lower cell, walking in at speed 5; and the capacity of the
    fullest cell."""
    pos, vel, cell = _initial_arrays()
    L = cell[0, 0]
    coords = np.clip(np.floor(pos / L * GRID).astype(int), 0, GRID - 1)
    cid = (coords[:, 0] * GRID + coords[:, 1]) * GRID + coords[:, 2]
    counts = np.bincount(cid, minlength=GRID ** 3)
    full = counts.max()
    home = np.array([i for i in range(GRID ** 3) if counts[i] == full
                     and i + GRID * GRID < GRID ** 3
                     and counts[i + GRID * GRID] == full][0])
    upper = home + GRID * GRID
    members = np.flatnonzero(cid == upper)
    centre = (np.array([home // 36 + 1, home // 6 % 6, home % 6]) + 0.5) \
        * L / GRID
    near = members[np.argsort(
        np.abs(pos[members, 0] - pos[members, 0].min())
        + np.abs(pos[members, 1:] - centre[1:]).sum(axis=1))[0]]
    spacing = L / 16
    face = (home // 36 + 1) * L / GRID
    pos = pos.copy()
    vel = vel.copy()
    pos[near] = [face + 0.033, pos[near, 1] + spacing / 2,
                 pos[near, 2] + spacing / 2]
    vel[near] = [-5.0, 0.0, 0.0]
    return pos, vel, cell, int(full)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each case's JAX run on its cell grid (the slot route), lazily."""
    done = {}

    def run(case):
        if case not in done:
            ensemble, dtype, aimed = CASES[case]
            pos, vel, cell, capacity = (_overflow_arrays() if aimed
                                        else (*_initial_arrays(), None))
            state = j_build_state(pos, np.ones(N), cell,
                                  jax.random.PRNGKey(KEY_SEED),
                                  velocities=vel, dtype=dtype, cutoff=2.5)
            params = JParameters(density=RHO, n_particles=N, dt=DT,
                                 potential=JLJ(r_cut=2.5))
            out_dir = str(tmp_path_factory.mktemp(f"jax_{case}"))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                j_run_simulation(state, params, ensemble, STEPS, FREQ,
                                 out_dir, engine=_jax_engine(capacity))
            done[case] = out_dir
        return done[case]

    return run


def _port_run(tmp_path, monkeypatch, ensemble, dtype, aimed=False):
    """The port's run on the same grid and capacity, counting its rebins."""
    rebins = []
    rebin = slot_step._rebin

    def counted(state, engine):
        rebins.append(1)
        return rebin(state, engine)

    monkeypatch.setattr(slot_step, "_rebin", counted)
    pos, vel, cell, capacity = (_overflow_arrays() if aimed
                                else (*_initial_arrays(), None))
    jeng = _jax_engine(capacity)
    assert jeng.grid == (GRID,) * 3
    engine = CellGridEngine(potential=LennardJones(r_cut=2.5), cutoff=2.5,
                            skin=SKIN, grid=jeng.grid,
                            cell_capacity=jeng.cell_capacity)
    state = build_state_from_arrays(pos, np.ones(N), cell, velocities=vel,
                                    dtype=dtype, cutoff=2.5, device="cpu")
    params = mdtpu_torch.Parameters(RHO, N, DT, LennardJones(r_cut=2.5))
    out_dir = str(tmp_path / "port")
    steps_before = slot_step.make_slot_step.steps
    out = mdtpu_torch.run_simulation(state, params, ensemble, STEPS, FREQ,
                                     out_dir, engine=engine, device="cpu")
    assert out.step == STEPS
    assert isinstance(out.nbrs, CellGridState) and out.ids is None
    assert slot_step.make_slot_step.steps - steps_before >= STEPS
    return out, out_dir, len(rebins)


def _rows(path):
    return np.loadtxt(os.path.join(path, "thermo.txt"))


def _compare(jdir, tdir, n_rebins):
    assert n_rebins >= 2
    rows_j, rows_t = _rows(jdir), _rows(tdir)
    assert rows_t.shape == (STEPS // FREQ, 4)
    np.testing.assert_array_equal(rows_t[:, 0], rows_j[:, 0])
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-9, atol=0)
    traj = os.path.join(tdir, "trajectory.xyz")
    assert open(traj).read().count("ITEM: TIMESTEP") == STEPS // FREQ
    _assert_same_numbers(traj, os.path.join(jdir, "trajectory.xyz"), 1e-9)
    _assert_same_numbers(os.path.join(tdir, "final.xyz"),
                         os.path.join(jdir, "final.xyz"), 1e-9)


def test_nve_matches_jax_slot_route(tmp_path, monkeypatch, jax_runs):
    _, tdir, n_rebins = _port_run(tmp_path, monkeypatch, mdtpu_torch.NVE(),
                                  torch.float64)
    _compare(jax_runs("nve"), tdir, n_rebins)


def test_nvt_replayed_noise_matches_jax_slot_route(tmp_path, monkeypatch,
                                                   jax_runs):
    key = jax.random.PRNGKey(KEY_SEED)

    def replay(seed, step, nf, dtype, device):
        r1, r2 = jax_bussi_draws(key, step, nf)
        return (torch.tensor(r1, dtype=dtype, device=device),
                torch.tensor(r2, dtype=dtype, device=device))

    monkeypatch.setattr(tthermo, "bussi_noise", replay)
    _, tdir, n_rebins = _port_run(tmp_path, monkeypatch,
                                  mdtpu_torch.NVT(1.0, 0.4), torch.float64)
    _compare(jax_runs("nvt"), tdir, n_rebins)


def test_f32_nve_takes_the_hilo_sweep_like_jax(tmp_path, monkeypatch,
                                               jax_runs):
    calls = []
    hilo = grid_mod.cell_sweep_hilo
    monkeypatch.setattr(grid_mod, "cell_sweep_hilo",
                        lambda *a: calls.append(a[-1]) or hilo(*a))
    out, tdir, n_rebins = _port_run(tmp_path, monkeypatch, mdtpu_torch.NVE(),
                                    torch.float32)
    # Every step takes the hi/lo sweep; all but the last of a segment lean.
    assert len(calls) == STEPS and calls.count(True) == STEPS // FREQ + 1
    assert n_rebins >= 2 and out.positions.dtype == torch.float32
    rows_j, rows_t = _rows(jax_runs("nve_f32")), _rows(tdir)
    assert rows_t.shape == rows_j.shape == (STEPS // FREQ, 4)
    assert np.all(np.abs(rows_t - rows_j)
                  <= 1e-5 * np.maximum(1.0, np.abs(rows_j)))


def test_capacity_overflow_mid_run_restores_like_jax(tmp_path, monkeypatch,
                                                     jax_runs):
    with pytest.warns(UserWarning, match="capacity overflow"):
        out, tdir, n_rebins = _port_run(tmp_path, monkeypatch,
                                        mdtpu_torch.NVE(), torch.float64,
                                        aimed=True)
    _compare(jax_runs("overflow"), tdir, n_rebins)
    assert out.positions.shape == (N, 3)
