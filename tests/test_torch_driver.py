"""The slice as a whole: the port's run_simulation (CPU, cell-grid engine,
plain sweep) against the JAX package's run_simulation from one
jittered-lattice state (N = 4096, rho = 0.8, LJ r_c = 2.5, f64), in NVE and
in NVT with the port's Bussi draws replaced by JAX's. Thermo rows agree to
rel 1e-9, final positions and trajectory frames to 1e-9 absolute; the two
packages' xyz and LAMMPS formatters give identical bytes for equal arrays."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdtpu_torch
from mdtpu.core.types import NVE as JNVE
from mdtpu.core.types import NVT as JNVT
from mdtpu.core.types import Parameters as JParameters
from mdtpu.io.lammps import format_lammps_frame as j_format_lammps
from mdtpu.io.xyz import write_xyz as j_write_xyz
from mdtpu.potentials.lennard_jones import LennardJones as JLJ
from mdtpu.sim.driver import run_simulation as j_run_simulation
from mdtpu.sim.initialization import build_state_from_arrays as j_build_state
from mdtpu_torch.integrate import thermostat as tthermo
from mdtpu_torch.interop import (params_from_fields, potential_from_fields,
                                 state_from_numpy, state_to_numpy)
from mdtpu_torch.io.lammps import format_lammps_frame as t_format_lammps
from mdtpu_torch.io.xyz import write_xyz as t_write_xyz
from mdtpu_torch.ops.cell_grid import CellGridEngine, CellGridState
from tests.test_torch_thermostat import jax_bussi_draws

N, RHO, DT = 4096, 0.8, 0.002
STEPS, FREQ = 20, 5
KEY_SEED = 7
_NUMBER = re.compile(r"^-?\d+(\.\d*)?([eE][-+]?\d+)?$")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tests run torch on one thread. The suite runs in
    several worker processes at once, and torch's OpenMP threads, spinning
    at every barrier on an oversubscribed machine, then slow its many small
    tensor ops down by an order of magnitude. Modules that import this
    fixture get it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _initial_arrays():
    rng = np.random.default_rng(2024)
    L = (N / RHO) ** (1.0 / 3.0)
    per = int(np.ceil(N ** (1 / 3)))
    idx = np.indices((per,) * 3).reshape(3, -1).T[:N]
    pos = (idx + 0.5) / per * L + 0.05 * rng.normal(size=(N, 3))
    vel = rng.normal(size=(N, 3))
    vel -= vel.mean(axis=0)
    vel *= np.sqrt(1.0 / (np.sum(vel * vel) / (3 * (N - 1))))
    return pos, vel, np.eye(3) * L


def _run_both(tmp_path, jax_ensemble, port_ensemble, port_engine=None):
    """Both packages' run_simulation from one state; ``port_engine(state)``
    builds the port's engine (default: its select_engine)."""
    pos, vel, cell = _initial_arrays()
    jstate = j_build_state(pos, np.ones(N), cell, jax.random.PRNGKey(KEY_SEED),
                           velocities=vel, dtype=jnp.float64, cutoff=2.5)
    jpot = JLJ(r_cut=2.5)
    jparams = JParameters(density=RHO, n_particles=N, dt=DT, potential=jpot)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jout = j_run_simulation(jstate, jparams, jax_ensemble, STEPS, FREQ, jdir)

    fields = {name: np.asarray(getattr(jstate, name)) for name in
              ("positions", "velocities", "forces", "images", "diameters",
               "unitcell", "unitcell_inv", "step", "nf", "energy", "virial",
               "temperature", "pos_comp", "vel_comp")}
    fields["cutoff"] = jstate.cutoff
    tstate = state_from_numpy(fields, device="cpu")
    tparams = params_from_fields(RHO, N, DT, potential_from_fields(
        "LennardJones", {"r_cut": 2.5}))
    engine = None if port_engine is None else port_engine(tstate)
    tout = mdtpu_torch.run_simulation(tstate, tparams, port_ensemble, STEPS,
                                      FREQ, tdir, engine=engine, device="cpu")
    return jout, tout, jdir, tdir


def _tokens(path):
    with open(path) as f:
        return [line.split() for line in f]


def _assert_same_numbers(path_a, path_b, atol):
    a, b = _tokens(path_a), _tokens(path_b)
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for ta, tb in zip(ra, rb):
            if _NUMBER.match(ta) and _NUMBER.match(tb):
                assert abs(float(ta) - float(tb)) <= atol, (ta, tb)
            else:
                assert ta == tb


def _compare(jout, tout, jdir, tdir):
    assert tout.step == int(jout.step) == STEPS
    rows_j = np.loadtxt(os.path.join(jdir, "thermo.txt"))
    rows_t = np.loadtxt(os.path.join(tdir, "thermo.txt"))
    assert rows_t.shape == (STEPS // FREQ, 4)
    np.testing.assert_array_equal(rows_t[:, 0], rows_j[:, 0])
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-9, atol=0)
    np.testing.assert_allclose(tout.positions.numpy(),
                               np.asarray(jout.positions), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tout.images.numpy(), np.asarray(jout.images))
    traj_t = os.path.join(tdir, "trajectory.xyz")
    assert open(traj_t).read().count("ITEM: TIMESTEP") == STEPS // FREQ
    _assert_same_numbers(traj_t, os.path.join(jdir, "trajectory.xyz"), 1e-9)
    _assert_same_numbers(os.path.join(tdir, "final.xyz"),
                         os.path.join(jdir, "final.xyz"), 1e-9)


def test_run_simulation_nve_matches_jax(tmp_path):
    jout, tout, jdir, tdir = _run_both(tmp_path, JNVE(), mdtpu_torch.NVE())
    assert isinstance(tout.nbrs, CellGridState)   # ran the cell grid
    _compare(jout, tout, jdir, tdir)


def test_run_simulation_nvt_replayed_noise_matches_jax(tmp_path, monkeypatch):
    key = jax.random.PRNGKey(KEY_SEED)

    def replay(seed, step, nf, dtype, device):
        r1, r2 = jax_bussi_draws(key, step, nf)
        return (torch.tensor(r1, dtype=dtype, device=device),
                torch.tensor(r2, dtype=dtype, device=device))

    monkeypatch.setattr(tthermo, "bussi_noise", replay)
    jout, tout, jdir, tdir = _run_both(tmp_path, JNVT(1.0, 0.4),
                                       mdtpu_torch.NVT(1.0, 0.4))
    _compare(jout, tout, jdir, tdir)


def test_driver_picks_the_cell_grid():
    pos, vel, cell = _initial_arrays()
    state = mdtpu_torch.sim.initialization.build_state_from_arrays(
        pos, np.ones(N), cell, 0, velocities=vel, dtype=torch.float64,
        cutoff=2.5, device="cpu")
    engine = mdtpu_torch.select_engine(mdtpu_torch.LennardJones(r_cut=2.5),
                                       2.5, state)
    assert isinstance(engine, CellGridEngine) and engine.grid == (6, 6, 6)
    small = mdtpu_torch.select_engine(mdtpu_torch.LennardJones(r_cut=2.5),
                                      2.5, n_particles=1000,
                                      unitcell=np.eye(3) * 10.8)
    assert isinstance(small, mdtpu_torch.NaivePairEngine)


def test_state_round_trip_and_init_from_file(tmp_path):
    """interop carries a state both ways; initialize_state mode B reads the
    JAX package's Extended-XYZ files."""
    pos, vel, cell = _initial_arrays()
    jstate = j_build_state(pos, np.ones(N), cell, jax.random.PRNGKey(1),
                           velocities=vel, dtype=jnp.float64, cutoff=2.5)
    fields = {"positions": pos, "velocities": vel, "forces": np.zeros_like(pos),
              "images": np.zeros((N, 3), np.int32), "diameters": np.ones(N),
              "unitcell": cell, "unitcell_inv": np.linalg.inv(cell),
              "step": 3, "nf": 3.0 * (N - 1), "energy": 0.0, "virial": 0.0,
              "temperature": 0.0, "pos_comp": np.zeros_like(pos),
              "vel_comp": np.zeros_like(pos), "cutoff": 2.5, "seed": 9,
              "key": np.asarray(jstate.key)}
    back = state_to_numpy(state_from_numpy(fields, device="cpu"))
    assert back["step"] == 3 and back["seed"] == 9 and back["cutoff"] == 2.5
    assert back["images"].dtype == np.int64
    np.testing.assert_array_equal(back["positions"], pos)
    # The Brownian accumulators start at zero when absent and ride both ways,
    # from the JAX state's own fields too.
    assert back["virial_accum"] == 0.0 and back["nprom"] == 0
    jfields = {**fields, "virial_accum": np.asarray(12.5),
               "nprom": np.asarray(jstate.nprom) + 3}
    back = state_to_numpy(state_from_numpy(jfields, device="cpu"))
    assert back["virial_accum"] == 12.5 and back["virial_accum"].dtype \
        == np.float64
    assert back["nprom"] == 3 and back["nprom"].dtype == np.int64
    again = state_to_numpy(state_from_numpy(back, device="cpu"))
    assert again["virial_accum"] == 12.5 and again["nprom"] == 3
    with pytest.raises(ValueError, match="unknown state fields"):
        state_from_numpy({**fields, "bogus": 1}, device="cpu")

    path = str(tmp_path / "snap.xyz")
    j_write_xyz(path, 0, cell, pos, np.full(N, 1.1), mode="w")
    params = mdtpu_torch.Parameters(RHO, N, DT, mdtpu_torch.LennardJones())
    st = mdtpu_torch.initialize_state(params, str(tmp_path / "run"),
                                      from_file=path, cutoff=2.5,
                                      dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(st.positions.numpy(), pos, atol=5e-7)
    np.testing.assert_allclose(st.diameters.numpy(), 1.1, atol=1e-6)
    np.testing.assert_allclose(st.unitcell.numpy(), cell)
    assert (tmp_path / "run" / "init.xyz").is_file()
    assert mdtpu_torch.initial_temperature_for_velocities(
        mdtpu_torch.LinearRamp(0.5, 2.0, 10)) == 2.0


@pytest.mark.parametrize("dim,tilted", [(3, False), (3, True), (2, False)])
def test_formatters_are_byte_identical(tmp_path, dim, tilted):
    rng = np.random.default_rng(dim + 10 * tilted)
    n = 300
    cell = np.diag(rng.uniform(5.0, 9.0, dim))
    if tilted:
        cell[0, 1] = 0.7
    pos = rng.uniform(-0.5, 9.5, (n, dim))
    pos[:5] = np.round(pos[:5], 6) + 5e-7   # at %.6f rounding boundaries
    images = rng.integers(-4, 5, (n, dim)).astype(np.int32)
    diam = rng.uniform(0.8, 1.2, n)
    assert (t_format_lammps(12, cell, pos, images, diam)
            == j_format_lammps(12, cell, pos, images, diam))
    a, b = str(tmp_path / "a.xyz"), str(tmp_path / "b.xyz")
    t_write_xyz(a, 40, cell, torch.from_numpy(pos), torch.from_numpy(diam),
                mode="w")
    j_write_xyz(b, 40, cell, pos, diam, mode="w")
    assert open(a, "rb").read() == open(b, "rb").read()
