"""The slot route in 2D and in a tilted 3D box, FIRE and packing in 2D, and
BASELINE config 4, against the JAX package on the CPU:

  * 20-step ``run_simulation`` runs on a cell grid of small skin (so the
    runs re-bin), both packages on the same grid and capacity, f64, NVE and
    NVT (the port's Bussi draws replaced by JAX's): thermo rows to rel 1e-9,
    trajectory frames and ``final.xyz`` to 1e-9. The 2D system is
    ``bench_2d.py``'s (polydisperse pseudo-hard spheres at rho 0.7, cutoff
    1.3231) at N = 2500, the tilted one the bench's Lennard-Jones fluid
    (rho 0.8, r_c 2.5) at N = 4096 in a box whose columns carry the
    off-diagonals of ``tests/test_cell_grid.py:128-130`` scaled to L. A 2D
    float32 NVE run takes the slot route's hi/lo sweep on both sides
    (counted on the port's), rows within 1e-5;
  * slot FIRE in 2D (force-shifted Lennard-Jones in a tilted box, the cell
    grid) stepwise against the JAX package's (energy rel 1e-10, positions
    1e-9, through rebins), and
    packing in 2D with the JAX package's draws replayed (positions 1e-8);
  * config 4 as written (``examples/03_polydisperse_2d.py``, N = 1200: an
    XYZ start, ``minimize``, a few NVT steps), which takes the naive engine
    in both packages, with the user potential in each package's copy.

The JAX runs are module fixtures, computed once per case. Run as a script
(``python -m tests.test_torch_geometry_driver`` from the repository root)
it prints FIRE's energy on config 4's start after 300, 1000 and 3000
iterations at the step caps 0.1 and 0.01, both packages (ROADMAP C8)."""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdtpu
import mdtpu_torch
from mdtpu.core.types import NVE as JNVE
from mdtpu.core.types import NVT as JNVT
from mdtpu.core.types import Parameters as JParameters
from mdtpu.io.xyz import write_xyz as j_write_xyz
from mdtpu.minimize.fire import fire_minimize as j_fire_minimize
from mdtpu.ops.cell_grid import CellGridEngine as JCellGrid
from mdtpu.potentials.lennard_jones import LennardJones as JLJ
from mdtpu.potentials.pseudo_hs import PseudoHS as JPHS
from mdtpu.sim.driver import run_simulation as j_run_simulation
from mdtpu.sim.initialization import build_state_from_arrays as j_build_state
from mdtpu.sim.pack import pack_positions as j_pack_positions
from mdtpu_torch.integrate import slot_step
from mdtpu_torch.integrate import thermostat as tthermo
from mdtpu_torch.ops import cell_grid as grid_mod
from mdtpu_torch.ops.cell_grid import CellGridEngine, CellGridState
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from mdtpu_torch.sim import pack
from mdtpu_torch.sim.initialization import build_state_from_arrays
from tests.test_torch_driver import _assert_same_numbers
from tests.test_torch_driver import one_torch_thread  # noqa: F401
from tests.test_torch_geometry import JNonAdditivePHS, NonAdditivePHS, lattice
from tests.test_torch_thermostat import jax_bussi_draws

STEPS, FREQ, KEY_SEED = 20, 5, 11


def system_2d(n=2500, rho=0.7):
    """``bench_2d.py``'s system at ``n``: a lattice jittered by 0.01,
    diameters 1 + 0.2 (U - 0.5), Maxwell velocities at T = 1."""
    L = (n / rho) ** 0.5
    cell = np.eye(2) * L
    pos, _ = lattice(n, cell, 0.01, 1)
    rng = np.random.default_rng(2)
    diam = 1.0 + 0.2 * (rng.uniform(size=n) - 0.5)
    vel = rng.normal(size=(n, 2))
    vel -= vel.mean(axis=0)
    return pos, vel, diam, cell


def system_tilted(n=4096, rho=0.8):
    """The bench's LJ fluid in the tilted box [[L, L/8, L/12], [0, L, L/6],
    [0, 0, L]] (volume L^3)."""
    L = (n / rho) ** (1.0 / 3.0)
    cell = np.array([[L, L / 8, L / 12], [0.0, L, L / 6], [0.0, 0.0, L]])
    pos, diam = lattice(n, cell, 0.05, 3)
    vel = np.random.default_rng(4).normal(size=(n, 3))
    vel -= vel.mean(axis=0)
    return pos, vel, diam, cell


# name -> (system, port potential, JAX potential, cutoff, skin, dt)
SYSTEMS = {
    "2d": (system_2d, PseudoHS(), JPHS(), 1.3231, 0.02, 0.001),
    "tilted": (system_tilted, LennardJones(r_cut=2.5), JLJ(r_cut=2.5), 2.5,
               0.04, 0.002),
}
CASES = {
    "2d_nve": ("2d", JNVE(), jnp.float64),
    "2d_nvt": ("2d", JNVT(1.0, 0.1), jnp.float64),
    "2d_nve_f32": ("2d", JNVE(), jnp.float32),
    "tilted_nve": ("tilted", JNVE(), jnp.float64),
    "tilted_nvt": ("tilted", JNVT(1.0, 0.4), jnp.float64),
}


def _jax_engine(name):
    make, _, jpot, cutoff, skin, _ = SYSTEMS[name]
    pos, _, diam, cell = make()
    return JCellGrid.create(jpot, cutoff, skin, cell, len(pos),
                            diameters=diam)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each case's JAX run on its cell grid (the slot route), lazily."""
    done = {}

    def run(case):
        if case not in done:
            name, ensemble, dtype = CASES[case]
            make, _, jpot, cutoff, _, dt = SYSTEMS[name]
            pos, vel, diam, cell = make()
            n = len(pos)
            state = j_build_state(pos, diam, cell,
                                  jax.random.PRNGKey(KEY_SEED),
                                  velocities=vel, dtype=dtype, cutoff=cutoff)
            params = JParameters(density=n / abs(np.linalg.det(cell)),
                                 n_particles=n, dt=dt, potential=jpot)
            out_dir = str(tmp_path_factory.mktemp(f"jax_{case}"))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                j_run_simulation(state, params, ensemble, STEPS, FREQ,
                                 out_dir, engine=_jax_engine(name))
            done[case] = out_dir
        return done[case]

    return run


def _port_run(tmp_path, monkeypatch, case, ensemble):
    """The port's run on the JAX run's grid and capacity, counting its
    rebins."""
    rebins = []
    rebin = slot_step._rebin
    monkeypatch.setattr(slot_step, "_rebin",
                        lambda s, e: rebins.append(1) or rebin(s, e))
    name, _, jdtype = CASES[case]
    make, pot, _, cutoff, skin, dt = SYSTEMS[name]
    pos, vel, diam, cell = make()
    n = len(pos)
    jeng = _jax_engine(name)
    assert len(jeng.grid) == cell.shape[0]
    engine = CellGridEngine(potential=pot, cutoff=cutoff, skin=skin,
                            grid=jeng.grid, cell_capacity=jeng.cell_capacity)
    dtype = torch.float32 if jdtype == jnp.float32 else torch.float64
    state = build_state_from_arrays(pos, diam, cell, velocities=vel,
                                    dtype=dtype, cutoff=cutoff, device="cpu")
    params = mdtpu_torch.Parameters(n / abs(np.linalg.det(cell)), n, dt, pot)
    out_dir = str(tmp_path / "port")
    steps_before = slot_step.make_slot_step.steps
    out = mdtpu_torch.run_simulation(state, params, ensemble, STEPS, FREQ,
                                     out_dir, engine=engine, device="cpu")
    assert out.step == STEPS and out.positions.shape == (n, cell.shape[0])
    assert isinstance(out.nbrs, CellGridState) and out.ids is None
    assert slot_step.make_slot_step.steps - steps_before == STEPS
    return out_dir, len(rebins)


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


def _replay_bussi(monkeypatch):
    key = jax.random.PRNGKey(KEY_SEED)

    def replay(seed, step, nf, dtype, device):
        r1, r2 = jax_bussi_draws(key, step, nf)
        return (torch.tensor(r1, dtype=dtype, device=device),
                torch.tensor(r2, dtype=dtype, device=device))

    monkeypatch.setattr(tthermo, "bussi_noise", replay)


@pytest.mark.parametrize("case", ["2d_nve", "2d_nvt", "tilted_nve",
                                  "tilted_nvt"])
def test_slot_route_matches_jax(tmp_path, monkeypatch, jax_runs, case):
    ensemble = (mdtpu_torch.NVE() if case.endswith("nve")
                else mdtpu_torch.NVT(*((1.0, 0.1) if case.startswith("2d")
                                       else (1.0, 0.4))))
    if case.endswith("nvt"):
        _replay_bussi(monkeypatch)
    tdir, n_rebins = _port_run(tmp_path, monkeypatch, case, ensemble)
    _compare(jax_runs(case), tdir, n_rebins)


def test_2d_f32_nve_takes_the_hilo_sweep_like_jax(tmp_path, monkeypatch,
                                                  jax_runs):
    calls = []
    hilo = grid_mod.cell_sweep_hilo
    monkeypatch.setattr(grid_mod, "cell_sweep_hilo",
                        lambda *a: calls.append(a[-1]) or hilo(*a))
    tdir, n_rebins = _port_run(tmp_path, monkeypatch, "2d_nve_f32",
                               mdtpu_torch.NVE())
    # Every step takes the hi/lo sweep; all but the last of a segment lean.
    assert len(calls) == STEPS and calls.count(True) == STEPS // FREQ + 1
    rows_j, rows_t = _rows(jax_runs("2d_nve_f32")), _rows(tdir)
    assert rows_t.shape == rows_j.shape == (STEPS // FREQ, 4)
    assert np.all(np.abs(rows_t - rows_j)
                  <= 1e-5 * np.maximum(1.0, np.abs(rows_j)))


# ------------------------------------------------------- FIRE and packing

def test_slot_fire_2d_tilted_stepwise_matches_jax(monkeypatch):
    """Slot FIRE on a tilted 2D box (a jittered lattice of force-shifted
    Lennard-Jones disks at rho 0.8) against the JAX package's, through
    rebins; the energy falls."""
    n, rho = 1600, 0.8
    L = (n / rho) ** 0.5
    cell = np.array([[L, 2.0], [0.0, L]])
    pos, diam = lattice(n, cell, 0.05, 8)
    jpot = JLJ(r_cut=1.5, force_shift=True)
    pot = LennardJones(r_cut=1.5, force_shift=True)
    jengine = JCellGrid.create(jpot, 1.5, 0.3, cell, n)
    jstate = j_build_state(pos, diam, cell, jax.random.PRNGKey(0),
                           dtype=jnp.float64, cutoff=1.5)
    jparams = JParameters(density=rho, n_particles=n, dt=0.001,
                          potential=jpot)
    state = build_state_from_arrays(pos, diam, cell, dtype=torch.float64,
                                    cutoff=1.5, device="cpu")
    params = mdtpu_torch.Parameters(rho, n, 0.001, pot)
    engine = CellGridEngine(potential=pot, cutoff=1.5, skin=0.3,
                            grid=jengine.grid,
                            cell_capacity=jengine.cell_capacity)
    assert len(engine.grid) == 2
    rebins = []
    rebin = slot_step._rebin
    monkeypatch.setattr(slot_step, "_rebin",
                        lambda s, e: rebins.append(1) or rebin(s, e))
    for max_steps in (10, 40):
        jout, je, _, jn = j_fire_minimize(jstate, jparams, jengine,
                                          max_steps=max_steps, tol=1e-9)
        out, e, _, steps = mdtpu_torch.fire_minimize(
            state, params, engine, max_steps=max_steps, tol=1e-9,
            device="cpu")
        assert steps == int(jn) == max_steps
        np.testing.assert_allclose(float(e), float(je), rtol=1e-10)
        np.testing.assert_allclose(out.positions.numpy(),
                                   np.array(jout.positions), rtol=0,
                                   atol=1e-9)
    assert float(e) < float(mdtpu_torch.NaivePairEngine(pot, 1.5).compute(
        state.positions, state.diameters, state.unitcell,
        state.unitcell_inv)[0])
    assert len(rebins) >= 2


def test_pack_2d_on_the_cell_grid_matches_jax(monkeypatch):
    """Packing 2500 disks at rho 0.5 (the cell grid in both packages) with
    the JAX package's uniform draws replayed at the port's seam."""
    n, rho = 2500, 0.5
    L = (n / rho) ** 0.5
    key = jax.random.PRNGKey(4)
    jpos = np.array(j_pack_positions(key, jnp.eye(2) * L, n, 2, tol=1.0,
                                     dtype=jnp.float64))

    def draws(seed, shape, dtype, device):
        u = jax.random.uniform(key, tuple(shape), dtype=jnp.float64)
        return torch.as_tensor(np.array(u), dtype=dtype, device=device)

    monkeypatch.setattr(pack, "uniform_fractions", draws)
    engines = []
    select = mdtpu_torch.ops.select_engine

    def recorded(*a, **k):
        engines.append(select(*a, **k))
        return engines[-1]

    monkeypatch.setattr(mdtpu_torch.ops, "select_engine", recorded)
    pos = pack.pack_positions(0, np.eye(2) * L, n, 2, tol=1.0,
                              dtype=torch.float64, device="cpu").numpy()
    assert isinstance(engines[0], CellGridEngine) and len(engines[0].grid) == 2
    np.testing.assert_allclose(pos, jpos, rtol=0, atol=1e-8)
    d = pos[:, None, :] - pos[None, :, :]
    d -= L * np.round(d / L)
    r = np.sqrt((d * d).sum(-1))
    assert r[~np.eye(n, dtype=bool)].min() > 1.0 - 1e-6


# ------------------------------------------------------------- config 4

def test_config4_as_written_matches_jax(tmp_path):
    """``examples/03_polydisperse_2d.py`` at N = 1200: an XYZ snapshot
    written by the JAX package, ``initialize_state(from_file=...)``,
    ``minimize`` (tol 1e-4, the naive engine in both packages), then 30 NVT
    steps at dt 1e-4 with the port's Bussi draws replaced by JAX's.

    FIRE on this random, overlapping start is chaotic: the two packages
    agree to 3.5e-10 after 50 iterations and part by 100 (as FIRE does on
    the dense lattice of ROADMAP's C7), and the example's minimization runs
    for thousands of iterations. So ``minimize`` is held to 50 iterations
    here, and both NVT runs start from the JAX package's minimized state."""
    n, density = 1200, 0.9
    L = (n / density) ** 0.5
    rng = np.random.default_rng(0)
    diam = rng.uniform(0.8, 1.2, n)
    pos = rng.uniform(0, L, (n, 2))
    snap = str(tmp_path / "start.xyz")
    j_write_xyz(snap, 0, np.eye(2) * L, pos, diam, mode="w")

    jparams = JParameters(density=density, n_particles=n, dt=1e-4,
                          potential=JNonAdditivePHS())
    jstate = mdtpu.initialize_state(jparams, str(tmp_path / "jax"),
                                    from_file=snap, dimension=2, cutoff=1.8,
                                    dtype=jnp.float64)
    jstate, je, jconv, jsteps = mdtpu.minimize(jstate, jparams,
                                               str(tmp_path / "jax"), 2,
                                               tol=1e-4, max_steps=50)
    params = mdtpu_torch.Parameters(density, n, 1e-4, NonAdditivePHS())
    state = mdtpu_torch.initialize_state(params, str(tmp_path / "port"),
                                         from_file=snap, dimension=2,
                                         cutoff=1.8, dtype=torch.float64,
                                         device="cpu")
    assert isinstance(mdtpu_torch.select_engine(params.potential, 1.8,
                                                state),
                      mdtpu_torch.NaivePairEngine)
    state, e, conv, steps = mdtpu_torch.minimize(
        state, params, str(tmp_path / "port"), 2, tol=1e-4, max_steps=50,
        device="cpu")
    assert steps == int(jsteps) == 50 and conv == bool(jconv)
    np.testing.assert_allclose(float(e), float(je), rtol=1e-9)
    np.testing.assert_allclose(state.positions.numpy(),
                               np.array(jstate.positions), rtol=0, atol=1e-8)
    _assert_same_numbers(str(tmp_path / "port" / "minimized.xyz"),
                         str(tmp_path / "jax" / "minimized.xyz"), 1e-8)
    state = state.replace(positions=torch.from_numpy(
        np.array(jstate.positions)), images=torch.from_numpy(
        np.array(jstate.images)).long())

    vel = np.array(mdtpu.initialize_velocities(0.5, jax.random.PRNGKey(1), n,
                                               2, jnp.float64))
    jstate = jstate.replace(velocities=jnp.asarray(vel))
    state = state.replace(velocities=torch.from_numpy(vel))
    j_run_simulation(jstate, jparams, JNVT(0.5, 0.01), 30, 10,
                     str(tmp_path / "jax_run"))
    key = jstate.key

    def replay(seed, step, nf, dtype, device):
        r1, r2 = jax_bussi_draws(key, step, nf)
        return (torch.tensor(r1, dtype=dtype, device=device),
                torch.tensor(r2, dtype=dtype, device=device))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tthermo, "bussi_noise", replay)
        mdtpu_torch.run_simulation(state, params, mdtpu_torch.NVT(0.5, 0.01),
                                   30, 10, str(tmp_path / "port_run"),
                                   device="cpu")
    rows_j = _rows(str(tmp_path / "jax_run"))
    rows_t = _rows(str(tmp_path / "port_run"))
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-9, atol=0)
    _assert_same_numbers(str(tmp_path / "port_run" / "final.xyz"),
                         str(tmp_path / "jax_run" / "final.xyz"), 1e-9)


def config4_fire_climb(steps=(300, 1000, 3000), dmaxes=(0.1, 0.01)):
    """Energy per particle after ``steps`` FIRE iterations on config 4's
    start (N = 1200, the example's uniform random positions and diameters),
    the JAX package's ``minimize`` (the naive engine) beside the port's slot
    FIRE on the cell grid (the pair list), at each step cap ``dmax``."""
    import tempfile

    n, density = 1200, 0.9
    L = (n / density) ** 0.5
    rng = np.random.default_rng(0)
    diam = rng.uniform(0.8, 1.2, n)
    pos = rng.uniform(0, L, (n, 2))
    with tempfile.TemporaryDirectory() as d:
        snap = os.path.join(d, "start.xyz")
        j_write_xyz(snap, 0, np.eye(2) * L, pos, diam, mode="w")
        jparams = JParameters(density=density, n_particles=n, dt=1e-4,
                              potential=JNonAdditivePHS())
        jstate = mdtpu.initialize_state(jparams, d, from_file=snap,
                                        dimension=2, cutoff=1.8,
                                        dtype=jnp.float64)
        params = mdtpu_torch.Parameters(density, n, 1e-4, NonAdditivePHS())
        state = mdtpu_torch.initialize_state(params, d, from_file=snap,
                                             dimension=2, cutoff=1.8,
                                             dtype=torch.float64,
                                             device="cpu")
        engine = mdtpu_torch.select_engine(params.potential, 1.8, state,
                                           prefer="cellgrid")
        for dmax in dmaxes:
            for k in steps:
                je = mdtpu.minimize(jstate, jparams, d, 2, tol=1e-4,
                                    max_steps=k, dmax=dmax)[1]
                te = mdtpu_torch.minimize(state, params, d, 2, tol=1e-4,
                                          max_steps=k, dmax=dmax,
                                          engine=engine, device="cpu")[1]
                print(f"dmax {dmax} iterations {k}: energy per particle "
                      f"JAX package {float(je) / n:.6g}, port "
                      f"{float(te) / n:.6g}", flush=True)


if __name__ == "__main__":
    # python -m tests.test_torch_geometry_driver: FIRE on config 4's start
    # (ROADMAP C8), both packages, on the CPU (a few minutes).
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    config4_fire_climb()
