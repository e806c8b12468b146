"""The Newton half-stencil sweep (``plane_sweep``; its plain version runs on
the CPU) and ``PlaneEngine`` against the JAX package's B2 kernel
(``PallasPlaneEngine`` in interpret mode), its ``CellGridEngine`` and the
port's full-stencil ``cell_sweep_plain``.

Tolerances: at f32 against the Pallas kernel, those of
tests/test_experimental_pallas.py::test_pallas_plane_matches_oracle (energy
and virial rtol 1e-5; forces 5e-6 of the largest force): the two build
their slot coordinates and sum in different orders. At f64, those of the B1
parity tests (energy and virial rtol 1e-12, forces rtol 1e-10 / atol
1e-12). Runs: f32 thermo rows within 1e-5 (relative, or absolute below 1)
of the JAX run through the Pallas kernel; f64 rows within rel 1e-9 of the
JAX default run, as tests/test_torch_driver.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdtpu_torch
from mdtpu.core.types import NVE as JNVE
from mdtpu.core.types import Parameters as JParameters
from mdtpu.ops.cell_grid import CellGridEngine as JCellGrid
from mdtpu.ops.experimental import PallasPlaneEngine
from mdtpu.potentials.lennard_jones import LennardJones as JLJ
from mdtpu.sim.driver import run_simulation as j_run_simulation
from mdtpu.sim.initialization import build_state_from_arrays as j_build_state
from mdtpu_torch.ops import plane_sweep as plane_mod
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.cell_sweep import cell_sweep_plain
from mdtpu_torch.ops.experimental import PlaneEngine
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.sim.initialization import build_state_from_arrays
from tests.test_torch_driver import _run_both
from tests.test_torch_driver import one_torch_thread  # noqa: F401

RHO, CUTOFF, SKIN = 0.6, 1.5, 0.3
# Box lengths giving 5x5x5, 3x3x3 and 3x4x5 grids at cutoff + skin = 1.8.
BOXES = {"cubic": (9.41, 9.41, 9.41), "three": (5.6, 5.6, 5.6),
         "non_cubic": (5.5, 7.5, 9.2)}


def _system(box, seed, dtype, jitter=0.15):
    """A jittered lattice at RHO filling ``box``, wrapped into it."""
    rng = np.random.default_rng(seed)
    box = np.asarray(box, np.float64)
    n = int(round(RHO * np.prod(box)))
    per = np.ceil((n / np.prod(box)) ** (1 / 3) * box).astype(int)
    idx = np.indices(per).reshape(3, -1).T
    idx = idx[rng.permutation(len(idx))[:n]]
    pos = np.mod((idx + 0.5) / per * box + jitter * rng.normal(size=(n, 3)),
                 box)
    cell = np.diag(box)
    return (pos.astype(dtype), np.ones(n, dtype), cell.astype(dtype),
            np.linalg.inv(cell).astype(dtype))


def _moved(arrays, seed):
    """Positions moved by up to 0.07 per axis and wrapped: some cross the
    box edge after the binning."""
    pos, _, cell, _ = arrays
    rng = np.random.default_rng(seed)
    box = np.diag(cell).astype(np.float64)
    return np.mod(pos + rng.uniform(-0.07, 0.07, pos.shape),
                  box).astype(pos.dtype)


def _port(engine, arrays, positions):
    pos, diam, cell, cinv = (torch.from_numpy(a) for a in arrays)
    nb = engine.allocate(pos, diam, cell, cinv)
    assert not bool(nb.overflow)
    e, w, f, _ = engine.compute(torch.from_numpy(positions), diam, cell, cinv,
                                nb)
    return float(e), float(w), f.numpy()


def _jax(engine, arrays, positions):
    pos, diam, cell, cinv = (jnp.asarray(a) for a in arrays)
    nb = engine.allocate(pos, diam, cell, cinv)
    e, w, f, _ = engine.compute(jnp.asarray(positions), diam, cell, cinv, nb)
    return float(e), float(w), np.asarray(f)


@pytest.mark.parametrize("box", ["cubic", "non_cubic"])
def test_plane_sweep_f32_matches_pallas_plane(box):
    arrays = _system(BOXES[box], 21, np.float32)
    n = len(arrays[0])
    pallas = PallasPlaneEngine.create(JLJ(r_cut=1.5, force_shift=True),
                                      CUTOFF, SKIN, arrays[2], n,
                                      interpret=True)
    port = PlaneEngine.create(LennardJones(r_cut=1.5, force_shift=True),
                              CUTOFF, SKIN, arrays[2], n,
                              cell_capacity=pallas.cell_capacity)
    assert port.grid == pallas.grid
    for positions in (arrays[0], _moved(arrays, 5)):
        e0, w0, f0 = _jax(pallas, arrays, positions)
        e1, w1, f1 = _port(port, arrays, positions)
        np.testing.assert_allclose(e1, e0, rtol=1e-5)
        np.testing.assert_allclose(w1, w0, rtol=1e-5)
        scale = np.abs(f0).max()
        np.testing.assert_allclose(f1 / scale, f0 / scale, atol=5e-6)


@pytest.mark.parametrize("box", ["three", "non_cubic"])
def test_plane_sweep_f64_matches_cell_grid(box):
    arrays = _system(BOXES[box], 8, np.float64)
    n = len(arrays[0])
    jpot = JLJ(r_cut=1.5)
    ref = JCellGrid.create(jpot, CUTOFF, SKIN, arrays[2], n)
    port = PlaneEngine.create(LennardJones(r_cut=1.5), CUTOFF, SKIN,
                              arrays[2], n, cell_capacity=ref.cell_capacity)
    assert port.grid == ref.grid == {"three": (3, 3, 3),
                                     "non_cubic": (3, 4, 5)}[box]
    full = CellGridEngine.create(LennardJones(r_cut=1.5), CUTOFF, SKIN,
                                 arrays[2], n,
                                 cell_capacity=ref.cell_capacity)
    for positions in (arrays[0], _moved(arrays, 6)):
        e0, w0, f0 = _jax(ref, arrays, positions)
        e1, w1, f1 = _port(port, arrays, positions)
        e2, w2, f2 = _port(full, arrays, positions)
        for e, w, f in ((e0, w0, f0), (e2, w2, f2)):
            np.testing.assert_allclose(e1, e, rtol=1e-12)
            np.testing.assert_allclose(w1, w, rtol=1e-12)
            np.testing.assert_allclose(f1, f, rtol=1e-10, atol=1e-12)


def test_every_pair_counted_once_on_a_three_cell_grid():
    """Energy 1 per pair closer than r_c: the half stencil counts each
    unordered pair once (self column at 1/2 from both sides, Newton cells
    at 1) and matches the full stencil on 3x3x3 and 3x4x5 grids."""

    class PairCounter:
        def evaluate_r2(self, r2, d_i, d_j):
            return (r2 < CUTOFF ** 2).to(r2.dtype), torch.zeros_like(r2)

    for box in ("three", "non_cubic"):
        arrays = _system(BOXES[box], 3, np.float64, jitter=0.3)
        pos, diam, cell, cinv = (torch.from_numpy(a) for a in arrays)
        eng = PlaneEngine.create(LennardJones(r_cut=1.5), CUTOFF, SKIN, cell,
                                 len(pos))
        nb = eng.allocate(pos, diam, cell, cinv)
        inputs = eng.slot_inputs(pos, cell, cinv, nb)
        half = plane_mod.plane_sweep_plain(*inputs, eng.grid, CUTOFF,
                                           PairCounter())[0]
        full = cell_sweep_plain(*inputs, eng.grid, CUTOFF, PairCounter())[0]
        d = pos[:, None, :] - pos[None, :, :]
        d = d - cell.diagonal() * torch.round(d / cell.diagonal())
        r2 = (d * d).sum(-1)
        brute = int(((r2 < CUTOFF ** 2).sum() - len(pos)) // 2)
        assert float(half) == float(full) == brute > 0


def test_vacant_and_trash_slots_get_no_force():
    arrays = _system(BOXES["cubic"], 4, np.float64)
    pos, diam, cell, cinv = (torch.from_numpy(a) for a in arrays)
    eng = PlaneEngine.create(LennardJones(r_cut=1.5), CUTOFF, SKIN, cell,
                             len(pos))
    nb = eng.allocate(pos, diam, cell, cinv)
    inputs = eng.slot_inputs(pos, cell, cinv, nb)
    _, _, f_slots = plane_mod.plane_sweep(*inputs, eng.grid, CUTOFF,
                                          eng.potential)
    cap = eng.cell_capacity
    occ = (torch.arange(cap)[None, :] < nb.counts[:, None]).reshape(-1)
    assert bool((~occ).any()) and bool(torch.all(f_slots[:, ~occ] == 0))
    assert bool(torch.all(f_slots[:, occ].norm(dim=0) > 0))

    tight = PlaneEngine.create(LennardJones(r_cut=1.5), CUTOFF, SKIN, cell,
                               len(pos), cell_capacity=2)
    nb = tight.allocate(pos, diam, cell, cinv)
    assert bool(nb.overflow)
    _, _, f, _ = tight.compute(pos, diam, cell, cinv, nb)
    trash = nb.addr == tight.n_cells * tight.cell_capacity
    assert bool(trash.any()) and bool(torch.all(f[trash] == 0))
    grown = tight.with_grown_capacity()
    assert type(grown) is PlaneEngine and grown.cell_capacity == 6


def test_cpu_wrapper_takes_the_plain_version():
    arrays = _system(BOXES["non_cubic"], 9, np.float64)
    pos, diam, cell, cinv = (torch.from_numpy(a) for a in arrays)
    eng = PlaneEngine.create(LennardJones(r_cut=1.5, shift=True), CUTOFF,
                             SKIN, cell, len(pos))
    inputs = eng.slot_inputs(pos, cell, cinv, eng.allocate(pos, diam, cell,
                                                           cinv))
    before = plane_mod.plane_sweep.launches
    got = plane_mod.plane_sweep(*inputs, eng.grid, CUTOFF, eng.potential)
    want = plane_mod.plane_sweep_plain(*inputs, eng.grid, CUTOFF,
                                       eng.potential)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert plane_mod.plane_sweep.launches == before
    with pytest.raises(ValueError):
        plane_mod.plane_sweep(*inputs, (2, 4, 5), CUTOFF, eng.potential)
    # select_engine never picks it.
    state = build_state_from_arrays(*arrays[:3], device="cpu",
                                    dtype=torch.float64)
    assert type(mdtpu_torch.select_engine(eng.potential, CUTOFF, state,
                                          prefer="cellgrid")) \
        is CellGridEngine


def _rows(path):
    return np.loadtxt(path)


def test_run_f32_matches_jax_pallas_plane_run(tmp_path):
    """10 NVE steps of N = 1000 LJ (r_c 2.5, rho 0.8: a 3x3x3 grid) with
    compensated=False: the JAX package through PallasPlaneEngine in
    interpret mode, the port through PlaneEngine."""
    n, rho, steps = 1000, 0.8, 10
    rng = np.random.default_rng(11)
    L = (n / rho) ** (1.0 / 3.0)
    idx = np.indices((10, 10, 10)).reshape(3, -1).T
    pos = ((idx + 0.5) / 10 * L + 0.05 * rng.normal(size=(n, 3))) % L
    vel = rng.normal(size=(n, 3))
    vel -= vel.mean(axis=0)
    cell = np.eye(3) * L
    # Capacity 80 holds the lattice's fullest cell (4^3): the JAX particle
    # path computes its initial forces before any overflow check.
    pallas = PallasPlaneEngine.create(JLJ(r_cut=2.5), 2.5, 0.3, cell, n,
                                      cell_capacity=80, interpret=True)
    jstate = j_build_state(pos, np.ones(n), cell, jax.random.PRNGKey(0),
                           velocities=vel, dtype=jnp.float32, cutoff=2.5)
    jparams = JParameters(density=rho, n_particles=n, dt=0.002,
                          potential=JLJ(r_cut=2.5))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    j_run_simulation(jstate, jparams, JNVE(), steps, 5, jdir, engine=pallas,
                     compensated=False)

    engine = PlaneEngine.create(LennardJones(r_cut=2.5), 2.5, 0.3, cell, n,
                                cell_capacity=pallas.cell_capacity)
    assert engine.grid == pallas.grid == (3, 3, 3)
    tstate = build_state_from_arrays(pos, np.ones(n), cell, velocities=vel,
                                     dtype=torch.float32, cutoff=2.5,
                                     device="cpu")
    params = mdtpu_torch.Parameters(rho, n, 0.002, LennardJones(r_cut=2.5))
    out = mdtpu_torch.run_simulation(tstate, params, mdtpu_torch.NVE(), steps,
                                     5, tdir, engine=engine,
                                     compensated=False, device="cpu")
    assert out.step == steps
    rows_j = _rows(os.path.join(jdir, "thermo.txt"))
    rows_t = _rows(os.path.join(tdir, "thermo.txt"))
    assert rows_t.shape == rows_j.shape == (2, 4)
    np.testing.assert_array_equal(rows_t[:, 0], rows_j[:, 0])
    assert np.all(np.abs(rows_t - rows_j)
                  <= 1e-5 * np.maximum(1.0, np.abs(rows_j)))


def test_run_f64_plane_engine_matches_jax_default(tmp_path, monkeypatch):
    """The port through PlaneEngine against the JAX package's default f64
    run (N = 4096), as tests/test_torch_driver.py holds the default."""
    calls = []
    plain = plane_mod.plane_sweep_plain

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(plane_mod, "plane_sweep_plain", counted)

    def plane(state):
        return PlaneEngine.create(LennardJones(r_cut=2.5), 2.5, 0.3,
                                  state.unitcell, state.n_particles)

    jout, tout, jdir, tdir = _run_both(tmp_path, JNVE(), mdtpu_torch.NVE(),
                                       port_engine=plane)
    assert len(calls) >= tout.step   # every step went through the sweep
    rows_j = _rows(os.path.join(jdir, "thermo.txt"))
    rows_t = _rows(os.path.join(tdir, "thermo.txt"))
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-9, atol=0)
    np.testing.assert_allclose(tout.positions.numpy(),
                               np.asarray(jout.positions), rtol=0, atol=1e-9)
