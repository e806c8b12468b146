"""The hi/lo (f32x2) pair sweep, the repair of the port's default f32 NVE
route: ``cell_sweep_hilo`` (its plain version runs on the CPU) and the
driver's ``precision`` rule, against the JAX package.

  * the fault: on the same float32 (hi, lo) input, the hi/lo sweep's
    per-particle force error against the f64 sweep on hi + lo is several
    times smaller than the plain float32 sweep's;
  * the arithmetic: the port's hi/lo sweep against the JAX package's hi/lo
    slot sweep (``CellGridEngine.compute_slots(pos_lo=...)``) on the same
    slot arrays, each particle's force to 1e-5 of the larger of its own and
    the RMS force, energy and virial to rtol 1e-5 (the two sum in different
    orders);
  * the route: the port's default f32 NVE run against the JAX package's
    default run on its cell grid (the slot path with the hi/lo sweep), 20
    steps, thermo rows within 1e-5 (relative, or absolute below 1);
  * ``precision="f32x2"`` runs on the cell grid and raises ``ValueError``
    where it cannot run."""

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
from mdtpu.ops.cell_grid import far_ramp
from mdtpu.potentials.lennard_jones import LennardJones as JLJ
from mdtpu.sim.driver import run_simulation as j_run_simulation
from mdtpu.sim.initialization import build_state_from_arrays as j_build_state
from mdtpu_torch.ops import cell_grid as grid_mod
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.cell_sweep import cell_sweep_hilo_plain, cell_sweep_plain
from mdtpu_torch.ops.experimental import PlaneEngine
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.sim.initialization import build_state_from_arrays
from tests.test_torch_driver import _initial_arrays
from tests.test_torch_driver import one_torch_thread  # noqa: F401

N, RHO = 4096, 0.8


def _hilo_inputs(seed=3):
    """A float64 fluid split into float32 words: hi = f32(x), lo = f32(x -
    hi); the slot inputs of both sweeps, and the engine."""
    pos, _, cell = _initial_arrays()
    rng = np.random.default_rng(seed)
    pos = np.mod(pos + 0.3 * rng.uniform(-1, 1, pos.shape), np.diag(cell))
    hi = pos.astype(np.float32)
    lo = (pos - hi.astype(np.float64)).astype(np.float32)
    cell32 = torch.from_numpy(cell.astype(np.float32))
    cinv32 = torch.linalg.inv(cell32)
    eng = CellGridEngine.create(LennardJones(r_cut=2.5), 2.5, 0.3, cell32, N)
    hi_t, lo_t = torch.from_numpy(hi), torch.from_numpy(lo)
    nb = eng.allocate(hi_t, torch.ones(N), cell32, cinv32)
    return eng, nb, eng.slot_inputs_hilo(hi_t, lo_t, cell32, cinv32, nb)


def _force_error(f1, f0):
    err = (f1.double() - f0.double()).norm(dim=0)
    mag = f0.double().norm(dim=0)
    rms = torch.sqrt((mag * mag).sum() / N)
    return float((err / mag.clamp(min=rms)).max())


def test_hilo_sweep_is_several_times_closer_to_f64_than_plain():
    eng, nb, (hi, lo, diam, counts, box) = _hilo_inputs()
    args = (eng.grid, eng.cutoff, eng.potential)
    _, _, f64 = cell_sweep_plain(hi.double() + lo.double(), diam.double(),
                                 counts, box.double(), *args)
    _, _, f_hilo = cell_sweep_hilo_plain(hi, lo, diam, counts, box, *args)
    _, _, f_plain = cell_sweep_plain(hi, diam, counts, box, *args)
    err_hilo, err_plain = _force_error(f_hilo, f64), _force_error(f_plain,
                                                                  f64)
    assert err_hilo * 5 < err_plain, (err_hilo, err_plain)
    assert err_hilo < 2e-5


def test_hilo_sweep_matches_jax_hilo_slot_sweep():
    eng, nb, (hi, lo, diam, counts, box) = _hilo_inputs(seed=4)
    cap, n_slots = eng.cell_capacity, hi.shape[1]
    occ = (torch.arange(cap)[None, :] < counts[:, None]).reshape(-1).numpy()
    far = np.asarray(far_ramp(n_slots, jnp.float32))
    hi_j = np.where(occ[None, :], hi.numpy(), far[None, :])
    lo_j = np.where(occ[None, :], lo.numpy(), 0.0).astype(np.float32)
    cell = jnp.asarray(box.numpy())   # slot_inputs_hilo gives the cell
    jeng = JCellGrid(potential=JLJ(r_cut=2.5), cutoff=2.5, skin=0.3,
                     grid=eng.grid, cell_capacity=cap)
    e0, w0, f0, _ = jeng.compute_slots(jnp.asarray(hi_j),
                                       jnp.asarray(diam.numpy()), cell,
                                       jnp.linalg.inv(cell), None,
                                       pos_lo=jnp.asarray(lo_j))
    e1, w1, f1 = cell_sweep_hilo_plain(hi, lo, diam, counts, box, eng.grid,
                                       eng.cutoff, eng.potential)
    np.testing.assert_allclose(float(e1), float(e0), rtol=1e-5)
    np.testing.assert_allclose(float(w1), float(w0), rtol=1e-5)
    f0 = torch.from_numpy(np.array(f0))[:, occ]
    assert _force_error(f1[:, occ], f0) < 1e-5


def test_default_f32_nve_runs_the_hilo_sweep_like_jax(tmp_path, monkeypatch):
    steps, freq = 20, 5
    pos, vel, cell = _initial_arrays()
    jstate = j_build_state(pos, np.ones(N), cell, jax.random.PRNGKey(0),
                           velocities=vel, dtype=jnp.float32, cutoff=2.5)
    jparams = JParameters(density=RHO, n_particles=N, dt=0.002,
                          potential=JLJ(r_cut=2.5))
    jengine = JCellGrid.create(JLJ(r_cut=2.5), 2.5, 0.3, cell, N)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    j_run_simulation(jstate, jparams, JNVE(), steps, freq, jdir,
                     engine=jengine)

    calls = []
    hilo = grid_mod.cell_sweep_hilo

    def counted(*args):
        calls.append(1)
        return hilo(*args)

    monkeypatch.setattr(grid_mod, "cell_sweep_hilo", counted)
    tstate = build_state_from_arrays(pos, np.ones(N), cell, velocities=vel,
                                     dtype=torch.float32, cutoff=2.5,
                                     device="cpu")
    params = mdtpu_torch.Parameters(RHO, N, 0.002, LennardJones(r_cut=2.5))
    out = mdtpu_torch.run_simulation(tstate, params, mdtpu_torch.NVE(), steps,
                                     freq, tdir, device="cpu")
    assert out.step == steps and len(calls) == steps
    rows_j = np.loadtxt(os.path.join(jdir, "thermo.txt"))
    rows_t = np.loadtxt(os.path.join(tdir, "thermo.txt"))
    assert rows_t.shape == rows_j.shape == (steps // freq, 4)
    assert np.all(np.abs(rows_t - rows_j)
                  <= 1e-5 * np.maximum(1.0, np.abs(rows_j)))


def test_f32x2_runs_on_the_cell_grid_and_raises_elsewhere(tmp_path,
                                                          monkeypatch):
    pos, vel, cell = _initial_arrays()
    params = mdtpu_torch.Parameters(RHO, N, 0.002, LennardJones(r_cut=2.5))
    state = build_state_from_arrays(pos, np.ones(N), cell, velocities=vel,
                                    dtype=torch.float32, cutoff=2.5,
                                    device="cpu")
    calls = []
    hilo = grid_mod.cell_sweep_hilo
    monkeypatch.setattr(grid_mod, "cell_sweep_hilo",
                        lambda *a: calls.append(1) or hilo(*a))
    # Forced on NVT and Brownian; PlaneEngine hands it to the hi/lo variant
    # of the full-stencil sweep.
    plane = PlaneEngine.create(params.potential, 2.5, 0.3, cell, N)
    for ens, engine in ((mdtpu_torch.NVT(1.0, 0.4), None),
                        (mdtpu_torch.Brownian(1.0), None),
                        (mdtpu_torch.NVE(), plane)):
        out = mdtpu_torch.run_simulation(state, params, ens, 2, 1,
                                         str(tmp_path / "ok"), engine=engine,
                                         precision="f32x2", device="cpu")
        assert out.step == 2
    assert len(calls) == 6
    naive = mdtpu_torch.NaivePairEngine(potential=params.potential,
                                        cutoff=2.5)
    for kw in ({"engine": naive}, {"compensated": False}):
        with pytest.raises(ValueError, match="f32x2"):
            mdtpu_torch.run_simulation(state, params, mdtpu_torch.NVE(), 2, 1,
                                       str(tmp_path / "x"), precision="f32x2",
                                       device="cpu", **kw)
    with pytest.raises(ValueError, match="float32"):
        mdtpu_torch.run_simulation(
            build_state_from_arrays(pos, np.ones(N), cell, cutoff=2.5,
                                    dtype=torch.float64, device="cpu"),
            params, mdtpu_torch.NVE(), 2, 1, str(tmp_path / "x"),
            precision="f32x2", device="cpu")
    assert not (tmp_path / "x").exists()
