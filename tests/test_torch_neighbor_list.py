"""The neighbour-list engine (``mdtpu_torch.ops.neighbor_list``) against the
JAX package's ``NeighborListEngine`` on the CPU, at f64:

  * ``create`` on 2D and 3D boxes (grid, C, K), ``with_grown_capacity``
    twice, and the ``ValueError`` of a tilted and of a small box;
  * ``allocate``: every row the same set of neighbours as the JAX ``idx``,
    the counts, and the overflow flag of a forced overflow;
  * ``needs_rebuild`` on displaced positions;
  * the plain build in K1's order (``stencil_order=True``) against the JAX
    rows and the default build as sets, under overflow too; ``allocate``'s
    ``order``; K1's staging plan (``build_plan``);
  * ``compute`` on the JAX list (through ``interop``): LJ, pseudo-hard
    spheres and a user potential (the torch route), energy and virial to
    rtol 1e-12, forces to 1e-10;
  * ``select_engine(prefer="neighbor")``: the same engine as the JAX
    package's;
  * 20 NVT steps (the JAX Bussi draws replayed) and 20 NVE steps through
    ``run_simulation`` on the list, row for row at rel 1e-9, and 20 FIRE
    iterations through ``minimize`` at rel 1e-10.
The JAX side of each system runs once per module."""

import dataclasses

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
from mdtpu.ops import select_engine as j_select_engine
from mdtpu.ops.neighbor_list import NeighborListEngine as JNL
from mdtpu.ops.neighbor_list import estimate_capacities as j_estimate
from mdtpu.potentials.lennard_jones import LennardJones as JLJ
from mdtpu.potentials.pseudo_hs import PseudoHS as JPHS
from mdtpu.sim.driver import run_simulation as j_run_simulation
from mdtpu.sim.initialization import build_state_from_arrays as j_build_state
from mdtpu_torch.integrate import thermostat as tthermo
from mdtpu_torch.interop import neighbor_state_from_numpy
from mdtpu_torch.ops import neighbor_list as nl_ops
from mdtpu_torch.ops.neighbor_list import (BUILD_STAGE_BYTES,
                                           NeighborListEngine,
                                           NeighborState, build_plan,
                                           estimate_capacities,
                                           nl_build_plain)
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from mdtpu_torch.sim.initialization import build_state_from_arrays
from tests.test_torch_driver import one_torch_thread  # noqa: F401
from tests.test_torch_geometry import JNonAdditivePHS, lattice
from tests.test_torch_gpu import NonAdditivePHS
from tests.test_torch_thermostat import jax_bussi_draws

N, RHO, DT, STEPS, FREQ, KEY_SEED = 500, 0.8, 0.002, 20, 5, 7
# name: (JAX potential, port potential, cutoff, density, dimension, poly)
SYSTEMS = {
    "lj": (JLJ(r_cut=2.5), LennardJones(r_cut=2.5), 2.5, 0.8, 3, 0.0),
    "pseudo_hs": (JPHS(), PseudoHS(), 1.5, 0.76, 3, 0.1),
    "user_2d": (JNonAdditivePHS(), NonAdditivePHS(), 1.8, 0.9, 2, 0.2),
}


def _box(n, rho, dim):
    return np.eye(dim) * (n / rho) ** (1.0 / dim)


def _jax_side(name):
    """The JAX engine, positions, diameters and cell of a system, its list
    and its ``compute`` (f64)."""
    jpot, _, cutoff, rho, dim, poly = SYSTEMS[name]
    cell = _box(N, rho, dim)
    pos, diam = lattice(N, cell, 0.08, 11, poly)
    engine = JNL.create(jpot, cutoff, 0.3, cell, N, max_sigma=diam.max())
    nbrs, (e, w, f) = _jax_build_and_compute(engine, pos, diam, cell)
    return dict(engine=engine, pos=pos, diam=diam, cell=cell,
                idx=np.asarray(nbrs.idx), overflow=bool(nbrs.overflow),
                ref=np.asarray(nbrs.ref_positions), energy=float(e),
                virial=float(w), forces=np.asarray(f))


def _jax_build_and_compute(engine, pos, diam, cell):
    """The JAX engine's list and ``compute`` on it, in one jitted program
    (eager, each op compiles on its own: several times slower)."""
    def both(p, d, c, ci):
        nbrs = engine.allocate(p, d, c, ci)
        return nbrs, engine.compute(p, d, c, ci, nbrs)[:3]

    return jax.jit(both)(jnp.asarray(pos), jnp.asarray(diam),
                         jnp.asarray(cell), jnp.asarray(np.linalg.inv(cell)))


@pytest.fixture(scope="module")
def jax_systems():
    return {name: _jax_side(name) for name in SYSTEMS}


def _port_engine(name, js):
    _, pot, cutoff, *_ = SYSTEMS[name]
    return NeighborListEngine.create(pot, cutoff, 0.3, js["cell"], N,
                                     max_sigma=js["diam"].max())


def _port_args(js):
    cell = torch.tensor(js["cell"])
    return (torch.tensor(js["pos"]), torch.tensor(js["diam"]), cell,
            torch.linalg.inv(cell))


def _row_sets(idx, n):
    return [frozenset(r[r < n].tolist()) for r in np.asarray(idx)]


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_create_matches_jax(jax_systems, name):
    js = jax_systems[name]
    jengine, engine = js["engine"], _port_engine(name, js)
    assert (engine.grid, engine.cell_capacity, engine.max_neighbors,
            engine.cutoff, engine.skin) == (
        jengine.grid, jengine.cell_capacity, jengine.max_neighbors,
        jengine.cutoff, jengine.skin)
    assert estimate_capacities(N, js["cell"], engine.cutoff, 0.3,
                               engine.grid) == j_estimate(
        N, js["cell"], engine.cutoff, 0.3, engine.grid)
    # Given capacities are kept; grown twice, both engines agree.
    given = NeighborListEngine.create(engine.potential, engine.cutoff, 0.3,
                                      js["cell"], N, cell_capacity=5,
                                      max_neighbors=12)
    assert (given.cell_capacity, given.max_neighbors) == (5, 12)
    for _ in range(2):
        engine, jengine = (engine.with_grown_capacity(),
                           jengine.with_grown_capacity())
        assert (engine.cell_capacity, engine.max_neighbors) == (
            jengine.cell_capacity, jengine.max_neighbors)


@pytest.mark.parametrize("box,match", [
    (np.array([[9.0, 1.0, 0.0], [0.0, 9.0, 0.0], [0.0, 0.0, 9.0]]),
     "orthorhombic-only"),
    (np.eye(3) * 7.0, "box too small"),
    (np.eye(2) * 8.0, "box too small"),
], ids=["tilted", "small_3d", "small_2d"])
def test_create_refuses_what_jax_refuses(box, match):
    for create, pot in ((JNL.create, JLJ(r_cut=2.5)),
                        (NeighborListEngine.create, LennardJones(r_cut=2.5))):
        with pytest.raises(ValueError, match=match):
            create(pot, 2.5, 0.3, box, 200)


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_allocate_rows_match_jax_as_sets(jax_systems, name):
    js = jax_systems[name]
    engine = _port_engine(name, js)
    nbrs = engine.allocate(*_port_args(js))
    assert isinstance(nbrs, NeighborState)
    assert nbrs.idx.dtype == torch.int32 and nbrs.idx.shape == js["idx"].shape
    assert not bool(nbrs.overflow) and not js["overflow"]
    assert _row_sets(nbrs.idx, N) == _row_sets(js["idx"], N)
    np.testing.assert_array_equal(nbrs.count.numpy(),
                                  (js["idx"] < N).sum(axis=1))
    # Each row holds its neighbours first, then the sentinel.
    k = np.arange(js["idx"].shape[1])
    assert np.all((nbrs.idx.numpy() < N) == (k < nbrs.count.numpy()[:, None]))
    np.testing.assert_array_equal(nbrs.ref_positions.numpy(), js["pos"])


@pytest.mark.parametrize("capacities", [(4, 64), (64, 16)],
                         ids=["cells", "rows"])
def test_allocate_flags_overflow_as_jax(jax_systems, capacities):
    js = jax_systems["lj"]
    cap, k = capacities
    jengine = js["engine"].replace(cell_capacity=cap, max_neighbors=k)
    jn, _ = _jax_build_and_compute(jengine, js["pos"], js["diam"], js["cell"])
    engine = NeighborListEngine(potential=LennardJones(r_cut=2.5),
                                cutoff=2.5, skin=0.3, grid=jengine.grid,
                                cell_capacity=cap, max_neighbors=k)
    nbrs = engine.allocate(*_port_args(js))
    assert bool(nbrs.overflow) and bool(jn.overflow)
    np.testing.assert_array_equal(nbrs.count.numpy(),
                                  (np.asarray(jn.idx) < N).sum(axis=1))


def test_needs_rebuild_matches_jax(jax_systems):
    js = jax_systems["lj"]
    jengine, engine = js["engine"], _port_engine("lj", js)
    cell = js["cell"]
    L = cell[0, 0]
    ref = js["pos"].copy()
    nbrs = engine.allocate(*_port_args(js))
    jn, _ = _jax_build_and_compute(jengine, ref, js["diam"], cell)
    small = ref + 0.09   # |d| = 0.156 > skin / 2
    # A particle that crossed the box edge by 0.01 moved 0.01, not L.
    wrapped = ref.copy()
    wrapped[0, 0] = L - 0.005
    nbrs_edge = NeighborState(idx=nbrs.idx,
                              ref_positions=torch.tensor(wrapped),
                              overflow=nbrs.overflow, count=nbrs.count)
    crossed = wrapped.copy()
    crossed[0, 0] = 0.005
    far = ref.copy()
    far[3] += np.array([0.1, 0.05, 0.06])   # |d| = 0.13 < 0.15
    farther = ref.copy()
    farther[3] += np.array([0.1, 0.1, 0.06])  # |d| = 0.154 > 0.15
    for moved, state, want in ((small, nbrs, True), (far, nbrs, False),
                               (farther, nbrs, True),
                               (crossed, nbrs_edge, False)):
        jref = jn.replace(ref_positions=jnp.asarray(
            state.ref_positions.numpy()))
        got = engine.needs_rebuild(torch.tensor(moved), state,
                                   torch.tensor(cell),
                                   torch.linalg.inv(torch.tensor(cell)))
        jgot = jengine.needs_rebuild(jnp.asarray(moved), jref,
                                     jnp.asarray(cell),
                                     jnp.asarray(np.linalg.inv(cell)))
        assert bool(got) == bool(jgot) == want


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_compute_on_the_jax_list_matches_jax(jax_systems, name):
    js = jax_systems[name]
    engine = _port_engine(name, js)
    assert engine.uses_kernel == (name != "user_2d")
    nbrs = neighbor_state_from_numpy(js["idx"], js["ref"], js["overflow"],
                                     device="cpu")
    e, w, f, out = engine.compute(*_port_args(js), nbrs)
    assert out is nbrs and abs(js["energy"]) > 0
    np.testing.assert_allclose(float(e), js["energy"], rtol=1e-12)
    np.testing.assert_allclose(float(w), js["virial"], rtol=1e-12)
    np.testing.assert_allclose(f.numpy(), js["forces"], rtol=1e-10,
                               atol=1e-10 * np.abs(js["forces"]).max())


def test_plain_build_keeps_the_closest_in_order(jax_systems):
    """The plain build keeps JAX's rows as they are (the K closest, sorted
    by r^2), not only as sets."""
    js = jax_systems["lj"]
    engine = _port_engine("lj", js)
    pos, _, cell, cell_inv = _port_args(js)
    cid, cell_buf, counts = engine.bin(pos, cell_inv)
    idx, count, over = nl_build_plain(pos, cid, cell_buf, counts,
                                      torch.diagonal(cell), engine.grid,
                                      engine.cutoff + engine.skin,
                                      engine.max_neighbors)
    np.testing.assert_array_equal(idx.numpy(), js["idx"])
    assert not bool(over)


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_stencil_order_plain_build_matches_jax_as_sets(jax_systems, name):
    """The plain build in K1's order (first K hits in stencil order, then
    slot order) holds the JAX rows and the default plain build's as sets,
    with the same counts; each row's hits come first."""
    js = jax_systems[name]
    engine = _port_engine(name, js)
    pos, _, cell, cell_inv = _port_args(js)
    args = (pos, *engine.bin(pos, cell_inv), torch.diagonal(cell),
            engine.grid, engine.cutoff + engine.skin, engine.max_neighbors)
    idx, count, over = nl_build_plain(*args, stencil_order=True)
    idx0, count0, over0 = nl_build_plain(*args)
    assert not bool(over) and not bool(over0)
    assert _row_sets(idx, N) == _row_sets(js["idx"], N) == _row_sets(idx0, N)
    assert torch.equal(count, count0)
    k = torch.arange(idx.shape[1])
    assert torch.equal(idx < N, k < count[:, None])
    assert not torch.equal(idx, idx0)   # the orders differ


@pytest.mark.parametrize("capacities", [(4, 64), (64, 16)],
                         ids=["cells", "rows"])
def test_stencil_order_plain_build_overflow_counts(jax_systems, capacities):
    """Under overflow both plain builds raise the flag and count each row's
    hits (at most K) alike; the JAX list's counts are the same."""
    js = jax_systems["lj"]
    cap, k_max = capacities
    engine = dataclasses.replace(_port_engine("lj", js), cell_capacity=cap,
                                 max_neighbors=k_max)
    pos, _, cell, cell_inv = _port_args(js)
    args = (pos, *engine.bin(pos, cell_inv), torch.diagonal(cell),
            engine.grid, engine.cutoff + engine.skin, engine.max_neighbors)
    idx, count, over = nl_build_plain(*args, stencil_order=True)
    idx0, count0, over0 = nl_build_plain(*args)
    jn, _ = _jax_build_and_compute(
        js["engine"].replace(cell_capacity=cap, max_neighbors=k_max),
        js["pos"], js["diam"], js["cell"])
    assert bool(over) and bool(over0) and bool(jn.overflow)
    assert torch.equal(count, count0)
    np.testing.assert_array_equal(count.numpy(),
                                  (np.asarray(jn.idx) < N).sum(axis=1))
    assert int(count.max()) == k_max if cap == 64 else int(count.max()) > 0


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_allocate_order_sorts_the_particles_by_cell(jax_systems, name):
    js = jax_systems[name]
    engine = _port_engine(name, js)
    pos, diam, cell, cell_inv = _port_args(js)
    nbrs = engine.allocate(pos, diam, cell, cell_inv)
    order = nbrs.order
    assert order.dtype == torch.int32 and order.shape == (N,)
    assert torch.equal(torch.sort(order).values,
                       torch.arange(N, dtype=torch.int32))
    cid = engine.bin(pos, cell_inv)[0]
    assert bool((cid[order.long()].diff() >= 0).all())


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_compute_with_and_without_order(jax_systems, name, monkeypatch):
    """``compute`` with the state's ``order`` and with ``order=None`` agree
    to 1e-12, and both hold the JAX ``compute``. On the CPU the force pass
    is the plain version, which takes the rows in particle order either
    way, so the agreement says nothing of K2 (the card's tests hold K2 in
    cell order against particle order); what this holds is that
    ``compute`` hands the state's order, or None, to ``nl_forces`` where
    the potential has a kernel, and bypasses it where it has none."""
    js = jax_systems[name]
    engine = _port_engine(name, js)
    args = _port_args(js)
    nbrs = engine.allocate(*args)
    assert nbrs.order is not None
    seen = []
    forces_pass = nl_ops.nl_forces

    def recording(*a, order=None):
        seen.append(order)
        return forces_pass(*a, order=order)

    monkeypatch.setattr(nl_ops, "nl_forces", recording)
    e1, w1, f1, _ = engine.compute(*args, nbrs)
    e0, w0, f0, _ = engine.compute(*args, dataclasses.replace(nbrs,
                                                              order=None))
    if engine.uses_kernel:
        assert len(seen) == 2 and seen[0] is nbrs.order and seen[1] is None
    else:
        assert seen == []
    for a, b in ((e1, e0), (w1, w0), (f1, f0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(f0.abs().max()))
    np.testing.assert_allclose(float(e1), js["energy"], rtol=1e-12)
    np.testing.assert_allclose(f1.numpy(), js["forces"], rtol=1e-10,
                               atol=1e-10 * np.abs(js["forces"]).max())


def test_build_plan_stages_the_bench_stencil_at_once():
    """K1's stage at the bench (65,536 LJ at rho 0.8, 15^3 cells, C 57):
    the whole stencil at f32 and f64; with C grown twice (137), 9-cell
    stages."""
    box = np.eye(3) * (65536 / 0.8) ** (1.0 / 3.0)
    eng = NeighborListEngine.create(LennardJones(r_cut=2.5), 2.5, 0.3, box,
                                    65536)
    assert (eng.grid, eng.cell_capacity) == ((15, 15, 15), 57)
    grown = eng.with_grown_capacity().with_grown_capacity()
    assert grown.cell_capacity == 137
    for dtype in (torch.float32, torch.float64):
        assert build_plan(eng.cell_capacity, 3, dtype) == 27
        assert build_plan(grown.cell_capacity, 3, dtype) == 9


# csrc/neighbor_list.cu, kMaxDynamicShared: a block's dynamic shared memory.
MAX_DYNAMIC_SHARED = 227 * 1024 - 1024


@pytest.mark.parametrize("cap, dim, dtype, cells", [
    (9, 2, torch.float32, 9), (137, 3, torch.float64, 9),
    (500, 3, torch.float32, 3), (2000, 2, torch.float64, 1),
    (8000, 3, torch.float64, 1)],
    ids=["2d-whole", "3d-nine", "3d-three", "2d-one", "3d-one-largest"])
def test_build_plan_fits_shared_memory(cap, dim, dtype, cells):
    """The plan takes the largest stage (3^d, 3^(d-1), 3 or 1 cells) within
    the budget; a single cell may pass the budget but fits the block's
    shared memory up to C 8,265 at f64 3D."""
    assert build_plan(cap, dim, dtype) == cells
    stage = cells * cap * (4 + dim * torch.finfo(dtype).bits // 8)
    assert stage <= BUILD_STAGE_BYTES or cells == 1
    assert cells == 3 ** dim or 3 * stage > BUILD_STAGE_BYTES
    assert stage <= MAX_DYNAMIC_SHARED


def test_neighbor_state_from_numpy_has_no_order(jax_systems):
    """A state made from the JAX fields has no ``order`` (particle order),
    and ``compute`` takes it."""
    js = jax_systems["lj"]
    nbrs = neighbor_state_from_numpy(js["idx"], js["ref"], js["overflow"],
                                     device="cpu")
    assert nbrs.order is None
    e, _, f, _ = _port_engine("lj", js).compute(*_port_args(js), nbrs)
    np.testing.assert_allclose(float(e), js["energy"], rtol=1e-12)
    assert f.shape == js["forces"].shape


def test_select_engine_prefer_neighbor_matches_jax():
    pot, jpot = LennardJones(r_cut=2.5), JLJ(r_cut=2.5)
    for n, box in ((N, _box(N, RHO, 3)), (N, _box(N, 0.9, 2)),
                   (64, np.eye(3) * 4.3)):
        engine = mdtpu_torch.select_engine(pot, 2.5, unitcell=box,
                                           n_particles=n, prefer="neighbor")
        jengine = j_select_engine(jpot, 2.5, unitcell=box, n_particles=n,
                                  prefer="neighbor")
        assert type(engine).__name__ == type(jengine).__name__
        if isinstance(engine, NeighborListEngine):
            assert (engine.grid, engine.cell_capacity, engine.max_neighbors,
                    engine.cutoff, engine.skin) == (
                jengine.grid, jengine.cell_capacity, jengine.max_neighbors,
                jengine.cutoff, jengine.skin)
    # Auto-selection keeps the cell grid above 2048 particles.
    auto = mdtpu_torch.select_engine(pot, 2.5, unitcell=_box(4096, RHO, 3),
                                     n_particles=4096)
    assert type(auto).__name__ == "CellGridEngine"
    with pytest.raises(ValueError, match="unknown engine preference"):
        mdtpu_torch.select_engine(pot, 2.5, unitcell=_box(N, RHO, 3),
                                  n_particles=N, prefer="verlet")


# ------------------------------------------------------------- the slice


def _initial_arrays():
    rng = np.random.default_rng(2024)
    cell = _box(N, RHO, 3)
    pos, _ = lattice(N, cell, 0.05, 5)
    vel = rng.normal(size=(N, 3))
    vel -= vel.mean(axis=0)
    vel *= np.sqrt(1.0 / (np.sum(vel * vel) / (3 * (N - 1))))
    return pos, vel, cell


def _run_both(tmp_path, jax_ensemble, port_ensemble):
    pos, vel, cell = _initial_arrays()
    jstate = j_build_state(pos, np.ones(N), cell,
                           jax.random.PRNGKey(KEY_SEED), velocities=vel,
                           dtype=jnp.float64, cutoff=2.5)
    jparams = JParameters(density=RHO, n_particles=N, dt=DT,
                          potential=JLJ(r_cut=2.5))
    jengine = j_select_engine(jparams.potential, 2.5, jstate,
                              prefer="neighbor")
    assert isinstance(jengine, JNL)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jout = j_run_simulation(jstate, jparams, jax_ensemble, STEPS, FREQ, jdir,
                            engine=jengine)
    state = build_state_from_arrays(pos, np.ones(N), cell, velocities=vel,
                                    dtype=torch.float64, cutoff=2.5,
                                    device="cpu")
    params = mdtpu_torch.Parameters(RHO, N, DT, LennardJones(r_cut=2.5))
    engine = mdtpu_torch.select_engine(params.potential, 2.5, state,
                                       prefer="neighbor")
    tout = mdtpu_torch.run_simulation(state, params, port_ensemble, STEPS,
                                      FREQ, tdir, engine=engine,
                                      device="cpu")
    assert isinstance(tout.nbrs, NeighborState)
    assert tout.step == int(jout.step) == STEPS
    rows_j = np.loadtxt(f"{jdir}/thermo.txt")
    rows_t = np.loadtxt(f"{tdir}/thermo.txt")
    assert rows_t.shape == (STEPS // FREQ, 4)
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-9, atol=0)
    np.testing.assert_allclose(tout.positions.numpy(),
                               np.asarray(jout.positions), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tout.images.numpy(),
                                  np.asarray(jout.images))


def test_nve_run_on_the_list_matches_jax(tmp_path):
    _run_both(tmp_path, JNVE(), mdtpu_torch.NVE())


def test_nvt_run_on_the_list_matches_jax(tmp_path, monkeypatch):
    key = jax.random.PRNGKey(KEY_SEED)

    def replay(seed, step, nf, dtype, device):
        r1, r2 = jax_bussi_draws(key, step, nf)
        return (torch.tensor(r1, dtype=dtype, device=device),
                torch.tensor(r2, dtype=dtype, device=device))

    monkeypatch.setattr(tthermo, "bussi_noise", replay)
    _run_both(tmp_path, JNVT(1.0, 0.4), mdtpu_torch.NVT(1.0, 0.4))


def test_fire_on_the_list_matches_jax(tmp_path):
    pos, vel, cell = _initial_arrays()
    jstate = j_build_state(pos, np.ones(N), cell, jax.random.PRNGKey(1),
                           velocities=vel, dtype=jnp.float64, cutoff=2.5)
    jparams = JParameters(density=RHO, n_particles=N, dt=DT,
                          potential=JLJ(r_cut=2.5, force_shift=True))
    jengine = JNL.create(jparams.potential, 2.5, 0.3, cell, N)
    (tmp_path / "jax").mkdir()
    jout = mdtpu.minimize(jstate, jparams, str(tmp_path / "jax"),
                          engine=jengine, max_steps=20, tol=0.0)
    state = build_state_from_arrays(pos, np.ones(N), cell, velocities=vel,
                                    dtype=torch.float64, cutoff=2.5,
                                    device="cpu")
    params = mdtpu_torch.Parameters(
        RHO, N, DT, LennardJones(r_cut=2.5, force_shift=True))
    engine = NeighborListEngine.create(params.potential, 2.5, 0.3, cell, N)
    out = mdtpu_torch.minimize(state, params, str(tmp_path / "port"),
                               engine=engine, max_steps=20, tol=0.0,
                               device="cpu")
    assert out[3] == int(jout[3]) == 20
    np.testing.assert_allclose(float(out[1]), float(jout[1]), rtol=1e-10)
    np.testing.assert_allclose(out[0].positions.numpy(),
                               np.asarray(jout[0].positions), rtol=0,
                               atol=1e-9)
    assert isinstance(out[0].nbrs, NeighborState)


def test_brownian_force_dtype_and_grown_capacities_on_the_list(tmp_path):
    """The list through the rest of the particle-order step: Brownian
    dynamics as the naive engine gives them (the same draws), the pair
    sweep in float32 under ``force_dtype`` (the list built and evaluated in
    float32, forces back in float64), and run_simulation's growth from
    capacities that overflow at the start, as a run that fits."""
    from mdtpu_torch.integrate.step import make_step

    pos, vel, cell = _initial_arrays()
    state = build_state_from_arrays(pos, np.ones(N), cell, velocities=vel,
                                    dtype=torch.float64, cutoff=2.5,
                                    device="cpu")
    pot = LennardJones(r_cut=2.5, force_shift=True)
    params = mdtpu_torch.Parameters(RHO, N, 1e-4, pot)
    engine = NeighborListEngine.create(pot, 2.5, 0.3, cell, N)
    naive = mdtpu_torch.NaivePairEngine(potential=pot, cutoff=2.5)
    ends = [mdtpu_torch.run_simulation(
        state, params, mdtpu_torch.Brownian(1.0), 10, 5,
        str(tmp_path / name), engine=e, device="cpu")
        for name, e in (("nl", engine), ("naive", naive))]
    np.testing.assert_allclose(ends[0].positions.numpy(),
                               ends[1].positions.numpy(), rtol=0, atol=1e-10)

    s64 = state.replace(nbrs=None)   # the first step builds the list
    step = make_step(params, mdtpu_torch.NVE(), engine,
                     force_dtype=torch.float32)
    out = step(s64)
    assert out.nbrs.ref_positions.dtype == torch.float32
    assert out.forces.dtype == torch.float64
    x32 = out.positions.to(torch.float32)
    want = naive.compute(x32, state.diameters.float(),
                         state.unitcell.float(), state.unitcell_inv.float())
    np.testing.assert_allclose(float(out.energy), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(out.forces.numpy(), want[2].double().numpy(),
                               rtol=0, atol=1e-4 * float(want[2].abs().max()))

    tight = dataclasses.replace(engine, cell_capacity=4, max_neighbors=16)
    runs = [mdtpu_torch.run_simulation(
        state, params, mdtpu_torch.NVE(), 10, 5, str(tmp_path / name),
        engine=e, device="cpu")
        for name, e in (("tight", tight), ("fits", engine))]
    assert runs[0].nbrs.idx.shape[1] > 16
    np.testing.assert_allclose(runs[0].positions.numpy(),
                               runs[1].positions.numpy(), rtol=0, atol=1e-12)
