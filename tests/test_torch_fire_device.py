"""FIRE on the device (``mdtpu_torch.minimize.fire``: the minimization on
buffers, ``SlotFire`` and ``RowFire``, run eagerly here with the plain
versions of ``mdtpu_torch.minimize.fire_update``) against the JAX package on
the CPU, f64, N <= 500:

  * the slot FIRE against ``mdtpu.minimize.fire.fire_minimize_slots`` on
    three cases: a packing that converges (the overlap potential, tol
    1e-10), a Lennard-Jones fluid stopped at ``max_steps``, and the same
    fluid at a cell capacity that a rebin overflows (the run stops there,
    and ``fire_minimize`` retries at a grown capacity as the JAX package's
    does). Positions to 1e-10 of the box length, f_rms to rel 1e-10,
    ``n_steps``, ``converged`` and ``overflow`` equal; the JAX runs shared
    through module fixtures;
  * the slot FIRE's rebin steps against a host loop written here that
    follows the JAX package's nesting (``mdtpu/minimize/fire.py:386-423``:
    a rebin on entry, then one after each step whose drift test fired,
    none after the step that ends the loop, an overflow ending the loop
    before any further step);
  * the particle-order FIRE (``_fire_once``) on the naive engine and the
    neighbour list against the JAX package's ``_fire_once``: converging
    and stopped at ``max_steps``;
  * each plain function of ``fire_update`` (the reduction and its tail,
    the move in slots and in rows with the wrap, the test) against the JAX
    package's expressions, at f32 and f64, in 3D and 2D, split as the
    sharded FIRE splits them and in one call alike, in every branch (the
    power positive, not positive, past n_min with ~1e25 forces,
    displacements past dmax, non-finite forces, the overflow flag set);
  * ``device_while``'s eager loop: the body runs exactly while the
    predicate holds, never after it turned false; ``LoopCounts``, which
    brings a captured loop's launches back into the counters.
Also: a grown-capacity retry is not cached, and the sharded FIRE on CPU
tensors refuses ``graph=True``."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdtpu_torch
from mdtpu.core.box import wrap_positions as j_wrap_positions
from mdtpu.core.types import Parameters as JParameters
from mdtpu.integrate.slot_step import slotify as j_slotify
from mdtpu.integrate.slot_step import unslotify_state as j_unslotify
from mdtpu.minimize.fire import _fire_once as j_fire_once
from mdtpu.minimize.fire import fire_minimize as j_fire_minimize
from mdtpu.minimize.fire import fire_minimize_slots as j_fire_slots
from mdtpu.ops.cell_grid import CellGridEngine as JCellGrid
from mdtpu.ops.naive import NaivePairEngine as JNaive
from mdtpu.ops.neighbor_list import NeighborListEngine as JList
from mdtpu.potentials.lennard_jones import LennardJones as JLJ
from mdtpu.sim.initialization import build_state_from_arrays as j_build
from mdtpu.sim.pack import OverlapPotential as JOverlap
from mdtpu_torch.integrate import slot_step as slots
from mdtpu_torch.integrate.device_advance import LoopCounts, device_while
from mdtpu_torch.minimize import fire as fire_mod
from mdtpu_torch.minimize import fire_update as fu
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.neighbor_list import NeighborListEngine
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.potentials.overlap import OverlapPotential
from mdtpu_torch.sim.initialization import build_state_from_arrays
from mdtpu_torch.utils import counters
from tests.test_dynamics import make_fluid_state
from tests.test_torch_driver import one_torch_thread  # noqa: F401

HYPER = dict(dt_initial=0.01, dt_max=0.1, alpha0=0.1, f_inc=1.2, f_dec=0.2,
             n_min=5, dmax=0.1)
PACK_HYPER = dict(HYPER, dt_max=0.15)
RTOL = 1e-10


def _fluid():
    """A Lennard-Jones fluid (N = 256, rho 0.5, force-shifted r_c 1.5): the
    JAX state and the port's, and both potentials."""
    n = 256
    js = make_fluid_state(n=n, rho=0.5, temp=0.75, dtype=jnp.float64,
                          cutoff=1.5, seed=3)
    state = build_state_from_arrays(
        np.array(js.positions), np.ones(n), np.array(js.unitcell),
        velocities=np.array(js.velocities), dtype=torch.float64, cutoff=1.5,
        device="cpu")
    return (js, JLJ(r_cut=1.5, force_shift=True), state,
            LennardJones(r_cut=1.5, force_shift=True), 1.5)


def _packing():
    """Uniform random positions (N = 500, rho 0.5) under the packer's
    overlap potential (tol 1): FIRE converges to f_rms 0."""
    n, rho = 500, 0.5
    length = (n / rho) ** (1 / 3)
    cell = np.eye(3) * length
    pos = np.random.default_rng(5).uniform(0, length, (n, 3))
    js = j_build(jnp.asarray(pos), jnp.ones(n), jnp.asarray(cell),
                 jax.random.PRNGKey(0), dtype=jnp.float64, cutoff=1.0)
    state = build_state_from_arrays(pos, np.ones(n), cell,
                                    dtype=torch.float64, cutoff=1.0,
                                    device="cpu")
    return js, JOverlap(tol=1.0), state, OverlapPotential(tol=1.0), 1.0


SYSTEMS = {"fluid": _fluid, "packing": _packing}
# name: (system, capacity (None: the engine's own), max_steps, tol, hyper)
SLOT_CASES = {
    "converges": ("packing", None, 2000, 1e-10, PACK_HYPER),
    "max_steps": ("fluid", None, 60, 1e-9, HYPER),
    "overflow": ("fluid", 8, 60, 1e-9, HYPER),
}


@pytest.fixture(scope="module")
def systems():
    return {name: make() for name, make in SYSTEMS.items()}


def _engines(system, capacity):
    js, jpot, state, pot, cutoff = system
    jengine = JCellGrid.create(jpot, cutoff, 0.3, np.array(js.unitcell),
                               state.n_particles)
    if capacity is not None:
        jengine = dataclasses.replace(jengine, cell_capacity=capacity)
    engine = CellGridEngine(potential=pot, cutoff=cutoff, skin=0.3,
                            grid=jengine.grid,
                            cell_capacity=jengine.cell_capacity)
    return jengine, engine


@pytest.fixture(scope="module")
def jax_slot_runs(systems):
    """Each case's JAX slot FIRE from its slotified start: ``(slot state,
    f_rms, converged, n_steps, overflow)``."""
    out = {}
    for name, (system, capacity, max_steps, tol, hyper) in SLOT_CASES.items():
        js = systems[system][0]
        jengine, _ = _engines(systems[system], capacity)
        start = j_slotify(js, jengine)
        assert not bool(start.nbrs.overflow)
        out[name] = j_fire_slots(start, jengine, max_steps=max_steps,
                                 tol=tol, **hyper)
    return out


def _port_slot_run(systems, name):
    system, capacity, max_steps, tol, hyper = SLOT_CASES[name]
    _, engine = _engines(systems[system], capacity)
    start = slots.slotify(systems[system][2], engine)
    run = fire_mod.make_slot_fire(engine, max_steps=max_steps, tol=tol,
                                  **hyper)
    return run, start, run(start)


def _particle_order(state):
    """The positions of a slot state in particle order, as numpy."""
    if isinstance(state.positions, torch.Tensor):
        return slots.unslotify_state(state).positions.numpy()
    return np.asarray(j_unslotify(state).positions)


@pytest.mark.parametrize("name", list(SLOT_CASES))
def test_slot_fire_on_the_device_matches_jax(systems, jax_slot_runs, name):
    jout = jax_slot_runs[name]
    run, _, out = _port_slot_run(systems, name)
    assert run.fire.graph is None          # eager here: the CPU
    st, f_rms, converged, n_steps, ovf = out
    assert (n_steps, converged, ovf) == (int(jout[3]), bool(jout[2]),
                                         bool(jout[4]))
    np.testing.assert_allclose(float(f_rms), float(jout[1]), rtol=RTOL)
    if name == "converges":
        assert converged and n_steps < 2000
    elif name == "max_steps":
        assert n_steps == 60 and not converged
    else:
        # The run stopped at the rebin that overflowed, rows dropped: only
        # the counts compare.
        assert ovf and 0 < n_steps < 60
        return
    length = float(systems[SLOT_CASES[name][0]][2].unitcell[0, 0])
    np.testing.assert_allclose(_particle_order(st), _particle_order(jout[0]),
                               rtol=0, atol=RTOL * length)


def test_overflow_after_a_rebin_retries_as_jax_does(systems, monkeypatch):
    """``fire_minimize`` from the capacity that a rebin overflows: both
    packages retry at a grown capacity and agree on the result; the retry's
    run is not kept in the cache."""
    monkeypatch.setattr(fire_mod, "_CACHE", collections.OrderedDict())
    retries = []
    retried = fire_mod._retried
    monkeypatch.setattr(fire_mod, "_retried",
                        lambda hyper: retries.append(1) or retried(hyper))
    system, capacity, max_steps, tol, hyper = SLOT_CASES["overflow"]
    js, jpot, state, pot, cutoff = systems[system]
    jengine, engine = _engines(systems[system], capacity)
    jparams = JParameters(density=0.5, n_particles=state.n_particles,
                          dt=0.002, potential=jpot)
    params = mdtpu_torch.Parameters(0.5, state.n_particles, 0.002, pot)
    jout = j_fire_minimize(js, jparams, jengine, max_steps=max_steps,
                           tol=tol, **hyper)
    out = mdtpu_torch.fire_minimize(state, params, engine,
                                    max_steps=max_steps, tol=tol,
                                    device="cpu", **hyper)
    assert out[3] == int(jout[3]) and out[2] == bool(jout[2])
    np.testing.assert_allclose(float(out[1]), float(jout[1]), rtol=RTOL)
    length = float(state.unitcell[0, 0])
    np.testing.assert_allclose(out[0].positions.numpy(),
                               np.asarray(jout[0].positions), rtol=0,
                               atol=RTOL * length)
    assert torch.equal(out[0].velocities, state.velocities)
    assert retries and len(fire_mod._CACHE) == 1


def test_sharded_fire_refuses_the_graph():
    """On a ring of CPU tensors the sharded FIRE runs eagerly: asking for
    its CUDA graph (``graph=True``) raises."""
    from mdtpu_torch.sim.initialization import lattice_fluid_state
    state = lattice_fluid_state(1000, 0.8, 1.0, dtype=torch.float64,
                                cutoff=2.5, jitter=0.05, device="cpu")
    params = mdtpu_torch.Parameters(0.8, 1000, 0.002,
                                    LennardJones(r_cut=2.5))
    with pytest.raises(ValueError, match="graph=True takes a CUDA state"):
        fire_mod.fire_minimize_sharded(state, params, graph=True,
                                       device="cpu", max_steps=5)


def _host_loop(start, engine, max_steps, tol, hyper):
    """The slot FIRE as the JAX package nests it (fire.py:386-423), step by
    step on the host with the plain versions: ``(rebin steps, n_steps,
    overflow)``."""
    h = fu.FireHyper(**hyper)
    s = start.replace(velocities=torch.zeros_like(start.velocities),
                      vel_comp=torch.zeros_like(start.vel_comp))
    s = slots.slot_forces(s, engine)
    scal, ints, red, _, flags = fu.buffers(s.dtype, s.device, 1)
    scal[fu.DT], scal[fu.ALPHA], scal[fu.TOL] = h.dt_initial, h.alpha0, tol
    ints[fu.MAX_STEPS] = max_steps
    sqrt_ndof = float(s.nf) ** 0.5
    fu.fire_test_plain(s.forces, scal, ints, red[fu.RED:], sqrt_ndof, flags,
                       entry=True)

    def f_rms():
        return float(scal[fu.FRMS])

    step, rebins, ovf = 0, [], bool(s.nbrs.overflow)
    while step < max_steps and f_rms() >= tol and not ovf:
        rebins.append(step)
        s = slots._engine_rebin(s, engine)
        ovf = ovf or bool(s.nbrs.overflow)
        rebuild = False
        while step < max_steps and f_rms() >= tol and not rebuild \
                and not ovf:
            x, v = s.positions.clone(), s.velocities.clone()
            fu.fire_reduce_plain(v, s.forces, scal, ints, red[:fu.RED], h)
            fu.fire_move_plain(x, v, s.forces, scal, ints, h.dmax, rows=False)
            s = slots.slot_forces(s.replace(positions=x, velocities=v),
                                  engine, observables=False)
            fu.fire_test_plain(s.forces, scal, ints, red[fu.RED:], sqrt_ndof,
                               flags)
            step += 1
            rebuild = bool(slots.slot_needs_rebin(s, engine))
            ovf = ovf or bool(s.nbrs.overflow)
    return rebins, step, ovf


@pytest.mark.parametrize("name", list(SLOT_CASES))
def test_slot_fire_rebins_where_the_jax_nesting_does(systems, name):
    run, start, out = _port_slot_run(systems, name)
    system, capacity, max_steps, tol, hyper = SLOT_CASES[name]
    _, engine = _engines(systems[system], capacity)
    rebins, n_steps, ovf = _host_loop(start, engine, max_steps, tol, hyper)
    assert run.fire.rebuild_steps() == rebins
    assert (out[3], out[4]) == (n_steps, ovf)
    assert len(rebins) >= 2 and rebins[0] == 0
    # No rebin after the step that ends the loop; an overflowed run ends at
    # the rebin after its last step.
    assert rebins[-1] == n_steps if ovf else rebins[-1] < n_steps


@pytest.fixture(scope="module")
def jax_particle_runs(systems):
    """The JAX package's ``_fire_once`` on the naive engine (both systems)
    and the list (the fluid)."""
    out = {}
    for key, (system, max_steps, tol, hyper) in PARTICLE_CASES.items():
        js, jpot, state, _, cutoff = systems[system]
        engine = (JNaive(potential=jpot, cutoff=cutoff) if key[1] == "naive"
                  else JList.create(jpot, cutoff, 0.3, np.array(js.unitcell),
                                    state.n_particles))
        jparams = JParameters(density=0.5, n_particles=state.n_particles,
                              dt=0.002, potential=jpot)
        out[key] = j_fire_once(js, jparams, engine, max_steps=max_steps,
                               tol=tol, **hyper)
    return out


PARTICLE_CASES = {
    ("converges", "naive"): ("packing", 2000, 1e-10, PACK_HYPER),
    ("max_steps", "naive"): ("fluid", 40, 1e-9, HYPER),
    ("max_steps", "list"): ("fluid", 40, 1e-9, HYPER),
}


def _f_rms(forces, n, dim):
    f = np.asarray(forces)
    m = np.abs(f).max()
    return np.sqrt(np.sum((f / (m if m > 0 else 1.0)) ** 2)) * m / np.sqrt(
        dim * (n - 1.0))


@pytest.mark.parametrize("key", list(PARTICLE_CASES),
                         ids=["-".join(k) for k in PARTICLE_CASES])
def test_particle_order_fire_on_the_device_matches_jax(systems,
                                                       jax_particle_runs,
                                                       key):
    system, max_steps, tol, hyper = PARTICLE_CASES[key]
    js, _, state, pot, cutoff = systems[system]
    engine = (mdtpu_torch.NaivePairEngine(potential=pot, cutoff=cutoff)
              if key[1] == "naive" else
              NeighborListEngine.create(pot, cutoff, 0.3,
                                        state.unitcell.numpy(),
                                        state.n_particles))
    params = mdtpu_torch.Parameters(0.5, state.n_particles, 0.002, pot)
    jout = jax_particle_runs[key]
    out = fire_mod._fire_once(state, params, engine, max_steps=max_steps,
                              tol=tol, **hyper)
    assert (out[3], out[2]) == (int(jout[3]), bool(jout[2]))
    assert out[2] if key[0] == "converges" else out[3] == max_steps
    np.testing.assert_allclose(float(out[1]), float(jout[1]), rtol=RTOL,
                               atol=1e-300)
    n, dim = state.n_particles, state.dimension
    np.testing.assert_allclose(_f_rms(out[0].forces, n, dim),
                               _f_rms(jout[0].forces, n, dim), rtol=RTOL)
    length = float(state.unitcell[0, 0])
    np.testing.assert_allclose(out[0].positions.numpy(),
                               np.asarray(jout[0].positions), rtol=0,
                               atol=RTOL * length)
    assert torch.equal(out[0].images, torch.as_tensor(
        np.array(jout[0].images), dtype=torch.int64))
    assert torch.equal(out[0].velocities, state.velocities)


# ------------------------------------------------ the plain functions


def _jax_update(v, f, dt, alpha, ssn, hyper, axis):
    """The JAX package's fire_step before the sweep (fire.py:325-366),
    written out: ``(v, disp, dt, alpha, ssn)``."""
    h = hyper
    v = v + dt * f
    vmax, fmax = jnp.max(jnp.abs(v)), jnp.max(jnp.abs(f))
    vmax_s = jnp.where(vmax > 0, vmax, jnp.ones_like(vmax))
    fmax_s = jnp.where(fmax > 0, fmax, jnp.ones_like(fmax))
    power = jnp.sum((v / vmax_s) * (f / fmax_s))
    vn = jnp.sqrt(jnp.sum((v / vmax_s) ** 2))
    fn = jnp.sqrt(jnp.sum((f / fmax_s) ** 2))
    do_mix = (vmax > 0) & (fmax > 0)
    scale = alpha * (vmax_s / fmax_s) * (vn / jnp.where(fn > 0, fn,
                                                        jnp.ones_like(fn)))
    mix_v = 1.0 - alpha
    positive = power > 0
    ssn_pos = ssn + 1
    grow = ssn_pos > h["n_min"]
    dt_pos = jnp.where(grow, jnp.minimum(dt * h["f_inc"], h["dt_max"]), dt)
    alpha_pos = jnp.where(grow, alpha * 0.99, alpha)
    dt_neg = jnp.maximum(dt * h["f_dec"], h["dt_initial"])
    dt = jnp.where(positive, dt_pos, dt_neg)
    alpha = jnp.where(positive, alpha_pos, jnp.asarray(h["alpha0"], v.dtype))
    ssn = jnp.where(positive, ssn_pos, 0)
    v, disp = _jax_move(v, f, mix_v, scale, do_mix, positive, dt, h["dmax"],
                        axis)
    return v, disp, dt, alpha, ssn


def _jax_move(v, f, mix_v, mix_f, do_mix, positive, dt, dmax, axis):
    """The move of fire_step (fire.py:355-366) from the kicked ``v``: the
    mix, the zeroing, the capped displacement: ``(v, disp)``."""
    v = jnp.where(do_mix, mix_v * v + mix_f * f, v)
    v = jnp.where(positive, v, jnp.zeros_like(v))
    disp = dt * v
    m = jnp.max(jnp.abs(disp), axis=axis, keepdims=True)
    m_safe = jnp.where(m > 0, m, jnp.ones_like(m))
    dnorm = jnp.sqrt(jnp.sum((disp / m_safe) ** 2, axis=axis,
                             keepdims=True)) * m
    dnorm = jnp.where(jnp.isfinite(dnorm), dnorm, jnp.full_like(dnorm,
                                                                jnp.inf))
    cap = jnp.minimum(1.0, dmax / jnp.maximum(dnorm, 1e-30))
    disp = jnp.where(jnp.isfinite(disp), disp * cap, jnp.zeros_like(disp))
    return v, disp


def _jax_f_rms(f, ndof):
    fm = jnp.max(jnp.abs(f))
    fm_s = jnp.where(fm > 0, fm, jnp.ones_like(fm))
    return jnp.sqrt(jnp.sum((f / fm_s) ** 2)) * fm_s / jnp.sqrt(ndof)


# The plain update's layouts: (dimension, particle rows).
UPDATE_LAYOUTS = {"slots": (3, False), "rows": (3, True),
                  "slots_2d": (2, False), "rows_2d": (2, True)}


def _update_inputs(case, shape, rows):
    """``(f, v, x)`` of a case of :func:`test_plain_update_matches_the_jax_
    expressions`, made with numpy from one seed."""
    rng = np.random.default_rng(11)
    # Forces of an overlapping start (~1e25) never square a raw value.
    f = rng.normal(size=shape) * (1e25 if case == "grow" else 1.0)
    v = rng.normal(size=shape) * 0.3 + 0.05 * f / np.abs(f).max()
    if case == "negative":
        v = -v - 0.2 * f / np.abs(f).max()
    if case == "rest":
        v, f = np.zeros(shape), np.zeros(shape)
    if case == "past_dmax":
        # dt v' of ~0.15 a component: most particles past dmax, some not.
        v = v * 16.0
    if case == "nonfinite":
        # An infinite force and a NaN force, each on a particle of its own.
        idx = ((0, 3), (1, 7)) if not rows else ((3, 0), (7, 1))
        f[idx[0]], f[idx[1]] = np.inf, np.nan
    x = rng.uniform(0, 9.0, size=shape)
    return f, v, x


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ["positive", "negative", "grow", "rest",
                                  "overflow", "nonfinite", "past_dmax"])
@pytest.mark.parametrize("layout", list(UPDATE_LAYOUTS))
def test_plain_update_matches_the_jax_expressions(dtype, case, layout):
    """The reduction, the move and the test, plain, against the JAX
    package's expressions (rel 1e-12 at f64, 2e-6 at f32), in slots and in
    rows with the wrap, in 3D and 2D: the power positive, not positive
    (negative, and zero at rest), positive past n_min with ~1e25 forces,
    displacements past dmax, non-finite forces, and the overflow flag set
    (the JAX package's loop does not run: nothing changes). With
    non-finite forces the power is NaN and the move zeroes every velocity,
    so the move is also held alone, at a positive power with the mix on,
    to the JAX move: there its non-finite displacements are the ones the
    guards drop."""
    dim, rows = UPDATE_LAYOUTS[layout]
    n = 500
    shape = (n, dim) if rows else (dim, n)
    axis = -1 if rows else 0
    f, v, x = _update_inputs(case, shape, rows)
    # grow: past n_min, and dt * f_inc clamped at dt_max.
    ssn, dt, alpha = ((7, 0.09, 0.07) if case == "grow" else (2, 0.03, 0.07))
    ndof = dim * (n - 1.0)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    cell = np.eye(dim) * 9.0
    jcell = (jnp.asarray(cell, jt), jnp.asarray(np.linalg.inv(cell), jt))

    def wrapped(jx):
        if not rows:
            return jx, None
        return j_wrap_positions(jx, jnp.zeros(shape, jnp.int32), *jcell)

    overflow = case == "overflow"
    if overflow:
        jv, jx, jdt, jalpha, jssn = (np.asarray(v, dtype), np.asarray(
            x, dtype), dt, alpha, ssn)
        jimg, jrms = np.zeros(shape, np.int64), 0.0
    else:
        # float64 is on for JAX in these tests (tests/conftest.py).
        jv, jdisp, jdt, jalpha, jssn = _jax_update(
            jnp.asarray(v, jt), jnp.asarray(f, jt), jnp.asarray(dt, jt),
            jnp.asarray(alpha, jt), jnp.asarray(ssn), HYPER, axis)
        jx, jimg = wrapped(jnp.asarray(x, jt) + jdisp)
        jrms = _jax_f_rms(jnp.asarray(f, jt), ndof)
        jv, jx, jdt, jalpha, jrms = (np.asarray(a) for a in
                                     (jv, jx, jdt, jalpha, jrms))
        if case == "past_dmax":
            norms = np.linalg.norm(np.asarray(jdisp, np.float64), axis=axis)
            assert (norms < 0.0999).any()
            np.testing.assert_allclose(norms.max(), HYPER["dmax"],
                                       rtol=1e-5)
    rtol = 1e-12 if dtype == "float64" else 2e-6
    hyper = fu.FireHyper(**HYPER)
    c = torch.tensor(cell, dtype=tt)
    box = (torch.linalg.inv(c),)
    for modes in ((fu.ONE_PASS,), (fu.MAXIMA, fu.SUMS, fu.TAIL)):
        scal, ints, red, _, flags = fu.buffers(tt, "cpu", 1)
        scal[fu.DT], scal[fu.ALPHA], scal[fu.TOL] = dt, alpha, 1e-3
        ints[fu.SSN], ints[fu.MAX_STEPS] = ssn, 10
        tv, tf = torch.tensor(v, dtype=tt), torch.tensor(f, dtype=tt)
        tx = torch.tensor(x, dtype=tt)
        over = torch.tensor(overflow)
        for mode in modes:
            fu.fire_reduce_plain(tv, tf, scal, ints, red[:fu.RED], hyper,
                                 over, mode=mode)
        img = torch.zeros(shape, dtype=torch.int64)
        fu.fire_move_plain(tx, tv, tf, scal, ints, hyper.dmax, rows,
                           *((img, c, *box) if rows else ()), overflow=over)
        for mode in modes:
            fu.fire_test_plain(tf, scal, ints, red[fu.RED:], ndof ** 0.5,
                               flags, overflow=over, mode=mode)
        np.testing.assert_allclose(tv.numpy(), jv, rtol=rtol,
                                   atol=rtol * np.abs(jv).max())
        np.testing.assert_allclose(tx.numpy(), jx, rtol=rtol, atol=rtol * 9)
        np.testing.assert_allclose(float(scal[fu.DT]), float(jdt), rtol=rtol)
        np.testing.assert_allclose(float(scal[fu.ALPHA]), float(jalpha),
                                   rtol=rtol)
        np.testing.assert_allclose(float(scal[fu.FRMS]), float(jrms),
                                   rtol=rtol)
        assert int(ints[fu.SSN]) == int(jssn)
        assert int(ints[fu.STEP]) == int(not overflow)
        assert int(ints[fu.PASSES]) == 1
        assert int(ints[fu.POSITIVE]) == (case in ("positive", "grow",
                                                   "past_dmax"))
        assert int(ints[fu.DO_MIX]) == (case not in ("rest", "overflow",
                                                     "nonfinite"))
        if rows:
            assert torch.equal(img, torch.as_tensor(np.array(jimg),
                                                    dtype=torch.int64))
    if case != "nonfinite":
        return
    # The move alone at a positive power, mixing, on the non-finite forces.
    dt_kick, mix_v, mix_f = 0.03, 0.93, 0.4
    jv, jdisp = _jax_move(jnp.asarray(v, jt) + dt_kick * jnp.asarray(f, jt),
                          jnp.asarray(f, jt), mix_v, mix_f, True, True, dt,
                          HYPER["dmax"], axis)
    jx, jimg = wrapped(jnp.asarray(x, jt) + jdisp)
    scal, ints, _, _, _ = fu.buffers(tt, "cpu", 1)
    scal[fu.DT_KICK], scal[fu.DT] = dt_kick, dt
    scal[fu.MIX_V], scal[fu.MIX_F] = mix_v, mix_f
    ints[fu.DO_MIX], ints[fu.POSITIVE] = 1, 1
    tv, tf = torch.tensor(v, dtype=tt), torch.tensor(f, dtype=tt)
    tx, img = torch.tensor(x, dtype=tt), torch.zeros(shape, dtype=torch.int64)
    fu.fire_move_plain(tx, tv, tf, scal, ints, HYPER["dmax"], rows,
                       *((img, c, *box) if rows else ()))
    assert not np.isfinite(np.asarray(jv)).all()
    finite = np.isfinite(np.asarray(jv))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(jv)[finite])
                               .max())
    assert np.isfinite(tx.numpy()).all()
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=rtol,
                               atol=rtol * 9)
    if rows:
        assert torch.equal(img, torch.as_tensor(np.array(jimg),
                                                dtype=torch.int64))


def test_plain_test_counts_the_step_and_sets_the_flags():
    f = torch.tensor([[3.0, -4.0], [0.0, 0.0]], dtype=torch.float64)
    scal, ints, red, _, flags = fu.buffers(torch.float64, "cpu", 1)
    scal[fu.TOL], ints[fu.MAX_STEPS] = 1.0, 2
    fu.fire_test_plain(f, scal, ints, red, 2.0, flags, entry=True)
    assert float(scal[fu.FRMS]) == 2.5 and int(ints[fu.STEP]) == 0
    assert flags.tolist() == [True, True] and int(ints[fu.PASSES]) == 0
    drift = torch.tensor(False)
    fu.fire_test_plain(f, scal, ints, red, 2.0, flags, drift=drift)
    assert int(ints[fu.STEP]) == 1 and flags.tolist() == [True, False]
    fu.fire_test_plain(f, scal, ints, red, 2.0, flags, drift=~drift)
    # max_steps reached: the loop ends, and no rebin follows.
    assert int(ints[fu.STEP]) == 2 and flags.tolist() == [False, False]
    assert int(ints[fu.CONVERGED]) == 0
    overflow = torch.tensor(True)
    fu.fire_test_plain(f, scal, ints, red, 2.0, flags, overflow=overflow)
    assert int(ints[fu.STEP]) == 2 and int(ints[fu.OVERFLOW]) == 1
    assert int(ints[fu.PASSES]) == 3 and flags.tolist() == [False, False]
    scal[fu.TOL] = 10.0
    fu.fire_test_plain(f, scal, ints, red, 2.0, flags, entry=True)
    assert int(ints[fu.CONVERGED]) == 1


# ------------------------------------------------------ device_while


@pytest.mark.parametrize("start", [0, 3, 5])
def test_device_while_runs_the_body_while_the_flag_is_set(start):
    counter = torch.tensor(start)
    flag = torch.zeros((), dtype=torch.bool)
    passes = []

    def test(handle):
        assert handle is None
        flag.copy_(counter < 3)

    def body(handle):
        assert flag and handle is None
        passes.append(int(counter))
        counter.add_(1)
        test(handle)

    device_while(flag, test, body)
    assert passes == list(range(start, 3))
    assert int(counter) == max(start, 3)


def test_device_while_takes_the_body_at_its_word():
    flag = torch.ones((), dtype=torch.bool)
    passes = []

    def body(handle):
        passes.append(len(passes))
        return len(passes) < 4        # the flag itself stays set

    device_while(flag, lambda handle: None, body)
    assert passes == [0, 1, 2, 3]


def test_loop_counts_split_a_capture_into_once_pass_and_rebuild():
    """``LoopCounts``: a capture's counts split into what a replay adds once
    (the entry test), each pass (its rebuild apart) and each rebuild taken,
    added back by host counts and by a device tally."""
    class Wrapper:
        launches = 0
        rebuilds = 0

    key_l, key_r = (Wrapper, "launches"), (Wrapper, "rebuilds")
    counters.register(Wrapper, "launches", "rebuilds")
    try:
        counts = LoopCounts()
        start = counters.snapshot()
        Wrapper.launches += 1                 # the entry test
        with counts.if_body():                # the entry rebuild
            Wrapper.rebuilds += 3
        with counts.loop_body():
            Wrapper.launches += 2
            with counts.if_body():
                Wrapper.rebuilds += 3
            Wrapper.launches += 1
        counts.close(counters.difference(counters.snapshot(), start))
        assert counts.once == {key_l: 1}
        assert counts.per_pass == {key_l: 3}
        assert counts.per_if == {key_r: 3}
        Wrapper.launches = Wrapper.rebuilds = 0
        counts.add(5, 2)
        assert (Wrapper.launches, Wrapper.rebuilds) == (16, 6)
        counts.add(1, (torch.tensor(2), torch.tensor(6)))
        counters.settle()
        assert (Wrapper.launches, Wrapper.rebuilds) == (20, 18)
    finally:
        counters.unregister(Wrapper, "launches", "rebuilds")
