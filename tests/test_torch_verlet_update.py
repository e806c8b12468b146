"""The slot step's velocity-Verlet chain (``mdtpu_torch.integrate.
verlet_update``) on the CPU, where its wrappers take their plain versions:

  * the plain kick-drift and kick against the JAX package's chain, its
    ``kahan_add`` composed as ``mdtpu/integrate/slot_step.py:579-592``
    composes it, on inputs made by numpy from a seed (f32 and f64,
    compensated and not, 2D and 3D): bit for bit, where both sides round
    every product and sum on its own (XLA on the CPU does not contract
    them here);
  * the wrappers: into new tensors (the plain versions' own), in place, the
    hi/lo low word, the step counter, the rescale and the bad inputs they
    refuse; the finish's ``(scale, temperature)`` written around a
    temperature buffer;
  * the slot MD step through the in-place route (``make_slot_advance``, its
    buffers written by the chain, the sweep and the finish) against the
    composition the step ran before (the torch chain and
    ``md_velocity_finish`` on new tensors, copied into the buffers) over
    short segments of the bench's shape (NVT on a ramp, NVE on the hi/lo
    sweep, f64 NVT, a 2D box, uncompensated, ``force_dtype``), with
    rebuilds: every segment's thermo numbers and the final state bit for
    bit; and the Brownian slot step the same way (its sweep and
    ``brownian_update`` writing the buffers, against the noise, the Kahan
    add and the virial sample as torch operations on new tensors: f32,
    hi/lo, a 2D box, f64 uncompensated), the accumulators too.

The kernel itself is held to the plain versions on the card
(``tests/test_torch_gpu.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdtpu_torch as mt
from mdtpu.utils.math import kahan_add as j_kahan_add
from mdtpu_torch.integrate import slot_step
from mdtpu_torch.integrate import step as tstep
from mdtpu_torch.integrate import velocity_finish as vf
from mdtpu_torch.integrate import verlet_update as vu
from mdtpu_torch.integrate.ramps import LinearRamp
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.cell_sweep import lean_zero
from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                            initialize_velocities,
                                            lattice_fluid_state,
                                            lattice_positions)
from tests.test_torch_driver import one_torch_thread  # noqa: F401

DTYPES = {"f32": (torch.float32, np.float32, jnp.float32),
          "f64": (torch.float64, np.float64, jnp.float64)}
DT = 0.002


def _rows(dim, dtype, seed=0, n=1001):
    """f, v, vc, x, xc, f2 as (dim, n) numpy arrays of ``dtype``: velocities
    and forces of order 1, positions up to 20, compensations of the size a
    Kahan add leaves."""
    rng = np.random.default_rng(seed)
    shape = (dim, n)
    f, f2 = rng.normal(size=shape) * 30.0, rng.normal(size=shape) * 30.0
    v = rng.normal(size=shape)
    x = rng.uniform(0.0, 20.0, size=shape)
    vc = rng.normal(size=shape) * 1e-8
    xc = rng.normal(size=shape) * 1e-7
    return [a.astype(dtype) for a in (f, v, vc, x, xc, f2)]


def _jax_chain(f, v, vc, x, xc, f2, compensated, jdtype):
    """The JAX package's slot step chain: the half-kick, the drift, then
    the second half-kick with the new forces."""
    dt = jnp.asarray(DT, jdtype)
    half = 0.5 * dt

    def add(a, c, d):
        return j_kahan_add(a, c, d) if compensated else (a + d, c)

    v, vc = add(jnp.asarray(v), jnp.asarray(vc), jnp.asarray(f) * half)
    x, xc = add(jnp.asarray(x), jnp.asarray(xc), v * dt)
    v, vc = add(v, vc, jnp.asarray(f2) * half)
    return [np.asarray(a) for a in (v, vc, x, xc)]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_chain_equals_the_jax_chain(dtype, compensated, dim):
    tdtype, ndtype, jdtype = DTYPES[dtype]
    arrays = _rows(dim, ndtype, seed=dim)
    f, v, vc, x, xc, f2 = (torch.from_numpy(a) for a in arrays)
    v1, vc1, x1, xc1, lo = vu.kick_drift_plain(f, v, vc, x, xc, 0.5 * DT, DT,
                                               compensated)
    v2, vc2 = vu.kick_plain(f2, v1, vc1, 0.5 * DT, compensated)
    want = _jax_chain(*arrays, compensated, jdtype)
    assert lo is None
    for got, w in zip((v2, vc2, x1, xc1), want):
        assert got.dtype == tdtype and w.dtype == ndtype
        np.testing.assert_array_equal(got.numpy(), w)
    if not compensated:
        assert vc2 is vc and xc1 is xc


@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wrappers_on_the_cpu(dtype, compensated):
    """New tensors equal the plain versions' and leave the inputs alone;
    in place the same bits land in the inputs; the low word, the step."""
    tdtype, ndtype, _ = DTYPES[dtype]
    f, v, vc, x, xc, f2 = (torch.from_numpy(a) for a in _rows(3, ndtype))
    keep = [t.clone() for t in (v, vc, x, xc)]
    want = vu.kick_drift_plain(f, v, vc, x, xc, 0.5 * DT, DT, compensated,
                               compensated)
    lo = torch.empty_like(xc) if compensated else None
    got = vu.kick_drift(f, v, vc, x, xc, 0.5 * DT, DT, compensated, lo=lo)
    for a, b in zip(got, want[:4]):
        assert torch.equal(a, b)
    for a, b in zip((v, vc, x, xc), keep):
        assert torch.equal(a, b)
    if compensated:
        assert torch.equal(lo, -want[3])
    bufs = (v, vc, x, xc)
    got = vu.kick_drift(f, v, vc, x, xc, 0.5 * DT, DT, compensated, out=bufs)
    assert all(a is b for a, b in zip(got, bufs))
    for a, b in zip(bufs, want[:4]):
        assert torch.equal(a, b)
    step = torch.tensor(41)
    kv, kvc = vu.kick_plain(f2, v, vc, 0.5 * DT, compensated)
    vu.kick(f2, v, vc, 0.5 * DT, compensated, step)
    assert torch.equal(v, kv) and torch.equal(vc, kvc) and int(step) == 42
    scale = torch.tensor(1.01, dtype=tdtype)
    rv, rvc = vu.rescale_plain(v, vc, scale, compensated)
    nxt = torch.empty_like(step)
    vu.rescale(v, vc, scale, compensated, step, nxt)
    assert torch.equal(v, rv) and torch.equal(vc, rvc)
    assert int(step) == 42 and int(nxt) == 43
    if compensated:
        assert not bool(vc.any())
    if not compensated:
        with pytest.raises(ValueError):
            vu.kick_drift(f, v, vc, x, xc, 0.5 * DT, DT, False,
                          lo=torch.empty_like(xc))


def test_the_finish_writes_around_a_temperature_buffer():
    v = torch.from_numpy(_rows(3, np.float64)[1])
    temp = vf.finish_buffer(torch.tensor(0.25, dtype=torch.float64))
    assert float(temp) == 0.25 and temp.dim() == 0
    pair = vf.finish_pair(temp)
    target = vf.TargetTable(torch.tensor([1.0, 0.9], dtype=torch.float64),
                            torch.tensor(7))
    step = torch.tensor(8)
    scale, got = vf.velocity_finish(v, None, 3, step, 3000.0, DT, 0.4, target,
                                    out=pair)
    want = vf.velocity_finish(v, None, 3, step, 3000.0, DT, 0.4, target)
    assert torch.equal(got, want[1]) and torch.equal(scale, want[0])
    assert torch.equal(temp, want[1]) and torch.equal(pair[0], want[0])
    with pytest.raises(ValueError):
        vf.finish_pair(torch.tensor(1.0))
    with pytest.raises(ValueError):
        vf.velocity_finish(v, None, 3, step, 3000.0, DT, 0.4, target,
                           out=torch.empty(3, dtype=torch.float64))


def test_lean_zero_is_made_once():
    a = lean_zero(torch.float32, "cpu")
    assert a is lean_zero(torch.float32, "cpu") and float(a) == 0.0
    assert lean_zero(torch.float64, "cpu").dtype == torch.float64


# ------------------------------------------- the slot step's two routes


def _old_slot_step(params, ensemble, engine, compensated, observables, hilo,
                   force_dtype):
    """The slot MD step as the port ran it before the chain was one
    kernel: torch operations on new tensors, the sweep's results and the
    finish's returned as they came."""
    obs = observables

    def step(state, ktemp=None):
        slot_step.make_slot_step.steps += 1
        dt = float(params.dt)
        half = 0.5 * dt
        v, vc = tstep._add(state.velocities, state.vel_comp,
                           state.forces * half, compensated)
        x, xc = tstep._add(state.positions, state.pos_comp, v * dt,
                           compensated)
        energy, virial, forces, nbrs = slot_step._sweep_in(
            engine, x, state.diameters, state.unitcell, state.unitcell_inv,
            state.nbrs, obs, force_dtype, -xc if hilo else None)
        if not obs:
            energy, virial = state.energy, state.virial
        v, vc = tstep._add(v, vc, forces * half, compensated)
        v, vc, temperature = tstep.md_velocity_finish(
            ensemble, v, vc, state, dt, compensated, None, ktemp)
        return state.replace(
            positions=x, velocities=v, forces=forces, step=state.step + 1,
            energy=energy, virial=virial, temperature=temperature,
            pos_comp=xc, vel_comp=vc, nbrs=nbrs)

    return step


def _old_brownian_step(params, ensemble, engine, compensated, observables,
                       hilo, force_dtype):
    """The Brownian slot step as the port ran it before its update was one
    kernel: the noise through the seam, masked, the move, the Kahan add and
    the virial sample as torch operations on new tensors."""

    def step(state, ktemp=None):
        slot_step.make_slot_step.steps += 1
        dtype = state.dtype
        drift, sigma, kt = vu.brownian_coefficients(params.dt,
                                                    ensemble.ktemp, dtype)
        energy, virial, forces, nbrs = slot_step._sweep_in(
            engine, state.positions, state.diameters, state.unitcell,
            state.unitcell_inv, state.nbrs, True, force_dtype,
            -state.pos_comp if hilo else None)
        noise = torch.where(
            state.nbrs.occupied[None, :],
            tstep.brownian_noise(state.seed, state.step,
                                 state.positions.shape, dtype, state.device),
            0.0)
        x, xc = tstep._add(state.positions, state.pos_comp,
                           forces * drift + noise * sigma, compensated)
        virial_accum, nprom = tstep.brownian_virial_sample(state, virial)
        return state.replace(
            positions=x, forces=forces, step=state.step + 1, energy=energy,
            virial=virial,
            temperature=torch.full((), kt, dtype=dtype, device=state.device),
            pos_comp=xc, nbrs=nbrs, virial_accum=virial_accum, nprom=nprom)

    return step


def _start(case):
    """A slot state of ``case`` with its engine: 1,000 LJ particles (r_c
    1.5, a short skin so that the segments rebuild), or a tilted 2D box of
    pseudo-hard spheres."""
    if case == "2d":
        n, rho = 900, 0.7
        L = (n / rho) ** 0.5
        cell = np.array([[L, L / 8], [0.0, L]])
        pos = lattice_positions(n, cell, 2, dtype=torch.float32,
                                jitter=0.01, device="cpu")
        state = build_state_from_arrays(pos, np.ones(n), cell, 5,
                                        dtype=torch.float32, cutoff=1.5,
                                        device="cpu")
        state = state.replace(velocities=initialize_velocities(
            1.0, 1, n, 2, dtype=torch.float32, device="cpu"))
        pot, dt = mt.PseudoHS(), 0.001
    else:
        n, rho = 1000, 0.8
        dtype = torch.float64 if case == "f64" else torch.float32
        state = lattice_fluid_state(n, rho, 1.4, dtype=dtype, cutoff=1.5,
                                    jitter=0.05, device="cpu")
        pot, dt = mt.LennardJones(r_cut=1.5), 0.004
    eng = CellGridEngine.create(pot, 1.5, 0.1, state.unitcell, n)
    params = mt.Parameters(rho, n, dt, pot)
    slots = slot_step.slot_forces(slot_step.slotify(state, eng), eng)
    return slots, eng, params


ROUTES = {
    # case: (start, ensemble, compensated, hilo, force_dtype)
    "nvt_ramp": ("f32", mt.NVT(LinearRamp(1.4, 0.9, 40), 0.4), True, False,
                 None),
    "nve_hilo": ("f32", mt.NVE(), True, True, None),
    "nvt_f64": ("f64", mt.NVT(1.2, 0.2), True, False, None),
    "nvt_2d": ("2d", mt.NVT(1.0, 0.1), True, False, None),
    "nve_uncompensated": ("f32", mt.NVE(), False, False, None),
    "nvt_force_f64": ("f32", mt.NVT(1.2, 0.4), True, False, torch.float64),
    "brownian": ("f32", mt.Brownian(1.4), True, False, None),
    "brownian_hilo": ("f32", mt.Brownian(1.4), True, True, None),
    "brownian_2d": ("2d", mt.Brownian(1.0), True, False, None),
    "brownian_f64_uncompensated": ("f64", mt.Brownian(1.2), False, False,
                                   None),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_in_place_route_equals_the_old_composition(route):
    """``make_slot_advance``'s in-place steps against a slot advance of the
    old composition's steps, from one start over segments (1, 9, 9, 6):
    each segment's energy, virial, temperature, Brownian accumulators and
    step, the rebuild steps and the final state's arrays bit for bit."""
    case, ens, compensated, hilo, force_dtype = ROUTES[route]
    slots, eng, params = _start(case)
    if isinstance(ens, mt.Brownian):
        # An overdamped step of the MD step's dt would throw the lattice
        # apart.
        params = mt.Parameters(params.density, params.n_particles,
                               params.dt / 40, params.potential)
    new = slot_step.make_slot_advance(params, ens, eng,
                                      compensated=compensated, hilo=hilo,
                                      force_dtype=force_dtype)
    kw = dict(compensated=compensated, hilo=hilo, force_dtype=force_dtype)
    old_step = (_old_brownian_step if isinstance(ens, mt.Brownian)
                else _old_slot_step)
    old = slot_step.SlotAdvance(
        old_step(params, ens, eng, observables=False, **kw),
        old_step(params, ens, eng, observables=True, **kw),
        eng, ens, True, False)
    runs = {}
    for name, advance in (("new", new), ("old", old)):
        s, rows = slots, []
        for k in (1, 9, 9, 6):
            step = s.step
            s = advance(s, k)
            assert s.step == step + k
            rows.append(torch.stack([s.energy, s.virial, s.temperature,
                                     s.virial_accum,
                                     s.nprom.to(s.virial_accum.dtype)]))
        runs[name] = (s, torch.stack(rows), advance.rebuild_steps())
    (sn, rn, bn), (so, ro, bo) = runs["new"], runs["old"]
    assert bn == bo and len(bn) >= 1, (bn, bo)
    assert torch.equal(rn, ro)
    for field in ("positions", "velocities", "forces", "pos_comp",
                  "vel_comp", "images", "ids", "temperature", "energy",
                  "virial_accum", "nprom"):
        assert torch.equal(getattr(sn, field), getattr(so, field)), field
    assert bool(torch.isfinite(sn.positions).all())
    if isinstance(ens, mt.Brownian):
        assert int(sn.nprom) == 3        # steps 0, 10 and 20 sampled
