"""The particle-order step as one device segment on the CPU, where the
kernels' wrappers take their plain versions:

  * the plain kick-drift-wrap (``verlet_update.kick_drift_wrap_plain``)
    against the JAX package's ``kahan_add`` chain and its
    ``wrap_positions_compensated`` / ``wrap_positions``, on rows made by
    numpy from a seed (3D, 2D and a tilted 3D cell; f32 and f64;
    compensated and not): the kicks bit for bit; the wrapped positions and
    their compensation bit for bit in the diagonal cells (every product
    with a zero entry is exact, so both sides round alike), within rel
    1e-12 (f64) or 1e-6 (f32) of the box length in the tilted one (the JAX
    package takes the products as a matmul, whose order of sums is XLA's);
    the images equal;
  * the plain Brownian move (``verlet_update.brownian_rows_plain``, the
    JAX package's noise replayed through ``integrate.step.brownian_noise``)
    against the JAX package's move, at the same tolerances, and its virial
    sample;
  * the plain drift test (``philox_draws.rebuild_flag_rows_plain``) row by
    row against the JAX package's ``CellGridEngine.needs_rebuild`` (the
    cell's minimum image; cubic and tilted) and
    ``NeighborListEngine.needs_rebuild`` (the box lengths; 3D and 2D), on
    displacements within 2% of skin/2, across the box's faces too: every
    flag equal; and against the engines' test as it was written before
    (``torch.sum`` over the last axis), flag for flag;
  * ``make_particle_advance`` run eagerly on ``PlaneEngine`` (NVT
    uncompensated, as the B2 path runs it; NVE on the hi/lo sweep), the
    neighbour list (NVT, NVE, NVT on a ramp), the naive engine (NVT, and
    NVE in 2D), the cell grid with ``compensated=False`` in a tilted box
    (NVT) and Brownian on ``PlaneEngine`` and on the cell grid in 2D, in
    segments of 1, 9, 12 and 8 steps with rebuilds, against the
    composition the driver's step loop ran before (written out here:
    torch adds, wraps, the engines' former test, ``md_velocity_finish``):
    every segment's numbers, the final arrays and the rebuild steps bit
    for bit (on the ramp, whose targets come from the device table, the
    numbers within rel 1e-12 and the rebuild steps equal);
  * the advance against the JAX package's ``fori_loop`` of ``make_step``
    on its neighbour list (NVE, f64) and on its cell grid (Brownian,
    ``compensated=False``, the noise replayed), to rel 1e-9 in energy and
    1e-9 in positions as ``tests/test_torch_driver.py`` holds the driver;
  * a segment reads nothing on the host but the rebuild flag, once a step
    (``device_if``); the steps write the buffers in place; after a rebuild
    the buffers' reference positions are a tensor of their own that holds
    the build's positions; a state without engine state takes its first
    step with its first build; the graph option's checks: ``graph=None``
    settles by the device alone (captured on a CUDA device, eager on the
    CPU), a user potential's loops too, for the slot, sharded and
    particle-order advances and both FIREs.

The kernels themselves are held to these plain versions on the card
(``tests/test_torch_gpu.py``)."""

import dataclasses
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdtpu_torch as mt
from mdtpu.core.box import wrap_positions as j_wrap
from mdtpu.core.box import wrap_positions_compensated as j_wrap_comp
from mdtpu.core.types import Brownian as JBrownian
from mdtpu.core.types import NVE as JNVE
from mdtpu.core.types import Parameters as JParameters
from mdtpu.integrate.step import brownian_noise as j_brownian_noise
from mdtpu.integrate.step import make_step as j_make_step
from mdtpu.ops.cell_grid import CellGridEngine as JCellGrid
from mdtpu.ops.neighbor_list import NeighborListEngine as JNeighborList
from mdtpu.potentials.lennard_jones import LennardJones as JLJ
from mdtpu.potentials.pseudo_hs import PseudoHS as JPHS
from mdtpu.sim.initialization import build_state_from_arrays as j_build_state
from mdtpu.utils.math import kahan_add as j_kahan_add
from mdtpu_torch.core.box import (minimum_image, wrap_positions,
                                  wrap_positions_compensated)
from mdtpu_torch.integrate import device_advance
from mdtpu_torch.integrate import step as tstep
from mdtpu_torch.integrate import verlet_update as vu
from mdtpu_torch.integrate.ramps import LinearRamp
from mdtpu_torch.ops import philox_draws as draws
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.experimental import PlaneEngine
from mdtpu_torch.ops.naive import NaivePairEngine
from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                            lattice_fluid_state)
from tests.test_torch_driver import one_torch_thread  # noqa: F401

DTYPES = {"f32": (torch.float32, np.float32, jnp.float32),
          "f64": (torch.float64, np.float64, jnp.float64)}
# Box-length tolerances where the JAX package's matmul may sum in another
# order than the port's fixed-order products (the tilted cell).
REL = {"f32": 1e-6, "f64": 1e-12}
L_BOX = 9.0


def _cell(name):
    if name == "2d":
        return np.eye(2) * L_BOX
    if name == "tilted":
        return np.array([[L_BOX, L_BOX / 8, L_BOX / 12],
                         [0.0, L_BOX, L_BOX / 6],
                         [0.0, 0.0, L_BOX]])
    return np.eye(3) * L_BOX


def _rows(cell, dtype, seed=0, n=400):
    """f, v, vc, x, xc (n, d) and images (n, d) int64 as numpy arrays:
    positions at fractional coordinates in [-0.05, 1.05) (some outside the
    box, so the wrap folds them), velocities of order 3 (the drift moves
    some across a face), compensations of the size a Kahan add leaves."""
    rng = np.random.default_rng(seed)
    d = cell.shape[0]
    frac = rng.uniform(-0.05, 1.05, size=(n, d))
    x = frac @ cell.T
    f = rng.normal(size=(n, d)) * 30.0
    v = rng.normal(size=(n, d)) * 3.0
    vc = rng.normal(size=(n, d)) * 1e-8
    xc = rng.normal(size=(n, d)) * 1e-7
    images = rng.integers(-3, 4, size=(n, d))
    return [a.astype(dtype) for a in (f, v, vc, x, xc)] + [images]


def _box(cell, dtype):
    inv = np.linalg.inv(cell)
    return cell.astype(dtype), inv.astype(dtype)


def _assert_wrapped(got, want, cell_name, tag, scale):
    """Bit for bit in a diagonal cell, else within REL of the box length."""
    got, want = np.asarray(got), np.asarray(want)
    if cell_name == "tilted":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=REL[tag] * scale)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cell_name", ["cubic", "2d", "tilted"])
@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_kick_drift_wrap_plain_matches_jax(tag, compensated, cell_name):
    tdtype, ndtype, jdtype = DTYPES[tag]
    cell = _cell(cell_name)
    f, v, vc, x, xc, images = _rows(cell, ndtype)
    c, ci = _box(cell, ndtype)
    dt = 0.01
    got = vu.kick_drift_wrap_plain(
        *(torch.as_tensor(a) for a in (f, v, vc, x, xc, images, c, ci)),
        0.5 * dt, dt, compensated, lo=compensated)

    jdt = jnp.asarray(dt, jdtype)
    half = 0.5 * jdt

    def add(a, comp, dx):
        return j_kahan_add(a, comp, dx) if compensated else (a + dx, comp)

    jv, jvc = add(jnp.asarray(v), jnp.asarray(vc), jnp.asarray(f) * half)
    jx, jxc = add(jnp.asarray(x), jnp.asarray(xc), jv * jdt)
    jc, jci = jnp.asarray(c), jnp.asarray(ci)
    if compensated:
        jx, jxc, jimg = j_wrap_comp(jx, jxc, jnp.asarray(images), jc, jci)
    else:
        jx, jimg = j_wrap(jx, jnp.asarray(images), jc, jci)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jvc))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(jimg))
    _assert_wrapped(got[2].numpy(), jx, cell_name, tag, L_BOX)
    _assert_wrapped(got[3].numpy(), jxc, cell_name, tag, 1e-7)
    assert (got[5] is None) == (not compensated)
    if compensated:
        np.testing.assert_array_equal(got[5].numpy(), -got[3].numpy())
    # Some particles crossed a face and were folded back.
    assert np.any(got[4].numpy() != images)


@pytest.mark.parametrize("cell_name", ["cubic", "2d", "tilted"])
@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_brownian_rows_plain_matches_jax(tag, compensated, cell_name,
                                         monkeypatch):
    tdtype, ndtype, jdtype = DTYPES[tag]
    cell = _cell(cell_name)
    f, _, _, x, xc, images = _rows(cell, ndtype, seed=1)
    c, ci = _box(cell, ndtype)
    key = jax.random.PRNGKey(11)
    step, dt, kt = 40, 2e-3, 1.3

    def noise(seed, s, shape, dtype, device):
        xi = j_brownian_noise(key, int(s), tuple(shape), jdtype, None)
        return torch.as_tensor(np.array(xi), dtype=dtype, device=device)

    monkeypatch.setattr(tstep, "brownian_noise", noise)
    state = types.SimpleNamespace(
        positions=torch.as_tensor(x), pos_comp=torch.as_tensor(xc),
        images=torch.as_tensor(images), unitcell=torch.as_tensor(c),
        unitcell_inv=torch.as_tensor(ci), seed=0, step=step, dtype=tdtype,
        device=torch.device("cpu"),
        virial_accum=torch.tensor(2.5, dtype=tdtype),
        nprom=torch.tensor(4))
    virial = torch.tensor(-12.25, dtype=tdtype)
    coeffs = vu.brownian_coefficients(dt, kt, tdtype)
    got = vu.brownian_rows_plain(torch.as_tensor(f), virial, state, *coeffs,
                                 compensated)

    jdt, jkt = jnp.asarray(dt, jdtype), jnp.asarray(kt, jdtype)
    dx = (jnp.asarray(f) * (jdt / jkt)
          + j_brownian_noise(key, step, x.shape, jdtype, None)
          * jnp.sqrt(2.0 * jdt))
    if compensated:
        jx, jxc = j_kahan_add(jnp.asarray(x), jnp.asarray(xc), dx)
        jx, jxc, jimg = j_wrap_comp(jx, jxc, jnp.asarray(images),
                                    jnp.asarray(c), jnp.asarray(ci))
    else:
        jx, jxc = jnp.asarray(x) + dx, jnp.asarray(xc)
        jx, jimg = j_wrap(jx, jnp.asarray(images), jnp.asarray(c),
                          jnp.asarray(ci))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jimg))
    _assert_wrapped(got[0].numpy(), jx, cell_name, tag, L_BOX)
    _assert_wrapped(got[1].numpy(), jxc, cell_name, tag, 1e-7)
    # Step 40 samples the virial; the temperature column is kT.
    assert float(got[3]) == float(torch.tensor(2.5 - 12.25, dtype=tdtype))
    assert int(got[4]) == 5
    assert float(got[5]) == float(np.asarray(kt, ndtype))


def _old_flag(positions, ref, skin, cell, cell_inv, lengths):
    """The engines' drift test as it was written before: ``torch.sum``
    over the last axis."""
    disp = positions - ref
    if lengths is None:
        disp = minimum_image(disp, cell, cell_inv)
    else:
        disp = disp - lengths * torch.round(disp / lengths)
    half_skin = 0.5 * skin
    d2 = torch.sum(disp * disp, dim=-1)
    return torch.any(d2 > half_skin * half_skin)


@pytest.mark.parametrize("form", ["cell_cubic", "cell_tilted", "lengths_3d",
                                  "lengths_2d"])
@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_drift_test_plain_matches_jax(tag, form):
    tdtype, ndtype, jdtype = DTYPES[tag]
    cell = _cell({"cell_tilted": "tilted", "lengths_2d": "2d"}.get(form,
                                                                  "cubic"))
    c, ci = _box(cell, ndtype)
    d, skin, n = cell.shape[0], 0.3, 96
    rng = np.random.default_rng(3)
    # References inside the box, half of them at a face; displacements of
    # length within 2% of skin/2 (the threshold), outside +-1e-4 of it.
    frac = rng.uniform(0.0, 1.0, size=(n, d))
    frac[::2, 0] = rng.choice([0.001, 0.999], size=n // 2)
    ref = frac @ cell.T
    u = rng.normal(size=(n, d))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    ratio = rng.uniform(0.98, 1.02, size=(n, 1))
    ratio = np.where(np.abs(ratio - 1) < 1e-4, 1.01, ratio)
    pos = ref + u * ratio * 0.5 * skin
    pos = pos - np.floor(pos @ np.linalg.inv(cell).T) @ cell.T   # wrapped
    ref, pos = ref.astype(ndtype), pos.astype(ndtype)
    if form.startswith("cell"):
        jeng = JCellGrid.create(JLJ(r_cut=2.5), 2.5, skin, cell, n)
        box = dict(cell=torch.as_tensor(c), cell_inv=torch.as_tensor(ci))
    else:
        jeng = JNeighborList.create(JLJ(r_cut=2.5), 2.5, skin, cell, n)
        box = dict(lengths=torch.diagonal(torch.as_tensor(c)))
    flags = []
    for i in range(n):
        p, r = torch.as_tensor(pos[i:i + 1]), torch.as_tensor(ref[i:i + 1])
        mine = draws.rebuild_flag_rows(p, r, skin, **box)
        old = _old_flag(p, r, skin, box.get("cell"), box.get("cell_inv"),
                        box.get("lengths"))
        theirs = jeng.needs_rebuild(
            jnp.asarray(pos[i:i + 1]),
            types.SimpleNamespace(ref_positions=jnp.asarray(ref[i:i + 1])),
            jnp.asarray(c), jnp.asarray(ci))
        assert bool(mine) == bool(old) == bool(theirs), i
        flags.append(bool(mine))
    assert 0 < sum(flags) < n            # both sides of the threshold


# ------------------------------------------------- the advance, eagerly


def _lj_start(dtype, n=500):
    return lattice_fluid_state(n, 0.8, 1.2, dtype=dtype, cutoff=2.5,
                               jitter=0.05, device="cpu")


def _tilted_start(dtype, n=512):
    L = (n / 0.8) ** (1.0 / 3.0)
    cell = np.array([[L, L / 8, L / 12], [0.0, L, L / 6], [0.0, 0.0, L]])
    per = 8
    idx = np.indices((per,) * 3).reshape(3, -1).T[:n]
    frac = (idx + 0.5) / per + 0.005 * np.random.default_rng(4).normal(
        size=(n, 3))
    st = build_state_from_arrays(frac @ cell.T, np.ones(n), cell, 1,
                                 dtype=dtype, cutoff=2.5, device="cpu")
    return st.replace(velocities=mt.initialize_velocities(
        1.2, 3, n, 3, dtype=dtype, device="cpu"))


def _disks(dtype, n=400):
    return lattice_fluid_state(n, 0.7, 1.0, dimension=2, dtype=dtype,
                               cutoff=1.5, jitter=0.05, device="cpu")


def _phs_start(dtype, n=512):
    return lattice_fluid_state(n, 0.5, 1.0, dtype=dtype, cutoff=1.5,
                               jitter=0.05, device="cpu")


LJ = mt.LennardJones(r_cut=2.5)
PHS = mt.PseudoHS()


def _plane(st, pot, cutoff):
    return PlaneEngine.create(pot, cutoff, 0.3, st.unitcell, st.n_particles)


def _neighbor(st, pot, cutoff):
    return mt.select_engine(pot, cutoff, st, prefer="neighbor")


def _naive(st, pot, cutoff):
    return NaivePairEngine(pot, cutoff)


def _cellgrid(st, pot, cutoff):
    return CellGridEngine.create(pot, cutoff, 0.3, st.unitcell,
                                 st.n_particles)


# name: (start, potential, cutoff, engine, ensemble, compensated, hilo, dt)
CASES = {
    "plane_nvt": (_lj_start, torch.float64, LJ, 2.5, _plane,
                  mt.NVT(1.2, 0.4), False, False, 0.004),
    "plane_nve_hilo": (_lj_start, torch.float32, LJ, 2.5, _plane, mt.NVE(),
                       True, True, 0.004),
    "neighbor_nvt": (_lj_start, torch.float64, LJ, 2.5, _neighbor,
                     mt.NVT(1.2, 0.4), True, False, 0.004),
    "neighbor_nve": (_lj_start, torch.float32, LJ, 2.5, _neighbor, mt.NVE(),
                     True, False, 0.004),
    "neighbor_nvt_ramp": (_lj_start, torch.float64, LJ, 2.5, _neighbor,
                          mt.NVT(LinearRamp(1.4, 0.9, 30), 0.4), True,
                          False, 0.004),
    "naive_nvt": (_lj_start, torch.float64, LJ, 2.5, _naive,
                  mt.NVT(1.2, 0.4), True, False, 0.004),
    "naive_2d_nve": (_disks, torch.float64, PHS, 1.5, _naive, mt.NVE(),
                     True, False, 0.002),
    "cellgrid_tilted_nvt": (_tilted_start, torch.float32, LJ, 2.5,
                            _cellgrid, mt.NVT(1.2, 0.4), False, False,
                            0.004),
    "brownian_plane": (_phs_start, torch.float32, PHS, 1.5, _plane,
                       mt.Brownian(1.0), True, False, 5e-5),
    "brownian_cellgrid_2d": (_disks, torch.float64, PHS, 1.5, _cellgrid,
                             mt.Brownian(1.0), False, False, 5e-5),
}
SEGMENTS = (1, 9, 12, 8)


def _start(case):
    start, dtype, pot, cutoff, engine_of, ens, comp, hilo, dt = CASES[case]
    st = start(dtype)
    eng = engine_of(st, pot, cutoff)
    params = mt.Parameters(0.8, st.n_particles, dt, pot)
    nbrs = eng.allocate(st.positions, st.diameters, st.unitcell,
                        st.unitcell_inv)
    if not isinstance(ens, mt.Brownian):
        e, w, f, nbrs = eng.compute(st.positions, st.diameters, st.unitcell,
                                    st.unitcell_inv, nbrs)
        st = st.replace(forces=f, energy=e, virial=w)
    return st.replace(nbrs=nbrs), eng, params, ens, comp, hilo


def _old_step(params, ensemble, engine, compensated, hilo, rebuilt):
    """The particle-order step the driver ran in a loop before the
    advance: torch adds and wraps, the engines' former drift test read on
    the host, ``md_velocity_finish`` or the Brownian noise and move;
    ``rebuilt`` collects the steps in which it rebuilt."""

    def forces_at(x, state, pos_lo):
        cell, cell_inv, nbrs = state.unitcell, state.unitcell_inv, state.nbrs
        if not isinstance(engine, NaivePairEngine):
            lengths = (torch.diagonal(cell) if isinstance(
                engine, mt.NeighborListEngine) else None)
            if bool(_old_flag(x, nbrs.ref_positions, engine.skin, cell,
                              cell_inv, lengths)):
                rebuilt.append(state.step)
                fresh = engine.allocate(x, state.diameters, cell, cell_inv)
                nbrs = dataclasses.replace(
                    fresh, overflow=fresh.overflow | nbrs.overflow)
        kw = {} if pos_lo is None else {"pos_lo": pos_lo}
        return engine.compute(x, state.diameters, cell, cell_inv, nbrs, **kw)

    def wrap(x, xc, state):
        if compensated:
            return wrap_positions_compensated(x, xc, state.images,
                                              state.unitcell,
                                              state.unitcell_inv)
        x, images = wrap_positions(x, state.images, state.unitcell,
                                   state.unitcell_inv)
        return x, xc, images

    def md(state):
        dt = float(params.dt)
        half = 0.5 * dt
        v, vc = tstep._add(state.velocities, state.vel_comp,
                           state.forces * half, compensated)
        x, xc = tstep._add(state.positions, state.pos_comp, v * dt,
                           compensated)
        x, xc, images = wrap(x, xc, state)
        energy, virial, forces, nbrs = forces_at(x, state,
                                                 -xc if hilo else None)
        v, vc = tstep._add(v, vc, forces * half, compensated)
        v, vc, temperature = tstep.md_velocity_finish(ensemble, v, vc, state,
                                                      dt, compensated)
        return state.replace(
            positions=x, velocities=v, forces=forces, images=images,
            step=state.step + 1, energy=energy, virial=virial,
            temperature=temperature, pos_comp=xc, vel_comp=vc, nbrs=nbrs)

    def brownian(state):
        drift, sigma, kt = vu.brownian_coefficients(params.dt, ensemble.ktemp,
                                                    state.dtype)
        energy, virial, forces, nbrs = forces_at(
            state.positions, state, -state.pos_comp if hilo else None)
        noise = tstep.brownian_noise(state.seed, state.step,
                                     state.positions.shape, state.dtype,
                                     state.device)
        x, xc = tstep._add(state.positions, state.pos_comp,
                           forces * drift + noise * sigma, compensated)
        x, xc, images = wrap(x, xc, state)
        accum, nprom = tstep.brownian_virial_sample(state, virial)
        return state.replace(
            positions=x, forces=forces, images=images, step=state.step + 1,
            energy=energy, virial=virial,
            temperature=torch.full((), kt, dtype=state.dtype),
            pos_comp=xc, nbrs=nbrs, virial_accum=accum, nprom=nprom)

    return brownian if isinstance(ensemble, mt.Brownian) else md


def _numbers(s):
    return torch.stack([s.energy, s.virial, s.temperature, s.virial_accum,
                        s.nprom.to(s.virial_accum.dtype)])


FIELDS = ("positions", "velocities", "forces", "images", "pos_comp",
          "vel_comp", "energy", "virial", "temperature", "virial_accum",
          "nprom")


@pytest.mark.parametrize("case", sorted(CASES))
def test_advance_equals_the_former_step_loop(case):
    st, eng, params, ens, comp, hilo = _start(case)
    rebuilt = []
    old_step = _old_step(params, ens, eng, comp, hilo, rebuilt)
    advance = tstep.make_particle_advance(params, ens, eng, comp, hilo=hilo)
    old, new, rows_old, rows_new = st, st, [], []
    for k in SEGMENTS:
        for _ in range(k):
            old = old_step(old)
        new = advance(new, k)
        assert new.step == old.step and isinstance(new.step, int)
        rows_old.append(_numbers(old))
        rows_new.append(_numbers(new))
    assert advance.graph is False
    assert advance.rebuild_steps() == rebuilt
    if not isinstance(eng, NaivePairEngine):
        assert len(rebuilt) >= 1
    if case.endswith("ramp"):
        # Device-table targets: rounded as a tensor, the loop's as a host
        # number.
        np.testing.assert_allclose(torch.stack(rows_new).numpy(),
                                   torch.stack(rows_old).numpy(),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(new.positions.numpy(),
                                   old.positions.numpy(), rtol=0,
                                   atol=1e-12 * L_BOX)
        return
    assert torch.equal(torch.stack(rows_new), torch.stack(rows_old))
    for field in FIELDS:
        assert torch.equal(getattr(new, field), getattr(old, field)), field


# ----------------------------------------------- against the JAX package


def _jax_run(jstate, jparams, jens, jeng, compensated, steps):
    jstate = jstate.replace(nbrs=jeng.allocate(
        jstate.positions, jstate.diameters, jstate.unitcell,
        jstate.unitcell_inv))
    if not isinstance(jens, JBrownian):
        e, w, f, nbrs = jeng.compute(jstate.positions, jstate.diameters,
                                     jstate.unitcell, jstate.unitcell_inv,
                                     jstate.nbrs)
        jstate = jstate.replace(forces=f, energy=e, virial=w, nbrs=nbrs)
    step = j_make_step(jparams, jens, jeng, compensated)
    run = jax.jit(lambda s: jax.lax.fori_loop(0, steps,
                                              lambda i, t: step(t), s))
    return run(jstate)


def _port_state(pos, diam, cell, vel, dtype, cutoff):
    return build_state_from_arrays(pos, diam, cell, 0, velocities=vel,
                                   dtype=dtype, cutoff=cutoff, device="cpu")


def test_neighbor_nve_matches_jax_fori_loop():
    n, steps = 500, 30
    st = _lj_start(torch.float64, n)
    pos, vel = st.positions.numpy(), st.velocities.numpy()
    cell = st.unitcell.numpy()
    jstate = j_build_state(pos, np.ones(n), cell, jax.random.PRNGKey(0),
                           velocities=vel, dtype=jnp.float64, cutoff=2.5)
    jparams = JParameters(density=0.8, n_particles=n, dt=0.004,
                          potential=JLJ(r_cut=2.5))
    jeng = JNeighborList.create(JLJ(r_cut=2.5), 2.5, 0.3, cell, n)
    jout = _jax_run(jstate, jparams, JNVE(), jeng, True, steps)

    tst = _port_state(pos, np.ones(n), cell, vel, torch.float64, 2.5)
    eng = mt.NeighborListEngine.create(LJ, 2.5, 0.3, cell, n)
    nbrs = eng.allocate(tst.positions, tst.diameters, tst.unitcell,
                        tst.unitcell_inv)
    e, w, f, nbrs = eng.compute(tst.positions, tst.diameters, tst.unitcell,
                                tst.unitcell_inv, nbrs)
    tst = tst.replace(forces=f, energy=e, virial=w, nbrs=nbrs)
    params = mt.Parameters(0.8, n, 0.004, LJ)
    advance = tstep.make_particle_advance(params, mt.NVE(), eng)
    out = advance(advance(tst, 12), steps - 12)
    assert len(advance.rebuild_steps()) >= 1
    np.testing.assert_allclose(out.positions.numpy(),
                               np.asarray(jout.positions), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(out.images.numpy(),
                                  np.asarray(jout.images))
    for name in ("energy", "virial", "temperature"):
        np.testing.assert_allclose(float(getattr(out, name)),
                                   float(getattr(jout, name)), rtol=1e-9)


def test_brownian_uncompensated_matches_jax_fori_loop(monkeypatch):
    n, steps, dt = 512, 30, 5e-5
    st = _phs_start(torch.float64, n)
    pos, cell = st.positions.numpy(), st.unitcell.numpy()
    key = jax.random.PRNGKey(5)
    jstate = j_build_state(pos, np.ones(n), cell, key, dtype=jnp.float64,
                           cutoff=1.5)
    jparams = JParameters(density=0.5, n_particles=n, dt=dt, potential=JPHS())
    jeng = JCellGrid.create(JPHS(), 1.5, 0.3, cell, n)
    jout = _jax_run(jstate, jparams, JBrownian(1.0), jeng, False, steps)

    def noise(seed, s, shape, dtype, device):
        xi = j_brownian_noise(key, int(s), tuple(shape), jnp.float64, None)
        return torch.as_tensor(np.array(xi), dtype=dtype, device=device)

    monkeypatch.setattr(tstep, "brownian_noise", noise)
    tst = _port_state(pos, np.ones(n), cell, None, torch.float64, 1.5)
    eng = CellGridEngine.create(PHS, 1.5, 0.3, cell, n)
    tst = tst.replace(nbrs=eng.allocate(tst.positions, tst.diameters,
                                        tst.unitcell, tst.unitcell_inv))
    params = mt.Parameters(0.5, n, dt, PHS)
    advance = tstep.make_particle_advance(params, mt.Brownian(1.0), eng,
                                          compensated=False)
    out = advance(advance(tst, 7), steps - 7)
    assert len(advance.rebuild_steps()) >= 1
    np.testing.assert_allclose(out.positions.numpy(),
                               np.asarray(jout.positions), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(out.images.numpy(),
                                  np.asarray(jout.images))
    for name in ("energy", "virial", "virial_accum"):
        np.testing.assert_allclose(float(getattr(out, name)),
                                   float(getattr(jout, name)), rtol=1e-9)
    assert int(out.nprom) == int(jout.nprom) == 3


# ------------------------------------------------------ the advance's rules

READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist",
         "numpy", "cpu")


@pytest.mark.parametrize("case", ["cellgrid_tilted_nvt",
                                  "brownian_cellgrid_2d"])
def test_segment_reads_nothing_but_the_rebuild_flag(case, monkeypatch):
    st, eng, params, ens, comp, hilo = _start(case)
    advance = tstep.make_particle_advance(params, ens, eng, comp, hilo=hilo)
    advance(st, 1)                          # buffers made, engine asked
    k, reads, allowed = 20, [], []

    def read_guard(name, original):
        def read(self, *args, **kwargs):
            if (name == "__bool__" and sys._getframe(1).f_code
                    is device_advance.device_if.__code__):
                allowed.append(1)
                return original(self, *args, **kwargs)
            reads.append(name)
            raise AssertionError(f"host read Tensor.{name}")
        return read

    with monkeypatch.context() as m:
        for name in READS:
            m.setattr(torch.Tensor, name,
                      read_guard(name, getattr(torch.Tensor, name)))
        out = advance(st, k)
    assert reads == [] and len(allowed) == k
    assert out.step == st.step + k


@pytest.mark.parametrize("case", ["plane_nve_hilo", "brownian_plane"])
def test_steps_write_the_buffers_in_place(case):
    """A step on the advance's buffers returns a state of the buffers' own
    tensors where the chain writes them (positions, their compensation and
    images, velocities, the step counter and the temperature); the
    engine's results are copied in."""
    st, eng, params, ens, comp, hilo = _start(case)
    advance = tstep.make_particle_advance(params, ens, eng, comp, hilo=hilo)
    advance._load(st)
    advance._untested = advance._never_rebuilds(st)
    b = advance.bufs
    out = advance.step_fn(b, advance._target(), advance._refresh)
    names = ["positions", "pos_comp", "images", "step", "temperature"]
    if not isinstance(ens, mt.Brownian):
        names += ["velocities", "vel_comp"]
    for name in names:
        assert getattr(out, name) is getattr(b, name), name
    assert int(b.step) == st.step + 1


def test_rebuild_keeps_its_own_reference():
    """After in-place steps and rebuilds, the buffers' reference positions
    are not the positions tensor and hold the last build's positions."""
    st, eng, params, ens, comp, hilo = _start("neighbor_nvt")
    built = []
    allocate = type(eng).allocate

    def recording(self, positions, *args):
        built.append(positions.clone())
        return allocate(self, positions, *args)

    advance = tstep.make_particle_advance(params, ens, eng, comp)
    try:
        type(eng).allocate = recording
        advance(st, 28)
    finally:
        type(eng).allocate = allocate
    b = advance.bufs
    steps = advance.rebuild_steps()
    assert len(steps) == len(built) >= 1
    assert steps[-1] < st.step + 27          # the last step moved on
    assert b.nbrs.ref_positions is not b.positions
    assert b.nbrs.ref_positions.data_ptr() != b.positions.data_ptr()
    assert torch.equal(b.nbrs.ref_positions, built[-1])
    assert not torch.equal(b.positions, built[-1])


def test_first_build_and_graph_options():
    st, eng, params, ens, comp, hilo = _start("neighbor_nve")
    fresh = st.replace(nbrs=None)
    advance = tstep.make_particle_advance(params, ens, eng, comp)
    one = tstep.make_step(params, ens, eng, comp)
    a = advance(fresh, 5)
    b = fresh
    for _ in range(5):
        b = one(b)
    assert a.step == 5 and torch.equal(a.positions, b.positions)
    assert advance(a, 0) is a
    with pytest.raises(ValueError, match="graph=True"):
        tstep.make_particle_advance(params, ens, eng, comp, graph=True)(st, 2)

    # graph=None settles by the device alone: eager for a CPU state,
    # whatever the potential (test_graph_none_settles_by_the_device).
    assert advance.graph is False
    unsettled = tstep.make_particle_advance(params, ens, eng, comp)
    unsettled._resolve_graph(st)
    assert unsettled.graph is False


def _loop_of(kind, potential, graph):
    """``settle(state) -> bool`` of a loop of ``kind`` made with ``graph``
    over ``potential`` (a 2D box of 400 disks at rho 0.9): the slot
    advance, the sharded one (a ring of one), the particle-order advance
    (the naive engine), the slot FIRE or the row FIRE; the advances keep
    the settled value in ``graph``, FIRE settles at each run."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.minimize import fire
    from mdtpu_torch.minimize import fire_update as fu
    from mdtpu_torch.parallel.halo_slot import (HaloSlotEngine,
                                                make_sharded_slot_advance)
    from mdtpu_torch.parallel.mesh import ShardRing

    cell = np.eye(2) * (400 / 0.9) ** 0.5
    params = mt.Parameters(0.9, 400, 1e-4, potential)
    nvt = mt.NVT(0.5, 0.01)
    hyper = fu.FireHyper(dt_initial=0.01, dt_max=0.1, alpha0=0.1,
                         f_inc=1.2, f_dec=0.2, n_min=5, dmax=0.1)
    if kind in ("slot", "slot_fire"):
        eng = CellGridEngine.create(potential, 1.8, 0.3, cell, 400)
        if kind == "slot_fire":
            loop = fire.SlotFire(eng, hyper, graph)
            return loop._settle
        loop = slot_step.make_slot_advance(params, nvt, eng, graph=graph)
        assert type(loop) is slot_step.SlotAdvance
    elif kind == "sharded_slot":
        eng = HaloSlotEngine.create(potential, 1.8, cell, 400,
                                    ShardRing(None, "cpu"))
        loop = make_sharded_slot_advance(params, nvt, eng, graph=graph)
        assert type(loop) is slot_step.ShardedSlotAdvance
    elif kind == "row_fire":
        return fire.RowFire(NaivePairEngine(potential, 1.8), hyper,
                            graph)._settle
    else:
        loop = tstep.make_particle_advance(
            params, nvt, NaivePairEngine(potential, 1.8), graph=graph)

    def settle(state):
        loop._resolve_graph(state)
        return loop.graph

    return settle


@pytest.mark.parametrize("potential", ["user", "functor"])
@pytest.mark.parametrize("kind", ["slot", "sharded_slot", "particle",
                                  "slot_fire", "row_fire"])
def test_graph_none_settles_by_the_device(kind, potential):
    """``graph=None`` settles captured for a state on a CUDA device and
    eager for one on the CPU, a user potential (examples/03's) or one with
    a kernel functor alike (a stand-in object with a CUDA device needs no
    card); ``graph=False`` stays eager; ``graph=True`` raises on a CPU
    state. Every loop settles by ``device_advance.settle_graph``."""
    from tests.test_torch_gpu import NonAdditivePHS

    pot = (NonAdditivePHS() if potential == "user"
           else mt.PseudoHS())
    card = types.SimpleNamespace(device=torch.device("cuda"))
    cpu = types.SimpleNamespace(device=torch.device("cpu"))
    assert _loop_of(kind, pot, None)(card) is True
    assert _loop_of(kind, pot, None)(cpu) is False
    assert _loop_of(kind, pot, False)(card) is False
    assert _loop_of(kind, pot, True)(card) is True
    with pytest.raises(ValueError, match="graph=True takes a CUDA state"):
        _loop_of(kind, pot, True)(cpu)


def test_counts_of_a_taken_branch_come_in_at_settle():
    """``counters.add_later``: the counts of a captured rebuild's launches,
    times the rebuilds a device tally saw, are added at ``settle``."""
    from mdtpu_torch.utils import counters

    def owner():
        pass

    owner.launches = 5
    counters.register(owner, "launches")
    try:
        delta = {(owner, "launches"): 2}
        counters.add_later(delta, torch.tensor(3), torch.tensor(7))
        assert owner.launches == 5
        counters.settle()
        assert owner.launches == 5 + 2 * 4
        counters.settle()
        assert owner.launches == 13
    finally:
        counters.unregister(owner, "launches")
