"""The port's cell-grid engine (its pair sweep runs the plain version on the
CPU) against the JAX package's CellGridEngine, its Pallas B1 kernel
(PallasCellEngine in interpret mode) and its naive oracle.

Tolerances: at f64 those of tests/test_experimental_pallas.py (energy and
virial rtol 1e-12, forces rtol 1e-10 / atol 1e-12); at f32 against the f64
naive oracle, rtol 2e-5 on energy and virial and 5e-6 on forces scaled by
their largest magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdtpu.ops.cell_grid import CellGridEngine as JCellGrid
from mdtpu.ops.experimental import PallasCellEngine
from mdtpu.ops.naive import NaivePairEngine as JNaive
from mdtpu.potentials.lennard_jones import LennardJones as JLJ
from mdtpu.potentials.pseudo_hs import PseudoHS as JPHS
from mdtpu_torch.ops import cell_sweep as sweep_mod
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from tests.test_torch_driver import one_torch_thread  # noqa: F401

N, RHO, CUTOFF, SKIN = 500, 0.6, 1.5, 0.3
CASES = {
    "lj_force_shift": (JLJ(r_cut=1.5, force_shift=True),
                       LennardJones(r_cut=1.5, force_shift=True), 0.0),
    "pseudo_hs": (JPHS(), PseudoHS(), 0.0),
    "lj_polydisperse": (JLJ(r_cut=1.5), LennardJones(r_cut=1.5), 0.2),
}


def _system(seed, lattice, poly, dtype):
    rng = np.random.default_rng(seed)
    L = (N / RHO) ** (1.0 / 3.0)
    if lattice:
        per = int(np.ceil(N ** (1 / 3)))
        idx = np.indices((per,) * 3).reshape(3, -1).T[:N]
        pos = (idx + 0.5) / per * L + 0.15 * rng.normal(size=(N, 3))
        pos = np.mod(pos, L)
    else:
        pos = rng.uniform(size=(N, 3)) * L
    diam = 1.0 + poly * rng.uniform(-1.0, 1.0, N)
    cell = np.eye(3) * L
    return (pos.astype(dtype), diam.astype(dtype), cell.astype(dtype),
            np.linalg.inv(cell).astype(dtype))


def _port_compute(pot, arrays, positions=None, engine=None):
    pos, diam, cell, cinv = (torch.from_numpy(a) for a in arrays)
    eng = engine or CellGridEngine.create(pot, CUTOFF, SKIN, cell, N)
    nb = eng.allocate(pos, diam, cell, cinv)
    assert not bool(nb.overflow)
    if positions is not None:
        pos = torch.from_numpy(positions)
    e, w, f, _ = eng.compute(pos, diam, cell, cinv, nb)
    return float(e), float(w), f.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_cell_sweep_matches_jax_f64(case):
    jpot, tpot, poly = CASES[case]
    arrays = _system(21, False, poly, np.float64)
    pos, diam, cell, cinv = (jnp.asarray(a) for a in arrays)

    ref = JCellGrid.create(jpot, CUTOFF, SKIN, arrays[2], N)
    nb = ref.allocate(pos, diam, cell, cinv)
    e0, w0, f0, _ = ref.compute(pos, diam, cell, cinv, nb)
    e1, w1, f1 = _port_compute(tpot, arrays)
    np.testing.assert_allclose(e1, float(e0), rtol=1e-12)
    np.testing.assert_allclose(w1, float(w0), rtol=1e-12)
    np.testing.assert_allclose(f1, np.asarray(f0), rtol=1e-10, atol=1e-12)

    pe = PallasCellEngine.create(jpot, CUTOFF, SKIN, arrays[2], N,
                                 interpret=True)
    e2, w2, f2, _ = pe.compute(pos, diam, cell, cinv, nb)
    np.testing.assert_allclose(e1, float(e2), rtol=1e-12)
    np.testing.assert_allclose(w1, float(w2), rtol=1e-12)
    np.testing.assert_allclose(f1, np.asarray(f2), rtol=1e-10, atol=1e-12)

    # Positions moved (and wrapped across the box) since the binning: slot
    # coordinates are ref + MIC(pos - ref), so the +-L image shifts stay
    # right.
    rng = np.random.default_rng(5)
    moved = np.mod(arrays[0] + rng.uniform(-0.07, 0.07, arrays[0].shape),
                   arrays[2][0, 0])
    e0, w0, f0, _ = ref.compute(jnp.asarray(moved), diam, cell, cinv, nb)
    e1, w1, f1 = _port_compute(tpot, arrays, positions=moved)
    np.testing.assert_allclose(e1, float(e0), rtol=1e-12)
    np.testing.assert_allclose(w1, float(w0), rtol=1e-12)
    np.testing.assert_allclose(f1, np.asarray(f0), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cell_sweep_f32_matches_naive_oracle(case):
    jpot, tpot, poly = CASES[case]
    arrays = _system(21, True, poly, np.float32)
    e1, w1, f1 = _port_compute(tpot, arrays)
    e0, w0, f0, _ = JNaive(potential=jpot, cutoff=CUTOFF).compute(
        *(jnp.asarray(a.astype(np.float64)) for a in arrays[:3]),
        jnp.linalg.inv(jnp.asarray(arrays[2].astype(np.float64))), ())
    np.testing.assert_allclose(e1, float(e0), rtol=2e-5)
    np.testing.assert_allclose(w1, float(w0), rtol=2e-5)
    scale = np.abs(np.asarray(f0)).max()
    np.testing.assert_allclose(f1 / scale, np.asarray(f0) / scale, atol=5e-6)


def test_allocate_flags_overflow():
    pos, diam, cell, cinv = (torch.from_numpy(a) for a in
                             _system(3, False, 0.0, np.float64))
    eng = CellGridEngine.create(LennardJones(r_cut=1.5), CUTOFF, SKIN, cell, N)
    assert not bool(eng.allocate(pos, diam, cell, cinv).overflow)
    tight = CellGridEngine.create(LennardJones(r_cut=1.5), CUTOFF, SKIN, cell,
                                  N, cell_capacity=2)
    nb = tight.allocate(pos, diam, cell, cinv)
    assert bool(nb.overflow)
    # Overflowing particles sit in the trash slot and get no forces.
    _, _, f, _ = tight.compute(pos, diam, cell, cinv, nb)
    trash = nb.addr == tight.n_cells * tight.cell_capacity
    assert bool(trash.any()) and bool(torch.all(f[trash] == 0))
    assert tight.with_grown_capacity().cell_capacity == int(2 * 1.4 + 4)


def test_cpu_wrapper_takes_the_plain_version():
    pos, diam, cell, cinv = (torch.from_numpy(a) for a in
                             _system(4, True, 0.1, np.float64))
    pot = LennardJones(r_cut=1.5, shift=True)
    eng = CellGridEngine.create(pot, CUTOFF, SKIN, cell, N)
    nb = eng.allocate(pos, diam, cell, cinv)
    inputs = eng.slot_inputs(pos, cell, cinv, nb)
    before = sweep_mod.cell_sweep.launches
    got = sweep_mod.cell_sweep(*inputs, eng.grid, eng.cutoff, pot)
    want = sweep_mod.cell_sweep_plain(*inputs, eng.grid, eng.cutoff, pot)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert sweep_mod.cell_sweep.launches == before
    with pytest.raises(ValueError):
        sweep_mod.cell_sweep(*inputs, (2, 5, 5), eng.cutoff, pot)
    # A potential without a functor takes the pair-list route, by type.
    assert sweep_mod.kernel_params(object()) is None
    with pytest.raises(ValueError, match="pair list"):
        sweep_mod.functor_params(object())


@pytest.mark.parametrize("route", ["cell_sweep", "cell_sweep_hilo",
                                   "compute_slots"])
def test_scalar_outputs_on_the_plain_route(route):
    """Energy and virial written into given 0-d tensors (the slot advance's
    buffers; on the card the kernel's last block sums them there): the
    tensors themselves come back, holding the bits of a call without them;
    a lean sweep refuses them."""
    hilo = route == "cell_sweep_hilo"
    dtype = torch.float32 if hilo else torch.float64
    pos, diam, cell, cinv = (torch.from_numpy(a) for a in _system(
        6, True, 0.1, np.float32 if hilo else np.float64))
    pot = LennardJones(r_cut=1.5)
    eng = CellGridEngine.create(pot, CUTOFF, SKIN, cell, N)
    nb = eng.allocate(pos, diam, cell, cinv)
    slot_pos, slot_diam, counts, cell_m = eng.slot_inputs(pos, cell, cinv,
                                                          nb)
    lo = torch.zeros_like(slot_pos)
    scalars = (torch.full((), 7.0, dtype=dtype),
               torch.full((), 7.0, dtype=dtype))
    if route == "compute_slots":
        def run(**kw):
            e, w, f, _ = eng.compute_slots(slot_pos, slot_diam, cell_m, cinv,
                                           nb, **kw)
            return e, w, f
    else:
        args = (((slot_pos, lo) if hilo else (slot_pos,))
                + (slot_diam, counts, cell_m, eng.grid, eng.cutoff, pot))
        fn = getattr(sweep_mod, route)

        def run(**kw):
            return fn(*args, **kw)
    want = run()
    got = run(scalars_out=scalars)
    assert got[0] is scalars[0] and got[1] is scalars[1]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert float(want[0]) != 0.0 and float(want[1]) != 0.0
    if route != "compute_slots":
        with pytest.raises(ValueError, match="lean"):
            run(observables=False, scalars_out=scalars)
