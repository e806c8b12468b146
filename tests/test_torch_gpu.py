"""The CUDA kernels against their plain PyTorch versions on the card: the
pair sweep (full stencil, and its hi/lo variant), the Newton half-stencil
sweep at f64 and f32 for the three potentials the kernels know, the probe of
its inner loop, and a short run through ``PlaneEngine``.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one. On a machine with a card (the JAX package need not be
installed there):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

import mdtpu_torch
from mdtpu_torch.ops import cell_sweep as sweep_mod
from mdtpu_torch.ops import plane_sweep as plane_mod
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.experimental import PlaneEngine
from mdtpu_torch.ops.experimental import probe as probe_mod
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from mdtpu_torch.potentials.xplor import LennardJonesXPLOR
from mdtpu_torch.sim.initialization import lattice_fluid_state

pytestmark = pytest.mark.gpu

POTENTIALS = {
    "lj": (LennardJones(r_cut=2.5, force_shift=True), 2.5, 0.8),
    "pseudo_hs": (PseudoHS(), 1.5, 0.76),
    "xplor": (LennardJonesXPLOR(r_on=2.0, r_cut=2.5), 2.5, 0.8),
}
# f64: the two sum in different orders; f32 additionally rounds each pair.
TOLERANCES = {torch.float64: (1e-12, 1e-10), torch.float32: (1e-5, 1e-5)}
# Lattice jitter in standard normals of the spacing: small enough that no
# pair comes much closer than 0.9 sigma, so no single r^-50 (pseudo-hard
# sphere) or r^-12 force dwarfs the rest.
JITTER = 0.03


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(POTENTIALS))
def test_kernel_matches_plain(cuda, name, dtype):
    pot, cutoff, rho = POTENTIALS[name]
    n = 20000
    state = lattice_fluid_state(n, rho, 1.0, dtype=dtype, cutoff=cutoff,
                                jitter=JITTER, device=cuda)
    diam = (1.0 + 0.1 * torch.rand(n, generator=torch.Generator().manual_seed(0),
                                   dtype=dtype)).to(cuda)
    eng = CellGridEngine.create(pot, cutoff, 0.3, state.unitcell, n,
                                diameters=diam)
    nb = eng.allocate(state.positions, diam, state.unitcell,
                      state.unitcell_inv)
    assert not bool(nb.overflow)
    inputs = eng.slot_inputs(state.positions, state.unitcell,
                             state.unitcell_inv, nb)
    before = sweep_mod.cell_sweep.launches
    e1, w1, f1 = sweep_mod.cell_sweep(*inputs, eng.grid, eng.cutoff, pot)
    torch.cuda.synchronize()
    assert sweep_mod.cell_sweep.launches == before + 1
    e0, w0, f0 = sweep_mod.cell_sweep_plain(*inputs, eng.grid, eng.cutoff,
                                            pot)
    rtol_ew, tol_f = TOLERANCES[dtype]
    np.testing.assert_allclose(float(e1), float(e0), rtol=rtol_ew)
    np.testing.assert_allclose(float(w1), float(w0), rtol=rtol_ew)
    # Each particle is held to its own force, or to the RMS force where its
    # own is smaller (a nearly balanced particle).
    err = (f1 - f0).norm(dim=0)
    mag = f0.norm(dim=0)
    rms = torch.sqrt((mag * mag).sum() / n)
    assert float((err / mag.clamp(min=rms)).max()) <= tol_f


def test_unknown_potential_raises_on_cuda(cuda):
    class Custom(LennardJones):
        pass

    state = lattice_fluid_state(2000, 0.8, 1.0, cutoff=2.5, device=cuda)
    eng = CellGridEngine.create(Custom(), 2.5, 0.3, state.unitcell, 2000)
    nb = eng.allocate(state.positions, state.diameters, state.unitcell,
                      state.unitcell_inv)
    with pytest.raises(NotImplementedError):
        eng.compute(state.positions, state.diameters, state.unitcell,
                    state.unitcell_inv, nb)


def _force_ratio(f1, f0, n):
    err = (f1.double() - f0.double()).norm(dim=0)
    mag = f0.double().norm(dim=0)
    rms = torch.sqrt((mag * mag).sum() / n)
    return float((err / mag.clamp(min=rms)).max())


def _inputs(cuda, name, dtype, n=20000):
    pot, cutoff, rho = POTENTIALS[name]
    state = lattice_fluid_state(n, rho, 1.0, dtype=dtype, cutoff=cutoff,
                                jitter=JITTER, device=cuda)
    eng = CellGridEngine.create(pot, cutoff, 0.3, state.unitcell, n)
    nb = eng.allocate(state.positions, state.diameters, state.unitcell,
                      state.unitcell_inv)
    assert not bool(nb.overflow)
    return state, eng, nb


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(POTENTIALS))
def test_plane_sweep_matches_plain_and_full_stencil(cuda, name, dtype):
    state, eng, nb = _inputs(cuda, name, dtype)
    n = state.n_particles
    inputs = eng.slot_inputs(state.positions, state.unitcell,
                             state.unitcell_inv, nb)
    args = (*inputs, eng.grid, eng.cutoff, eng.potential)
    before = plane_mod.plane_sweep.launches
    e1, w1, f1 = plane_mod.plane_sweep(*args)
    again = plane_mod.plane_sweep(*args)
    torch.cuda.synchronize()
    assert plane_mod.plane_sweep.launches == before + 2
    # Fixed summation order: a second launch repeats bit for bit.
    assert all(torch.equal(a, b) for a, b in zip((e1, w1, f1), again))
    e0, w0, f0 = plane_mod.plane_sweep_plain(*args)
    rtol_ew, tol_f = TOLERANCES[dtype]
    np.testing.assert_allclose(float(e1), float(e0), rtol=rtol_ew)
    np.testing.assert_allclose(float(w1), float(w0), rtol=rtol_ew)
    assert _force_ratio(f1, f0, n) <= tol_f
    if dtype == torch.float64:
        # Same function as the full stencil; at f32 a pair crossing the box
        # edge rounds its displacement differently from its two sides, so
        # there the two are compared in chip_smoke.py against f64.
        e2, w2, f2 = sweep_mod.cell_sweep(*args)
        np.testing.assert_allclose(float(e1), float(e2), rtol=1e-12)
        np.testing.assert_allclose(float(w1), float(w2), rtol=1e-12)
        assert _force_ratio(f1, f2, n) <= 1e-10


def test_plane_sweep_capacity_limit(cuda):
    """The shared-memory tile takes the bench capacity grown twice (37 -> 55
    -> 81) at f64; a capacity whose tile does not fit raises and is not
    counted as a launch."""
    n = 4000
    state = lattice_fluid_state(n, 0.8, 1.0, dtype=torch.float64, cutoff=2.5,
                                jitter=JITTER, device=cuda)
    for cap, fits in ((81, True), (200, False)):
        eng = PlaneEngine.create(LennardJones(r_cut=2.5), 2.5, 0.3,
                                 state.unitcell, n, cell_capacity=cap)
        nb = eng.allocate(state.positions, state.diameters, state.unitcell,
                          state.unitcell_inv)
        inputs = eng.slot_inputs(state.positions, state.unitcell,
                                 state.unitcell_inv, nb)
        args = (*inputs, eng.grid, eng.cutoff, eng.potential)
        before = plane_mod.plane_sweep.launches
        if not fits:
            with pytest.raises(RuntimeError):
                plane_mod.plane_sweep(*args)
            assert plane_mod.plane_sweep.launches == before
            continue
        e1, w1, f1 = plane_mod.plane_sweep(*args)
        torch.cuda.synchronize()
        assert plane_mod.plane_sweep.launches == before + 1
        e0, w0, f0 = plane_mod.plane_sweep_plain(*args)
        np.testing.assert_allclose(float(e1), float(e0), rtol=1e-12)
        np.testing.assert_allclose(float(w1), float(w0), rtol=1e-12)
        assert _force_ratio(f1, f0, n) <= 1e-10


@pytest.mark.parametrize("name", sorted(POTENTIALS))
def test_cell_sweep_hilo_matches_plain(cuda, name):
    state, eng, nb = _inputs(cuda, name, torch.float64)
    n = state.n_particles
    # hi/lo words of the f64 positions.
    hi = state.positions.float()
    lo = (state.positions - hi.double()).float()
    cell, cinv = state.unitcell.float(), state.unitcell_inv.float()
    eng32 = CellGridEngine.create(eng.potential, eng.cutoff, 0.3, cell, n)
    nb32 = eng32.allocate(hi, state.diameters.float(), cell, cinv)
    inputs = eng32.slot_inputs_hilo(hi, lo, cell, cinv, nb32)
    args = (eng32.grid, eng32.cutoff, eng32.potential)
    before = sweep_mod.cell_sweep_hilo.launches
    e1, w1, f1 = sweep_mod.cell_sweep_hilo(*inputs, *args)
    torch.cuda.synchronize()
    assert sweep_mod.cell_sweep_hilo.launches == before + 1
    e0, w0, f0 = sweep_mod.cell_sweep_hilo_plain(*inputs, *args)
    np.testing.assert_allclose(float(e1), float(e0), rtol=1e-5)
    np.testing.assert_allclose(float(w1), float(w0), rtol=1e-5)
    assert _force_ratio(f1, f0, n) <= 1e-5
    slot_hi, slot_lo, diam, counts, box = inputs
    _, _, f64 = sweep_mod.cell_sweep_plain(
        slot_hi.double() + slot_lo.double(), diam.double(), counts,
        box.double(), *args)
    _, _, f_plain = sweep_mod.cell_sweep(slot_hi, diam, counts, box, *args)
    assert _force_ratio(f1, f64, n) * 5 < _force_ratio(f_plain, f64, n)


@pytest.mark.parametrize("spec", ["full", "full_static:15", "nodiv:5",
                                  "reduce_only"])
def test_plane_probe_matches_plain(cuda, spec):
    variant, chunk = probe_mod.parse_variant(spec)
    for scale in (40.0, 5.0):
        w = probe_mod.random_input(1, device=cuda) * (scale / 40.0)
        before = probe_mod.probe_sweep.launches
        fx1, e1 = probe_mod.probe_sweep(w, variant, chunk)
        torch.cuda.synchronize()
        assert probe_mod.probe_sweep.launches == before + 1
        fx0, e0 = probe_mod.probe_sweep_plain(w, variant, chunk)
        for got, want in ((fx1, fx0), (e1, e0)):
            got, want = got.cpu().numpy(), want.cpu().numpy()
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            fin = ~np.isnan(want)
            if fin.any():
                floor = 1e-5 * max(np.abs(want[fin]).max(), 1e-30)
                np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                           atol=floor)


def test_plane_engine_nvt_run(cuda, tmp_path):
    n, steps = 8000, 60
    state = lattice_fluid_state(n, 0.8, 1.0, cutoff=2.5, device=cuda)
    params = mdtpu_torch.Parameters(0.8, n, 0.002,
                                    mdtpu_torch.LennardJones(r_cut=2.5))
    engine = PlaneEngine.create(params.potential, 2.5, 0.3, state.unitcell, n)
    before = plane_mod.plane_sweep.launches
    out = mdtpu_torch.run_simulation(state, params, mdtpu_torch.NVT(1.0, 0.4),
                                     steps, 20, str(tmp_path),
                                     engine=engine, compensated=False)
    torch.cuda.synchronize()
    assert out.step == steps
    assert plane_mod.plane_sweep.launches - before >= steps
    rows = np.loadtxt(tmp_path / "thermo.txt")
    assert rows.shape == (3, 4) and np.isfinite(rows).all()
    assert bool(torch.isfinite(out.positions).all())
