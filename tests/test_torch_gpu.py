"""The CUDA kernels against their plain PyTorch versions on the card: the
pair sweep (full stencil, and its hi/lo variant), the Newton half-stencil
sweep at f64 and f32 for the three potentials the kernels know, the probe of
its inner loop, and a short run through ``PlaneEngine``. The slot-space
loop's kernels: the lean variants of the full-stencil sweep bit-equal to the
full ones, the packer's ``Overlap`` functor, ``compute_slots`` on resorted
slots, and the slot advance on the card against the CPU. The full-stencil
sweep also on slot inputs made by hand: every class of capacity (one warp,
several, a staging plan of fewer than 27 cells), a grid that is not cubic,
empty and full cells, counts above the capacity, a cluster in which every
candidate is a hit, every flag of the potentials; and two launches repeat
bit for bit. The half-stencil sweep on the same hand-made inputs, its
reaction buffer filled with NaN beforehand, and its capacity limit; the
probe at chunks that do and do not divide its rows. 2D and tilted boxes:
the full-stencil sweep (f64, f32, hi/lo; lean) on hand-made slots in a 2D,
a tilted 2D and a tilted 3D box, 2D neighbourhoods staged in parts; the
pair list and its reduction against their plain versions (the same entries
in the same order, bit for bit), its overflow, and a run with a user
potential on the card against the same run on the CPU. The RDF histogram
kernel against its plain version (3D, tilted 3D, tilted 2D, rotated 3D
and 2D; f64 and f32; positions displaced by box vectors; the cell route
at r_max 3 and the tile route at half the width, each asserted, and the
tile route forced at r_max 3; two launches alike), the full reduction in
one launch, and 200 steps from a state and from its checkpoint, bit for
bit. The neighbour list: its build (rows as sets, counts, the
overflow flag of small capacities, two launches alike; its rows bit for bit
the stencil-order plain build's in 2D and 3D, with and without the cells'
order and starts, under overflow and with the stencil staged in parts) and
its force pass (f64 and f32, three potentials; two launches bit for bit;
rows in cell order against particle order; against the full-stencil sweep
on the same state) against their plain versions, and a run on the list on
the card against the same run on the CPU. The slab
launch of the sharded engine (B1 over the interior cells of a ghost-extended
grid): against its plain version and the periodic launch (f64, f32, hi/lo),
lean bit-equal and repeats, a run of cells outside the grid refused, and
``run_simulation_sharded`` on a ring of one on the card against the CPU.
The pair list's slab launch (a user potential on the sharded engine):
against its plain version and the periodic list (the same pairs, the
forces, energy and virial bit for bit), the list's buffers kept across calls
(padded as a fresh list, also under CUDA-graph replay and at a grown
capacity), and a sharded run with the user potential on the card against
the CPU.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one. On a machine with a card (the JAX package need not be
installed there):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

import mdtpu_torch
from mdtpu_torch.ops import cell_pairs as pairs_mod
from mdtpu_torch.ops import cell_sweep as sweep_mod
from mdtpu_torch.ops import plane_sweep as plane_mod
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.experimental import PlaneEngine
from mdtpu_torch.ops.experimental import probe as probe_mod
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from mdtpu_torch.potentials.xplor import LennardJonesXPLOR
from mdtpu_torch.sim.initialization import lattice_fluid_state
from mdtpu_torch.utils.math import ipow

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
    """The sweep kernels have no functor for a user's class (even one
    derived from a built-in): their wrappers raise ``ValueError``, and the
    engine takes the pair-list route instead, with the CPU's result."""
    class Custom(LennardJones):
        pass

    state = lattice_fluid_state(2000, 0.8, 1.0, dtype=torch.float64,
                                cutoff=2.5, device=cuda)
    eng = CellGridEngine.create(Custom(), 2.5, 0.3, state.unitcell, 2000)
    assert eng.uses_pair_list
    nb = eng.allocate(state.positions, state.diameters, state.unitcell,
                      state.unitcell_inv)
    inputs = eng.slot_inputs(state.positions, state.unitcell,
                             state.unitcell_inv, nb)
    with pytest.raises(ValueError, match="pair list"):
        sweep_mod.cell_sweep(*inputs, eng.grid, eng.cutoff, eng.potential)
    before = pairs_mod.pair_list.launches
    e1, w1, f1, _ = eng.compute(state.positions, state.diameters,
                                state.unitcell, state.unitcell_inv, nb)
    assert pairs_mod.pair_list.launches == before + 1
    e0, w0, f0 = sweep_mod.cell_sweep_plain(*inputs, eng.grid, eng.cutoff,
                                            LennardJones())
    np.testing.assert_allclose(float(e1), float(e0), rtol=1e-12)
    np.testing.assert_allclose(float(w1), float(w0), rtol=1e-12)


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
    """The staging plan takes the bench capacity grown twice (37 -> 55 -> 81)
    at f64 and capacities far beyond (200); the first capacity whose plan
    does not fit in a block's shared memory raises and is not counted as a
    launch."""
    n = 4000
    state = lattice_fluid_state(n, 0.8, 1.0, dtype=torch.float64, cutoff=2.5,
                                jitter=JITTER, device=cuda)
    limit = sweep_mod.MAX_SHARED_BYTES
    refused = next(c for c in range(1, sweep_mod.MAX_CAPACITY + 1)
                   if plane_mod.plane_stage_plan(c, torch.float64)[2] > limit)
    assert refused > 200
    for cap, fits in ((81, True), (200, True), (refused, False)):
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


@pytest.mark.parametrize("spec", [
    "full", "full:15", "full:5", "full:40", "full_static:15", "nodiv:5",
    "nodiv:40", "reduce_only", "reduce_only:15", "reduce_only:40"])
def test_plane_probe_matches_plain(cuda, spec):
    """Every variant, at chunks that divide the 225 rows (45, 15, 5) and one
    that does not (40: rows 200.. are not swept and keep fx = 0); two
    launches repeat bit for bit."""
    variant, chunk = probe_mod.parse_variant(spec)
    for scale in (40.0, 5.0):
        w = probe_mod.random_input(1, device=cuda) * (scale / 40.0)
        before = probe_mod.probe_sweep.launches
        fx1, e1 = probe_mod.probe_sweep(w, variant, chunk)
        again = probe_mod.probe_sweep(w, variant, chunk)
        torch.cuda.synchronize()
        assert probe_mod.probe_sweep.launches == before + 2
        for a, b in zip((fx1, e1), again):
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
        swept = probe_mod.ROWS // chunk * chunk
        assert not bool(fx1[:, swept:].any())
        fx0, e0 = probe_mod.probe_sweep_plain(w, variant, chunk)
        for got, want in ((fx1, fx0), (e1, e0)):
            got, want = got.cpu().numpy(), want.cpu().numpy()
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            fin = ~np.isnan(want)
            if fin.any():
                floor = 1e-5 * max(np.abs(want[fin]).max(), 1e-30)
                np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                           atol=floor)


def test_plane_probe_fx_does_not_depend_on_the_chunk(cuda):
    """The launch no longer follows the chunk: fx of the rows that two
    chunks both sweep is the same bits."""
    w = probe_mod.random_input(2, device=cuda) * (5.0 / 40.0)
    fx45, _ = probe_mod.probe_sweep(w, "nodiv", 45)
    for chunk in (5, 15, 40):
        fx, _ = probe_mod.probe_sweep(w, "nodiv", chunk)
        swept = probe_mod.ROWS // chunk * chunk
        assert torch.equal(fx[:, :swept], fx45[:, :swept])


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


# --------------------------------------------------------------------------
# The full-stencil sweep on slot inputs made by hand.
# --------------------------------------------------------------------------

VACANT = 777.0   # what vacant slots hold: the sweeps must never read it


def _sublattice_slots(grid, cap, counts, cutoff, seed, device,
                      diam_spread=0.0):
    """f64 slot inputs ``(slot_pos, slot_diam, counts, box)``: cell ``c``
    holds ``min(counts[c], cap)`` particles on randomly chosen sites of its
    own m^3 sublattice (m^3 >= cap, spacing >= 1), jittered so that no pair
    comes much closer than 0.9."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = grid
    n_cells = nx * ny * nz
    m = 1
    while m ** 3 < cap:
        m += 1
    edge = max(cutoff + 0.05, float(m))
    jitter = JITTER if m > 1 else 0.1
    idx = np.arange(n_cells)
    corner = np.stack([idx // (ny * nz), (idx // nz) % ny, idx % nz]) * edge
    pos = np.full((3, n_cells, cap), VACANT)
    for c in range(n_cells):
        n = min(int(counts[c]), cap)
        sites = rng.permutation(m ** 3)[:n]
        ijk = np.stack([sites // (m * m), (sites // m) % m, sites % m])
        pos[:, c, :n] = corner[:, c, None] + (
            ijk + 0.5 + jitter * rng.standard_normal((3, n))) * (edge / m)
    diam = 1.0 + diam_spread * rng.random(n_cells * cap)
    box = np.array(grid, dtype=np.float64) * edge
    return tuple(torch.as_tensor(a, device=device) for a in (
        pos.reshape(3, -1), diam, np.asarray(counts, dtype=np.int64), box))


def _mixed_counts(n_cells, cap, seed):
    """Random counts with an empty cell, a full one and one above ``cap``."""
    counts = np.random.default_rng(seed).integers(0, cap + 1, n_cells)
    counts[:3] = (cap, 0, cap + 5)
    return counts


def _check_full_stencil(kind, slots, grid, cutoff, pot):
    """Kernel against plain version for ``kind`` in f64 / f32 / hilo, and a
    second launch against the first, bit for bit."""
    pos, diam, counts, box = slots
    if kind == "hilo":
        hi = pos.float()
        args = (hi, (pos - hi.double()).float(), diam.float(), counts,
                box.float(), grid, cutoff, pot)
        kernel, plain = sweep_mod.cell_sweep_hilo, sweep_mod.cell_sweep_hilo_plain
    else:
        dtype = torch.float64 if kind == "f64" else torch.float32
        args = (pos.to(dtype), diam.to(dtype), counts, box.to(dtype), grid,
                cutoff, pot)
        kernel, plain = sweep_mod.cell_sweep, sweep_mod.cell_sweep_plain
    before = kernel.launches
    out = kernel(*args)
    again = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    ref = plain(*args)
    rtol_ew, tol_f = TOLERANCES[torch.float64 if kind == "f64"
                                else torch.float32]
    cap = pos.shape[1] // counts.shape[0]
    occupied = (torch.arange(cap, device=pos.device)[None, :]
                < counts.clamp(max=cap)[:, None]).reshape(-1)
    n = max(int(occupied.sum()), 1)
    # f32: the sums differ in order; hold them to the per-particle scale.
    atol = 0.0 if kind == "f64" else 1e-5 * n
    for got, want in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(float(got), float(want), rtol=rtol_ew,
                                   atol=atol)
    f1, f0 = out[2].double(), ref[2].double()
    assert bool((f1[:, ~occupied] == 0).all())
    err = (f1 - f0).norm(dim=0)
    mag = f0.norm(dim=0)
    rms = float(torch.sqrt((mag * mag).sum() / n))
    assert float((err / mag.clamp(min=max(rms, 1e-300))).max()) <= tol_f
    return out


@pytest.mark.parametrize("kind", ["f64", "f32", "hilo"])
@pytest.mark.parametrize("cap", [1, 31, 32, 33, 64, 65, 200, 1024])
def test_cell_sweep_capacities(cuda, cap, kind):
    """Blocks of one warp and of several, up to 1024 threads, where the 27
    cells no longer fit in one stage; with an empty cell, a full cell and a
    count above the capacity."""
    grid, cutoff = (3, 3, 3), 2.5
    dtype = torch.float64 if kind == "f64" else torch.float32
    counts = _mixed_counts(27, cap, cap)
    if cap == 1024:
        list_len, _, threads = sweep_mod.stage_plan(cap, dtype, kind == "hilo")
        assert threads == 1024
        # On a 3 x 3 x 3 grid every block's stencil is the whole grid.
        assert sweep_mod.stage_cells(list(np.minimum(counts, cap)),
                                     list_len) < 27
    slots = _sublattice_slots(grid, cap, counts, cutoff, cap, cuda)
    _check_full_stencil(kind, slots, grid, cutoff, LennardJones(r_cut=cutoff))


@pytest.mark.parametrize("kind", ["f64", "f32", "hilo"])
@pytest.mark.parametrize("cap,filled", [(33, 27), (33, 19)])
def test_cell_sweep_stages_in_parts(cuda, cap, filled, kind):
    """Neighbourhoods fuller than a stage's list go in three stages of 9
    cells: with every cell at its capacity, and with 19 full and 8 empty
    cells (stages of unequal length)."""
    grid, cutoff = (3, 3, 3), 2.5
    dtype = torch.float64 if kind == "f64" else torch.float32
    list_len = sweep_mod.stage_plan(cap, dtype, kind == "hilo")[0]
    counts = np.zeros(27, dtype=np.int64)
    counts[np.random.default_rng(filled).permutation(27)[:filled]] = cap
    assert sweep_mod.stage_cells(list(counts), list_len) < 27
    slots = _sublattice_slots(grid, cap, counts, cutoff, cap, cuda)
    _check_full_stencil(kind, slots, grid, cutoff, LennardJones(r_cut=cutoff))


FLAGGED = {
    "lj_shift": (LennardJones(r_cut=2.5, shift=True), 2.5, 0.0),
    "lj_force_shift": (LennardJones(r_cut=2.5, force_shift=True), 2.5, 0.0),
    "lj_no_mixing": (LennardJones(sigma=0.9, r_cut=2.5, force_shift=True,
                                  mixing="none"), 2.5, 0.2),
    "lj_polydisperse": (LennardJones(r_cut=2.5, force_shift=True), 2.5, 0.2),
    "pseudo_hs_no_mixing": (PseudoHS(mixing="none"), 1.5, 0.2),
    "pseudo_hs_fixed_cutoff": (PseudoHS(sigma_scaled_cutoff=False), 1.5, 0.0),
    "pseudo_hs_polydisperse": (PseudoHS(), 1.5, 0.05),
    "xplor_no_mixing": (LennardJonesXPLOR(r_on=2.0, r_cut=2.5,
                                          mixing="none"), 2.5, 0.2),
    "xplor_polydisperse": (LennardJonesXPLOR(r_on=2.0, r_cut=2.5), 2.5, 0.2),
}


@pytest.mark.parametrize("kind", ["f64", "f32", "hilo"])
@pytest.mark.parametrize("name", sorted(FLAGGED))
def test_cell_sweep_flags_on_a_noncubic_grid(cuda, name, kind):
    """Every flag of the three potentials, with equal and with mixed
    diameters (the per-thread set-up and the per-pair route), on a 3 x 4 x 5
    grid with empty cells."""
    pot, cutoff, diam_spread = FLAGGED[name]
    grid, cap = (3, 4, 5), 20
    slots = _sublattice_slots(grid, cap, _mixed_counts(60, cap, 7), cutoff,
                              11, cuda, diam_spread=diam_spread)
    _check_full_stencil(kind, slots, grid, cutoff, pot)


def _cluster_slots(device):
    """512 particles within one cutoff of each other around a corner shared
    by 8 cells of a 4 x 4 x 4 grid (64 in each, the capacity), the other 56
    cells empty. Returns ``(slots, grid, cutoff, potential)``."""
    grid, cap, cutoff, edge, spacing = (4, 4, 4), 64, 6.0, 6.3, 0.4
    rng = np.random.default_rng(3)
    ijk = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij")
                   ).reshape(3, -1)
    points = (2 * edge + (ijk - 3.5 + JITTER * rng.standard_normal(ijk.shape))
              * spacing)
    far = np.linalg.norm(points[:, :, None] - points[:, None, :], axis=0).max()
    assert far < cutoff
    cid = np.floor(points / edge).astype(int)
    cid = (cid[0] * 4 + cid[1]) * 4 + cid[2]
    pos = np.full((3, 64, cap), VACANT)
    counts = np.zeros(64, dtype=np.int64)
    for p, c in zip(points.T, cid):
        pos[:, c, counts[c]] = p
        counts[c] += 1
    assert counts.max() == cap and (counts > 0).sum() == 8
    slots = tuple(torch.as_tensor(a, device=device) for a in (
        pos.reshape(3, -1), np.ones(64 * cap), counts,
        np.full(3, 4 * edge)))
    pot = LennardJones(sigma=0.35, r_cut=cutoff, force_shift=True,
                       mixing="none")
    return slots, grid, cutoff, pot


@pytest.mark.parametrize("kind", ["f64", "f32", "hilo"])
def test_cell_sweep_cluster_every_candidate_hits(cuda, kind):
    """Every candidate of every own slot of the cluster is a hit, so each
    thread's queue fills and drains many times."""
    slots, grid, cutoff, pot = _cluster_slots(cuda)
    _check_full_stencil(kind, slots, grid, cutoff, pot)


@pytest.mark.parametrize("kind", ["f64", "f32", "hilo"])
@pytest.mark.parametrize("name", ["lj", "pseudo_hs"])
def test_cell_sweep_repeats_bit_for_bit(cuda, name, kind):
    """Two launches on the same engine inputs give the same bits: forces,
    energy and virial."""
    state, eng, nb = _inputs(cuda, name, torch.float64)
    slots = eng.slot_inputs(state.positions, state.unitcell,
                            state.unitcell_inv, nb)
    _check_full_stencil(kind, slots, eng.grid, eng.cutoff, eng.potential)


# --------------------------------------------------------------------------
# The half-stencil sweep on slot inputs made by hand.
# --------------------------------------------------------------------------

def _check_half_stencil(kind, slots, grid, cutoff, pot, monkeypatch=None):
    """``plane_sweep`` against its plain version at f64 / f32; a second
    launch against the first, bit for bit; vacant slots get zero force. With
    ``monkeypatch`` the reaction buffer starts as NaN: the fold-back must
    read nothing the sweep did not write."""
    pos, diam, counts, box = slots
    dtype = torch.float64 if kind == "f64" else torch.float32
    args = (pos.to(dtype), diam.to(dtype), counts, box.to(dtype), grid,
            cutoff, pot)
    kernel = plane_mod.plane_sweep
    before = kernel.launches
    out = kernel(*args)
    if monkeypatch is not None:
        monkeypatch.setattr(
            plane_mod, "_react_buffer",
            lambda n_slots, dt, dev: torch.full((12, 3, n_slots),
                                                float("nan"), dtype=dt,
                                                device=dev))
    again = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    ref = plane_mod.plane_sweep_plain(*args)
    rtol_ew, tol_f = TOLERANCES[dtype]
    cap = pos.shape[1] // counts.shape[0]
    occupied = (torch.arange(cap, device=pos.device)[None, :]
                < counts.clamp(max=cap)[:, None]).reshape(-1)
    n = max(int(occupied.sum()), 1)
    atol = 0.0 if kind == "f64" else 1e-5 * n
    for got, want in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(float(got), float(want), rtol=rtol_ew,
                                   atol=atol)
    f1, f0 = out[2].double(), ref[2].double()
    assert bool(torch.isfinite(f1).all())
    assert bool((f1[:, ~occupied] == 0).all())
    err = (f1 - f0).norm(dim=0)
    mag = f0.norm(dim=0)
    rms = float(torch.sqrt((mag * mag).sum() / n))
    assert float((err / mag.clamp(min=max(rms, 1e-300))).max()) <= tol_f


@pytest.mark.parametrize("cap,kind", [
    (c, k) for c in (1, 31, 32, 33, 64, 65) for k in ("f64", "f32")
] + [(97, "f64"), (137, "f32")])
def test_plane_sweep_capacities(cuda, cap, kind):
    """Blocks of one warp and of several, masks of one word and of several,
    up to the largest capacities the first design's tile took (97 at f64,
    137 at f32); with an empty cell, a full cell and a count above the
    capacity. A 3 x 3 x 3 grid: every pair once on 3-cell axes."""
    grid, cutoff = (3, 3, 3), 2.5
    slots = _sublattice_slots(grid, cap, _mixed_counts(27, cap, cap), cutoff,
                              cap, cuda)
    _check_half_stencil(kind, slots, grid, cutoff, LennardJones(r_cut=cutoff))


def _list_counts(counts, grid, cell, cap):
    """The clamped counts of the 15 list cells around ``cell``."""
    nx, ny, nz = grid
    home = (cell // (ny * nz), (cell // nz) % ny, cell % nz)
    out = []
    for off in plane_mod.LIST_CELLS:
        j = [(h + o) % n for h, o, n in zip(home, off, grid)]
        out.append(min(int(counts[(j[0] * ny + j[1]) * nz + j[2]]), cap))
    return out


@pytest.mark.parametrize("kind", ["f64", "f32"])
@pytest.mark.parametrize("cap,filled,cells", [(33, 27, 3), (33, 19, 3),
                                              (600, 27, 1)])
def test_plane_sweep_stages_in_parts(cuda, cap, filled, cells, kind):
    """Neighbourhoods fuller than a stage's list go in five stages of 3
    cells (every cell at its capacity; 19 full and 8 empty cells), or cell
    by cell at a capacity whose list holds fewer than three cells."""
    grid, cutoff = (3, 3, 3), 2.5
    dtype = torch.float64 if kind == "f64" else torch.float32
    list_len, _, smem, _ = plane_mod.plane_stage_plan(cap, dtype)
    assert smem <= sweep_mod.MAX_SHARED_BYTES
    counts = np.zeros(27, dtype=np.int64)
    counts[np.random.default_rng(filled).permutation(27)[:filled]] = cap
    assert min(plane_mod.plane_stage_cells(
        _list_counts(counts, grid, c, cap), list_len)
        for c in range(27)) == cells
    slots = _sublattice_slots(grid, cap, counts, cutoff, cap, cuda)
    _check_half_stencil(kind, slots, grid, cutoff, LennardJones(r_cut=cutoff))


@pytest.mark.parametrize("kind", ["f64", "f32"])
@pytest.mark.parametrize("name", sorted(FLAGGED))
def test_plane_sweep_flags_on_a_noncubic_grid(cuda, name, kind, monkeypatch):
    """Every flag of the three potentials, with equal and with mixed
    diameters (the pair evaluated from the own side and again from the
    candidate's must give the same force), on a 3 x 4 x 5 grid with empty
    cells; the reaction buffer NaN before the second launch."""
    pot, cutoff, diam_spread = FLAGGED[name]
    grid, cap = (3, 4, 5), 20
    slots = _sublattice_slots(grid, cap, _mixed_counts(60, cap, 7), cutoff,
                              11, cuda, diam_spread=diam_spread)
    _check_half_stencil(kind, slots, grid, cutoff, pot, monkeypatch)


@pytest.mark.parametrize("kind", ["f64", "f32"])
def test_plane_sweep_cluster_every_candidate_hits(cuda, kind, monkeypatch):
    """Every candidate is a hit: every queue fills and drains many times and
    every mask bit of the occupied Newton cells is set."""
    slots, grid, cutoff, pot = _cluster_slots(cuda)
    _check_half_stencil(kind, slots, grid, cutoff, pot, monkeypatch)


@pytest.mark.parametrize("kind", ["f64", "f32"])
@pytest.mark.parametrize("name", ["lj", "pseudo_hs"])
def test_plane_sweep_repeats_bit_for_bit(cuda, name, kind, monkeypatch):
    """Two launches on the same engine inputs give the same bits, the second
    over a reaction buffer of NaN."""
    state, eng, nb = _inputs(cuda, name, torch.float64)
    slots = eng.slot_inputs(state.positions, state.unitcell,
                            state.unitcell_inv, nb)
    _check_half_stencil(kind, slots, eng.grid, eng.cutoff, eng.potential,
                        monkeypatch)


# --------------------------------------------------------------------------
# The slot-space loop's kernels: the lean variants, the Overlap functor,
# compute_slots on resorted slots, and the slot advance against the CPU.
# --------------------------------------------------------------------------


def _melted_slots(cuda, dtype, n=20000, steps=100):
    """A lattice melted by ``steps`` NVT steps on the card, in slot order
    after one rebin with crossings (f64 melt, cast)."""
    from mdtpu_torch.integrate import slot_step

    pot = LennardJones(r_cut=2.5)
    state = lattice_fluid_state(n, 0.8, 1.0, dtype=torch.float64,
                                cutoff=2.5, jitter=JITTER, device=cuda)
    params = mdtpu_torch.Parameters(0.8, n, 0.002, pot)
    eng = CellGridEngine.create(pot, 2.5, 0.3, state.unitcell, n)
    slots = slot_step.slot_forces(slot_step.slotify(state, eng), eng)
    slots = slot_step.make_slot_advance(params, mdtpu_torch.NVT(1.0, 0.4),
                                        eng)(slots, steps)
    slots = slot_step._rebin(slots, eng)
    assert not bool(slots.nbrs.overflow)
    cast = {name: getattr(slots, name).to(dtype)
            for name in ("positions", "diameters", "pos_comp", "unitcell")}
    return slots.replace(**cast), eng


@pytest.mark.parametrize("case", ["lattice", "melted"])
@pytest.mark.parametrize("kind", ["f64", "f32", "hilo"])
def test_lean_sweeps_are_bit_equal_to_full(cuda, kind, case):
    """The lean variant of both sweeps gives the full variant's forces bit
    for bit, zero energy and virial, and repeats bit for bit."""
    dtype = torch.float64 if kind == "f64" else torch.float32
    if case == "lattice":
        state, eng, nb = _inputs(cuda, "lj", torch.float64)
        slot_pos, slot_diam, counts, box = eng.slot_inputs(
            state.positions, state.unitcell, state.unitcell_inv, nb)
    else:
        slots, eng = _melted_slots(cuda, torch.float64)
        slot_pos, slot_diam, counts = (slots.positions, slots.diameters,
                                       slots.nbrs.counts)
        box = torch.diagonal(slots.unitcell).contiguous()
    pot = eng.potential
    hi = slot_pos.to(dtype)
    args = (slot_diam.to(dtype), counts, box.to(dtype), eng.grid, eng.cutoff,
            pot)
    if kind == "hilo":
        lo = (slot_pos - hi.double()).float()
        kernel, first = sweep_mod.cell_sweep_hilo, (hi, lo)
    else:
        kernel, first = sweep_mod.cell_sweep, (hi,)
    before = (kernel.launches, kernel.lean_launches)
    full = kernel(*first, *args)
    lean = kernel(*first, *args, observables=False)
    again = kernel(*first, *args, observables=False)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.lean_launches) == (before[0] + 3,
                                                       before[1] + 2)
    assert torch.equal(lean[2], full[2]) and torch.equal(again[2], lean[2])
    assert float(lean[0]) == float(lean[1]) == 0.0
    plain = (sweep_mod.cell_sweep_hilo_plain if kind == "hilo"
             else sweep_mod.cell_sweep_plain)(*first, *args,
                                              observables=False)
    tol = 1e-10 if kind == "f64" else 1e-5
    assert _force_ratio(lean[2], plain[2], int(counts.sum())) <= tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_overlap_functor_matches_plain(cuda, dtype):
    """The packer's potential in the kernel (uniform random positions at rho
    0.8, full of overlaps), both variants, against the plain version."""
    from mdtpu_torch.sim.pack import OverlapPotential

    n = 30000
    L = (n / 0.8) ** (1 / 3)
    g = torch.Generator().manual_seed(3)
    pos = (torch.rand((n, 3), generator=g, dtype=torch.float64) * L).to(
        dtype).to(cuda)
    cell = (torch.eye(3, dtype=torch.float64) * L).to(dtype).to(cuda)
    cinv = torch.linalg.inv(cell.double()).to(dtype)
    pot = OverlapPotential(tol=1.0)
    eng = CellGridEngine.create(pot, 1.0, 0.3, cell, n, cell_capacity=16)
    nb = eng.allocate(pos, torch.ones(n, dtype=dtype, device=cuda), cell,
                      cinv)
    assert not bool(nb.overflow)
    inputs = eng.slot_inputs(pos, cell, cinv, nb)
    args = (*inputs, eng.grid, eng.cutoff, pot)
    e1, w1, f1 = sweep_mod.cell_sweep(*args)
    _, _, f_lean = sweep_mod.cell_sweep(*args, observables=False)
    again = sweep_mod.cell_sweep(*args)
    torch.cuda.synchronize()
    e0, w0, f0 = sweep_mod.cell_sweep_plain(*args)
    rtol_ew, tol_f = TOLERANCES[dtype]
    assert float(e0) > 1000.0
    np.testing.assert_allclose(float(e1), float(e0), rtol=rtol_ew)
    np.testing.assert_allclose(float(w1), float(w0), rtol=rtol_ew)
    assert _force_ratio(f1, f0, n) <= tol_f
    assert torch.equal(f_lean, f1)
    assert all(torch.equal(a, b) for a, b in zip(again, (e1, w1, f1)))


@pytest.mark.parametrize("kind", ["f64", "f32", "hilo"])
def test_compute_slots_on_resorted_slots_matches_plain(cuda, kind):
    """compute_slots on a melted, rebinned slot state (deferred-wrap
    positions, some outside the box) against cell_sweep_plain on the same
    slots."""
    slots, eng = _melted_slots(cuda, torch.float64)
    from mdtpu_torch.integrate import slot_step

    # Drift again without a rebin: positions up to skin/2 off, some past
    # the box edge.
    params = mdtpu_torch.Parameters(0.8, 20000, 0.002, eng.potential)
    step = slot_step.make_slot_step(params, mdtpu_torch.NVE(), eng)
    for _ in range(3):
        slots = step(slots)
    assert not bool(slot_step.slot_needs_rebin(slots, eng))
    dtype = torch.float64 if kind == "f64" else torch.float32
    pos = slots.positions.to(dtype)
    lo = (slots.positions - pos.double()).float() if kind == "hilo" else None
    cell = slots.unitcell.to(dtype)
    e1, w1, f1, _ = eng.compute_slots(pos, slots.diameters.to(dtype), cell,
                                      cell, slots.nbrs, pos_lo=lo)
    box = torch.diagonal(cell).contiguous()
    common = (slots.diameters.to(dtype), slots.nbrs.counts, box, eng.grid,
              eng.cutoff, eng.potential)
    if kind == "hilo":
        e0, w0, f0 = sweep_mod.cell_sweep_hilo_plain(pos, lo, *common)
    else:
        e0, w0, f0 = sweep_mod.cell_sweep_plain(pos, *common)
    rtol_ew, tol_f = TOLERANCES[dtype]
    np.testing.assert_allclose(float(e1), float(e0), rtol=rtol_ew)
    np.testing.assert_allclose(float(w1), float(w0), rtol=rtol_ew)
    assert _force_ratio(f1, f0, 20000) <= tol_f
    assert float(f1[:, ~slots.nbrs.occupied].abs().max()) == 0.0


def test_slot_advance_on_the_card_matches_the_cpu(cuda):
    """make_slot_advance at N = 4096 f64 (LJ, small skin: several rebins),
    on the card and on the CPU from one state: energy, temperature and
    virial after every segment to rel 1e-10, positions to 1e-9."""
    from mdtpu_torch.integrate import slot_step

    n = 4096
    pot = LennardJones(r_cut=2.5)
    params = mdtpu_torch.Parameters(0.8, n, 0.002, pot)
    runs = {}
    for device in ("cpu", cuda):
        state = lattice_fluid_state(n, 0.8, 1.0, dtype=torch.float64,
                                    cutoff=2.5, jitter=JITTER, device=device)
        eng = CellGridEngine.create(pot, 2.5, 0.04, state.unitcell, n)
        slots = slot_step.slot_forces(slot_step.slotify(state, eng), eng)
        advance = slot_step.make_slot_advance(params, mdtpu_torch.NVE(), eng)
        rows = []
        for k in (1, 7, 7, 7):
            slots = advance(slots, k)
            rows.append([float(slots.energy), float(slots.temperature),
                         float(slots.virial)])
        runs[str(device)] = (rows, slot_step.unslotify_state(slots))
    (rows_c, cpu), (rows_g, gpu) = runs["cpu"], runs[str(cuda)]
    np.testing.assert_allclose(rows_g, rows_c, rtol=1e-10)
    np.testing.assert_allclose(gpu.positions.cpu().numpy(),
                               cpu.positions.numpy(), rtol=0, atol=1e-9)
    assert torch.equal(gpu.images.cpu(), cpu.images)


# --------------------------------------------------------------------------
# 2D and tilted boxes; the pair list.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NonAdditivePHS(mdtpu_torch.Potential):
    """The user potential of ``examples/03_polydisperse_2d.py`` written
    against the port's ``Potential``: non-additive cross diameters sigma_ij =
    0.5 (s_i + s_j)(1 - 0.2 |s_i - s_j|), an r^-12 repulsion energy- and
    force-shifted at 1.25 sigma_ij."""

    lam: int = 12

    def evaluate(self, r, sigma_i, sigma_j):
        sigma = 0.5 * (sigma_i + sigma_j) * (1.0 - 0.2 * torch.abs(
            sigma_i - sigma_j))
        cutoff = 1.25 * sigma
        inside = r < cutoff
        r_safe = torch.where(inside, r, torch.ones_like(r))
        sr = sigma / r_safe
        u_raw = ipow(sr, self.lam)
        f_raw = self.lam * u_raw / r_safe
        u_c = ipow(torch.tensor(1 / 1.25, dtype=r.dtype, device=r.device),
                   self.lam)
        f_c = self.lam * u_c / cutoff
        u = u_raw - u_c + (r_safe - cutoff) * f_c
        f = f_raw - f_c
        zero = torch.zeros_like(u)
        return torch.where(inside, u, zero), torch.where(inside, f, zero)


BOXES = {"2d": ((6, 5), 0.0), "2d_tilted": ((6, 5), 0.125),
         "3d_tilted": ((4, 3, 5), 0.125)}


def _slots_in_box(grid, cap, counts, cutoff, seed, device, tilt=0.0,
                  diam_spread=0.0):
    """f64 slot inputs ``(slot_pos, slot_diam, counts, cell)`` on a 2D or 3D
    grid: cell ``c`` holds ``min(counts[c], cap)`` particles on random sites
    of its own sublattice (m^d >= cap sites, spacing >= 1 in fractional
    units of the edge), jittered; the box's later columns lean by ``tilt``
    of their length along the earlier axes."""
    rng = np.random.default_rng(seed)
    dim = len(grid)
    n_cells = int(np.prod(grid))
    m = 1
    while m ** dim < cap:
        m += 1
    edge = max(cutoff + 0.05, float(m))
    lengths = np.array(grid, dtype=np.float64) * edge
    cell = np.diag(lengths)
    for a in range(1, dim):
        for k in range(a):
            cell[k, a] = tilt * lengths[a]
    idx = np.arange(n_cells)
    coords = np.stack(np.unravel_index(idx, grid))
    frac = np.full((dim, n_cells, cap), VACANT)
    for c in range(n_cells):
        n = min(int(counts[c]), cap)
        sites = np.stack(np.unravel_index(rng.permutation(m ** dim)[:n],
                                          (m,) * dim))
        frac[:, c, :n] = (coords[:, c, None] + (
            sites + 0.5 + 0.03 * rng.standard_normal((dim, n))) / m) \
            / np.array(grid)[:, None]
    pos = np.where(frac == VACANT, VACANT,
                   np.einsum("ka,acs->kcs", cell, frac))
    diam = 1.0 + diam_spread * rng.random(n_cells * cap)
    return tuple(torch.as_tensor(a, device=device) for a in (
        pos.reshape(dim, -1), diam, np.asarray(counts, dtype=np.int64), cell))


@pytest.mark.parametrize("kind", ["f64", "f32", "hilo"])
@pytest.mark.parametrize("cap", [5, 33])
@pytest.mark.parametrize("box", sorted(BOXES))
def test_cell_sweep_2d_and_tilted_boxes(cuda, box, cap, kind):
    """The full-stencil sweep in a 2D, a tilted 2D and a tilted 3D box, with
    an empty, a full and an overfull cell; its lean variant's forces the
    full variant's bits."""
    grid, tilt = BOXES[box]
    counts = _mixed_counts(int(np.prod(grid)), cap, cap + len(grid))
    slots = _slots_in_box(grid, cap, counts, 2.5, cap, cuda, tilt, 0.2)
    pot = LennardJones(r_cut=2.5, force_shift=True)
    full = _check_full_stencil(kind, slots, grid, 2.5, pot)
    pos, diam, counts_t, cell = slots
    if kind == "hilo":
        hi = pos.float()
        lean = sweep_mod.cell_sweep_hilo(
            hi, (pos - hi.double()).float(), diam.float(), counts_t,
            cell.float(), grid, 2.5, pot, observables=False)
    else:
        dtype = torch.float64 if kind == "f64" else torch.float32
        lean = sweep_mod.cell_sweep(pos.to(dtype), diam.to(dtype), counts_t,
                                    cell.to(dtype), grid, 2.5, pot,
                                    observables=False)
    assert torch.equal(lean[2], full[2])


@pytest.mark.parametrize("kind", ["f64", "f32", "hilo"])
def test_cell_sweep_2d_stages_in_parts(cuda, kind):
    """A 2D neighbourhood of full cells is longer than a stage's list: the
    kernel stages its 9 cells three at a time."""
    grid, cap = (4, 3), 33
    dtype = torch.float64 if kind == "f64" else torch.float32
    list_len = sweep_mod.stage_plan(cap, dtype, kind == "hilo", 2)[0]
    counts = np.full(12, cap, dtype=np.int64)
    assert sweep_mod.stage_cells([cap] * 9, list_len) == 3
    slots = _slots_in_box(grid, cap, counts, 2.5, 3, cuda, 0.125)
    _check_full_stencil(kind, slots, grid, 2.5, LennardJones(r_cut=2.5))


def _list_entries(plist):
    total = int(plist.total)
    return [getattr(plist, k)[..., :total] for k in
            ("neighbour", "disp", "r2", "sigma_i", "sigma_j")]


@pytest.mark.parametrize("kind", ["f64", "f32", "hilo"])
@pytest.mark.parametrize("box", ["2d_tilted", "3d_tilted"])
def test_pair_list_and_reduction_match_plain(cuda, box, kind):
    """The list's entries are its plain version's, in the same order and
    the same bits; the reduction matches its plain version, its lean
    forces are the full ones' bits, and both repeat bit for bit; a capacity
    below the hits flags the overflow and keeps the first entries."""
    grid, tilt = BOXES[box]
    cap = 9
    counts = _mixed_counts(int(np.prod(grid)), cap, 4)
    pos, diam, counts_t, cell = _slots_in_box(grid, cap, counts, 2.0, 8,
                                              cuda, tilt, 0.4)
    dtype = torch.float64 if kind == "f64" else torch.float32
    hi = pos.to(dtype)
    lo = (pos - hi.double()).float() if kind == "hilo" else None
    args = (hi, diam.to(dtype), counts_t, cell.to(dtype), grid, 2.0)
    plist = pairs_mod.pair_list(*args, 100000, slot_lo=lo)
    again = pairs_mod.pair_list(*args, 100000, slot_lo=lo)
    torch.cuda.synchronize()
    plain = pairs_mod.pair_list_plain(*args, 100000, slot_lo=lo)
    assert int(plist.total) == int(plain.total) > 100
    assert not bool(plist.overflow) and torch.equal(plist.count, plain.count)
    for got, want, rep in zip(_list_entries(plist), _list_entries(plain),
                              _list_entries(again)):
        assert torch.equal(got, want) and torch.equal(got, rep)
    pot = NonAdditivePHS()
    u, f = pot.evaluate_r2(plist.r2, plist.sigma_i, plist.sigma_j)
    out = pairs_mod.pair_reduce(plist, f, u)
    rep = pairs_mod.pair_reduce(plist, f, u)
    lean = pairs_mod.pair_reduce(plist, f)
    ref = pairs_mod.pair_reduce_plain(plist, f, u)
    assert all(torch.equal(a, b) for a, b in zip(out, rep))
    assert torch.equal(lean[2], out[2])
    rtol_ew, tol_f = TOLERANCES[dtype]
    np.testing.assert_allclose(float(out[0]), float(ref[0]), rtol=rtol_ew)
    np.testing.assert_allclose(float(out[1]), float(ref[1]), rtol=rtol_ew)
    assert _force_ratio(out[2], ref[2], int(counts_t.clamp(max=cap).sum())) \
        <= tol_f
    short = pairs_mod.pair_list(*args, 50, slot_lo=lo)
    assert bool(short.overflow) and int(short.total) == int(plist.total)
    for got, want in zip(_list_entries(short), _list_entries(plist)):
        assert torch.equal(got[..., :50], want[..., :50])


@pytest.mark.parametrize("kind", ["f64", "f32"])
def test_pair_reduce_full_is_one_launch(cuda, kind):
    """The full reduction is one kernel a call (the profiler's kernels of a
    call: one, the reduction's): energy and virial against the plain
    version, forces bit-equal to the lean variant's, repeats and CUDA-graph
    replays bit for bit (the last block's ticket is back at 0 after every
    call)."""
    grid, tilt = BOXES["3d_tilted"]
    cap = 9
    counts = _mixed_counts(int(np.prod(grid)), cap, 5)
    pos, diam, counts_t, cell = _slots_in_box(grid, cap, counts, 2.0, 9,
                                              cuda, tilt, 0.4)
    dtype = torch.float64 if kind == "f64" else torch.float32
    args = (pos.to(dtype), diam.to(dtype), counts_t, cell.to(dtype), grid,
            2.0)
    plist = pairs_mod.pair_list(*args, 100000)
    u, f = NonAdditivePHS().evaluate_r2(plist.r2, plist.sigma_i,
                                        plist.sigma_j)
    first = pairs_mod.pair_reduce(plist, f, u)
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):   # a profile that saw nothing on the device: again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = pairs_mod.pair_reduce(plist, f, u)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset"))]
        if kernels:
            break
    assert len(kernels) == 1 and "pair_reduce" in kernels[0], kernels
    lean = pairs_mod.pair_reduce(plist, f)
    ref = pairs_mod.pair_reduce_plain(plist, f, u)
    rtol_ew, tol_f = TOLERANCES[dtype]
    np.testing.assert_allclose(float(out[0]), float(ref[0]), rtol=rtol_ew)
    np.testing.assert_allclose(float(out[1]), float(ref[1]), rtol=rtol_ew)
    assert _force_ratio(out[2], ref[2], int(counts_t.clamp(max=cap).sum())) \
        <= tol_f
    assert torch.equal(lean[2], out[2])
    assert out[0].shape == out[1].shape == ()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pairs_mod.pair_reduce(plist, f, u)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, first))
    again = pairs_mod.pair_reduce(plist, f, u)
    assert all(torch.equal(a, b) for a, b in zip(out, first))
    assert all(torch.equal(a, b) for a, b in zip(again, first))


def test_user_potential_run_on_the_card_matches_the_cpu(cuda):
    """A 2D polydisperse run with a user potential (the pair-list route in
    the slot layout, f64, NVE) on the card and on the CPU from one state:
    energy, temperature and virial after every segment to rel 1e-10."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                                lattice_positions)

    n, rho = 4096, 0.9
    L = (n / rho) ** 0.5
    cell = np.array([[L, L / 8], [0.0, L]])
    pot = NonAdditivePHS()
    params = mdtpu_torch.Parameters(rho, n, 1e-3, pot)
    diam = 0.8 + 0.4 * torch.rand(n, generator=torch.Generator()
                                  .manual_seed(1), dtype=torch.float64)
    runs = {}
    for device in ("cpu", cuda):
        pos = lattice_positions(n, cell, 2, dtype=torch.float64, jitter=0.02,
                                seed=3, device=device)
        state = build_state_from_arrays(pos, diam, cell, dtype=torch.float64,
                                        cutoff=1.8, device=device)
        eng = CellGridEngine.create(pot, 1.8, 0.1, state.unitcell, n)
        assert eng.uses_pair_list and len(eng.grid) == 2
        slots, eng = slot_step.slotify_grown(state, eng)
        slots = slot_step.slot_forces(slots, eng)
        advance = slot_step.make_slot_advance(params, mdtpu_torch.NVE(), eng)
        rows = []
        for k in (1, 7, 7, 7):
            slots = advance(slots, k)
            rows.append([float(slots.energy), float(slots.temperature),
                         float(slots.virial)])
        assert not bool(slots.nbrs.overflow)
        runs[str(device)] = rows
    np.testing.assert_allclose(runs[str(cuda)], runs["cpu"], rtol=1e-10)


# --------------------------------------------------------------------------
# The RDF histogram; checkpoints on the card.
# --------------------------------------------------------------------------

def _rdf_box(kind, n, rho=0.8):
    dim = 2 if kind == "tilted2d" else 3
    L = (n / rho) ** (1 / dim)
    cell = np.eye(dim) * L
    if kind != "cubic":
        cell[0, 1] = L / 8
        if dim == 3:
            cell[0, 2], cell[1, 2] = L / 12, L / 6
    return cell


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("box", ["cubic", "tilted3d", "tilted2d"])
@pytest.mark.parametrize("n", [2, 129, 3000])
def test_rdf_histogram_matches_plain(cuda, box, dtype, n):
    """The kernel against its plain version on the card, bin for bin (the
    two round every operation alike), at r_max 3 and at half the narrowest
    width; two launches give the same counts; launches are counted."""
    from mdtpu_torch.observables import half_min_width
    from mdtpu_torch.ops import rdf

    cell = _rdf_box(box, n)
    rng = np.random.default_rng(n)
    pos = torch.tensor(rng.random((n, cell.shape[0])) @ cell.T, dtype=dtype,
                       device=cuda)
    c = torch.tensor(cell, dtype=dtype, device=cuda)
    ci = torch.tensor(np.linalg.inv(cell), dtype=dtype, device=cuda)
    for r_max in (3.0, half_min_width(cell)):
        before = rdf.rdf_histogram.launches
        cells = rdf.rdf_histogram.cell_launches
        route = rdf.rdf_plan(pos, c, ci, r_max, 200).route
        got = rdf.rdf_histogram(pos, c, ci, r_max, 200)
        again = rdf.rdf_histogram(pos, c, ci, r_max, 200)
        plain = rdf.rdf_histogram_plain(pos, c, ci, r_max, 200)
        torch.cuda.synchronize()
        assert rdf.rdf_histogram.launches == before + 2
        assert rdf.rdf_histogram.cell_launches == cells + 2 * (
            route == rdf.CELL)
        assert route == rdf.TILE or r_max == 3.0
        assert got.device.type == "cuda" and got.dtype == torch.int64
        assert torch.equal(got, plain) and torch.equal(got, again)
        assert int(got.sum()) % 2 == 0


def _rotated(cell):
    """The cell turned by a fixed rotation: no entry of it or its inverse
    is zero (the general pattern)."""
    dim = cell.shape[0]
    if dim == 2:
        c, s = np.cos(0.3), np.sin(0.3)
        rot = np.array([[c, -s], [s, c]])
    else:
        rot, _ = np.linalg.qr(np.random.default_rng(11).normal(size=(3, 3)))
    return rot @ cell


@pytest.mark.parametrize("displaced", [0, 4, 2 ** 20],
                         ids=["inside", "displaced", "far"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("box", ["cubic", "tilted3d", "tilted2d",
                                 "general3d", "general2d"])
def test_rdf_histogram_routes_match_plain(cuda, box, dtype, displaced):
    """Both routes against the plain version bin for bin, at N = 20,000:
    r_max 3 takes the cell route (asserted) and half the narrowest width
    the tile route (asserted); at r_max 3 the tile route, forced, gives the
    same counts. The boxes: cubic (the diagonal pattern), tilted (upper
    triangular), rotated (general), in 3D and 2D; displaced: every
    particle moved by whole box vectors, up to 4 each way; far: moved by
    2^20 box vectors more, where float32 takes the tile route (its margin
    leaves no cell) and float64 still the cell route. Two launches give
    the same counts."""
    from mdtpu_torch.observables import half_min_width
    from mdtpu_torch.ops import rdf

    n = 20000
    kind = {"general3d": "cubic", "general2d": "tilted2d"}.get(box, box)
    cell = _rdf_box(kind, n)
    if box.startswith("general"):
        cell = _rotated(cell)
    rng = np.random.default_rng(7)
    pos = rng.random((n, cell.shape[0])) @ cell.T
    if displaced:
        pos = pos + rng.integers(-4, 5, size=pos.shape) @ cell.T
    if displaced > 4:
        pos = pos + displaced * cell.sum(axis=1)
    far32 = displaced > 4 and dtype == torch.float32
    pos = torch.tensor(pos, dtype=dtype, device=cuda)
    c = torch.tensor(cell, dtype=dtype, device=cuda)
    ci = torch.tensor(np.linalg.inv(cell), dtype=dtype, device=cuda)
    pattern = {"cubic": rdf.DIAGONAL, "tilted3d": rdf.UPPER,
               "tilted2d": rdf.UPPER}.get(box, rdf.GENERAL)
    for r_max, route in ((3.0, rdf.TILE if far32 else rdf.CELL),
                         (half_min_width(cell), rdf.TILE)):
        plan = rdf.rdf_plan(pos, c, ci, r_max, 200)
        assert (plan.route, plan.pattern) == (route, pattern)
        got = rdf.rdf_histogram(pos, c, ci, r_max, 200)
        again = rdf.rdf_launch(plan, pos)
        plain = rdf.rdf_histogram_plain(pos, c, ci, r_max, 200)
        torch.cuda.synchronize()
        assert torch.equal(got, plain) and torch.equal(got, again)
        assert int(got.sum()) > 0
        if r_max == 3.0 and not far32:
            tile = rdf.rdf_launch(
                rdf.rdf_plan(pos, c, ci, r_max, 200, route=rdf.TILE), pos)
            assert torch.equal(tile, plain)


def test_checkpoint_continuation_is_bit_exact_on_the_card(cuda, tmp_path):
    """200 steps from a state and from that state saved and loaded give the
    same positions and velocities bit for bit, on the slot route, at f32
    and f64."""
    from mdtpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    n = 4096
    params = mdtpu_torch.Parameters(0.8, n, 0.002, LennardJones(r_cut=2.5))
    for dtype in (torch.float32, torch.float64):
        state = lattice_fluid_state(n, 0.8, 1.0, dtype=dtype, cutoff=2.5,
                                    device=cuda)
        mid = mdtpu_torch.run_simulation(
            state, params, mdtpu_torch.NVT(1.0, 0.4), 50, 50,
            str(tmp_path / "a"))
        path = str(tmp_path / f"mid_{dtype}.npz")
        save_checkpoint(mid, path)
        back = load_checkpoint(path, state)
        assert back.positions.device.type == "cuda"
        ends = [mdtpu_torch.run_simulation(s, params, mdtpu_torch.NVE(), 200,
                                           100, str(tmp_path / d))
                for s, d in ((mid, "b"), (back, "c"))]
        assert ends[0].step == ends[1].step == 250
        for name in ("positions", "velocities"):
            assert torch.equal(getattr(ends[0], name),
                               getattr(ends[1], name)), name


# --------------------------------------------------------------------------
# The neighbour list: its build (K1) and force pass (K2).
# --------------------------------------------------------------------------

def _nl_inputs(cuda, name, dtype, n=20000, **capacities):
    """A jittered lattice of POTENTIALS[name] with diameters 1 + 0.1 U, its
    neighbour-list engine and binning."""
    from mdtpu_torch.ops.neighbor_list import NeighborListEngine
    pot, cutoff, rho = POTENTIALS[name]
    state = lattice_fluid_state(n, rho, 1.0, dtype=dtype, cutoff=cutoff,
                                jitter=JITTER, device=cuda)
    diam = (1.0 + 0.1 * torch.rand(n, generator=torch.Generator()
                                   .manual_seed(0), dtype=dtype)).to(cuda)
    eng = NeighborListEngine.create(pot, cutoff, 0.3, state.unitcell, n,
                                    max_sigma=float(diam.max()),
                                    **capacities)
    cid, cell_buf, counts = eng.bin(state.positions, state.unitcell_inv)
    build_args = (state.positions, cid, cell_buf, counts,
                  torch.diagonal(state.unitcell).contiguous(), eng.grid,
                  eng.cutoff + eng.skin, eng.max_neighbors)
    return state, diam, eng, build_args


def _sorted_rows(idx):
    return torch.sort(idx, dim=1).values


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["lj", "pseudo_hs"])
def test_nl_build_matches_plain(cuda, name, dtype):
    from mdtpu_torch.ops import neighbor_list as nl
    _, _, _, args = _nl_inputs(cuda, name, dtype)
    before = nl.nl_build.launches
    idx, count, over = nl.nl_build(*args)
    torch.cuda.synchronize()
    assert nl.nl_build.launches == before + 1
    idx0, count0, over0 = nl.nl_build_plain(*args)
    assert not bool(over) and not bool(over0)
    assert torch.equal(count, count0) and int(count.min()) > 0
    assert torch.equal(_sorted_rows(idx), _sorted_rows(idx0))
    again = nl.nl_build(*args)
    assert all(torch.equal(a, b) for a, b in zip(again, (idx, count, over)))


@pytest.mark.parametrize("capacities", [
    dict(cell_capacity=4), dict(max_neighbors=16)], ids=["cells", "rows"])
def test_nl_build_flags_overflow(cuda, capacities):
    from mdtpu_torch.ops import neighbor_list as nl
    _, _, _, args = _nl_inputs(cuda, "lj", torch.float64, **capacities)
    idx, count, over = nl.nl_build(*args)
    idx0, count0, over0 = nl.nl_build_plain(*args)
    assert bool(over) and bool(over0)
    assert torch.equal(count, count0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(POTENTIALS))
def test_nl_forces_match_plain_and_the_cell_sweep(cuda, name, dtype):
    """K2 against its plain version on the kernel's list, two launches bit
    for bit, and against the full-stencil sweep (B1) on the same state."""
    from mdtpu_torch.ops import neighbor_list as nl
    state, diam, eng, _ = _nl_inputs(cuda, name, dtype)
    args = (state.positions, diam, state.unitcell, state.unitcell_inv)
    nbrs = eng.allocate(*args)
    assert not bool(nbrs.overflow)
    before = nl.nl_forces.launches
    e1, w1, f1, _ = eng.compute(*args, nbrs)
    torch.cuda.synchronize()
    assert nl.nl_forces.launches == before + 1
    lengths = torch.diagonal(state.unitcell).contiguous()
    e0, w0, f0 = nl.nl_forces_plain(state.positions, diam, nbrs.idx,
                                    nbrs.count, lengths, eng.cutoff,
                                    eng.potential)
    rtol_ew, tol_f = TOLERANCES[dtype]
    n = state.n_particles
    np.testing.assert_allclose(float(e1), float(e0), rtol=rtol_ew)
    np.testing.assert_allclose(float(w1), float(w0), rtol=rtol_ew)
    assert _force_ratio(f1.T, f0.T, n) <= tol_f
    e2, w2, f2, _ = eng.compute(*args, nbrs)
    assert torch.equal(e1, e2) and torch.equal(w1, w2) and torch.equal(f1, f2)
    cg = CellGridEngine.create(eng.potential, eng.cutoff, 0.3, state.unitcell,
                               n, diameters=diam)
    nb = cg.allocate(*args)
    e3, w3, f3, _ = cg.compute(*args, nb)
    np.testing.assert_allclose(float(e1), float(e3), rtol=rtol_ew)
    np.testing.assert_allclose(float(w1), float(w3), rtol=rtol_ew)
    if dtype == torch.float64:
        assert _force_ratio(f1.T, f3.T, n) <= tol_f
    else:
        # B1 takes slot coordinates (reference plus minimum image), the list
        # the minimum image of the plain difference: at f32 a pair across
        # the box edge rounds differently in the two. Both are held to the
        # f64 forces on the same positions, the list to twice B1's error.
        ref = nl.nl_forces_plain(state.positions.double(), diam.double(),
                                 nbrs.idx, nbrs.count, lengths.double(),
                                 eng.cutoff, eng.potential)[2]
        assert _force_ratio(f1.T, ref.T, n) <= 2 * _force_ratio(f3.T, ref.T,
                                                                 n)


def test_nl_run_on_the_card_matches_the_cpu(cuda, tmp_path):
    """40 NVE steps on the list (f64, LJ, N = 4096) through run_simulation on
    the card and on the CPU from one state: the final energy, virial and
    temperature to rel 1e-10, positions to 1e-9."""
    from mdtpu_torch.ops import neighbor_list as nl
    n = 4096
    params = mdtpu_torch.Parameters(0.8, n, 0.002,
                                    LennardJones(r_cut=2.5))
    ends = {}
    for device in ("cpu", cuda):
        state = lattice_fluid_state(n, 0.8, 1.0, dtype=torch.float64,
                                    cutoff=2.5, jitter=0.02, device=device)
        eng = mdtpu_torch.select_engine(params.potential, 2.5, state,
                                        prefer="neighbor")
        assert isinstance(eng, nl.NeighborListEngine)
        before = nl.nl_forces.launches
        out = mdtpu_torch.run_simulation(
            state, params, mdtpu_torch.NVE(), 40, 10,
            str(tmp_path / str(device).replace(":", "")), engine=eng,
            device=device)
        if device != "cpu":
            assert nl.nl_forces.launches == before + 41
        ends[str(device)] = ([float(out.energy), float(out.virial),
                              float(out.temperature)],
                             out.positions.cpu().numpy())
    np.testing.assert_allclose(ends[str(cuda)][0], ends["cpu"][0],
                               rtol=1e-10)
    np.testing.assert_allclose(ends[str(cuda)][1], ends["cpu"][1], rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_nl_2d_matches_plain(cuda, dtype):
    """The 2D kernels (a 3 x 3 stencil) on 8,192 polydisperse disks: K1's
    rows as sets, K2 against its plain version (Lennard-Jones); a user
    potential (no functor) evaluates on the tiles on the card as on the
    CPU. (Pseudo-hard disks at this density interact in lone pairs near
    the cutoff, where the force's two terms cancel: an ulp of the card's
    rsqrtf there moves the force by ~7e-5 of itself at f32; the functor
    itself is held in 3D above.)"""
    from mdtpu_torch.ops import neighbor_list as nl
    from mdtpu_torch.sim.initialization import lattice_positions
    n, rho = 8192, 0.7
    L = (n / rho) ** 0.5
    cell = torch.tensor([[L, 0.0], [0.0, L]], dtype=dtype, device=cuda)
    pos = lattice_positions(n, cell.cpu().numpy(), 2, dtype=dtype,
                            jitter=0.03, seed=5, device=cuda)
    diam = (0.9 + 0.2 * torch.rand(n, generator=torch.Generator()
                                   .manual_seed(2), dtype=dtype)).to(cuda)
    cell_inv = torch.linalg.inv(cell)
    lengths = torch.diagonal(cell).contiguous()
    for pot, cutoff in ((LennardJones(r_cut=2.5), 2.5),
                        (NonAdditivePHS(), 1.8)):
        eng = nl.NeighborListEngine.create(pot, cutoff, 0.3, cell, n,
                                           max_sigma=float(diam.max()))
        cid, cell_buf, counts = eng.bin(pos, cell_inv)
        args = (pos, cid, cell_buf, counts, lengths, eng.grid,
                eng.cutoff + eng.skin, eng.max_neighbors)
        idx, count, over = nl.nl_build(*args)
        idx0, count0, over0 = nl.nl_build_plain(*args)
        assert not bool(over) and not bool(over0)
        assert torch.equal(count, count0)
        assert torch.equal(_sorted_rows(idx), _sorted_rows(idx0))
        nbrs = nl.NeighborState(idx=idx, ref_positions=pos, overflow=over,
                                count=count)
        e1, w1, f1, _ = eng.compute(pos, diam, cell, cell_inv, nbrs)
        e0, w0, f0, _ = eng.compute(pos.cpu(), diam.cpu(), cell.cpu(),
                                    cell_inv.cpu(), nl.NeighborState(
                                        idx=idx.cpu(),
                                        ref_positions=pos.cpu(),
                                        overflow=over.cpu(),
                                        count=count.cpu()))
        rtol_ew, tol_f = TOLERANCES[dtype]
        np.testing.assert_allclose(float(e1), float(e0), rtol=rtol_ew)
        np.testing.assert_allclose(float(w1), float(w0), rtol=rtol_ew)
        assert _force_ratio(f1.T.cpu(), f0.T, n) <= tol_f


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("dim", [2, 3])
def test_nl_build_rows_are_the_stencil_order_plain_rows(cuda, dim, dtype):
    """K1's rows bit for bit the stencil-order plain build's (padding
    included), with its counts and flag, given ``order`` and the starts and
    without them (the wrapper derives them); also with C a quarter (cells
    overflow, dropped particles keep their rows) and K 16 (rows cut)."""
    from mdtpu_torch.ops import neighbor_list as nl
    n = 20000 if dim == 3 else 8192
    state = lattice_fluid_state(n, 0.8, 1.0, dimension=dim, dtype=dtype,
                                cutoff=2.5, jitter=JITTER, device=cuda)
    base = nl.NeighborListEngine.create(LennardJones(r_cut=2.5), 2.5, 0.3,
                                        state.unitcell, n)
    lengths = torch.diagonal(state.unitcell).contiguous()
    for eng in (base, dataclasses.replace(
            base, cell_capacity=base.cell_capacity // 4),
            dataclasses.replace(base, max_neighbors=16)):
        cid, buf, counts, order, starts = eng.bin_sorted(
            state.positions, state.unitcell_inv)
        args = (state.positions, cid, buf, counts, lengths, eng.grid,
                eng.cutoff + eng.skin, eng.max_neighbors)
        got = nl.nl_build(*args, order=order, starts=starts)
        want = nl.nl_build_plain(*args, stencil_order=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert bool(got[2]) == (eng is not base)
        derived = nl.nl_build(*args)
        assert all(torch.equal(a, b) for a, b in zip(derived, got))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_nl_build_stages_a_grown_stencil_in_parts(cuda, dtype):
    """C grown twice (137 at this density) puts 27 C candidates past the
    first stage's budget: K1 stages the stencil 9 cells at a time, its rows
    still the stencil-order plain build's and equal as sets to the first
    capacity's."""
    from mdtpu_torch.ops import neighbor_list as nl
    state, _, eng, _ = _nl_inputs(cuda, "lj", dtype)
    grown = eng.with_grown_capacity().with_grown_capacity()
    assert nl.build_plan(eng.cell_capacity, 3, dtype) == 27
    assert nl.build_plan(grown.cell_capacity, 3, dtype) == 9
    lengths = torch.diagonal(state.unitcell).contiguous()
    rows = []
    for e in (eng, grown):
        cid, buf, counts, order, starts = e.bin_sorted(state.positions,
                                                       state.unitcell_inv)
        args = (state.positions, cid, buf, counts, lengths, e.grid,
                e.cutoff + e.skin, e.max_neighbors)
        got = nl.nl_build(*args, order=order, starts=starts)
        want = nl.nl_build_plain(*args, stencil_order=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert not bool(got[2])
        rows.append(got)
    k = eng.max_neighbors
    assert torch.equal(rows[0][1], rows[1][1])
    assert torch.equal(_sorted_rows(rows[0][0]),
                       _sorted_rows(rows[1][0][:, :k]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_nl_build_dense_cells_in_batches_and_parts(cuda, dtype):
    """A 3 x 3 x 3 grid over 20,000 particles (486-1,000 a cell, C
    1,000): K1 takes a cell's particles in batches of 64 and stages the
    stencil 3 cells (f32) or 1 cell (f64) at a time, restaging for every
    batch; its rows are still the stencil-order plain build's, bit for
    bit."""
    from mdtpu_torch.ops import neighbor_list as nl
    state, _, eng, _ = _nl_inputs(cuda, "lj", dtype)
    dense = dataclasses.replace(eng, grid=(3, 3, 3), cell_capacity=1000)
    assert nl.build_plan(dense.cell_capacity, 3, dtype) in (1, 3)
    cid, buf, counts, order, starts = dense.bin_sorted(state.positions,
                                                       state.unitcell_inv)
    assert int(counts.min()) > 64 and int(counts.max()) <= 1000
    args = (state.positions, cid, buf, counts,
            torch.diagonal(state.unitcell).contiguous(), dense.grid,
            dense.cutoff + dense.skin, dense.max_neighbors)
    got = nl.nl_build(*args, order=order, starts=starts)
    want = nl.nl_build_plain(*args, stencil_order=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(POTENTIALS))
def test_nl_forces_with_order_match_without(cuda, name, dtype):
    """K2 with the rows in cell order (the state's ``order``) against K2 in
    particle order: the same forces bit for bit (a row's sum does not depend
    on where its worker lies), energy and virial within the tolerances."""
    from mdtpu_torch.ops import neighbor_list as nl
    state, diam, eng, _ = _nl_inputs(cuda, name, dtype)
    nbrs = eng.allocate(state.positions, diam, state.unitcell,
                        state.unitcell_inv)
    assert nbrs.order is not None and not bool(nbrs.overflow)
    args = (state.positions, diam, nbrs.idx, nbrs.count,
            torch.diagonal(state.unitcell).contiguous(), eng.cutoff,
            eng.potential)
    e1, w1, f1 = nl.nl_forces(*args, order=nbrs.order)
    e0, w0, f0 = nl.nl_forces(*args)
    assert torch.equal(f1, f0)
    rtol_ew, _ = TOLERANCES[dtype]
    np.testing.assert_allclose(float(e1), float(e0), rtol=rtol_ew)
    np.testing.assert_allclose(float(w1), float(w0), rtol=rtol_ew)
    again = nl.nl_forces(*args, order=nbrs.order)
    assert all(torch.equal(a, b) for a, b in zip(again, (e1, w1, f1)))


# --------------------------------------------------------------------------
# The slab launch of the sharded engine (a ring of one on the card).
# --------------------------------------------------------------------------

def _slab(cuda, kind, n=20000, tilted=False):
    """A ring of one's slab inputs of the melted lattice, and the periodic
    slot state they come from (f64 melt, cast; hi/lo words of it)."""
    from mdtpu_torch.parallel import HaloSlotEngine, ShardRing
    from mdtpu_torch.parallel.halo_slot import build_sharded_slot_state
    from mdtpu_torch.integrate import slot_step

    dtype = torch.float64 if kind == "f64" else torch.float32
    slots, eng = _melted_slots(cuda, torch.float64)
    state = slot_step.unslotify_state(slots)
    halo = HaloSlotEngine(potential=eng.potential, cutoff=eng.cutoff,
                          skin=eng.skin, grid=eng.grid,
                          cell_capacity=eng.cell_capacity,
                          ring=ShardRing(device=cuda))
    sh = build_sharded_slot_state(state, halo)
    hi = sh.positions.to(dtype)
    lo = (sh.positions - hi.double()).float() if kind == "hilo" else None
    pos, slab_lo, diam, counts, grid, interior = halo.slab_inputs(
        hi, sh.diameters.to(dtype), sh.nbrs.counts,
        sh.unitcell.to(dtype).contiguous(), lo)
    first = (pos,) if lo is None else (pos, slab_lo)
    periodic = (hi,) if lo is None else (hi, lo)
    args = (diam, counts, sh.unitcell.to(dtype).contiguous(), grid,
            halo.cutoff, halo.potential)
    per_args = (sh.diameters.to(dtype), sh.nbrs.counts,
                sh.unitcell.to(dtype).contiguous(), halo.grid, halo.cutoff,
                halo.potential)
    return first, args, interior, periodic, per_args, int(counts.sum())


@pytest.mark.parametrize("kind", ["f64", "f32", "hilo"])
def test_slab_launch_matches_plain_and_periodic(cuda, kind):
    """B1 over the interior cells of the ghost-extended grid: against its
    plain version on the same inputs and against the periodic launch on the
    global slots (a ring of one's slab is the whole box), at the sweep's
    tolerances; the output covers the interior slots only."""
    first, args, interior, periodic, per_args, n = _slab(cuda, kind)
    kernel = (sweep_mod.cell_sweep_hilo if kind == "hilo"
              else sweep_mod.cell_sweep)
    plain = (sweep_mod.cell_sweep_hilo_plain if kind == "hilo"
             else sweep_mod.cell_sweep_plain)
    before = kernel.slab_launches
    got = kernel(*first, *args, interior=interior)
    assert kernel.slab_launches == before + 1
    ref = plain(*first, *args, interior=interior)
    per = kernel(*periodic, *per_args)
    torch.cuda.synchronize()
    assert got[2].shape == per[2].shape
    rtol, ftol = TOLERANCES[torch.float64 if kind == "f64"
                            else torch.float32]
    for r in (ref, per):
        np.testing.assert_allclose(float(got[0]), float(r[0]), rtol=rtol)
        np.testing.assert_allclose(float(got[1]), float(r[1]), rtol=rtol)
        assert _force_ratio(got[2], r[2], n) <= ftol


@pytest.mark.parametrize("kind", ["f64", "f32", "hilo"])
def test_slab_lean_is_bit_equal_and_repeats(cuda, kind):
    first, args, interior, _, _, _ = _slab(cuda, kind)
    kernel = (sweep_mod.cell_sweep_hilo if kind == "hilo"
              else sweep_mod.cell_sweep)
    full = kernel(*first, *args, interior=interior)
    again = kernel(*first, *args, interior=interior)
    lean = kernel(*first, *args, observables=False, interior=interior)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(full, again))
    assert torch.equal(lean[2], full[2])
    assert float(lean[0]) == float(lean[1]) == 0.0


def test_slab_launch_rejects_a_run_outside_the_grid(cuda):
    first, args, interior, _, _, _ = _slab(cuda, "f32")
    first_cell, count = interior
    for bad in ((-1, count), (first_cell, 0),
                (first_cell, count + 2 * first_cell)):
        with pytest.raises(ValueError, match="interior cells"):
            sweep_mod.cell_sweep(*first, *args, interior=bad)


def test_sharded_run_on_the_card_matches_the_cpu(cuda, tmp_path):
    """run_simulation_sharded on a ring of one at N = 4096 f64 (two NVE
    legs: the card's random streams are not the CPU's), on the card and on
    the CPU from one state: thermo rows to rel 1e-9 (one flip of the last
    printed digit), positions to 1e-9; every step's sweep is a slab launch
    on the card."""
    from mdtpu_torch.parallel import HaloSlotEngine, ShardRing

    n = 4096
    pot = LennardJones(r_cut=2.5)
    params = mdtpu_torch.Parameters(0.8, n, 0.002, pot)
    out = {}
    for device in ("cpu", cuda):
        state = lattice_fluid_state(n, 0.8, 1.0, dtype=torch.float64,
                                    cutoff=2.5, jitter=JITTER, device=device)
        eng = HaloSlotEngine.create(pot, 2.5, state.unitcell, n,
                                    ShardRing(device=device))
        sweep_mod.reset_launches()
        mid = mdtpu_torch.run_simulation_sharded(
            state, params, mdtpu_torch.NVE(), 30, 10,
            str(tmp_path / f"{device}_nvt"), engine=eng, device=device)
        end = mdtpu_torch.run_simulation_sharded(
            mid, params, mdtpu_torch.NVE(), 30, 10,
            str(tmp_path / f"{device}_nve"), engine=eng, device=device)
        launches = sweep_mod.cell_sweep.slab_launches
        rows = np.concatenate([np.loadtxt(tmp_path / f"{device}_{leg}"
                                          / "thermo.txt")
                               for leg in ("nvt", "nve")])
        out[str(device)] = (rows, end.positions.cpu().numpy(), launches)
    (rows_c, pos_c, _), (rows_g, pos_g, launches) = (out["cpu"],
                                                      out[str(cuda)])
    assert launches >= 60
    assert np.all(np.abs(rows_g - rows_c)
                  <= np.maximum(1e-9 * np.abs(rows_c), 1.000001e-6))
    np.testing.assert_allclose(pos_g, pos_c, rtol=0, atol=1e-9)


# --------------------------------------------------------------------------
# The pair list's slab launch: a user potential on the sharded engine.
# --------------------------------------------------------------------------

def _user_slab(cuda, kind, n=4096):
    """A ring of one's slab inputs of config 4's density and diameters (2D,
    rho 0.9, U(0.8, 1.2), cutoff 1.8) on a lattice jittered by 0.05, and the
    periodic slot inputs they come from: ``(engine, slab args, slab lo
    words, interior, periodic args, periodic lo words)``, each args tuple
    ``(slot_pos, slot_diam, counts, cell, grid, cutoff)``."""
    from mdtpu_torch.parallel import HaloSlotEngine, ShardRing
    from mdtpu_torch.parallel.halo_slot import build_sharded_slot_state
    from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                                lattice_positions)

    dtype = torch.float64 if kind == "f64" else torch.float32
    L = (n / 0.9) ** 0.5
    cell = torch.eye(2, dtype=torch.float64) * L
    pos = lattice_positions(n, cell, 2, dtype=torch.float64, jitter=0.05,
                            seed=4, device=cuda)
    diam = 0.8 + 0.4 * torch.rand(n, generator=torch.Generator()
                                  .manual_seed(6), dtype=torch.float64)
    state = build_state_from_arrays(pos, diam, cell, dtype=torch.float64,
                                    cutoff=1.8, device=cuda)
    halo = HaloSlotEngine.create(NonAdditivePHS(), 1.8, cell, n,
                                 ShardRing(device=cuda), diameters=diam)
    assert halo.uses_pair_list and halo.pair_capacity > 0
    sh = build_sharded_slot_state(state, halo)
    hi = sh.positions.to(dtype)
    lo = (sh.positions - hi.double()).float() if kind == "hilo" else None
    cellm = sh.unitcell.to(dtype).contiguous()
    d = sh.diameters.to(dtype)
    pos_e, lo_e, diam_e, counts_e, grid_e, interior = halo.slab_inputs(
        hi, d, sh.nbrs.counts, cellm, lo)
    return (halo, (pos_e, diam_e, counts_e, cellm, grid_e, halo.cutoff),
            lo_e, interior, (hi, d, sh.nbrs.counts, cellm, halo.grid,
                             halo.cutoff), lo)


@pytest.mark.parametrize("kind", ["f64", "f32", "hilo"])
def test_pair_list_slab_launch_matches_plain_and_the_periodic_list(cuda,
                                                                   kind):
    """The list over the interior cells of the ghost-extended grid: its
    entries and counts are its plain version's, bit for bit, and repeat;
    against the periodic list of the same state (a ring of one's slab is
    the whole box) the same pairs in the same order (displacements, r^2 and
    diameters equal; the neighbours are slots of the extended grid), and
    the sweep on it gives the periodic list route's forces, energy and
    virial bit for bit."""
    halo, slab, slab_lo, interior, per, per_lo = _user_slab(cuda, kind)
    cap = halo.pair_list_capacity
    before = pairs_mod.pair_list.slab_launches
    got = pairs_mod.pair_list(*slab, cap, slot_lo=slab_lo,
                              interior=interior)
    assert pairs_mod.pair_list.slab_launches == before + 1
    again = pairs_mod.pair_list(*slab, cap, slot_lo=slab_lo,
                                interior=interior)
    per_list = pairs_mod.pair_list(*per, cap, slot_lo=per_lo)
    torch.cuda.synchronize()
    plain = pairs_mod.pair_list_plain(*slab, cap, slot_lo=slab_lo,
                                      interior=interior)
    assert got.count.shape == (interior[1] * halo.cell_capacity,)
    assert int(got.total) == int(plain.total) == int(per_list.total) > 1000
    assert not bool(got.overflow)
    assert torch.equal(got.count, plain.count)
    assert torch.equal(got.count, per_list.count)
    for a, b, c in zip(_list_entries(got), _list_entries(plain),
                       _list_entries(again)):
        assert torch.equal(a, b) and torch.equal(a, c)
    for a, b in zip(_list_entries(got)[1:], _list_entries(per_list)[1:]):
        assert torch.equal(a, b)
    pot = halo.potential
    for obs in (True, False):
        slab_out = pairs_mod.pair_sweep(*slab, pot, cap, obs, slab_lo,
                                        interior=interior)
        per_out = pairs_mod.pair_sweep(*per, pot, cap, obs, per_lo)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(slab_out[:3],
                                                     per_out[:3]))


def test_pair_list_workspace_pads_only_what_is_stale(cuda):
    """A list kept in a workspace across calls (the engines' way) holds, in
    all its capacity, what a fresh list holds: as its hits fall and rise
    (the positions scaled by a few percent about the origin), under
    CUDA-graph replay with the inputs changed in place between replays, and
    at a grown capacity (new buffers, padded whole)."""
    halo, _, _, _, per, _ = _user_slab(cuda, "f64")
    pos, diam, counts, cell, grid, cutoff = per
    cap = halo.pair_list_capacity
    ws = pairs_mod.PairListWorkspace()

    def same(kept, fresh):
        assert torch.equal(kept.count, fresh.count)
        assert int(kept.total) == int(fresh.total)
        for k in ("neighbour", "disp", "r2", "sigma_i", "sigma_j"):
            assert torch.equal(getattr(kept, k), getattr(fresh, k)), k
        assert int(ws.last_total) == int(fresh.total)

    totals = []
    x = pos.clone()
    for scale in (1.0, 1.03, 1.01, 1.05, 1.0):
        x.copy_(pos * scale)
        kept = pairs_mod.pair_list(x, diam, counts, cell, grid, cutoff, cap,
                                   workspace=ws)
        assert kept.r2.data_ptr() == ws.buffers["r2"].data_ptr()
        fresh = pairs_mod.pair_list(x, diam, counts, cell, grid, cutoff,
                                    cap)
        torch.cuda.synchronize()
        same(kept, fresh)
        totals.append(int(fresh.total))
    # The totals fell and rose: stale hits were padded over, and new ones
    # written past the old end.
    steps = list(zip(totals, totals[1:]))
    assert any(b < a for a, b in steps) and any(b > a for a, b in steps)

    def call():
        return pairs_mod.pair_list(x, diam, counts, cell, grid, cutoff, cap,
                                   workspace=ws)

    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for scale in (1.02, 1.0, 1.04):
        x.copy_(pos * scale)
        graph.replay()
        fresh = pairs_mod.pair_list(x, diam, counts, cell, grid, cutoff,
                                    cap)
        torch.cuda.synchronize()
        same(captured, fresh)
    grown = cap + 4099
    kept = pairs_mod.pair_list(pos, diam, counts, cell, grid, cutoff, grown,
                               workspace=ws)
    fresh = pairs_mod.pair_list(pos, diam, counts, cell, grid, cutoff, grown)
    torch.cuda.synchronize()
    assert kept.capacity == grown
    same(kept, fresh)


def test_sharded_user_run_on_the_card_matches_the_cpu(cuda, tmp_path):
    """run_simulation_sharded with a user potential (the pair list's slab
    launch) on a ring of one at N = 4096, 2D f64 (config 4's density and
    diameters), two NVE legs, on the card and on the CPU from one state:
    thermo rows to rel 1e-9 (one flip of the last printed digit), positions
    to 1e-9; every step's list is a slab launch on the card."""
    from mdtpu_torch.parallel import HaloSlotEngine, ShardRing
    from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                                initialize_velocities,
                                                lattice_positions)

    n, rho = 4096, 0.9
    pot = NonAdditivePHS()
    params = mdtpu_torch.Parameters(rho, n, 1e-3, pot)
    L = (n / rho) ** 0.5
    cell = torch.eye(2, dtype=torch.float64) * L
    diam = 0.8 + 0.4 * torch.rand(n, generator=torch.Generator()
                                  .manual_seed(6), dtype=torch.float64)
    vel = initialize_velocities(0.5, 7, n, 2, dtype=torch.float64,
                                device="cpu")
    out = {}
    for device in ("cpu", cuda):
        pos = lattice_positions(n, cell, 2, dtype=torch.float64, jitter=0.05,
                                seed=4, device=device)
        state = build_state_from_arrays(pos, diam, cell, dtype=torch.float64,
                                        cutoff=1.8, device=device)
        state = state.replace(velocities=vel.to(device))
        eng = HaloSlotEngine.create(pot, 1.8, cell, n,
                                    ShardRing(device=device), diameters=diam)
        pairs_mod.reset_launches()
        mid = mdtpu_torch.run_simulation_sharded(
            state, params, mdtpu_torch.NVE(), 30, 10,
            str(tmp_path / f"{device}_a"), engine=eng, device=device)
        end = mdtpu_torch.run_simulation_sharded(
            mid, params, mdtpu_torch.NVE(), 30, 10,
            str(tmp_path / f"{device}_b"), engine=eng, device=device)
        launches = pairs_mod.pair_list.slab_launches
        rows = np.concatenate([np.loadtxt(tmp_path / f"{device}_{leg}"
                                          / "thermo.txt")
                               for leg in ("a", "b")])
        out[str(device)] = (rows, end.positions.cpu().numpy(), launches)
    (rows_c, pos_c, _), (rows_g, pos_g, launches) = (out["cpu"],
                                                      out[str(cuda)])
    assert launches >= 60
    assert np.all(np.abs(rows_g - rows_c)
                  <= np.maximum(1e-9 * np.abs(rows_c), 1.000001e-6))
    np.testing.assert_allclose(pos_g, pos_c, rtol=0, atol=1e-9)
