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
the CPU. The slot step's small kernels: Philox's words, Bussi's draw, the
Brownian noise and the rebuild test (at the threshold's ulp, on rows off
16-byte alignment) against their plain versions; the velocity finish's
tail against the torch composition on the card (bit for bit given the
kinetic energy) and summing the velocities itself; the captured and eager
slot routes bit for bit, and a captured step's nodes read from its graph.
The finish and the noise launch as programmatic dependents: 100 finishes
overlapping in one graph each equal to the call alone, the programmatic
edge into a captured step's finish (NVT, NVE) or update (Brownian), the
noise in memory the kernel before it reads, the same bits from the plain
launch, and the summing finish's step written by the kernel just before.
The slot step's Verlet chain (``integrate/verlet_update.py``): each
variant bit for bit the torch composition on the card (f32, f64,
compensated and not, 16-byte and unaligned rows, in place and into new
tensors, the step counter), its bad inputs refused; the captured slot
advance writing its buffers in place against the composition it replaced,
run eagerly (bench NVT then hi/lo NVE, 2D, tilted: every segment's numbers
and arrays bit for bit), the tilted box captured against eager, and a
captured lean step's nodes (7 NVT, 6 NVE, no copy; the full last step
the same). The Brownian slot step's update (``brownian_update``): bit for
bit the torch composition on the card fed by the noise kernel (f32, f64,
compensated and not, 2D, unaligned rows, a device counter past 2^32 and a
host step, a rank, in place and into new tensors), its bad inputs refused,
a captured Brownian step's nodes (at most 5, no copy, no memset, one
programmatic edge into the update), captured against eager at f64 and on
the hi/lo sweep. B1's energy and virial summed in its last block: against
``torch.sum`` of the same launch's partials (melted bench fluid, a slab, a
tilted 2D box; f64, f32, hi/lo), two launches alike, and a captured full
sweep writing its NaN-filled scalars. The list's reduction,
staged and walked, against its plain version in list order on config 4's
list and a 3D list (forces bit for bit, a captured call replayed). The
particle rows' drift test and Brownian move at the edges of their grid
(``philox_draws.rows_edge_counts``; d 2 and 3, f64 and f32, rows at an
offset of one or two values, the only hit at the first row, the last row
and the last Philox period's first row): the flag as the plain version's,
the move bit for bit, each twice alike.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one. On a machine with a card (the JAX package need not be
installed there):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import contextlib
import dataclasses
import os
import runpy

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

# The user potential of BASELINE config 4: examples_torch/03_polydisperse_2d.py's,
# loaded by path (this module runs with --noconftest, where a package named
# ``tests`` installed elsewhere can shadow this directory).
NonAdditivePHS = runpy.run_path(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples_torch", "03_polydisperse_2d.py"))["NonAdditivePHS"]


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
    energy, temperature and virial after every segment to rel 1e-10. On
    the card the default route is captured (one graph launch a segment
    variant, the potential in the WHILE node's body) and equals the eager
    route (``graph=False``) bit for bit: every segment's numbers, the
    final arrays and the rebuild steps."""
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
    runs, ends = {}, {}
    for device, graph in (("cpu", None), (cuda, None), (cuda, False)):
        pos = lattice_positions(n, cell, 2, dtype=torch.float64, jitter=0.02,
                                seed=3, device=device)
        state = build_state_from_arrays(pos, diam, cell, dtype=torch.float64,
                                        cutoff=1.8, device=device)
        eng = CellGridEngine.create(pot, 1.8, 0.1, state.unitcell, n)
        assert eng.uses_pair_list and len(eng.grid) == 2
        slots, eng = slot_step.slotify_grown(state, eng)
        slots = slot_step.slot_forces(slots, eng)
        advance = slot_step.make_slot_advance(params, mdtpu_torch.NVE(), eng,
                                              graph=graph)
        rows = []
        for k in (1, 7, 7, 7):
            slots = advance(slots, k)
            rows.append([float(slots.energy), float(slots.temperature),
                         float(slots.virial)])
        assert not bool(slots.nbrs.overflow)
        assert advance.graph is (str(device) != "cpu" and graph is None)
        key = f"{device}_{graph}"
        runs[key] = rows
        ends[key] = (slots, advance.rebuild_steps())
    np.testing.assert_allclose(runs[f"{cuda}_None"], runs["cpu_None"],
                               rtol=1e-10)
    assert runs[f"{cuda}_None"] == runs[f"{cuda}_False"]
    (g, g_reb), (e, e_reb) = ends[f"{cuda}_None"], ends[f"{cuda}_False"]
    assert g_reb == e_reb
    for name in ("positions", "velocities", "forces", "energy", "virial"):
        assert torch.equal(getattr(g, name), getattr(e, name)), name


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


def test_sharded_user_run_on_the_card_matches_the_cpu(cuda, tmp_path,
                                                      monkeypatch):
    """run_simulation_sharded with a user potential (the pair list's slab
    launch) on a ring of one at N = 4096, 2D f64 (config 4's density and
    diameters), two NVE legs, on the card and on the CPU from one state:
    thermo rows to rel 1e-9 (one flip of the last printed digit), positions
    to 1e-9; every step's list is a slab launch on the card (the launches
    counted under graph replay). On the card the default route is captured
    and equals the eager sharded advance (``graph=False``) bit for bit:
    every row, the final arrays and the rebuild steps."""
    import mdtpu_torch.parallel.driver as driver_mod
    from mdtpu_torch.parallel import HaloSlotEngine, ShardRing
    from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                                initialize_velocities,
                                                lattice_positions)
    from mdtpu_torch.utils import counters

    n, rho = 4096, 0.9
    pot = NonAdditivePHS()
    params = mdtpu_torch.Parameters(rho, n, 1e-3, pot)
    L = (n / rho) ** 0.5
    cell = torch.eye(2, dtype=torch.float64) * L
    diam = 0.8 + 0.4 * torch.rand(n, generator=torch.Generator()
                                  .manual_seed(6), dtype=torch.float64)
    vel = initialize_velocities(0.5, 7, n, 2, dtype=torch.float64,
                                device="cpu")
    real = driver_mod.make_sharded_slot_advance
    out = {}
    for device, graph in (("cpu", None), (cuda, None), (cuda, False)):
        made = []

        def make(*args, graph=graph, **kwargs):
            made.append(real(*args, graph=graph, **kwargs))
            return made[-1]

        monkeypatch.setattr(driver_mod, "make_sharded_slot_advance", make)
        pos = lattice_positions(n, cell, 2, dtype=torch.float64, jitter=0.05,
                                seed=4, device=device)
        state = build_state_from_arrays(pos, diam, cell, dtype=torch.float64,
                                        cutoff=1.8, device=device)
        state = state.replace(velocities=vel.to(device))
        eng = HaloSlotEngine.create(pot, 1.8, cell, n,
                                    ShardRing(device=device), diameters=diam)
        key = f"{device}_{graph}"
        counters.settle()
        pairs_mod.reset_launches()
        mid = mdtpu_torch.run_simulation_sharded(
            state, params, mdtpu_torch.NVE(), 30, 10,
            str(tmp_path / f"{key}_a"), engine=eng, device=device)
        end = mdtpu_torch.run_simulation_sharded(
            mid, params, mdtpu_torch.NVE(), 30, 10,
            str(tmp_path / f"{key}_b"), engine=eng, device=device)
        counters.settle()
        launches = pairs_mod.pair_list.slab_launches
        rows = np.concatenate([np.loadtxt(tmp_path / f"{key}_{leg}"
                                          / "thermo.txt")
                               for leg in ("a", "b")])
        assert all(a.graph is (str(device) != "cpu" and graph is None)
                   for a in made)
        out[key] = (rows, end, launches,
                    [s for a in made for s in a.rebuild_steps()])
    (rows_c, end_c, _, _), (rows_g, end_g, launches, reb_g) = (
        out["cpu_None"], out[f"{cuda}_None"])
    rows_e, end_e, launches_e, reb_e = out[f"{cuda}_False"]
    assert launches >= 60 and launches == launches_e
    assert np.all(np.abs(rows_g - rows_c)
                  <= np.maximum(1e-9 * np.abs(rows_c), 1.000001e-6))
    np.testing.assert_allclose(end_g.positions.cpu().numpy(),
                               end_c.positions.numpy(), rtol=0, atol=1e-9)
    assert np.array_equal(rows_g, rows_e) and reb_g == reb_e
    for name in ("positions", "velocities", "forces", "images"):
        assert torch.equal(getattr(end_g, name), getattr(end_e, name)), name


# --------------------------------------------------------------------------
# The slot advance on the device: the Philox draws, the rebuild flag, and
# the captured advance against the eager one.
# --------------------------------------------------------------------------

# Random123's known answers for Philox-4x32-10: (counter, key, words).
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def test_philox_known_answers_and_words_on_the_card(cuda):
    from mdtpu_torch.ops import philox_draws as draws
    ctr = torch.tensor([k[0] for k in PHILOX_KAT], device=cuda)
    key = torch.tensor([k[1] for k in PHILOX_KAT], device=cuda)
    assert draws.philox_words(ctr, key).cpu().tolist() == [
        list(k[2]) for k in PHILOX_KAT]
    rng = np.random.default_rng(3)
    ctr = torch.from_numpy(rng.integers(0, 2 ** 32, (4096, 4)))
    key = torch.from_numpy(rng.integers(0, 2 ** 32, (4096, 2)))
    assert torch.equal(draws.philox_words(ctr.to(cuda), key.to(cuda)).cpu(),
                       draws.philox_words(ctr, key))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("dof", [0.0, 1.0, 3.0, 196604.0])
def test_bussi_draw_matches_plain(cuda, dof, dtype):
    """r1 and r2 against the plain version to rel 1e-12 in float64 (the
    card's libm is not the CPU's), one float32 rounding of that in
    float32; two launches bit for bit."""
    from mdtpu_torch.ops import philox_draws as draws
    rtol = 1e-12 if dtype == torch.float64 else 1.2e-7
    for seed, step in ((7, 0), (7, 1), (7, 123456), (2 ** 40 + 3, 2 ** 33 + 5)):
        got = draws.bussi_draw(seed, torch.tensor(step, device=cuda), dof,
                               dtype)
        again = draws.bussi_draw(seed, torch.tensor(step, device=cuda), dof,
                                 dtype)
        want = draws.bussi_draw(seed, torch.tensor(step), dof, dtype)
        assert torch.equal(got, again)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("dof", [0.0, -3.0, 0.3, 1.5, 3.0, 196604.0,
                                 float("inf")])
def test_bussi_draw_matches_its_plain_version_on_the_card(cuda, dof, dtype):
    """Bussi's draw bit for bit its plain version run on the card (the
    same operations by torch's CUDA kernels) over 200 steps and at a step
    past 2^32: r2 = 0 where dof <= 0, the boost where a < 1 (dof 0.3 and
    1.5: exponents 1/a of 6.67 and 1.33, which torch's pow takes as pow),
    the first accepting attempt (a rejected first one at some of the
    steps), and an infinite dof on which no attempt accepts. Each draw is
    a programmatic dependent of a kernel that writes its step just before
    it (the draw reads the step after the wait): the same bits as a draw
    launched after a synchronize."""
    from mdtpu_torch.ops import philox_draws as draws
    steps = list(range(200)) + [2 ** 33 + 5]
    step = torch.zeros((), dtype=torch.int64, device=cuda)
    got, settled = [], []
    for s in steps:
        step.fill_(s)
        got.append(draws.bussi_draw(7, step, dof, dtype))
        torch.cuda.synchronize()
        settled.append(draws.bussi_draw(7, step, dof, dtype))
    got, settled = torch.stack(got), torch.stack(settled)
    r1, r2 = draws.bussi_draw_plain(7, torch.tensor(steps, device=cuda), dof)
    want = torch.stack([r1, r2], 1).to(dtype)
    assert torch.equal(got, settled)
    assert torch.equal(got, want), (got - want).abs().max()
    if not dof > 0:
        assert not got[:, 1].any()
    if dof == float("inf"):
        assert torch.isinf(got[:, 1]).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", [(3, 124875), (2, 7), (3, 1)])
def test_uniform_noise_matches_plain_bit_for_bit(cuda, shape, dtype):
    from mdtpu_torch.ops import philox_draws as draws
    for rank in (None, 3):
        got = draws.uniform_noise(11, torch.tensor(41, device=cuda), shape,
                                  dtype, rank)
        want = draws.uniform_noise(11, torch.tensor(41), shape, dtype, rank)
        assert got.shape == shape and got.dtype == dtype
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("dim", [2, 3])
def test_rebuild_flag_matches_plain(cuda, dim, dtype):
    """The flag against the drift test on drifts below skin/2 and with one
    slot past it (each slot of a few), written into a given tensor."""
    from mdtpu_torch.ops import philox_draws as draws
    g = torch.Generator().manual_seed(dim)
    ref = torch.rand((dim, 20000), generator=g, dtype=torch.float64) * 30
    drift = (torch.rand((dim, 20000), generator=g, dtype=torch.float64)
             - 0.5) * 0.08
    out = torch.zeros((), dtype=torch.bool, device=cuda)
    for slot in (None, 0, 12345, 19999):
        pos = ref + drift
        if slot is not None:
            pos[dim - 1, slot] += 0.25
        pos, r = pos.to(dtype), ref.to(dtype)
        want = draws.rebuild_flag(pos, r, 0.3)
        got = draws.rebuild_flag(pos.to(cuda), r.to(cuda), 0.3, out=out)
        assert got is out and bool(got) == bool(want) == (slot is not None)


def _graph_and_eager(state, params, ensemble, engine, segments, hilo=False):
    """The slot advance eagerly and captured from one slot state: per route
    the final state, the thermo numbers after every segment, the rebuild
    steps and the launch counts."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.utils import counters
    out = {}
    for graph in (False, None):
        advance = slot_step.make_slot_advance(params, ensemble, engine,
                                              hilo=hilo, graph=graph)
        before = counters.snapshot()
        s, rows = state, []
        for k in segments:
            s = advance(s, k)
            rows.append(torch.stack([s.energy, s.temperature, s.virial,
                                     s.virial_accum]).cpu())
        counts = {(getattr(o, "__name__", o), n): v for (o, n), v in
                  counters.difference(counters.snapshot(), before).items()}
        out[graph] = (s, torch.stack(rows), advance.rebuild_steps(), counts)
    return out


def _assert_routes_equal(out, n_steps):
    (se, rows_e, reb_e, n_e), (sg, rows_g, reb_g, n_g) = out[False], out[None]
    assert sg.step == se.step
    for name in ("positions", "velocities", "forces", "pos_comp", "vel_comp",
                 "images", "ids"):
        assert torch.equal(getattr(sg, name), getattr(se, name)), name
    assert torch.equal(rows_g, rows_e)
    assert reb_g == reb_e and len(reb_e) >= 1
    # The captured segments' loop test: once a step and once at each graph
    # launch (a step variant's WHILE node), which the eager route does not
    # launch; every other count the eager route's.
    loop = dict(n_g).pop(("step_below", "launches"), 0)
    assert n_steps < loop <= 3 * n_steps
    assert {k: v for k, v in n_g.items()
            if k != ("step_below", "launches")} == n_e
    assert n_e[("make_slot_step", "steps")] == n_steps
    assert n_e[("rebuild_flag", "launches")] >= n_steps
    # An MD step finishes through velocity_finish and draws in it; a
    # Brownian step draws in its update.
    assert n_e.get(("velocity_finish", "launches"), 0) in (0, n_steps)
    assert n_e.get(("brownian_update", "launches"), 0) in (0, n_steps)
    assert ("bussi_draw", "launches") not in n_e
    assert ("uniform_noise", "launches") not in n_e
    assert n_e.get(("cell_sweep", "launches"), 0) + n_e.get(
        ("cell_sweep_hilo", "launches"), 0) == n_steps


def test_captured_slot_advance_equals_eager_nvt_then_hilo_nve(cuda):
    """NVT on a ramp (the device's ktemp table), then NVE on the hi/lo
    sweep, 4096 LJ at f32: captured and eager bit for bit, with the same
    rebuilds and the same counts of every kernel launch."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.integrate.ramps import LinearRamp
    n = 4096
    pot = LennardJones(r_cut=2.5)
    params = mdtpu_torch.Parameters(0.8, n, 0.002, pot)
    state = lattice_fluid_state(n, 0.8, 1.0, dtype=torch.float32, cutoff=2.5,
                                jitter=JITTER, device=cuda)
    eng = CellGridEngine.create(pot, 2.5, 0.3, state.unitcell, n)
    slots = slot_step.slot_forces(slot_step.slotify(state, eng), eng)
    nvt = _graph_and_eager(slots, params,
                           mdtpu_torch.NVT(LinearRamp(1.4, 0.9, 120), 0.4),
                           eng, (1, 60, 60, 29))
    _assert_routes_equal(nvt, 150)
    nve = _graph_and_eager(nvt[None][0], params, mdtpu_torch.NVE(), eng,
                           (1, 40, 40), hilo=True)
    _assert_routes_equal(nve, 81)


def test_captured_slot_advance_equals_eager_brownian_and_2d(cuda):
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                                initialize_velocities,
                                                lattice_positions)
    n = 4096
    state = lattice_fluid_state(n, 0.5, 1.0, dtype=torch.float32, cutoff=1.5,
                                jitter=0.05, device=cuda)
    params = mdtpu_torch.Parameters(0.5, n, 1e-5, PseudoHS())
    # A short skin: rebuilds within the segments.
    eng = CellGridEngine.create(PseudoHS(), 1.5, 0.1, state.unitcell, n)
    slots = slot_step.slotify(state, eng)
    _assert_routes_equal(_graph_and_eager(slots, params,
                                          mdtpu_torch.Brownian(1.0), eng,
                                          (1, 45, 45)), 91)
    L = (n / 0.7) ** 0.5
    cell = np.array([[L, L / 8], [0.0, L]])
    pos = lattice_positions(n, cell, 2, dtype=torch.float32, jitter=0.01,
                            device=cuda)
    state = build_state_from_arrays(pos, np.ones(n), cell, 5,
                                    dtype=torch.float32, cutoff=1.5,
                                    device=cuda)
    state = state.replace(velocities=initialize_velocities(
        1.0, 1, n, 2, dtype=torch.float32, device=cuda))
    params = mdtpu_torch.Parameters(0.7, n, 0.002, PseudoHS())
    eng = CellGridEngine.create(PseudoHS(), 1.5, 0.3, state.unitcell, n)
    slots = slot_step.slot_forces(slot_step.slotify(state, eng), eng)
    _assert_routes_equal(_graph_and_eager(slots, params,
                                          mdtpu_torch.NVT(1.0, 0.1), eng,
                                          (1, 60, 60)), 121)


# The velocity finish's tail: NVT at a fixed target, on a ramp's device
# table read at the step, and NVE.
FINISH_KINDS = ("fixed", "ramp", "nve")


def _finish_target(kind, dtype, device):
    from mdtpu_torch.integrate import velocity_finish as vf
    table = torch.linspace(1.4, 0.9, 64, dtype=torch.float64).to(dtype)
    table = table.to(device)
    return {"fixed": lambda s: 1.0, "nve": lambda s: None,
            "ramp": lambda s: vf.TargetTable(
                table, torch.tensor(s - s % 64, device=device))}[kind]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind", FINISH_KINDS)
def test_velocity_finish_given_kinetic_equals_the_composition(cuda, kind,
                                                              dtype):
    """Given the kinetic energy, the kernel's scale and temperature equal
    the torch composition on the card (its draws from bussi_draw) bit for
    bit, from a device step and from a host step; two launches alike."""
    from mdtpu_torch.integrate import velocity_finish as vf
    target = _finish_target(kind, dtype, cuda)
    nf = 3.0 * 65535
    for s in (0, 5, 600, 2 ** 33 + 5):
        for k in (98302.5, 1234.75, 0.5):
            kin = torch.tensor(k, dtype=dtype, device=cuda)
            step = torch.tensor(s, device=cuda)
            got = torch.stack(vf.velocity_finish(None, kin, 7, step, nf,
                                                 0.002, 0.4, target(s)))
            again = torch.stack(vf.velocity_finish(None, kin, 7, s, nf,
                                                   0.002, 0.4, target(s)))
            want = torch.stack(vf.velocity_finish_plain(
                None, kin, 7, step, nf, 0.002, 0.4, target(s)))
            assert got.dtype == dtype
            assert torch.equal(got, want), (s, k, got, want)
            assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n", [1, 4095, 3 * 124875, 3 * 262144 + 7])
def test_velocity_finish_summing_matches_plain(cuda, n, dtype):
    """Summing the velocities itself: bit for bit its plain version (the
    kernel's sum order, kinetic_plain), and against the composition on
    torch.sum to rel 2e-13 (f64) and 2e-6 (f32: torch sums float32 in
    float32, the kernel the exact squares in float64)."""
    from mdtpu_torch.integrate import thermostat
    from mdtpu_torch.integrate import velocity_finish as vf
    g = torch.Generator().manual_seed(n)
    v = torch.randn(n, generator=g, dtype=torch.float64).to(dtype).to(cuda)
    rtol = 2e-13 if dtype == torch.float64 else 2e-6
    for kind in ("ramp", "nve"):
        target = _finish_target(kind, dtype, cuda)(70)
        step = torch.tensor(70, device=cuda)
        got = torch.stack(vf.velocity_finish(v, None, 3, step, 3.0 * n, 0.002,
                                             0.4, target))
        again = torch.stack(vf.velocity_finish(v, None, 3, step, 3.0 * n,
                                               0.002, 0.4, target))
        want = torch.stack(vf.velocity_finish_plain(v, None, 3, step,
                                                    3.0 * n, 0.002, 0.4,
                                                    target))
        summed = torch.stack(vf.velocity_finish_plain(
            None, thermostat.compute_kinetic(v), 3, step, 3.0 * n, 0.002,
            0.4, target))
        assert torch.equal(got, want) and torch.equal(got, again)
        np.testing.assert_allclose(got.cpu().double().numpy(),
                                   summed.cpu().double().numpy(), rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("slots", [124875, 3037, 6, 1])
def test_rebuild_flag_at_the_threshold(cuda, slots, dtype):
    """One slot one ulp of skin/2 short of the threshold and one past it,
    on each row (rows 1 and 2 start off 16-byte alignment where the slot
    count is odd) and at the first, middle and last slots: the kernel's
    flag is its plain version's, and it repeats with no memset between."""
    from mdtpu_torch.ops import philox_draws as draws
    g = torch.Generator().manual_seed(slots)
    ref = (torch.rand((3, slots), generator=g, dtype=torch.float64)
           * 30).to(dtype)
    half = torch.tensor(0.15, dtype=dtype)
    out = torch.zeros((), dtype=torch.bool, device=cuda)
    for slot in sorted({0, slots // 2, slots - 1}):
        for row in range(3):
            for toward in (0.0, 1.0):
                pos = ref.clone()
                pos[row, slot] += torch.nextafter(
                    half, torch.tensor(toward, dtype=dtype))
                plain = draws.rebuild_flag(pos, ref, 0.3)
                got = draws.rebuild_flag(pos.to(cuda), ref.to(cuda), 0.3,
                                         out=out)
                assert bool(plain) == bool(got)
                assert bool(draws.rebuild_flag(pos.to(cuda), ref.to(cuda),
                                               0.3)) == bool(got)


@pytest.mark.parametrize("ensemble", ["nvt", "nve"])
def test_captured_slot_step_nodes(cuda, ensemble):
    """A captured bench-shaped slot step (4096 LJ, f32) holds one node for
    the drift test, one for the velocity finish and one conditional node,
    and no memset, read from its graph; its replays count one launch of
    each a step."""
    from mdtpu_torch.integrate import slot_step
    n = 4096
    pot = LennardJones(r_cut=2.5)
    params = mdtpu_torch.Parameters(0.8, n, 0.002, pot)
    state = lattice_fluid_state(n, 0.8, 1.0, dtype=torch.float32, cutoff=2.5,
                                jitter=JITTER, device=cuda)
    eng = CellGridEngine.create(pot, 2.5, 0.3, state.unitcell, n)
    slots = slot_step.slot_forces(slot_step.slotify(state, eng), eng)
    ens = mdtpu_torch.NVT(1.0, 0.4) if ensemble == "nvt" else \
        mdtpu_torch.NVE()
    advance = slot_step.make_slot_advance(params, ens, eng,
                                          hilo=ensemble == "nve")
    out = _graph_and_eager(slots, params, ens, eng, (1, 20))
    for route in (False, None):
        assert out[route][3][("velocity_finish", "launches")] == 21
        assert out[route][3][("rebuild_flag", "launches")] == 21
    advance(slots, 5)
    assert advance.graph and sorted(advance.census) == ["last", "lean"]
    for nodes in advance.census.values():
        assert nodes["rebuild_flag"] == 1 and nodes["velocity_finish"] == 1
        assert nodes["bussi_draw"] == 0 and nodes["unreadable"] == 0
        assert nodes["memsets"] == 0 and nodes["conditionals"] == 1
        # The IF node's one dependency: the drift test, at the step's start.
        assert nodes["if_dependencies"] == nodes["if_root_kernels"] == 1
        assert nodes["kernels"] < nodes["nodes"] <= nodes["dot_nodes"]
        # The Verlet chain: kick-drift, kick and (NVT) the rescale.
        assert nodes["verlet_update"] == (3 if ensemble == "nvt" else 2)
    # The lean step: the drift test, the IF node, the chain, the sweep and
    # the finish, nothing copied into the buffers. The full last step has
    # the same nodes: its sweep sums energy and virial in its last block,
    # into the buffers.
    lean, last = advance.census["lean"], advance.census["last"]
    assert lean["copies"] == 0
    assert lean["nodes"] == (7 if ensemble == "nvt" else 6), lean
    assert last["copies"] == 0 and last["nodes"] == lean["nodes"], last


@pytest.mark.parametrize("kind", ["ramp", "nve", "given_kinetic"])
def test_velocity_finish_instances_overlapping_in_a_graph(cuda, kind):
    """100 finishes back to back in one captured graph, each on velocities
    of its own and launched as a programmatic dependent of the one before
    (so they overlap): each equals the same call launched alone, bit for
    bit. Overlapping instances never share the ticket or the handover."""
    from mdtpu_torch.integrate import thermostat
    from mdtpu_torch.integrate import velocity_finish as vf
    from mdtpu_torch.ops import philox_draws as draws
    assert draws.launch_options() == 1
    n = 124875
    g = torch.Generator(device=cuda).manual_seed(3)
    vs = [torch.randn((3, n), generator=g, device=cuda) for _ in range(100)]
    kins = [thermostat.compute_kinetic(v) for v in vs]
    target = _finish_target("nve" if kind == "nve" else "ramp",
                            torch.float32, cuda)(70)
    step = torch.tensor(70, device=cuda)

    def call(i):
        given = kind == "given_kinetic"
        return vf.velocity_finish(None if given else vs[i],
                                  kins[i] if given else None, 5, step,
                                  3.0 * n, 0.002, 0.4, target)

    alone = []
    for i in range(len(vs)):
        alone.append(torch.stack(call(i)))
        torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [call(i) for i in range(len(vs))]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for i, out in enumerate(outs):
            assert torch.equal(torch.stack(out), alone[i]), i


def test_captured_steps_take_programmatic_edges(cuda):
    """A captured NVT and NVE slot step (4096 LJ, f32) enters its velocity
    finish by a programmatic edge, and a Brownian slot step its update
    (which draws the noise), each the graph's only one, read from the graph's edges; a step's nodes are
    those of the same step captured with the plain launch."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.ops import philox_draws as draws
    n = 4096
    lj = LennardJones(r_cut=2.5)
    md = lattice_fluid_state(n, 0.8, 1.0, dtype=torch.float32, cutoff=2.5,
                             jitter=JITTER, device=cuda)
    md_eng = CellGridEngine.create(lj, 2.5, 0.3, md.unitcell, n)
    md_slots = slot_step.slot_forces(slot_step.slotify(md, md_eng), md_eng)
    bd = lattice_fluid_state(n, 0.5, 1.0, dtype=torch.float32, cutoff=1.5,
                             jitter=0.05, device=cuda)
    bd_eng = CellGridEngine.create(PseudoHS(), 1.5, 0.3, bd.unitcell, n)
    bd_slots = slot_step.slotify(bd, bd_eng)
    cases = {
        "nvt": (mdtpu_torch.Parameters(0.8, n, 0.002, lj),
                mdtpu_torch.NVT(1.0, 0.4), md_eng, md_slots, False,
                "programmatic_into_velocity_finish"),
        "nve": (mdtpu_torch.Parameters(0.8, n, 0.002, lj),
                mdtpu_torch.NVE(), md_eng, md_slots, True,
                "programmatic_into_velocity_finish"),
        "brownian": (mdtpu_torch.Parameters(0.5, n, 1e-5, PseudoHS()),
                     mdtpu_torch.Brownian(1.0), bd_eng, bd_slots, False,
                     "programmatic_into_brownian_update"),
    }
    for name, (params, ens, eng, slots, hilo, into) in cases.items():
        census = {}
        for programmatic in (True, False):
            with (contextlib.nullcontext() if programmatic
                  else draws.plain_launch()):
                advance = slot_step.make_slot_advance(params, ens, eng,
                                                      hilo=hilo)
                advance(slots, 5)
            assert advance.graph and sorted(advance.census) == ["last",
                                                                "lean"]
            census[programmatic] = advance.census
        for variant, nodes in census[True].items():
            plain = census[False][variant]
            assert nodes["edges_error"] == plain["edges_error"] == 0
            assert nodes[into] == nodes["programmatic_edges"] == 1, (
                name, variant, nodes)
            assert plain["programmatic_edges"] == 0
            for key in ("nodes", "kernels", "copies", "memsets",
                        "conditionals", "if_dependencies", "dot_nodes"):
                assert nodes[key] == plain[key], (name, variant, key)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_uniform_noise_in_memory_its_predecessor_reads(cuda, dtype):
    """In a captured graph the noise's output takes the memory of a tensor
    that the kernel just before it reads (the graph's pool hands it back
    once that kernel is enqueued): that kernel's result is unchanged and
    the noise is its plain version's, at every replay."""
    from mdtpu_torch.ops import philox_draws as draws
    shape = (3, 124875)
    src = torch.randn(shape, generator=torch.Generator(device=cuda)
                      .manual_seed(8), device=cuda).to(dtype)
    step = torch.tensor(41, device=cuda)
    draws.uniform_noise(11, step, shape, dtype)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        a = src * 3.0                   # written by the kernel before
        read = a * a + 1.0              # the kernel just before the noise
        freed = a.data_ptr()
        del a
        noise = draws.uniform_noise(11, step, shape, dtype)
    assert noise.data_ptr() == freed
    want_read = src * 3.0
    want_read = want_read * want_read + 1.0
    want_noise = draws.uniform_noise(11, torch.tensor(41), shape, dtype)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(read, want_read)
        assert torch.equal(noise.cpu(), want_noise)


def test_other_launches_give_the_same_bits(cuda):
    """The plain launch gives the bits of the launch as a programmatic
    dependent: the finish summing (NVT on a table and at a host target,
    NVE; three value counts), given K, and the noise (both dtypes, a
    rank)."""
    from mdtpu_torch.integrate import velocity_finish as vf
    from mdtpu_torch.ops import philox_draws as draws
    g = torch.Generator(device=cuda).manual_seed(2)
    step = torch.tensor(70, device=cuda)

    def run():
        out = []
        for n in (3 * 124875, 4095, 3 * 262144 + 7):
            v = torch.randn(n, generator=g, device=cuda)
            kin = (0.5 * (v.double() ** 2).sum()).float()
            for kind in FINISH_KINDS:
                target = _finish_target(kind, torch.float32, cuda)(70)
                out.append(torch.stack(vf.velocity_finish(
                    v, None, 5, step, 3.0 * n, 0.002, 0.4, target)))
                out.append(torch.stack(vf.velocity_finish(
                    None, kin, 5, step, 3.0 * n, 0.002, 0.4, target)))
        for shape in ((3, 124875), (3, 263424), (2, 7)):
            for dtype in (torch.float32, torch.float64):
                out.append(draws.uniform_noise(11, step, shape, dtype, 3))
        return out

    g.manual_seed(2)
    want = run()
    with draws.plain_launch():
        g.manual_seed(2)
        got = run()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["ramp", "fixed", "nve"])
def test_velocity_finish_summing_reads_a_step_written_just_before(cuda,
                                                                    kind):
    """The finish that sums reads its step after it waits for the kernel
    before it: in one captured graph, 50 times over, a kernel adds one to
    the step tensor and the finish (a programmatic dependent of that
    kernel) follows; each finish equals the call alone at its step, bit
    for bit, at every replay."""
    from mdtpu_torch.integrate import velocity_finish as vf
    n = 124875
    v = torch.randn((3, n), generator=torch.Generator(device=cuda)
                    .manual_seed(4), device=cuda)
    targets = [_finish_target(kind, torch.float32, cuda)(61 + i)
               for i in range(50)]
    step = torch.tensor(60, device=cuda)

    def call(s, i):
        return torch.stack(vf.velocity_finish(v, None, 5, s, 3.0 * n, 0.002,
                                              0.4, targets[i]))

    alone = [call(torch.tensor(61 + i, device=cuda), i) for i in range(50)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = []
        for i in range(50):
            step.add_(1)
            outs.append(call(step, i))
    for _ in range(3):
        step.fill_(60)
        graph.replay()
        torch.cuda.synchronize()
        for i, out in enumerate(outs):
            assert torch.equal(out, alone[i]), i


# --------------------------------------------------------------------------
# The slot step's Verlet chain (integrate/verlet_update.py) and the list's
# staged reduction.
# --------------------------------------------------------------------------

def _verlet_rows(shape, dtype, device, seed, offset=False):
    """f, v, vc, x, xc (``shape``) and a scale on ``device``: forces of
    order 30, velocities of 1, positions up to 20, compensations of a
    Kahan add's size. ``offset``: v, vc, x and xc are rows of one packed
    tensor, none 16-byte aligned (a rebin's unpacked rows)."""
    g = torch.Generator().manual_seed(seed)
    f = torch.randn(shape, generator=g, dtype=torch.float64) * 30.0
    v = torch.randn(shape, generator=g, dtype=torch.float64)
    vc = torch.randn(shape, generator=g, dtype=torch.float64) * 1e-8
    x = torch.rand(shape, generator=g, dtype=torch.float64) * 20.0
    xc = torch.randn(shape, generator=g, dtype=torch.float64) * 1e-7
    rows = [t.to(dtype).to(device) for t in (f, v, vc, x, xc)]
    if offset:
        n = rows[0].numel()
        packed = torch.zeros(4 * n + 1, dtype=dtype, device=device)
        views = [packed[1 + i * n:1 + (i + 1) * n].view(shape)
                 for i in range(4)]
        for view, row in zip(views, rows[1:]):
            view.copy_(row)
        rows[1:] = views
        assert views[0].data_ptr() % 16
    return rows, torch.tensor(1.0123, dtype=dtype, device=device)


@pytest.mark.parametrize("layout", ["bench", "offset", "odd"])
@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_verlet_update_matches_plain_bit_for_bit(cuda, dtype, compensated,
                                                 layout):
    """Each variant against its plain version on the card's tensors (the
    torch composition on the card), bit for bit: kick-drift into new
    tensors (its inputs untouched) and in place, with the hi/lo low word;
    the kick and the rescale in place, the step counter advanced in place
    and into another tensor; one launch each. The bench's slots (16-byte
    loads), rows off alignment, and a shape of 14 values."""
    from mdtpu_torch.integrate import verlet_update as vu
    shape = {"bench": (3, 124875), "offset": (3, 124875),
             "odd": (2, 7)}[layout]
    (f, v, vc, x, xc), scale = _verlet_rows(shape, dtype, cuda, 3,
                                            layout == "offset")
    half, dt = 0.001, 0.002
    keep = [t.clone() for t in (v, vc, x, xc)]
    want = vu.kick_drift_plain(f, v, vc, x, xc, half, dt, compensated,
                               compensated)
    lo = torch.empty_like(xc) if compensated else None
    n0 = vu.kick_drift.launches
    got = vu.kick_drift(f, v, vc, x, xc, half, dt, compensated, lo=lo)
    torch.cuda.synchronize()
    assert vu.kick_drift.launches == n0 + 1
    for a, b in zip(got, want[:4]):
        assert torch.equal(a, b)
    for a, b in zip((v, vc, x, xc), keep):
        assert torch.equal(a, b)
    if compensated:
        assert torch.equal(lo, want[4])
    else:
        assert got[1] is vc and got[3] is xc
    vu.kick_drift(f, v, vc, x, xc, half, dt, compensated,
                  out=(v, vc, x, xc))
    for a, b in zip((v, vc, x, xc), want[:4]):
        assert torch.equal(a, b)
    step = torch.tensor(2 ** 33 + 5, device=cuda)
    kv, kvc = vu.kick_plain(f * 0.5, v, vc, half, compensated)
    vu.kick(f * 0.5, v, vc, half, compensated, step)
    assert torch.equal(v, kv) and torch.equal(vc, kvc)
    assert int(step) == 2 ** 33 + 6
    rv, rvc = vu.rescale_plain(v, vc, scale, compensated)
    after = torch.empty_like(step)
    n1 = vu.rescale.launches
    vu.rescale(v, vc, scale, compensated, step, after)
    torch.cuda.synchronize()
    assert vu.rescale.launches == n1 + 1
    assert torch.equal(v, rv) and torch.equal(vc, rvc)
    assert int(step) == 2 ** 33 + 6 and int(after) == 2 ** 33 + 7


def test_verlet_update_refuses_what_it_does_not_take(cuda):
    from mdtpu_torch.integrate import verlet_update as vu
    (f, v, vc, x, xc), scale = _verlet_rows((3, 100), torch.float32, cuda, 1)
    with pytest.raises(ValueError):   # not contiguous
        vu.kick(f.t().contiguous().t(), v, vc, 0.001, True)
    with pytest.raises(ValueError):   # shapes differ
        vu.kick(f[:, :50], v, vc, 0.001, True)
    with pytest.raises(ValueError):   # a scale of another dtype
        vu.rescale(v, vc, scale.double(), True)
    with pytest.raises(ValueError):   # a step that is not int64
        vu.kick(f, v, vc, 0.001, True, torch.tensor(3, device=cuda,
                                                    dtype=torch.int32))
    with pytest.raises(TypeError):
        vu.kick(f.half(), v.half(), vc.half(), 0.001, True)


def _old_slot_step(params, ensemble, engine, observables, hilo):
    """The slot MD step as the port ran it before the Verlet chain was one
    kernel: torch operations on new tensors (copied into the advance's
    buffers by the advance)."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.integrate import step as tstep

    def step(state, ktemp=None):
        slot_step.make_slot_step.steps += 1
        dt = float(params.dt)
        half = 0.5 * dt
        v, vc = tstep._add(state.velocities, state.vel_comp,
                           state.forces * half, True)
        x, xc = tstep._add(state.positions, state.pos_comp, v * dt, True)
        energy, virial, forces, nbrs = slot_step._sweep_in(
            engine, x, state.diameters, state.unitcell, state.unitcell_inv,
            state.nbrs, observables, None, -xc if hilo else None)
        if not observables:
            energy, virial = state.energy, state.virial
        v, vc = tstep._add(v, vc, forces * half, True)
        v, vc, temperature = tstep.md_velocity_finish(
            ensemble, v, vc, state, dt, True, None, ktemp)
        return state.replace(
            positions=x, velocities=v, forces=forces, step=state.step + 1,
            energy=energy, virial=virial, temperature=temperature,
            pos_comp=xc, vel_comp=vc, nbrs=nbrs)

    return step


def _slot_case(case, cuda):
    """``(slots, engine, params)``: 4096 LJ at f32 (the bench's density and
    cutoff) on a lattice, in the tilted box [[L, L/8, L/12], [0, L, L/6],
    [0, 0, L]] too, or pseudo-hard disks in a 2D box leaning by L/8."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                                initialize_velocities,
                                                lattice_positions)
    n = 4096
    if case == "2d":
        L = (n / 0.7) ** 0.5
        cell = np.array([[L, L / 8], [0.0, L]])
        pot, cutoff, dt, rho = PseudoHS(), 1.5, 0.002, 0.7
    else:
        L = (n / 0.8) ** (1.0 / 3.0)
        cell = (np.array([[L, L / 8, L / 12], [0.0, L, L / 6],
                          [0.0, 0.0, L]]) if case == "tilted"
                else np.eye(3) * L)
        pot, cutoff, dt, rho = LennardJones(r_cut=2.5), 2.5, 0.002, 0.8
    dim = cell.shape[0]
    pos = lattice_positions(n, cell, dim, dtype=torch.float32, jitter=0.01,
                            device=cuda)
    state = build_state_from_arrays(pos, np.ones(n), cell, 5,
                                    dtype=torch.float32, cutoff=cutoff,
                                    device=cuda)
    state = state.replace(velocities=initialize_velocities(
        1.0, 1, n, dim, dtype=torch.float32, device=cuda))
    eng = CellGridEngine.create(pot, cutoff, 0.3, state.unitcell, n)
    params = mdtpu_torch.Parameters(rho, n, dt, pot)
    return slot_step.slot_forces(slot_step.slotify(state, eng), eng), eng, \
        params


@pytest.mark.parametrize("case", ["bench", "2d", "tilted"])
def test_in_place_steps_give_the_old_composition_bits(cuda, case):
    """The slot advance through the Verlet kernel, the sweep and the finish
    writing the buffers (captured) against the composition the step ran
    before (eager, torch's kernels, results copied into the buffers): NVT
    on a ramp then NVE (the bench on the hi/lo sweep), segments of one step
    and of several; after every segment the thermo numbers and every
    array bit for bit, the same rebuild steps."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.integrate.ramps import LinearRamp
    slots, eng, params = _slot_case(case, cuda)
    segments = (1,) * 6 + (30, 30)
    start = slots
    for ens, hilo in ((mdtpu_torch.NVT(LinearRamp(1.4, 0.9, 80), 0.4),
                       False), (mdtpu_torch.NVE(), case == "bench")):
        new = slot_step.make_slot_advance(params, ens, eng, hilo=hilo)
        old = slot_step.SlotAdvance(
            _old_slot_step(params, ens, eng, False, hilo),
            _old_slot_step(params, ens, eng, True, hilo), eng, ens, True,
            False)
        ends = []
        for advance in (new, old):
            s, rows, arrays = start, [], []
            for k in segments:
                s = advance(s, k)
                rows.append(torch.stack([s.energy, s.virial, s.temperature]))
                arrays.append([getattr(s, f) for f in (
                    "positions", "pos_comp", "velocities", "vel_comp",
                    "forces", "images", "ids")])
            ends.append((s, torch.stack(rows), arrays,
                         advance.rebuild_steps()))
        (sn, rn, an, bn), (so, ro, ao, bo) = ends
        assert torch.equal(rn, ro) and bn == bo and sn.step == so.step
        for i, (a, b) in enumerate(zip(an, ao)):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), i
        assert new.graph and not old.graph
        start = sn


def test_captured_slot_advance_equals_eager_tilted(cuda):
    """The tilted bench box: NVT then hi/lo NVE, captured and eager bit for
    bit at every step (segments of one step, then lean ones), with the same
    rebuilds and counts."""
    from mdtpu_torch.integrate import slot_step
    slots, eng, params = _slot_case("tilted", cuda)
    nvt = _graph_and_eager(slots, params, mdtpu_torch.NVT(1.0, 0.4), eng,
                           (1,) * 5 + (60, 60))
    _assert_routes_equal(nvt, 125)
    nve = _graph_and_eager(nvt[None][0], params, mdtpu_torch.NVE(), eng,
                           (1,) * 5 + (40,), hilo=True)
    _assert_routes_equal(nve, 45)
    assert slot_step.make_slot_step.steps >= 340


def _config4_list(cuda, case):
    """``(plist, u, f)``: the pair list of BASELINE config 4 (2D, 65,536,
    rho 0.9, diameters U(0.8, 1.2), r_c 1.8, f64, a lattice jittered by
    0.05: ~4 entries a slot) or of a 3D lattice (20,000 at rho 0.8, the
    bench's r_c 2.5, f32: ~36), with the user potential's values on it."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                                lattice_positions)
    pot = NonAdditivePHS()
    g = torch.Generator().manual_seed(6)
    if case == "config4":
        n, dim, rho, cutoff, dtype = 65536, 2, 0.9, 1.8, torch.float64
    else:
        n, dim, rho, cutoff, dtype = 20000, 3, 0.8, 2.5, torch.float32
    L = (n / rho) ** (1.0 / dim)
    cell = np.eye(dim) * L
    pos = lattice_positions(n, cell, dim, dtype=torch.float64, jitter=0.05,
                            seed=4, device=cuda)
    diam = 0.8 + 0.4 * torch.rand(n, generator=g, dtype=torch.float64)
    state = build_state_from_arrays(pos, diam, cell, 0, dtype=dtype,
                                    cutoff=cutoff, device=cuda)
    eng = CellGridEngine.create(pot, cutoff, 0.3, state.unitcell, n,
                                diameters=state.diameters)
    slots = slot_step.slotify(state, eng)
    plist = pairs_mod.pair_list(slots.positions, slots.diameters,
                                slots.nbrs.counts, slots.unitcell, eng.grid,
                                eng.cutoff, eng.pair_list_capacity)
    assert not bool(plist.overflow)
    u, f = pot.evaluate_r2(plist.r2, plist.sigma_i, plist.sigma_j)
    return plist, u, f


@pytest.mark.parametrize("way", ["chosen", "staged", "walk"])
@pytest.mark.parametrize("case", ["config4", "3d"])
def test_pair_reduce_forces_are_the_plain_versions_bits(cuda, case, way,
                                                        monkeypatch):
    """The reduction's forces, full and lean, equal the plain version's in
    list order (index_add_ on the CPU) bit for bit, by the kernel the
    wrapper picks (the walk at config 4's short segments, the staged one
    at the 3D list's long ones) and by each forced; energy and virial to
    the sums' rounding; two calls alike."""
    plist, u, f = _config4_list(cuda, case)
    picked = pairs_mod.staged_reduce(plist.capacity, plist.count.shape[0])
    assert picked == (case == "3d")
    if way != "chosen":
        monkeypatch.setattr(pairs_mod, "staged_reduce",
                            lambda *a: way == "staged")
    out = pairs_mod.pair_reduce(plist, f, u)
    lean = pairs_mod.pair_reduce(plist, f)
    again = pairs_mod.pair_reduce(plist, f, u)
    cpu = pairs_mod.PairList(**{k: getattr(plist, k).cpu() for k in (
        "start", "total", "overflow", "count", "neighbour", "disp", "r2",
        "sigma_i", "sigma_j")})
    ref = pairs_mod.pair_reduce_plain(cpu, f.cpu(), u.cpu())
    assert torch.equal(out[2].cpu(), ref[2])
    assert torch.equal(lean[2], out[2])
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert float(lean[0]) == float(lean[1]) == 0.0
    # Captured on the capturing stream: a replay writes the outputs anew.
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pairs_mod.pair_reduce(plist, f, u)
    for t in captured:
        t.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, out))
    rtol = TOLERANCES[out[2].dtype][0]
    np.testing.assert_allclose(float(out[0]), float(ref[0]), rtol=rtol)
    np.testing.assert_allclose(float(out[1]), float(ref[1]), rtol=rtol)


# ------------------------------------------- the Brownian update, B1's fold

BROWNIAN_LAYOUTS = {"slots": (3, 263424), "bench": (3, 124875),
                    "2d": (2, 4097), "offset": (3, 124875)}


def _brownian_state(shape, dtype, device, seed, step, offset=False):
    """A slot state as far as the Brownian update reads it, on ``device``:
    one slot in five vacant (zero rows there), forces of order 30,
    positions up to 20, compensations of a Kahan add's size, the virial,
    the accumulators and the temperature buffer, ``step`` a device
    counter. ``offset``: the positions and their compensation are rows of
    one packed tensor, not 16-byte aligned. Returns ``(state, forces,
    virial)``."""
    import types

    from mdtpu_torch.integrate import velocity_finish as vf
    g = torch.Generator().manual_seed(seed)
    occ = torch.rand(shape[1], generator=g) < 0.8
    f = torch.randn(shape, generator=g, dtype=torch.float64) * 30.0 * occ
    x = torch.rand(shape, generator=g, dtype=torch.float64) * 20.0 * occ
    xc = torch.randn(shape, generator=g, dtype=torch.float64) * 1e-7 * occ
    f, x, xc = (t.to(dtype).to(device) for t in (f, x, xc))
    if offset:
        n = x.numel()
        packed = torch.zeros(2 * n + 1, dtype=dtype, device=device)
        views = [packed[1 + i * n:1 + (i + 1) * n].view(shape)
                 for i in range(2)]
        views[0].copy_(x)
        views[1].copy_(xc)
        x, xc = views
        assert x.data_ptr() % 16
    state = types.SimpleNamespace(
        positions=x, pos_comp=xc, seed=11,
        nbrs=types.SimpleNamespace(occupied=occ.to(device)),
        step=torch.tensor(step, device=device), dtype=dtype, device=device,
        virial_accum=torch.tensor(-3.25, dtype=dtype, device=device),
        nprom=torch.tensor(7, device=device),
        temperature=vf.finish_buffer(torch.tensor(0.5, dtype=dtype,
                                                  device=device)))
    return state, f, torch.tensor(123.456, dtype=dtype, device=device)


@pytest.mark.parametrize("layout", sorted(BROWNIAN_LAYOUTS))
@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_brownian_update_matches_plain_bit_for_bit(cuda, dtype, compensated,
                                                   layout):
    """The kernel against its plain version on the card's tensors, the
    noise drawn there by the ``uniform_noise`` kernel: positions,
    compensation, accumulators, temperature and step bit for bit, into new
    tensors (the state untouched) and in place, at a device counter past
    2^32 and at a host step, for a shard's rank; two launches alike; one
    launch each. The Brownian slot path's slots and the bench's (16-byte
    rows), a 2D shape and rows off alignment; a step that samples the
    virial (``slots``, ``2d``) and one that does not."""
    from mdtpu_torch.integrate import verlet_update as vu
    shape = BROWNIAN_LAYOUTS[layout]
    step = 2 ** 33 + (20 if layout in ("slots", "2d") else 23)
    state, f, virial = _brownian_state(shape, dtype, cuda, 5, step,
                                       layout == "offset")
    coeffs = vu.brownian_coefficients(1e-5, 1.0, dtype)
    keep = [t.clone() for t in (state.positions, state.pos_comp,
                                state.virial_accum, state.nprom, state.step)]
    want = vu.brownian_update_plain(f, virial, state, *coeffs, compensated)
    n0 = vu.brownian_update.launches
    got = vu.brownian_update(f, virial, state, *coeffs, compensated)
    again = vu.brownian_update(f, virial, state, *coeffs, compensated)
    torch.cuda.synchronize()
    assert vu.brownian_update.launches == n0 + 2
    for a, b, c in zip(got[:2] + got[3:], want, again[:2] + again[3:]):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert int(got[2]) == step + 1 and int(again[2]) == step + 1
    for a, b in zip((state.positions, state.pos_comp, state.virial_accum,
                     state.nprom, state.step), keep):
        assert torch.equal(a, b)
    if not compensated:
        assert got[1] is state.pos_comp
    assert int(got[4]) == 7 + (step % 10 == 0)
    ranked = vu.brownian_update(f, virial, state, *coeffs, compensated, 3)
    want3 = vu.brownian_update_plain(f, virial, state, *coeffs, compensated,
                                     3)
    assert torch.equal(ranked[0], want3[0])
    assert not torch.equal(ranked[0], got[0])
    state.step = step
    by_host = vu.brownian_update(f, virial, state, *coeffs, compensated)
    assert by_host[2] == step + 1
    for a, b in zip(by_host[:2] + by_host[3:], want):
        assert torch.equal(a, b)
    state.step = keep[4]
    mine = (state.positions, state.pos_comp, state.step,
            state.virial_accum, state.nprom, state.temperature)
    done = vu.brownian_update(f, virial, state, *coeffs, compensated,
                              in_place=True)
    torch.cuda.synchronize()
    assert all(a is b for a, b in zip(done, mine))
    assert int(state.step) == step + 1
    for a, b in zip(done[:2] + done[3:], want):
        assert torch.equal(a, b)


def test_brownian_update_refuses_what_it_does_not_take(cuda):
    from mdtpu_torch.integrate import verlet_update as vu
    state, f, virial = _brownian_state((3, 100), torch.float32, cuda, 1, 4)
    coeffs = vu.brownian_coefficients(1e-5, 1.0, torch.float32)
    with pytest.raises(ValueError):   # a virial of another dtype
        vu.brownian_update(f, virial.double(), state, *coeffs, True)
    with pytest.raises(ValueError):   # forces of another shape
        vu.brownian_update(f[:, :50], virial, state, *coeffs, True)
    state.nbrs.occupied = state.nbrs.occupied.to(torch.uint8)
    with pytest.raises(ValueError):   # an occupancy that is not bool
        vu.brownian_update(f, virial, state, *coeffs, True)


def _brownian_slots(cuda, n=4096, skin=0.3, dtype=torch.float32):
    from mdtpu_torch.integrate import slot_step
    state = lattice_fluid_state(n, 0.5, 1.0, dtype=dtype, cutoff=1.5,
                                jitter=0.05, device=cuda)
    params = mdtpu_torch.Parameters(0.5, n, 1e-5, PseudoHS())
    eng = CellGridEngine.create(PseudoHS(), 1.5, skin, state.unitcell, n)
    return slot_step.slotify(state, eng), eng, params


def test_captured_brownian_slot_step_nodes(cuda):
    """A captured Brownian slot step (4096 pseudo-hard spheres, f32) holds
    the drift test, the IF node, B1 (its energy and virial summed in its
    last block) and the update, entered by the graph's one programmatic
    edge: at most 5 nodes, no copy, no memset, no noise kernel; its
    replays count one update a step."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.integrate import verlet_update as vu
    slots, eng, params = _brownian_slots(cuda)
    advance = slot_step.make_slot_advance(params, mdtpu_torch.Brownian(1.0),
                                          eng)
    n0 = vu.brownian_update.launches
    advance(slots, 6)
    assert vu.brownian_update.launches == n0 + 6
    assert advance.graph and sorted(advance.census) == ["last", "lean"]
    for nodes in advance.census.values():
        assert nodes["nodes"] <= 5 and nodes["copies"] == 0, nodes
        assert nodes["memsets"] == 0 and nodes["conditionals"] == 1
        assert nodes["rebuild_flag"] == 1 and nodes["brownian_update"] == 1
        assert nodes["uniform_noise"] == 0 and nodes["verlet_update"] == 0
        assert nodes["if_dependencies"] == nodes["if_root_kernels"] == 1
        assert nodes["programmatic_into_brownian_update"] == 1
        assert nodes["programmatic_edges"] == 1
        assert nodes["brownian_edges_error"] == nodes["edges_error"] == 0


def test_captured_brownian_advance_equals_eager_f64_and_hilo(cuda):
    """The Brownian slot advance captured and eager, bit for bit with the
    same rebuilds and counts: f64, and f32 on the hi/lo sweep."""
    from mdtpu_torch.integrate import slot_step
    for dtype, hilo in ((torch.float64, False), (torch.float32, True)):
        slots, eng, params = _brownian_slots(cuda, skin=0.1, dtype=dtype)
        out = {}
        for graph in (False, None):
            advance = slot_step.make_slot_advance(
                params, mdtpu_torch.Brownian(1.0), eng, hilo=hilo,
                graph=graph)
            s, rows = slots, []
            for k in (1, 1, 30, 29):
                s = advance(s, k)
                rows.append(torch.stack([s.energy, s.virial, s.temperature,
                                         s.virial_accum]).cpu())
            out[graph] = (s, torch.stack(rows), advance.rebuild_steps())
        (se, re, be), (sg, rg, bg) = out[False], out[None]
        assert torch.equal(re, rg) and be == bg and len(be) >= 1
        for name in ("positions", "pos_comp", "forces", "images", "ids",
                     "nprom"):
            assert torch.equal(getattr(se, name), getattr(sg, name)), name


def _folded_and_summed(kind, first, args, interior=None):
    """One launch of B1's full variant with its partials kept: ``(folded,
    summed, forces)``, the energy and the virial its last block summed and
    ``torch.sum`` of its partials. The entry point takes the two 0-d
    outputs right after the partials, where ``launch_sweep`` puts its
    scratch tensors."""
    import math
    hilo = kind == "hilo"
    lib = sweep_mod._library()
    slot_pos = first[0]
    diam, counts, box, grid, cutoff, pot = args
    dtype = slot_pos.dtype
    cell = sweep_mod.as_cell(box, len(grid)).contiguous()
    n_cells = math.prod(grid)
    cap = slot_pos.shape[1] // n_cells
    start, n_out = sweep_mod.check_interior(interior, n_cells)
    folded = tuple(torch.full((), float("nan"), dtype=dtype,
                              device=slot_pos.device) for _ in range(2))
    fn = (lib.mdtpu_cell_sweep_hilo_f32 if hilo else
          lib.mdtpu_cell_sweep_f32 if dtype == torch.float32
          else lib.mdtpu_cell_sweep_f64)
    plan = (start, n_out, *sweep_mod._plan_args(cap, dtype, hilo, len(grid)),
            *((sweep_mod.hilo_filter_margin(torch.float32),) if hilo
              else ()), 1)
    e, w, force = sweep_mod.launch_sweep(
        lib, sweep_mod.NAME, fn, (*first, diam, counts, cell), grid, cap,
        cutoff, pot, n_out, "cell_sweep", scratch=folded, plan=plan)
    torch.cuda.synchronize()
    return folded, (e, w), force


@pytest.mark.parametrize("case", ["melted", "slab", "2d"])
@pytest.mark.parametrize("kind", ["f64", "f32", "hilo"])
def test_cell_sweep_folds_energy_and_virial(cuda, kind, case):
    """B1's full variant sums its partials in its last block: against
    ``torch.sum`` of the same launch's partials at rel 1e-6 (f32, summed
    in float64 and rounded once) and 1e-12 (f64); two launches bit for
    bit; the wrapper's one launch gives those scalars and the forces of
    the launch with the sum after it. The melted bench fluid, a ring of
    one's slab launch, and a 2D tilted box."""
    if case == "slab":
        first, args, interior, *_ = _slab(cuda, kind)
    elif case == "melted":
        dtype = torch.float64 if kind == "f64" else torch.float32
        slots, eng = _melted_slots(cuda, dtype)
        first = (slots.positions,) + ((-slots.pos_comp,) if kind == "hilo"
                                      else ())
        args = (slots.diameters, slots.nbrs.counts, slots.unitcell,
                eng.grid, eng.cutoff, eng.potential)
        interior = None
    else:
        grid, tilt = BOXES["2d_tilted"]
        cap = 33
        counts = _mixed_counts(int(np.prod(grid)), cap, cap + 2)
        pos, diam, counts_t, cell = _slots_in_box(grid, cap, counts, 2.5, 4,
                                                  cuda, tilt, 0.2)
        dtype = torch.float64 if kind == "f64" else torch.float32
        hi = pos.to(dtype)
        first = (hi,) + (((pos - hi.double()).float(),) if kind == "hilo"
                         else ())
        args = (diam.to(dtype), counts_t, cell.to(dtype), grid, 2.5,
                LennardJones(r_cut=2.5, force_shift=True))
        interior = None
    folded, summed, force = _folded_and_summed(kind, first, args, interior)
    again, _, force2 = _folded_and_summed(kind, first, args, interior)
    rtol = 1e-12 if kind == "f64" else 1e-6
    for f, s in zip(folded, summed):
        assert bool(torch.isfinite(f))
        np.testing.assert_allclose(float(f), float(s), rtol=rtol)
    assert all(torch.equal(a, b) for a, b in zip(folded, again))
    assert torch.equal(force, force2)
    kernel = (sweep_mod.cell_sweep_hilo if kind == "hilo"
              else sweep_mod.cell_sweep)
    n0 = kernel.launches
    got = kernel(*first, *args, interior=interior)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    assert torch.equal(got[0], folded[0]) and torch.equal(got[1], folded[1])
    assert torch.equal(got[2], force)


@pytest.mark.parametrize("kind", ["f32", "hilo"])
def test_captured_full_sweep_writes_its_scalars(cuda, kind):
    """A full sweep captured into a graph with its forces and scalars in
    given tensors: after they are NaN-filled, a replay writes the eager
    call's values into them (the launch is on the capturing stream)."""
    slots, eng = _melted_slots(cuda, torch.float32)
    first = (slots.positions,) + ((-slots.pos_comp,) if kind == "hilo"
                                  else ())
    args = (slots.diameters, slots.nbrs.counts, slots.unitcell, eng.grid,
            eng.cutoff, eng.potential)
    kernel = (sweep_mod.cell_sweep_hilo if kind == "hilo"
              else sweep_mod.cell_sweep)
    want = kernel(*first, *args)
    force = torch.empty_like(want[2])
    scalars = (torch.empty_like(want[0]), torch.empty_like(want[1]))
    kernel(*first, *args, out=force, scalars_out=scalars)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = kernel(*first, *args, out=force, scalars_out=scalars)
    assert got[0] is scalars[0] and got[1] is scalars[1] and got[2] is force
    for _ in range(2):
        for t in (force, *scalars):
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------ the particle-order step

def _particle_cell(name, L):
    if name == "2d":
        return np.eye(2) * L
    if name == "tilted":
        return np.array([[L, L / 8, L / 12], [0.0, L, L / 6], [0.0, 0.0, L]])
    return np.eye(3) * L


def _particle_rows(name, dtype, device, n=20001, seed=5):
    """f, v, vc, x, xc (n, d) of ``dtype`` and images (n, d) int64 on the
    card, the cell and its inverse: positions at fractional coordinates in
    [-0.05, 1.05) of a box of side 40, so the wrap folds some."""
    g = torch.Generator().manual_seed(seed)
    cell = _particle_cell(name, 40.0)
    d = cell.shape[0]
    frac = torch.rand((n, d), generator=g, dtype=torch.float64) * 1.1 - 0.05
    x = frac @ torch.as_tensor(cell).T
    f = torch.randn((n, d), generator=g, dtype=torch.float64) * 30.0
    v = torch.randn((n, d), generator=g, dtype=torch.float64) * 3.0
    vc = torch.randn((n, d), generator=g, dtype=torch.float64) * 1e-8
    xc = torch.randn((n, d), generator=g, dtype=torch.float64) * 1e-7
    images = torch.randint(-3, 4, (n, d), generator=g)
    c = torch.as_tensor(cell)
    rows = [t.to(dtype).to(device) for t in (f, v, vc, x, xc)]
    return rows, images.to(device), c.to(dtype).to(device), \
        torch.linalg.inv(c).to(dtype).to(device)


@pytest.mark.parametrize("cell", ["cubic", "2d", "tilted"])
@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kick_drift_wrap_matches_plain_bit_for_bit(cuda, dtype, compensated,
                                                   cell):
    """The particle rows' kick-drift-wrap against its plain version on the
    card's tensors (the torch composition with the wrap), bit for bit:
    into new tensors (inputs untouched), twice alike, and in place, with
    the hi/lo low word; one launch each."""
    from mdtpu_torch.integrate import verlet_update as vu
    (f, v, vc, x, xc), images, c, ci = _particle_rows(cell, dtype, cuda)
    half, dt = 0.005, 0.01
    keep = [t.clone() for t in (v, vc, x, xc, images)]
    want = vu.kick_drift_wrap_plain(f, v, vc, x, xc, images, c, ci, half, dt,
                                    compensated, compensated)
    assert not torch.equal(want[4], images)        # some were folded
    lo = torch.empty_like(xc) if compensated else None
    n0 = vu.kick_drift_wrap.launches
    got = vu.kick_drift_wrap(f, v, vc, x, xc, images, c, ci, half, dt,
                             compensated, lo=lo)
    again = vu.kick_drift_wrap(f, v, vc, x, xc, images, c, ci, half, dt,
                               compensated)
    torch.cuda.synchronize()
    assert vu.kick_drift_wrap.launches == n0 + 2
    for a, b, r in zip(got, want[:5], again):
        assert torch.equal(a, b) and torch.equal(a, r)
    for a, b in zip((v, vc, x, xc, images), keep):
        assert torch.equal(a, b)
    if compensated:
        assert torch.equal(lo, want[5])
    else:
        assert got[1] is vc and got[3] is xc
    vu.kick_drift_wrap(f, v, vc, x, xc, images, c, ci, half, dt, compensated,
                       out=(v, vc, x, xc, images))
    for a, b in zip((v, vc, x, xc, images), want[:5]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cell", ["cubic", "2d", "tilted"])
@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_brownian_rows_matches_plain_bit_for_bit(cuda, dtype, compensated,
                                                 cell):
    """The particle rows' Brownian move against its plain version on the
    card (the torch composition, its noise from the ``uniform_noise``
    kernel), bit for bit: a device counter past 2^32 and a host step, into
    new tensors (twice alike) and in place; the virial's sample, the
    temperature and the step."""
    import types

    from mdtpu_torch.integrate import verlet_update as vu
    (f, _, _, x, xc), images, c, ci = _particle_rows(cell, dtype, cuda,
                                                     seed=6)
    coeffs = vu.brownian_coefficients(1e-3, 1.3, dtype)

    def state_of(step):
        return types.SimpleNamespace(
            positions=x.clone(), pos_comp=xc.clone(), images=images.clone(),
            unitcell=c, unitcell_inv=ci, seed=3, step=step, dtype=dtype,
            device=x.device,
            virial_accum=torch.tensor(2.5, dtype=dtype, device=cuda),
            nprom=torch.tensor(4, device=cuda),
            temperature=torch.tensor(0.0, dtype=dtype, device=cuda))

    w = torch.tensor(-1234.5, dtype=dtype, device=cuda)
    for step in (torch.tensor(2 ** 33 + 10, device=cuda), 123457):
        st = state_of(step)
        want = vu.brownian_rows_plain(f, w, st, *coeffs, compensated)
        got = vu.brownian_rows(f, w, st, *coeffs, compensated)
        again = vu.brownian_rows(f, w, st, *coeffs, compensated)
        torch.cuda.synchronize()
        for a, b, r in zip(got[:3] + got[4:], want, again[:3] + again[4:]):
            assert torch.equal(a, b) and torch.equal(a, r)
        assert int(got[3]) == int(step) + 1 == int(again[3])
        assert not torch.equal(want[2], images)
    st = state_of(torch.tensor(2 ** 33 + 8, device=cuda))
    want = vu.brownian_rows_plain(f, w, st, *coeffs, compensated)
    vu.brownian_rows(f, w, st, *coeffs, compensated, in_place=True)
    for a, b in zip((st.positions, st.pos_comp, st.images, st.virial_accum,
                     st.nprom, st.temperature), want):
        assert torch.equal(a, b)
    assert int(st.step) == 2 ** 33 + 9
    assert int(st.nprom) == 5            # 2^33 + 8 is a multiple of 10


@pytest.mark.parametrize("form", ["cell_cubic", "cell_tilted", "lengths_3d",
                                  "lengths_2d"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_rebuild_flag_rows_matches_plain(cuda, dtype, form):
    """The particle rows' drift test against its plain version on the
    card: row by row on displacements within 2% of skin/2 and at the
    threshold's ulp (across the box's faces too), and on all rows at once
    with none past it and with one; the flag written into ``out``."""
    from mdtpu_torch.ops import philox_draws as draws
    name = {"cell_tilted": "tilted", "lengths_2d": "2d"}.get(form, "cubic")
    cell = torch.as_tensor(_particle_cell(name, 12.0), dtype=dtype)
    d, skin, n = cell.shape[0], 0.3, 4096
    g = torch.Generator().manual_seed(9)
    frac = torch.rand((n, d), generator=g, dtype=torch.float64)
    frac[::2, 0] = 0.001
    ref = frac.to(dtype) @ cell.T
    u = torch.randn((n, d), generator=g, dtype=torch.float64)
    u = u / u.norm(dim=1, keepdim=True)
    ratio = 0.98 + 0.04 * torch.rand((n, 1), generator=g,
                                     dtype=torch.float64)
    disp = (u * ratio * 0.5 * skin).to(dtype)
    pos = ref + disp
    pos = pos - torch.floor(pos @ torch.linalg.inv(cell).T) @ cell.T
    box = (dict(cell=cell.to(cuda), cell_inv=torch.linalg.inv(cell).to(
        cuda)) if form.startswith("cell")
        else dict(lengths=torch.diagonal(cell).contiguous().to(cuda)))
    pos, ref = pos.to(cuda).contiguous(), ref.to(cuda).contiguous()
    disp = disp.to(cuda)
    flags = []
    out = torch.empty((), dtype=torch.bool, device=cuda)
    for i in range(0, n, 16):
        p, r = pos[i:i + 1], ref[i:i + 1]
        mine = draws.rebuild_flag_rows(p, r, skin, out=out, **box)
        plain = draws.rebuild_flag_rows_plain(p, r, skin, box.get("cell"),
                                              box.get("cell_inv"),
                                              box.get("lengths"))
        assert mine is out and bool(mine) == bool(plain), i
        flags.append(bool(mine))
    assert 0 < sum(flags) < len(flags)
    # All rows inside skin/2 but one: the flag follows that one.
    inside = ref + disp * 0.5
    assert not bool(draws.rebuild_flag_rows(inside, ref, skin, **box))
    moved = inside.clone()
    moved[n - 7] = ref[n - 7] + 0.2
    for rows in (inside, moved):
        a = draws.rebuild_flag_rows(rows, ref, skin, **box)
        b = draws.rebuild_flag_rows_plain(rows, ref, skin, box.get("cell"),
                                          box.get("cell_inv"),
                                          box.get("lengths"))
        assert bool(a) == bool(b)
    assert bool(draws.rebuild_flag_rows(moved, ref, skin, **box))


def _rows_view(rows, offset):
    """``rows`` copied into a flat buffer of their dtype at ``offset``
    values: a view whose data_ptr is 16-byte aligned only where the
    offset's bytes are a multiple of 16."""
    n, d = rows.shape
    buf = torch.empty(n * d + offset, dtype=rows.dtype, device=rows.device)
    view = buf[offset:].view(n, d)
    view.copy_(rows)
    assert (view.data_ptr() % 16 == 0) == (
        offset * rows.element_size() % 16 == 0)
    return view


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_rows_grid_follows_the_count(cuda, dtype, d):
    """The particle-order kernels' grid as their library sizes it
    (``philox_draws.rows_grid``): a particle a thread, one block up to one
    block's particles and two past it, never more than the most blocks
    (one wave), never fewer blocks for more rows; the Philox period is the
    fewest particles whose values fill whole 16-byte blocks."""
    from mdtpu_torch.ops import philox_draws as draws
    vector = 16 // torch.empty((), dtype=dtype).element_size()
    g = draws.rows_grid(1, d, dtype)
    assert g.period == {(4, 3): 4, (2, 3): 2, (4, 2): 2,
                        (2, 2): 1}[(vector, d)]
    assert g.blocks == 1 and g.threads % 32 == 0
    block, wave = g.threads, g.threads * g.max_blocks
    edges = draws.rows_edge_counts(d, dtype)
    assert {1, 3, g.period + 1, block - 1, block + 1, wave + 1} <= set(
        edges)
    assert draws.rows_grid(block, d, dtype).blocks == 1
    assert draws.rows_grid(block + 1, d, dtype).blocks == 2
    assert draws.rows_grid(wave, d, dtype).blocks == g.max_blocks
    assert draws.rows_grid(10 * wave, d, dtype).blocks == g.max_blocks
    prev = 1
    for n in sorted(edges + (0, 7 * block + 3)):
        r = draws.rows_grid(n, d, dtype)
        assert prev <= r.blocks == max(1, min(r.max_blocks, -(-n // block)))
        prev = r.blocks


@pytest.mark.parametrize("align", ["aligned", "head", "apart"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_rebuild_flag_rows_at_the_grid_edges(cuda, dtype, d, align):
    """The particle rows' drift test beside
    :func:`test_rebuild_flag_rows_matches_plain`, at the edges of its grid
    (``rows_edge_counts``: 1, 3, one Philox period's particles and its
    neighbours, an odd count, one block's and its neighbours, one wave's
    and past it), on rows at an offset of one value (a data_ptr not
    16-byte aligned), of one and two values (positions and references at
    different alignments) or none: with no particle past skin/2 and with only
    the first row, the last row or the first row of the last Philox period
    past it, by the cell (tilted in 3D) and by the box lengths (the cell's
    diagonal, a view at stride d + 1): the flag equals the plain
    version's, twice alike."""
    from mdtpu_torch.ops import philox_draws as draws
    op, orf = {"aligned": (0, 0), "head": (1, 1), "apart": (1, 2)}[align]
    skin = 0.3
    cell = torch.as_tensor(_particle_cell("tilted" if d == 3 else "2d",
                                          12.0), dtype=dtype).to(cuda)
    cube = torch.eye(d, dtype=dtype, device=cuda) * 12.0
    boxes = (dict(cell=cell, cell_inv=torch.linalg.inv(cell)),
             dict(lengths=torch.diagonal(cube)))
    for n in draws.rows_edge_counts(d, dtype):
        g = torch.Generator(device=cuda).manual_seed(n)
        ref = torch.rand((n, d), device=cuda, generator=g,
                         dtype=torch.float64) * 12.0
        disp = (torch.rand((n, d), device=cuda, generator=g,
                           dtype=torch.float64) - 0.5) * 0.1
        period = draws.rows_grid(n, d, dtype).period
        last = (n - 1) // period * period
        for hit in (None, 0, n - 1, last):
            moved = disp.clone()
            if hit is not None:
                moved[hit] = 0.2
            r = _rows_view(ref.to(dtype), orf)
            p = _rows_view((ref + moved).to(dtype), op)
            for box in boxes:
                plain_box = (box.get("cell"), box.get("cell_inv"),
                             box.get("lengths"))
                a = draws.rebuild_flag_rows(p, r, skin, **box)
                again = draws.rebuild_flag_rows(p, r, skin, **box)
                b = draws.rebuild_flag_rows_plain(p, r, skin, *plain_box)
                assert bool(a) == bool(b) == bool(again) == (
                    hit is not None), (n, hit, list(box))


@pytest.mark.parametrize("align", ["aligned", "head"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_brownian_rows_at_the_grid_edges(cuda, dtype, d, align):
    """The particle rows' Brownian move beside
    :func:`test_brownian_rows_matches_plain_bit_for_bit`, at the edges of
    its grid (``rows_edge_counts``), on forces, positions, compensation
    and images at an offset of one value (data_ptrs not 16-byte aligned)
    or none, compensated and not, into new
    tensors and in place: bit for bit the plain version, twice alike."""
    import types

    from mdtpu_torch.integrate import verlet_update as vu
    from mdtpu_torch.ops import philox_draws as draws
    off = 0 if align == "aligned" else 1
    coeffs = vu.brownian_coefficients(1e-3, 1.3, dtype)
    w = torch.tensor(-1234.5, dtype=dtype, device=cuda)
    for n in draws.rows_edge_counts(d, dtype):
        (f, _, _, x, xc), images, c, ci = _particle_rows(
            "tilted" if d == 3 else "2d", dtype, cuda, n=n, seed=n)

        def state_of(step):
            return types.SimpleNamespace(
                positions=_rows_view(x, off), pos_comp=_rows_view(xc, off),
                images=_rows_view(images, off), unitcell=c,
                unitcell_inv=ci, seed=3, step=step, dtype=dtype,
                device=x.device,
                virial_accum=torch.tensor(2.5, dtype=dtype, device=cuda),
                nprom=torch.tensor(4, device=cuda),
                temperature=torch.tensor(0.0, dtype=dtype, device=cuda))

        fv = _rows_view(f, off)
        for comp in (True, False):
            st = state_of(torch.tensor(2 ** 33 + 10, device=cuda))
            want = vu.brownian_rows_plain(fv, w, st, *coeffs, comp)
            got = vu.brownian_rows(fv, w, st, *coeffs, comp)
            again = vu.brownian_rows(fv, w, st, *coeffs, comp)
            for a, b, r in zip(got[:3] + got[4:], want,
                               again[:3] + again[4:]):
                assert torch.equal(a, b) and torch.equal(a, r), (n, comp)
            st = state_of(torch.tensor(2 ** 33 + 10, device=cuda))
            vu.brownian_rows(fv, w, st, *coeffs, comp, in_place=True)
            mine = (st.positions, st.pos_comp, st.images, st.virial_accum,
                    st.nprom, st.temperature)
            for i, (a, b) in enumerate(zip(mine, want)):
                if comp or i != 1:
                    assert torch.equal(a, b), (n, comp, i)
            assert int(st.step) == 2 ** 33 + 11


def _particle_case(name, device):
    """A particle-order start on the card (20,000 particles, Brownian
    8,000, the naive engine 2,000): its state
    with engine state and forces, engine, params, ensemble, compensated,
    hilo."""
    from mdtpu_torch.ops.naive import NaivePairEngine
    brown = name.startswith("brownian")
    # The Brownian lattice's spacing at 8,000 (1.26) keeps every start
    # pair past 0.9, so the first moves stay small.
    n = 8000 if brown else 20000
    dtype = torch.float64 if name.endswith("f64") else torch.float32
    # A Brownian run moves less: a smaller skin rebuilds within 50 steps.
    if brown:
        pot, cutoff, rho, dt, skin = PseudoHS(), 1.5, 0.5, 1e-5, 0.1
    else:
        pot, cutoff, rho, dt, skin = LennardJones(r_cut=2.5), 2.5, 0.8, \
            0.004, 0.3
    st = lattice_fluid_state(n, rho, 1.2, dtype=dtype, cutoff=cutoff,
                             jitter=0.05, device=device)
    if name.startswith("neighbor"):
        eng = mdtpu_torch.NeighborListEngine.create(pot, cutoff, skin,
                                                    st.unitcell, n)
    elif name.startswith("naive"):
        n = 2000
        st = lattice_fluid_state(n, rho, 1.2, dtype=dtype, cutoff=cutoff,
                                 jitter=0.05, device=device)
        eng = NaivePairEngine(pot, cutoff)
    elif name.startswith("cellgrid"):
        eng = CellGridEngine.create(pot, cutoff, skin, st.unitcell, n)
    else:
        eng = PlaneEngine.create(pot, cutoff, skin, st.unitcell, n)
    ens = (mdtpu_torch.Brownian(1.0) if brown else mdtpu_torch.NVE()
           if "nve" in name else mdtpu_torch.NVT(1.2, 0.4))
    compensated = not (name.startswith("cellgrid") or name == "plane_nvt")
    hilo = "hilo" in name
    params = mdtpu_torch.Parameters(rho, n, dt, pot)
    nbrs = eng.allocate(st.positions, st.diameters, st.unitcell,
                        st.unitcell_inv)
    if not brown:
        e, w, f, nbrs = eng.compute(st.positions, st.diameters, st.unitcell,
                                    st.unitcell_inv, nbrs)
        st = st.replace(forces=f, energy=e, virial=w)
    return st.replace(nbrs=nbrs), eng, params, ens, compensated, hilo


PARTICLE_CASES = ("plane_nvt", "plane_nve_hilo", "neighbor_nvt",
                  "neighbor_nve_f64", "naive_nvt", "cellgrid_nvt",
                  "brownian_plane", "brownian_cellgrid_f64")


@pytest.mark.parametrize("case", PARTICLE_CASES)
def test_captured_particle_advance_equals_eager(cuda, case):
    """The particle-order advance captured (one graph launch a segment) and
    eager (the flag read on the host), 50 steps in segments with at least
    one rebuild: positions, velocities, forces, images, energy, virial,
    every segment's numbers and the rebuild steps bit for bit; the
    captured step's nodes (the drift test and the IF node where the engine
    tests; no memset) and its launches counted at every replay."""
    from mdtpu_torch.integrate import step as tstep
    from mdtpu_torch.integrate import verlet_update as vu
    from mdtpu_torch.ops import neighbor_list as nl
    from mdtpu_torch.utils import counters
    st, eng, params, ens, comp, hilo = _particle_case(case, cuda)
    out = {}
    for graph in (False, None):
        advance = tstep.make_particle_advance(params, ens, eng, comp,
                                              hilo=hilo, graph=graph)
        counters.settle()
        moves0 = vu.kick_drift_wrap.launches + vu.brownian_rows.launches
        builds0 = nl.nl_build.launches
        s, rows = st, []
        for k in (1, 9, 25, 15):
            s = advance(s, k)
            rows.append(torch.stack([s.energy, s.virial, s.temperature,
                                     s.virial_accum]).cpu())
        counters.settle()
        moves = vu.kick_drift_wrap.launches + vu.brownian_rows.launches
        assert moves - moves0 == 50
        assert advance.graph is (graph is None)
        # A captured rebuild's launches count where its branch was taken.
        assert nl.nl_build.launches - builds0 == (
            len(advance.rebuild_steps()) if case.startswith("neighbor")
            else 0)
        out[graph] = (s, torch.stack(rows), advance.rebuild_steps(),
                      advance.census)
    (se, re, be, _), (sg, rg, bg, census) = out[False], out[None]
    assert torch.equal(re, rg) and be == bg
    if not case.startswith("naive"):
        assert len(be) >= 1
    for name in ("positions", "velocities", "forces", "images", "pos_comp",
                 "vel_comp", "nprom"):
        assert torch.equal(getattr(se, name), getattr(sg, name)), name
    nodes = census["step"]
    tests = 0 if case.startswith("naive") else 1
    assert nodes["conditionals"] == nodes["rebuild_rows"] == tests, nodes
    assert nodes["rebuild_flag"] == 0 and nodes["unreadable"] == 0, nodes
    moves = (nodes["brownian_rows"] if case.startswith("brownian")
             else nodes["kick_drift_wrap"])
    assert moves == 1 and nodes["uniform_noise"] == 0, nodes


def test_captured_steps_keep_the_reference_of_the_last_build(cuda):
    """After captured in-place steps, the buffers' reference positions are
    a tensor of their own: a step that does not rebuild leaves them as
    they were and moves the positions."""
    from mdtpu_torch.integrate import step as tstep
    st, eng, params, ens, comp, hilo = _particle_case("neighbor_nvt", cuda)
    advance = tstep.make_particle_advance(params, ens, eng, comp)
    s = advance(st, 20)
    b = advance.bufs
    assert advance.graph and len(advance.rebuild_steps()) >= 1
    assert b.nbrs.ref_positions.data_ptr() != b.positions.data_ptr()
    for _ in range(10):
        ref, pos = b.nbrs.ref_positions.clone(), b.positions.clone()
        count = int(advance.rebuilds)
        s = advance(s, 1)
        if int(advance.rebuilds) == count:
            assert torch.equal(b.nbrs.ref_positions, ref)
            assert not torch.equal(b.positions, pos)
            return
    pytest.fail("every step rebuilt")


@pytest.mark.parametrize("case", ["positive", "negative", "grow", "rest",
                                  "overflow"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("layout", ["slots", "rows"])
def test_fire_kernels_match_their_plain_versions(cuda, dtype, layout, case):
    """FIRE's three kernels (``minimize/fire_update.py``) on one set of
    buffers against their plain versions, at the bench_fire shapes (the
    slots' grid has a ragged last block), in every branch: the power
    positive, negative, positive past n_min with ~1e25 forces (the one-pass
    rescaling) and dt clamped at dt_max, at rest (v = F = 0), and with the
    overflow flag set. ``fire_reduce`` in one pass and split as the shard
    ring launches it (every scalar to rel 1e-12 at f64, 2e-6 at f32;
    do_mix, positive and the counters equal), ``fire_move`` (positions,
    velocities, and in rows the images after the wrap), ``fire_test`` in
    one pass and split (f_rms, the step and the flags), each twice bit for
    bit."""
    from mdtpu_torch.minimize import fire_update as fu
    tol = 1e-12 if dtype == torch.float64 else 2e-6
    shape = (3, 124875) if layout == "slots" else (65536, 3)
    g = torch.Generator(device=cuda).manual_seed(4)
    f = torch.randn(shape, device=cuda, generator=g) * 30
    v = torch.randn(shape, device=cuda, generator=g)
    x = (torch.rand(shape, device=cuda, generator=g) * 20).to(dtype)
    if case == "grow":
        f = f * (1e25 / 30)
    v = -v - 0.05 * f if case == "negative" else v + 0.01 * f
    if case == "rest":
        v, f = torch.zeros_like(v), torch.zeros_like(f)
    f, v = f.to(dtype), v.to(dtype)
    box = {}
    if layout == "rows":
        cell = torch.eye(3, dtype=dtype, device=cuda) * 20.1
        box = dict(images=torch.zeros(shape, dtype=torch.int64, device=cuda),
                   cell=cell, cell_inv=torch.linalg.inv(cell))
    over = torch.tensor(case == "overflow", device=cuda)
    hyper = fu.FireHyper()
    bufs = fu.buffers(dtype, cuda, f.numel())
    bufs[0][fu.DT] = 0.09 if case == "grow" else 0.03
    bufs[0][fu.ALPHA], bufs[0][fu.TOL] = 0.07, 1e-3
    bufs[1][fu.SSN], bufs[1][fu.MAX_STEPS] = (7 if case == "grow" else 2), 10
    ring = (fu.MAXIMA, fu.SUMS, fu.TAIL)

    def copies(of):
        return [t.clone() for t in of]

    def close(a, b):
        a, b = a.double(), b.double()
        return bool(((a - b).abs() <= tol * b.abs()).all())

    plain = copies(bufs)
    fu.fire_reduce_plain(v, f, plain[0], plain[1], plain[2][:fu.RED], hyper,
                         over)
    if case == "grow":
        assert float(plain[0][fu.DT]) == pytest.approx(hyper.dt_max)
    for modes in ((fu.ONE_PASS,), ring):
        runs = [copies(bufs), copies(bufs)]
        for k in runs:
            for mode in modes:
                fu.fire_reduce(v, f, k[0], k[1], k[2][:fu.RED], k[3], hyper,
                               over, mode=mode)
        assert torch.equal(runs[0][0], runs[1][0])
        assert close(runs[0][0], plain[0]) and close(runs[0][2], plain[2])
        assert torch.equal(runs[0][1], plain[1])
    outs = []
    for move in (fu.fire_move, fu.fire_move, fu.fire_move_plain):
        xs, vs = x.clone(), v.clone()
        b = {k: (t.clone() if k == "images" else t) for k, t in box.items()}
        if move is fu.fire_move_plain:
            move(xs, vs, f, plain[0], plain[1], hyper.dmax,
                 layout == "rows", *b.values(), overflow=over)
        else:
            move(xs, vs, f, plain[0], plain[1], hyper.dmax,
                 rows=layout == "rows", overflow=over, **b)
        outs.append((xs, vs, b.get("images")))
    for a, b in zip(outs[0], outs[1]):
        assert a is None or torch.equal(a, b)
    for a, b in zip(outs[0][:2], outs[2][:2]):
        assert bool(((a - b).abs() <= tol * b.abs().max()).all())
    if layout == "rows":
        assert torch.equal(outs[0][2], outs[2][2])
    tested = copies(plain)
    fu.fire_test_plain(f, tested[0], tested[1], tested[2][fu.RED:], 17.0,
                       tested[4], overflow=over)
    for modes in ((fu.ONE_PASS,), ring):
        runs = [copies(plain), copies(plain)]
        for k in runs:
            for mode in modes:
                fu.fire_test(f, k[0], k[1], k[2][fu.RED:], k[3], 17.0, k[4],
                             overflow=over, mode=mode)
        assert torch.equal(runs[0][0], runs[1][0])
        assert close(runs[0][0], tested[0])
        assert torch.equal(runs[0][1], tested[1])
        assert torch.equal(runs[0][4], tested[4])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_fire_reduction_grid_follows_the_count(cuda, dtype):
    """The reductions' grid as the kernels' library sizes it
    (``fire_update.reduce_grid``): one block up to one block's count, two
    past it, at most the wave's blocks past the wave's count, never fewer
    blocks for more values; ``work`` holds the ticket and five partials a
    block, ``buffers`` sizes it so, and a launch on a shorter ``work``
    raises."""
    from mdtpu_torch.minimize import fire_update as fu
    g = fu.reduce_grid(1, dtype)
    assert g.vector == 16 // torch.empty((), dtype=dtype).element_size()
    one, wave = g.block_values, g.wave_values
    edges = fu.edge_counts(dtype)
    assert edges[:7] == (1, 3, one - 1, one, one + 1, one + g.vector, 9999)
    assert edges[7:] == (wave, wave + 1, wave + g.vector)
    blocks = [fu.reduce_grid(n, dtype).blocks for n in edges]
    most = fu.reduce_grid(10 * wave, dtype).blocks
    assert blocks[:5] == [1] * 5 and blocks[5] == 2
    assert 2 < blocks[6] < most and blocks[7:] == [most] * 3
    assert wave % (most * g.vector) == 0
    prev = 0
    for n in range(0, 40 * one, one // 3):
        r = fu.reduce_grid(n, dtype)
        assert prev <= r.blocks <= most and r.blocks >= 1
        assert r.work == 1 + 5 * r.blocks
        prev = r.blocks
    n = 3 * one + 5
    scal, ints, red, work, flags = fu.buffers(dtype, cuda, n)
    assert work.numel() == fu.reduce_grid(n, dtype).work and not work.any()
    f = torch.ones(n, dtype=dtype, device=cuda)
    fu.fire_test(f, scal, ints, red[fu.RED:], work, 1.0, flags)
    with pytest.raises(RuntimeError):
        fu.fire_test(f, scal, ints, red[fu.RED:], work[:-1], 1.0, flags)
    with pytest.raises(RuntimeError):
        fu.fire_reduce(f, f, scal, ints, red[:fu.RED], work[:-1],
                       fu.FireHyper())


@pytest.mark.parametrize("align", ["aligned", "head", "apart"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_fire_reductions_match_their_plain_versions_at_the_grid_edges(
        cuda, dtype, align):
    """``fire_reduce`` and ``fire_test`` beside
    :func:`test_fire_kernels_match_their_plain_versions`, at the edges of
    their grid (1, 3, one block's count and its neighbours, an odd count,
    one wave's count and past it), on views of v and F at an offset of
    one value (a data_ptr not 16-byte aligned: a scalar head), of one and
    two values (misaligned apart: scalar loads) or none, in every case:
    one pass and split against the plain versions (rel 1e-12 at f64, 2e-6
    at f32; counters and flags equal), each twice bit for bit."""
    from mdtpu_torch.minimize import fire_update as fu
    tol = 1e-12 if dtype == torch.float64 else 2e-6
    of, ov = {"aligned": (0, 0), "head": (1, 1), "apart": (1, 2)}[align]
    hyper = fu.FireHyper()
    ring = (fu.MAXIMA, fu.SUMS, fu.TAIL)

    def copies(of_):
        return [t.clone() for t in of_]

    def close(a, b):
        a, b = a.double(), b.double()
        return bool(((a - b).abs() <= tol * b.abs()).all())

    for n in fu.edge_counts(dtype):
        for case in ("positive", "negative", "grow", "rest", "overflow"):
            g = torch.Generator(device=cuda).manual_seed(n)
            f = torch.randn(n + 2, device=cuda, generator=g) * 30
            v = torch.randn(n + 2, device=cuda, generator=g)
            if case == "grow":
                f = f * (1e25 / 30)
            v = -v - 0.05 * f if case == "negative" else v + 0.01 * f
            if case == "rest":
                v, f = torch.zeros_like(v), torch.zeros_like(f)
            f, v = f.to(dtype)[of:of + n], v.to(dtype)[ov:ov + n]
            assert (f.data_ptr() % 16 == 0) == (of == 0)
            over = torch.tensor(case == "overflow", device=cuda)
            bufs = fu.buffers(dtype, cuda, n)
            bufs[0][fu.DT] = 0.09 if case == "grow" else 0.03
            bufs[0][fu.ALPHA], bufs[0][fu.TOL] = 0.07, 1e-3
            bufs[1][fu.SSN] = 7 if case == "grow" else 2
            bufs[1][fu.MAX_STEPS] = 10
            plain = copies(bufs)
            fu.fire_reduce_plain(v, f, plain[0], plain[1], plain[2][:fu.RED],
                                 hyper, over)
            for modes in ((fu.ONE_PASS,), ring):
                runs = [copies(bufs), copies(bufs)]
                for k in runs:
                    for mode in modes:
                        fu.fire_reduce(v, f, k[0], k[1], k[2][:fu.RED], k[3],
                                       hyper, over, mode=mode)
                assert torch.equal(runs[0][0], runs[1][0])
                assert torch.equal(runs[0][2], runs[1][2])
                assert close(runs[0][0], plain[0]), (n, case)
                assert close(runs[0][2], plain[2]), (n, case)
                assert torch.equal(runs[0][1], plain[1])
            tested = copies(plain)
            fu.fire_test_plain(f, tested[0], tested[1], tested[2][fu.RED:],
                               17.0, tested[4], overflow=over)
            for modes in ((fu.ONE_PASS,), ring):
                runs = [copies(plain), copies(plain)]
                for k in runs:
                    for mode in modes:
                        fu.fire_test(f, k[0], k[1], k[2][fu.RED:], k[3], 17.0,
                                     k[4], overflow=over, mode=mode)
                assert torch.equal(runs[0][0], runs[1][0])
                assert close(runs[0][0], tested[0]), (n, case)
                assert torch.equal(runs[0][1], tested[1])
                assert torch.equal(runs[0][4], tested[4])


# The move's cases: (dimension, particle rows) by layout, and counts at the
# edges of its grid (one block, past it; rows: past one wave of 512 blocks)
# beside the bench_fire shapes.
MOVE_LAYOUTS = {"slots": (3, False), "rows": (3, True),
                "slots_2d": (2, False), "rows_2d": (2, True)}
MOVE_COUNTS = {False: (124875, 1, 255, 257), True: (65536, 1, 257, 131073)}


def _move_inputs(cuda, case, dim, rows, n, dtype):
    """``(x, v, f, scal, ints, box, overflow)`` for one move, the scalars
    set by hand: positive with the mix (also with non-finite forces, whose
    displacements the guards drop), not positive, a step whose
    displacements pass dmax, and the overflow flag set."""
    from mdtpu_torch.minimize import fire_update as fu
    shape = (n, dim) if rows else (dim, n)
    g = torch.Generator(device=cuda).manual_seed(n + dim)
    f = torch.randn(shape, device=cuda, generator=g, dtype=torch.float64)
    v = torch.randn(shape, device=cuda, generator=g, dtype=torch.float64)
    x = torch.rand(shape, device=cuda, generator=g, dtype=torch.float64)
    if case == "past_dmax":
        v = v * 16
    if case == "nonfinite":
        flat = f.view(-1)
        flat[::7] = float("inf")
        flat[3::11] = float("nan")
        flat[5::13] = -float("inf")
    f, v, x = (t.to(dtype) for t in (f * 30, v, x * 20.0))
    scal, ints, _, _, _ = fu.buffers(dtype, cuda, f.numel())
    scal[fu.DT_KICK], scal[fu.DT] = 0.03, 0.036
    scal[fu.MIX_V], scal[fu.MIX_F] = 0.93, 0.0021
    ints[fu.DO_MIX] = int(case != "negative")
    ints[fu.POSITIVE] = int(case != "negative")
    box = {}
    if rows:
        cell = torch.eye(dim, dtype=dtype, device=cuda) * 20.1
        cell[0, 1] = 2.5 if dim == 3 else 0.0
        box = dict(images=torch.randint(-3, 3, shape, device=cuda,
                                        generator=g),
                   cell=cell, cell_inv=torch.linalg.inv(cell))
    over = torch.tensor(case == "overflow", device=cuda)
    return x, v, f, scal, ints, box, over


@pytest.mark.parametrize("case", ["positive", "negative", "past_dmax",
                                  "nonfinite", "overflow"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("layout", list(MOVE_LAYOUTS))
def test_fire_move_matches_its_plain_version_bit_for_bit(cuda, layout,
                                                         dtype, case):
    """``fire_move`` bit for bit its plain version on the card (positions,
    velocities, and in rows the images after the wrap in a tilted box), in
    slots and rows, 3D and 2D, at the bench_fire shapes and the edges of
    its grids, in every branch: positive with the mix, not positive,
    displacements past dmax, non-finite forces, the overflow flag set
    (nothing written). Launched twice after a kernel that does not touch
    its inputs, and as a programmatic dependent of a ``fire_reduce`` over
    the same v and F into buffers of its own: every launch the same
    bits."""
    from mdtpu_torch.minimize import fire_update as fu
    dim, rows = MOVE_LAYOUTS[layout]
    for n in MOVE_COUNTS[rows]:
        x, v, f, scal, ints, box, over = _move_inputs(cuda, case, dim, rows,
                                                      n, dtype)
        images = box.pop("images", None)
        outs = []
        for way in ("plain", "kernel", "kernel", "after_reduce"):
            xs, vs = x.clone(), v.clone()
            img = None if images is None else images.clone()
            if way == "plain":
                fu.fire_move_plain(xs, vs, f, scal, ints, 0.1, rows, img,
                                   *box.values(), overflow=over)
            else:
                if way == "after_reduce":
                    rs, ri, red, work, _ = fu.buffers(dtype, cuda,
                                                      f.numel())
                    fu.fire_reduce(vs, f, rs, ri, red[:fu.RED], work,
                                   fu.FireHyper())
                fu.fire_move(xs, vs, f, scal, ints, 0.1, rows=rows,
                             images=img, overflow=over, **box)
            outs.append((xs, vs, img))
        torch.cuda.synchronize()
        if case == "overflow":
            assert torch.equal(outs[1][0], x) and torch.equal(outs[1][1], v)
        for out in outs[1:]:
            for got, want in zip(out, outs[0]):
                if want is not None:
                    assert got.dtype == want.dtype
                    assert torch.equal(torch.nan_to_num(got),
                                       torch.nan_to_num(want)), (n, way)
                    assert torch.equal(got.isnan(), want.isnan())


@pytest.mark.parametrize("captured", [False, True],
                         ids=["eager", "captured"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("layout", list(MOVE_LAYOUTS))
def test_fire_move_reads_the_scalars_a_reduction_just_wrote(
        cuda, layout, dtype, captured):
    """The FIRE loops' order: ``fire_reduce`` in one pass writes the very
    ``scal`` and ``ints`` the move then reads (its kick's dt, dt, the mix,
    do_mix, positive), and the move is launched at once as its
    programmatic dependent, eager or replayed from a CUDA graph, ten
    times from one start. Positions, velocities and images equal, bit
    for bit, those of the same reduction, a synchronize, then the move.
    The scalars before the reduction (zero: no mix, not positive) give
    other positions and velocities, so a move that read them before its
    wait would differ."""
    from mdtpu_torch.minimize import fire_update as fu
    dim, rows = MOVE_LAYOUTS[layout]
    n = MOVE_COUNTS[rows][0]
    x, v, f, _, _, box, _ = _move_inputs(cuda, "positive", dim, rows, n,
                                         dtype)
    v = v + 0.05 * f          # the power positive: the reduction mixes
    images = box.pop("images", None)
    hyper = fu.FireHyper()
    start = fu.buffers(dtype, cuda, f.numel())[:4]
    start[0][fu.DT], start[0][fu.ALPHA] = 0.02, 0.1
    start[1][fu.SSN] = 6
    first = start + (x, v, images)
    state = [None if t is None else t.clone() for t in first]

    def reset():
        for t, t0 in zip(state, first):
            if t is not None:
                t.copy_(t0)

    def pair(settle=False):
        scal, ints, red, work, xs, vs, img = state
        fu.fire_reduce(vs, f, scal, ints, red[:fu.RED], work, hyper)
        if settle:
            torch.cuda.synchronize()
        fu.fire_move(xs, vs, f, scal, ints, hyper.dmax, rows=rows,
                     images=img, **box)

    def outputs():
        return [None if t is None else t.clone() for t in state[4:]]

    reset()
    pair(settle=True)
    want = outputs()
    assert not torch.equal(want[0], x)
    stale = [None if t is None else t.clone() for t in (x, v, images)]
    fu.fire_move(stale[0], stale[1], f, start[0].clone(), start[1].clone(),
                 hyper.dmax, rows=rows, images=stale[2], **box)
    assert not torch.equal(stale[0], want[0])
    assert not torch.equal(stale[1], want[1])
    graph = None
    if captured:
        reset()
        pair()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            pair()
    for _ in range(10):
        reset()
        if graph is None:
            pair()
        else:
            graph.replay()
        torch.cuda.synchronize()
        for got, w in zip(outputs(), want):
            if w is not None:
                assert torch.equal(got, w)


@pytest.mark.parametrize("kind", ["slots", "list", "plane"])
def test_captured_fire_equals_eager(cuda, kind):
    """FIRE as one CUDA-graph launch a minimization against FIRE eager
    (``graph=False``) from one start (4096 LJ on the bench's jittered
    lattice, f32): positions, FIRE's velocities, forces, energy, n_steps
    and the rebuild steps bit for bit, for 15 and then 60 iterations (the
    second call replays the first's graph), with rebuilds; in slots a
    captured pass holds the nested IF node and no copy; every captured
    pass takes a programmatic edge into the move (slots, particle order on
    the list and on ``PlaneEngine``)."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.minimize import fire as fire_mod
    n = 4096
    pot = LennardJones(r_cut=2.5)
    state = lattice_fluid_state(n, 0.8, 1.0, dtype=torch.float32, cutoff=2.5,
                                jitter=JITTER, device=cuda)
    if kind == "slots":
        eng = CellGridEngine.create(pot, 2.5, 0.3, state.unitcell, n)
        start = slot_step.slotify(state, eng)
    else:
        eng = (PlaneEngine.create(pot, 2.5, 0.3, state.unitcell, n)
               if kind == "plane" else
               mdtpu_torch.select_engine(pot, 2.5, state, prefer="neighbor"))
        start = state.replace(nbrs=eng.allocate(
            state.positions, state.diameters, state.unitcell,
            state.unitcell_inv))
    out = {}
    for graph in (False, None):
        runs = []
        for max_steps in (15, 60):
            if kind == "slots":
                run = fire_mod.make_slot_fire(eng, max_steps=max_steps,
                                              tol=0.0, graph=graph)
                st, _, _, steps, ovf = run(start)
                fire, v = run.fire, st.velocities
            else:
                run = fire_mod.make_row_fire(eng, max_steps=max_steps,
                                             tol=0.0, graph=graph)
                st, _, _, steps = run(start)
                fire, v, ovf = run.fire, run.fire.bufs[1].v, False
            assert steps == max_steps and not ovf
            runs.append((st, v.clone(), fire.rebuild_steps()))
        out[graph] = (runs, fire)
    for (se, ve, re), (sg, vg, rg) in zip(out[False][0], out[None][0]):
        for name in ("positions", "forces", "energy", "virial"):
            assert torch.equal(getattr(se, name), getattr(sg, name)), name
        assert torch.equal(ve, vg) and re == rg
    assert len(out[None][0][-1][2]) >= 2
    fire = out[None][1]
    assert fire.captured is not None and out[False][1].captured is None
    assert fire.census["pass"]["conditionals"] == 1
    assert fire.census["pass"]["memsets"] == 0
    assert fire.census["pass"]["programmatic_into_fire_move"] >= 1
    assert fire.census["pass"]["fire_edges_error"] == 0
    if kind == "slots":
        assert fire.census["pass"]["copies"] == 0


def test_captured_segment_is_one_launch_a_variant(cuda):
    """A captured slot segment is one graph launch a step variant (the
    WHILE node loops the steps), whatever its length, and the loop test
    launches once a step and once a segment variant."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.ops import philox_draws as draws
    from mdtpu_torch.utils import counters
    n = 4096
    pot = LennardJones(r_cut=2.5)
    params = mdtpu_torch.Parameters(0.8, n, 0.002, pot)
    state = lattice_fluid_state(n, 0.8, 1.0, dtype=torch.float32, cutoff=2.5,
                                jitter=JITTER, device=cuda)
    eng = CellGridEngine.create(pot, 2.5, 0.3, state.unitcell, n)
    slots = slot_step.slot_forces(slot_step.slotify(state, eng), eng)
    advance = slot_step.make_slot_advance(params, mdtpu_torch.NVT(1.0, 0.4),
                                          eng)
    s = advance(slots, 3)
    replays = []
    for name, (graph, *_rest) in advance.graphs.items():
        real = graph.replay
        graph.replay = (lambda real=real, name=name:
                        replays.append(name) or real())
    counters.settle()
    before = draws.step_below.launches
    s = advance(s, 40)
    counters.settle()
    assert replays == ["lean", "last"]
    assert draws.step_below.launches - before == 40 + 2
    assert s.step == 43


# --------------------------------------------------------------------------
# The sharded route's loops on the device (a ring of one on the card).


def test_rebuild_vote_matches_its_plain_version(cuda):
    """The sharded segment's rebuild decision: the flag of every vote and
    counter its plain version's, one launch a call."""
    from mdtpu_torch.ops import philox_draws as draws
    votes = torch.zeros((), dtype=torch.int32, device=cuda)
    counter = torch.zeros((), dtype=torch.int64, device=cuda)
    first = torch.full((), 7, dtype=torch.int64, device=cuda)
    flag = torch.zeros((), dtype=torch.bool, device=cuda)
    before = draws.rebuild_vote.launches
    cases = [(0, 7), (0, 8), (1, 8), (5, 7), (-1, 6)]
    for vote, at in cases:
        votes.fill_(vote)
        counter.fill_(at)
        draws.rebuild_vote(votes, counter, first, flag)
        assert bool(flag) == bool(draws.rebuild_vote_plain(votes, counter,
                                                           first))
    assert draws.rebuild_vote.launches - before == len(cases)
    with pytest.raises(ValueError, match="int32 vote"):
        draws.rebuild_vote(votes.long(), counter, first, flag)


def _sharded_start(cuda, n=4096):
    from mdtpu_torch.parallel import HaloSlotEngine, ShardRing
    from mdtpu_torch.parallel.driver import build_grown
    pot = LennardJones(r_cut=2.5)
    state = lattice_fluid_state(n, 0.8, 1.0, dtype=torch.float32, cutoff=2.5,
                                jitter=JITTER, device=cuda)
    eng = HaloSlotEngine.create(pot, 2.5, state.unitcell, n,
                                ShardRing(device=cuda))
    sh, eng = build_grown(state, eng)
    return sh, eng, mdtpu_torch.Parameters(0.8, n, 0.002, pot)


def test_sharded_advance_captured_matches_eager(cuda):
    """The sharded advance on a ring of one: captured (one graph launch a
    step variant) against eager from one start over two segments, every
    tensor and the rebuild steps bit for bit; the lean step's graph tests,
    votes and rebuilds in one IF node, the last step's rebuilds with no
    IF node."""
    from mdtpu_torch.parallel.halo_slot import make_sharded_slot_advance
    sh, eng, params = _sharded_start(cuda)
    out = {}
    for graph in (False, None):
        advance = make_sharded_slot_advance(params, mdtpu_torch.NVT(1.0, 0.4),
                                            eng, graph=graph)
        s = advance(advance(sh, 13), 40)
        out[graph] = (s, advance.rebuild_steps(), advance)
    (e, e_reb, eager), (g, g_reb, captured) = out[False], out[None]
    assert eager.graph is False and captured.graph is True
    assert g.step == e.step == sh.step + 53
    for name in ("positions", "velocities", "forces", "energy", "virial",
                 "temperature"):
        assert torch.equal(getattr(g, name), getattr(e, name)), name
    assert g_reb == e_reb and len(g_reb) > 4
    lean, last = captured.census["lean"], captured.census["last"]
    assert (lean["rebuild_flag"], lean["rebuild_vote"],
            lean["conditionals"], lean["memsets"]) == (1, 1, 1, 0)
    assert (last["rebuild_flag"], last["rebuild_vote"],
            last["conditionals"]) == (0, 0, 0)
    replays = []
    for name, (graph, *_rest) in captured.graphs.items():
        real = graph.replay
        graph.replay = (lambda real=real, name=name:
                        replays.append(name) or real())
    captured(g, 20)
    assert replays == ["lean", "last"]


def test_sharded_fire_captured_matches_eager(cuda):
    """The sharded FIRE on a ring of one: one graph launch a minimization
    against the eager run from one start, state and rebuild steps bit for
    bit."""
    from mdtpu_torch.minimize.fire import make_slot_fire
    sh, eng, _ = _sharded_start(cuda)
    out = {}
    for graph in (False, None):
        run = make_slot_fire(eng, ring=eng.ring, max_steps=60, tol=0.0,
                             graph=graph, cached=False)
        st, _, _, n, ovf = run(sh)
        out[graph] = (st, n, ovf, run.fire)
    (e, e_n, e_ovf, eager), (g, g_n, g_ovf, captured) = out[False], out[None]
    assert captured.captured is not None and eager.captured is None
    assert e_n == g_n == 60 and not e_ovf and not g_ovf
    for name in ("positions", "velocities", "forces", "energy", "virial"):
        assert torch.equal(getattr(g, name), getattr(e, name)), name
    assert captured.rebuild_steps() == eager.rebuild_steps()
    assert captured.census["pass"]["conditionals"] == 1
    assert captured.census["pass"]["programmatic_into_fire_move"] >= 1


# --------------------------------------------------------------------------
# A user potential's routes captured: config 4's potential (the pair list in
# slots, the naive engine, the neighbour list's tiles), captured against
# graph=False bit for bit; a potential that breaks the capture contract.


def _user_start(device, n, seed=9):
    """Config 4's density and diameters (rho 0.9, U(0.8, 1.2), f64) on a
    2D lattice jittered by 0.05, velocities at T = 0.5."""
    from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                                initialize_velocities,
                                                lattice_positions)
    L = (n / 0.9) ** 0.5
    cell = torch.eye(2, dtype=torch.float64) * L
    diam = 0.8 + 0.4 * torch.rand(n, generator=torch.Generator()
                                  .manual_seed(seed), dtype=torch.float64)
    pos = lattice_positions(n, cell, 2, dtype=torch.float64, jitter=0.05,
                            seed=seed, device=device)
    state = build_state_from_arrays(pos, diam, cell, dtype=torch.float64,
                                    cutoff=1.8, device=device)
    return state.replace(velocities=initialize_velocities(
        0.5, seed, n, 2, dtype=torch.float64, device=device))


def test_captured_user_slot_advance_is_one_launch_a_variant(cuda):
    """Config 4's NVT in slots (the pair list, lean and full steps):
    captured against eager over three segments, every array and the
    rebuild steps bit for bit; a captured segment is one replay a step
    variant; the list's and the reduction's launches are counted at every
    replay as eagerly (one list and one reduction a step, the full ones
    at the segments' last steps)."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.utils import counters
    n = 4096
    params = mdtpu_torch.Parameters(0.9, n, 1e-3, NonAdditivePHS())
    state = _user_start(cuda, n)
    eng = CellGridEngine.create(params.potential, 1.8, 0.1, state.unitcell,
                                n)
    slots, eng = slot_step.slotify_grown(state, eng)
    slots = slot_step.slot_forces(slots, eng)
    out = {}
    for graph in (False, None):
        advance = slot_step.make_slot_advance(
            params, mdtpu_torch.NVT(0.5, 0.01), eng, graph=graph)
        counters.settle()
        pairs_mod.reset_launches()
        s = advance(advance(advance(slots, 1), 19), 20)
        counters.settle()
        launches = (pairs_mod.pair_list.launches,
                    pairs_mod.pair_reduce.launches,
                    pairs_mod.pair_reduce.lean_launches)
        out[graph] = (s, advance.rebuild_steps(), launches, advance)
    (e, e_reb, e_n, _), (g, g_reb, g_n, captured) = out[False], out[None]
    assert captured.graph is True and g.step == e.step == slots.step + 40
    for name in ("positions", "velocities", "forces", "energy", "virial",
                 "temperature"):
        assert torch.equal(getattr(g, name), getattr(e, name)), name
    assert g_reb == e_reb and len(g_reb) >= 1
    assert g_n == e_n == (40, 40, 37)
    lean = captured.census["lean"]
    assert (lean["rebuild_flag"], lean["conditionals"]) == (1, 1), lean
    replays = []
    for name, (graph, *_rest) in captured.graphs.items():
        real = graph.replay
        graph.replay = (lambda real=real, name=name:
                        replays.append(name) or real())
    captured(g, 25)
    assert replays == ["lean", "last"]


@pytest.mark.parametrize("kind", ["slots", "naive", "neighbor"])
def test_captured_user_fire_equals_eager(cuda, kind):
    """FIRE with config 4's potential, one graph launch a minimization,
    against ``graph=False`` from one start, 60 iterations at tol 0: the
    slot FIRE on the pair list (4096), the row FIRE on the naive engine
    (example 03's published 1200) and on the neighbour list (4096, its
    tiles in torch): positions, FIRE's velocities, forces, energy, the
    iterations and the rebuild steps bit for bit."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.minimize import fire as fire_mod
    from mdtpu_torch.ops.naive import NaivePairEngine
    pot = NonAdditivePHS()
    n = 1200 if kind == "naive" else 4096
    state = _user_start(cuda, n)
    if kind == "slots":
        eng = CellGridEngine.create(pot, 1.8, 0.3, state.unitcell, n)
        start, eng = slot_step.slotify_grown(state, eng)
    else:
        eng = (NaivePairEngine(pot, 1.8) if kind == "naive" else
               mdtpu_torch.NeighborListEngine.create(pot, 1.8, 0.3,
                                                     state.unitcell, n))
        start = state.replace(nbrs=eng.allocate(
            state.positions, state.diameters, state.unitcell,
            state.unitcell_inv))
    out = {}
    for graph in (False, None):
        if kind == "slots":
            run = fire_mod.make_slot_fire(eng, max_steps=60, tol=0.0,
                                          dmax=0.01, graph=graph,
                                          cached=False)
            st, _, _, steps, ovf = run(start)
            v = st.velocities
        else:
            run = fire_mod.make_row_fire(eng, max_steps=60, tol=0.0,
                                         dmax=0.01, graph=graph,
                                         cached=False)
            st, _, _, steps = run(start)
            v, ovf = run.fire.bufs[1].v, False
        assert steps == 60 and not ovf
        out[graph] = (st, v.clone(), run.fire.rebuild_steps(), run.fire)
    (se, ve, re, eager), (sg, vg, rg, fire) = out[False], out[None]
    for name in ("positions", "forces", "energy", "virial"):
        assert torch.equal(getattr(se, name), getattr(sg, name)), name
    assert torch.equal(ve, vg) and re == rg
    assert fire.captured is not None and eager.captured is None
    if kind != "naive":
        assert fire.census["pass"]["conditionals"] == 1


@pytest.mark.parametrize("case", ["naive_1200", "neighbor"])
def test_captured_user_particle_advance_equals_eager(cuda, case):
    """Particle order with config 4's potential: the naive engine at
    example 03's published 1200 (no drift test) and the neighbour list at
    4096 (K1 at rebuilds, in the IF node), NVT in segments, captured
    against eager: every segment's numbers, the final arrays and the
    rebuild steps bit for bit."""
    from mdtpu_torch.integrate import step as tstep
    from mdtpu_torch.ops.naive import NaivePairEngine
    pot = NonAdditivePHS()
    n = 1200 if case == "naive_1200" else 4096
    st = _user_start(cuda, n)
    params = mdtpu_torch.Parameters(0.9, n, 2e-3, pot)
    eng = (NaivePairEngine(pot, 1.8) if case == "naive_1200" else
           mdtpu_torch.NeighborListEngine.create(pot, 1.8, 0.1,
                                                 st.unitcell, n))
    assert getattr(eng, "uses_kernel", False) is False
    nbrs = eng.allocate(st.positions, st.diameters, st.unitcell,
                        st.unitcell_inv)
    e, w, f, nbrs = eng.compute(st.positions, st.diameters, st.unitcell,
                                st.unitcell_inv, nbrs)
    st = st.replace(forces=f, energy=e, virial=w, nbrs=nbrs)
    out = {}
    for graph in (False, None):
        advance = tstep.make_particle_advance(
            params, mdtpu_torch.NVT(0.5, 0.01), eng, graph=graph)
        s, rows = st, []
        for k in (1, 9, 25, 15):
            s = advance(s, k)
            rows.append(torch.stack([s.energy, s.virial,
                                     s.temperature]).cpu())
        assert advance.graph is (graph is None)
        out[graph] = (s, torch.stack(rows), advance.rebuild_steps())
    (se, re, be), (sg, rg, bg) = out[False], out[None]
    assert torch.equal(re, rg) and be == bg
    if case == "neighbor":
        assert len(be) >= 1
    for name in ("positions", "velocities", "forces", "images"):
        assert torch.equal(getattr(se, name), getattr(sg, name)), name


class _ReadsTheHost(mdtpu_torch.Potential):
    """Config 4's potential, scaled by a value read back to the host: it
    runs eagerly and breaks the capture contract."""

    def evaluate(self, r, sigma_i, sigma_j):
        u, f = NonAdditivePHS().evaluate(r, sigma_i, sigma_j)
        scale = 1.0 + 0.0 * r.min().item()
        return u * scale, f * scale


class _SyncsTheCard(mdtpu_torch.Potential):
    """Config 4's potential that waits for the card in each call: no tensor
    operation the contract's guard sees, but the capture refuses it."""

    def evaluate(self, r, sigma_i, sigma_j):
        torch.cuda.synchronize()
        return NonAdditivePHS().evaluate(r, sigma_i, sigma_j)


def _breaking_case(name):
    """Config 4's slots at 4096 advanced under ``graph=None`` with the
    potential ``name`` (a class of this module) that breaks the capture
    contract: what happened, as a dict (the error's type and message,
    whether the state and the advance's buffers are as they were, whether
    a graph was kept, and where the eager route with the same potential
    ended)."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.potentials.base import CaptureContractError
    n = 4096
    params = mdtpu_torch.Parameters(0.9, n, 1e-3, globals()[name]())
    state = _user_start(torch.device("cuda"), n)
    eng = CellGridEngine.create(params.potential, 1.8, 0.3, state.unitcell,
                                n)
    slots, eng = slot_step.slotify_grown(state, eng)
    slots = slot_step.slot_forces(slots, eng)
    before = {k: getattr(slots, k).clone() for k in ("positions",
                                                     "velocities", "forces")}
    advance = slot_step.make_slot_advance(params, mdtpu_torch.NVE(), eng)
    out = {"raised": None}
    try:
        advance(slots, 5)
    except CaptureContractError as exc:
        out.update(raised=type(exc).__name__, message=str(exc),
                   runtime_error=isinstance(exc, RuntimeError))
    out["kept"] = (all(torch.equal(getattr(slots, k), t)
                       for k, t in before.items())
                   and int(advance.bufs.step) == slots.step)
    out["graphs"] = len(advance.graphs)
    eager = slot_step.make_slot_advance(params, mdtpu_torch.NVE(), eng,
                                        graph=False)
    out["eager_step"] = eager(slots, 5).step - slots.step
    out["eng"], out["slots"] = eng, slots
    return out


@pytest.mark.parametrize("pot", ["_ReadsTheHost", "_SyncsTheCard"])
def test_a_potential_that_breaks_the_capture_contract_raises(cuda, pot):
    """Under ``graph=None`` a user potential that reads the host raises the
    named ``RuntimeError`` (its type, the contract, the eager route) and
    takes no step: the caller's state and the advance's buffers stay as
    they were, no graph is kept; ``graph=False`` runs the same potential
    eagerly. ``.item()`` is refused by torch's synchronisation check in
    the warm-up, and the card captures again after it; a device-wide
    synchronisation only by the trial capture of the potential alone,
    which may leave the process unable to capture (a later garbage
    collection aborted it), so that case runs in a process of its own."""
    if pot == "_ReadsTheHost":
        out = _breaking_case(pot)
    else:
        import json
        import subprocess
        import sys
        # This file by its directory: a package named ``tests`` elsewhere
        # on the path would shadow this one.
        code = ("import json, os, sys\n"
                "sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "
                "'tests')]\n"
                "from test_torch_gpu import _breaking_case\n"
                f"out = _breaking_case({pot!r})\n"
                "del out['eng'], out['slots']\n"
                "print(json.dumps(out), flush=True)\n"
                "os._exit(0)\n")
        done = subprocess.run([sys.executable, "-c", code],
                              cwd=os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))),
                              capture_output=True, text=True, timeout=600)
        assert done.returncode == 0, done.stderr[-3000:]
        out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["raised"] == "CaptureContractError" and out["runtime_error"]
    assert out["message"].startswith(f"{pot}.")
    assert "potentials/base.py" in out["message"]
    assert "graph=False" in out["message"]
    assert out["kept"] and out["graphs"] == 0 and out["eager_step"] == 5
    if pot == "_ReadsTheHost":
        from mdtpu_torch.integrate import slot_step
        # The engine holds the potential the sweep calls.
        good = slot_step.make_slot_advance(
            mdtpu_torch.Parameters(0.9, 4096, 1e-3, NonAdditivePHS()),
            mdtpu_torch.NVE(), dataclasses.replace(
                out["eng"], potential=NonAdditivePHS()))
        s = good(out["slots"], 5)
        assert s.step == out["slots"].step + 5 and good.graph is True
