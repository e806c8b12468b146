"""2D and tilted boxes on the port's cell grid, and a user potential on its
pair list, against the JAX package (CPU, the kernels' plain versions):

  * engine choice (``select_engine``) for the boxes of ROADMAP's fault C6:
    a 6^3 box with N = 100 takes the naive engine in both packages, a
    40 x 40 2D box and a tilted 30^3 box the cell grid in both, with the
    same energy, virial and forces (f64: rtol 1e-12, forces 1e-10);
  * the 2D sweep on ``tests/test_cell_grid.py``'s 2D fluid (tilts 0 and 3,
    at rho 0.85):
    at f64 against the JAX package's cell grid (rtol 1e-12 on energy and
    virial, 1e-10 on forces), at f32 against its naive oracle at f64 (rtol
    2e-5, forces 5e-6 of the largest), and the hi/lo sweep against the JAX
    package's hi/lo slot sweep (1e-5, the two sum the float32 virial in
    different orders);
  * the 3D sweep in ``tests/test_cell_grid.py``'s tilted cell, the same;
  * the pair-list route with a non-additive polydisperse potential (each
    package's own copy, as ``examples/03_polydisperse_2d.py`` writes it)
    against the JAX package's cell grid with the same potential, f64, in 2D
    and in the tilted 3D cell; its list against the plain sweep's pairs, and
    the list's overflow flag and growth;
  * ``PlaneEngine`` refuses the boxes its kernel does not take;
  * the host plans of the kernels in 2D and 3D (the sweep's and the list's
    staging plans at every capacity), and the hi/lo filter's widened
    cutoff in tilted boxes 200 wide.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

import mdtpu
import mdtpu_torch
from mdtpu.ops.cell_grid import CellGridEngine as JCellGrid
from mdtpu.ops.cell_grid import far_ramp
from mdtpu.ops.naive import NaivePairEngine as JNaive
from mdtpu.potentials.base import Potential as JPotential
from mdtpu.potentials.lennard_jones import LennardJones as JLJ
from mdtpu.potentials.pseudo_hs import PseudoHS as JPHS
from mdtpu.utils.math import ipow as j_ipow
from mdtpu_torch.ops import cell_pairs
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.cell_sweep import (HILO_LO_BOUND, MAX_CAPACITY,
                                        MAX_SHARED_BYTES, QUEUE_DEPTH,
                                        PairTiles, box_extent,
                                        candidate_words,
                                        cell_sweep_hilo_plain,
                                        cell_sweep_plain,
                                        hilo_filter_cutoff2, kernel_params,
                                        stage_cells, stage_plan)
from mdtpu_torch.ops.experimental import PlaneEngine
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from tests.test_torch_driver import one_torch_thread  # noqa: F401
from tests.test_torch_gpu import NonAdditivePHS

TILTED_3D = [[24.0, 3.0, 2.0], [0.0, 24.0, 4.0], [0.0, 0.0, 24.0]]


# The user potential of examples/03_polydisperse_2d.py: the port's copy
# (NonAdditivePHS, from tests/test_torch_gpu.py) and the JAX package's.
@struct.dataclass
class JNonAdditivePHS(JPotential):
    """The JAX package's copy (examples/03_polydisperse_2d.py)."""

    lam: int = struct.field(pytree_node=False, default=12)

    def evaluate(self, r, sigma_i, sigma_j):
        sigma = 0.5 * (sigma_i + sigma_j) * (1.0 - 0.2 * jnp.abs(
            sigma_i - sigma_j))
        cutoff = 1.25 * sigma
        inside = r < cutoff
        r_safe = jnp.where(inside, r, jnp.ones_like(r))
        sr = sigma / r_safe
        u_raw = j_ipow(sr, self.lam)
        f_raw = self.lam * u_raw / r_safe
        u_c = j_ipow(jnp.asarray(1 / 1.25, r.dtype), self.lam)
        f_c = self.lam * u_c / cutoff
        u = u_raw - u_c + (r_safe - cutoff) * f_c
        f = f_raw - f_c
        zero = jnp.zeros_like(u)
        return jnp.where(inside, u, zero), jnp.where(inside, f, zero)


def lattice(n, cell, jitter, seed, poly=0.0):
    """A jittered lattice filling ``cell`` (fractional lattice, Cartesian
    jitter), folded into the box; diameters 1 + poly U(-1, 1)."""
    cell = np.asarray(cell, np.float64)
    dim = cell.shape[0]
    rng = np.random.default_rng(seed)
    per = int(np.ceil(n ** (1.0 / dim)))
    idx = np.indices((per,) * dim).reshape(dim, -1).T[:n]
    pos = (idx + 0.5) / per @ cell.T + jitter * rng.normal(size=(n, dim))
    frac = pos @ np.linalg.inv(cell).T
    pos = (frac - np.floor(frac)) @ cell.T
    diam = 1.0 + poly * rng.uniform(-1.0, 1.0, n)
    return pos, diam


def fluid_2d(tilt, n=800, rho=0.85):
    """``tests/test_cell_grid.py``'s 2D fluid, denser so that most particles
    interact with pseudo-hard spheres (lattice spacing 1.08): n = 800 at rho
    0.85 in a box with x-tilt ``tilt``, a lattice jittered by 0.08."""
    L = (n / rho) ** 0.5
    cell = np.array([[L, tilt], [0.0, L]])
    pos, diam = lattice(n, cell, 0.08, 7)
    return pos, diam, cell


def fluid_tilted_3d(n=4096):
    """``tests/test_cell_grid.py``'s tilted cell (L = 24) holding its test's
    4096 particles, here a jittered lattice (spacing 1.5, so the cases take
    Lennard-Jones at r_c 2.5 there)."""
    pos, diam = lattice(n, TILTED_3D, 0.08, 11)
    return pos, diam, np.array(TILTED_3D)


# name -> (positions, diameters, cell; the port's and the JAX package's
# potential and the cutoff)
GEOMETRIES = {
    "2d": (lambda: fluid_2d(0.0), PseudoHS(), JPHS(), 1.5),
    "2d_tilt3": (lambda: fluid_2d(3.0), PseudoHS(), JPHS(), 1.5),
    "3d_tilted": (fluid_tilted_3d, LennardJones(r_cut=2.5), JLJ(r_cut=2.5),
                  2.5),
}


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def port_compute(pot, pos, diam, cell, cutoff, dtype=torch.float64,
                 engine=None):
    """The port's cell grid in particle order: (e, w, forces (n, d))."""
    pos, diam, cell = _t(pos, dtype), _t(diam, dtype), _t(cell, dtype)
    cinv = _t(np.linalg.inv(np.asarray(cell, np.float64)), dtype)
    eng = engine or CellGridEngine.create(pot, cutoff, 0.3, cell,
                                          pos.shape[0])
    nb = eng.allocate(pos, diam, cell, cinv)
    assert not bool(nb.overflow)
    e, w, f, nb = eng.compute(pos, diam, cell, cinv, nb)
    assert not bool(nb.overflow)
    return float(e), float(w), f.numpy(), eng


def jax_compute(jpot, pos, diam, cell, cutoff, engine="cellgrid"):
    pos, diam, cell = (jnp.asarray(np.asarray(a, np.float64))
                       for a in (pos, diam, cell))
    cinv = jnp.linalg.inv(cell)
    if engine == "naive":
        e, w, f, _ = JNaive(potential=jpot, cutoff=cutoff).compute(
            pos, diam, cell, cinv, ())
    else:
        eng = JCellGrid.create(jpot, cutoff, 0.3, np.asarray(cell),
                               pos.shape[0])
        nb = eng.allocate(pos, diam, cell, cinv)
        assert not bool(nb.overflow)
        e, w, f, _ = eng.compute(pos, diam, cell, cinv, nb)
    return float(e), float(w), np.asarray(f)


def assert_f64_match(got, want):
    e1, w1, f1 = got[:3]
    e0, w0, f0 = want
    np.testing.assert_allclose(e1, e0, rtol=1e-12)
    np.testing.assert_allclose(w1, w0, rtol=1e-12)
    np.testing.assert_allclose(f1, f0, rtol=1e-10, atol=1e-12)


def assert_f32_match(got, want):
    e1, w1, f1 = got[:3]
    e0, w0, f0 = want
    np.testing.assert_allclose(e1, e0, rtol=2e-5)
    np.testing.assert_allclose(w1, w0, rtol=2e-5)
    scale = np.abs(f0).max()
    np.testing.assert_allclose(f1 / scale, f0 / scale, atol=5e-6)


# ------------------------------------------------------------------- C6

C6_BOXES = {
    "small_3d": (np.eye(3) * 6.0, 100, mdtpu.NaivePairEngine,
                 mdtpu_torch.NaivePairEngine),
    "2d_40": (np.eye(2) * 40.0, 1280, JCellGrid, CellGridEngine),
    "tilted_30": (np.array([[30.0, 30 / 8, 30 / 12], [0.0, 30.0, 30 / 6],
                            [0.0, 0.0, 30.0]]), 1500, JCellGrid,
                  CellGridEngine),
}


@pytest.mark.parametrize("box", sorted(C6_BOXES))
def test_select_engine_prefer_cellgrid_follows_the_reference(box):
    """ROADMAP C6: ``prefer="cellgrid"`` falls back to the naive engine where
    the box does not fit a grid, as the reference does, and takes the grid
    for 2D and tilted boxes, with the JAX package's forces."""
    cell, n, jtype, ttype = C6_BOXES[box]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the small box's half-box warning
        jeng = mdtpu.select_engine(JLJ(r_cut=2.5), 2.5, unitcell=cell,
                                   n_particles=n, prefer="cellgrid")
        teng = mdtpu_torch.select_engine(LennardJones(r_cut=2.5), 2.5,
                                         unitcell=cell, n_particles=n,
                                         prefer="cellgrid")
    assert type(jeng) is jtype and type(teng) is ttype
    if ttype is CellGridEngine:
        assert len(teng.grid) == len(jeng.grid) == cell.shape[0]
        pos, diam = lattice(n, cell, 0.1, 3)
        got = port_compute(LennardJones(r_cut=2.5), pos, diam, cell, 2.5,
                           engine=teng)
        assert_f64_match(got, jax_compute(JLJ(r_cut=2.5), pos, diam, cell,
                                          2.5))


def test_select_engine_auto_takes_the_grid_for_2d_and_tilted_boxes():
    for cell in (np.eye(2) * 60.0, C6_BOXES["tilted_30"][0]):
        eng = mdtpu_torch.select_engine(LennardJones(r_cut=2.5), 2.5,
                                        unitcell=cell, n_particles=4096)
        assert isinstance(eng, CellGridEngine)
        assert len(eng.grid) == cell.shape[0] and min(eng.grid) >= 3
    small = mdtpu_torch.select_engine(LennardJones(r_cut=2.5), 2.5,
                                      unitcell=np.eye(2) * 60.0,
                                      n_particles=2048)
    assert isinstance(small, mdtpu_torch.NaivePairEngine)


def test_plane_engine_refuses_other_boxes():
    pot = LennardJones(r_cut=2.5)
    for cell in (np.eye(2) * 40.0, C6_BOXES["tilted_30"][0]):
        with pytest.raises(ValueError, match="orthorhombic"):
            PlaneEngine.create(pot, 2.5, 0.3, cell, 4096)
    assert isinstance(PlaneEngine.create(pot, 2.5, 0.3, np.eye(3) * 30.0,
                                         4096), PlaneEngine)


# ------------------------------------------------------- sweeps vs the JAX

@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_sweep_matches_jax_f64(geometry):
    make, pot, jpot, cutoff = GEOMETRIES[geometry]
    pos, diam, cell = make()
    got = port_compute(pot, pos, diam, cell, cutoff)
    assert len(got[3].grid) == cell.shape[0]
    assert_f64_match(got, jax_compute(jpot, pos, diam, cell, cutoff))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_sweep_f32_matches_naive_oracle(geometry):
    make, pot, jpot, cutoff = GEOMETRIES[geometry]
    # Both take the same float32 numbers (the oracle at f64).
    pos, diam, cell = (np.asarray(a, np.float32).astype(np.float64)
                       for a in make())
    got = port_compute(pot, pos, diam, cell, cutoff, torch.float32)
    assert_f32_match(got, jax_compute(jpot, pos, diam, cell, cutoff,
                                      engine="naive"))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_hilo_sweep_matches_jax_hilo_slot_sweep(geometry):
    """The hi/lo sweep on hi/lo words of the f64 state against the JAX
    package's hi/lo slot sweep on the same slots (its vacant slots on its
    far-pad ramp); its displacements, image shifts across tilted faces
    included, exact to a few ulp of the cutoff where the plain f32 ones
    carry ulps of the box."""
    make, pot, jpot, cutoff = GEOMETRIES[geometry]
    pos, diam, cell = make()
    n, dim = pos.shape
    eng = CellGridEngine.create(pot, cutoff, 0.3, cell, n)
    hi = _t(pos, torch.float32)
    lo = (_t(pos) - hi.double()).float()
    cell32 = _t(cell, torch.float32)
    cinv32 = _t(np.linalg.inv(cell), torch.float32)
    nb = eng.allocate(hi, _t(diam, torch.float32), cell32, cinv32)
    slot_hi, slot_lo, sdiam, counts, cm = eng.slot_inputs_hilo(
        hi, lo, cell32, cinv32, nb)
    e1, w1, f1 = cell_sweep_hilo_plain(slot_hi, slot_lo, sdiam, counts, cm,
                                       eng.grid, eng.cutoff, pot)
    cap, n_slots = eng.cell_capacity, slot_hi.shape[1]
    occ = (torch.arange(cap)[None, :] < counts[:, None]).reshape(-1).numpy()
    far = np.asarray(far_ramp(n_slots, jnp.float32))
    jeng = JCellGrid(potential=jpot, cutoff=cutoff, skin=0.3, grid=eng.grid,
                     cell_capacity=cap)
    e0, w0, f0, _ = jeng.compute_slots(
        jnp.asarray(np.where(occ[None, :], slot_hi.numpy(), far[None, :])),
        jnp.asarray(sdiam.numpy()), jnp.asarray(cm.numpy()),
        jnp.linalg.inv(jnp.asarray(cm.numpy())), None,
        pos_lo=jnp.asarray(np.where(occ[None, :], slot_lo.numpy(),
                                    0.0).astype(np.float32)))
    np.testing.assert_allclose(float(e1), float(e0), rtol=1e-5)
    np.testing.assert_allclose(float(w1), float(w0), rtol=1e-5)
    f0 = np.asarray(f0)[:, occ]
    scale = np.abs(f0).max()
    np.testing.assert_allclose(f1.numpy()[:, occ] / scale, f0 / scale,
                               atol=1e-6)
    tiles = {kind: PairTiles(h, sdiam, counts, c, eng.grid, eng.cutoff, None,
                             slot_lo=lo_)
             for kind, h, c, lo_ in (
                 ("f64", slot_hi.double() + slot_lo.double(), cm.double(),
                  None),
                 ("hilo", slot_hi, cm, slot_lo), ("plain", slot_hi, cm, None))}
    err = {"hilo": 0.0, "plain": 0.0}
    for off in tiles["f64"].offsets():
        _, d64, _, mask = tiles["f64"].pairs(off)
        if not bool(mask.any()):
            continue
        for kind in err:
            d = tiles[kind].pairs(off)[1]
            for k in range(dim):
                err[kind] = max(err[kind], float(
                    (d[k].double() - d64[k])[mask].abs().max()))
    eps = float(torch.finfo(torch.float32).eps)
    assert err["hilo"] <= 4 * eps * cutoff, err
    assert 10 * err["hilo"] < err["plain"], err


# --------------------------------------------------------- the pair list

@pytest.mark.parametrize("geometry", ["2d_tilt3", "3d_tilted"])
def test_pair_list_route_matches_jax_with_a_user_potential(geometry):
    pos, _, cell = GEOMETRIES[geometry][0]()
    diam = np.random.default_rng(5).uniform(0.8, 1.2, pos.shape[0])
    pot = NonAdditivePHS()
    assert kernel_params(pot) is None
    got = port_compute(pot, pos, diam, cell, 1.8)
    eng = got[3]
    assert eng.uses_pair_list and eng.pair_capacity > 0
    assert_f64_match(got, jax_compute(JNonAdditivePHS(), pos, diam, cell,
                                      1.8))


def test_pair_list_holds_the_plain_sweeps_pairs_in_order():
    """The list of every occupied slot: its segment holds the pairs of the
    plain sweep inside the engine cutoff, stencil by stencil, and the lean
    reduction's forces are the full one's."""
    pos, diam, cell = fluid_2d(3.0)
    pot = NonAdditivePHS()
    eng = CellGridEngine.create(pot, 1.8, 0.3, cell, pos.shape[0])
    t = [_t(a) for a in (pos, diam, cell, np.linalg.inv(cell))]
    nb = eng.allocate(*t)
    slot_pos, sdiam, counts, cm = eng.slot_inputs(t[0], t[2], t[3], nb)
    plist = cell_pairs.pair_list(slot_pos, sdiam, counts, cm, eng.grid, 1.8,
                                 eng.pair_list_capacity)
    total = int(plist.total)
    assert not bool(plist.overflow) and 0 < total <= plist.capacity
    assert int(plist.count.sum()) == total
    # Every hit inside the cutoff, from both sides: each (i, j) has (j, i).
    own = torch.repeat_interleave(torch.arange(slot_pos.shape[1]),
                                  plist.count.long())
    nbr = plist.neighbour[:total].long()
    assert bool((plist.r2[:total] < 1.8 ** 2).all())
    pairs = set(zip(own.tolist(), nbr.tolist()))
    assert len(pairs) == total and all((j, i) in pairs for i, j in pairs)
    # The displacement is own minus the neighbour's image.
    d = plist.disp[:, :total]
    np.testing.assert_allclose((d * d).sum(0).numpy(),
                               plist.r2[:total].numpy(), rtol=1e-14)
    # The energy and forces are the plain sweep's (same pairs, other order).
    e1, w1, f1, over = cell_pairs.pair_sweep(slot_pos, sdiam, counts, cm,
                                             eng.grid, 1.8, pot,
                                             eng.pair_list_capacity)
    e0, w0, f0 = cell_sweep_plain(slot_pos, sdiam, counts, cm, eng.grid,
                                  1.8, pot)
    np.testing.assert_allclose(float(e1), float(e0), rtol=1e-12)
    np.testing.assert_allclose(float(w1), float(w0), rtol=1e-12)
    np.testing.assert_allclose(f1.numpy(), f0.numpy(), rtol=1e-10,
                               atol=1e-12)
    _, _, f_lean, _ = cell_pairs.pair_sweep(
        slot_pos, sdiam, counts, cm, eng.grid, 1.8, pot,
        eng.pair_list_capacity, observables=False)
    assert torch.equal(f_lean, f1)


def test_pair_list_overflow_is_flagged_and_the_engine_grows():
    pos, diam, cell = fluid_2d(0.0)
    pot = NonAdditivePHS()
    eng = CellGridEngine.create(pot, 1.8, 0.3, cell, pos.shape[0])
    t = [_t(a) for a in (pos, diam, cell, np.linalg.inv(cell))]
    nb = eng.allocate(*t)
    _, _, f_full, nb_full = eng.compute(*t, nb)
    assert not bool(nb_full.overflow)
    tight = dataclasses.replace(eng, pair_capacity=500)
    _, _, f_short, nb_short = tight.compute(*t, tight.allocate(*t))
    assert bool(nb_short.overflow)           # sticky, as a full cell's
    assert not torch.equal(f_short, f_full)
    grown = tight.with_grown_capacity()
    assert grown.pair_capacity == int(500 * 1.4) + 1024
    assert grown.cell_capacity == int(tight.cell_capacity * 1.4 + 4)
    # Built-in potentials keep the kernel's functor and no list.
    assert not CellGridEngine.create(PseudoHS(), 1.5, 0.3, cell,
                                     pos.shape[0]).uses_pair_list


# ------------------------------------------------ the kernels' host plans

def _sweep_shared_bytes(list_len, threads, esize, words):
    """``shared_bytes`` of csrc/cell_sweep.cu: the list and its 16 pad
    candidates of ``words`` values, 5 sums a thread, 3 x 32 shifts, 2 x 32
    ints of cell records, the queues."""
    return ((words * (list_len + 16) + 5 * threads + 96) * esize + 64 * 4
            + QUEUE_DEPTH * threads * 2)


def _list_shared_bytes(list_len, cap, esize, dim, hilo, cells, out_len):
    """``ListLayout`` of csrc/cell_pairs.cu for a block of ``cells`` own
    cells buffering ``out_len`` hits, each region rounded up to 16 bytes:
    the list (d + 1 words a candidate, and the lo words: 4 in 3D, 2 in
    2D), the own slots' d + 1 words (2 d + 1 under hi/lo), d x 32
    shifts, an 8-byte position per own slot and one more (at least 32),
    33 + 2 x 32 ints of window records, an int slot id per staged
    candidate, cells + 1 own offsets, and the buffered hits (an int and
    d + 3 words each)."""
    def r16(n):
        return -(-n // 16) * 16

    n = list_len
    lo_words = (4 if dim == 3 else 2) if hilo else 0
    own = (2 * dim + 1) if hilo else dim + 1
    slots = cells * cap
    return (r16((dim + 1) * n * esize) + r16(lo_words * n * esize)
            + r16(own * slots * esize) + r16(32 * dim * esize)
            + r16(8 * max(slots + 1, 32)) + r16(4 * 33) + 2 * r16(128)
            + r16(4 * n) + r16(4 * (cells + 1)) + r16(4 * out_len)
            + r16((dim + 3) * out_len * esize))


@pytest.mark.parametrize("kind", ["f32", "f64", "hilo"])
@pytest.mark.parametrize("dim", [2, 3])
def test_stage_plans_in_2d_and_3d(dim, kind):
    """The sweep's and the list's staging plans at every capacity: the
    kernels' own byte counts (a 2D candidate takes 3 values, 5 with its lo
    words; 4 and 8 in 3D), within a block's shared memory, a stage of at
    least one cell and at most the stencil (the list's: the whole stencil
    where it fits, else the most that fit), and a whole typical
    neighbourhood in one stage; the list's blocks fill an SM's warps."""
    dtype = torch.float64 if kind == "f64" else torch.float32
    hilo = kind == "hilo"
    esize = torch.finfo(dtype).bits // 8
    words = {(2, False): 3, (2, True): 5, (3, False): 4, (3, True): 8}[
        (dim, hilo)]
    assert candidate_words(dim, hilo) == words
    cells = 3 ** dim
    for cap in range(1, MAX_CAPACITY + 1):
        list_len, smem, threads = stage_plan(cap, dtype, hilo, dim)
        assert smem == _sweep_shared_bytes(list_len, threads, esize, words)
        assert smem <= MAX_SHARED_BYTES and cap <= list_len <= cells * cap
        assert threads >= cap and threads & (threads - 1) == 0
        assert stage_cells([cap // 2] * cells, list_len) == cells or \
            list_len < cells * (cap // 2)
        p_len, p_out, p_smem, p_threads, p_cells = \
            cell_pairs.pairs_stage_plan(cap, dtype, hilo, dim)
        assert p_smem == _list_shared_bytes(p_len, cap, esize, dim, hilo,
                                            p_cells, p_out)
        # A block takes up to 4 cells of a 2D row (a window of 3 x 6
        # cells), one in 3D (3 x 9); a stage holds at least one window row,
        # the whole window where it fits, else the most that fits.
        rows, window = cells // 3, p_cells + 2
        assert 1 <= p_cells <= (4 if dim == 2 else 1)
        assert p_smem <= MAX_SHARED_BYTES
        assert window * cap <= p_len <= rows * window * cap
        assert p_len == rows * window * cap or _list_shared_bytes(
            p_len + 1, cap, esize, dim, hilo, p_cells, 0) > MAX_SHARED_BYTES
        # One or two warps for a small stencil, whichever keeps more warps
        # on an SM; else a power of two of warps, enough that the blocks one
        # SM's shared memory holds bring it its 64 warps, at most 8.
        assert 32 <= p_threads <= 256 and p_threads & (p_threads - 1) == 0
        base = p_smem - _list_shared_bytes(0, 0, esize, dim, hilo, 0, p_out) \
            + _list_shared_bytes(0, 0, esize, dim, hilo, 0, 0)
        blocks = min(32, 233472 // (base + 1024))
        if cells * cap <= 256:
            warps = {t: min(32, 1024 // t, blocks) * t // 32 for t in (32, 64)}
            assert p_threads == (64 if warps[64] > warps[32] else 32)
        else:
            assert blocks * p_threads >= 2048 or p_threads == 256
        # The buffered hits fill what the blocks an SM holds at 64 registers
        # a thread leave of its shared memory, at most 4096.
        per_block = min(233472 // min(32, 1024 // p_threads) - 1024, 232448)
        assert 0 <= p_out <= 4096
        assert p_out == 0 or p_smem <= per_block
        assert p_out == 4096 or _list_shared_bytes(
            p_len, cap, esize, dim, hilo, p_cells, p_out + 1) > per_block - 32
    # bench_2d.py's geometry (C = 9): the whole 2D stencil in one stage.
    assert stage_cells([9] * 9, stage_plan(9, dtype, hilo, 2)[0]) in (9, 3)
    assert stage_cells([5] * 9, stage_plan(9, dtype, hilo, 2)[0]) == 9


@pytest.mark.parametrize("geometry", ["2d_tilt3", "3d_tilted"])
def test_hilo_filter_admits_every_pair_in_a_tilted_box(geometry):
    """The hi/lo filter's widened cutoff, whose margin scales with the box's
    extent (``box_extent``: the largest row sum of |cell|, the longest box
    length of an orthorhombic box), admits every pair whose hi/lo r^2 is
    inside the cutoff, in a tilted box scaled to 200 wide with lo words at
    their contract's bound."""
    make, pot, _, cutoff = GEOMETRIES[geometry]
    pos, diam, cell = make()
    scale = 200.0 / cell[0, 0]
    cell = cell * scale
    pos = pos * scale
    n, dim = pos.shape
    rng = np.random.default_rng(0)
    eps = float(torch.finfo(torch.float32).eps)
    ext = float(box_extent(_t(cell)))
    assert ext == pytest.approx(np.abs(cell).sum(axis=1).max())
    # Pairs at the cutoff: partners placed at r_c (1 + k eps).
    first = rng.integers(0, n, 400)
    direction = rng.normal(size=(400, dim))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    k = rng.integers(-6, 7, 400)[:, None]
    true = np.concatenate([pos, pos[first] + cutoff * (1 + k * eps)
                           * direction])
    frac = true @ np.linalg.inv(cell).T
    true = (frac - np.floor(frac)) @ cell.T
    noise = (rng.random(true.shape) * 2 - 1) * 3 * eps * ext
    hi = torch.from_numpy((true + noise).astype(np.float32))
    lo = torch.from_numpy((true - hi.double().numpy()).astype(np.float32))
    cell32, cinv32 = _t(cell, torch.float32), _t(np.linalg.inv(cell),
                                                  torch.float32)
    eng = CellGridEngine.create(pot, cutoff, 0.0, cell32, len(true))
    nb = eng.allocate(hi, torch.ones(len(true)), cell32, cinv32)
    while bool(nb.overflow):
        eng = eng.with_grown_capacity()
        nb = eng.allocate(hi, torch.ones(len(true)), cell32, cinv32)
    slot_hi, slot_lo, sdiam, counts, cm = eng.slot_inputs_hilo(
        hi, lo, cell32, cinv32, nb)
    assert float(slot_lo.abs().max()) <= HILO_LO_BOUND * eps * ext
    filter2 = hilo_filter_cutoff2(cutoff, cm, torch.float32)
    exact = PairTiles(slot_hi, sdiam, counts, cm, eng.grid, cutoff, None,
                      slot_lo=slot_lo)
    plain = PairTiles(slot_hi, sdiam, counts, cm, eng.grid, cutoff, None)
    inside = 0
    for off in exact.offsets():
        _, d, _, hit = exact.pairs(off)
        _, p, r2p, _ = plain.pairs(off)
        assert bool((r2p[hit] < filter2).all())
        inside += int(hit.sum())
    assert inside > 300   # the planted pairs inside the cutoff, both sides
