"""The port's observables (``mdtpu_torch.observables``, ``ops/rdf.py``)
against the JAX package's ``mdtpu.observables`` on the same numpy-seeded
inputs (CPU):

  * ``rdf_histogram`` (the plain version, which the CPU takes) counts the
    same pairs in every bin as the JAX package's dense histogram, at f64
    and f32, in a cubic 3D box, a tilted 3D box and a tilted 2D box (N =
    1200), at r_max 3 and at half the narrowest width. The one allowance:
    pairs whose scaled distance ``r / r_max * n_bins`` lies within 1e-9 of
    an integer (counted in numpy f64) may fall in the neighbouring bin, in
    case XLA contracts a product on the CPU; the total difference is then
    at most twice their number;
  * the row chunks do not change the counts;
  * the kernel's tile schedule (row tiles, column spans, only the blocks
    with work, the diagonal tile from j > i), emulated in Python: every
    unordered pair exactly once;
  * the host's planning, on which the kernel relies (not a copy of the
    kernel): the bin edges and ``r^2`` threshold against the formula in
    numpy and in torch in the dtype, at and one ulp either side of every
    edge; a plain pass over exactly the pairs that the cell route's grid
    and half stencil visit gives the JAX package's counts (the same
    near-edge allowance) in the three boxes and with the positions
    displaced by several box lengths, each pair visited once; the route
    (tile below 3 cells an axis, or where the stencil covers much of the
    box) and the zero pattern of a diagonal, a triangular and a general
    cell;
  * ``rdf_normalize`` and ``sample_rdf`` at rel 1e-12, the mean-squared
    displacement at rel 1e-12, ``read_thermo`` equal;
  * ``validate_torch.py``'s oracles equal ``validate.py``'s."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdtpu import observables as jobs
from mdtpu_torch import observables as tobs
from mdtpu_torch.ops import rdf
from mdtpu_torch.sim.initialization import build_state_from_arrays
from tests.test_torch_driver import one_torch_thread  # noqa: F401

N_RDF, RHO_RDF = 1200, 0.8
BOXES = ("cubic", "tilted3d", "tilted2d")
DTYPES = {"f64": (jnp.float64, np.float64),
          "f32": (jnp.float32, np.float32)}


def _box(kind):
    dim = 2 if kind == "tilted2d" else 3
    L = (N_RDF / RHO_RDF) ** (1 / dim)
    cell = np.eye(dim) * L
    if kind != "cubic":
        cell[0, 1] = L / 8
        if dim == 3:
            cell[0, 2], cell[1, 2] = L / 12, L / 6
    return cell


def _positions(cell, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((N_RDF, cell.shape[0])) @ cell.T


def _near_edges(pos, cell, r_max, n_bins, tol=1e-9):
    """Ordered pairs whose scaled distance lies within ``tol`` of an
    integer (numpy f64, all pairs)."""
    inv = np.linalg.inv(cell)
    d = pos[:, None, :] - pos[None, :, :]
    f = d @ inv.T
    f -= np.round(f)
    r = np.sqrt(((f @ cell.T) ** 2).sum(-1))
    x = r / r_max * n_bins
    np.fill_diagonal(x, np.inf)
    return int(np.sum((np.abs(x - np.round(x)) < tol) & (r < r_max)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("box", BOXES)
def test_rdf_histogram_matches_jax(box, dtype):
    jdt, ndt = DTYPES[dtype]
    cell = _box(box)
    pos = _positions(cell).astype(ndt)
    cell_n, inv_n = cell.astype(ndt), np.linalg.inv(cell).astype(ndt)
    for r_max in (3.0, tobs.half_min_width(cell)):
        ref = np.asarray(jobs.rdf_histogram(
            jnp.asarray(pos, jdt), jnp.asarray(cell_n, jdt),
            jnp.asarray(inv_n, jdt), r_max, 200))
        got = rdf.rdf_histogram(torch.tensor(pos), torch.tensor(cell_n),
                                torch.tensor(inv_n), r_max, 200)
        assert got.dtype == torch.int64 and got.shape == (200,)
        diff = int(np.abs(got.numpy() - ref).sum())
        if diff:
            excused = _near_edges(pos.astype(np.float64), cell, r_max, 200)
            assert diff <= 2 * excused, (diff, excused)
        assert int(got.sum()) == int(ref.sum()) > 0


def test_rdf_plain_chunks_do_not_change_the_counts(monkeypatch):
    cell = _box("tilted3d")
    args = (torch.tensor(_positions(cell, seed=3)), torch.tensor(cell),
            torch.tensor(np.linalg.inv(cell)), 4.0, 50)
    whole = rdf.rdf_histogram_plain(*args)
    for rows in (1, 7, 500):
        monkeypatch.setattr(rdf, "CHUNK_ELEMENTS", rows * N_RDF)
        assert torch.equal(rdf.rdf_histogram_plain(*args), whole)


def test_rdf_checks_its_inputs():
    pos = torch.zeros((10, 4), dtype=torch.float64)
    eye = torch.eye(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="positions"):
        rdf.rdf_histogram(pos, eye, eye, 1.0, 10)
    pos = torch.zeros((10, 3), dtype=torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        rdf.rdf_histogram(pos, eye.float(), eye.float(), 1.0, 10)
    with pytest.raises(ValueError, match="n_bins"):
        rdf.rdf_histogram(pos, eye, eye, 1.0, rdf.MAX_BINS + 1)


def _kernel_pairs(n, width=256, span=8):
    """The (i, j) pairs ``csrc/rdf_histogram.cu``'s tile route evaluates,
    by its schedule: tiles of ``width`` rows (and columns); span y holds
    the row tiles 0 .. min(tiles, (y + 1) span) - 1, block by block in that
    order, and block (x, y) walks the column tiles max(x, y span) ..
    min(tiles, (y + 1) span) - 1, the diagonal tile from j > i."""
    tiles = -(-n // width)
    blocks = []
    for y in range(-(-tiles // span)):
        blocks += [(x, y) for x in range(min(tiles, (y + 1) * span))]
    pairs = []
    for x, y in blocks:
        for tile in range(max(x, y * span), min(tiles, (y + 1) * span)):
            for i in range(x * width, min(n, (x + 1) * width)):
                start = i + 1 if tile == x else tile * width
                pairs += [(i, j) for j in
                          range(start, min(n, (tile + 1) * width))]
    return pairs


@pytest.mark.parametrize("n,rows,span", [(2, 128, 16), (300, 128, 16),
                                         (1000, 16, 3), (97, 8, 2)])
def test_kernel_schedule_visits_each_pair_once(n, rows, span):
    pairs = _kernel_pairs(n, rows, span)
    assert len(pairs) == len(set(pairs)) == n * (n - 1) // 2
    assert all(i < j for i, j in pairs)


def _ulp_neighbours(x):
    lo = np.nextafter(x, x.dtype.type(-np.inf))
    hi = np.nextafter(x, x.dtype.type(np.inf))
    return np.concatenate([lo, x, hi])


def _numpy_bins(r2, r_max, n_bins):
    """The plain version's bin in numpy, in r2's dtype (n_bins: outside)."""
    dt = r2.dtype.type
    r = np.sqrt(r2)
    inside = r < dt(r_max)
    with np.errstate(invalid="ignore", over="ignore"):
        b = np.minimum((r / dt(r_max) * dt(n_bins)).astype(np.int64),
                       n_bins - 1)
    return np.where(inside, b, n_bins)


def _edge_rule(r2, edges):
    """The kernel's reading of the edges: outside (n_bins) where r2 >= t,
    else the largest b with edges[b] <= r2."""
    n_bins = edges.shape[0] - 1
    b = np.searchsorted(edges[:n_bins], r2, side="right") - 1
    return np.where(r2 < edges[n_bins], b, n_bins)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("r_max,n_bins", [(3.0, 200), (21.72, 200),
                                          (2.5, 7), (1.0, 12288)])
def test_bin_edges_match_the_formula(dtype, r_max, n_bins):
    """The host's edges and threshold t against the plain version's formula
    in numpy in the dtype (correctly rounded, as the card's arithmetic; the
    CPU build of torch takes a vectorized square root that can be 1 ulp
    off): at every edge and one ulp either side, and over the squares of a
    grid of distances; each edge the least r^2 of its bin."""
    edges = rdf.bin_edges(dtype, r_max, n_bins)
    assert edges.dtype == dtype and edges.shape == (n_bins + 1,)
    assert edges[0] == 0 and np.all(np.diff(edges) >= 0)
    r = np.linspace(0, 1.2 * r_max, 20001).astype(dtype)
    for r2 in (_ulp_neighbours(edges[1:]), r * r):
        want = _numpy_bins(r2, r_max, n_bins)
        np.testing.assert_array_equal(_edge_rule(r2, edges), want)
    below = np.nextafter(edges[1:], dtype(0))
    b = np.arange(1, n_bins + 1)
    assert np.all(_numpy_bins(edges[1:], r_max, n_bins) >= b)
    assert np.all(_numpy_bins(below, r_max, n_bins) < b)
    t = edges[n_bins]
    assert np.sqrt(t) >= dtype(r_max) > np.sqrt(np.nextafter(t, dtype(0)))


def _rotation(dim):
    """A rotation that leaves no entry of a cell matrix zero."""
    if dim == 2:
        c, s = np.cos(0.3), np.sin(0.3)
        return np.array([[c, -s], [s, c]])
    q, _ = np.linalg.qr(np.random.default_rng(11).normal(size=(3, 3)))
    return q


def _cell_route_pairs(frac, grid, cid):
    """The unordered pairs the cell route visits: the own cell (j after i
    in the binning's order) and the cells whose offset lies
    lexicographically ahead in {-1, 0, 1}^d, from each cell; each visit
    once, as a set of (i, j), i < j."""
    dim = len(grid)
    coords = np.stack(np.unravel_index(cid, grid), axis=1)
    offsets = [o for o in itertools.product((-1, 0, 1), repeat=dim)
               if o > (0,) * dim]
    by_cell = {}
    order = np.argsort(cid, kind="stable")
    for p in order:
        by_cell.setdefault(tuple(coords[p]), []).append(int(p))
    visits = []
    for c, own in by_cell.items():
        for k, i in enumerate(own):
            visits += [(i, j) for j in own[k + 1:]]
            for o in offsets:
                nb = tuple((a + b) % g for a, b, g in zip(c, o, grid))
                visits += [(i, j) for j in by_cell.get(nb, [])]
    pairs = {(min(i, j), max(i, j)) for i, j in visits}
    assert len(pairs) == len(visits)   # each pair visited once
    return np.array(sorted(pairs))


def _plain_pair_bins(pos, cell, inv, pairs, r_max, n_bins):
    """The plain version's arithmetic (the JAX expression order) on a list
    of pairs, in numpy in the dtype; the bins (n_bins: outside) and the
    squared distances."""
    dim = pos.shape[1]
    i, j = pairs[:, 0], pairs[:, 1]
    d = [pos[i, k] - pos[j, k] for k in range(dim)]

    def row(m, a, v):
        out = m[a, 0] * v[0]
        for k in range(1, dim):
            out = out + m[a, k] * v[k]
        return out

    frac = [f - np.round(f) for f in (row(inv, k, d) for k in range(dim))]
    r2 = None
    for a in range(dim):
        x = row(cell, a, frac)
        r2 = x * x if r2 is None else r2 + x * x
    return _numpy_bins(r2, r_max, n_bins), r2


@pytest.mark.parametrize("displaced", [False, True],
                         ids=["inside", "displaced"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("box", BOXES)
def test_cell_route_pairs_give_the_jax_counts(box, dtype, displaced):
    """A plain pass over exactly the pairs that the cell route's plan
    visits (its grid, the binning of ``bin_by_cell``, the half stencil)
    gives the JAX package's dense histogram, bin for bin up to the
    near-edge allowance; the kernel's edge rule bins those pairs as the
    plain formula does. Displaced: every particle moved by whole box
    vectors (up to 4 each way), which the margin covers."""
    jdt, ndt = DTYPES[dtype]
    cell = _box(box)
    dim = cell.shape[0]
    pos = _positions(cell, seed=5)
    if displaced:
        shift = np.random.default_rng(6).integers(-4, 5, size=pos.shape)
        pos = pos + shift @ cell.T
    pos = pos.astype(ndt)
    cell_n, inv_n = cell.astype(ndt), np.linalg.inv(cell).astype(ndt)
    r_max, n_bins = (3.0 if dim == 2 else 2.0), 60
    t_pos, t_cell, t_inv = (torch.from_numpy(a) for a in (pos, cell_n,
                                                          inv_n))
    plan = rdf.rdf_plan(t_pos, t_cell, t_inv, r_max, n_bins,
                        route=rdf.CELL)
    assert plan.route == rdf.CELL and min(plan.grid) >= 4
    cid = rdf.bin_by_cell(plan.frac, plan.grid)[0].numpy()
    pairs = _cell_route_pairs(plan.frac.numpy(), plan.grid, cid)
    assert len(pairs) < N_RDF * (N_RDF - 1) // 4
    bins, r2 = _plain_pair_bins(pos, cell_n, inv_n, pairs, r_max, n_bins)
    np.testing.assert_array_equal(
        _edge_rule(r2, rdf.bin_edges(ndt, r_max, n_bins)), bins)
    got = 2 * np.bincount(bins, minlength=n_bins + 1)[:n_bins]
    ref = np.asarray(jobs.rdf_histogram(
        jnp.asarray(pos, jdt), jnp.asarray(cell_n, jdt),
        jnp.asarray(inv_n, jdt), r_max, n_bins))
    diff = int(np.abs(got - ref).sum())
    if diff:
        excused = _near_edges(pos.astype(np.float64), cell, r_max, n_bins)
        assert diff <= 2 * excused, (diff, excused)
    assert int(got.sum()) == int(ref.sum()) > 0


def test_plan_routes():
    """The tile route below 3 cells an axis (half the width), where the
    stencil covers more than CELL_SHARE_MAX of the box (4 cells an axis),
    and for positions so far out that the float32 margin leaves fewer than
    3 (float64's still leaves 14); the cell route at r_max 3 in the bench
    box; CELL refused where it cannot be taken."""
    L = (65536 / 0.8) ** (1 / 3)
    cell = torch.eye(3, dtype=torch.float32) * L
    inv = torch.eye(3, dtype=torch.float32) / L
    pos = torch.rand((65536, 3), generator=torch.Generator().manual_seed(0)
                     ) * L
    plan = rdf.rdf_plan(pos, cell, inv, 3.0)
    assert plan.route == rdf.CELL and plan.grid == (14, 14, 14)
    assert plan.pattern == rdf.DIAGONAL
    for r_max in (L / 2, L / 3, L / 4.05):
        assert rdf.rdf_plan(pos, cell, inv, r_max).route == rdf.TILE
    assert rdf.rdf_plan(pos, cell, inv, L / 4.05, route=rdf.CELL).grid == (
        4, 4, 4)
    with pytest.raises(ValueError, match="3 cells"):
        rdf.rdf_plan(pos, cell, inv, L / 2, route=rdf.CELL)
    far = pos + 1e6 * L
    assert rdf.rdf_plan(far, cell, inv, 3.0).route == rdf.TILE
    assert rdf.rdf_plan(far.double(), cell.double(), inv.double(),
                        3.0).route == rdf.CELL
    assert rdf.rdf_plan(pos, cell, inv, 3.0, route=rdf.TILE).route == \
        rdf.TILE
    assert rdf.cell_grid_for(cell.numpy(), inv.numpy(), 3.0, np.float32,
                             1.0, 100) == (4, 4, 4)   # at most N cells


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_zero_pattern(dtype):
    """Diagonal for an orthorhombic cell, upper triangular for the tilted
    boxes (their numpy inverses keep the zeros), general for a rotated
    cell, in the dtype."""
    for box, want in (("cubic", rdf.DIAGONAL), ("tilted3d", rdf.UPPER),
                      ("tilted2d", rdf.UPPER)):
        cell = _box(box)
        inv = np.linalg.inv(cell)
        assert rdf.zero_pattern(cell.astype(dtype), inv.astype(dtype)) == \
            want
        rot = _rotation(cell.shape[0]) @ cell
        assert rdf.zero_pattern(rot.astype(dtype),
                                np.linalg.inv(rot).astype(dtype)) == \
            rdf.GENERAL


def _states(dim=3, seed=4, dtype=torch.float64):
    """A port state and the JAX package's view of the same fields."""
    cell = _box("tilted2d" if dim == 2 else "tilted3d")
    rng = np.random.default_rng(seed)
    pos = _positions(cell, seed)
    images = rng.integers(-3, 4, size=pos.shape)
    state = build_state_from_arrays(pos, np.ones(N_RDF), cell, dtype=dtype,
                                    device="cpu")
    state = state.replace(images=torch.tensor(images))
    fields = {"positions": jnp.asarray(pos), "unitcell": jnp.asarray(cell),
              "unitcell_inv": jnp.asarray(np.linalg.inv(cell)),
              "images": jnp.asarray(images, jnp.int32)}
    return state, fields


def test_rdf_normalize_and_sample_rdf_match_jax():
    counts = np.random.default_rng(1).integers(0, 1000, size=200)
    for dim in (2, 3):
        got = tobs.rdf_normalize(torch.tensor(counts), 900, 1234.5, 3.0,
                                 n_frames=3, dim=dim)
        ref = jobs.rdf_normalize(counts, 900, 1234.5, 3.0, n_frames=3,
                                 dim=dim)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
        state, f = _states(dim)

        class View:  # what jobs.sample_rdf reads of a state
            positions, unitcell = f["positions"], f["unitcell"]
            unitcell_inv = f["unitcell_inv"]
            n_particles, dimension = N_RDF, dim

        ref_r, ref_g = jobs.sample_rdf(View, n_bins=150)
        got_r, got_g = tobs.sample_rdf(state, n_bins=150)
        np.testing.assert_allclose(got_r, ref_r, rtol=1e-12, atol=0)
        np.testing.assert_allclose(got_g, ref_g, rtol=1e-12, atol=0)


def test_mean_squared_displacement_matches_jax():
    state, f = _states(seed=6)
    rng = np.random.default_rng(7)
    ref_pos = np.asarray(f["positions"]) + rng.normal(size=(N_RDF, 3))

    class View:
        positions, images, unitcell = (f["positions"], f["images"],
                                       f["unitcell"])

    ref = jobs.mean_squared_displacement(View, jnp.asarray(ref_pos))
    got = tobs.mean_squared_displacement(state, ref_pos)
    assert ref > 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_read_thermo_matches_jax(tmp_path):
    path = tmp_path / "thermo.txt"
    path.write_text("# Step Energy Temperature Pressure\n"
                    "0 -5.123456 1.000000 0.250000\n"
                    "100 -5.200000 0.987654 -0.012345\n")
    got, ref = tobs.read_thermo(str(path)), jobs.read_thermo(str(path))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


def test_validate_torch_oracles_equal_validate_py():
    """``validate_torch.py`` keeps its own copy of ``validate.py``'s
    quadratures, SEM and fit (that script imports JAX): the same values."""
    import validate
    import validate_torch

    assert validate_torch.BOYLE_T == validate.BOYLE_T
    for t in (1.0, 2.0, validate.BOYLE_T):
        assert validate_torch.lj_b2(t) == validate.lj_b2(t)
        assert validate_torch.lj_u2(t) == validate.lj_u2(t)
    series = np.random.default_rng(2).normal(size=1234)
    assert validate_torch.block_sem(series) == validate.block_sem(series)
    assert validate_torch.block_sem(series[:5]) == \
        validate.block_sem(series[:5])
    fit = ((0.02, 0.05, 0.08), (0.975, 0.94, 0.91), (1e-3, 2e-3, 3e-3))
    assert validate_torch.fit_b2_b3(*fit) == validate.fit_b2_b3(*fit)
