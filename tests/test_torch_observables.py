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
  * the kernel's schedule (row tiles, column spans, the diagonal tile from
    j > i), emulated in Python: every unordered pair exactly once;
  * ``rdf_normalize`` and ``sample_rdf`` at rel 1e-12, the mean-squared
    displacement at rel 1e-12, ``read_thermo`` equal;
  * ``validate_torch.py``'s oracles equal ``validate.py``'s."""

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


def _kernel_pairs(n, rows=128, span=16):
    """The (i, j) pairs ``csrc/rdf_histogram.cu`` evaluates, by its
    schedule: block (x, y) owns row tile x and walks the column tiles
    max(x, y span) .. min(tiles, (y + 1) span) - 1; the diagonal tile from
    j > i."""
    tiles = -(-n // rows)
    pairs = []
    for x in range(tiles):
        for y in range(-(-tiles // span)):
            for tile in range(max(x, y * span), min(tiles, (y + 1) * span)):
                for i in range(x * rows, min(n, (x + 1) * rows)):
                    start = i + 1 if tile == x else tile * rows
                    pairs += [(i, j) for j in
                              range(start, min(n, (tile + 1) * rows))]
    return pairs


@pytest.mark.parametrize("n,rows,span", [(2, 128, 16), (300, 128, 16),
                                         (1000, 16, 3), (97, 8, 2)])
def test_kernel_schedule_visits_each_pair_once(n, rows, span):
    pairs = _kernel_pairs(n, rows, span)
    assert len(pairs) == len(set(pairs)) == n * (n - 1) // 2
    assert all(i < j for i, j in pairs)


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
