"""Independent thermodynamic cross-checks through the port, as
``tests/test_physics_consistency.py`` holds the JAX package:

(a) the virial pressure W/(d V) against a numerical -dU/dV (central
    difference in the box scale, eps 1e-5, fractional coordinates fixed)
    on frozen, wrapped f64 configurations, to rel 1e-6 (abs 1e-9): the
    JAX test's five cases (pseudo-hard spheres in 3D, 2D and a tilted 3D
    box, force-shifted LJ, LJ-XPLOR) through the naive engine and the cell
    grid (the sweep's plain version), and three more: the pair list (a
    user potential, ``examples_torch/03_polydisperse_2d.py``'s, 2D,
    polydisperse), a 3D box tilted in all three angles on the cell grid,
    and the neighbour list. An error in the virial's accumulation, the
    minimum image or a force's sign shows up as a disagreement.

(b) <U/N> and <P> of Bussi-thermostatted MD (the port's ``make_step``,
    naive engine) against the JAX test's independent Metropolis MC sampler
    of the same cut LJ (numpy only, no code shared with either package) at
    rho 0.6, T 1.5, N 64, within the JAX test's 0.10 and 0.30."""

import numpy as np
import pytest
import torch

from mdtpu_torch.core.types import NVT, Parameters
from mdtpu_torch.integrate.step import engine_forces, make_step
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.naive import NaivePairEngine
from mdtpu_torch.ops.neighbor_list import NeighborListEngine
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from mdtpu_torch.potentials.xplor import LennardJonesXPLOR
from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                            initialize_velocities)
from mdtpu_torch.sim.pack import pack_positions
from tests.test_physics_consistency import _N, _RC, _RHO, _T, _mc_averages
from tests.test_torch_driver import one_torch_thread  # noqa: F401
from tests.torch_examples import load_example

EPS = 1e-5
TILTED = [[1.0, 0.125, 1 / 12], [0.0, 1.0, 1 / 6], [0.0, 0.0, 1.0]]


def _user_potential():
    return load_example("03_polydisperse_2d").NonAdditivePHS()


# name -> (potential factory, cutoff, d, box shape, N, rho, polydisperse):
# box "ortho", "xy" (the JAX test's tilt, cell[0, 1] = 0.2 L) or "tilted"
# (TILTED times L). N is the JAX test's 48 where the box fits 3 cells of
# the cutoff (the list: of cutoff + skin), else a round size that does.
CASES = {
    "phs_3d": (PseudoHS, 1.5, 3, "ortho", 48, 0.5, False),
    "phs_2d": (PseudoHS, 1.5, 2, "ortho", 48, 0.5, False),
    "phs_3d_xy_tilt": (PseudoHS, 1.5, 3, "xy", 64, 0.5, False),
    "lj_force_shift": (lambda: LennardJones(r_cut=2.5, force_shift=True),
                       2.5, 3, "ortho", 256, 0.5, False),
    "xplor": (lambda: LennardJonesXPLOR(r_on=2.0, r_cut=2.5), 2.5, 3,
              "ortho", 256, 0.5, False),
    "user_2d": (_user_potential, 1.8, 2, "ortho", 64, 0.9, True),
    "lj_tilted": (lambda: LennardJones(r_cut=2.5, force_shift=True), 2.5, 3,
                  "tilted", 512, 0.5, False),
    "lj_list": (lambda: LennardJones(r_cut=2.5, force_shift=True), 2.5, 3,
                "ortho", 512, 0.5, False),
}
ENGINES = [(case, engine) for case in list(CASES)[:5]
           for engine in ("naive", "cellgrid")]
ENGINES += [("user_2d", "cellgrid"), ("lj_tilted", "cellgrid"),
            ("lj_list", "neighbor")]


def _frozen_config(n, rho, d, box, seed, poly):
    L = (n / rho) ** (1.0 / d)
    cell = np.eye(d) * L
    if box == "xy":
        cell[0, 1] = 0.2 * L
    elif box == "tilted":
        cell = np.asarray(TILTED) * L
    pos = pack_positions(seed, cell, n, d, tol=0.9, dtype=torch.float64,
                         device="cpu")
    frac = pos.numpy() @ np.linalg.inv(cell).T
    assert frac.min() >= 0.0 and frac.max() < 1.0  # engines take wrapped
    diam = (np.random.default_rng(seed).uniform(0.8, 1.2, n) if poly
            else np.ones(n))
    return pos.numpy(), diam, cell


def _engine(kind, pot, cutoff, cell, n, diam):
    """The engine, sized for the smallest box of the difference."""
    small = cell * (1 - EPS)
    if kind == "naive":
        return NaivePairEngine(potential=pot, cutoff=cutoff)
    if kind == "cellgrid":
        return CellGridEngine.create(pot, cutoff, 0.0, small, n,
                                     diameters=diam)
    return NeighborListEngine.create(pot, cutoff, 0.3, small, n)


def _energy_virial(engine, pos, diam, cell):
    state = build_state_from_arrays(pos, diam, cell, dtype=torch.float64,
                                    cutoff=engine.cutoff, device="cpu")
    args = (state.positions, state.diameters, state.unitcell,
            state.unitcell_inv)
    e, w, _, nbrs = engine.compute(*args, engine.allocate(*args))
    assert not bool(getattr(nbrs, "overflow", False))
    return float(e), float(w)


@pytest.mark.parametrize("case,kind", ENGINES,
                         ids=[f"{c}-{k}" for c, k in ENGINES])
def test_virial_matches_volume_derivative(case, kind):
    """W/(d V) == -dU/dV under affine volume scaling (fixed fractional
    coordinates, fixed cutoff), for any pair potential smooth at the
    cutoff. Convention: P_excess = W/(d V) with W = sum_{i<j} f_ij r_ij
    (MolecularDynamics.jl src/pairwise.jl:32-33,
    src/simulation.jl:129-131)."""
    make_pot, cutoff, d, box, n, rho, poly = CASES[case]
    pot = make_pot()
    pos, diam, cell = _frozen_config(n, rho, d, box, 3, poly)
    engine = _engine(kind, pot, cutoff, cell, n, diam)
    if kind == "cellgrid":
        assert engine.uses_pair_list == (case == "user_2d")

    e, w = _energy_virial(engine, pos, diam, cell)
    assert e > 0 or e < 0  # pairs interact
    vol = abs(float(np.linalg.det(cell)))
    p_virial = w / (d * vol)
    u_plus, _ = _energy_virial(engine, pos * (1 + EPS), diam, cell * (1 + EPS))
    u_minus, _ = _energy_virial(engine, pos * (1 - EPS), diam,
                                cell * (1 - EPS))
    dv = vol * ((1 + EPS) ** d - (1 - EPS) ** d)
    p_deriv = -(u_plus - u_minus) / dv
    assert p_virial == pytest.approx(p_deriv, rel=1e-6, abs=1e-9), (
        f"virial route {p_virial} vs -dU/dV route {p_deriv}")


def _md_averages(L, n_equil=1500, n_samples=400, stride=10, seed=11):
    pot = LennardJones(r_cut=_RC)
    params = Parameters(density=_RHO, n_particles=_N, dt=0.002, potential=pot)
    engine = NaivePairEngine(potential=pot, cutoff=_RC)
    cell = np.eye(3) * L
    pos = pack_positions(seed, cell, _N, 3, tol=0.9, dtype=torch.float64,
                         device="cpu")
    state = build_state_from_arrays(pos, np.ones(_N), cell, seed + 2,
                                    dtype=torch.float64, cutoff=_RC,
                                    device="cpu")
    state = state.replace(velocities=initialize_velocities(
        _T, seed + 1, _N, 3, dtype=torch.float64, device="cpu"))
    e, w, f, nbrs = engine_forces(engine, state.positions, state.diameters,
                                  state.unitcell, state.unitcell_inv, None)
    state = state.replace(forces=f, energy=e, virial=w, nbrs=nbrs)
    step = make_step(params, NVT(_T, 0.2), engine)
    for _ in range(n_equil):
        state = step(state)
    us, ws = [], []
    for _ in range(n_samples):
        for _ in range(stride):
            state = step(state)
        us.append(float(state.energy))
        ws.append(float(state.virial))
    vol = L ** 3
    return np.mean(us) / _N, _RHO * _T + np.mean(ws) / (3.0 * vol)


def test_md_matches_mc_canonical_averages():
    """<U/N> and <P> from Bussi-thermostatted MD agree with an independent
    Metropolis MC sampler of the same cut-LJ Hamiltonian at (rho=0.6,
    T=1.5). MC is exactly canonical, so agreement validates both the
    thermostat's sampling and the virial pressure end to end. Tolerances
    are the JAX test's, ~4x the combined statistical error of the two
    finite runs (systematic thermostat or virial errors are 10-100x)."""
    L = (_N / _RHO) ** (1.0 / 3.0)
    u_mc, p_mc = _mc_averages(L)
    u_md, p_md = _md_averages(L)
    assert u_md == pytest.approx(u_mc, abs=0.10), (
        f"<U/N>: MD {u_md:.4f} vs MC {u_mc:.4f}")
    assert p_md == pytest.approx(p_mc, abs=0.30), (
        f"<P>: MD {p_md:.4f} vs MC {p_mc:.4f}")
