"""The reference's end-to-end behaviours through the port, as
``tests/test_reference_parity.py`` holds the JAX package to them: every
export of MolecularDynamics.jl (src/MolecularDynamics.jl:29-35) has an
``mdtpu_torch`` counterpart, ``Parameters`` keeps the reference's field
order, the thermo rows carry the long-range correction (tail minus plain
run: energy_lrc / N and pressure_lrc, within 2e-5 absolute; the tail run's
rows equal the JAX package's from the same carried state to rel 1e-9), the
Brownian row prints kT and the pressure of the 10-step-averaged virial, and
rows are ``"%d %.6f %.6f %.6f"`` under the reference's header."""

import os

import numpy as np
import pytest
import torch

import mdtpu_torch
from mdtpu_torch.interop import state_from_numpy
from tests.test_reference_parity import REFERENCE_EXPORTS
from tests.test_torch_driver import one_torch_thread  # noqa: F401

_CARRIED = ("positions", "velocities", "forces", "images", "diameters",
            "unitcell", "unitcell_inv", "step", "nf", "energy", "virial",
            "temperature", "pos_comp", "vel_comp")


def carry_state(jstate):
    """The JAX package's state as the port's, on the CPU."""
    fields = {name: np.asarray(getattr(jstate, name)) for name in _CARRIED}
    fields["cutoff"] = jstate.cutoff
    return state_from_numpy(fields, device="cpu")


def _rows(path):
    with open(os.path.join(path, "thermo.txt")) as f:
        return [tuple(map(float, r.split())) for r in f.read().splitlines()[1:]]


def test_all_reference_exports_present():
    missing = [name for name in REFERENCE_EXPORTS
               if not hasattr(mdtpu_torch, name)]
    assert not missing, f"missing reference exports: {missing}"


def test_parameters_field_order_matches_reference():
    # MolecularDynamics.jl src/types.jl:8-13: (rho, n_particles, dt,
    # potential)
    p = mdtpu_torch.Parameters(0.76, 1024, 0.001, mdtpu_torch.PseudoHS())
    assert float(p.density) == 0.76
    assert p.n_particles == 1024
    assert float(p.dt) == 0.001
    assert isinstance(p.potential, mdtpu_torch.PseudoHS)


def test_lrc_appears_in_thermo_output(tmp_path):
    # MolecularDynamics.jl src/simulation.jl:118-131: thermo energy
    # includes energy_lrc/N; pressure includes pressure_lrc.
    import jax
    import jax.numpy as jnp

    import mdtpu

    n = 64
    jpot = mdtpu.LennardJones(r_cut=1.5, tail_correction=True)
    jparams = mdtpu.Parameters(density=0.5, n_particles=n, dt=1e-4,
                               potential=jpot)
    jdir = str(tmp_path / "jax")
    jstate = mdtpu.initialize_state(jparams, jdir, dimension=3, cutoff=1.5,
                                    seed=3, dtype=jnp.float64)
    jstate = jstate.replace(velocities=mdtpu.initialize_velocities(
        1.0, jax.random.PRNGKey(1), n, 3, jnp.float64))
    mdtpu.run_simulation(jstate, jparams, mdtpu.NVE(), total_steps=2,
                         frequency=1, pathname=jdir)
    state = carry_state(jstate)

    pot_plain = mdtpu_torch.LennardJones(r_cut=1.5)
    pot_tail = mdtpu_torch.LennardJones(r_cut=1.5, tail_correction=True)

    def run(pot, out):
        params = mdtpu_torch.Parameters(density=0.5, n_particles=n, dt=1e-4,
                                        potential=pot)
        mdtpu_torch.run_simulation(state, params, mdtpu_torch.NVE(),
                                   total_steps=2, frequency=1, pathname=out,
                                   device="cpu")
        return _rows(out)

    rows_plain = run(pot_plain, str(tmp_path / "plain"))
    rows_tail = run(pot_tail, str(tmp_path / "tail"))

    volume = n / 0.5
    e_lrc = float(pot_tail.energy_lrc(n, volume)) / n
    p_lrc = float(pot_tail.pressure_lrc(n, volume))
    assert abs(e_lrc) > 1e-6 and abs(p_lrc) > 1e-6
    # identical trajectories (same state, engine); columns differ by the LRC
    np.testing.assert_allclose(rows_tail[0][1] - rows_plain[0][1], e_lrc,
                               atol=2e-5)
    np.testing.assert_allclose(rows_tail[0][3] - rows_plain[0][3], p_lrc,
                               atol=2e-5)
    assert len(rows_tail) == 2
    np.testing.assert_allclose(rows_tail, _rows(jdir), rtol=1e-9, atol=0)


def test_brownian_pressure_uses_10step_averaged_virial(tmp_path):
    # MolecularDynamics.jl src/simulation.jl:253-266: P = W_avg/(d*nprom*V)
    # + rho*kT with W sampled every 10 steps, and T column = ktemp. The
    # rows of a 40-step run against the JAX package's, its noise replayed
    # (P at steps 10-30 averages two to four samples), are held to rel 1e-9
    # by tests/test_torch_brownian.py::
    # test_run_matches_jax_with_replayed_noise; here the row at step 0
    # holds its one sample, the start's virial.
    n = 32
    pot = mdtpu_torch.PseudoHS()
    params = mdtpu_torch.Parameters(density=0.3, n_particles=n, dt=1e-5,
                                    potential=pot)
    out = str(tmp_path / "br")
    state = mdtpu_torch.initialize_state(params, out, dimension=3,
                                         cutoff=1.5, seed=5,
                                         dtype=torch.float64, device="cpu")
    mdtpu_torch.run_simulation(state, params, mdtpu_torch.Brownian(1.3),
                               total_steps=25, frequency=25, pathname=out,
                               device="cpu")
    rows = _rows(out)
    assert len(rows) == 1
    step, e, t, p = rows[0]
    assert t == pytest.approx(1.3)
    assert np.isfinite(p)
    engine = mdtpu_torch.NaivePairEngine(potential=pot, cutoff=1.5)
    _, w, _, _ = engine.compute(state.positions, state.diameters,
                                state.unitcell, state.unitcell_inv)
    volume = n / 0.3
    assert p == pytest.approx(float(w) / (3 * volume) + 0.3 * 1.3, abs=2e-6)


def test_thermo_format_matches_reference(tmp_path):
    # "%d %.6f %.6f %.6f" rows under "# Step Energy Temperature Pressure"
    # (MolecularDynamics.jl src/simulation.jl:54-58).
    n = 32
    params = mdtpu_torch.Parameters(density=0.3, n_particles=n, dt=1e-4,
                                    potential=mdtpu_torch.PseudoHS())
    out = str(tmp_path / "fmt")
    state = mdtpu_torch.initialize_state(params, out, dimension=3,
                                         cutoff=1.5, seed=6,
                                         dtype=torch.float64, device="cpu")
    mdtpu_torch.run_simulation(state, params, mdtpu_torch.NVE(),
                               total_steps=3, frequency=1, pathname=out,
                               device="cpu")
    lines = open(os.path.join(out, "thermo.txt")).read().splitlines()
    assert lines[0] == "# Step Energy Temperature Pressure"
    assert len(lines) == 4
    for line in lines[1:]:
        cols = line.split()
        assert len(cols) == 4
        assert cols[0].isdigit()
        for c in cols[1:]:
            assert len(c.split(".")[-1]) == 6  # %.6f
