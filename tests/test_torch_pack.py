"""Random packing (``mdtpu_torch.sim.pack``) and ``initialize_state`` modes
C and D against the JAX package on the CPU, with JAX's uniform draws
replayed through the port's one seam (``pack.uniform_fractions``):

  * ``OverlapPotential``: its plain cell sweep (``cell_sweep_plain``, the
    kernel's plain version) and the naive engine against the JAX package's
    ``OverlapPotential`` through its naive engine, on uniform random
    positions full of overlaps (f64: energy and virial to rel 1e-12, forces
    to 1e-12 of the largest);
  * ``pack_positions`` (N = 128, rho 0.5, the naive engine on both sides):
    positions to 1e-8, no pair closer than tol;
  * modes C (a box given as three lengths) and D (the default cubic box):
    the same positions as the JAX package's ``initialize_state`` to 1e-8,
    and ``init.xyz`` written;
  * a packer that runs out of iterations raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdtpu_torch
from mdtpu.core.types import Parameters as JParameters
from mdtpu.ops.naive import NaivePairEngine as JNaive
from mdtpu.potentials.pseudo_hs import PseudoHS as JPHS
from mdtpu.sim.initialization import initialize_state as j_initialize_state
from mdtpu.sim.pack import OverlapPotential as JOverlap
from mdtpu.sim.pack import pack_positions as j_pack_positions
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.cell_sweep import cell_sweep_plain, kernel_params
from mdtpu_torch.sim import pack
from mdtpu_torch.sim.pack import OverlapPotential
from tests.test_torch_driver import one_torch_thread  # noqa: F401

N, RHO = 128, 0.5


def _replay(monkeypatch, key):
    """The port's seam hands out JAX's draws of ``key``."""
    def draws(seed, shape, dtype, device):
        u = jax.random.uniform(key, tuple(shape), dtype=jnp.float64)
        return torch.as_tensor(np.array(u), dtype=dtype, device=device)

    monkeypatch.setattr(pack, "uniform_fractions", draws)


def _min_distance(pos, L):
    d = pos[:, None, :] - pos[None, :, :]
    d -= L * np.round(d / L)
    r = np.sqrt((d * d).sum(-1))
    return r[~np.eye(len(pos), dtype=bool)].min()


def test_overlap_potential_matches_jax():
    rng = np.random.default_rng(0)
    n, L = 3000, 14.0
    pos = rng.uniform(0, L, (n, 3))
    cell = np.eye(3) * L
    je, jw, jf, _ = JNaive(potential=JOverlap(tol=1.0), cutoff=1.0).compute(
        jnp.asarray(pos), jnp.ones(n), jnp.asarray(cell),
        jnp.asarray(np.linalg.inv(cell)), ())
    jf = np.array(jf)
    pot = OverlapPotential(tol=1.0)
    assert kernel_params(pot)[0] == 3 and pot.max_cutoff() == 1.0
    t = torch.from_numpy
    te, tw, tf, _ = mdtpu_torch.NaivePairEngine(potential=pot,
                                                cutoff=1.0).compute(
        t(pos), torch.ones(n, dtype=torch.float64), t(cell),
        t(np.linalg.inv(cell)), ())
    engine = CellGridEngine.create(pot, 1.0, 0.3, cell, n)
    nbrs = engine.allocate(t(pos), torch.ones(n, dtype=torch.float64),
                           t(cell), t(np.linalg.inv(cell)))
    slot_pos, slot_diam, counts, box = engine.slot_inputs(
        t(pos), t(cell), t(np.linalg.inv(cell)), nbrs)
    ce, cw, cf = cell_sweep_plain(slot_pos, slot_diam, counts, box,
                                  engine.grid, engine.cutoff, pot)
    cf = torch.cat([cf, cf.new_zeros((3, 1))], dim=1)[:, nbrs.addr].T
    scale = np.abs(jf).max()
    assert float(je) > 100.0                       # many overlapping pairs
    for e, w, f in ((te, tw, tf), (ce, cw, cf)):
        np.testing.assert_allclose(float(e), float(je), rtol=1e-12)
        np.testing.assert_allclose(float(w), float(jw), rtol=1e-12)
        np.testing.assert_allclose(f.numpy(), jf, rtol=0,
                                   atol=1e-12 * scale)


def test_pack_positions_matches_jax_with_replayed_draws(monkeypatch):
    L = (N / RHO) ** (1 / 3)
    key = jax.random.PRNGKey(21)
    jpos = np.array(j_pack_positions(key, jnp.eye(3) * L, N, 3, tol=1.0,
                                     dtype=jnp.float64))
    _replay(monkeypatch, key)
    pos = pack.pack_positions(5, np.eye(3) * L, N, 3, tol=1.0,
                              dtype=torch.float64, device="cpu").numpy()
    np.testing.assert_allclose(pos, jpos, rtol=0, atol=1e-8)
    assert _min_distance(pos, L) > 1.0 - 1e-6
    assert pos.min() >= 0.0 and pos.max() < L


@pytest.mark.parametrize("box", [None, (9.0, 7.0, 8.0)], ids=["D", "C"])
def test_initialize_state_packs_like_jax(monkeypatch, tmp_path, box):
    seed = 9
    jparams = JParameters(density=RHO, n_particles=N, dt=1e-5,
                          potential=JPHS())
    jstate = j_initialize_state(jparams, str(tmp_path / "jax"), seed=seed,
                                unitcell=box, dtype=jnp.float64)
    _, pack_key = jax.random.split(jax.random.PRNGKey(seed))
    _replay(monkeypatch, pack_key)
    params = mdtpu_torch.Parameters(RHO, N, 1e-5, mdtpu_torch.PseudoHS())
    state = mdtpu_torch.initialize_state(params, str(tmp_path / "port"),
                                         seed=seed, unitcell=box,
                                         dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(state.unitcell.numpy(),
                               np.array(jstate.unitcell))
    np.testing.assert_allclose(state.positions.numpy(),
                               np.array(jstate.positions), rtol=0, atol=1e-8)
    assert torch.equal(state.diameters, torch.ones(N, dtype=torch.float64))
    assert (tmp_path / "port" / "init.xyz").is_file()
    lines = (tmp_path / "port" / "init.xyz").read_text().splitlines()
    assert len(lines) == N + 2 and lines[0] == str(N)


def test_packer_that_runs_out_of_steps_raises():
    with pytest.raises(RuntimeError, match="packing failed"):
        pack.pack_positions(1, np.eye(3) * 5.0, 200, 3, tol=1.0,
                            dtype=torch.float64, max_steps=3, device="cpu")
