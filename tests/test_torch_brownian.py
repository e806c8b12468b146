"""Brownian dynamics and log-time snapshots: the port against the JAX
package, with JAX's uniform noise replayed through the port's one noise seam
(``integrate.step.brownian_noise``).

  * run level: ``run_simulation(Brownian, log_times=True)`` at f64 (N = 512
    pseudo-hard spheres, the O(N^2) engine in both): thermo rows to rel
    1e-9, final positions to 1e-9 absolute, the same snapshot steps and
    ``new-log-times.txt``, snapshot numbers to 2e-6 (they are written as
    float32 with 6 decimals);
  * step level: ``make_brownian_step`` on the port's ``PlaneEngine`` against
    the JAX package's on its ``CellGridEngine``, 12 steps at f64, positions
    and the virial accumulators to 1e-9;
  * the port's own noise: its moments and its replay rule;
  * ``generate_log_times`` equal to JAX's, and snapshot frames
    byte-identical to JAX's for equal arrays."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdtpu_torch
from mdtpu.core.types import Brownian as JBrownian
from mdtpu.core.types import Parameters as JParameters
from mdtpu.integrate.step import brownian_noise as j_brownian_noise
from mdtpu.integrate.step import make_brownian_step as j_make_brownian_step
from mdtpu.io.lammps import write_lammps_frame as j_write_lammps_frame
from mdtpu.io.logtimes import generate_log_times as j_generate_log_times
from mdtpu.ops.cell_grid import CellGridEngine as JCellGrid
from mdtpu.potentials.pseudo_hs import PseudoHS as JPHS
from mdtpu.sim.driver import run_simulation as j_run_simulation
from mdtpu.sim.initialization import build_state_from_arrays as j_build_state
from mdtpu_torch.integrate import step as tstep
from mdtpu_torch.io.logtimes import generate_log_times
from mdtpu_torch.io.writer import TrajectoryWriter
from mdtpu_torch.ops.experimental import PlaneEngine
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from mdtpu_torch.sim.initialization import build_state_from_arrays
from tests.test_torch_driver import _assert_same_numbers
from tests.test_torch_driver import one_torch_thread  # noqa: F401

RHO, DT, KT, KEY_SEED = 0.7, 1e-5, 1.0, 3


def _arrays(n, seed=5):
    """A jittered simple-cubic lattice at RHO: a few pairs start inside the
    pseudo-hard-sphere range (1.02), none deep in it."""
    rng = np.random.default_rng(seed)
    per = int(round(n ** (1 / 3)))
    L = (n / RHO) ** (1.0 / 3.0)
    idx = np.indices((per,) * 3).reshape(3, -1).T
    pos = np.mod((idx + 0.5) / per * L + 0.03 * rng.normal(size=(n, 3)), L)
    return pos, np.ones(n), np.eye(3) * L


def _replay(monkeypatch, key):
    def noise(seed, step, shape, dtype, device):
        xi = j_brownian_noise(key, step, tuple(shape), jnp.float64, None)
        return torch.as_tensor(np.array(xi), dtype=dtype, device=device)

    monkeypatch.setattr(tstep, "brownian_noise", noise)


def _numbers(path):
    with open(path) as f:
        return [line.split() for line in f]


def test_run_matches_jax_with_replayed_noise(tmp_path, monkeypatch):
    n, steps, freq = 512, 40, 10
    pos, diam, cell = _arrays(n)
    key = jax.random.PRNGKey(KEY_SEED)
    jstate = j_build_state(pos, diam, cell, key, dtype=jnp.float64,
                           cutoff=1.5)
    jparams = JParameters(density=RHO, n_particles=n, dt=DT, potential=JPHS())
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jout = j_run_simulation(jstate, jparams, JBrownian(KT), steps, freq, jdir,
                            log_times=True)

    _replay(monkeypatch, key)
    tstate = build_state_from_arrays(pos, diam, cell, dtype=torch.float64,
                                     cutoff=1.5, device="cpu")
    tparams = mdtpu_torch.Parameters(RHO, n, DT, PseudoHS())
    tout = mdtpu_torch.run_simulation(tstate, tparams,
                                      mdtpu_torch.Brownian(KT), steps, freq,
                                      tdir, log_times=True, device="cpu")
    assert isinstance(tout.nbrs, tuple)          # the O(N^2) engine ran
    assert tout.step == int(jout.step) == steps

    rows_j = np.loadtxt(os.path.join(jdir, "thermo.txt"))
    rows_t = np.loadtxt(os.path.join(tdir, "thermo.txt"))
    assert rows_t.shape == (steps // freq, 4)
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-9, atol=0)
    assert np.all(rows_t[:, 2] == KT)             # T column prints kT
    assert np.any(rows_t[:, 1] > 0)               # pairs interacted
    np.testing.assert_allclose(tout.positions.numpy(),
                               np.asarray(jout.positions), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tout.images.numpy(),
                                  np.asarray(jout.images))

    snaps = sorted(f for f in os.listdir(jdir) if f.startswith("snapshot."))
    assert snaps == sorted(f for f in os.listdir(tdir)
                           if f.startswith("snapshot."))
    assert len(snaps) == 12                       # 0 and the log times < 40
    for name in snaps:
        a = _numbers(os.path.join(tdir, name))
        b = _numbers(os.path.join(jdir, name))
        assert len(a) == len(b) == 9 + n
        for ra, rb in zip(a, b):
            for ta, tb in zip(ra, rb):
                if ta != tb:
                    assert abs(float(ta) - float(tb)) <= 2e-6, (name, ta, tb)
    assert open(os.path.join(tdir, "new-log-times.txt"), "rb").read() == \
        open(os.path.join(jdir, "new-log-times.txt"), "rb").read()
    _assert_same_numbers(os.path.join(tdir, "final.xyz"),
                         os.path.join(jdir, "final.xyz"), 1e-9)


def test_brownian_step_on_plane_engine_matches_jax(monkeypatch):
    n, steps = 512, 12
    pos, diam, cell = _arrays(n, seed=9)
    key = jax.random.PRNGKey(KEY_SEED + 1)
    jengine = JCellGrid.create(JPHS(), 1.5, 0.3, cell, n)
    jparams = JParameters(density=RHO, n_particles=n, dt=DT, potential=JPHS())
    jstep = jax.jit(j_make_brownian_step(jparams, JBrownian(KT), jengine))
    js = j_build_state(pos, diam, cell, key, dtype=jnp.float64, cutoff=1.5)
    js = js.replace(nbrs=jengine.allocate(js.positions, js.diameters,
                                          js.unitcell, js.unitcell_inv))

    _replay(monkeypatch, key)
    engine = PlaneEngine.create(PseudoHS(), 1.5, 0.3, cell, n,
                                cell_capacity=jengine.cell_capacity)
    assert engine.grid == jengine.grid
    tparams = mdtpu_torch.Parameters(RHO, n, DT, PseudoHS())
    tstep_fn = tstep.make_step(tparams, mdtpu_torch.Brownian(KT), engine)
    ts = build_state_from_arrays(pos, diam, cell, dtype=torch.float64,
                                 cutoff=1.5, device="cpu")
    for _ in range(steps):
        js = jstep(js)
        ts = tstep_fn(ts)
    assert float(ts.energy) > 0
    np.testing.assert_allclose(ts.positions.numpy(), np.asarray(js.positions),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(ts.forces.numpy(), np.asarray(js.forces),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(float(ts.virial_accum), float(js.virial_accum),
                               rtol=1e-9)
    assert int(ts.nprom) == int(js.nprom) == 2   # steps 0 and 10
    assert float(ts.temperature) == KT


def test_port_noise_moments_and_replay():
    shape = (200_000, 3)
    xi = tstep.brownian_noise(11, 4, shape, torch.float64, "cpu")
    assert xi.shape == shape
    assert float(xi.abs().max()) <= np.sqrt(3.0)
    # Uniform on [-sqrt 3, sqrt 3]: mean 0, variance 1, fourth moment 9/5.
    # Standard errors at 6e5 draws: 1.3e-3, 1.2e-3, 3.7e-3.
    assert abs(float(xi.mean())) < 6e-3
    assert abs(float(xi.var()) - 1.0) < 6e-3
    assert abs(float((xi ** 4).mean()) - 1.8) < 2e-2
    again = tstep.brownian_noise(11, 4, shape, torch.float64, "cpu")
    assert torch.equal(xi, again)                 # (seed, step) replays
    other = tstep.brownian_noise(11, 5, shape, torch.float64, "cpu")
    assert abs(float((xi * other).mean())) < 6e-3  # steps independent


@pytest.mark.parametrize("kw", [{}, {"max_step": 1000},
                                {"max_iter": 3, "logn": 10, "logbase": 2.0},
                                {"max_step": 5_000_000}])
def test_log_times_match_jax(tmp_path, kw):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    assert generate_log_times(save_dir=str(a), **kw) == \
        j_generate_log_times(save_dir=str(b), **kw)
    assert (a / "new-log-times.txt").read_bytes() == \
        (b / "new-log-times.txt").read_bytes()


def test_snapshot_frames_byte_identical(tmp_path):
    rng = np.random.default_rng(4)
    n = 257
    cell = np.diag(rng.uniform(6.0, 9.0, 3))
    pos = rng.uniform(-0.5, 9.5, (n, 3)).astype(np.float32)
    images = rng.integers(-3, 4, (n, 3)).astype(np.int32)
    diam = rng.uniform(0.9, 1.1, n)
    writer = TrajectoryWriter(str(tmp_path / "traj.xyz"))
    writer.write_snapshot(str(tmp_path / "snapshot.7"), 7, cell, pos, images,
                          diam)
    writer.close()
    j_write_lammps_frame(str(tmp_path / "jax.7"), 7, cell, pos, images, diam,
                         mode="w")
    assert (tmp_path / "snapshot.7").read_bytes() == \
        (tmp_path / "jax.7").read_bytes()
    assert (tmp_path / "traj.xyz").read_bytes() == b""
