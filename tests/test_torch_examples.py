"""The port's five examples (``examples_torch/``) on the CPU, as
``tests/test_examples.py`` runs the JAX package's: each ``main`` at the same
tiny sizes with ``device="cpu"``, into ``tmp_path``, asserting the files
its JAX twin's test asserts and the others the example writes. Example 05
runs on a 2-rank gloo group of spawned processes (``spawn_ranks`` of
``tests/test_torch_halo_slot.py``; the ranks' target,
``tests/torch_examples.py``, imports no JAX), started when the module
starts so that the ranks run beside the other examples.

Example 03 is also held against the JAX example, both at n_particles=200.
The same numpy snapshot gives ``start.xyz`` byte for byte. FIRE on this
random, overlapping start is chaotic: the two packages' ``minimize`` agree
to rel 1e-10 after 30 iterations, 1e-8 after 40, and part by 100 (neither
converges within its 10,000 iterations; ROADMAP C8). So both examples'
``minimize`` is held to ``FIRE_ITERS`` = 30 iterations here: its energy
and the ``minimized.xyz`` numbers agree to rel 1e-9. Then 400 NVT steps
(thermo and frames every 200) with the port's velocities and Bussi draws
replaced by the JAX example's: thermo rows and ``final.xyz`` numbers to rel
1e-9."""

import os

import numpy as np
import pytest
import torch

from tests.test_torch_driver import one_torch_thread  # noqa: F401
from tests.test_torch_halo_slot import spawn_ranks
from tests.torch_examples import ROOT, load_example

FIRE_ITERS = 30
SHARDED_N, SHARDED_STEPS = 1536, 60


def _rows(path):
    return np.loadtxt(path, ndmin=2)


def _assert_finite_rows(path, n_rows):
    rows = _rows(path)
    assert rows.shape == (n_rows, 4)
    assert np.all(np.isfinite(rows))


@pytest.fixture(scope="module")
def sharded_ranks(tmp_path_factory):
    """Example 05 on two gloo ranks, started now; ``wait()`` joins them."""
    workdir = str(tmp_path_factory.mktemp("example05"))
    out = os.path.join(workdir, "shard")
    wait = spawn_ranks(os.path.join(workdir, "ranks"),
                       ("tests.torch_examples", "sharded_example"),
                       (out, SHARDED_N, SHARDED_STEPS))
    return out, wait


@pytest.fixture(autouse=True, scope="module")
def start_ranks_first(sharded_ranks):
    """Every test of the module requests the spawn, so it starts first."""


def test_example_pseudohs_nvt_nve(tmp_path):
    mod = load_example("01_pseudohs_nvt_nve")
    state = mod.main(n_particles=256, nvt_steps=60, nve_steps=60,
                     out=str(tmp_path / "phs"), device="cpu")
    assert float(state.temperature) > 0
    assert (tmp_path / "phs_nve" / "thermo.txt").exists()
    assert (tmp_path / "phs_nve" / "trajectory.xyz.zst").is_file()
    for leg in ("phs", "phs_nve"):
        _assert_finite_rows(tmp_path / leg / "thermo.txt", 1)
        assert (tmp_path / leg / "final.xyz").is_file()


def test_example_brownian(tmp_path):
    mod = load_example("02_brownian")
    state = mod.main(n_particles=256, steps=60, out=str(tmp_path / "brw"),
                     device="cpu")
    assert state.step == 60
    assert (tmp_path / "brw" / "thermo.txt").exists()
    assert (tmp_path / "brw" / "snapshot.0").is_file()
    assert (tmp_path / "brw" / "new-log-times.txt").is_file()


def test_example_polydisperse_2d(tmp_path):
    mod = load_example("03_polydisperse_2d")
    mod.main(n_particles=200, steps=60, out=str(tmp_path / "poly"),
             device="cpu")
    assert (tmp_path / "poly" / "thermo.txt").exists()
    for name in ("start.xyz", "minimized.xyz", "final.xyz"):
        assert (tmp_path / "poly" / name).is_file()


def test_example_quench_fire(tmp_path):
    mod = load_example("04_quench_fire")
    mod.main(n_particles=128, ramp_steps=80, out=str(tmp_path / "quench"),
             device="cpu")
    assert (tmp_path / "quench" / "thermo.txt").exists()
    assert (tmp_path / "quench" / "minimized.xyz").is_file()


def test_example_sharded_multichip(sharded_ranks):
    out, wait = sharded_ranks
    ranks = wait()
    assert [r["world"] for r in ranks] == [2, 2]
    assert all(r["step"] == SHARDED_STEPS for r in ranks)
    np.testing.assert_array_equal(ranks[0]["positions"],
                                  ranks[1]["positions"])
    assert ranks[0]["temperature"] == ranks[1]["temperature"] > 0
    assert os.path.exists(os.path.join(out, "thermo.txt"))
    _assert_finite_rows(os.path.join(out, "thermo.txt"), 1)
    traj = open(os.path.join(out, "trajectory.xyz")).read()
    assert traj.count("ITEM: TIMESTEP") == 1


def _numbers(path):
    with open(path) as f:
        return [line.split() for line in f]


def _assert_same_numbers(path_t, path_j, rtol):
    """Token for token: words equal, numbers to ``rtol``."""
    a, b = _numbers(path_t), _numbers(path_j)
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for ta, tb in zip(ra, rb):
            try:
                x, y = float(ta), float(tb)
            except ValueError:
                assert ta == tb
                continue
            assert abs(x - y) <= rtol * abs(y), (ta, tb)


def test_example_polydisperse_2d_matches_jax(tmp_path, monkeypatch):
    import importlib.util

    import jax
    import jax.numpy as jnp

    import mdtpu
    from mdtpu_torch.integrate import thermostat as tthermo
    from tests.test_torch_thermostat import jax_bussi_draws

    spec = importlib.util.spec_from_file_location(
        "examples_jax_03", os.path.join(ROOT, "examples",
                                        "03_polydisperse_2d.py"))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    tmod = load_example("03_polydisperse_2d")

    minimized = {}

    def held(tag, fn):
        def run(*args, **kwargs):
            out = fn(*args, max_steps=FIRE_ITERS, **kwargs)
            minimized[tag] = out
            return out
        return run

    n, steps = 200, 400
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(jmod, "minimize", held("jax", jmod.minimize))
    jfinal = jmod.main(n_particles=n, steps=steps, out=str(jdir))

    vel = np.array(mdtpu.initialize_velocities(
        0.5, jax.random.PRNGKey(1), n, 2, jnp.float64))

    def jax_velocities(ktemp, seed, n_particles, dimension, dtype, device):
        assert (ktemp, seed, n_particles, dimension) == (0.5, 1, n, 2)
        return torch.as_tensor(vel, dtype=dtype, device=device)

    def replay(seed, step, nf, dtype, device):
        r1, r2 = jax_bussi_draws(jfinal.key, step, nf)
        return (torch.tensor(r1, dtype=dtype, device=device),
                torch.tensor(r2, dtype=dtype, device=device))

    monkeypatch.setattr(tmod, "minimize", held("port", tmod.minimize))
    monkeypatch.setattr(tmod, "initialize_velocities", jax_velocities)
    monkeypatch.setattr(tthermo, "bussi_noise", replay)
    tfinal = tmod.main(n_particles=n, steps=steps, out=str(tdir),
                       device="cpu")

    assert (tdir / "start.xyz").read_bytes() == (jdir / "start.xyz").read_bytes()
    (_, je, jconv, jn), (_, te, tconv, tn) = minimized["jax"], minimized["port"]
    assert tn == int(jn) == FIRE_ITERS and tconv == bool(jconv)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-9)
    _assert_same_numbers(tdir / "minimized.xyz", jdir / "minimized.xyz", 1e-9)
    assert tfinal.step == int(jfinal.step) == steps
    rows_t, rows_j = _rows(tdir / "thermo.txt"), _rows(jdir / "thermo.txt")
    assert rows_t.shape == (steps // 200, 4)
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-9, atol=0)
    _assert_same_numbers(tdir / "final.xyz", jdir / "final.xyz", 1e-9)
