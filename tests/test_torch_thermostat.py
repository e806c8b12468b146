"""The port's Bussi thermostat: the rescale factor with injected draws equals
the JAX package's at f64, the draws come from one seeded seam, and repeated
rescaling samples the canonical kinetic-temperature moments (mean T,
variance 2T^2/nf), as in tests/test_thermostat.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdtpu.integrate import thermostat as jthermo
from mdtpu_torch.integrate import thermostat as tthermo
from mdtpu_torch.integrate.ramps import ExponentialRamp, LinearRamp


def jax_bussi_draws(key, step, nf):
    """The draws JAX's bussi_scale_from_kinetic makes from fold_in(key, step)
    (mdtpu/integrate/thermostat.py), as float64."""
    k1, k2 = jax.random.split(jax.random.fold_in(key, step))
    r1 = jax.random.normal(k1, dtype=jnp.float32).astype(jnp.float64)
    r2 = jthermo.sum_noises(k2, jnp.asarray(nf, jnp.float64) - 1.0)
    return float(r1), float(r2)


@pytest.mark.parametrize("step", [0, 7, 123])
def test_bussi_scale_matches_jax(step):
    rng = np.random.default_rng(step)
    n, nf = 256, 3 * 255.0
    v = rng.normal(size=(n, 3)) * 1.3
    key = jax.random.PRNGKey(11)
    kinetic_j = jthermo.compute_kinetic(jnp.asarray(v))
    scale_j = jthermo.bussi_scale_from_kinetic(
        jax.random.fold_in(key, step), kinetic_j, 0.9, jnp.asarray(nf),
        0.002, 0.4, jnp.float64)
    r1, r2 = jax_bussi_draws(key, step, nf)
    kinetic_t = tthermo.compute_kinetic(torch.from_numpy(v))
    np.testing.assert_allclose(float(kinetic_t), float(kinetic_j), rtol=1e-14)
    scale_t = tthermo.bussi_scale_from_kinetic(
        kinetic_t, 0.9, nf, 0.002, 0.4, torch.tensor(r1, dtype=torch.float64),
        torch.tensor(r2, dtype=torch.float64))
    np.testing.assert_allclose(float(scale_t), float(scale_j), rtol=1e-14)
    np.testing.assert_allclose(
        float(tthermo.compute_temperature(torch.from_numpy(v), nf)),
        float(jthermo.compute_temperature(jnp.asarray(v), nf)), rtol=1e-14)


def test_bussi_noise_is_seeded_and_chi_squared():
    a = tthermo.bussi_noise(5, 17, 3 * 99.0, torch.float64, "cpu")
    b = tthermo.bussi_noise(5, 17, 3 * 99.0, torch.float64, "cpu")
    c = tthermo.bussi_noise(5, 18, 3 * 99.0, torch.float64, "cpu")
    assert [float(x) for x in a] == [float(x) for x in b]
    assert float(a[1]) != float(c[1])
    nf = 64.0
    draws = np.array([[float(x) for x in tthermo.bussi_noise(1, s, nf,
                                                             torch.float64,
                                                             "cpu")]
                      for s in range(3000)])
    # r1 ~ N(0, 1); r2 ~ chi-squared(nf - 1): mean nf - 1, variance 2(nf - 1)
    assert abs(draws[:, 0].mean()) < 0.1
    assert abs(draws[:, 0].var() - 1.0) < 0.1
    assert abs(draws[:, 1].mean() - (nf - 1)) < 0.05 * nf
    assert abs(draws[:, 1].var() - 2 * (nf - 1)) < 0.15 * 2 * nf


def test_bussi_drives_to_target_temperature():
    n, d = 512, 3
    nf = d * (n - 1.0)
    target = 0.8
    g = torch.Generator().manual_seed(1)
    v = torch.randn((n, d), generator=g, dtype=torch.float64) * 3.0
    temps = []
    for i in range(400):
        r1, r2 = tthermo.bussi_noise(2, i, nf, torch.float64, "cpu")
        kinetic = tthermo.compute_kinetic(v)
        v = v * tthermo.bussi_scale_from_kinetic(kinetic, target, nf, 0.005,
                                                 0.05, r1, r2)
        temps.append(float(tthermo.compute_temperature(v, nf)))
    temps = np.array(temps[100:])
    assert abs(temps.mean() - target) < 0.02
    expected_var = 2 * target ** 2 / nf
    assert 0.3 * expected_var < temps.var() < 3.0 * expected_var


def test_ramps_match_jax():
    from mdtpu.integrate.ramps import ExponentialRamp as JExp
    from mdtpu.integrate.ramps import LinearRamp as JLin

    for tr, jr in ((LinearRamp(2.0, 1.0, 11), JLin(2.0, 1.0, 11)),
                   (ExponentialRamp(2.0, 0.5, 21), JExp(2.0, 0.5, 21)),
                   (LinearRamp(2.0, 1.0, 1), JLin(2.0, 1.0, 1))):
        for s in (0, 1, 5, 11, 20, 21, 100):
            np.testing.assert_allclose(tr(s), float(jr(s)), rtol=1e-14)
