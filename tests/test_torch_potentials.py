"""The port's pair potentials against the JAX package's, elementwise at f64
on an r-grid that crosses the cutoff; exact zeros beyond the cutoff; and
F = -dV/dr against torch.autograd."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdtpu.potentials.lennard_jones import LennardJones
from mdtpu.potentials.pseudo_hs import PseudoHS
from mdtpu.potentials.xplor import LennardJonesXPLOR
from mdtpu_torch.interop import potential_from_fields

CASES = (
    [LennardJones(epsilon=1.3, sigma=1.1, r_cut=2.5, shift=s, force_shift=fs,
                  tail_correction=tc, mixing=m)
     for s in (False, True) for fs in (False, True) for tc in (False, True)
     for m in ("lorentz", "none")]
    + [PseudoHS(lam=lam, sigma_scaled_cutoff=sc, mixing=m)
       for lam in (50, 49, 35) for sc in (True, False)
       for m in ("lorentz", "none")]
    + [LennardJonesXPLOR(epsilon=0.9, sigma=1.05, r_on=2.0, r_cut=2.5,
                         tail_correction=tc, mixing=m)
       for tc in (False, True) for m in ("lorentz", "none")]
)
SIGMAS = [(1.0, 1.0), (1.1, 0.9)]


def _close(actual, desired):
    """rtol 1e-12; the shifted forms go to zero continuously at the cutoff,
    where the last ulp of the shift constant dominates, so values below the
    array's scale are held to 1e-12 of that scale."""
    desired = np.asarray(desired)
    scale = float(np.abs(desired).max())
    np.testing.assert_allclose(actual.numpy(), desired, rtol=1e-12,
                               atol=1e-12 * scale)


def _port(pot):
    fields = {f.name: getattr(pot, f.name) for f in dataclasses.fields(pot)}
    return potential_from_fields(type(pot).__name__, fields)


def _grid(pot):
    # Crosses the cutoff of every case (PseudoHS ~1.02 sigma, LJ 2.5), plus
    # far-away pairs.
    hi = 1.3 if isinstance(pot, PseudoHS) else 2.9
    return np.concatenate([np.linspace(0.85, hi, 97), [10.0, 1e6]])


@pytest.mark.parametrize("pot", CASES, ids=repr)
def test_potential_matches_jax(pot):
    port = _port(pot)
    r = _grid(pot)
    for si, sj in SIGMAS:
        si_np = np.full_like(r, si)
        sj_np = np.full_like(r, sj)
        si_t, sj_t = torch.from_numpy(si_np), torch.from_numpy(sj_np)
        u0, f0 = pot.evaluate(jnp.asarray(r), jnp.asarray(si_np),
                              jnp.asarray(sj_np))
        u1, f1 = port.evaluate(torch.from_numpy(r), si_t, sj_t)
        _close(u1, u0)
        _close(f1, f0)

        r2 = r * r
        u0, g0 = pot.evaluate_r2(jnp.asarray(r2), jnp.asarray(si_np),
                                 jnp.asarray(sj_np))
        u1, g1 = port.evaluate_r2(torch.from_numpy(r2), si_t, sj_t)
        _close(u1, u0)
        _close(g1, g0)
        h0 = pot.force_r2(jnp.asarray(r2), jnp.asarray(si_np),
                          jnp.asarray(sj_np))
        h1 = port.force_r2(torch.from_numpy(r2), si_t, sj_t)
        _close(h1, h0)

    assert port.max_cutoff(1.2) == pot.max_cutoff(1.2)
    for n, vol in ((1000, 1250.0), (4096, 5120.0)):
        np.testing.assert_allclose(port.energy_lrc(n, vol),
                                   float(pot.energy_lrc(n, vol)), rtol=1e-12)
        np.testing.assert_allclose(port.pressure_lrc(n, vol),
                                   float(pot.pressure_lrc(n, vol)), rtol=1e-12)


@pytest.mark.parametrize("pot", CASES, ids=repr)
def test_exact_zero_beyond_cutoff(pot):
    port = _port(pot)
    for sigma in (1.0, 1.2):
        rc = port.max_cutoff(sigma)
        r = torch.tensor([rc, rc * (1 + 1e-12), rc + 0.5, 1e3, 1e6],
                         dtype=torch.float64)
        s = torch.full_like(r, sigma)
        u, f = port.evaluate(r, s, s)
        assert torch.all(u == 0) and torch.all(f == 0)
        u, g = port.evaluate_r2(r * r, s, s)
        assert torch.all(u == 0) and torch.all(g == 0)
        assert torch.all(port.force_r2(r * r, s, s) == 0)


@pytest.mark.parametrize("pot", CASES, ids=repr)
def test_force_is_minus_grad(pot):
    port = _port(pot)
    hi = 1.0 if isinstance(pot, PseudoHS) else 2.45
    r = torch.linspace(0.9, hi, 23, dtype=torch.float64, requires_grad=True)
    s1, s2 = torch.full_like(r, 1.1), torch.full_like(r, 0.95)
    u, f = port.evaluate(r, s1, s2)
    (du,) = torch.autograd.grad(u.sum(), r)
    np.testing.assert_allclose(f.detach().numpy(), -du.numpy(), rtol=1e-8,
                               atol=1e-10)
