"""``validate_torch.py`` keeps its own copies of ``validate.py``'s oracles
(that script imports JAX): the Mayer-integral quadratures ``lj_b2`` and
``lj_u2``, ``block_sem`` and the SEM-weighted isotherm fit ``fit_b2_b3``.
Each copy gives ``validate.py``'s numbers (rel 1e-14), and the copy of B2
is pinned to the published constants ``tests/test_validate_anchors.py``
pins: B2(T_Boyle) = 0 and B2*(1.0) = -5.3158, both within 2e-3."""

import numpy as np
import pytest

import validate
import validate_torch

TEMPS = [0.75, 0.85, 1.0, 2.0, validate.BOYLE_T]


def test_boyle_temperature_is_the_same():
    assert validate_torch.BOYLE_T == validate.BOYLE_T


def test_b2_copy_pinned_to_published_constants():
    assert abs(validate_torch.lj_b2(validate_torch.BOYLE_T)) < 2e-3
    np.testing.assert_allclose(validate_torch.lj_b2(1.0), -5.3158, atol=2e-3)


@pytest.mark.parametrize("name", ["lj_b2", "lj_u2"])
@pytest.mark.parametrize("temp", TEMPS)
def test_quadratures_match_validate(name, temp):
    np.testing.assert_allclose(getattr(validate_torch, name)(temp),
                               getattr(validate, name)(temp), rtol=1e-14)


@pytest.mark.parametrize("nblocks", [5, 10])
def test_block_sem_matches_validate(nblocks):
    x = np.random.default_rng(nblocks).normal(size=10_007)
    np.testing.assert_allclose(validate_torch.block_sem(x, nblocks),
                               validate.block_sem(x, nblocks), rtol=1e-14)
    assert validate_torch.block_sem(x[:3], nblocks) == float("inf")


def test_fit_b2_b3_matches_validate():
    rhos = np.array([0.02, 0.05, 0.08])
    z = 1.0 - 0.6276 * rhos + 1.7 * rhos ** 2 + np.array([3e-4, -2e-4, 1e-4])
    sems = [1e-4, 3e-4, 2e-4]
    np.testing.assert_allclose(validate_torch.fit_b2_b3(rhos, z, sems),
                               validate.fit_b2_b3(rhos, z, sems), rtol=1e-12)
