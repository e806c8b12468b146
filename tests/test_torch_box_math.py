"""The port's compensated arithmetic and box math against the JAX package's,
at f64 on random inputs that cross the box: agreement to 1e-15 absolute."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdtpu.core import box as jbox
from mdtpu.utils import math as jmath
from mdtpu_torch.core import box as tbox
from mdtpu_torch.utils import math as tmath

ATOL = 1e-15


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cell(rng, tilted):
    cell = np.diag(rng.uniform(3.0, 6.0, 3))
    if tilted:
        cell[0, 1], cell[0, 2], cell[1, 2] = rng.uniform(-1.0, 1.0, 3)
    return cell


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_sum_and_kahan_add(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1e3, 1e3, 500) * 10.0 ** rng.integers(-8, 8, 500)
    b = rng.uniform(-1e3, 1e3, 500) * 10.0 ** rng.integers(-8, 8, 500)
    c = rng.uniform(-1e-12, 1e-12, 500)
    s0, e0 = jmath.two_sum(jnp.asarray(a), jnp.asarray(b))
    s1, e1 = tmath.two_sum(_t(a), _t(b))
    np.testing.assert_array_equal(s1.numpy(), np.asarray(s0))
    np.testing.assert_array_equal(e1.numpy(), np.asarray(e0))
    x0, c0 = jmath.kahan_add(jnp.asarray(a), jnp.asarray(c), jnp.asarray(b))
    x1, c1 = tmath.kahan_add(_t(a), _t(c), _t(b))
    np.testing.assert_array_equal(x1.numpy(), np.asarray(x0))
    np.testing.assert_array_equal(c1.numpy(), np.asarray(c0))
    x = _t(rng.uniform(0.5, 1.5, 64))
    for n in (0, 1, 2, 7, 24, 49):
        np.testing.assert_allclose(tmath.ipow(x, n).numpy(),
                                   np.asarray(jmath.ipow(jnp.asarray(x.numpy()), n)),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("tilted", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_wrap_and_minimum_image(seed, tilted):
    rng = np.random.default_rng(seed)
    cell = _cell(rng, tilted)
    cell_inv = np.linalg.inv(cell)
    x = rng.uniform(-2.5, 2.5, (400, 3)) @ cell.T   # crosses the box
    comp = rng.uniform(-1e-16, 1e-16, (400, 3))
    images = rng.integers(-3, 3, (400, 3))

    p0, c0, i0 = jbox.wrap_positions_compensated(
        jnp.asarray(x), jnp.asarray(comp), jnp.asarray(images, jnp.int32),
        jnp.asarray(cell), jnp.asarray(cell_inv))
    p1, c1, i1 = tbox.wrap_positions_compensated(
        _t(x), _t(comp), _t(images), _t(cell), _t(cell_inv))
    np.testing.assert_allclose(p1.numpy(), np.asarray(p0), rtol=0, atol=ATOL)
    np.testing.assert_allclose(c1.numpy(), np.asarray(c0), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i0))

    w0, j0 = jbox.wrap_positions(jnp.asarray(x), jnp.asarray(images, jnp.int32),
                                 jnp.asarray(cell), jnp.asarray(cell_inv))
    w1, j1 = tbox.wrap_positions(_t(x), _t(images), _t(cell), _t(cell_inv))
    np.testing.assert_allclose(w1.numpy(), np.asarray(w0), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(j1.numpy(), np.asarray(j0))

    dr = rng.uniform(-1.0, 1.0, (400, 3)) @ cell.T
    m0 = jbox.minimum_image(jnp.asarray(dr), jnp.asarray(cell),
                            jnp.asarray(cell_inv))
    m1 = tbox.minimum_image(_t(dr), _t(cell), _t(cell_inv))
    np.testing.assert_allclose(m1.numpy(), np.asarray(m0), rtol=0, atol=ATOL)

    u0 = jbox.unwrapped_positions(jnp.asarray(x), jnp.asarray(images, jnp.int32),
                                  jnp.asarray(cell))
    u1 = tbox.unwrapped_positions(_t(x), _t(images), _t(cell))
    np.testing.assert_allclose(u1.numpy(), np.asarray(u0), rtol=0, atol=ATOL)

    assert tbox.is_orthorhombic(cell) == jbox.is_orthorhombic(cell)
    np.testing.assert_allclose(tbox.box_volume(_t(cell)),
                               float(jbox.box_volume(jnp.asarray(cell))),
                               rtol=1e-15)
    for spec in (4.0, [2.0, 3.0, 4.0], cell):
        np.testing.assert_array_equal(
            tbox.to_unitcell(spec, 3, torch.float64).numpy(),
            np.asarray(jbox.to_unitcell(spec, 3, jnp.float64)))
