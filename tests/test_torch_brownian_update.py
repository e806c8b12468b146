"""The Brownian slot step's update (``mdtpu_torch.integrate.verlet_update.
brownian_update``) on the CPU, where its wrapper takes its plain version:

  * ``brownian_update_plain`` against the JAX package's Brownian slot
    update, its arithmetic as ``mdtpu/integrate/slot_step.py:557-577``
    composes it (``brownian_noise`` masked to the occupied slots, ``dx = F
    dt/kT + xi sqrt(2 dt)``, ``_add``, ``brownian_virial_sample``), on
    inputs made by numpy from a seed, with the JAX package's noise replayed
    through the port's seam (f32 and f64, compensated and not, 2D and 3D,
    a step that samples the virial and one that does not): positions,
    compensation, ``virial_accum`` and ``nprom`` bit for bit, given the
    same noise and forces (both sides round every product and sum on its
    own; XLA on the CPU does not contract them here);
  * the wrapper: new tensors (the inputs left as they were, a host step
    and a counter), in place on the state's own tensors, and what it
    refuses.

The kernel itself is held to the plain version, fed by the noise kernel,
on the card (``tests/test_torch_gpu.py``)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdtpu.integrate import step as j_step
from mdtpu_torch.integrate import step as tstep
from mdtpu_torch.integrate import verlet_update as vu
from tests.test_torch_driver import one_torch_thread  # noqa: F401

DTYPES = {"f32": (torch.float32, np.float32, jnp.float32),
          "f64": (torch.float64, np.float64, jnp.float64)}
DT, KT, SEED = 1e-3, 1.3, 7


def _inputs(dim, ndtype, seed, n=1001):
    """forces, positions, compensation, occupancy, virial, virial_accum
    and nprom: forces of order 30, positions up to 20, compensations of the
    size a Kahan add leaves, one slot in five vacant (zero rows there)."""
    rng = np.random.default_rng(seed)
    occ = rng.uniform(size=n) < 0.8
    f = rng.normal(size=(dim, n)) * 30.0 * occ
    x = rng.uniform(0.0, 20.0, size=(dim, n)) * occ
    xc = rng.normal(size=(dim, n)) * 1e-7 * occ
    scalars = rng.normal(size=2) * 100.0
    return ([a.astype(ndtype) for a in (f, x, xc)], occ,
            [ndtype(v) for v in scalars], int(rng.integers(0, 50)))


def _replay(monkeypatch, key, jdtype):
    """The port's noise seam returns the JAX package's noise of the same
    step and shape."""
    def noise(seed, step, shape, dtype, device, *rank):
        xi = j_step.brownian_noise(key, int(step), tuple(shape), jdtype,
                                   None)
        return torch.as_tensor(np.array(xi), dtype=dtype, device=device)

    monkeypatch.setattr(tstep, "brownian_noise", noise)


def _jax_update(f, x, xc, occ, virial, accum, nprom, step, key, compensated,
                jdtype):
    dt = jnp.asarray(DT, jdtype)
    ktemp = jnp.asarray(KT, jdtype)
    noise = jnp.where(jnp.asarray(occ)[None, :],
                      j_step.brownian_noise(key, step, x.shape, jdtype,
                                            None), 0.0)
    dx = jnp.asarray(f) * (dt / ktemp) + noise * jnp.sqrt(2.0 * dt)
    x, xc = j_step._add(jnp.asarray(x), jnp.asarray(xc), dx, compensated)
    state = types.SimpleNamespace(step=jnp.asarray(step, jnp.int64),
                                  virial_accum=jnp.asarray(accum),
                                  nprom=jnp.asarray(nprom, jnp.int64))
    accum, nprom = j_step.brownian_virial_sample(state, jnp.asarray(virial))
    return [np.asarray(a) for a in (x, xc, accum, nprom)]


def _state(f, x, xc, occ, accum, nprom, step, tdtype):
    """A slot state as far as the update reads it."""
    return types.SimpleNamespace(
        positions=torch.from_numpy(x).clone(),
        pos_comp=torch.from_numpy(xc).clone(), seed=SEED,
        nbrs=types.SimpleNamespace(occupied=torch.from_numpy(occ)),
        step=step, dtype=tdtype, device=torch.device("cpu"),
        virial_accum=torch.tensor(accum, dtype=tdtype),
        nprom=torch.tensor(nprom, dtype=torch.int64),
        temperature=torch.tensor(0.5, dtype=tdtype))


@pytest.mark.parametrize("sampled", [True, False],
                         ids=["sampled", "unsampled"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("compensated", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_update_equals_the_jax_update(dtype, compensated, dim, sampled,
                                            monkeypatch):
    tdtype, ndtype, jdtype = DTYPES[dtype]
    (f, x, xc), occ, (virial, accum), nprom = _inputs(dim, ndtype, dim)
    step = 40 if sampled else 43
    key = jax.random.PRNGKey(11)
    _replay(monkeypatch, key, jdtype)
    state = _state(f, x, xc, occ, accum, nprom, torch.tensor(step), tdtype)
    drift, sigma, ktemp = vu.brownian_coefficients(DT, KT, tdtype)
    got = vu.brownian_update_plain(torch.from_numpy(f),
                                   torch.tensor(virial, dtype=tdtype),
                                   state, drift, sigma, ktemp, compensated)
    want = _jax_update(f, x, xc, occ, virial, accum, nprom, step, key,
                       compensated, jdtype)
    for name, g, w in zip(("positions", "pos_comp", "virial_accum",
                           "nprom"), got[:4], want):
        assert g.dtype == (torch.int64 if name == "nprom" else tdtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert float(got[4]) == float(np.asarray(KT, ndtype))
    assert int(got[3]) == nprom + sampled
    if not compensated:
        assert got[1] is state.pos_comp
    moved = np.any(got[0].numpy() != x, axis=0)
    np.testing.assert_array_equal(moved[~occ], False)   # vacant slots stay


@pytest.mark.parametrize("compensated", [True, False])
def test_wrapper_on_the_cpu(compensated):
    """New tensors equal the plain version's and leave the state alone
    (a counter and a host step); in place the same bits land in the
    state's tensors and the counter advances; an in-place update of a host
    step is refused."""
    tdtype = torch.float64
    (f, x, xc), occ, (virial, accum), nprom = _inputs(3, np.float64, 5)
    forces, w = torch.from_numpy(f), torch.tensor(virial, dtype=tdtype)
    coeffs = vu.brownian_coefficients(DT, KT, tdtype)
    counter = torch.tensor(30)
    state = _state(f, x, xc, occ, accum, nprom, counter, tdtype)
    keep = [t.clone() for t in (state.positions, state.pos_comp,
                                state.virial_accum, state.nprom)]
    want = vu.brownian_update_plain(forces, w, state, *coeffs, compensated)
    got = vu.brownian_update(forces, w, state, *coeffs, compensated)
    assert int(got[2]) == 31 and int(counter) == 30
    for a, b in zip(got[:2] + got[3:], want):
        assert torch.equal(a, b)
    for a, b in zip((state.positions, state.pos_comp, state.virial_accum,
                     state.nprom), keep):
        assert torch.equal(a, b)
    host = _state(f, x, xc, occ, accum, nprom, 30, tdtype)
    got_host = vu.brownian_update(forces, w, host, *coeffs, compensated)
    assert got_host[2] == 31
    for a, b in zip(got_host[:2] + got_host[3:], want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="device step counter"):
        vu.brownian_update(forces, w, host, *coeffs, compensated,
                           in_place=True)
    mine = (state.positions, state.pos_comp, counter, state.virial_accum,
            state.nprom, state.temperature)
    got = vu.brownian_update(forces, w, state, *coeffs, compensated,
                             in_place=True)
    assert all(a is b for a, b in zip(got, mine))
    assert int(counter) == 31
    for a, b in zip(got[:2] + got[3:], want):
        assert torch.equal(a, b)
