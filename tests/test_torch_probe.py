"""The micro-probe of the half-stencil inner loop (``probe_sweep``; its plain
version runs on the CPU) against the JAX package's Pallas probe
``probe_kernel.kernel``, run through ``pl.pallas_call(..., interpret=True)``
with the BlockSpecs of ``probe_kernel.run``.

Inputs: the probe's own (uniform on [0, 40)) and a dense one (uniform on
[0, 5)), where reduce_only samples pairs inside the cutoff. NaN positions
must be equal (full and full_static are NaN by construction: at offset 0
every own slot meets itself); finite values agree to rtol 1e-5 with an
absolute floor of 1e-5 of the largest value (the two sum in different
orders)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import probe_kernel as pk
from mdtpu_torch.ops.experimental import probe
from tests.test_torch_driver import one_torch_thread  # noqa: F401

SPECS = ["full", "full_static", "nodiv", "reduce_only", "nodiv:5",
         "reduce_only:15"]


def _pallas_probe(w, variant, chunk):
    f = pl.pallas_call(
        partial(pk.kernel, variant=variant, chunk=chunk),
        grid=(pk.NX,),
        in_specs=[pl.BlockSpec((4, 1, pk.ROWS, pk.C3),
                               lambda i: (0, i, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=(pl.BlockSpec((1, pk.ROWS, pk.CAP), lambda i: (i, 0, 0),
                                memory_space=pltpu.VMEM),
                   pl.BlockSpec((1, 1, 1), lambda i: (i, 0, 0),
                                memory_space=pltpu.SMEM)),
        out_shape=(jax.ShapeDtypeStruct((pk.NX, pk.ROWS, pk.CAP), jnp.float32),
                   jax.ShapeDtypeStruct((pk.NX, 1, 1), jnp.float32)),
        interpret=True)
    return tuple(np.asarray(a) for a in f(jnp.asarray(w)))


def _assert_same(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    if fin.any():
        floor = 1e-5 * max(np.abs(want[fin]).max(), 1e-30)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=floor)


@pytest.mark.parametrize("spec", SPECS)
def test_probe_matches_pallas_probe(spec):
    variant, chunk = probe.parse_variant(spec)
    rng = np.random.default_rng(7)
    for scale in (40.0, 5.0):
        w = (rng.uniform(size=(4, pk.NX, pk.ROWS, pk.C3)) * scale).astype(
            np.float32)
        fx0, e0 = _pallas_probe(w, variant, chunk)
        fx1, e1 = (a.numpy() for a in probe.probe_sweep(torch.from_numpy(w),
                                                        variant, chunk))
        _assert_same(fx1, fx0)
        _assert_same(e1, e0)
        if variant in ("full", "full_static"):
            assert np.isnan(e1).all()      # the self pairs, by construction
        else:
            assert np.isfinite(e1).all() and np.isfinite(fx1).all()
        if variant == "reduce_only":
            assert not fx1.any()
            if scale == 5.0:
                assert np.abs(e1).max() > 0


def test_probe_geometry_and_cpu_path():
    assert (probe.NX, probe.ROWS, probe.CAP, probe.C3, probe.CHUNK,
            probe.N_OFF) == (pk.NX, pk.ROWS, pk.CAP, pk.C3, pk.CHUNK,
                             pk.N_OFF)
    assert probe.parse_variant("full_static:15") == ("full_static", 15)
    assert probe.parse_variant("nodiv") == ("nodiv", pk.CHUNK)
    w = probe.random_input(0, device="cpu")
    assert w.shape == (4, pk.NX, pk.ROWS, pk.C3) and float(w.max()) < 40.0
    before = probe.probe_sweep.launches
    got = probe.probe_sweep(w, "nodiv", 45)
    want = probe.probe_sweep_plain(w, "nodiv", 45)
    assert all(torch.equal(g, h) for g, h in zip(got, want))
    assert probe.probe_sweep.launches == before
    with pytest.raises(ValueError):
        probe.probe_sweep(w, "fast", 45)
    with pytest.raises(ValueError):
        probe.probe_sweep(w[:, :3], "full", 45)
