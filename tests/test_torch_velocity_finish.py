"""The velocity finish's scalar tail on the CPU: its plain version
(``mdtpu_torch.integrate.velocity_finish``) against the torch composition it
replaces, bit for bit (NVT at a host target, a 0-d target and a device
table; NVE; f32 and f64), and through ``md_velocity_finish``; against the
JAX package's ``bussi_scale_from_kinetic`` with its draws replayed (rel
1e-12, f64) and ``compute_temperature``; the kernel's ticket-order kinetic
sum (``kinetic_plain``) against a thread-by-thread emulation of the kernel,
against ``torch.sum`` and against an exact sum; and a slot advance whose
rebuild test runs at the step's start rebuilding at exactly the steps a
test before every step picks. The kernel itself is held to these on the
card (``tests/test_torch_gpu.py``)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdtpu_torch as mt
from mdtpu.integrate import thermostat as jthermo
from mdtpu_torch.integrate import slot_step
from mdtpu_torch.integrate import step as tstep
from mdtpu_torch.integrate import thermostat as tthermo
from mdtpu_torch.integrate import velocity_finish as vf
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.sim.initialization import lattice_fluid_state
from tests.test_torch_driver import one_torch_thread  # noqa: F401
from tests.test_torch_thermostat import jax_bussi_draws

DTYPES = {"f64": torch.float64, "f32": torch.float32}
NF = 3 * 999.0
DT, TAU, SEED = 0.002, 0.4, 17


def _velocities(dtype, n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(3, n)) * 1.2).to(dtype)


def _old(v, ktemp, step, nvt=True):
    """The composition md_velocity_finish ran before the tail was one
    kernel."""
    if not nvt:
        return None, tthermo.compute_temperature(v, NF)
    r1, r2 = tthermo.bussi_noise(SEED, step, NF, v.dtype, v.device)
    kinetic = tthermo.compute_kinetic(v)
    scale = tthermo.bussi_scale_from_kinetic(kinetic, ktemp, NF, DT, TAU, r1,
                                             r2)
    return scale, scale * scale * 2.0 * kinetic / NF


def _bits(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("target", ["host", "tensor", "table", "nve"])
def test_plain_equals_the_old_composition(dtype, target):
    dtype = DTYPES[dtype]
    v = _velocities(dtype)
    kinetic = tthermo.compute_kinetic(v)
    table = torch.tensor([1.3, 1.1, 0.9, 0.7], dtype=torch.float64).to(dtype)
    base = torch.tensor(40)
    for s in (41, 43):
        step = torch.tensor(s)
        ktemp = {"host": 1.1, "tensor": table[s - 40], "nve": None,
                 "table": vf.TargetTable(table, base)}[target]
        scale, temp = vf.velocity_finish_plain(None, kinetic, SEED, step, NF,
                                               DT, TAU, ktemp)
        want_scale, want_temp = _old(v, table[s - 40] if target == "table"
                                     else ktemp, step, target != "nve")
        assert _bits(temp, want_temp)
        if target == "nve":
            assert float(scale) == 1.0
        else:
            assert _bits(scale, want_scale)
        # The wrapper on CPU tensors is the plain version.
        got = vf.velocity_finish(None, kinetic, SEED, step, NF, DT, TAU,
                                 ktemp)
        assert _bits(got[0], scale) and _bits(got[1], temp)


@pytest.mark.parametrize("compensated", [True, False])
def test_md_velocity_finish_on_the_cpu_is_unchanged(compensated):
    """The step's tail on CPU tensors: velocities rescaled by the old
    composition's factor, its temperature, the compensation zeroed."""
    v = _velocities(torch.float64, n=500)
    vc = torch.full_like(v, 1e-17)
    state = lattice_fluid_state(8, 0.8, 1.0, dtype=torch.float64,
                                device="cpu").replace(step=11, seed=SEED,
                                                      nf=NF)
    ens = mt.NVT(mt.LinearRamp(1.4, 0.9, 30), TAU)
    v2, vc2, temp = tstep.md_velocity_finish(ens, v, vc, state, DT,
                                             compensated)
    scale, want_temp = _old(v, ens.ktemp(12), 11)
    assert torch.equal(v2, v * scale) and _bits(temp, want_temp)
    assert torch.equal(vc2, torch.zeros_like(vc) if compensated else vc)
    v3, vc3, temp = tstep.md_velocity_finish(mt.NVE(), v, vc, state, DT,
                                             compensated)
    assert v3 is v and vc3 is vc
    assert _bits(temp, tthermo.compute_temperature(v, NF))


@pytest.mark.parametrize("step", [0, 7, 123])
def test_plain_matches_jax_with_its_draws(step, monkeypatch):
    """The tail from the velocities (the kernel's kinetic sum) against the
    JAX package's bussi_scale_from_kinetic and compute_temperature, its
    draws replayed at the seam: rel 1e-12 in float64 (the two sum the
    kinetic energy in different orders)."""
    key = jax.random.PRNGKey(11)

    def replay(seed, s, nf, dtype, device):
        r1, r2 = jax_bussi_draws(key, int(s), nf)
        return (torch.tensor(r1, dtype=dtype, device=device),
                torch.tensor(r2, dtype=dtype, device=device))

    monkeypatch.setattr(tthermo, "bussi_noise", replay)
    v = _velocities(torch.float64, n=1000, seed=step)
    vj = jnp.asarray(v.numpy().T)
    kinetic_j = jthermo.compute_kinetic(vj)
    scale_j = jthermo.bussi_scale_from_kinetic(
        jax.random.fold_in(key, step), kinetic_j, 0.9, jnp.asarray(NF), DT,
        TAU, jnp.float64)
    scale, temp = vf.velocity_finish_plain(v, None, SEED, torch.tensor(step),
                                           NF, DT, TAU, 0.9)
    np.testing.assert_allclose(float(scale), float(scale_j), rtol=1e-12)
    np.testing.assert_allclose(
        float(temp), float(scale_j) ** 2 * 2.0 * float(kinetic_j) / NF,
        rtol=1e-12)
    one, temp = vf.velocity_finish_plain(v, None, SEED, step, NF, DT, TAU,
                                         None)
    assert float(one) == 1.0
    np.testing.assert_allclose(
        float(temp), float(jthermo.compute_temperature(vj, NF)), rtol=1e-12)


def _kernel_order_sum(x):
    """The summing kernel's order written thread by thread in Python
    floats: thread t of block b adds its values b T + t + k G T in order,
    each warp's lane 0 takes the shuffle-down tree, warp 0 the same tree
    of the warps' sums (zeros past them), and the last block the blocks'
    partials the same way."""
    threads = vf.FINISH_THREADS
    blocks = vf.finish_blocks(len(x))

    def tree(vals):
        while len(vals) > 1:
            h = len(vals) // 2
            vals = [vals[i] + vals[i + h] for i in range(h)]
        return vals[0]

    def block(acc):
        warps = [tree(acc[w * 32:(w + 1) * 32]) for w in range(threads // 32)]
        return tree(warps + [0.0] * (32 - len(warps)))

    partials = []
    for b in range(blocks):
        acc = []
        for t in range(threads):
            a = 0.0
            for i in range(b * threads + t, len(x), blocks * threads):
                a = a + x[i] * x[i]
            acc.append(a)
        partials.append(block(acc))
    return 0.5 * block(partials + [0.0] * (threads - blocks))


@pytest.mark.parametrize("n", [1, 37, 4096, 9000])
def test_kinetic_plain_is_the_kernel_order(n, monkeypatch):
    """At the kernel's own grid and at one capped to 3 blocks (so the
    threads stride several times), bit for bit the thread-by-thread
    order."""
    x = _velocities(torch.float64, n=n, seed=n)[0]
    values = x.tolist()
    assert float(vf.kinetic_plain(x)) == _kernel_order_sum(values)
    monkeypatch.setattr(vf, "FINISH_MAX_BLOCKS", 3)
    assert vf.finish_blocks(n) == min(-(-n // vf.FINISH_PER_BLOCK), 3)
    assert float(vf.kinetic_plain(x)) == _kernel_order_sum(values)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kinetic_plain_against_torch_sum(dtype):
    """At the bench's slot shape (3, 124,875), where each thread strides
    twice: against torch.sum, rel 1e-13 in float64 and 1e-6 in float32
    (torch sums float32 in float32; the kernel adds the exact squares in
    float64), and against the exact sum, within 1e-13 in float64 and
    half an ulp in float32."""
    dtype = DTYPES[dtype]
    v = _velocities(dtype, n=124875, seed=3)
    got = vf.kinetic_plain(v)
    assert got.dtype == dtype and got.dim() == 0
    want = tthermo.compute_kinetic(v)
    rel = 1e-13 if dtype == torch.float64 else 1e-6
    np.testing.assert_allclose(float(got), float(want), rtol=rel)
    exact = 0.5 * math.fsum(float(a) * float(a) for a in
                            v.double().reshape(-1).tolist())
    tol = 1e-13 if dtype == torch.float64 else 2.0 ** -24
    assert abs(float(got) - exact) <= tol * exact


def _slots(skin):
    n = 1000
    pot = mt.LennardJones(r_cut=2.5)
    state = lattice_fluid_state(n, 0.8, 1.2, dtype=torch.float64, cutoff=2.5,
                                jitter=0.05, device="cpu")
    eng = CellGridEngine.create(pot, 2.5, skin, state.unitcell, n)
    slots = slot_step.slot_forces(slot_step.slotify(state, eng), eng)
    return slots, eng, mt.Parameters(0.8, n, 0.004, pot)


def test_advance_rebuilds_where_a_test_before_every_step_does(monkeypatch):
    """The advance tests the drift at each step's start (the test a
    captured step holds before its IF node): over segments of 1, 12 and 17
    steps it rebuilds at exactly the steps where a test of the state
    before every step finds a drift past skin/2, and the two runs end with
    the same bits."""
    slots, eng, params = _slots(skin=0.1)
    ensemble = mt.NVT(1.2, 0.4)
    advance = slot_step.make_slot_advance(params, ensemble, eng, lean=False)
    order = []
    rebin = slot_step._rebin
    test = slot_step.philox_draws.rebuild_flag
    monkeypatch.setattr(slot_step, "_rebin",
                        lambda s, e: order.append("rebin") or rebin(s, e))
    monkeypatch.setattr(slot_step.philox_draws, "rebuild_flag",
                        lambda *a, **k: order.append("test") or test(*a, **k))
    state = slots
    for k in (1, 12, 17):
        state = advance(state, k)
    monkeypatch.undo()
    assert order[0] == "test" and order.count("test") == 30
    assert order.count("rebin") == len(advance.rebuild_steps())

    step = slot_step.make_slot_step(params, ensemble, eng)
    s, want = slots, []
    for i in range(30):
        if bool(slot_step.slot_needs_rebin(s, eng)):
            want.append(slots.step + i)
            s = slot_step._rebin(s, eng)
        s = step(s)
    assert advance.rebuild_steps() == want and len(want) >= 2
    for name in ("positions", "velocities", "forces", "ids"):
        assert torch.equal(getattr(state, name), getattr(s, name))
