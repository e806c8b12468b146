"""The slot step's draws on the CPU: Philox-4x32-10's known answers, the
plain Bussi draw's moments (r1 ~ N(0, 1); r2 chi-squared with nf - 1
degrees of freedom, as the JAX package's 2 Gamma((nf - 1)/2)) and its
branches against its attempts made one after another, the plain
Brownian noise (on [-sqrt 3, sqrt 3], unit variance), draws that repeat for
one (seed, step) and differ across steps, seeds and ranks, the plain
rebuild flag against numpy, and the launch counters' arithmetic. The
kernels themselves are held to these plain versions on the card
(``tests/test_torch_gpu.py``)."""

import math

import numpy as np
import pytest
import torch

from mdtpu_torch.integrate import step as tstep
from mdtpu_torch.integrate import thermostat as tthermo
from mdtpu_torch.ops import philox_draws as draws
from mdtpu_torch.utils import counters

# Random123's known answers for Philox-4x32-10: (counter, key, words).
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
N_STEPS = 20000


def _philox_numpy(ctr, key):
    """Philox-4x32-10 in Python integers: Random123's rounds."""
    c, (k0, k1) = list(ctr), key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & 0xFFFFFFFF, (k1 + 0xBB67AE85) \
                & 0xFFFFFFFF
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & 0xFFFFFFFF,
             (p0 >> 32) ^ c[3] ^ k1, p0 & 0xFFFFFFFF]
    return tuple(c)


@pytest.mark.parametrize("ctr,key,words", KAT)
def test_philox_known_answers(ctr, key, words):
    got = draws.philox_words(torch.tensor([ctr]), torch.tensor([key]))
    assert tuple(got[0].tolist()) == words
    assert _philox_numpy(ctr, key) == words


def test_philox_words_match_python_integers():
    rng = np.random.default_rng(1)
    ctr = rng.integers(0, 2 ** 32, (200, 4))
    key = rng.integers(0, 2 ** 32, (200, 2))
    got = draws.philox_words(torch.from_numpy(ctr), torch.from_numpy(key))
    assert [tuple(r) for r in got.tolist()] == [
        _philox_numpy(tuple(int(v) for v in c), tuple(int(v) for v in k))
        for c, k in zip(ctr, key)]


@pytest.mark.parametrize("dof", [1.0, 3.0, 196604.0])
def test_bussi_draw_moments(dof):
    """Over 20,000 steps: r1's mean 0 and variance 1, r2's mean nf - 1 and
    variance 2(nf - 1), each within five standard errors."""
    r1, r2 = draws.bussi_draw_plain(3, torch.arange(N_STEPS), dof)
    r1, r2 = r1.numpy(), r2.numpy()
    n = N_STEPS
    assert abs(r1.mean()) < 5 / math.sqrt(n)
    assert abs(r1.var() - 1.0) < 5 * math.sqrt(2 / n)
    assert abs(r2.mean() - dof) < 5 * math.sqrt(2 * dof / n)
    var_se = math.sqrt((8 * dof ** 2 + 48 * dof) / n)
    assert abs(r2.var() - 2 * dof) < 5 * var_se
    assert np.all(r2 > 0)


def test_bussi_draw_without_freedom_is_zero():
    r1, r2 = draws.bussi_draw_plain(3, torch.arange(10), 0.0)
    assert torch.all(r2 == 0) and torch.all(torch.isfinite(r1))


def _bussi_in_order(seed, step, dof, attempts=draws.GAMMA_ATTEMPTS):
    """Bussi's ``(r1, r2)`` of one step in Python floats, the gamma
    attempts tried one after another and the first accepting one taken
    (Marsaglia and Tsang; the counters of ``csrc/philox_draws.cu``), and
    that attempt's index (None where none accepted or none was made)."""
    key = draws.seed_key(seed)

    def words(block):
        return _philox_numpy((block, step & 0xFFFFFFFF, step >> 32, 0), key)

    def u53(a, b):
        return ((a >> 5) * 2 ** 26 + (b >> 6)) * 2.0 ** -53

    def normal(w):
        return math.sqrt(-2.0 * math.log(1.0 - u53(w[0], w[1]))) * math.cos(
            draws.TWO_PI * u53(w[2], w[3]))

    r1 = normal(words(0))
    if not dof > 0.0:
        return r1, 0.0, None
    a = 0.5 * dof
    boost = a < 1.0
    d = (a + 1.0 if boost else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    g, ub, at = d, 1.0, None
    for t in range(attempts):
        x = normal(words(1 + 2 * t))
        w = words(2 + 2 * t)
        cx = 1.0 + c * x
        v = cx * cx * cx
        u = 1.0 - u53(w[0], w[1])
        if v > 0.0 and math.log(u) < (0.5 * x * x + d - d * v
                                      + d * math.log(v)):
            g, ub, at = d * v, 1.0 - u53(w[2], w[3]), t
            break
    if boost:
        g = g * ub ** (1.0 / a)
    return r1, 2.0 * g, at


# Bussi's branches: (dofs, gamma attempts).
BUSSI_BRANCHES = {"no_freedom": ((0.0, -3.0, math.nan), None),
                  "boost": ((1.5, 0.3), None),
                  "gamma": ((3.0, 196604.0), None),
                  "none_accepts": ((1.5, 3.0), 1),
                  "none_can_accept": ((math.inf,), None)}


@pytest.mark.parametrize("branch", list(BUSSI_BRANCHES))
def test_bussi_draw_plain_takes_the_first_accepting_attempt(branch,
                                                            monkeypatch):
    """``bussi_draw_plain`` (all attempts at once, the first accepting one
    taken by ``argmax``) against the attempts made one after another in
    Python floats, over 400 steps, to rel 1e-12 (the libm's last bits):
    r2 = 0 where dof <= 0 (or NaN); the boost u^(1/a) where a < 1; the
    first accepting attempt, at some steps past the first one; a step on
    which no attempt accepts (with the attempts cut to one: r2 = 2 d), and
    a dof on which none can (infinite: r2 infinite)."""
    dofs, attempts = BUSSI_BRANCHES[branch]
    if attempts is not None:
        monkeypatch.setattr(draws, "GAMMA_ATTEMPTS", attempts)
    steps = list(range(400))
    for dof in dofs:
        r1, r2 = draws.bussi_draw_plain(7, torch.tensor(steps), dof)
        want = [_bussi_in_order(7, s, dof, draws.GAMMA_ATTEMPTS)
                for s in steps]
        np.testing.assert_allclose(r1.numpy(), [w[0] for w in want],
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(r2.numpy(), [w[1] for w in want],
                                   rtol=1e-12, atol=0)
        taken = [w[2] for w in want]
        if branch == "no_freedom":
            assert torch.all(r2 == 0)
        elif branch == "none_can_accept":
            assert torch.all(torch.isinf(r2)) and taken == [None] * 400
        elif branch == "none_accepts":
            assert None in taken and 0 in taken
        else:
            assert all(t is not None for t in taken)
            if dof < 10:
                assert max(taken) > 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_uniform_noise_range_and_variance(dtype):
    xi = draws.uniform_noise_plain(11, torch.tensor(4), (3, 100001), dtype)
    assert xi.shape == (3, 100001) and xi.dtype == dtype
    assert float(xi.abs().max()) <= math.sqrt(3.0)
    # Standard errors at 3e5 draws: mean 1.8e-3, variance 1.6e-3.
    assert abs(float(xi.double().mean())) < 1e-2
    assert abs(float(xi.double().var()) - 1.0) < 1e-2


def test_draws_repeat_and_differ_across_steps_seeds_and_ranks():
    def noise(seed, step, rank=None):
        return tstep.brownian_noise(seed, step, (3, 999), torch.float64,
                                    "cpu", rank)

    a = noise(5, 17)
    assert torch.equal(a, noise(5, torch.tensor(17)))
    for other in (noise(5, 18), noise(6, 17), noise(5, 17, 1),
                  noise(5, 17 + 2 ** 32)):
        assert abs(float((a * other).mean())) < 0.1
    assert torch.equal(noise(5, 17, 1), noise(5, 17, 1))
    assert not torch.equal(noise(5, 17, 1), noise(5, 17, 2))
    b = tthermo.bussi_noise(5, 17, 3 * 99.0, torch.float64, "cpu")
    c = tthermo.bussi_noise(5, torch.tensor(17), 3 * 99.0, torch.float64,
                            "cpu")
    assert [float(x) for x in b] == [float(x) for x in c]
    for d in (tthermo.bussi_noise(5, 18, 3 * 99.0, torch.float64, "cpu"),
              tthermo.bussi_noise(6, 17, 3 * 99.0, torch.float64, "cpu")):
        assert float(d[0]) != float(b[0]) and float(d[1]) != float(b[1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_rebuild_flag_plain_matches_numpy(dtype):
    """The drift test in the positions' dtype, threshold (skin/2)^2 rounded
    to it, at drifts just below and just above."""
    rng = np.random.default_rng(2)
    ref = rng.uniform(0, 20, (3, 5000)).astype(np.float64)
    skin = 0.3
    for scale in (0.999, 1.001):
        drift = np.zeros_like(ref)
        drift[1, 77] = 0.5 * skin * scale
        pos, r = (torch.from_numpy(ref + drift).to(dtype),
                  torch.from_numpy(ref).to(dtype))
        npd = {torch.float64: np.float64, torch.float32: np.float32}[dtype]
        d = (pos.numpy() - r.numpy()).astype(npd)
        d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
        want = bool(np.any(d2 > npd(0.5 * skin * 0.5 * skin)))
        out = torch.ones((), dtype=torch.bool)
        assert bool(draws.rebuild_flag(pos, r, skin)) == want == (scale > 1)
        assert draws.rebuild_flag(pos, r, skin, out=out) is out
        assert bool(out) == want


def test_wrappers_on_the_cpu_take_the_plain_versions():
    before = counters.snapshot()
    r = draws.bussi_draw(1, torch.tensor(3), 10.0, torch.float32)
    assert r.shape == (2,) and r.dtype == torch.float32
    assert torch.equal(r, torch.stack(
        draws.bussi_draw_plain(1, torch.tensor(3), 10.0)).float())
    draws.uniform_noise(1, torch.tensor(3), (2, 5), torch.float32)
    draws.rebuild_flag(torch.zeros(2, 5), torch.zeros(2, 5), 0.3)
    assert counters.snapshot() == before
    with pytest.raises(ValueError):
        draws.step_tensor(torch.tensor([1, 2]), "cpu")
    with pytest.raises(TypeError):
        draws.uniform_noise(1, torch.tensor(3), (2, 5), torch.float16)


def test_counters_snapshot_difference_add_restore():
    def wrapper():
        pass

    wrapper.launches = 2
    counters.register(wrapper, "launches")
    try:
        before = counters.snapshot()
        wrapper.launches += 3
        delta = counters.difference(counters.snapshot(), before)
        assert delta == {(wrapper, "launches"): 3}
        counters.restore(before)
        assert wrapper.launches == 2
        counters.add(delta, 4)
        assert wrapper.launches == 14
    finally:
        counters.unregister(wrapper, "launches")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_noise_of_a_host_step_is_the_tensor_steps(dtype):
    """A host int step (the kernel takes it as a number on the card, with
    no fill before it) gives the noise of the same step as a tensor, through
    the wrapper and through ``brownian_noise``, with and without a rank."""
    for rank in (None, 2):
        want = draws.uniform_noise_plain(5, torch.tensor(37), (3, 11), dtype,
                                         rank)
        got = draws.uniform_noise(5, 37, (3, 11), dtype, rank, device="cpu")
        seam = tstep.brownian_noise(5, 37, (3, 11), dtype, "cpu", rank)
        assert torch.equal(got, want) and torch.equal(seam, want)


def test_launch_options_word():
    """The options word of the finish's and the noise's launches: 1 (as
    programmatic dependents) but inside ``plain_launch``, where it is 0;
    the context restores it on exit, also after an error and when nested."""
    assert draws.launch_options() == 1
    with draws.plain_launch():
        assert draws.launch_options() == 0
        with draws.plain_launch():
            assert draws.launch_options() == 0
        assert draws.launch_options() == 0
    assert draws.launch_options() == 1
    with pytest.raises(RuntimeError):
        with draws.plain_launch():
            raise RuntimeError
    assert draws.launch_options() == 1
