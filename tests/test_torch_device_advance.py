"""The single-device slot advance keeps its segment on the device.

One segment of ``make_slot_advance`` runs on the CPU with every way Python
code reads a tensor back to the host (``Tensor.__bool__``, ``__int__``,
``__float__``, ``__index__``, ``.item()``, ``.tolist()``, ``.numpy()``,
``.cpu()``) patched to raise, except the one read in :func:`device_if`'s
eager branch; the segment completes and reaches that read once a step. The
card captures this same code into CUDA graphs, so it reads nothing back
there. Also: every step variant writes its results into the advance's
buffers (MD and Brownian, lean and full: a step's state holds the buffers'
own tensors, so nothing is copied in after it); NVT's target temperature
comes from the advance's device table, step for step what the schedule
gives; the counter is the state's step; the advance leaves its input state
as it was; and the graph option's checks.
"""

import sys

import numpy as np
import pytest
import torch

import mdtpu_torch as mt
from mdtpu_torch.integrate import slot_step
from mdtpu_torch.integrate import thermostat as tthermo
from mdtpu_torch.integrate.ramps import LinearRamp
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.sim.initialization import lattice_fluid_state
from tests.test_torch_driver import one_torch_thread  # noqa: F401

N = 1000
READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist",
         "numpy", "cpu")


def _slots(ensemble, dtype=torch.float64):
    """A slot state of N particles on a lattice (a 3^3 grid for LJ) and its engine."""
    if isinstance(ensemble, mt.Brownian):
        pot, rho, cutoff = mt.PseudoHS(), 0.5, 1.5
    else:
        pot, rho, cutoff = mt.LennardJones(r_cut=2.5), 0.8, 2.5
    state = lattice_fluid_state(N, rho, 1.2, dtype=dtype, cutoff=cutoff,
                                jitter=0.05, device="cpu")
    eng = CellGridEngine.create(pot, cutoff, 0.3, state.unitcell, N)
    slots = slot_step.slot_forces(slot_step.slotify(state, eng), eng)
    params = mt.Parameters(rho, N, 1e-5 if isinstance(
        ensemble, mt.Brownian) else 0.004, pot)
    return slots, eng, params


CASES = {
    "nvt_ramp": (mt.NVT(LinearRamp(1.2, 0.8, 30), 0.4), torch.float64, False),
    "nve_hilo": (mt.NVE(), torch.float32, True),
    "brownian": (mt.Brownian(1.0), torch.float64, False),
    "brownian_hilo": (mt.Brownian(1.0), torch.float32, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_segment_reads_nothing_but_the_rebuild_flag(case, monkeypatch):
    ensemble, dtype, hilo = CASES[case]
    slots, eng, params = _slots(ensemble, dtype)
    advance = slot_step.make_slot_advance(params, ensemble, eng, hilo=hilo)
    k = 25
    rebins = []
    rebin = slot_step._rebin
    monkeypatch.setattr(slot_step, "_rebin",
                        lambda s, e: rebins.append(1) or rebin(s, e))
    steps_before = slot_step.make_slot_step.steps
    reads = []
    with monkeypatch.context() as m:
        allowed = []

        def read_guard(name, original):
            def read(self, *args, **kwargs):
                if (name == "__bool__" and sys._getframe(1).f_code
                        is slot_step.device_if.__code__):
                    allowed.append(1)
                    return original(self, *args, **kwargs)
                reads.append(name)
                raise AssertionError(f"host read Tensor.{name}")
            return read

        for name in READS:
            m.setattr(torch.Tensor, name,
                      read_guard(name, getattr(torch.Tensor, name)))
        out = advance(slots, k)
    assert reads == []
    assert len(allowed) == k                  # device_if: once a step
    assert out.step == slots.step + k and isinstance(out.step, int)
    assert slot_step.make_slot_step.steps - steps_before == k
    assert len(rebins) == len(advance.rebuild_steps())
    assert bool(torch.all(torch.isfinite(out.positions)))


@pytest.mark.parametrize("variant", ["lean", "last"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_steps_write_the_buffers_in_place(case, variant):
    """A step on the advance's buffers returns a state of the buffers' own
    tensors, its binning's included: the step wrote every result in place
    and ``_copy_into`` has nothing to copy. Two steps advance the counter
    by two."""
    ensemble, dtype, hilo = CASES[case]
    slots, eng, params = _slots(ensemble, dtype)
    advance = slot_step.make_slot_advance(params, ensemble, eng, hilo=hilo)
    advance._load(slots)
    advance._fill_table(slots.step, 2)
    b = advance.bufs
    fn = advance.step_fn if variant == "lean" else advance.last_fn
    for _ in range(2):
        out = fn(b, advance._target())
        for name in slot_step._STATE_TENSORS:
            assert getattr(out, name) is getattr(b, name), name
        for name in slot_step._NBRS_TENSORS:
            assert getattr(out.nbrs, name) is getattr(b.nbrs, name), name
    assert int(b.step) == slots.step + 2
    assert bool(torch.all(torch.isfinite(b.positions)))


def test_ramp_target_comes_from_the_device_table(monkeypatch):
    """Each NVT step's ktemp, read from the advance's table by the step
    counter, is the schedule's value at step + 1 in the state's dtype."""
    ramp = LinearRamp(1.5, 0.5, 40)
    ensemble = mt.NVT(ramp, 0.4)
    slots, eng, params = _slots(ensemble, torch.float32)
    seen = []
    scale = tthermo.bussi_scale_from_kinetic

    def recorded(kinetic, ktemp, *args):
        seen.append(ktemp.clone())
        return scale(kinetic, ktemp, *args)

    monkeypatch.setattr(tthermo, "bussi_scale_from_kinetic", recorded)
    advance = slot_step.make_slot_advance(params, ensemble, eng)
    state = slots.replace(step=7)
    for k in (1, 12, 30):
        state = advance(state, k)
    assert state.step == 7 + 43
    assert all(t.dtype == torch.float32 and t.dim() == 0 for t in seen)
    np.testing.assert_array_equal(
        np.array([float(t) for t in seen], np.float32),
        np.array([ramp(s + 1) for s in range(7, 50)], np.float32))


def test_advance_leaves_its_input_alone():
    """Two segments from one start give the same state (the driver reruns a
    segment from its start after an overflow), and the returned state's
    tensors are not the advance's buffers."""
    ensemble = mt.NVT(1.0, 0.4)
    slots, eng, params = _slots(ensemble)
    start = {n: getattr(slots, n).clone() for n in ("positions",
                                                     "velocities")}
    advance = slot_step.make_slot_advance(params, ensemble, eng)
    a = advance(slots, 15)
    b = advance(slots, 15)
    for name, t in start.items():
        assert torch.equal(getattr(slots, name), t)
    for name in ("positions", "velocities", "ids"):
        assert torch.equal(getattr(a, name), getattr(b, name))
        assert getattr(a, name) is not getattr(advance.bufs, name)
    c = advance(a, 0)
    assert c is a


def test_graph_option_checks():
    ensemble = mt.NVE()
    slots, eng, params = _slots(ensemble)
    advance = slot_step.make_slot_advance(params, ensemble, eng, graph=True)
    with pytest.raises(ValueError, match="graph=True"):
        advance(slots, 3)
    eager = slot_step.make_slot_advance(params, ensemble, eng)
    eager(slots, 2)
    assert eager.graph is False


def test_sharded_segment_reads_only_the_ring_vote(monkeypatch):
    """The sharded advance on a ring of one (``ShardedSlotAdvance``) keeps
    its segment on the device too: the one host read is ``device_if``'s of
    the ring's vote, once a lean step (the full last step rebuilds without
    a test); its steps write the buffers in place; a rebuild at the
    segment's start and before its last step."""
    from mdtpu_torch.parallel import HaloSlotEngine, ShardRing
    from mdtpu_torch.parallel.driver import build_grown
    from mdtpu_torch.parallel.halo_slot import make_sharded_slot_advance
    ensemble = mt.NVT(1.2, 0.4)
    state = lattice_fluid_state(N, 0.8, 1.2, dtype=torch.float64, cutoff=2.5,
                                jitter=0.05, device="cpu")
    pot = mt.LennardJones(r_cut=2.5)
    eng = HaloSlotEngine.create(pot, 2.5, state.unitcell, N,
                                ShardRing(device="cpu"))
    sh, eng = build_grown(state, eng)
    advance = make_sharded_slot_advance(mt.Parameters(0.8, N, 0.004, pot),
                                        ensemble, eng)
    assert isinstance(advance, slot_step.ShardedSlotAdvance)
    k = 12
    allowed, reads = [], []
    with monkeypatch.context() as m:
        def read_guard(name, original):
            def read(self, *args, **kwargs):
                if (name == "__bool__" and sys._getframe(1).f_code
                        is slot_step.device_if.__code__):
                    allowed.append(1)
                    return original(self, *args, **kwargs)
                reads.append(name)
                raise AssertionError(f"host read Tensor.{name}")
            return read

        for name in READS:
            m.setattr(torch.Tensor, name,
                      read_guard(name, getattr(torch.Tensor, name)))
        out = advance(sh, k)
    assert reads == [] and len(allowed) == k - 1
    assert out.step == sh.step + k
    steps = advance.rebuild_steps()
    assert steps[0] == sh.step and steps[-1] == sh.step + k - 1
    b = advance.bufs
    for fn in (advance.step_fn, advance.last_fn):
        stepped = fn(b, advance._target())
        for name in slot_step._STATE_TENSORS:
            assert getattr(stepped, name) is getattr(b, name), name
        for name in slot_step._NBRS_TENSORS:
            assert getattr(stepped.nbrs, name) is getattr(b.nbrs, name), name


def test_rebuild_vote_plain_and_its_wrapper():
    """``rebuild_vote``'s plain version: true where the ring's vote is not 0
    or the counter is at the segment's first step; the wrapper writes it
    into its flag on the CPU and refuses a graph's handle there."""
    from mdtpu_torch.ops import philox_draws as draws
    i64 = dict(dtype=torch.int64)
    out = torch.zeros((), dtype=torch.bool)
    for vote, counter, first in ((0, 5, 3), (1, 5, 3), (0, 3, 3), (2, 3, 3),
                                 (0, 4, 5)):
        want = vote != 0 or counter == first
        args = (torch.tensor(vote, dtype=torch.int32),
                torch.tensor(counter, **i64), torch.tensor(first, **i64))
        assert bool(draws.rebuild_vote_plain(*args)) == want
        assert draws.rebuild_vote(*args, out) is out and bool(out) == want
    with pytest.raises(ValueError, match="handle"):
        draws.rebuild_vote(*args, out, handle=1)
