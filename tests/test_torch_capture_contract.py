"""The capture contract of ``mdtpu_torch/potentials/base.py`` on the CPU.

On the card a potential runs inside a CUDA graph, so it may read no value
back to the host, make no tensor from host data and size no output by the
values. Here ``ContractGuard`` (a ``TorchDispatchMode``) refuses those
operators by name, as the card's warm-up refuses them through torch's
synchronisation check and a trial capture (``potential_values`` under
``checking_contract``, which raises ``CaptureContractError`` naming the
potential's type, the contract and the eager route):

  * the shipped potentials keep it: ``examples_torch/03``'s
    ``NonAdditivePHS``, ``chip_smoke.py``'s (its config 4 potential and its
    ``PairCounter``), the tests' copy of config 4's
    (``tests/test_torch_gpu.py``, loaded from the example by path), and the
    built-in ones that the naive engine and the neighbour list evaluate in
    torch, each's ``evaluate_r2`` and ``force_r2`` at f32 and f64, their
    values unchanged by the guard;
  * a potential that reads the host (``.item()``, a Python branch on a
    value), makes a tensor from host data or sizes an output by the values
    (``nonzero``, a boolean mask, ``unique``) is refused, and the error a
    capture raises for it names its type, the contract and the eager
    route;
  * each engine that calls a potential in torch (the pair list's sweep,
    the naive engine, the neighbour list's tiles) calls it through
    ``potential_values``, where the card checks it;
  * the named error is found in the chain of a later one (a failed
    capture raises again on its way out)."""

import os
import runpy

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mdtpu_torch as mt
from mdtpu_torch.integrate.device_advance import contract_error
from mdtpu_torch.ops import cell_pairs, naive, neighbor_list
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.naive import NaivePairEngine
from mdtpu_torch.ops.neighbor_list import NeighborListEngine
from mdtpu_torch.potentials.base import (CaptureContractError,
                                         contract_message, potential_values)
from mdtpu_torch.potentials.overlap import OverlapPotential
from tests.test_torch_driver import one_torch_thread  # noqa: F401
from tests.test_torch_gpu import NonAdditivePHS as OwnNonAdditivePHS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The operators a potential on the card must not call: a read back to the
# host, a tensor made from host data, an output sized by the values.
HOST_OPERATORS = frozenset({
    "aten::_local_scalar_dense", "aten::item", "aten::lift_fresh",
    "aten::lift_fresh_copy", "aten::nonzero", "aten::masked_select",
    "aten::_unique2", "aten::unique_consecutive", "aten::unique_dim"})
_CROSSING = frozenset({"aten::_to_copy", "aten::copy_"})
# Indexing by a boolean mask sizes its output by the values as well.
_INDEXING = frozenset({"aten::index", "aten::index_put", "aten::index_put_",
                       "aten::_index_put_impl_"})


class HostAccess(RuntimeError):
    """What :class:`ContractGuard` raises on an operator of
    :data:`HOST_OPERATORS` or a copy between the host and the card."""


class ContractGuard(TorchDispatchMode):
    """Within: an operator of :data:`HOST_OPERATORS`, indexing by a
    boolean mask, or a copy between a host tensor and a device tensor,
    raises :class:`HostAccess` (a Python number a tensor operation takes is
    not such a copy)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if name in HOST_OPERATORS:
            raise HostAccess(f"{name} reads a value back to the host, "
                             f"makes a tensor from host data or sizes its "
                             f"output by the values")
        if name in _INDEXING and any(
                isinstance(t, torch.Tensor)
                and t.dtype in (torch.bool, torch.uint8)
                for t in (args[1] if len(args) > 1 else ())):
            raise HostAccess(f"{name} by a boolean mask sizes its output by "
                             f"the values")
        if name in _CROSSING:
            devices = {t.device.type for t in args
                       if isinstance(t, torch.Tensor) and t.dim() > 0}
            target = kwargs.get("device")
            if target is not None:
                devices.add(torch.device(target).type)
            if "cpu" in devices and len(devices) > 1:
                raise HostAccess(f"{name} copies between the host and the "
                                 f"device")
        return func(*args, **kwargs)




def _shipped():
    example = runpy.run_path(
        os.path.join(REPO, "examples_torch", "03_polydisperse_2d.py"))
    smoke = runpy.run_path(os.path.join(REPO, "chip_smoke.py"),
                           run_name="chip_smoke_module")
    return {
        "examples_torch/03 NonAdditivePHS": example["NonAdditivePHS"](),
        "chip_smoke.py user_potential": smoke["user_potential"](mt),
        "chip_smoke.py PairCounter": smoke["PairCounter"](1.2),
        "tests NonAdditivePHS": OwnNonAdditivePHS(),
        "LennardJones": mt.LennardJones(r_cut=2.5),
        "LennardJones shifted": mt.LennardJones(r_cut=2.5, force_shift=True),
        "PseudoHS": mt.PseudoHS(),
        "LennardJonesXPLOR": mt.LennardJonesXPLOR(),
        "OverlapPotential": OverlapPotential(),
    }


SHIPPED = _shipped()


def _pairs(dtype, n=257, seed=0):
    rng = np.random.default_rng(seed)
    r2 = rng.uniform(0.5, 7.0, n)
    si, sj = rng.uniform(0.8, 1.2, (2, n))
    return [torch.as_tensor(a, dtype=dtype) for a in (r2, si, sj)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_shipped_potentials_keep_the_capture_contract(name, dtype):
    pot = SHIPPED[name]
    r2, si, sj = _pairs(dtype)
    plain = pot.evaluate_r2(r2, si, sj)
    with ContractGuard():
        guarded = pot.evaluate_r2(r2, si, sj)
        if hasattr(pot, "force_r2"):
            force = pot.force_r2(r2, si, sj)
    for got, want in zip(guarded, plain):
        assert torch.equal(got, want)
    if hasattr(pot, "force_r2"):
        assert torch.equal(force, plain[1])
    for got, want in zip(potential_values(pot, "evaluate_r2", r2, si, sj),
                         plain):
        assert torch.equal(got, want)


class _Reads(mt.Potential):
    """A potential whose ``evaluate`` breaks the contract by ``how``."""

    def __init__(self, how):
        self.how = how

    def evaluate(self, r, sigma_i, sigma_j):
        how = self.how
        if how == "item":
            scale = r.max().item()
        elif how == "branch":
            scale = 2.0 if bool((r < 0.9).any()) else 1.0
        elif how == "host_tensor":
            scale = torch.tensor(1.5, dtype=r.dtype)
        elif how == "nonzero":
            scale = r.new_zeros(r.shape).index_fill(
                0, torch.nonzero(r.reshape(-1) < 1.0).reshape(-1), 1.0) \
                .reshape(r.shape) + 1.0
        elif how == "mask":
            scale = r.clone()
            scale[r < 1.0] = 2.0
        else:
            scale = torch.unique(sigma_i).sum()
        u = torch.where(r < 1.25, (1.25 - r) * scale, 0 * r)
        return u, torch.where(r < 1.25, scale + 0 * r, 0 * r)


HOW = ("item", "branch", "host_tensor", "nonzero", "mask", "unique")


@pytest.mark.parametrize("how", HOW)
def test_a_potential_that_reads_the_host_is_refused(how):
    r2, si, sj = _pairs(torch.float64)
    pot = _Reads(how)
    pot.evaluate_r2(r2, si, sj)         # eagerly it runs
    with ContractGuard(), pytest.raises(HostAccess):
        pot.evaluate_r2(r2, si, sj)
    err = CaptureContractError(contract_message(pot, "evaluate_r2", how))
    msg = str(err)
    assert msg.startswith("_Reads.evaluate_r2 broke the capture contract")
    assert "mdtpu_torch/potentials/base.py" in msg
    assert "graph=False" in msg and "make_slot_advance" in msg
    assert isinstance(err, RuntimeError)


def _fluid(n=300, dim=2, rho=0.9, seed=1):
    L = (n / rho) ** (1.0 / dim)
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(0, L, (n, dim)))
    diam = torch.as_tensor(rng.uniform(0.8, 1.2, n))
    cell = torch.eye(dim, dtype=torch.float64) * L
    return pos, diam, cell, torch.linalg.inv(cell)


@pytest.mark.parametrize("engine", ["pair_list", "naive", "neighbor"])
def test_each_engine_calls_the_potential_through_potential_values(
        engine, monkeypatch):
    """The engines that call a potential in torch call it through
    ``potential_values`` (where the card checks it before a capture and
    names a failure inside one): every call of the potential goes through
    it, the full sweep's ``evaluate_r2`` and the list's lean ``force_r2``,
    with the bits of a direct call."""
    pos, diam, cell, inv = _fluid()
    n = pos.shape[0]
    pot = OwnNonAdditivePHS()
    module, eng = {
        "naive": (naive, NaivePairEngine(pot, 1.8)),
        "neighbor": (neighbor_list,
                     NeighborListEngine.create(pot, 1.8, 0.3, cell, n)),
        "pair_list": (cell_pairs,
                      CellGridEngine.create(pot, 1.8, 0.3, cell, n)),
    }[engine]
    calls = []

    def spy(potential, method, *args):
        calls.append((potential, method))
        return potential_values(potential, method, *args)

    nb = eng.allocate(pos, diam, cell, inv)
    plain = eng.compute(pos, diam, cell, inv, nb)[:3]
    monkeypatch.setattr(module, "potential_values", spy)
    checked = eng.compute(pos, diam, cell, inv, nb)[:3]
    assert calls == [(pot, "evaluate_r2")]
    for got, want in zip(checked, plain):
        assert torch.equal(got, want)
    if engine == "pair_list":
        s = eng.slot_inputs(pos, cell, inv, nb)
        slots_nb = nb
        eng.compute_slots(s[0], s[1], s[3], inv, slots_nb,
                          observables=False)
        assert calls[-1] == (pot, "force_r2")


def test_the_named_error_is_found_in_a_later_ones_chain():
    named = CaptureContractError("the potential's")
    try:
        try:
            raise named
        except CaptureContractError as exc:
            raise RuntimeError("ending the capture failed") from exc
    except RuntimeError as later:
        assert contract_error(later) is named
    try:
        try:
            raise named
        except CaptureContractError:
            raise RuntimeError("no cause, a context")
    except RuntimeError as later:
        assert contract_error(later) is named
    assert contract_error(RuntimeError("other")) is None
