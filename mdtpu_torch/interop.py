"""Carry state and parameters across from plain numpy and Python values.

The counterpart of loading weights: the JAX package's ``SimulationState``,
``Parameters`` and potential dataclasses, taken apart into numpy arrays and
Python values by the caller, become this package's objects (and back). The
module imports no JAX; the tests use it to put both packages on the same
inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mdtpu_torch.core.types import Parameters, SimulationState
from mdtpu_torch.ops.neighbor_list import NeighborState
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from mdtpu_torch.potentials.xplor import LennardJonesXPLOR
from mdtpu_torch.utils.device import resolve_device

_POTENTIALS = {cls.__name__: cls
               for cls in (LennardJones, PseudoHS, LennardJonesXPLOR)}
_STATE_FIELDS = {f.name for f in dataclasses.fields(SimulationState)}
_SCALAR_FIELDS = {"seed": int, "step": int, "nf": float, "cutoff": float}
_INT_FIELDS = {"images", "nprom"}
# Fields that are not carried across: the JAX state's PRNG key (the seed
# replaces it), engine state (rebuilt from the positions) and the slot
# layout's particle ids (a state crosses in particle order).
_JAX_ONLY = {"key", "nbrs", "ids"}
# Fields that may be absent (or None): they then start at zero.
_OPTIONAL = {"virial_accum", "nprom"}


def state_from_numpy(arrays: dict, device=None) -> SimulationState:
    """A state from a dict of numpy arrays / Python values keyed by the
    field names of :class:`SimulationState`. ``seed`` defaults to 0 and
    ``nbrs`` to None, the Brownian accumulators ``virial_accum`` and
    ``nprom`` to zero; the JAX-only fields (``key``, ``nbrs``, ``ids``) are
    ignored. The float fields keep the dtype of ``positions``."""
    device = resolve_device(device)
    unknown = set(arrays) - _STATE_FIELDS - _JAX_ONLY
    if unknown:
        raise ValueError(f"unknown state fields: {sorted(unknown)}")
    dtype = torch.from_numpy(np.array(arrays["positions"])).dtype
    kw = {"seed": 0}
    for name, value in arrays.items():
        if name in _JAX_ONLY or (name in _OPTIONAL and value is None):
            continue
        if name in _SCALAR_FIELDS:
            kw[name] = _SCALAR_FIELDS[name](np.asarray(value).item())
        elif name in _INT_FIELDS:
            kw[name] = torch.as_tensor(np.array(value), dtype=torch.int64,
                                       device=device)
        else:
            kw[name] = torch.as_tensor(np.array(value), dtype=dtype,
                                       device=device)
    missing = _STATE_FIELDS - set(kw) - _JAX_ONLY - _OPTIONAL
    if missing:
        raise ValueError(f"missing state fields: {sorted(missing)}")
    kw.setdefault("virial_accum", torch.zeros((), dtype=dtype, device=device))
    kw.setdefault("nprom", torch.zeros((), dtype=torch.int64, device=device))
    return SimulationState(**kw)


def state_to_numpy(state: SimulationState) -> dict:
    """The state's fields as numpy arrays and Python values (no ``nbrs``
    or ``ids``: a particle-order state)."""
    out = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if f.name in ("nbrs", "ids"):
            continue
        out[f.name] = (value.detach().cpu().numpy()
                       if isinstance(value, torch.Tensor) else value)
    return out


def potential_from_fields(kind: str, fields: dict):
    """A port potential from the field values of the JAX dataclass of the
    same name (``"LennardJones"``, ``"PseudoHS"``, ``"LennardJonesXPLOR"``).
    Array-valued fields become Python floats."""
    if kind not in _POTENTIALS:
        raise NotImplementedError(f"no port of potential {kind!r}")
    cls = _POTENTIALS[kind]
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields:
            continue
        value = fields[f.name]
        if isinstance(value, (bool, str, int)):
            kw[f.name] = value
        else:
            kw[f.name] = float(np.asarray(value))
    return cls(**kw)


def params_from_fields(density, n_particles, dt, potential) -> Parameters:
    """Parameters from plain values (``potential`` already a port
    potential, e.g. from :func:`potential_from_fields`)."""
    return Parameters(density=float(np.asarray(density)),
                      n_particles=int(n_particles),
                      dt=float(np.asarray(dt)), potential=potential)


def neighbor_state_from_numpy(idx, ref_positions, overflow,
                              device=None) -> NeighborState:
    """The port's :class:`NeighborState` from the fields of the JAX
    package's (``idx`` (N, K) with sentinel N, ``ref_positions``,
    ``overflow``) as numpy arrays: ``idx`` becomes int32, the positions
    keep their dtype, and each row's ``count`` is its entries below the
    sentinel (the JAX rows hold their neighbours first)."""
    device = resolve_device(device)
    ref = torch.as_tensor(np.array(ref_positions), device=device)
    idx = torch.as_tensor(np.array(idx), dtype=torch.int32, device=device)
    count = (idx < ref.shape[0]).sum(dim=1).to(torch.int32)
    return NeighborState(
        idx=idx, ref_positions=ref,
        overflow=torch.as_tensor(bool(np.asarray(overflow)), device=device),
        count=count)
