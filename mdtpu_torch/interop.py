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
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from mdtpu_torch.potentials.xplor import LennardJonesXPLOR
from mdtpu_torch.utils.device import resolve_device

_POTENTIALS = {cls.__name__: cls
               for cls in (LennardJones, PseudoHS, LennardJonesXPLOR)}
_STATE_FIELDS = {f.name for f in dataclasses.fields(SimulationState)}
_SCALAR_FIELDS = {"seed": int, "step": int, "nf": float, "cutoff": float}
_INT_FIELDS = {"images"}
# Fields the JAX state carries that have no counterpart here: its PRNG key
# (the seed replaces it), engine state (rebuilt from the positions) and the
# slot-layout and Brownian fields.
_JAX_ONLY = {"key", "nbrs", "virial_accum", "nprom", "ids"}


def state_from_numpy(arrays: dict, device=None) -> SimulationState:
    """A state from a dict of numpy arrays / Python values keyed by the
    field names of :class:`SimulationState`. ``seed`` defaults to 0 and
    ``nbrs`` to None; the JAX-only fields (``key``, ``nbrs``, ...) are
    ignored. The float fields keep the dtype of ``positions``."""
    device = resolve_device(device)
    unknown = set(arrays) - _STATE_FIELDS - _JAX_ONLY
    if unknown:
        raise ValueError(f"unknown state fields: {sorted(unknown)}")
    dtype = torch.from_numpy(np.array(arrays["positions"])).dtype
    kw = {"seed": 0}
    for name, value in arrays.items():
        if name in _JAX_ONLY:
            continue
        if name in _SCALAR_FIELDS:
            kw[name] = _SCALAR_FIELDS[name](np.asarray(value).item())
        elif name in _INT_FIELDS:
            kw[name] = torch.as_tensor(np.array(value), dtype=torch.int64,
                                       device=device)
        else:
            kw[name] = torch.as_tensor(np.array(value), dtype=dtype,
                                       device=device)
    missing = _STATE_FIELDS - set(kw) - {"nbrs"}
    if missing:
        raise ValueError(f"missing state fields: {sorted(missing)}")
    return SimulationState(**kw)


def state_to_numpy(state: SimulationState) -> dict:
    """The state's fields as numpy arrays and Python values (no ``nbrs``)."""
    out = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if f.name == "nbrs":
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
