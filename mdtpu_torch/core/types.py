"""Parameters, simulation state, ensembles and the constant schedule.

Counterpart of ``mdtpu/core/types.py``. The state is a plain dataclass of
tensors on one device, structure-of-arrays ``(N, d)``; updates build a new
state with :func:`dataclasses.replace`. Where the JAX state carries a PRNG
key, this state carries an integer ``seed``: each step's random draws come
from a Philox counter of ``(seed, step)`` (see
:mod:`mdtpu_torch.ops.philox_draws`), so runs stay deterministic and
resumable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class Parameters:
    """Simulation parameters: (density, n_particles, dt, potential)."""

    density: float
    n_particles: int
    dt: float = 0.001
    potential: Any = None


@dataclass(frozen=True)
class SimulationState:
    """Full simulation state on one device.

    Besides the reference's fields it carries the last step's forces and
    thermo outputs, the step counter, the random seed and the Kahan
    compensation buffers, so NVE runs continue exactly, and the Brownian
    pressure accumulators. The shapes below are those of particle order; in
    the slot layout (``ids`` set) the per-particle fields are component-major
    ``(d, n_slots)`` (diameters ``(n_slots,)``), and ``n_particles`` and
    ``dimension`` hold for particle order only."""

    positions: torch.Tensor       # (N, d)
    velocities: torch.Tensor      # (N, d)
    forces: torch.Tensor          # (N, d)
    images: torch.Tensor          # (N, d) int64 box-crossing counts
    diameters: torch.Tensor       # (N,)
    unitcell: torch.Tensor        # (d, d), columns are box vectors
    unitcell_inv: torch.Tensor    # (d, d)
    seed: int                     # base seed; combined with the step
    step: Any                     # current step index: a host int (a 0-d
    #                               int64 device tensor inside the slot
    #                               advance's buffers)
    nf: float                     # degrees of freedom d*(N-1)
    energy: torch.Tensor          # () last potential energy (total)
    virial: torch.Tensor          # () last virial sum_{i<j} f_ij * r_ij
    temperature: torch.Tensor     # () last kinetic temperature
    pos_comp: torch.Tensor        # (N, d) Kahan compensation (zeros if unused)
    vel_comp: torch.Tensor        # (N, d)
    virial_accum: torch.Tensor    # () Brownian virial summed every 10 steps
    nprom: torch.Tensor           # () int64 count of those samples
    nbrs: Any = None              # engine state (e.g. the cell binning)
    cutoff: float = 1.5           # engine cutoff
    # Original particle index of each slot, only in the slot layout of
    # mdtpu_torch.integrate.slot_step (int64 (n_slots,), -1 on vacant slots);
    # None in particle order.
    ids: Any = None

    @property
    def n_particles(self) -> int:
        return self.positions.shape[0]

    @property
    def dimension(self) -> int:
        return self.positions.shape[1]

    @property
    def dtype(self):
        return self.positions.dtype

    @property
    def device(self):
        return self.positions.device

    def replace(self, **changes) -> "SimulationState":
        return dataclasses.replace(self, **changes)


def state_to(state: SimulationState, device) -> SimulationState:
    """The same state with every tensor on ``device`` (engine state is
    dropped when it moves: it is rebuilt from the positions)."""
    device = torch.device(device)
    if state.positions.device == device:
        return state
    changes = {f.name: getattr(state, f.name).to(device)
               for f in dataclasses.fields(state)
               if isinstance(getattr(state, f.name), torch.Tensor)}
    return state.replace(nbrs=None, **changes)


# ---------------------------------------------------------------------------
# Temperature schedules: NVT's ktemp is a callable of the (1-indexed) step.
# Ramps live in mdtpu_torch.integrate.ramps.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConstantSchedule:
    value: float

    def __call__(self, step):
        return float(self.value)


def as_schedule(ktemp) -> Any:
    """Coerce a float or callable into a schedule."""
    if callable(ktemp):
        return ktemp
    return ConstantSchedule(value=float(ktemp))


# ---------------------------------------------------------------------------
# Ensembles
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NVT:
    """Canonical ensemble via the Bussi-Donadio-Parrinello thermostat.

    ``ktemp`` may be a constant or a callable schedule ``step -> T``, called
    with the 1-indexed step."""

    ktemp: Any
    tau: float

    def __post_init__(self):
        object.__setattr__(self, "ktemp", as_schedule(self.ktemp))


@dataclass(frozen=True)
class NVE:
    """Microcanonical ensemble: plain velocity Verlet, no thermostat."""


@dataclass(frozen=True)
class Brownian:
    """Overdamped Brownian dynamics at temperature ``ktemp`` (Euler-Maruyama;
    see :func:`mdtpu_torch.integrate.step.make_brownian_step`)."""

    ktemp: float
