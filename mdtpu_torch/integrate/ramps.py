"""Temperature ramp schedules (callables usable as NVT's ktemp).

Counterpart of ``mdtpu/integrate/ramps.py``. Both ramps use 1-indexed step
semantics: the step function calls the schedule with ``step + 1``; values
clamp to [1, n_steps] and hold exactly T_final afterwards. Schedules are
evaluated on the host in float64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from mdtpu_torch.core.types import ConstantSchedule


def _progress(step, n_steps):
    return (min(max(step, 1), n_steps) - 1.0) / (n_steps - 1.0)


@dataclass(frozen=True)
class LinearRamp:
    t_initial: float
    t_final: float
    n_steps: int

    def __call__(self, step):
        ti, tf = float(self.t_initial), float(self.t_final)
        if self.n_steps <= 1 or step >= self.n_steps:
            return tf
        return ti + (tf - ti) * _progress(step, self.n_steps)


@dataclass(frozen=True)
class ExponentialRamp:
    t_initial: float
    t_final: float
    n_steps: int

    def __call__(self, step):
        ti, tf = float(self.t_initial), float(self.t_final)
        if self.n_steps <= 1 or step >= self.n_steps:
            return tf
        return ti * math.exp(math.log(tf / ti) * _progress(step, self.n_steps))


def initial_temperature_for_velocities(ktemp):
    """Temperature to draw initial velocities at: max(T_i, T_f) for ramps,
    the value itself otherwise."""
    if hasattr(ktemp, "t_initial") and hasattr(ktemp, "t_final"):
        return max(float(ktemp.t_initial), float(ktemp.t_final))
    if isinstance(ktemp, ConstantSchedule):
        return float(ktemp.value)
    if callable(ktemp):
        return float(ktemp(1))
    return float(ktemp)
