"""Bussi-Donadio-Parrinello stochastic velocity rescaling thermostat.

Counterpart of ``mdtpu/integrate/thermostat.py``. The rescale factor is

    scale = sqrt( e^{-dt/tau} + c2*(r2 + r1^2) + 2*r1*sqrt(e^{-dt/tau} * c2) )
    c2    = (1 - e^{-dt/tau}) * T_target / (T_current * nf)

with r1 ~ N(0, 1) and r2 ~ chi-squared with (nf - 1) degrees of freedom.
Both draws come from :func:`bussi_noise`, the one seam where the random
numbers enter: tests replace it to replay the JAX package's draws (its
``step`` may be a device tensor: such a replay reads it with ``int``).
"""

from __future__ import annotations

import math

import torch

from mdtpu_torch.ops import philox_draws


def compute_kinetic(velocities, ring=None):
    """Total kinetic energy 0.5 * sum v^2 (unit masses), a 0-d tensor.
    With a shard ring (:class:`mdtpu_torch.parallel.mesh.ShardRing`) each
    rank's partial sum is summed over the ring, as the JAX package psums it
    over its mesh axis."""
    kinetic = 0.5 * torch.sum(velocities * velocities)
    return kinetic if ring is None else ring.sum(kinetic)


def compute_temperature(velocities, nf, ring=None):
    """Instantaneous kinetic temperature 2K/nf."""
    return 2.0 * compute_kinetic(velocities, ring) / nf


def bussi_noise(seed: int, step, nf: float, dtype, device):
    """Bussi's two draws for one step, as 0-d tensors on ``device``:
    r1 ~ N(0, 1) and r2 ~ chi-squared with nf - 1 degrees of freedom.

    ``step`` is a host int or a 0-d int64 tensor on ``device`` (the slot
    advance's step counter). On the card one kernel draws both
    (:func:`mdtpu_torch.ops.philox_draws.bussi_draw`: r2 as twice a gamma
    variate, from a Philox counter of ``(seed, step)``); on the CPU its
    plain version. Nothing is read back to the host."""
    step = philox_draws.step_tensor(step, device)
    r = philox_draws.bussi_draw(seed, step, nf - 1.0, dtype)
    return r[0], r[1]


def bussi_scale_from_kinetic(kinetic, ktemp, nf, dt, tau, r1, r2):
    """The exact Bussi rescale factor given the kinetic energy and the two
    draws ``r1``, ``r2`` (see :func:`bussi_noise`). ``ktemp``: the target
    temperature, a host float or a 0-d tensor (the slot advance's, read
    from its device table); tensor operations only, no host read."""
    current_temperature = 2.0 * kinetic / nf
    term_1 = math.exp(-float(dt) / float(tau))
    c2 = (1.0 - term_1) * ktemp / (current_temperature * nf)
    term_2 = c2 * (r2 + r1 * r1)
    term_3 = 2.0 * r1 * torch.sqrt(term_1 * c2)
    return torch.sqrt(term_1 + term_2 + term_3)
