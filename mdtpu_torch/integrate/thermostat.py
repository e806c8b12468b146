"""Bussi-Donadio-Parrinello stochastic velocity rescaling thermostat.

Counterpart of ``mdtpu/integrate/thermostat.py``. The rescale factor is

    scale = sqrt( e^{-dt/tau} + c2*(r2 + r1^2) + 2*r1*sqrt(e^{-dt/tau} * c2) )
    c2    = (1 - e^{-dt/tau}) * T_target / (T_current * nf)

with r1 ~ N(0, 1) and r2 ~ chi-squared with (nf - 1) degrees of freedom.
Both draws come from :func:`bussi_noise`, the one seam where the random
numbers enter: tests replace it to replay the JAX package's draws.
"""

from __future__ import annotations

import math

import torch


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


# Mixes a shard's rank into a step's seed (the 64-bit golden ratio).
_RANK_MIX = 0x9E3779B97F4A7C15


def step_generator(seed: int, step: int, device, rank=None) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)``: each step's
    draws depend on nothing else, so runs replay and resume exactly. With
    ``rank`` (a shard's place in its ring) the seed is mixed with it, so
    each rank draws its own numbers, as the JAX package folds the axis
    index into a step's key."""
    g = torch.Generator(device=device)
    value = ((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)
    if rank is not None:
        value ^= (_RANK_MIX * (int(rank) + 1)) & 0xFFFFFFFFFFFFFFFF
    g.manual_seed(value)
    return g


def bussi_noise(seed: int, step: int, nf: float, dtype, device):
    """Bussi's two draws for one step, as 0-d tensors on ``device``:
    r1 ~ N(0, 1) and r2 ~ chi-squared with nf - 1 degrees of freedom.

    r2 is the sum of nf - 1 squared standard normals (nf = d (N - 1) is an
    integer), drawn and reduced on the device: nothing is read back to the
    host."""
    g = step_generator(seed, step, device)
    r1 = torch.randn((), generator=g, device=device, dtype=dtype)
    k = int(round(nf)) - 1
    if k <= 0:
        return r1, torch.zeros((), device=device, dtype=dtype)
    z = torch.randn((k,), generator=g, device=device, dtype=dtype)
    return r1, torch.sum(z * z)


def bussi_scale_from_kinetic(kinetic, ktemp, nf, dt, tau, r1, r2):
    """The exact Bussi rescale factor given the kinetic energy and the two
    draws ``r1``, ``r2`` (see :func:`bussi_noise`)."""
    current_temperature = 2.0 * kinetic / nf
    term_1 = math.exp(-float(dt) / float(tau))
    c2 = (1.0 - term_1) * float(ktemp) / (current_temperature * nf)
    term_2 = c2 * (r2 + r1 * r1)
    term_3 = 2.0 * r1 * torch.sqrt(term_1 * c2)
    return torch.sqrt(term_1 + term_2 + term_3)
