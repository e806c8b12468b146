"""The velocity finish's scalar tail as one kernel: the kinetic energy,
Bussi's draws, the rescale factor and the temperature of one MD step.

Counterpart of ``mdtpu/integrate/thermostat.py:52-67
bussi_scale_from_kinetic`` with ``:31 compute_kinetic`` and ``:37-40
compute_temperature``, which XLA fuses into one kernel. Composed of torch
operations (:mod:`mdtpu_torch.integrate.thermostat`) the same tail takes
about 22 launches on the card, each a node of the captured slot step;
:func:`velocity_finish` launches ``velocity_finish_kernel`` of
``csrc/philox_draws.cu`` once (``velocity_finish.launches``) and returns
the 0-d ``scale`` and ``temperature`` a step multiplies and records.

CPU tensors take :func:`velocity_finish_plain`: the torch composition
through the seams ``thermostat.bussi_noise`` and
``thermostat.bussi_scale_from_kinetic`` (which tests replace to replay the
JAX package's draws), on the kinetic energy given or, where the
velocities are given, summed in the kernel's order (:func:`kinetic_plain`).
Given the same kinetic energy the kernel equals the composition on the card
bit for bit; its own sum (float64, a fixed order that depends on the count
of values alone) differs from ``torch.sum``'s by rounding.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mdtpu_torch.integrate import thermostat
from mdtpu_torch.ops import philox_draws
from mdtpu_torch.utils import counters

FINISH_THREADS = 256      # a block of the summing kernel
FINISH_MAX_BLOCKS = 256
FINISH_PER_BLOCK = 2048   # values a block sums below the cap
WARP = 32


class TargetTable(NamedTuple):
    """NVT's targets of a segment on the device: the step ``s`` takes
    ``table[s - base]`` (``base`` a 0-d int64 tensor, the segment's first
    step), as the slot advance fills them."""

    table: torch.Tensor
    base: torch.Tensor

    def at(self, step):
        """The target of ``step`` (a 0-d int64 tensor) as a 0-d tensor."""
        return self.table.index_select(0, (step - self.base).reshape(1))[0]


def finish_blocks(n: int) -> int:
    """The summing kernel's blocks for ``n`` values."""
    return min(max(-(-n // FINISH_PER_BLOCK), 1), FINISH_MAX_BLOCKS)


def _halve(a):
    """A warp's tree of shuffles down: the last axis (a power of two)
    halved until one value is left, ``a[:h] + a[h:]`` each time."""
    while a.shape[-1] > 1:
        h = a.shape[-1] // 2
        a = a[..., :h] + a[..., h:]
    return a[..., 0]


def _block_sum(a):
    """The kernel's ``block_sum`` of ``(..., 256)`` float64 values: each
    warp's tree, then the warps' sums padded to a warp with zeros and the
    same tree."""
    warps = _halve(a.reshape(*a.shape[:-1], FINISH_THREADS // WARP, WARP))
    pad = warps.new_zeros((*warps.shape[:-1], WARP - warps.shape[-1]))
    return _halve(torch.cat([warps, pad], -1))


def kinetic_plain(velocities):
    """``0.5 sum v^2`` as the summing kernel takes it, a 0-d tensor of the
    velocities' dtype: the squares in float64, thread ``t`` of block ``b``
    adding in order the values ``b 256 + t + k G 256`` (``G`` =
    :func:`finish_blocks`), each block's threads by :func:`_block_sum`, the
    blocks' partials in block order by the same tree, half of it rounded
    to the dtype."""
    x = velocities.reshape(-1).to(torch.float64)
    n = x.numel()
    blocks = finish_blocks(n)
    width = blocks * FINISH_THREADS
    rows = -(-n // width)
    sq = torch.cat([x * x, x.new_zeros(rows * width - n)]).reshape(rows,
                                                                   width)
    acc = x.new_zeros(width)
    for row in sq:
        acc = acc + row
    partials = _block_sum(acc.reshape(blocks, FINISH_THREADS))
    partials = torch.cat([partials, partials.new_zeros(FINISH_THREADS
                                                       - blocks)])
    return (0.5 * _block_sum(partials)).to(velocities.dtype)


def velocity_finish_plain(velocities, kinetic, seed, step, nf, dt, tau,
                          ktemp):
    """``(scale, temperature)`` by torch operations: NVT (``ktemp`` a host
    float, a 0-d tensor or a :class:`TargetTable`) Bussi's factor from the
    draws of ``thermostat.bussi_noise`` and ``scale^2 2K / nf``; NVE
    (``ktemp`` None) ``(1, 2K / nf)``. ``K``: ``kinetic`` where given, else
    :func:`kinetic_plain` of ``velocities``."""
    if kinetic is None:
        kinetic = kinetic_plain(velocities)
    if ktemp is None:
        return torch.ones_like(kinetic), 2.0 * kinetic / nf
    if isinstance(ktemp, TargetTable):
        ktemp = ktemp.at(step)
    r1, r2 = thermostat.bussi_noise(seed, step, nf, kinetic.dtype,
                                    kinetic.device)
    scale = thermostat.bussi_scale_from_kinetic(kinetic, ktemp, nf, dt, tau,
                                                r1, r2)
    return scale, scale * scale * 2.0 * kinetic / nf


def velocity_finish(velocities, kinetic, seed, step, nf, dt, tau, ktemp,
                    out=None):
    """``(scale, temperature)`` of one step as 0-d tensors of the state's
    dtype: :func:`velocity_finish_plain`'s function, written into ``out``
    (a ``(2,)`` tensor of that dtype, e.g. :func:`finish_pair`) where
    given, else into a new one. Give ``velocities``
    (any shape; the kernel sums them) or ``kinetic`` (a 0-d tensor, e.g.
    summed over a shard ring). ``step``: a host int or a 0-d int64 tensor;
    ``ktemp``: NVT's target (a host float, a 0-d tensor or a
    :class:`TargetTable`), None for NVE. CUDA tensors launch the kernel
    (adds one to ``velocity_finish.launches``) as a programmatic dependent
    of the kernel before it: given ``kinetic``, it reads the step and draws
    before it waits for that kernel, which must not write a step tensor
    (the rule of ``philox_draws.launch_options``); summing, it reads
    everything after the wait. CPU tensors take the plain version."""
    ref = kinetic if kinetic is not None else velocities
    if out is not None and (out.shape != (2,) or out.dtype != ref.dtype
                            or out.device != ref.device
                            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous (2,) tensor of the "
                         "velocities' dtype and device")
    if ref.device.type == "cpu":
        scale, temperature = velocity_finish_plain(
            velocities, kinetic, seed, step, nf, dt, tau, ktemp)
        if out is None:
            return scale, temperature
        out[0], out[1] = scale, temperature
        return out[0], out[1]
    if ref.device.type != "cuda":
        raise ValueError(f"unsupported device {ref.device}")
    dtype, device = ref.dtype, ref.device
    philox_draws._check_dtype(dtype)
    if velocities is not None:
        velocities = velocities.contiguous()
    nvt = ktemp is not None
    term_1 = math.exp(-float(dt) / float(tau)) if nvt else 0.0
    table = base = None
    numer = 1.0 - term_1
    if isinstance(ktemp, TargetTable):
        table, base = ktemp
    elif isinstance(ktemp, torch.Tensor):
        table = ktemp
    elif nvt:
        numer = (1.0 - term_1) * ktemp
    for t in (kinetic, table):
        if t is not None and (t.dtype != dtype or t.device != device):
            raise ValueError("velocity_finish takes one dtype on one device")
    if isinstance(step, torch.Tensor) and (
            step.dtype != torch.int64 or step.dim() != 0
            or step.device != device):
        raise ValueError("the step must be a 0-d int64 tensor on the "
                         "velocities' device")
    if out is None:
        out = torch.empty(2, dtype=dtype, device=device)
    k0, k1 = philox_draws.seed_key(seed)

    def ptr(t):
        return None if t is None else t.data_ptr()

    tensor_step = isinstance(step, torch.Tensor)
    philox_draws.launch(
        "mdtpu_velocity_finish", dtype,
        (ptr(velocities), 0 if velocities is None else velocities.numel(),
         ptr(kinetic), step.data_ptr() if tensor_step else None,
         0 if tensor_step else int(step), ptr(table), ptr(base), numer,
         term_1, float(nf), k0, k1, int(nvt),
         philox_draws.launch_options(),
         out.data_ptr()),
        "velocity_finish", device)
    velocity_finish.launches += 1
    return out[0], out[1]


velocity_finish.launches = 0
counters.register(velocity_finish, "launches")


def finish_buffer(temperature):
    """A copy of the 0-d ``temperature`` that is the second value of a
    ``(2,)`` tensor of its own: a buffer the finish can write ``(scale,
    temperature)`` around (:func:`finish_pair`), so that the temperature
    lands in it with no copy. The first value is scratch."""
    return temperature.reshape(1).repeat(2)[1]


def finish_pair(temperature):
    """The ``(2,)`` view ``(scale, temperature)`` around a temperature
    buffer made by :func:`finish_buffer`."""
    offset = temperature.storage_offset()
    if (temperature.dim() != 0 or offset < 1
            or temperature.untyped_storage().nbytes()
            < (offset + 1) * temperature.element_size()):
        raise ValueError("the temperature is not a finish_buffer")
    return temperature.as_strided((2,), (1,), offset - 1)
