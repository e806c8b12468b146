"""The velocity-Verlet chain as one kernel: the slot step's, launched three
ways, and the particle-order step's.

Counterpart of the update in ``mdtpu/integrate/slot_step.py:579-605``
(``make_slot_step``; the rescale of ``md_velocity_finish``,
``mdtpu/integrate/step.py:78-100``), which XLA fuses into the segment's
loop. The port's slot step (:mod:`mdtpu_torch.integrate.slot_step`) runs
it as three launches of ``verlet_update_kernel`` in
``csrc/verlet_update.cu``:

  * :func:`kick_drift` before the sweep: ``v, vc <- kahan(v, vc, f dt/2)``,
    ``x, xc <- kahan(x, xc, v dt)``, and for the hi/lo sweep ``lo = -xc``;
  * :func:`kick` after the sweep: ``v, vc <- kahan(v, vc, f dt/2)``;
  * :func:`rescale` after the velocity finish (NVT): ``v <- v scale`` with
    ``scale`` read on the device, and ``vc <- 0``.

``compensated=False`` takes plain adds and leaves ``vc`` and ``xc`` alone.
:func:`kick` and :func:`rescale` update ``v`` and ``vc`` in place and, where
given a step counter (a 0-d int64 tensor), advance it to ``step_out`` (in
place by default): the slot step gives it to the chain's last launch, since
the velocity finish between them reads the step's own counter.
:func:`kick_drift` writes into ``out`` (the inputs themselves for an update
in place, as the slot advance's buffers take it) or into new tensors.

The Brownian slot step's update (``mdtpu/integrate/slot_step.py:557-577``,
also fused by XLA) is :func:`brownian_update`, ``brownian_update_kernel``
of the same source: the noise drawn inside (Philox, the bits of
:func:`mdtpu_torch.ops.philox_draws.uniform_noise`), masked to the occupied
slots, ``x, xc <- kahan(x, xc, f drift + xi sigma)``, and the step's
scalars (the virial sampled every 10 steps, the temperature, the step
counter), in one launch.

The particle-order step (``mdtpu/integrate/step.py:160-169`` and
``:233-242``, fused by XLA into the segment's ``fori_loop``) takes two more
kernels of the same source on ``(N, d)`` particle rows:
:func:`kick_drift_wrap` (the half-kick, the drift and the periodic wrap by
any cell, ``kick_drift_wrap_kernel``) and :func:`brownian_rows` (the
Brownian move, its noise drawn inside, the wrap and the step's scalars,
``brownian_rows_kernel``); its kick and NVT's rescale are :func:`kick` and
:func:`rescale`.

CUDA tensors launch the kernel (or raise); each launch adds one to the
wrapper's ``launches``. CPU tensors take the plain versions
(:func:`kick_drift_plain`, :func:`kick_plain`, :func:`rescale_plain`,
:func:`brownian_update_plain`, :func:`kick_drift_wrap_plain`,
:func:`brownian_rows_plain`): the torch composition the steps ran before,
on :func:`mdtpu_torch.utils.math.kahan_add` and the wraps of
:mod:`mdtpu_torch.core.box`. The kernel rounds each operation as that
composition does on the card, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mdtpu_torch.core.box import wrap_positions, wrap_positions_compensated
from mdtpu_torch.integrate import step as _step
from mdtpu_torch.ops import _cuda_build, philox_draws
from mdtpu_torch.potentials.base import rounded
from mdtpu_torch.utils import counters
from mdtpu_torch.utils.math import kahan_add

NAME = "verlet_update"
KICK_DRIFT, KICK, RESCALE = 0, 1, 2   # the kernel's variants

_P, _I, _L, _D, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_double, ctypes.c_uint)
_ARGS = (_I, _I, _L) + (_P,) * 13 + (_D, _D, _P)
_BROWNIAN_ARGS = (_I, _L, _L) + (_P,) * 14 + (_L, _D, _D, _D, _U, _U, _U,
                                             _I, _P)
_ROWS_ARGS = (_I, _I, _L) + (_P,) * 14 + (_D, _D, _P)
_BROWNIAN_ROWS_ARGS = (_I, _I, _L) + (_P,) * 17 + (_L, _D, _D, _D, _U, _U,
                                                   _U, _I, _P)
_SIGNATURES = (("mdtpu_verlet_update_f32", _ARGS),
               ("mdtpu_verlet_update_f64", _ARGS),
               ("mdtpu_brownian_update_f32", _BROWNIAN_ARGS),
               ("mdtpu_brownian_update_f64", _BROWNIAN_ARGS),
               ("mdtpu_kick_drift_wrap_f32", _ROWS_ARGS),
               ("mdtpu_kick_drift_wrap_f64", _ROWS_ARGS),
               ("mdtpu_brownian_rows_f32", _BROWNIAN_ROWS_ARGS),
               ("mdtpu_brownian_rows_f64", _BROWNIAN_ROWS_ARGS),
               ("mdtpu_verlet_update_census", (_P, _P)))
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _add(x, comp, dx, compensated):
    if compensated:
        return kahan_add(x, comp, dx)
    return x + dx, comp


# ------------------------------------------------------- plain versions


def kick_drift_plain(forces, v, vc, x, xc, half, dt, compensated, lo=False):
    """``(v, vc, x, xc, lo)``: the half-kick and the drift as torch
    operations (``lo``: ``-xc`` after the drift where True, else None)."""
    v, vc = _add(v, vc, forces * half, compensated)
    x, xc = _add(x, xc, v * dt, compensated)
    return v, vc, x, xc, (-xc if lo else None)


def kick_plain(forces, v, vc, half, compensated):
    """``(v, vc)`` after the half-kick, as torch operations."""
    return _add(v, vc, forces * half, compensated)


def rescale_plain(v, vc, scale, compensated):
    """``(v scale, 0)`` (``vc`` as it is where not ``compensated``)."""
    return v * scale, (vc.new_zeros(vc.shape) if compensated else vc)


# -------------------------------------------------------------- wrappers


def _library():
    return _cuda_build.load(NAME, _SIGNATURES)


def _check(tensors, step=None, step_out=None):
    ref = tensors[0]
    if ref.device.type != "cuda":
        raise ValueError(f"unsupported device {ref.device}")
    if ref.dtype not in _SUFFIX:
        raise TypeError(f"the Verlet update takes float32 or float64, got "
                        f"{ref.dtype}")
    for t in tensors:
        if (t.dtype != ref.dtype or t.device != ref.device
                or t.shape != ref.shape or not t.is_contiguous()):
            raise ValueError("the Verlet update takes contiguous CUDA "
                             "tensors of one dtype and shape")
    for s in (step, step_out):
        if s is not None and (s.dtype != torch.int64 or s.dim() != 0
                              or s.device != ref.device):
            raise ValueError("the step must be a 0-d int64 tensor on the "
                             "values' device")


def _launch(variant, compensated, n, inputs, outputs, step, step_out, half,
            dt, device, dtype):
    """inputs: f, v, vc, x, xc, scale; outputs: v, vc, x, xc, lo (None
    where the variant takes none)."""
    lib = _library()
    fn = getattr(lib, f"mdtpu_verlet_update_{_SUFFIX[dtype]}")

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(variant, int(compensated), n, *(ptr(t) for t in inputs),
                *(ptr(t) for t in outputs), ptr(step), ptr(step_out),
                float(half), float(dt), stream)
    _cuda_build.check(lib, NAME, rc, "verlet_update")


def _step_plain(step, step_out):
    if step is None:
        return
    if step_out is None:
        step.add_(1)
    else:
        torch.add(step, 1, out=step_out)


def kick_drift(forces, v, vc, x, xc, half, dt, compensated, out=None,
               lo=None):
    """``(v, vc, x, xc)`` after the half-kick ``f half`` and the drift
    ``v dt`` (deferred wrap: no fold). ``out``: the four tensors to write
    (the inputs for an update in place); None: new tensors (``vc`` and
    ``xc`` the inputs themselves where not ``compensated``). ``lo``: a
    tensor that receives ``-xc`` after the drift (the hi/lo sweep's low
    word; ``compensated`` only). One launch on the card
    (``kick_drift.launches``)."""
    if lo is not None and not compensated:
        raise ValueError("the low word needs compensated=True")
    if v.device.type == "cpu":
        got = kick_drift_plain(forces, v, vc, x, xc, half, dt, compensated,
                               lo is not None)
        if out is None:
            out = got[:4]
        for dst, src in zip(tuple(out) + (lo,), got):
            if dst is not None and dst is not src:
                dst.copy_(src)
        return tuple(out)
    if out is None:
        out = (torch.empty_like(v),
               torch.empty_like(vc) if compensated else vc,
               torch.empty_like(x),
               torch.empty_like(xc) if compensated else xc)
    out = tuple(out)
    _check((forces, v, vc, x, xc, *out)
           + (() if lo is None else (lo,)))
    _launch(KICK_DRIFT, compensated, v.numel(), (forces, v, vc, x, xc, None),
            (*out, lo), None, None, half, dt, v.device, v.dtype)
    kick_drift.launches += 1
    return out


def kick(forces, v, vc, half, compensated, step=None, step_out=None):
    """The half-kick ``f half`` on ``v`` and ``vc``, in place; where
    ``step`` is given (a 0-d int64 tensor), ``step_out`` (``step`` itself
    by default) becomes ``step + 1``. One launch on the card
    (``kick.launches``)."""
    if v.device.type == "cpu":
        nv, nvc = kick_plain(forces, v, vc, half, compensated)
        v.copy_(nv)
        if nvc is not vc:
            vc.copy_(nvc)
        _step_plain(step, step_out)
        return
    _check((forces, v, vc), step, step_out)
    _launch(KICK, compensated, v.numel(), (forces, v, vc, None, None, None),
            (v, vc if compensated else None, None, None, None), step,
            step if step_out is None else step_out, half, 0.0, v.device,
            v.dtype)
    kick.launches += 1


def rescale(v, vc, scale, compensated, step=None, step_out=None):
    """``v <- v scale`` (``scale`` a 0-d tensor of ``v``'s dtype, read on
    the device) and ``vc <- 0`` where ``compensated``, in place; ``step``
    as in :func:`kick`. One launch on the card (``rescale.launches``)."""
    if v.device.type == "cpu":
        nv, nvc = rescale_plain(v, vc, scale, compensated)
        v.copy_(nv)
        if nvc is not vc:
            vc.copy_(nvc)
        _step_plain(step, step_out)
        return
    _check((v, vc), step, step_out)
    if (scale.dim() != 0 or scale.dtype != v.dtype
            or scale.device != v.device):
        raise ValueError("the scale must be a 0-d tensor of the "
                         "velocities' dtype and device")
    _launch(RESCALE, compensated, v.numel(), (None, v, vc, None, None, scale),
            (v, vc if compensated else None, None, None, None), step,
            step if step_out is None else step_out, 0.0, 0.0, v.device,
            v.dtype)
    rescale.launches += 1


# ------------------------------------------------------------- Brownian


def brownian_coefficients(dt, ktemp, dtype):
    """``(drift, sigma, ktemp)`` of the Brownian move ``dx = F drift + xi
    sigma`` as Python numbers rounded to ``dtype`` as the JAX package casts
    them: ``dt`` and ``ktemp`` rounded first, then ``dt / ktemp`` and
    ``sqrt(2 dt)`` each rounded once more."""
    dt = rounded(dt, dtype)
    ktemp = rounded(ktemp, dtype)
    return (rounded(dt / ktemp, dtype),
            rounded(math.sqrt(rounded(2.0 * dt, dtype)), dtype), ktemp)


def brownian_update_plain(forces, virial, state, drift, sigma, ktemp,
                          compensated, rank=None):
    """``(positions, pos_comp, virial_accum, nprom, temperature)`` after the
    Brownian slot step's update, as torch operations: the noise of
    :func:`mdtpu_torch.integrate.step.brownian_noise` (called through the
    module, the seam tests replace) at ``state.step``, 0 on vacant slots,
    the move ``forces drift + noise sigma`` through the Kahan add (deferred
    wrap: no fold), the virial sampled where ``step % 10 == 0`` and the
    temperature ``ktemp``. ``drift``, ``sigma`` and ``ktemp``: Python
    numbers already rounded to the state's dtype; ``rank``: a shard's rank
    (its own noise) or None."""
    dtype = state.dtype
    noise = torch.where(
        state.nbrs.occupied[None, :],
        _step.brownian_noise(state.seed, state.step, state.positions.shape,
                             dtype, state.device,
                             *(() if rank is None else (rank,))),
        0.0)
    x, xc = _add(state.positions, state.pos_comp,
                 forces * drift + noise * sigma, compensated)
    virial_accum, nprom = _step.brownian_virial_sample(state, virial)
    temperature = torch.full((), ktemp, dtype=dtype, device=state.device)
    return x, xc, virial_accum, nprom, temperature


def _check_scalar(t, dtype, device, what):
    if (t.dim() != 0 or t.dtype != dtype or t.device != device):
        raise ValueError(f"{what} must be a 0-d {dtype} tensor on "
                         f"{device}")


def brownian_update(forces, virial, state, drift, sigma, ktemp, compensated,
                    rank=None, in_place=False):
    """The Brownian slot step's update of ``state`` (a slot-layout state)
    given the sweep's ``forces`` and ``virial``: :func:`brownian_update_
    plain`'s results and the step plus one, as ``(positions, pos_comp,
    step, virial_accum, nprom, temperature)``. ``in_place``: written into
    the state's own tensors (the slot advance's buffers: the positions, the
    compensation, the accumulators, the temperature and the step counter, a
    0-d int64 tensor) and those returned; else new tensors (``pos_comp``
    the state's own where not ``compensated``; a host-int step comes back
    plus one).

    On the card one launch (``brownian_update.launches``) that draws the
    noise inside, bit for bit :func:`mdtpu_torch.ops.philox_draws.
    uniform_noise`'s, as a programmatic dependent of the kernel before it,
    which must not write the step, the occupancy or the positions
    (:func:`~mdtpu_torch.ops.philox_draws.launch_options`: the pair sweep
    writes the forces and the virial, read after the wait). On the CPU the
    plain version."""
    step = state.step
    counter = isinstance(step, torch.Tensor)
    if in_place and not counter:
        raise ValueError("an update in place takes a device step counter")
    if state.positions.device.type == "cpu":
        got = brownian_update_plain(forces, virial, state, drift, sigma,
                                    ktemp, compensated, rank)
        if not in_place:
            return (*got[:2], step + 1, *got[2:])
        mine = (state.positions, state.pos_comp, state.virial_accum,
                state.nprom, state.temperature)
        for dst, src in zip(mine, got):
            if dst is not src:
                dst.copy_(src)
        step.add_(1)
        return (*mine[:2], step, *mine[2:])
    x, xc = state.positions, state.pos_comp
    dtype, device = x.dtype, x.device
    _check((forces, x, xc))
    occupied = state.nbrs.occupied
    if (occupied.dtype != torch.bool or occupied.dim() != 1
            or occupied.numel() != x.shape[1] or occupied.device != device
            or not occupied.is_contiguous()):
        raise ValueError("occupied must be a contiguous (S,) bool tensor on "
                         "the positions' device")
    for t, what in ((virial, "the virial"),
                    (state.virial_accum, "virial_accum"),
                    (state.temperature, "the temperature")):
        _check_scalar(t, dtype, device, what)
    _check_scalar(state.nprom, torch.int64, device, "nprom")
    if counter:
        _check_scalar(step, torch.int64, device, "the step")
    if in_place:
        outs = (x, xc, state.virial_accum, state.nprom, state.temperature)
        step_out = step
    else:
        outs = (torch.empty_like(x),
                torch.empty_like(xc) if compensated else xc,
                torch.empty_like(state.virial_accum),
                torch.empty_like(state.nprom),
                torch.empty((), dtype=dtype, device=device))
        step_out = torch.empty_like(step) if counter else None
    k0, k1 = philox_draws.seed_key(state.seed)
    lib = _library()
    fn = getattr(lib, f"mdtpu_brownian_update_{_SUFFIX[dtype]}")

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(int(compensated), x.numel(), x.shape[1], forces.data_ptr(),
                x.data_ptr(), xc.data_ptr(), occupied.data_ptr(),
                virial.data_ptr(), state.virial_accum.data_ptr(),
                state.nprom.data_ptr(), outs[0].data_ptr(),
                outs[1].data_ptr(), outs[2].data_ptr(), outs[3].data_ptr(),
                outs[4].data_ptr(), ptr(step if counter else None),
                ptr(step_out), 0 if counter else int(step), float(drift),
                float(sigma), float(ktemp), k0, k1,
                philox_draws.noise_stream(rank),
                philox_draws.launch_options(), stream)
    _cuda_build.check(lib, NAME, rc, "brownian_update")
    brownian_update.launches += 1
    return (*outs[:2], step_out if counter else step + 1, *outs[2:])


# ---------------------------------------------------- particle rows


def _wrap(x, xc, images, cell, cell_inv, compensated):
    if compensated:
        return wrap_positions_compensated(x, xc, images, cell, cell_inv)
    x, images = wrap_positions(x, images, cell, cell_inv)
    return x, xc, images


def kick_drift_wrap_plain(forces, v, vc, x, xc, images, cell, cell_inv,
                          half, dt, compensated, lo=False):
    """``(v, vc, x, xc, images, lo)``: the particle-order step's half-kick,
    drift and periodic wrap as torch operations
    (:func:`~mdtpu_torch.core.box.wrap_positions_compensated`, or
    :func:`~mdtpu_torch.core.box.wrap_positions` where not
    ``compensated``); ``lo``: ``-xc`` after the wrap where True, else
    None."""
    v, vc = _add(v, vc, forces * half, compensated)
    x, xc = _add(x, xc, v * dt, compensated)
    x, xc, images = _wrap(x, xc, images, cell, cell_inv, compensated)
    return v, vc, x, xc, images, (-xc if lo else None)


def _check_rows(tensors, images, cell, cell_inv):
    ref = tensors[0]
    _check(tensors)
    if ref.dim() != 2 or ref.shape[1] not in (2, 3):
        raise ValueError("particle rows must be (N, 2) or (N, 3)")
    d = ref.shape[1]
    for t in images:
        if (t.dtype != torch.int64 or t.shape != ref.shape
                or t.device != ref.device or not t.is_contiguous()):
            raise ValueError("images must be contiguous int64 of the "
                             "positions' shape and device")
    for t in (cell, cell_inv):
        if (t.shape != (d, d) or t.dtype != ref.dtype
                or t.device != ref.device):
            raise ValueError("the cell and its inverse must be (d, d) of "
                             "the positions' dtype and device")


def kick_drift_wrap(forces, v, vc, x, xc, images, cell, cell_inv, half, dt,
                    compensated, out=None, lo=None):
    """``(v, vc, x, xc, images)`` of ``(N, d)`` particle rows after the
    half-kick ``f half``, the drift ``v dt`` and the periodic wrap by the
    ``(d, d)`` cell (any, tilted included) and its inverse. ``out``: the
    five tensors to write (the inputs for an update in place); None: new
    tensors (``vc`` and ``xc`` the inputs themselves where not
    ``compensated``). ``lo``: a tensor that receives ``-xc`` after the wrap
    (the hi/lo sweep's low word; ``compensated`` only). One launch on the
    card (``kick_drift_wrap.launches``); CPU tensors take
    :func:`kick_drift_wrap_plain`."""
    if lo is not None and not compensated:
        raise ValueError("the low word needs compensated=True")
    if v.device.type == "cpu":
        got = kick_drift_wrap_plain(forces, v, vc, x, xc, images, cell,
                                    cell_inv, half, dt, compensated,
                                    lo is not None)
        if out is None:
            out = got[:5]
        for dst, src in zip(tuple(out) + (lo,), got):
            if dst is not None and dst is not src:
                dst.copy_(src)
        return tuple(out)
    if out is None:
        out = (torch.empty_like(v),
               torch.empty_like(vc) if compensated else vc,
               torch.empty_like(x),
               torch.empty_like(xc) if compensated else xc,
               torch.empty_like(images))
    out = tuple(out)
    _check_rows((forces, v, vc, x, xc, *out[:4])
                + (() if lo is None else (lo,)), (images, out[4]), cell,
                cell_inv)
    cell, cell_inv = cell.contiguous(), cell_inv.contiguous()
    lib = _library()
    fn = getattr(lib, f"mdtpu_kick_drift_wrap_{_SUFFIX[v.dtype]}")
    comp = (lambda t: t.data_ptr()) if compensated else (lambda t: None)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    with torch.cuda.device(v.device):
        rc = fn(int(compensated), v.shape[1], v.shape[0], forces.data_ptr(),
                v.data_ptr(), comp(vc), x.data_ptr(), comp(xc),
                images.data_ptr(), cell.data_ptr(), cell_inv.data_ptr(),
                out[0].data_ptr(), comp(out[1]), out[2].data_ptr(),
                comp(out[3]), out[4].data_ptr(),
                None if lo is None else lo.data_ptr(), float(half),
                float(dt), stream)
    _cuda_build.check(lib, NAME, rc, "kick_drift_wrap")
    kick_drift_wrap.launches += 1
    return out


def brownian_rows_plain(forces, virial, state, drift, sigma, ktemp,
                        compensated):
    """``(positions, pos_comp, images, virial_accum, nprom,
    temperature)`` after the particle-order Brownian step's move, as torch
    operations: the noise of
    :func:`mdtpu_torch.integrate.step.brownian_noise` (called through the
    module, the seam tests replace) at ``state.step``, the move ``forces
    drift + noise sigma`` through the Kahan add (plain where not
    ``compensated``), the wrap, the virial sampled where ``step % 10 ==
    0`` and the temperature ``ktemp``. ``drift``, ``sigma`` and ``ktemp``:
    Python numbers already rounded to the state's dtype."""
    dtype = state.dtype
    noise = _step.brownian_noise(state.seed, state.step,
                                 state.positions.shape, dtype, state.device)
    x, xc = _add(state.positions, state.pos_comp,
                 forces * drift + noise * sigma, compensated)
    x, xc, images = _wrap(x, xc, state.images, state.unitcell,
                          state.unitcell_inv, compensated)
    virial_accum, nprom = _step.brownian_virial_sample(state, virial)
    temperature = torch.full((), ktemp, dtype=dtype, device=state.device)
    return x, xc, images, virial_accum, nprom, temperature


def brownian_rows(forces, virial, state, drift, sigma, ktemp, compensated,
                  in_place=False):
    """The particle-order Brownian step's move of ``state`` (``(N, d)``
    rows) given the forces and the virial: :func:`brownian_rows_plain`'s
    results and the step plus one, as ``(positions, pos_comp, images,
    step, virial_accum, nprom, temperature)``. ``in_place``: written into
    the state's own tensors (the particle advance's buffers; the step a
    0-d int64 counter) and those returned; else new tensors (``pos_comp``
    the state's own where not ``compensated``; a host-int step comes back
    plus one).

    On the card one launch (``brownian_rows.launches``) that draws the
    noise inside, bit for bit :func:`mdtpu_torch.ops.philox_draws.
    uniform_noise`'s, as a programmatic dependent of the kernel before it,
    which must not write the step, the cell, the positions, their
    compensation or the images
    (:func:`~mdtpu_torch.ops.philox_draws.launch_options`: the pair sweep
    writes the forces and the virial, read after the wait). On the CPU the
    plain version."""
    step = state.step
    counter = isinstance(step, torch.Tensor)
    if in_place and not counter:
        raise ValueError("an update in place takes a device step counter")
    mine = (state.positions, state.pos_comp, state.images,
            state.virial_accum, state.nprom, state.temperature)
    if state.positions.device.type == "cpu":
        got = brownian_rows_plain(forces, virial, state, drift, sigma, ktemp,
                                  compensated)
        if not in_place:
            return (*got[:3], step + 1, *got[3:])
        for dst, src in zip(mine, got):
            if dst is not src:
                dst.copy_(src)
        step.add_(1)
        return (*mine[:3], step, *mine[3:])
    x, xc = state.positions, state.pos_comp
    dtype, device = x.dtype, x.device
    _check_rows((forces, x, xc), (state.images,), state.unitcell,
                state.unitcell_inv)
    for t, what in ((virial, "the virial"),
                    (state.virial_accum, "virial_accum"),
                    (state.temperature, "the temperature")):
        _check_scalar(t, dtype, device, what)
    _check_scalar(state.nprom, torch.int64, device, "nprom")
    if counter:
        _check_scalar(step, torch.int64, device, "the step")
    if in_place:
        outs, step_out = mine, step
    else:
        outs = (torch.empty_like(x),
                torch.empty_like(xc) if compensated else xc,
                torch.empty_like(state.images),
                torch.empty_like(state.virial_accum),
                torch.empty_like(state.nprom),
                torch.empty((), dtype=dtype, device=device))
        step_out = torch.empty_like(step) if counter else None
    cell = state.unitcell.contiguous()
    cell_inv = state.unitcell_inv.contiguous()
    k0, k1 = philox_draws.seed_key(state.seed)
    lib = _library()
    fn = getattr(lib, f"mdtpu_brownian_rows_{_SUFFIX[dtype]}")
    comp = (lambda t: t.data_ptr()) if compensated else (lambda t: None)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(int(compensated), x.shape[1], x.shape[0], forces.data_ptr(),
                x.data_ptr(), comp(xc), state.images.data_ptr(),
                cell.data_ptr(), cell_inv.data_ptr(), virial.data_ptr(),
                state.virial_accum.data_ptr(), state.nprom.data_ptr(),
                outs[0].data_ptr(), comp(outs[1]), outs[2].data_ptr(),
                outs[3].data_ptr(), outs[4].data_ptr(), outs[5].data_ptr(),
                step.data_ptr() if counter else None,
                None if step_out is None else step_out.data_ptr(),
                0 if counter else int(step), float(drift), float(sigma),
                float(ktemp), k0, k1, philox_draws.noise_stream(),
                philox_draws.launch_options(), stream)
    _cuda_build.check(lib, NAME, rc, "brownian_rows")
    brownian_rows.launches += 1
    return (*outs[:3], step_out if counter else step + 1, *outs[3:])


def capture_census(device):
    """``{"programmatic_into_brownian_update": n, "brownian_edges_error":
    rc, "programmatic_into_brownian_rows": m}``: the programmatic edges of
    the graph being captured on ``device``'s current stream that enter a
    Brownian slot update node and a particle-row Brownian move node (-1
    where the edges could not be read, ``rc`` the error). Raises where the
    stream is not capturing."""
    lib = _library()
    out = (ctypes.c_longlong * 3)()
    with torch.cuda.device(device):
        _cuda_build.check(lib, NAME, lib.mdtpu_verlet_update_census(
            torch.cuda.current_stream(device).cuda_stream, out),
            "verlet_update_census")
    return {"programmatic_into_brownian_update": out[0],
            "brownian_edges_error": out[1],
            "programmatic_into_brownian_rows": out[2]}


WRAPPERS = (kick_drift, kick, rescale, brownian_update, kick_drift_wrap,
            brownian_rows)


def reset_launches():
    """Set the six wrappers' launch counts to 0."""
    for wrapper in WRAPPERS:
        wrapper.launches = 0


reset_launches()
for _wrapper in WRAPPERS:
    counters.register(_wrapper, "launches")
