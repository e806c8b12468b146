"""The slot step's velocity-Verlet chain as one kernel, launched three ways.

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

CUDA tensors launch the kernel (or raise); each launch adds one to the
wrapper's ``launches``. CPU tensors take the plain versions
(:func:`kick_drift_plain`, :func:`kick_plain`, :func:`rescale_plain`):
the torch composition the slot step ran before, on
:func:`mdtpu_torch.utils.math.kahan_add`. The kernel rounds each operation
as that composition does on the card, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from mdtpu_torch.ops import _cuda_build
from mdtpu_torch.utils import counters
from mdtpu_torch.utils.math import kahan_add

NAME = "verlet_update"
KICK_DRIFT, KICK, RESCALE = 0, 1, 2   # the kernel's variants

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_ARGS = (_I, _I, _L) + (_P,) * 13 + (_D, _D, _P)
_SIGNATURES = (("mdtpu_verlet_update_f32", _ARGS),
               ("mdtpu_verlet_update_f64", _ARGS))
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


def reset_launches():
    """Set the three wrappers' launch counts to 0."""
    for wrapper in (kick_drift, kick, rescale):
        wrapper.launches = 0


reset_launches()
for _wrapper in (kick_drift, kick, rescale):
    counters.register(_wrapper, "launches")
