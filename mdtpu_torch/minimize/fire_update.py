"""FIRE's update as kernels that keep the minimizer's state on the device.

The JAX package runs FIRE as one device program (``mdtpu/minimize/fire.py``:
``_fire_once``'s body, ``make_slot_fire``'s ``fire_step`` and ``g_f_rms``).
Here an iteration is three launches of ``csrc/fire_update.cu`` on a few
device buffers, so that a CUDA graph's WHILE node can loop them:

  * :func:`fire_reduce`: the kick ``v' = v + dt F``, the maxima and the
    max-scaled sums (the power, ``|v'|^2``, ``|F|^2``) and the scalar tail
    (the mix's coefficients, the new ``dt`` and ``alpha``, the steps since
    the power turned negative);
  * :func:`fire_move`: the mix, the zeroing, the capped displacement and
    ``x += disp`` in place, in particle rows with the periodic wrap;
  * :func:`fire_test`: the RMS force after the sweep, the step, and the
    loop's predicate into a flag pair and, under capture, the WHILE node's
    and the rebin IF node's handles.

The buffers: ``scal`` (dtype of the state, :data:`SCAL` values: dt, alpha,
f_rms, tol, the mix's two coefficients, the kick's dt), ``ints`` (int64,
:data:`INTS`: the steps since the power turned negative, the step,
max_steps, do_mix, positive, the loop's passes, converged, the overflow
the test saw, the rebins the caller counts), ``red``
(:data:`RED` values: the maxima and the sums, one for the update and one
for the test, which a shard ring all-reduces between the split launches),
``work`` (the reductions' ticket and the blocks' partials, as many values
as the kernels' library asks for, :func:`reduce_grid`; zeros at first) and
``flags`` (two bools: the predicate, and the predicate with the drift
test's flag).

The two reductions launch as programmatic dependents of the kernel before
them (Hopper's programmatic dependent launch): each may read its own
scalars in ``scal`` and ``ints`` before that kernel has ended, so the
kernel just before one of them must not write those (see
``csrc/fire_update.cu``; FIRE's own kernels never do). The move launches
as one too, and reads nothing before that kernel has ended, so any kernel
may come before it.

Beside each kernel, its plain PyTorch version (the port's former torch
composition, on the same buffers): CUDA tensors launch the kernel, CPU
tensors take the plain version, which the CPU tests hold against the JAX
package; a kernel that does not build or launch raises. Counters:
``fire_reduce.launches``, ``fire_move.launches``, ``fire_test.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import typing

import torch

from mdtpu_torch.core.box import wrap_positions
from mdtpu_torch.ops import _cuda_build
from mdtpu_torch.utils import counters

NAME = "fire_update"
SCAL, INTS, RED = 7, 9, 5
DT, ALPHA, FRMS, TOL, MIX_V, MIX_F, DT_KICK = range(SCAL)
(SSN, STEP, MAX_STEPS, DO_MIX, POSITIVE, PASSES, CONVERGED, OVERFLOW,
 REBINS) = range(INTS)
MAX_A, MAX_B, SUM_AB, SUM_AA, SUM_BB = range(RED)
# Mode bits of fire_reduce and fire_test: the maxima, the sums, the tail.
MAXIMA, SUMS, TAIL = 1, 2, 4
ONE_PASS = MAXIMA | SUMS | TAIL

_P, _I, _L, _D, _Q = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_double, ctypes.c_ulonglong)
_SIGNATURES = tuple(
    [(f"mdtpu_fire_reduce_{s}", (_P, _P, _L, _P, _P, _P, _P, _L, _P, _I, _D,
                                 _D, _D, _D, _D, _L, _P)) for s in
     ("f32", "f64")]
    + [(f"mdtpu_fire_move_{s}", (_P, _P, _P, _I, _L, _L, _P, _P, _P, _P, _P,
                                 _D, _P, _P)) for s in ("f32", "f64")]
    + [(f"mdtpu_fire_test_{s}", (_P, _L, _P, _P, _P, _P, _L, _P, _P, _P, _D,
                                 _I, _I, _Q, _Q, _I, _I, _P)) for s in
       ("f32", "f64")]
    + [("mdtpu_fire_grid", (_L, _I, ctypes.POINTER(_L)), _L),
       ("mdtpu_fire_update_census", (_P, ctypes.POINTER(_L)))])
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@dataclasses.dataclass(frozen=True)
class FireHyper:
    """FIRE's fixed parameters (the reference's code defaults)."""

    dt_initial: float = 0.01
    dt_max: float = 0.1
    alpha0: float = 0.1
    f_inc: float = 1.2
    f_dec: float = 0.2
    n_min: int = 5
    dmax: float = 0.1


class Grid(typing.NamedTuple):
    """A reduction's grid as the kernels' library sizes it: the values of
    ``work`` it needs, its blocks, the values of one 16-byte vector, the
    most values one block takes before the grid grows, and the most whose
    threads load all theirs at once (one wave)."""

    work: int
    blocks: int
    vector: int
    block_values: int
    wave_values: int


def reduce_grid(n: int, dtype) -> Grid:
    """The grid of a reduction over ``n`` values of ``dtype`` (float32 or
    float64), read from the kernels' library (built at first use): by the
    count alone, not by the card."""
    lib = _cuda_build.load(NAME, _SIGNATURES)
    out = (ctypes.c_longlong * 4)()
    work = lib.mdtpu_fire_grid(
        n, torch.empty((), dtype=dtype).element_size(), out)
    if work < 0:
        raise ValueError(f"the reductions take float32 or float64, not "
                         f"{dtype}")
    return Grid(work, *out)


def edge_counts(dtype) -> tuple:
    """The counts at the edges of the reductions' grid: 1, 3, one block's
    count and its neighbours, the first count of two blocks, an odd count,
    one wave's count, one more value (a tail value) and one more vector (a
    second batch)."""
    g = reduce_grid(1, dtype)
    one, wave = g.block_values, g.wave_values
    return (1, 3, one - 1, one, one + 1, one + g.vector, 9999, wave,
            wave + 1, wave + g.vector)


def buffers(dtype, device, n_values: int):
    """``(scal, ints, red, work, flags)``: one FIRE run's buffers for
    reductions over ``n_values`` values (``red`` holds the update's and the
    test's, :data:`RED` each). ``work`` is sized by the kernels' library
    on the card and holds one value elsewhere: the plain versions do not
    read it."""
    device = torch.device(device)
    work = reduce_grid(n_values, dtype).work if device.type == "cuda" else 1
    return (torch.zeros(SCAL, dtype=dtype, device=device),
            torch.zeros(INTS, dtype=torch.int64, device=device),
            torch.zeros(2 * RED, dtype=dtype, device=device),
            torch.zeros(work, dtype=dtype, device=device),
            torch.zeros(2, dtype=torch.bool, device=device))


def _launch(fn, dtype, args, what, device):
    lib = _cuda_build.load(NAME, _SIGNATURES)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = getattr(lib, f"{fn}_{_SUFFIX[dtype]}")(*args, stream)
    _cuda_build.check(lib, NAME, rc, what)


def _check(what, values, scal, ints, same=(), flags=(), others=()):
    """The kernels' preconditions: float32 or float64 ``values``, and
    ``scal``, ``ints``, ``same`` (tensors of the values' dtype), ``flags``
    (bool tensors) and ``others`` (None where not given) contiguous on the
    values' device."""
    dtype, device = values.dtype, values.device
    if dtype not in _SUFFIX:
        raise ValueError(f"{what} takes float32 or float64, not {dtype}")
    for t in (values, scal, ints, *same, *flags, *others):
        if t is None:
            continue
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors on one device")
    if any(t is not None and t.dtype != dtype for t in same):
        raise ValueError(f"{what}: every float tensor of dtype {dtype}")
    if any(t is not None and t.dtype != torch.bool for t in flags):
        raise ValueError(f"{what}: the flags are bool tensors")
    if (scal.dtype != dtype or scal.numel() != SCAL
            or ints.dtype != torch.int64 or ints.numel() != INTS):
        raise ValueError(f"{what}: scal ({SCAL} values of the state's dtype) "
                         f"and ints ({INTS} int64) expected")


def _check_reduction(what, red, mode):
    """The reductions' mode and ``red`` (the library refuses a ``work``
    shorter than :func:`reduce_grid`'s)."""
    if mode not in (ONE_PASS, MAXIMA, SUMS, TAIL):
        raise ValueError(f"{what}: mode {mode} is not one pass, MAXIMA, "
                         "SUMS or TAIL")
    if red.numel() < RED:
        raise ValueError(f"{what}: red of {RED} values")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _overflowed(overflow):
    return overflow is not None and bool(overflow)


# ---------------------------------------------------------- fire_reduce


def _one(x):
    return torch.ones_like(x)


def fire_tail_plain(red, scal, ints, hyper: FireHyper):
    """FIRE's scalar tail from the global maxima and sums in ``red``
    (``mdtpu/minimize/fire.py:330-353``), into ``scal`` and ``ints``."""
    vmax, fmax = red[MAX_A], red[MAX_B]
    vmax_s = torch.where(vmax > 0, vmax, _one(vmax))
    fmax_s = torch.where(fmax > 0, fmax, _one(fmax))
    vn, fn = torch.sqrt(red[SUM_AA]), torch.sqrt(red[SUM_BB])
    do_mix = (vmax > 0) & (fmax > 0)
    dt, alpha = scal[DT].clone(), scal[ALPHA].clone()
    scale = alpha * (vmax_s / fmax_s) * (vn / torch.where(fn > 0, fn,
                                                          _one(fn)))
    positive = red[SUM_AB] > 0
    ssn_pos = ints[SSN] + 1
    grow = ssn_pos > hyper.n_min
    dt_pos = torch.where(grow, torch.clamp(dt * hyper.f_inc,
                                           max=hyper.dt_max), dt)
    alpha_pos = torch.where(grow, alpha * 0.99, alpha)
    dt_neg = torch.clamp(dt * hyper.f_dec, min=hyper.dt_initial)
    scal[DT_KICK] = dt
    scal[MIX_V] = 1.0 - alpha
    scal[MIX_F] = scale
    scal[DT] = torch.where(positive, dt_pos, dt_neg)
    scal[ALPHA] = torch.where(positive, alpha_pos,
                              torch.full_like(alpha, hyper.alpha0))
    ints[SSN] = torch.where(positive, ssn_pos, torch.zeros_like(ssn_pos))
    ints[DO_MIX] = do_mix
    ints[POSITIVE] = positive


def fire_reduce_plain(v, forces, scal, ints, red, hyper: FireHyper,
                      overflow=None, mode=ONE_PASS):
    """:func:`fire_reduce` in torch (the JAX package's expressions, the
    port's former ``_fire_update``): by ``mode``'s bits the maxima of
    ``|v + dt F|`` and ``|F|`` into ``red[:2]``, the max-scaled sums by
    ``red``'s maxima into ``red[2:5]``, the tail. Nothing where the 0-d
    bool ``overflow`` is set."""
    if _overflowed(overflow):
        return
    if mode & (MAXIMA | SUMS):
        kicked = v + scal[DT] * forces
    if mode & MAXIMA:
        red[MAX_A] = torch.max(torch.abs(kicked))
        red[MAX_B] = torch.max(torch.abs(forces))
    if mode & SUMS:
        vmax, fmax = red[MAX_A], red[MAX_B]
        vmax_s = torch.where(vmax > 0, vmax, _one(vmax))
        fmax_s = torch.where(fmax > 0, fmax, _one(fmax))
        # Only the sign of P = sum(v . F) matters: computed on
        # max-normalised copies.
        red[SUM_AB] = torch.sum((kicked / vmax_s) * (forces / fmax_s))
        red[SUM_AA] = torch.sum((kicked / vmax_s) ** 2)
        red[SUM_BB] = torch.sum((forces / fmax_s) ** 2)
    if mode & TAIL:
        fire_tail_plain(red, scal, ints, hyper)


def fire_reduce(v, forces, scal, ints, red, work, hyper: FireHyper,
                overflow=None, mode=ONE_PASS):
    """FIRE's reductions and scalar tail on the device buffers (see the
    module docstring; ``red``: the update's :data:`RED` values). ``mode``:
    :data:`ONE_PASS` (the kernel scales each block's sums by its own maxima
    and the last block rescales them), or, on a shard ring, :data:`MAXIMA`,
    :data:`SUMS` (divided by the global maxima) and :data:`TAIL` apart,
    with the ring's all-reduces of ``red`` between.
    CUDA tensors launch the kernel (adds one to ``fire_reduce.launches``),
    CPU tensors take :func:`fire_reduce_plain`."""
    if forces.device.type == "cpu":
        return fire_reduce_plain(v, forces, scal, ints, red, hyper, overflow,
                                 mode)
    _check("fire_reduce", forces, scal, ints, (v, red, work), (overflow,))
    if v.shape != forces.shape:
        raise ValueError("fire_reduce: v and forces of one shape")
    _check_reduction("fire_reduce", red, mode)
    _launch("mdtpu_fire_reduce", forces.dtype,
            (v.data_ptr(), forces.data_ptr(), forces.numel(),
             scal.data_ptr(), ints.data_ptr(), red.data_ptr(),
             work.data_ptr(), work.numel(), _ptr(overflow), mode,
             hyper.f_inc, hyper.f_dec, hyper.dt_max, hyper.dt_initial,
             hyper.alpha0, hyper.n_min), "fire_reduce", forces.device)
    fire_reduce.launches += 1


# ------------------------------------------------------------ fire_move


def _particle_norm(a, dim):
    """Each particle's Euclidean norm over its ``dim`` components, scaled by
    their max |a| first, so that no intermediate squares a raw value (the
    forces of an overlapping start can be ~1e25); the squares added in
    component order, as the kernel adds them (torch's sum over a short
    row adds in another order on the card). Keeps ``dim``."""
    m = torch.amax(torch.abs(a), dim=dim, keepdim=True)
    m_safe = torch.where(m > 0, m, torch.ones_like(m))
    q = (a / m_safe) ** 2
    parts = q.unbind(dim)
    ss = parts[0]
    for part in parts[1:]:
        ss = ss + part
    return torch.sqrt(ss.unsqueeze(dim)) * m


def fire_move_plain(positions, v, forces, scal, ints, dmax, rows,
                    images=None, cell=None, cell_inv=None, overflow=None):
    """:func:`fire_move` in torch: ``v`` and ``positions`` in place (and,
    ``rows`` with ``images``, the wrap: ``images`` in place)."""
    if _overflowed(overflow):
        return
    w = v + scal[DT_KICK] * forces
    w = torch.where(ints[DO_MIX].bool(), scal[MIX_V] * w + scal[MIX_F] *
                    forces, w)
    w = torch.where(ints[POSITIVE].bool(), w, torch.zeros_like(w))
    # LAMMPS-style per-particle displacement cap, so steep potentials (or
    # overlapping float32 starts) cannot explode the step.
    disp = scal[DT] * w
    dnorm = _particle_norm(disp, -1 if rows else 0)
    dnorm = torch.where(torch.isfinite(dnorm), dnorm,
                        torch.full_like(dnorm, float("inf")))
    cap = torch.clamp(dmax / torch.clamp(dnorm, min=1e-30), max=1.0)
    disp = torch.where(torch.isfinite(disp), disp * cap,
                       torch.zeros_like(disp))
    v.copy_(w)
    if images is None:
        positions.add_(disp)
        return
    x, img = wrap_positions(positions + disp, images, cell, cell_inv)
    positions.copy_(x)
    images.copy_(img)


def fire_move(positions, v, forces, scal, ints, dmax, *, rows,
              images=None, cell=None, cell_inv=None, overflow=None):
    """FIRE's move on the device buffers: the mix, the zeroing, the capped
    displacement, ``positions += disp`` and ``v`` the new velocity, in
    place. ``rows``: ``(N, d)`` particle rows (with ``images``, the cell
    and its inverse: the periodic wrap), else component-major ``(d, S)``
    slots (the wrap deferred to the rebin); d is 2 or 3. CUDA tensors
    launch the kernel (adds one to ``fire_move.launches``) as a
    programmatic dependent of the kernel before it on the stream (it
    reads nothing before that kernel has ended); CPU tensors take
    :func:`fire_move_plain`."""
    if forces.device.type == "cpu":
        return fire_move_plain(positions, v, forces, scal, ints, dmax, rows,
                               images, cell, cell_inv, overflow)
    _check("fire_move", forces, scal, ints, (positions, v), (overflow,),
           (images,))
    if (positions.shape != forces.shape or v.shape != forces.shape
            or forces.dim() != 2):
        raise ValueError("fire_move: positions, v and forces of one 2-d "
                         "shape")
    dim = forces.shape[1] if rows else forces.shape[0]
    n = forces.shape[0] if rows else forces.shape[1]
    if dim not in (2, 3):
        raise ValueError(f"fire_move takes d = 2 or 3, not {dim}")
    box = (None, None)
    if images is not None:
        if (not rows or images.shape != forces.shape
                or images.dtype != torch.int64):
            raise ValueError("fire_move wraps particle rows only, int64 "
                             "images of their shape")
        box = tuple(t.to(forces.dtype).contiguous() for t in (cell, cell_inv))
        if any(t.shape != (dim, dim) or t.device != forces.device
               for t in box):
            raise ValueError("fire_move: the cell and its inverse (d, d) on "
                             "the forces' device")
    _launch("mdtpu_fire_move", forces.dtype,
            (positions.data_ptr(), v.data_ptr(), forces.data_ptr(), dim, n,
             0 if rows else n, _ptr(images), _ptr(box[0]), _ptr(box[1]),
             scal.data_ptr(), ints.data_ptr(), float(dmax), _ptr(overflow)),
            "fire_move", forces.device)
    fire_move.launches += 1


# ------------------------------------------------------------ fire_test


def fire_test_plain(forces, scal, ints, red, sqrt_ndof, flags, overflow=None,
                    drift=None, entry=False, mode=ONE_PASS):
    """:func:`fire_test` in torch (``mdtpu/minimize/fire.py:299-302``): by
    ``mode``'s bits max |F| into ``red[MAX_B]``, the max-scaled sum into
    ``red[SUM_BB]``, and the tail: f_rms, the step (not at the ``entry``),
    converged, and the predicate ``step < max_steps & f_rms >= tol &
    ~overflow`` into ``flags[0]``, it and the ``drift`` flag into
    ``flags[1]``."""
    ovf = _overflowed(overflow)
    if not ovf and mode & MAXIMA:
        red[MAX_B] = torch.max(torch.abs(forces))
    if not ovf and mode & SUMS:
        m = red[MAX_B]
        m_safe = torch.where(m > 0, m, torch.ones_like(m))
        red[SUM_BB] = torch.sum((forces / m_safe) ** 2)
    if not mode & TAIL:
        return
    if not entry:
        ints[PASSES] += 1
    if not ovf:
        scal[FRMS] = torch.sqrt(red[SUM_BB]) * red[MAX_B] / sqrt_ndof
        if not entry:
            ints[STEP] += 1
    going = ((ints[STEP] < ints[MAX_STEPS]) & (scal[FRMS] >= scal[TOL])
             & (not ovf))
    ints[CONVERGED] = (scal[FRMS] < scal[TOL]) & (not ovf)
    ints[OVERFLOW].fill_(int(ovf))
    flags[0] = going
    flags[1] = going if drift is None else going & drift


def fire_test(forces, scal, ints, red, work, sqrt_ndof, flags, *,
              overflow=None, drift=None, entry=False, mode=ONE_PASS,
              handle=None, handle_then=None):
    """The loop's test on the device buffers after a sweep (``red``: the
    test's :data:`RED` values; ``sqrt_ndof``: the square root of the
    degrees of freedom): f_rms into ``scal``, the step (not counted at the
    ``entry`` test), and the predicate into ``flags`` (see
    :func:`fire_test_plain`). Under capture the kernel also sets
    ``handle`` (a WHILE node's) to the predicate and ``handle_then`` (an
    IF node's) to ``flags[1]``. CUDA tensors launch the kernel (adds one to
    ``fire_test.launches``), CPU tensors take :func:`fire_test_plain`."""
    if forces.device.type == "cpu":
        if handle is not None or handle_then is not None:
            raise ValueError("a graph's handle takes CUDA tensors")
        return fire_test_plain(forces, scal, ints, red, sqrt_ndof, flags,
                               overflow, drift, entry, mode)
    _check("fire_test", forces, scal, ints, (red, work),
           (flags, overflow, drift))
    if flags.numel() < 2:
        raise ValueError("fire_test: two bool flags")
    _check_reduction("fire_test", red, mode)
    _launch("mdtpu_fire_test", forces.dtype,
            (forces.data_ptr(), forces.numel(), scal.data_ptr(),
             ints.data_ptr(), red.data_ptr(), work.data_ptr(), work.numel(),
             _ptr(overflow), _ptr(drift), flags.data_ptr(),
             float(sqrt_ndof), mode, int(bool(entry)), handle or 0,
             handle_then or 0, int(handle is not None),
             int(handle_then is not None)), "fire_test", forces.device)
    fire_test.launches += 1


# The census of a capture (:func:`capture_census`).
CENSUS = ("programmatic_into_fire_reduce", "programmatic_into_fire_test",
          "fire_edges_error", "programmatic_into_fire_move")


def capture_census(device):
    """The programmatic edges of the graph being captured on ``device``'s
    current stream that enter a ``fire_reduce``, a ``fire_test`` and a
    ``fire_move`` node, and the error code of the edges' read (where not
    0, the counts are -1), by :data:`CENSUS`. Raises where the stream is
    not capturing."""
    lib = _cuda_build.load(NAME, _SIGNATURES)
    out = (ctypes.c_longlong * len(CENSUS))()
    with torch.cuda.device(device):
        _cuda_build.check(lib, NAME, lib.mdtpu_fire_update_census(
            torch.cuda.current_stream(device).cuda_stream, out),
            "fire_update_census")
    return dict(zip(CENSUS, out))


WRAPPERS = (fire_reduce, fire_move, fire_test)


def reset_launches():
    """Set the three wrappers' launch counts to 0."""
    for wrapper in WRAPPERS:
        wrapper.launches = 0


reset_launches()
for _wrapper in WRAPPERS:
    counters.register(_wrapper, "launches")
