"""The slot step's random draws and rebuild test as kernels that read the
step from the device, and the conditional node a captured step rebins
through.

The JAX package draws Bussi's two numbers and the Brownian noise from
``fold_in(key, step)`` inside its device loop. Here the draws come from
Philox-4x32-10 (``csrc/philox.cuh``): a pure function of a counter
``(block, step lo, step hi, stream)`` and the seed's two words, so a
step's numbers depend on ``(seed, step)`` alone and a kernel can take the
step from a device tensor that a replayed CUDA graph advances. CUDA tensors
launch ``csrc/philox_draws.cu``; CPU tensors take the plain versions here,
which do the same integer arithmetic in int64 (the Philox words and the
noise are the kernels' bits; ``bussi_draw``'s floats differ only by the
libm's last bits).

Wrappers and counters: :func:`bussi_draw` (``bussi_draw.launches``; the
step draws inside :func:`mdtpu_torch.integrate.velocity_finish.
velocity_finish` instead, the same library's kernel),
:func:`uniform_noise` (``uniform_noise.launches``), :func:`rebuild_flag`
(``rebuild_flag.launches``) and its form for ``(N, d)`` particle rows with
the minimum image, :func:`rebuild_flag_rows`
(``rebuild_flag_rows.launches``; the engines' ``needs_rebuild``; its grid,
shared with the particle rows' Brownian move, :func:`rows_grid`);
:func:`graph_if` opens an IF node in the graph
being captured (CUDA 12.4+), for torch versions whose ``CUDAGraph`` lacks
``begin_capture_to_if_node``, whose handle the rebuild test sets, and
:func:`graph_while` a WHILE node (a captured segment's loop, whose test
:func:`step_below` sets its handle: ``step_below.launches``; FIRE's
minimization), and a sharded segment's rebuild decision from the ring's
vote, :func:`rebuild_vote` (``rebuild_vote.launches``);
:func:`capture_census` counts the nodes of the graph being captured and
its programmatic edges; :func:`empty` launches a kernel that does nothing
(the launch floor). The noise, the velocity finish and the particle
rows' drift test launch as programmatic dependents
(:func:`launch_options`), Bussi's draw always as one: under capture each
takes a programmatic edge from the kernel node before it.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
import re
import tempfile
import typing

import torch

from mdtpu_torch.core.box import minimum_image
from mdtpu_torch.ops import _cuda_build
from mdtpu_torch.potentials.base import rounded
from mdtpu_torch.utils import counters

NAME = "philox_draws"
MASK = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57        # round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85        # Weyl key increments
GAMMA_ATTEMPTS = 32                    # kGammaAttempts of the kernel
BUSSI_STREAM = 0
BROWNIAN_STREAM = 1                    # | rank << 8
TWO_PI = 2.0 * math.pi
SQRT3 = math.sqrt(3.0)

_P, _I, _U, _L, _D, _Q = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_longlong, ctypes.c_double,
                          ctypes.c_ulonglong)
_SIGNATURES = (
    ("mdtpu_bussi_draw_f32", (_P, _U, _U, _D, _P, _P)),
    ("mdtpu_bussi_draw_f64", (_P, _U, _U, _D, _P, _P)),
    ("mdtpu_uniform_noise_f32", (_P, _L, _U, _U, _U, _L, _P, _I, _P)),
    ("mdtpu_uniform_noise_f64", (_P, _L, _U, _U, _U, _L, _P, _I, _P)),
    ("mdtpu_rebuild_flag_f32", (_P, _P, _I, _L, _D, _P, _Q, _I, _P)),
    ("mdtpu_rebuild_flag_f64", (_P, _P, _I, _L, _D, _P, _Q, _I, _P)),
    ("mdtpu_rebuild_rows_f32", (_P, _P, _P, _P, _L, _I, _L, _D, _P, _Q, _I,
                                _I, _P)),
    ("mdtpu_rebuild_rows_f64", (_P, _P, _P, _P, _L, _I, _L, _D, _P, _Q, _I,
                                _I, _P)),
    ("mdtpu_rows_grid", (_L, _I, _I, ctypes.POINTER(_L)), _L),
    ("mdtpu_velocity_finish_f32", (_P, _L, _P, _P, _L, _P, _P, _D, _D, _D,
                                   _U, _U, _I, _I, _P, _P)),
    ("mdtpu_velocity_finish_f64", (_P, _L, _P, _P, _L, _P, _P, _D, _D, _D,
                                   _U, _U, _I, _I, _P, _P)),
    ("mdtpu_philox_words", (_P, _P, _P, _L, _P)),
    ("mdtpu_empty", (_I, _P)),
    ("mdtpu_graph_if_handle", (_P, _P)),
    ("mdtpu_graph_if_begin", (_P, _Q, _P)),
    ("mdtpu_graph_if_end", (_P,)),
    ("mdtpu_graph_while_begin", (_P, _Q, _P)),
    ("mdtpu_graph_while_end", (_P,)),
    ("mdtpu_step_below", (_P, _P, _P, _Q, _I, _P)),
    ("mdtpu_rebuild_vote", (_P, _P, _P, _P, _Q, _I, _P)),
    ("mdtpu_capture_census", (_P, ctypes.c_char_p, _P)),
)
CENSUS = ("nodes", "kernels", "copies", "memsets", "conditionals", "others",
          "if_dependencies", "if_root_kernels", "unreadable", "dot_error",
          "programmatic_edges", "programmatic_into_velocity_finish",
          "programmatic_into_uniform_noise", "edges_error",
          "programmatic_into_rebuild_rows")
# Kernels the census names, by the text of their names in the graph's dump.
NAMED_KERNELS = {"rebuild_flag": "rebuild_flag_kernel",
                 "velocity_finish": "velocity_finish_kernel",
                 "verlet_update": "verlet_update_kernel",
                 "brownian_update": "brownian_update_kernel",
                 "uniform_noise": "uniform_noise_kernel",
                 "bussi_draw": "bussi_draw_kernel",
                 "rebuild_rows": "rebuild_rows_kernel",
                 "kick_drift_wrap": "kick_drift_wrap_kernel",
                 "brownian_rows": "brownian_rows_kernel",
                 "rebuild_vote": "rebuild_vote_kernel"}
_OPT_PROGRAMMATIC = 1
_plain_order = False      # True only inside plain_launch()
_DOT_NODE = re.compile(r'^\s*"?graph_\d+_node_\d+"?\s*\[', re.M)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _library():
    return _cuda_build.load(NAME, _SIGNATURES)


def launch(fn_name, dtype, args, what, device):
    """Call ``fn_name`` (``_f32``/``_f64`` by ``dtype`` where given) of the
    library with ``args`` and the current stream of ``device``; raises on
    an error code."""
    lib = _library()
    fn = getattr(lib, f"{fn_name}_{_SUFFIX[dtype]}" if dtype else fn_name)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*args, stream)
    _cuda_build.check(lib, NAME, rc, what)


def launch_options() -> int:
    """The options word of a launch of the velocity finish, the noise, the
    Brownian updates and the particle rows' drift test: as a programmatic
    dependent of the kernel before it on the stream (Hopper's programmatic
    dependent launch; a runtime that refuses the attribute raises, nothing
    is retried without it), or in plain stream order inside
    :func:`plain_launch`.

    The rule a caller keeps: such a kernel may read some inputs before it
    waits for the kernel before it, so that kernel must not write them.
    The noise and the finish given the kinetic energy read their step
    tensor (the finish that sums reads it after the wait); the drift test
    of particle rows its reference positions; the Brownian updates the
    step, the positions, their compensation and the images (the slot
    update the occupancy, the rows' move the cell). Every other input is
    read, and every output written, after the wait."""
    return 0 if _plain_order else _OPT_PROGRAMMATIC


@contextlib.contextmanager
def plain_launch():
    """For measurements: the kernels that take :func:`launch_options`
    launched, or captured, inside this context go in plain stream
    order."""
    global _plain_order
    saved, _plain_order = _plain_order, True
    try:
        yield
    finally:
        _plain_order = saved


def seed_key(seed: int):
    """The Philox key: the seed's low and high 32-bit words."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return s & MASK, s >> 32


def step_tensor(step, device):
    """``step`` as a 0-d int64 tensor on ``device``: a tensor is taken as
    it is; a host int is filled in on the device (a fill, no copy from the
    host)."""
    if isinstance(step, torch.Tensor):
        if step.dtype != torch.int64 or step.dim() != 0:
            raise ValueError("the step must be a 0-d int64 tensor")
        return step
    return torch.full((), int(step), dtype=torch.int64, device=device)


def _check_dtype(dtype):
    if dtype not in _SUFFIX:
        raise TypeError(f"the draws take float32 or float64, got {dtype}")


# --------------------------------------------------------- Philox-4x32-10


def _mulhilo(m: int, c):
    """``(hi, lo)`` words of the 64-bit product ``m c`` (``m`` < 2^32 an
    int, ``c`` int64 words), in int64 through 16-bit halves of ``c``."""
    a = m * (c & 0xFFFF)          # < 2^48
    b = m * (c >> 16)             # < 2^48
    return (b + (a >> 16)) >> 16, (a + ((b & 0xFFFF) << 16)) & MASK


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox-4x32-10 on int64 tensors (or ints) holding 32-bit words,
    broadcast together; the key ``(k0, k1)`` two ints or int64 tensors.
    Returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = (c if isinstance(c, torch.Tensor)
                      else torch.tensor(c, dtype=torch.int64)
                      for c in (c0, c1, c2, c3))
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_words(counters_, keys):
    """Philox-4x32-10 of ``counters_`` ``(n, 4)`` under ``keys`` ``(n, 2)``
    (int64 tensors of 32-bit words): ``(n, 4)`` int64 words. CUDA tensors
    launch the kernel's generator (``mdtpu_philox_words``, for the
    known-answer checks); CPU tensors take :func:`philox4x32_10`."""
    if counters_.device.type == "cpu":
        return torch.stack(philox4x32_10(*counters_.unbind(1),
                                         *keys.unbind(1)), 1)
    c32 = (counters_ & MASK).to(torch.int32).contiguous()
    k32 = (keys & MASK).to(torch.int32).contiguous()
    out = torch.empty_like(c32)
    launch("mdtpu_philox_words", None,
            (c32.data_ptr(), k32.data_ptr(), out.data_ptr(), out.shape[0]),
            "philox_words", counters_.device)
    return out.to(torch.int64) & MASK


def _step_words(step):
    return step & MASK, (step >> 32) & MASK


def _u53(a, b):
    """Doubles in [0, 1) from 53 bits of two words, exactly."""
    return (((a >> 5) << 26) + (b >> 6)).to(torch.float64) * 2.0 ** -53


def _box_muller(w0, w1, w2, w3):
    u1 = 1.0 - _u53(w0, w1)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * _u53(w2, w3))


# ------------------------------------------------------------------ Bussi


def bussi_draw_plain(seed: int, step, dof: float):
    """Bussi's ``(r1, r2)`` as float64 tensors of ``step``'s shape (any
    shape of int64 steps): r1 ~ N(0, 1), r2 = 2 Gamma(dof / 2), chi-squared
    with ``dof`` = nf - 1 degrees of freedom (0 where ``dof`` <= 0). The
    kernel's algorithm (``csrc/philox_draws.cu``), its attempts evaluated
    all at once and the first accepted one taken."""
    k0, k1 = seed_key(seed)
    lo, hi = _step_words(step)
    blocks = torch.arange(1 + 2 * GAMMA_ATTEMPTS, dtype=torch.int64,
                          device=step.device).reshape(-1, *[1] * step.dim())
    w = philox4x32_10(blocks, lo, hi, BUSSI_STREAM, k0, k1)
    r1 = _box_muller(*(x[0] for x in w))
    dof = float(dof)
    if not dof > 0.0:
        return r1, torch.zeros_like(r1)
    a = 0.5 * dof
    boost = a < 1.0
    d = (a + 1.0 if boost else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    x = _box_muller(*(y[1::2] for y in w))
    u = 1.0 - _u53(w[0][2::2], w[1][2::2])
    ub = 1.0 - _u53(w[2][2::2], w[3][2::2])
    cx = 1.0 + c * x
    v = cx * cx * cx
    ok = (v > 0.0) & (torch.log(u) < 0.5 * x * x + d - d * v
                      + d * torch.log(v))
    first = torch.argmax(ok.to(torch.int8), dim=0, keepdim=True)
    accepted = torch.any(ok, dim=0)
    g = torch.where(accepted, torch.gather(d * v, 0, first)[0], d)
    if boost:
        ub = torch.where(accepted, torch.gather(ub, 0, first)[0], 1.0)
        g = g * torch.pow(ub, 1.0 / a)
    return r1, 2.0 * g


def bussi_draw(seed: int, step, dof: float, dtype):
    """Bussi's ``(r1, r2)`` of one step as a ``(2,)`` tensor of ``dtype``
    on the step's device (``step`` a 0-d int64 tensor). A CUDA step
    launches the kernel (two warps, the velocity finish's draws; adds one
    to ``bussi_draw.launches``) as a programmatic dependent of the kernel
    before it (it reads the step after that kernel has ended, so any
    kernel may come before it); a CPU step takes
    :func:`bussi_draw_plain`."""
    _check_dtype(dtype)
    step = step_tensor(step, None)
    if step.device.type == "cpu":
        return torch.stack(bussi_draw_plain(seed, step, dof)).to(dtype)
    if step.device.type != "cuda":
        raise ValueError(f"unsupported device {step.device}")
    out = torch.empty(2, dtype=dtype, device=step.device)
    k0, k1 = seed_key(seed)
    launch("mdtpu_bussi_draw", dtype,
            (step.data_ptr(), k0, k1, float(dof), out.data_ptr()),
            "bussi_draw", step.device)
    bussi_draw.launches += 1
    return out


# ---------------------------------------------------------------- Brownian


def noise_stream(rank=None) -> int:
    """The counter's stream word of the Brownian noise: 1, with a shard's
    rank in the bits above 8."""
    return BROWNIAN_STREAM | (int(rank or 0) << 8)


def uniform_noise_plain(seed: int, step, shape, dtype, rank=None):
    """The variance-matched uniforms ``(2u - 1) sqrt(3)`` of ``shape``,
    bit for bit the kernel's: element ``e`` of the flattened array from
    Philox block ``e // 4`` (float32, the word's top 24 bits) or ``e // 2``
    (float64, 53 bits of two words)."""
    _check_dtype(dtype)
    n = math.prod(shape)
    per = 4 if dtype == torch.float32 else 2
    k0, k1 = seed_key(seed)
    lo, hi = _step_words(step)
    blocks = torch.arange(-(-n // per), dtype=torch.int64, device=step.device)
    w = philox4x32_10(blocks, lo, hi, noise_stream(rank), k0, k1)
    if per == 4:
        u = (torch.stack(w, 1).reshape(-1)[:n] >> 8).to(dtype) * 2.0 ** -24
    else:
        u = torch.stack([_u53(w[0], w[1]), _u53(w[2], w[3])],
                        1).reshape(-1)[:n]
    return ((2.0 * u - 1.0) * SQRT3).reshape(tuple(shape))


def uniform_noise(seed: int, step, shape, dtype, rank=None, device=None):
    """The Brownian noise of one step: :func:`uniform_noise_plain`'s values
    on the step's device (``step`` a 0-d int64 tensor, or a host int and
    ``device``). CUDA launches the kernel (adds one to
    ``uniform_noise.launches``), as a programmatic dependent of the kernel
    before it, which must not write the step tensor (the rule of
    :func:`launch_options`); a host int step goes to the kernel as a
    number. The CPU takes the plain version."""
    _check_dtype(dtype)
    if not isinstance(step, torch.Tensor) and device is not None:
        device = torch.device(device)
        if device.type == "cuda":
            return _noise_launch(seed, None, int(step), shape, dtype, rank,
                                 device)
    step = step_tensor(step, device)
    if step.device.type == "cpu":
        return uniform_noise_plain(seed, step, shape, dtype, rank)
    if step.device.type != "cuda":
        raise ValueError(f"unsupported device {step.device}")
    return _noise_launch(seed, step, 0, shape, dtype, rank, step.device)


def _noise_launch(seed, step, step_value, shape, dtype, rank, device):
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    k0, k1 = seed_key(seed)
    launch("mdtpu_uniform_noise", dtype,
           (None if step is None else step.data_ptr(), step_value, k0, k1,
            noise_stream(rank), out.numel(), out.data_ptr(),
            launch_options()), "uniform_noise", device)
    uniform_noise.launches += 1
    return out


# ---------------------------------------------------------- rebuild test


def rebuild_flag_plain(positions, ref_positions, skin):
    """True (a 0-d bool tensor) where a slot drifted past skin/2 from its
    reference: ``sum_k (x_k - ref_k)^2 > (skin/2)^2`` in component order,
    the threshold rounded to the positions' dtype."""
    d = positions - ref_positions
    d = d * d
    d2 = d[0]
    for dk in d[1:]:
        d2 = d2 + dk
    half_skin = 0.5 * skin
    return torch.any(d2 > half_skin * half_skin)


def rebuild_flag(positions, ref_positions, skin, out=None, handle=None):
    """:func:`rebuild_flag_plain` of ``(d, S)`` positions, written into
    ``out`` (a 0-d bool tensor) where given. CUDA tensors launch the kernel
    (one launch, no memset; adds one to ``rebuild_flag.launches``), which
    also sets ``handle``, an IF node's handle from :func:`graph_if`, inside
    the graph being captured; CPU tensors take the plain version."""
    if positions.shape != ref_positions.shape or positions.dim() != 2:
        raise ValueError("positions and ref_positions must be one (d, S) "
                         "shape")
    if positions.device.type == "cpu":
        if handle is not None:
            raise ValueError("a graph's handle takes CUDA tensors")
        flag = rebuild_flag_plain(positions, ref_positions, skin)
        return flag if out is None else out.copy_(flag)
    _check_dtype(positions.dtype)
    if (positions.device.type != "cuda" or ref_positions.dtype
            != positions.dtype or not positions.is_contiguous()
            or not ref_positions.is_contiguous()):
        raise ValueError("rebuild_flag takes contiguous CUDA tensors of one "
                         "dtype")
    if out is None:
        out = torch.empty((), dtype=torch.bool, device=positions.device)
    half_skin = 0.5 * skin
    launch("mdtpu_rebuild_flag", positions.dtype,
           (positions.data_ptr(), ref_positions.data_ptr(),
            positions.shape[0], positions.shape[1], half_skin * half_skin,
            out.data_ptr(), handle or 0, int(handle is not None)),
           "rebuild_flag", positions.device)
    rebuild_flag.launches += 1
    return out


def rebuild_flag_rows_plain(positions, ref_positions, skin, cell=None,
                            cell_inv=None, lengths=None):
    """True (a 0-d bool tensor) where a particle of the ``(N, d)`` rows
    drifted past skin/2 from its reference, the displacement
    minimum-imaged by the cell matrix (``cell`` and ``cell_inv``:
    :func:`~mdtpu_torch.core.box.minimum_image`, the cell grid's test) or
    by the box ``lengths`` (``d - L round(d / L)``, the neighbour list's);
    ``sum_k d_k^2`` in component order (what ``torch.sum`` over the last
    axis gives on the CPU), the threshold rounded to the positions'
    dtype."""
    disp = positions - ref_positions
    if lengths is None:
        disp = minimum_image(disp, cell, cell_inv)
    else:
        disp = disp - lengths * torch.round(disp / lengths)
    sq = disp * disp
    d2 = sq[:, 0]
    for k in range(1, sq.shape[1]):
        d2 = d2 + sq[:, k]
    half_skin = 0.5 * skin
    return torch.any(d2 > rounded(half_skin * half_skin, d2.dtype))


class RowsGrid(typing.NamedTuple):
    """The particle-order kernels' grid over ``n`` particle rows
    (``csrc/particle_rows.cuh``, read from the library): its blocks, a
    block's threads (a particle each, a tile a block), the most blocks (a
    thread takes a particle of each later tile beyond them), and the
    fewest particles whose values fill whole Philox blocks."""

    blocks: int
    threads: int
    max_blocks: int
    period: int


def rows_grid(n: int, d: int, dtype) -> RowsGrid:
    """The grid of the drift test and the Brownian move over ``n`` rows of
    ``d`` values of ``dtype`` (float32 or float64), read from the kernels'
    library (built at first use): by the count alone, not by the card."""
    lib = _library()
    out = (ctypes.c_longlong * 4)()
    if lib.mdtpu_rows_grid(n, d, torch.empty((), dtype=dtype).element_size(),
                           out) < 0:
        raise ValueError(f"the particle rows take float32 or float64 and d "
                         f"2 or 3, not {dtype} and {d}")
    return RowsGrid(*out)


def rows_edge_counts(d: int, dtype) -> tuple:
    """The counts at the edges of the particle rows' grid: 1, 3, the
    particles of one Philox period and its neighbours, an odd count, one
    block's particles and its neighbours, one wave's and one more, and a
    thread's second tile."""
    g = rows_grid(1, d, dtype)
    block = g.threads
    wave = block * g.max_blocks
    return tuple(sorted({1, 3, g.period - 1, g.period, g.period + 1, 4097,
                         block - 1, block, block + 1, wave, wave + 1,
                         wave + block + 5} - {0}))


def rebuild_flag_rows(positions, ref_positions, skin, *, cell=None,
                      cell_inv=None, lengths=None, out=None, handle=None):
    """:func:`rebuild_flag_rows_plain` of ``(N, d)`` particle rows (give
    ``cell`` and ``cell_inv``, or ``lengths``, a ``(d,)`` view of any
    stride such as the cell's diagonal), written into ``out`` (a 0-d bool
    tensor) where given. CUDA tensors launch the kernel (one launch, no
    memset, no copy of the box; adds one to ``rebuild_flag_rows.launches``)
    as a programmatic dependent of the kernel before it, which must not
    write ``ref_positions`` (:func:`launch_options`); it also sets
    ``handle``, an IF node's handle from :func:`graph_if`, inside the graph
    being captured. CPU tensors take the plain version."""
    if (positions.shape != ref_positions.shape or positions.dim() != 2
            or positions.shape[1] not in (2, 3)):
        raise ValueError("positions and ref_positions must be one (N, d) "
                         "shape, d 2 or 3")
    if (lengths is None) == (cell is None or cell_inv is None):
        raise ValueError("give the cell and its inverse, or the lengths")
    if positions.device.type == "cpu":
        if handle is not None:
            raise ValueError("a graph's handle takes CUDA tensors")
        flag = rebuild_flag_rows_plain(positions, ref_positions, skin, cell,
                                       cell_inv, lengths)
        return flag if out is None else out.copy_(flag)
    _check_dtype(positions.dtype)
    d = positions.shape[1]
    boxes = (cell, cell_inv) if lengths is None else (lengths,)
    shapes = ((d, d), (d, d)) if lengths is None else ((d,),)
    if (ref_positions.dtype != positions.dtype
            or ref_positions.device != positions.device
            or not positions.is_contiguous()
            or not ref_positions.is_contiguous()
            or any(t.shape != shape or t.dtype != positions.dtype
                   or t.device != positions.device
                   for t, shape in zip(boxes, shapes))):
        raise ValueError("rebuild_flag_rows takes contiguous rows of one "
                         "dtype and device, the box (d, d) or (d,)")
    if positions.device.type != "cuda":
        raise ValueError(f"rebuild_flag_rows takes CPU or CUDA tensors, not "
                         f"{positions.device}")
    if lengths is None:
        m, mi, stride = cell.contiguous(), cell_inv.contiguous(), 1
    else:
        mi = lengths if lengths.stride(0) >= 1 else lengths.contiguous()
        m, stride = None, mi.stride(0)
    if out is None:
        out = torch.empty((), dtype=torch.bool, device=positions.device)
    half_skin = 0.5 * skin
    launch("mdtpu_rebuild_rows", positions.dtype,
           (positions.data_ptr(), ref_positions.data_ptr(),
            None if m is None else m.data_ptr(), mi.data_ptr(), stride, d,
            positions.shape[0], half_skin * half_skin, out.data_ptr(),
            handle or 0, int(handle is not None), launch_options()),
           "rebuild_flag_rows", positions.device)
    rebuild_flag_rows.launches += 1
    return out


def step_below_plain(counter, end):
    """Whether the step ``counter`` is below ``end`` (0-d int64 tensors), a
    0-d bool tensor."""
    return counter < end


def step_below(counter, end, out, handle=None):
    """:func:`step_below_plain` into ``out`` (a 0-d bool tensor): a captured
    segment's loop test. CUDA tensors launch the kernel (one thread; adds
    one to ``step_below.launches``), which also sets ``handle``, a WHILE
    node's handle from :func:`graph_while`, inside the graph being
    captured; CPU tensors take the plain version."""
    if counter.device.type == "cpu":
        if handle is not None:
            raise ValueError("a graph's handle takes CUDA tensors")
        return out.copy_(step_below_plain(counter, end))
    if (counter.dtype != torch.int64 or end.dtype != torch.int64
            or out.dtype != torch.bool or end.device != counter.device
            or out.device != counter.device):
        raise ValueError("step_below takes int64 counters and a bool flag on "
                         "one device")
    launch("mdtpu_step_below", None,
           (counter.data_ptr(), end.data_ptr(), out.data_ptr(), handle or 0,
            int(handle is not None)), "step_below", counter.device)
    step_below.launches += 1
    return out


def rebuild_vote_plain(votes, counter, first):
    """Whether a sharded segment rebuilds before this step: any rank's
    drift flag (``votes``, the ring's maximum of the ranks' flags as a 0-d
    int32 tensor) or the step ``counter`` at the segment's ``first`` step
    (0-d int64 tensors); a 0-d bool tensor."""
    return (votes != 0) | (counter == first)


def rebuild_vote(votes, counter, first, out, handle=None):
    """:func:`rebuild_vote_plain` into ``out`` (a 0-d bool tensor): the
    rebuild decision of a sharded segment's step, which every rank of the
    ring takes alike (the JAX package's outer loop rebins at a segment's
    start and where the psum'd drift test ended the inner loop). CUDA
    tensors launch the kernel (one thread; adds one to
    ``rebuild_vote.launches``), which also sets ``handle``, an IF node's
    handle from :func:`graph_if`, inside the graph being captured; CPU
    tensors take the plain version."""
    if counter.device.type == "cpu":
        if handle is not None:
            raise ValueError("a graph's handle takes CUDA tensors")
        return out.copy_(rebuild_vote_plain(votes, counter, first))
    if (votes.dtype != torch.int32 or counter.dtype != torch.int64
            or first.dtype != torch.int64 or out.dtype != torch.bool
            or any(t.device != counter.device for t in (votes, first, out))):
        raise ValueError("rebuild_vote takes an int32 vote, int64 counters "
                         "and a bool flag on one device")
    launch("mdtpu_rebuild_vote", None,
           (votes.data_ptr(), counter.data_ptr(), first.data_ptr(),
            out.data_ptr(), handle or 0, int(handle is not None)),
           "rebuild_vote", counter.device)
    rebuild_vote.launches += 1
    return out


def empty(device="cuda", programmatic=False):
    """Launch a kernel that does nothing on ``device``'s current stream:
    its time in a graph of many launches is the card's launch floor.
    ``programmatic``: launched as a programmatic dependent of the kernel
    before it, which it waits for (and does nothing else)."""
    launch("mdtpu_empty", None, (_OPT_PROGRAMMATIC if programmatic else 0,),
           "empty", torch.device(device))


WRAPPERS = (bussi_draw, uniform_noise, rebuild_flag, rebuild_flag_rows,
            step_below, rebuild_vote)


def reset_launches():
    """Set the wrappers' launch counts to 0."""
    for wrapper in WRAPPERS:
        wrapper.launches = 0


reset_launches()
for _wrapper in WRAPPERS:
    counters.register(_wrapper, "launches")


# ------------------------------------------------- the conditional node

_BODY_STREAMS = {}    # (device, depth): the stream a body is captured on
_depth = 0            # conditional bodies being captured, one inside another


@contextlib.contextmanager
def _conditional(kind, test, device, pools):
    """The node ``kind`` ("if" or "while") after ``test(handle)``; yields the
    handle while its body is captured, its allocations from a new
    ``torch.cuda.MemPool`` appended to ``pools`` (a body nested in another
    needs a pool of its own: torch refuses to record to one pool twice)."""
    global _depth
    lib = _library()
    parent = torch.cuda.current_stream(device)
    body = _BODY_STREAMS.get((device, _depth))
    if body is None:
        body = _BODY_STREAMS[(device, _depth)] = torch.cuda.Stream(device)
    handle = ctypes.c_ulonglong()
    what = f"graph_{kind}"
    with torch.cuda.device(device):
        _cuda_build.check(lib, NAME, lib.mdtpu_graph_if_handle(
            parent.cuda_stream, ctypes.byref(handle)), what)
    test(handle.value)
    with torch.cuda.device(device):
        _cuda_build.check(lib, NAME, getattr(lib, f"mdtpu_graph_{kind}_begin")(
            parent.cuda_stream, handle.value, body.cuda_stream), what)
    pool = torch.cuda.MemPool()
    pools.append(pool)
    _depth += 1
    try:
        with torch.cuda.stream(body), torch.cuda.use_mem_pool(pool, device):
            yield handle.value
    finally:
        _depth -= 1
        with torch.cuda.device(device):
            _cuda_build.check(lib, NAME, getattr(
                lib, f"mdtpu_graph_{kind}_end")(body.cuda_stream), what)


def graph_if(test, device, pools):
    """Inside a CUDA-graph capture on ``device``'s current stream: what the
    body of this context enqueues runs at each replay only where the test
    set the IF node's handle at that point of the replay (the decision is
    made on the device). ``test(handle)`` launches the kernel that sets
    ``handle``, captured just before the node (:func:`rebuild_flag`). The
    body is captured on a stream of its own, and its allocations come from
    a ``torch.cuda.MemPool`` of its own, appended to the list ``pools``
    (the graph's pool routes only the capturing stream's allocations; the
    caller keeps ``pools`` as long as the graph). Inside the body of
    :func:`graph_while` the IF node is nested in the WHILE node. Raises
    where the stream is not capturing or the runtime refuses the node."""
    return _conditional("if", test, device, pools)


def graph_while(test, device, pools):
    """Inside a CUDA-graph capture on ``device``'s current stream: what the
    body of this context enqueues runs again and again at each replay while
    the WHILE node's handle is set (CUDA 12.4+ for an IF node nested in
    the body). ``test(handle)`` launches the kernel that sets ``handle``
    for the first entry, captured just before the node; the context yields
    the handle, and the body's last kernel must set it again on every pass
    (:func:`step_below`). The body's stream and allocations as
    :func:`graph_if`'s. Raises where the stream is not capturing or the
    runtime refuses the node."""
    return _conditional("while", test, device, pools)


def capture_census(device):
    """The nodes of the graph being captured on ``device``'s current stream
    so far, by :data:`CENSUS`: all top-level nodes, kernels, copies,
    memsets, conditional nodes, others; the conditional nodes'
    dependencies and how many of those are kernels that depend on nothing
    (the drift test at a step's start); nodes whose type could not be read;
    the dump's error code; the programmatic edges (a kernel launched as a
    programmatic dependent of the kernel before it) and how many of them
    enter a velocity finish and a noise node; the error code of the edges'
    read (where not 0, every edge count is -1). Then, from the graph's
    Graphviz dump (its conditional bodies included), the kernel nodes of
    each of :data:`NAMED_KERNELS` and ``dot_nodes``, every node of the
    dump. Raises only where the stream is not capturing."""
    lib = _library()
    out = (ctypes.c_longlong * len(CENSUS))()
    fd, path = tempfile.mkstemp(suffix=".dot")
    os.close(fd)
    try:
        with torch.cuda.device(device):
            _cuda_build.check(lib, NAME, lib.mdtpu_capture_census(
                torch.cuda.current_stream(device).cuda_stream,
                path.encode(), out), "capture_census")
        with open(path) as f:
            dot = f.read()
    finally:
        os.unlink(path)
    census = dict(zip(CENSUS, out))
    starts = [m.start() for m in _DOT_NODE.finditer(dot)] + [len(dot)]
    nodes = [dot[a:b] for a, b in zip(starts, starts[1:])]
    census["dot_nodes"] = len(nodes)
    for name, text in NAMED_KERNELS.items():
        census[name] = sum(text in node for node in nodes)
    return census
