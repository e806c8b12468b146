"""Pair-distance histogram for the radial distribution function.

The JAX package computes it in XLA with about a dozen dense ``(N, N)``
arrays (``mdtpu/observables.py:21 rdf_histogram``), 17.2 GB each in float32
at N = 65,536. Here CUDA tensors launch ``csrc/rdf_histogram.cu`` and CPU
tensors take :func:`rdf_histogram_plain`, which walks the rows in chunks so
that no ``(N, N)`` array exists. Both follow the JAX expression order,
operation for operation, so they give the same integer counts.

On the card the host plans each call (:func:`rdf_plan`; it reads the two
cell matrices and the largest |fractional coordinate| in one read):

  * the matrices' zero pattern (general, upper triangular, diagonal), for
    which the kernel drops the products with a zero entry (the same bits);
  * the bin edges in the positions' dtype (:func:`bin_edges`): the kernel
    tests ``r^2 < t`` with no square root and, at float64, reads the bin
    from the edges with no division, and gets the plain version's bins
    exactly;
  * the route: the cell route where r_max is short enough for at least 3
    cells an axis of width ``r_max (1 + margin)`` across
    (:func:`cell_grid_for`, whose margin makes skipping the pairs more than
    one cell apart exact) and the stencil covers at most
    ``CELL_SHARE_MAX`` of the box; else the tile route (every unordered
    pair). For the cell route :func:`rdf_launch` bins the particles in
    torch (wrapped fractional coordinates, :func:`cell_ids`,
    :func:`sort_by_cell`) before the kernel.

Each launch adds one to ``rdf_histogram.launches``, a launch of the cell
route also to ``rdf_histogram.cell_launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from mdtpu_torch.core.box import _mm
from mdtpu_torch.ops import _cuda_build
from mdtpu_torch.ops.cell_grid import cell_ids
from mdtpu_torch.ops.neighbor_list import sort_by_cell

NAME = "rdf_histogram"
MAX_BINS = 12288                 # kMaxBins of the kernel
CHUNK_ELEMENTS = 1 << 24         # pair entries of one plain chunk
GENERAL, UPPER, DIAGONAL = 0, 1, 2   # zero patterns, as the kernel's
TILE, CELL = "tile", "cell"
# The cell route where its stencil (3 cells an axis) covers at most this
# share of the box, the tile route above (measured on the card: PERF.md
# section 6).
CELL_SHARE_MAX = 0.25

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# positions, n, dim, cell, cell_inv (host), pattern, edges, n_bins, r_max,
# route, starts, cell counts, grid (host), counts, stream
_ARGS = (_P, _I, _I, _P, _P, _I, _P, _I, _D, _I, _P, _P, _P, _P, _P)
_SIGNATURES = (("mdtpu_rdf_histogram_f32", _ARGS),
               ("mdtpu_rdf_histogram_f64", _ARGS))
_NUMPY = {torch.float32: np.float32, torch.float64: np.float64}


def _library():
    return _cuda_build.load(NAME, _SIGNATURES)


def build_report() -> str:
    """Build (if needed) the kernel; return the compiler's report."""
    return _cuda_build.build_report(NAME)


def _check(positions, cell, cell_inv, n_bins):
    if positions.dim() != 2 or positions.shape[1] not in (2, 3):
        raise ValueError("positions must be (N, 2) or (N, 3), got "
                         f"{tuple(positions.shape)}")
    dim = positions.shape[1]
    for m in (cell, cell_inv):
        if tuple(m.shape) != (dim, dim):
            raise ValueError(f"cell matrices must be ({dim}, {dim})")
        if m.dtype != positions.dtype or m.device != positions.device:
            raise TypeError("cell matrices must share the positions' dtype "
                            "and device")
    if not 1 <= int(n_bins) <= MAX_BINS:
        raise ValueError(f"n_bins must lie in 1 .. {MAX_BINS}")


def zero_pattern(cell, cell_inv) -> int:
    """The pattern of zero entries both matrices share (numpy, in their
    dtype): ``DIAGONAL`` where every off-diagonal entry is 0, ``UPPER``
    where every entry below the diagonal is, else ``GENERAL``."""
    both = (np.asarray(cell) != 0) | (np.asarray(cell_inv) != 0)
    if not np.any(both & ~np.eye(both.shape[0], dtype=bool)):
        return DIAGONAL
    if not np.any(np.tril(both, -1)):
        return UPPER
    return GENERAL


def bin_index(r2, r_max, n_bins):
    """The plain version's bin of squared distances ``r2`` (a numpy array
    of float32 or float64), in that dtype: ``min(trunc(sqrt(r2) / r_max *
    n_bins), n_bins - 1)`` where ``sqrt(r2) < r_max``, else ``n_bins``.
    numpy's square root, division and product round correctly, as the
    card's do."""
    r2 = np.asarray(r2)
    dt = r2.dtype.type
    rm = np.full(1, r_max, dt)
    nb = np.full(1, n_bins, dt)
    r = np.sqrt(r2)
    inside = r < rm
    x = np.where(inside, r / np.where(inside, rm, dt(1)) * nb, dt(0))
    return np.where(inside, np.minimum(x.astype(np.int64), n_bins - 1),
                    n_bins)


@functools.lru_cache(maxsize=64)
def bin_edges(dtype, r_max, n_bins):
    """``(n_bins + 1,)`` numpy array in ``dtype`` (float32 or float64):
    ``e[0] = 0``, ``e[b]`` the least ``r^2`` whose :func:`bin_index` is at
    least ``b`` (``b = 1 .. n_bins - 1``), and ``e[n_bins] = t``, the least
    ``r^2`` with ``sqrt(r^2) >= r_max`` in the dtype. The bin is a monotone
    step function of ``r^2``, so a pair is inside iff ``r^2 < t`` and its
    bin is the largest ``b`` with ``e[b] <= r^2``. Read-only (cached)."""
    dt = np.dtype(dtype)
    bits = np.uint32 if dt.itemsize == 4 else np.uint64
    target = np.arange(1, n_bins + 1)
    # Non-negative floats order as their bit patterns: bisect over those.
    lo = np.zeros(n_bins, np.int64)                 # bin(0) = 0 < target
    hi = np.full(n_bins, int(np.array(np.inf, dt).view(bits)), np.int64)
    while np.any(hi - lo > 1):
        mid = lo + (hi - lo) // 2
        up = bin_index(mid.astype(bits).view(dt), r_max, n_bins) >= target
        hi = np.where(up, mid, hi)
        lo = np.where(up, lo, mid)
    edges = np.zeros(n_bins + 1, dt)
    edges[1:] = hi.astype(bits).view(dt)
    edges.setflags(write=False)
    return edges


def cell_grid_for(cell, cell_inv, r_max, dtype, frac_max, n_particles):
    """Cells an axis of the cell route (a tuple), or None where fewer than
    3 fit. ``cell`` and ``cell_inv`` are numpy matrices holding the dtype's
    values, ``frac_max`` the largest |fractional coordinate| of the
    positions as the binning computes them.

    Along axis k of a cell of perpendicular width ``W_k`` the cells are
    ``W_k / n_k >= r_max (1 + margin)`` across; a pair whose cells are two
    or more apart along some axis then has a computed distance of at least
    ``r_max``, and skipping it loses no count. With ``u`` the dtype's unit
    roundoff, ``g(m) = m u / (1 - m u)``, ``a_k`` the row sums of
    ``|inv| |cell|`` and ``T = frac_max + 1``:

      * the binning places a particle within ``eta_k = g(d) a_k T + 3u`` of
        its fractional coordinate (the product with inv, the wrap, the
        product with n_k), so the pair's fractional separation along k is
        at least ``1 / n_k - 2 eta_k`` (a whole cell lies between);
      * the kernel's fraction (``d = x_i - x_j`` rounded, then the product
        with inv, for positions up to ``T`` box lengths out) is within
        ``2 g(d + 1) a_k T`` of the exact one, and ``rint`` takes the
        nearest image, so ``|frac_k| >= 1 / n_k - beta_k``;
      * ``|cell frac| >= |frac_k| W_k``, and the product with the cell,
        the squares and their sum, and the square root lose at most a
        factor ``rho = 1 - g(d) kappa - g(2 d) - u`` (kappa the Frobenius
        norms' product of the cell and its inverse).

    Every error term is taken four times over and the quotient shrunk by
    2^-40, so the host's float64 arithmetic cannot tip a cell count. At
    most ``n_particles`` cells (wider cells stay exact); None where inv is
    not an inverse of cell to 2^-10."""
    m = np.asarray(cell, np.float64)
    v = np.asarray(cell_inv, np.float64)
    dim = m.shape[0]
    if np.abs(v @ m - np.eye(dim)).max() > 2.0 ** -10:
        return None
    u = float(np.finfo(dtype).eps) / 2

    def g(k):
        return k * u / (1 - k * u)

    m_inv = np.linalg.inv(m)
    widths = 1.0 / np.linalg.norm(m_inv, axis=1)
    a = (np.abs(v) @ np.abs(m)).sum(axis=1)
    big_t = float(frac_max) + 1.0
    eta = g(dim) * a * big_t + 3 * u
    beta = 4 * (2 * eta + 2 * g(dim + 1) * a * big_t)
    kappa = float(np.linalg.norm(m) * np.linalg.norm(m_inv))
    rho = (1 - 4 * (g(dim) * kappa + g(2 * dim) + u)
           - 16 * 2.0 ** -53 * kappa)
    if rho <= 0:
        return None
    r = float(np.asarray(r_max, dtype))
    grid = np.floor(1.0 / (r / (widths * rho) + beta) * (1 - 2.0 ** -40))
    cells = float(np.prod(grid))
    if cells > max(n_particles, 1):
        grid = np.floor(grid * (max(n_particles, 1) / cells) ** (1 / dim))
    if np.any(grid < 3):
        return None
    return tuple(int(x) for x in grid)


def stencil_share(grid) -> float:
    """The share of the box that a cell's 3^d stencil covers."""
    return math.prod(min(1.0, 3.0 / n) for n in grid)


@dataclass(frozen=True)
class RdfPlan:
    """What :func:`rdf_launch` needs besides the positions."""

    route: str                    # TILE or CELL
    pattern: int                  # GENERAL, UPPER or DIAGONAL
    grid: Optional[Tuple[int, ...]]   # cells an axis (CELL)
    r_max: float
    n_bins: int
    cell: np.ndarray              # host copies in the dtype
    cell_inv: np.ndarray
    edges: torch.Tensor           # bin_edges on the positions' device
    frac: Optional[torch.Tensor]  # (N, d) fractional coordinates (CELL)


def rdf_plan(positions, cell, cell_inv, r_max, n_bins=200, route=None):
    """The plan of one histogram on these inputs (any device): the zero
    pattern, the bin edges and the route, from the two matrices and the
    largest |fractional coordinate| (one read to the host). ``route`` None
    picks by shape; TILE or CELL forces one (CELL raises where fewer than
    3 cells fit)."""
    _check(positions, cell, cell_inv, n_bins)
    dtype = positions.dtype
    if dtype not in _NUMPY:
        raise TypeError(f"the kernel takes float32 or float64, got {dtype}")
    if route not in (None, TILE, CELL):
        raise ValueError(f"unknown route {route!r}")
    ndt = _NUMPY[dtype]
    n_bins = int(n_bins)
    n, dim = positions.shape
    frac = _mm(positions, cell_inv.T)
    # One read: both matrices and the largest |fractional coordinate|.
    host = torch.cat([cell.reshape(-1), cell_inv.reshape(-1),
                      frac.abs().amax().reshape(1) if n
                      else frac.new_zeros(1)]).cpu().numpy()
    m = host[:dim * dim].reshape(dim, dim).copy()
    v = host[dim * dim:2 * dim * dim].reshape(dim, dim).copy()
    grid = None
    if route != TILE:
        grid = cell_grid_for(m, v, r_max, ndt, float(host[-1]), n)
        if grid is not None and route is None and \
                stencil_share(grid) > CELL_SHARE_MAX:
            grid = None
    if route == CELL and grid is None:
        raise ValueError("the cell route needs at least 3 cells an axis of "
                         "r_max and its margin")
    return RdfPlan(route=CELL if grid else TILE, pattern=zero_pattern(m, v),
                   grid=grid, r_max=float(r_max), n_bins=n_bins, cell=m,
                   cell_inv=v,
                   edges=_device_edges(positions.device, ndt, float(r_max),
                                       n_bins),
                   frac=frac if grid else None)


@functools.lru_cache(maxsize=64)
def _device_edges(device, dtype, r_max, n_bins):
    """:func:`bin_edges` on ``device`` (kept: plans are made outside CUDA
    graphs, whose pools would own a tensor made during a capture)."""
    return torch.from_numpy(bin_edges(dtype, r_max, n_bins).copy()).to(
        device)


def bin_by_cell(frac, grid):
    """``(cid, order, starts, counts)``: each particle's cell from its
    wrapped fractional coordinates ``frac`` (N, d), as
    ``NeighborListEngine.bin_sorted`` bins, the particles sorted by cell
    (:func:`sort_by_cell`), where each cell's run begins and how many it
    holds (int64)."""
    w = frac - torch.floor(frac)
    cid = cell_ids([w[:, k] for k in range(w.shape[1])], grid)
    counts = torch.zeros(math.prod(grid), dtype=torch.int64,
                         device=frac.device)
    counts.scatter_add_(0, cid, torch.ones_like(cid))
    order, starts = sort_by_cell(cid, counts)
    return cid, order, starts, counts


def rdf_launch(plan, positions):
    """The kernel on ``plan``'s route: the counts ``(n_bins,)`` int64. Only
    device work (the cell route's binning and the launch), so a CUDA graph
    can hold it."""
    n, dim = positions.shape
    dtype = positions.dtype
    lib = _library()
    fn = (lib.mdtpu_rdf_histogram_f32 if dtype == torch.float32
          else lib.mdtpu_rdf_histogram_f64)
    device = positions.device
    counts = torch.zeros(plan.n_bins, dtype=torch.int64, device=device)
    grid = starts = cell_counts = None
    pos = positions.contiguous()
    if plan.route == CELL:
        _, order, starts, cell_counts = bin_by_cell(plan.frac, plan.grid)
        pos = torch.index_select(pos, 0, order)
        grid = (ctypes.c_int * dim)(*plan.grid)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(pos.data_ptr(), n, dim, plan.cell.ctypes.data,
                plan.cell_inv.ctypes.data, plan.pattern,
                plan.edges.data_ptr(), plan.n_bins, plan.r_max,
                int(plan.route == CELL),
                None if starts is None else starts.data_ptr(),
                None if cell_counts is None else cell_counts.data_ptr(),
                None if grid is None else ctypes.addressof(grid),
                counts.data_ptr(), stream)
    _cuda_build.check(lib, NAME, rc, "rdf_histogram")
    rdf_histogram.launches += 1
    if plan.route == CELL:
        rdf_histogram.cell_launches += 1
    return counts


def rdf_histogram(positions, cell, cell_inv, r_max, n_bins=200):
    """Counts ``(n_bins,)`` int64 of the ordered pairs ``i != j`` whose
    minimum-image distance ``r`` is below ``r_max``, in bin
    ``min(trunc(r / r_max * n_bins), n_bins - 1)``. ``positions`` ``(N,
    d)`` (d = 2 or 3), ``cell`` and ``cell_inv`` ``(d, d)`` of the same
    dtype (float32 or float64) and device. CUDA tensors launch the kernel
    (or raise) on :func:`rdf_plan`'s route; CPU tensors take
    :func:`rdf_histogram_plain`."""
    _check(positions, cell, cell_inv, n_bins)
    if positions.device.type == "cpu":
        return rdf_histogram_plain(positions, cell, cell_inv, r_max, n_bins)
    if positions.device.type != "cuda":
        raise ValueError(f"unsupported device {positions.device}")
    return rdf_launch(rdf_plan(positions, cell, cell_inv, r_max, n_bins),
                      positions)


rdf_histogram.launches = 0
rdf_histogram.cell_launches = 0


def _component_sum(m, row, comps):
    """``sum_k m[row, k] * comps[k]`` in index order."""
    out = m[row, 0] * comps[0]
    for k in range(1, len(comps)):
        out = out + m[row, k] * comps[k]
    return out


def rdf_histogram_plain(positions, cell, cell_inv, r_max, n_bins=200):
    """:func:`rdf_histogram` in plain PyTorch: the rows in chunks of
    ``CHUNK_ELEMENTS`` pair entries, each chunk the JAX package's
    arithmetic on its ``(rows, N)`` block, separate operations in the JAX
    order, and a ``bincount``. The division takes ``r_max`` as a tensor:
    PyTorch's CUDA division by a Python number multiplies by its reciprocal
    instead."""
    _check(positions, cell, cell_inv, n_bins)
    n, dim = positions.shape
    device, dtype = positions.device, positions.dtype
    n_bins = int(n_bins)
    r_max_t = torch.tensor(r_max, dtype=dtype, device=device)
    columns = positions.T
    counts = torch.zeros(n_bins + 1, dtype=torch.int64, device=device)
    rows = max(1, CHUNK_ELEMENTS // max(n, 1))
    for a in range(0, n, rows):
        b = min(n, a + rows)
        d = [positions[a:b, k, None] - columns[k][None, :]
             for k in range(dim)]
        frac = []
        for k in range(dim):
            f = _component_sum(cell_inv, k, d)
            frac.append(f - torch.round(f))
        r2 = None
        for i in range(dim):
            c = _component_sum(cell, i, frac)
            r2 = c * c if r2 is None else r2 + c * c
        r = torch.sqrt(r2)
        valid = r < r_max_t
        own = torch.arange(b - a, device=device)
        valid[own, own + a] = False
        bins = torch.clamp((r / r_max_t * n_bins).to(torch.int64),
                           max=n_bins - 1)
        bins = torch.where(valid, bins, n_bins)
        counts += torch.bincount(bins.reshape(-1), minlength=n_bins + 1)
    return counts[:n_bins]
