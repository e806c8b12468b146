"""Pair-distance histogram for the radial distribution function.

The JAX package computes it in XLA with about a dozen dense ``(N, N)``
arrays (``mdtpu/observables.py:21 rdf_histogram``), 17.2 GB each in float32
at N = 65,536. Here CUDA tensors launch ``csrc/rdf_histogram.cu`` (every
unordered pair once, a shared-memory histogram per block, integer atomics:
the counts repeat exactly) and CPU tensors take
:func:`rdf_histogram_plain`, which walks the rows in chunks so that no
``(N, N)`` array exists. Both follow the JAX expression order, operation for
operation, so they give the same integer counts. Each launch of the kernel
adds one to ``rdf_histogram.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from mdtpu_torch.ops import _cuda_build

NAME = "rdf_histogram"
MAX_BINS = 12288                 # kMaxBins of the kernel: 48 KB of counts
CHUNK_ELEMENTS = 1 << 24         # pair entries of one plain chunk

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# positions, n, dim, cell, cell_inv, r_max, n_bins, counts, stream
_ARGS = (_P, _I, _I, _P, _P, _D, _I, _P, _P)
_SIGNATURES = (("mdtpu_rdf_histogram_f32", _ARGS),
               ("mdtpu_rdf_histogram_f64", _ARGS))


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


def rdf_histogram(positions, cell, cell_inv, r_max, n_bins=200):
    """Counts ``(n_bins,)`` int64 of the ordered pairs ``i != j`` whose
    minimum-image distance ``r`` is below ``r_max``, in bin
    ``min(trunc(r / r_max * n_bins), n_bins - 1)``. ``positions`` ``(N,
    d)`` (d = 2 or 3), ``cell`` and ``cell_inv`` ``(d, d)`` of the same
    dtype (float32 or float64) and device. CUDA tensors launch the kernel
    (or raise); CPU tensors take :func:`rdf_histogram_plain`."""
    _check(positions, cell, cell_inv, n_bins)
    if positions.device.type == "cpu":
        return rdf_histogram_plain(positions, cell, cell_inv, r_max, n_bins)
    if positions.device.type != "cuda":
        raise ValueError(f"unsupported device {positions.device}")
    dtype = positions.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the kernel takes float32 or float64, got {dtype}")
    positions = positions.contiguous()
    cell, cell_inv = cell.contiguous(), cell_inv.contiguous()
    n, dim = positions.shape
    lib = _library()
    fn = (lib.mdtpu_rdf_histogram_f32 if dtype == torch.float32
          else lib.mdtpu_rdf_histogram_f64)
    device = positions.device
    counts = torch.zeros(int(n_bins), dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(positions.data_ptr(), n, dim, cell.data_ptr(),
                cell_inv.data_ptr(), float(r_max), int(n_bins),
                counts.data_ptr(), stream)
    _cuda_build.check(lib, NAME, rc, "rdf_histogram")
    rdf_histogram.launches += 1
    return counts


rdf_histogram.launches = 0


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
