"""LAMMPS dump frames formatted in host C++ (``csrc/lammps_format.cc``).

Counterpart of the formatter of ``mdtpu/io/native_writer.py``
(``native/trajwriter.cc``): :func:`format_frame` gives the bytes of
:func:`mdtpu_torch.io.lammps.format_lammps_frame` (the plain version, which
the tests hold it to) without Python's per-value string formatting, and
prints values of any magnitude, infinities and NaN as Python does. The
library is built with ``g++`` into ``mdtpu_torch/_build/`` at first use
(:mod:`mdtpu_torch.ops._cuda_build`) and bound with ctypes, which releases
the GIL during the call. A failed build raises ``RuntimeError`` with the
compiler's output; there is no fallback to the Python formatter.
"""

from __future__ import annotations

import ctypes

import numpy as np

from mdtpu_torch.ops import _cuda_build

NAME = "lammps_format"
# Bytes a row takes at most, past its id, for values below ~1e9: the first
# guess of a frame's size (a frame that needs more is formatted again).
_VALUE_BYTES = 16
_ROW_BYTES = 24

_P = ctypes.c_void_p
_SIGNATURES = (("mdtpu_lammps_format",
                (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int)
                + (_P,) * 5 + (ctypes.c_longlong,), ctypes.c_longlong),)


def library():
    """The formatter's library, built (if needed) and loaded once."""
    return _cuda_build.load(NAME, _SIGNATURES)


def format_frame(step, unitcell, positions, images, diameters) -> bytes:
    """One LAMMPS dump frame as bytes, equal to
    ``format_lammps_frame(...).encode()``. Each call adds one to
    ``format_frame.calls``."""
    cell = np.ascontiguousarray(unitcell, dtype=np.float64)
    pos = np.ascontiguousarray(positions, dtype=np.float64)
    img = np.ascontiguousarray(images, dtype=np.int32)
    diam = np.ascontiguousarray(diameters, dtype=np.float64)
    n, dim = pos.shape
    if dim not in (2, 3) or cell.shape != (dim, dim) \
            or img.shape != (n, dim) or diam.shape != (n,):
        raise ValueError(f"unsupported frame: positions {pos.shape}, cell "
                         f"{cell.shape}, images {img.shape}, diameters "
                         f"{diam.shape}")
    fn = library().mdtpu_lammps_format
    cap = 512 + n * (_ROW_BYTES + (1 + 2 * dim) * _VALUE_BYTES)
    while True:
        buf = np.empty(cap, dtype=np.uint8)
        size = fn(int(step), n, dim, cell.ctypes.data, pos.ctypes.data,
                  img.ctypes.data, diam.ctypes.data, buf.ctypes.data, cap)
        if size < 0:
            raise ValueError(f"unsupported dimension: {dim}")
        if size <= cap:
            format_frame.calls += 1
            return buf[:size].tobytes()
        cap = size


format_frame.calls = 0
