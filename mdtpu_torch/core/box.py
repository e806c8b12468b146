"""Periodic box handling: unit cells, wrapping, minimum image.

Counterpart of ``mdtpu/core/box.py``. Convention: the unit cell is a
``(d, d)`` matrix whose *columns* are the box vectors, so
``cartesian = cell @ fractional``.

Every product with the cell is written out elementwise in a fixed order
(:func:`_mm`), never as a matmul: on the card a float32 matmul may run in
TF32, which keeps about three decimal digits and would misplace coordinates
by ~1e-3 * L. The elementwise form is full precision on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from mdtpu_torch.utils.math import kahan_add


def _mm(a, m):
    """``a @ m`` for a small ``(d, d)`` matrix ``m``, as a fixed-order sum
    of elementwise products (full precision, no TF32)."""
    out = a[..., 0:1] * m[0]
    for k in range(1, m.shape[0]):
        out = out + a[..., k:k + 1] * m[k]
    return out


def to_unitcell(box, dimension: int, dtype=torch.float32, device="cpu"):
    """Normalise a scalar / vector / matrix box spec into a (d, d) cell."""
    box = np.asarray(box, dtype=np.float64)
    if box.ndim == 0:
        cell = np.eye(dimension) * float(box)
    elif box.ndim == 1:
        if box.shape[0] < dimension:
            raise ValueError(
                f"box vector of length {box.shape[0]} < dimension {dimension}")
        cell = np.diag(box[:dimension])
    elif box.ndim == 2:
        if box.shape[0] < dimension or box.shape[1] < dimension:
            raise ValueError(
                f"box matrix of shape {box.shape} < dimension {dimension}")
        cell = box[:dimension, :dimension]
    else:
        raise ValueError(f"cannot interpret box of shape {box.shape}")
    return torch.as_tensor(cell, dtype=dtype, device=device)


def box_volume(cell) -> float:
    """Volume (area in 2D) = |det(cell)|, on the host in float64."""
    c = cell.detach().cpu().numpy() if isinstance(cell, torch.Tensor) else cell
    return abs(float(np.linalg.det(np.asarray(c, np.float64))))


def is_orthorhombic(cell) -> bool:
    """Host-side check that the cell is diagonal (no tilt)."""
    c = cell.detach().cpu().numpy() if isinstance(cell, torch.Tensor) else cell
    c = np.asarray(c)
    return bool(np.allclose(c, np.diag(np.diag(c))))


def wrap_positions(positions, images, cell, cell_inv):
    """Wrap all positions into the box and update the integer image counts.
    Returns (wrapped_positions, new_images)."""
    frac = _mm(positions, cell_inv.T)
    n_cross = torch.floor(frac)
    wrapped = _mm(frac - n_cross, cell.T)
    return wrapped, images + n_cross.to(images.dtype)


def wrap_positions_compensated(positions, comp, images, cell, cell_inv):
    """Wrap through a Kahan-compensated delta instead of recomputing the
    coordinates: x += -(cell @ k) with integer crossing counts k, so
    non-crossing particles are untouched bit for bit and the rounding of
    crossing ones lands in the compensation buffer.

    Returns (positions, comp, images)."""
    frac = _mm(positions, cell_inv.T)
    n_cross = torch.floor(frac)
    delta = -_mm(n_cross, cell.T)
    positions, comp = kahan_add(positions, comp, delta)
    return positions, comp, images + n_cross.to(images.dtype)


def minimum_image(dr, cell, cell_inv):
    """Minimum-image convention for displacement vectors ``(..., d)``."""
    frac = _mm(dr, cell_inv.T)
    frac = frac - torch.round(frac)
    return _mm(frac, cell.T)


def unwrapped_positions(positions, images, cell):
    """Absolute (unwrapped) coordinates: p + cell @ image."""
    return positions + _mm(images.to(positions.dtype), cell.T)
