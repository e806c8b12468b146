"""Extended-XYZ reader/writer (a copy of ``mdtpu/io/xyz.py``, which the
port may not import).

Header: ``Lattice="<d*d floats, column-major>" Properties=type:I:1:id:I:1:
radius:R:1:pos:R:<d> Time=<step>``; rows: ``type id radius x y [z]`` with
radius = diameter / 2. The lattice is flattened column-major on write and
reshaped column-major on read (Julia comprehension + ``reshape`` semantics),
so write -> read round-trips for triclinic cells too.
"""

from __future__ import annotations

import re

import numpy as np


def _host(x):
    """float64 numpy copy of an array or a tensor on any device."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def format_g6(x: float) -> str:
    """Julia's @printf %.6g equivalent."""
    return f"{x:.6g}"


def write_xyz(filepath, step, unitcell, positions, diameters, mode="a"):
    positions = _host(positions)
    diameters = _host(diameters)
    cell = _host(unitcell)
    n, dim = positions.shape

    flat_lattice = " ".join(repr(float(v)) for v in cell.flatten(order="F"))
    lines = [f"{n}\n"]
    lines.append(
        f'Lattice="{flat_lattice}" '
        f"Properties=type:I:1:id:I:1:radius:R:1:pos:R:{dim} Time={format_g6(step)}\n"
    )
    for i in range(n):
        coords = " ".join(f"{positions[i, d]:.6f}" for d in range(dim))
        lines.append(f"1 {i + 1} {diameters[i] / 2.0:.6f} {coords}\n")
    with open(filepath, mode) as io:
        io.writelines(lines)


def read_xyz(filepath, dimension: int = 3):
    """Read one Extended-XYZ frame. Returns (unitcell (d,d), positions (N,d),
    diameters (N,))."""
    with open(filepath, "r") as io:
        n_particles = int(io.readline().strip())
        header = io.readline()
        m = re.search(r'Lattice="([^"]+)"', header)
        if m is None:
            raise ValueError(f"could not parse Lattice property in header of {filepath}")
        entries = np.array([float(x) for x in m.group(1).split()])
        unitcell = entries.reshape(dimension, dimension, order="F")

        positions = np.zeros((n_particles, dimension))
        radii = np.zeros(n_particles)
        for i in range(n_particles):
            parts = io.readline().split()
            radii[i] = float(parts[2])
            positions[i] = [float(x) for x in parts[3 : 3 + dimension]]

    return unitcell, positions, radii * 2.0
