"""LAMMPS dump trajectory writer (orthogonal or triclinic boxes, 2D/3D), a
copy of ``mdtpu/io/lammps.py`` (which the port may not import): box bounds
with tilt factors, per-atom ``id type radius`` plus wrapped *and* unwrapped
coordinates (``xu yu [zu]`` via p + cell @ image). Frames are byte-identical
to the JAX package's for equal inputs."""

from __future__ import annotations

import numpy as np


def format_lammps_frame(step, unitcell, positions, images, diameters) -> str:
    positions = np.asarray(positions, dtype=np.float64)
    images = np.asarray(images)
    diameters = np.asarray(diameters, dtype=np.float64)
    cell = np.asarray(unitcell, dtype=np.float64)
    n, dim = positions.shape

    boxmat = np.zeros((3, 3))
    boxmat[:dim, :dim] = cell

    out = []
    out.append(f"ITEM: TIMESTEP\n{step}\n")
    out.append(f"ITEM: NUMBER OF ATOMS\n{n}\n")

    if dim == 2:
        lx = np.linalg.norm(boxmat[:, 0])
        ly = np.linalg.norm(boxmat[:, 1])
        xy = boxmat[0, 1]
        out.append("ITEM: BOX BOUNDS xy pp pp\n")
        out.append(f"{0.0:.6f} {lx:.6f} {xy:.6f}\n")
        out.append(f"{0.0:.6f} {ly:.6f} 0.0\n")
        out.append(f"{0.0:.6f} {1.0:.6f} 0.0\n")
        out.append("ITEM: ATOMS id type radius x y xu yu\n")
    elif dim == 3:
        lx = np.linalg.norm(boxmat[:, 0])
        ly = np.linalg.norm(boxmat[:, 1])
        lz = np.linalg.norm(boxmat[:, 2])
        xy, xz, yz = boxmat[0, 1], boxmat[0, 2], boxmat[1, 2]
        out.append("ITEM: BOX BOUNDS xy xz yz pp pp pp\n")
        out.append(f"{0.0:.6f} {lx:.6f} {xy:.6f}\n")
        out.append(f"{0.0:.6f} {ly:.6f} {yz:.6f}\n")
        out.append(f"{0.0:.6f} {lz:.6f} {xz:.6f}\n")
        out.append("ITEM: ATOMS id type radius x y z xu yu zu\n")
    else:
        raise ValueError(f"unsupported dimension: {dim}")

    # Unwrapped coordinates p + cell @ image. Accumulated per image
    # component in a FIXED order (((p + c_k0 i_0) + c_k1 i_1) + c_k2 i_2)
    # with separate rounded multiply/add — NOT a matmul: BLAS may use FMA
    # and different summation order, which flips the last printed digit for
    # values near a %.6f rounding boundary, and the native C++ writer
    # (native/trajwriter.cc, built with -ffp-contract=off) must produce
    # byte-identical frames.
    unwrapped = positions.copy()
    imgf = images.astype(np.float64)
    for j in range(dim):
        unwrapped += imgf[:, j, None] * cell[None, :, j]

    radius = diameters / 2.0
    for i in range(n):
        wrapped = " ".join(f"{positions[i, d]:.6f}" for d in range(dim))
        unwr = " ".join(f"{unwrapped[i, d]:.6f}" for d in range(dim))
        out.append(f"{i + 1} 1 {radius[i]:.6f} {wrapped} {unwr}\n")

    return "".join(out)


def write_lammps_frame(filepath, step, unitcell, positions, images, diameters,
                       mode="w"):
    frame = format_lammps_frame(step, unitcell, positions, images, diameters)
    with open(filepath, mode) as io:
        io.write(frame)
