"""The cell-list pair sweep: a hand-written CUDA kernel and its plain version.

Counterpart of the Pallas kernel
``mdtpu/ops/experimental/pallas_cell.py::_pair_row_kernel``: forces, energy
and virial of every pair within the cutoff, over particles sorted into the
slots of a periodic 3D orthorhombic cell grid, with the full 27-cell
stencil (each pair seen from both sides; energy and virial halved).

Inputs (the slot layout of :meth:`CellGridEngine.allocate`):
  * ``slot_pos``  (3, n_cells * C) slot coordinates, component-major; the
    slots [0, count) of each cell are occupied, the rest are never read;
  * ``slot_diam`` (n_cells * C,) slot diameters;
  * ``counts``    (n_cells,) int64 occupied slots per cell (clamped to C);
  * ``box``       (3,) box lengths;
  * ``grid`` (nx, ny, nz), at least 3 cells per axis, and the engine cutoff.
Returns ``(energy, virial, slot_forces)`` with ``slot_forces`` (3, n_cells * C)
(zero on vacant slots).

:func:`cell_sweep` launches the kernel in ``csrc/cell_sweep.cu`` for CUDA
tensors and takes :func:`cell_sweep_plain` only for CPU tensors. The kernel is
compiled with ``nvcc`` for ``sm_90a`` into ``mdtpu_torch/_build`` at first use
and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import os
import shutil
import subprocess
from pathlib import Path

import torch

from mdtpu_torch.potentials.base import rounded
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from mdtpu_torch.potentials.xplor import LennardJonesXPLOR

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "cell_sweep.cu"
BUILD_DIR = _PKG / "_build"
_LIB = BUILD_DIR / "libcell_sweep.so"
_LOG = BUILD_DIR / "libcell_sweep.log"
MAX_CAPACITY = 1024  # one thread per own slot, at most 1024 a block


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA pair sweep is built at "
                           "first use and needs the CUDA toolkit")
    return found


def build() -> None:
    """Compile ``csrc/cell_sweep.cu`` into ``_build/libcell_sweep.so`` unless
    an up-to-date library is there; the compiler's report (``-Xptxas -v``:
    registers, shared memory, spills) goes to ``_build/libcell_sweep.log``."""
    if _LIB.is_file() and _LIB.stat().st_mtime >= SOURCE.stat().st_mtime:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libcell_sweep.{os.getpid()}.so"
    # -fmad=false: no multiply-add contraction, so every product rounds as
    # in the plain version and the two differ only in the order of the sums.
    # A contracted r^2 or lam sr^(lam+2) - (lam-1) sr^(lam+1) shifts a
    # pseudo-hard-sphere force by ~1e-5 of itself in float32.
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-fmad=false", "-lineinfo", "-Xptxas", "-v", "-shared",
           "-Xcompiler",
           "-fPIC", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    _LOG.write_text(proc.stderr + proc.stdout)
    os.replace(tmp, _LIB)


@functools.lru_cache(maxsize=1)
def _library():
    """The ctypes library, built and loaded once per process."""
    build()
    lib = ctypes.CDLL(str(_LIB))
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("mdtpu_cell_sweep_f32", "mdtpu_cell_sweep_f64"):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = ([ptr] * 4 + [i32] * 4 + [f64, i32] + [f64] * 4
                       + [i32] * 3 + [ptr] * 3 + [ptr])
    lib.mdtpu_cell_sweep_error_string.restype = ctypes.c_char_p
    lib.mdtpu_cell_sweep_error_string.argtypes = [i32]
    return lib


def build_report() -> str:
    """Build (if needed) and load the kernel; return the compiler's report
    of the build."""
    _library()
    return _LOG.read_text() if _LOG.is_file() else ""


def kernel_params(potential):
    """(kind, four float parameters, three int parameters) of a potential the
    kernel knows; ``NotImplementedError`` for any other."""
    kind = type(potential)
    mix = int(getattr(potential, "mixing", "lorentz") != "none")
    if kind is LennardJones:
        return 0, (potential.epsilon, potential.sigma, potential.r_cut, 0.0), \
            (int(potential.shift), int(potential.force_shift), mix)
    if kind is PseudoHS:
        if not isinstance(potential.lam, int) or potential.lam < 2:
            raise ValueError(f"PseudoHS lam must be an int >= 2, got "
                             f"{potential.lam!r}")
        return 1, (0.0, 0.0, 0.0, 0.0), \
            (potential.lam, int(potential.sigma_scaled_cutoff), mix)
    if kind is LennardJonesXPLOR:
        return 2, (potential.epsilon, potential.sigma, potential.r_on,
                   potential.r_cut), (0, 0, mix)
    raise NotImplementedError(
        f"the CUDA pair sweep has no functor for {kind.__name__}; user "
        f"potentials in the kernel are queue A9")


def _check(slot_pos, slot_diam, counts, box, grid):
    if len(grid) != 3 or min(grid) < 3:
        raise ValueError(f"the sweep needs a 3D grid with >= 3 cells per "
                         f"axis, got {tuple(grid)}")
    n_cells = grid[0] * grid[1] * grid[2]
    if slot_pos.dim() != 2 or slot_pos.shape[0] != 3 \
            or slot_pos.shape[1] % n_cells:
        raise ValueError(f"slot_pos must be (3, n_cells * C), got "
                         f"{tuple(slot_pos.shape)} for {n_cells} cells")
    cap = slot_pos.shape[1] // n_cells
    if not 1 <= cap <= MAX_CAPACITY:
        raise ValueError(f"cell capacity {cap} outside [1, {MAX_CAPACITY}]")
    if tuple(slot_diam.shape) != (slot_pos.shape[1],):
        raise ValueError("slot_diam must be (n_cells * C,)")
    if tuple(counts.shape) != (n_cells,) or counts.dtype != torch.int64:
        raise ValueError("counts must be int64 of shape (n_cells,)")
    if tuple(box.shape) != (3,):
        raise ValueError("box must hold the 3 box lengths")
    return n_cells, cap


def cell_sweep(slot_pos, slot_diam, counts, box, grid, cutoff, potential):
    """The pair sweep. CUDA tensors launch the kernel (or raise); CPU tensors
    take :func:`cell_sweep_plain`. Each launch adds one to
    ``cell_sweep.launches``."""
    n_cells, cap = _check(slot_pos, slot_diam, counts, box, grid)
    if slot_pos.device.type == "cpu":
        return cell_sweep_plain(slot_pos, slot_diam, counts, box, grid,
                                cutoff, potential)
    if slot_pos.device.type != "cuda":
        raise ValueError(f"unsupported device {slot_pos.device}")
    dtype, device = slot_pos.dtype, slot_pos.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the kernel takes float32 or float64, got {dtype}")
    for t in (slot_diam, box):
        if t.dtype != dtype:
            raise TypeError("slot_pos, slot_diam and box must share a dtype")
    for t in (slot_pos, slot_diam, counts, box):
        if t.device != device:
            raise ValueError("all sweep inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("sweep inputs must be contiguous")
    kind, fp, ip = kernel_params(potential)
    lib = _library()
    fn = (lib.mdtpu_cell_sweep_f32 if dtype == torch.float32
          else lib.mdtpu_cell_sweep_f64)
    force = torch.empty((3, slot_pos.shape[1]), dtype=dtype, device=device)
    e_part = torch.empty((n_cells,), dtype=dtype, device=device)
    w_part = torch.empty((n_cells,), dtype=dtype, device=device)
    nx, ny, nz = (int(g) for g in grid)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(slot_pos.data_ptr(), slot_diam.data_ptr(), counts.data_ptr(),
                box.data_ptr(), nx, ny, nz, cap, float(cutoff), kind,
                *(float(v) for v in fp), *ip, force.data_ptr(),
                e_part.data_ptr(), w_part.data_ptr(), stream)
    if rc != 0:
        msg = lib.mdtpu_cell_sweep_error_string(rc).decode()
        raise RuntimeError(f"cell_sweep launch failed ({rc}): {msg}")
    cell_sweep.launches += 1
    return torch.sum(e_part), torch.sum(w_part), force


cell_sweep.launches = 0


def cell_sweep_plain(slot_pos, slot_diam, counts, box, grid, cutoff,
                     potential):
    """The sweep in plain PyTorch, same arguments and results as
    :func:`cell_sweep`: one (n_cells, C, C) pair tile per stencil offset,
    neighbour cells found by periodic index with the +-L image shift added,
    loops bounded by the per-cell counts through masks."""
    n_cells, cap = _check(slot_pos, slot_diam, counts, box, grid)
    nx, ny, nz = (int(g) for g in grid)
    dtype, device = slot_pos.dtype, slot_pos.device
    pos = slot_pos.reshape(3, n_cells, cap)
    diam = slot_diam.reshape(n_cells, cap)
    slot = torch.arange(cap, device=device)
    occ = slot[None, :] < counts.clamp(max=cap)[:, None]       # (nc, C)
    c = torch.arange(n_cells, device=device)
    home = (c // (ny * nz), (c // nz) % ny, c % nz)
    own = [pos[k][:, :, None] for k in range(3)]               # (nc, C, 1)
    own_d = diam[:, :, None]
    not_self = ~torch.eye(cap, dtype=torch.bool, device=device)
    c_eng = rounded(cutoff, dtype)
    cutoff2 = rounded(c_eng * c_eng, dtype)

    energy = torch.zeros((), dtype=dtype, device=device)
    virial = torch.zeros((), dtype=dtype, device=device)
    force = torch.zeros((3, n_cells, cap), dtype=dtype, device=device)
    for off in itertools.product((-1, 0, 1), repeat=3):
        idx, shift = [], []
        for k, (h, n) in enumerate(zip(home, (nx, ny, nz))):
            j = h + off[k]
            shift.append(((j >= n).to(dtype) - (j < 0).to(dtype)) * box[k])
            idx.append(torch.remainder(j, n))
        nb = (idx[0] * ny + idx[1]) * nz + idx[2]
        w = [pos[k][nb] + shift[k][:, None] for k in range(3)]   # (nc, C)
        d = [own[k] - w[k][:, None, :] for k in range(3)]        # (nc, C, C)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        mask = occ[:, :, None] & occ[nb][:, None, :] & (r2 < cutoff2)
        if off == (0, 0, 0):
            mask = mask & not_self
        r2s = torch.where(mask, r2, torch.ones_like(r2))
        u, f = potential.evaluate_r2(r2s, own_d, diam[nb][:, None, :])
        u = torch.where(mask, u, torch.zeros_like(u))
        f = torch.where(mask, f, torch.zeros_like(f))
        energy = energy + 0.5 * torch.sum(u)
        virial = virial + 0.5 * torch.sum(f * r2s)
        for k in range(3):
            force[k] += torch.sum(f * d[k], dim=2)
    return energy, virial, force.reshape(3, n_cells * cap)
