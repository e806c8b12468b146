"""Micro-probe of the half-stencil sweep's inner loop: a hand-written CUDA
kernel and its plain version.

Counterpart of ``probe_kernel.py`` (``kernel`` and ``run``): one pair-block
sweep at the bench geometry (15 planes of 225 rows, capacity 29, 5
row-rolled offsets) in four variants, ``full`` and ``full_static`` (the
Lennard-Jones block), ``nodiv`` (no divide) and ``reduce_only`` (the block
without its reductions). A variant name may carry the row chunk, as in
``"full:5"``.

:func:`probe_sweep` launches ``csrc/plane_probe.cu`` for CUDA tensors and
takes :func:`probe_sweep_plain` only for CPU tensors. At offset 0 every own
slot meets itself (r^2 = 0), so ``full`` and ``full_static`` give NaN in
``fx`` and the energy by construction, as the Pallas probe does.

The row chunk belongs to the function (rows past the last whole chunk are
not swept, ``reduce_only`` samples each chunk's first row), not to the
kernel's launch: one block per (plane, row) whatever the chunk.
"""

from __future__ import annotations

import ctypes
import json

import torch

from mdtpu_torch.ops import _cuda_build

NAME = "plane_probe"
NX, NY, NZ, CAP = 15, 15, 15, 29
ROWS = NY * NZ
C3 = 3 * CAP
CHUNK = 45
N_OFF = 5
CUTOFF2 = 6.25
VARIANTS = {"full": 0, "full_static": 1, "nodiv": 2, "reduce_only": 3}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = (("mdtpu_plane_probe", (_P,) + (_I,) * 6 + (_P,) * 3),)


def _library():
    return _cuda_build.load(NAME, _SIGNATURES)


def build_report() -> str:
    """Build (if needed) the kernel; return the compiler's report."""
    return _cuda_build.build_report(NAME)


def parse_variant(spec: str):
    """``"full:5"`` -> ``("full", 5)``; a bare name takes :data:`CHUNK`."""
    name, _, chunk = spec.partition(":")
    return name, int(chunk) if chunk else CHUNK


def _check(w, variant, chunk):
    if variant not in VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}")
    if not 1 <= chunk <= ROWS:
        raise ValueError(f"chunk must be in [1, {ROWS}], got {chunk}")
    if tuple(w.shape) != (4, NX, ROWS, C3) or w.dtype != torch.float32:
        raise ValueError(f"w must be float32 of shape {(4, NX, ROWS, C3)}, "
                         f"got {w.dtype} {tuple(w.shape)}")


def probe_sweep(w, variant="full", chunk=CHUNK):
    """``(fx (NX, ROWS, CAP), energy (NX, 1, 1))`` of the probe on ``w``
    (4, NX, ROWS, 3 CAP). CUDA tensors launch the kernel (or raise); CPU
    tensors take :func:`probe_sweep_plain`. Each launch adds one to
    ``probe_sweep.launches``."""
    _check(w, variant, chunk)
    if w.device.type == "cpu":
        return probe_sweep_plain(w, variant, chunk)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    lib = _library()
    swept = ROWS // chunk * chunk
    fx = torch.zeros((NX, ROWS, CAP), dtype=torch.float32, device=w.device)
    e_part = torch.empty((NX, swept), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    with torch.cuda.device(w.device):
        rc = lib.mdtpu_plane_probe(w.data_ptr(), NX, ROWS, CAP, NZ, chunk,
                                   VARIANTS[variant], fx.data_ptr(),
                                   e_part.data_ptr(), stream)
    _cuda_build.check(lib, NAME, rc, "plane_probe")
    probe_sweep.launches += 1
    return fx, torch.sum(e_part, dim=1).reshape(NX, 1, 1)


probe_sweep.launches = 0


def probe_sweep_plain(w, variant="full", chunk=CHUNK):
    """The probe in plain PyTorch, same arguments and results as
    :func:`probe_sweep`, in the Pallas probe's order: per plane, offsets
    outer and row chunks inner."""
    _check(w, variant, chunk)
    n_chunks = ROWS // chunk
    fx = torch.zeros((NX, ROWS, CAP), dtype=torch.float32, device=w.device)
    energy = torch.zeros((NX,), dtype=torch.float32, device=w.device)
    for p in range(NX):
        own = [w[k, p, :, CAP:2 * CAP][:, :, None] for k in range(3)]
        e = torch.zeros((), dtype=torch.float32, device=w.device)
        for s in range(N_OFF):
            win = [torch.roll(w[k, p], s * NZ, dims=0)[:, None, :]
                   for k in range(3)]
            for ci in range(n_chunks):
                rows = slice(ci * chunk, (ci + 1) * chunk)
                dx, dy, dz = (own[k][rows] - win[k][rows] for k in range(3))
                r2 = dx * dx + dy * dy + dz * dz
                mask = r2 < CUTOFF2
                if variant == "nodiv":
                    u, f = r2 * 0.5, r2 + dx
                else:
                    inv_r2 = 1.0 / r2
                    sr6 = inv_r2 * inv_r2 * inv_r2
                    sr12 = sr6 * sr6
                    u = 4.0 * (sr12 - sr6)
                    f = 24.0 * (2.0 * sr12 - sr6) * inv_r2
                u = torch.where(mask, u, torch.zeros_like(u))
                f = torch.where(mask, f, torch.zeros_like(f))
                if variant == "reduce_only":
                    e = e + u[0, 0, 0] + f[0, 0, 0]
                    continue
                e = e + torch.sum(u)
                fx[p, rows] += (torch.sum(f * dx, dim=2)
                                + torch.sum(f * dy, dim=2)
                                + torch.sum(f * dz, dim=2))
        energy[p] = e
    return fx, energy.reshape(NX, 1, 1)


def random_input(seed=0, device=None):
    """The probe's input: uniform coordinates on [0, 40), (4, NX, ROWS, C3)
    float32, from a CPU generator seeded with ``seed``."""
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    w = torch.rand((4, NX, ROWS, C3), generator=g, dtype=torch.float32) * 40.0
    return w.to("cuda" if device is None else device)


def replay_ms(fn, reps=50, warmup=3):
    """Device time of one call of ``fn`` in ms: the call is captured in a
    CUDA graph once (after a first call, so nothing is built or loaded
    during the capture) and the graph replayed ``reps`` times between two
    CUDA events. Timing the calls themselves would read the host, which
    takes ~0.1 ms a call."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(warmup):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def run(spec="full", reps=50, seed=0, device=None):
    """Time one variant on the card, as ``probe_kernel.run`` does on the TPU
    (the device's time, by CUDA-graph replay): prints and returns
    ``{"variant", "chunk", "ms_per_sweep"}``."""
    variant, chunk = parse_variant(spec)
    w = random_input(seed, device)
    out = {"variant": variant, "chunk": chunk,
           "ms_per_sweep": replay_ms(lambda: probe_sweep(w, variant, chunk),
                                     reps)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    import sys

    for spec in sys.argv[1:] or ["full_static", "full_static:15", "full:5"]:
        run(spec)
