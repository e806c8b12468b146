"""Engines and probes of the JAX package's ``mdtpu.ops.experimental`` and its
kernel probe, on the port's kernels:

  * :class:`PlaneEngine` — the cell grid with the Newton half-stencil sweep
    (``csrc/plane_sweep.cu``), counterpart of ``PallasPlaneEngine``;
  * :mod:`mdtpu_torch.ops.experimental.probe` — the micro-probe of that
    sweep's inner loop (``csrc/plane_probe.cu``), counterpart of
    ``probe_kernel.py``.
"""

from mdtpu_torch.ops.experimental.plane import PlaneEngine

__all__ = ["PlaneEngine"]
