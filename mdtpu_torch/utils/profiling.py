"""Profiling helpers: a ``torch.profiler`` trace and the step-rate meter
of ``run_simulation``.

Counterpart of ``mdtpu/utils/profiling.py``: :class:`StepRateMeter` writes
the same ``perf.txt`` header and rows; :func:`trace` records the host and,
where a card is present, the device with ``torch.profiler`` and writes a
Chrome trace (``trace.json``, for Perfetto or ``chrome://tracing``) into
``logdir``, where the JAX package writes a ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write ``logdir/trace.json``; yields the
    profiler (``key_averages()`` gives the sums by kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepRateMeter:
    """Wall time per simulation segment; ``run_simulation`` appends rows to
    ``perf.txt`` (kept apart from thermo.txt, whose format is the
    reference's)."""

    def __init__(self, path=None, append=False):
        self.path = path
        self._last = time.perf_counter()
        if path is not None and not (append and os.path.isfile(path)):
            with open(path, "w") as f:
                f.write("# Step StepsPerSec\n")

    def tick(self, step: int, n_steps: int):
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        rate = n_steps / dt if dt > 0 else float("inf")
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(f"{step} {rate:.2f}\n")
        return rate
