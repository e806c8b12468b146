"""Background-thread trajectory writer.

A copy of ``PythonTrajectoryWriter`` from ``mdtpu/io/native_writer.py``,
without compression: frames are formatted and written by a worker thread, so
the simulation loop does not wait on text formatting (about a second per 1e5
atoms in Python). The binding to the native C++ writer comes later.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from mdtpu_torch.io.lammps import format_lammps_frame


class TrajectoryWriter:
    """Async LAMMPS-dump writer; call :meth:`close` to flush and join."""

    def __init__(self, path):
        self._queue: "queue.Queue" = queue.Queue()
        self._error = None
        self._io = open(path, "wb")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            try:
                self._io.write(format_lammps_frame(*item).encode())
            except Exception as exc:  # surface at close(); keep draining
                if self._error is None:
                    self._error = exc

    def write_frame(self, step, unitcell, positions, images, diameters):
        # Copy: the caller may reuse its buffers before the worker formats
        # them.
        self._queue.put((step, np.array(unitcell), np.array(positions),
                         np.array(images), np.array(diameters)))

    def close(self):
        self._queue.put(None)
        self._thread.join()
        self._io.close()
        if self._error is not None:
            # A failed disk write must not read as a written trajectory.
            raise RuntimeError(
                f"trajectory writer failed mid-run: {self._error!r}")
