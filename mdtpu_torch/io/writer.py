"""Background-thread trajectory writer.

The counterpart of the writers of ``mdtpu/io/native_writer.py``: frames are
formatted and written by a worker thread, so the simulation loop does not
wait on them. The thread formats each frame with the host C++ formatter
(:func:`mdtpu_torch.io.native_writer.format_frame`; ``PERF.md`` has its
time beside Python's ``format_lammps_frame``); ctypes releases the GIL
during the call. With ``compress`` the thread feeds a zstd
stream (:mod:`.compress`), so the file holds the compressed trajectory and
no plain file is written; with ``append`` the file is continued (a
compressed one gets a frame of its own: zstd decodes concatenated frames).
The same thread writes the log-time snapshots (``snapshot.{step}``, one
plain frame per file).
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from mdtpu_torch.io import native_writer
from mdtpu_torch.io.compress import ZstdWriter, require_libzstd


class TrajectoryWriter:
    """Async LAMMPS-dump writer; call :meth:`close` to flush and join."""

    def __init__(self, path, compress=False, append=False):
        self._queue: "queue.Queue" = queue.Queue()
        self._error = None
        # Before the file is opened (and truncated): a formatter that does
        # not build, or a missing libzstd, leaves no empty file behind.
        native_writer.library()
        if compress:
            require_libzstd()
        self._io = open(path, "ab" if append else "wb")
        self._zwriter = ZstdWriter(self._io) if compress else None
        self._sink = self._zwriter or self._io
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            path, frame = item
            try:
                text = native_writer.format_frame(*frame)
                if path is None:
                    self._sink.write(text)
                else:
                    with open(path, "wb") as f:
                        f.write(text)
            except Exception as exc:  # surface at close(); keep draining
                if self._error is None:
                    self._error = exc

    def _put(self, path, step, unitcell, positions, images, diameters):
        # Copy: the caller may reuse its buffers before the worker formats
        # them.
        self._queue.put((path, (step, np.array(unitcell), np.array(positions),
                                np.array(images), np.array(diameters))))

    def write_frame(self, step, unitcell, positions, images, diameters):
        """Append one frame to the trajectory file."""
        self._put(None, step, unitcell, positions, images, diameters)

    def write_snapshot(self, path, step, unitcell, positions, images,
                       diameters):
        """Write one frame as the whole of the file ``path``."""
        self._put(path, step, unitcell, positions, images, diameters)

    def close(self):
        self._queue.put(None)
        self._thread.join()
        try:
            if self._zwriter is not None:
                self._zwriter.close()
        finally:
            self._io.close()
        if self._error is not None:
            # A failed disk write must not read as a written trajectory.
            raise RuntimeError(
                f"trajectory writer failed mid-run: {self._error!r}")
