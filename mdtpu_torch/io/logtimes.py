"""Logarithmically spaced snapshot times, a copy of ``mdtpu/io/logtimes.py``
(which the port may not import).

``floor(j * maxlog + logbase^i)`` for j in 0..max_iter and i in 0..logn, with
maxlog = floor(logbase^logn), deduplicated and sorted; the list is also saved
to ``new-log-times.txt`` in ``save_dir``.
"""

from __future__ import annotations

import math
import os

import numpy as np


def save_log_times_to_file(logs, logn, logbase, filename):
    with open(filename, "w") as f:
        f.write(f"#maxsnap={logn},base={logbase}\n")
        for log in logs:
            f.write(f"{log}\n")


def generate_log_times(max_iter: int = 10000, logn: int = 40,
                       logbase: float = 1.35, save_dir: str | None = None,
                       max_step: int | None = None):
    """Return the sorted unique log-spaced step list. ``max_step`` stops the
    generation early and drops the times past it."""
    maxlog = math.floor(logbase ** logn)
    i = np.arange(logn + 1)
    if max_step is not None:
        max_iter = min(max_iter, max(0, int(max_step // maxlog) + 1))
    j = np.arange(max_iter + 1, dtype=np.int64)
    times = (j[:, None] * maxlog + np.floor(logbase ** i)[None, :]).astype(np.int64)
    logs = np.unique(times.ravel())
    if max_step is not None:
        logs = logs[logs <= max_step]
    logs = logs.tolist()

    if save_dir is not None:
        save_log_times_to_file(logs, logn, logbase,
                               os.path.join(save_dir, "new-log-times.txt"))
    return logs
