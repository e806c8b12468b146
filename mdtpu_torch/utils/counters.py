"""The launch counters of the kernel wrappers, kept true under CUDA-graph
replay.

Each wrapper counts its launches in plain integer attributes (e.g.
``cell_sweep.launches``). A launch recorded into a CUDA graph runs at every
replay of the graph, not when it is recorded. So a module whose wrapper a
captured slot step launches (``cell_sweep``, the draws of
``philox_draws``, ``make_slot_step``) registers its counters here, and
code that captures a graph takes :func:`snapshot`
before and after the capture, puts the counters back with :func:`restore`,
and adds the difference with :func:`add` after each replay.
"""

from __future__ import annotations

_REGISTERED = []   # (owner, attribute)


def register(owner, *names):
    """Register ``owner.name`` for each of ``names`` (integer attributes)."""
    for name in names:
        if (owner, name) not in _REGISTERED:
            _REGISTERED.append((owner, name))


def unregister(owner, *names):
    """Take ``owner.name`` out of the registry for each of ``names``."""
    for name in names:
        if (owner, name) in _REGISTERED:
            _REGISTERED.remove((owner, name))


def snapshot():
    """Every registered counter's value, by ``(owner, name)``."""
    return {(o, n): getattr(o, n) for o, n in _REGISTERED}


def restore(values):
    """Set the counters to ``values`` (a :func:`snapshot`)."""
    for (owner, name), v in values.items():
        setattr(owner, name, v)


def difference(after, before):
    """The counts added between two snapshots, where nonzero."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def add(delta, times=1):
    """Add ``times`` the counts of ``delta`` (a :func:`difference`)."""
    for (owner, name), v in delta.items():
        setattr(owner, name, getattr(owner, name) + v * times)
