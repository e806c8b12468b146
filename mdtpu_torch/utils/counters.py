"""The launch counters of the kernel wrappers, kept true under CUDA-graph
replay.

Each wrapper counts its launches in plain integer attributes (e.g.
``cell_sweep.launches``). A launch recorded into a CUDA graph runs at every
replay of the graph, not when it is recorded. So a module whose wrapper a
captured step launches (``cell_sweep``, the draws of ``philox_draws``,
``make_slot_step``; in particle order also ``plane_sweep`` and the list's
``nl_build`` and ``nl_forces``) registers its counters here, and
code that captures a graph takes :func:`snapshot`
before and after the capture, puts the counters back with :func:`restore`,
and adds the difference with :func:`add` after each replay. The launches
inside a conditional node (a rebuild) run only at the replays that take
it: they are added by :func:`add_later` from the device's tally of taken
branches and come in at :func:`settle`.
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


_PENDING = []   # (delta, first, last): counts a device tally decides


def add_later(delta, first, last):
    """Add the counts of ``delta`` ``last - first`` times at the next
    :func:`settle` (``first``, ``last``: 0-d integer tensors, a device
    tally before and after some replays: the launches inside a captured
    conditional node run only where it is taken, so a replay cannot add
    them without a host read)."""
    _PENDING.append((delta, first, last))


def settle():
    """Add every deferred count (one host read each); the counters are then
    true. Call before reading or resetting them."""
    while _PENDING:
        delta, first, last = _PENDING.pop(0)
        add(delta, int(last - first))
