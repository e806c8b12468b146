"""What the slot advance and the particle-order advance share: a segment of
steps on buffers the advance keeps, with the step counter, NVT's target
and the rebuild decision on the device, and on the card each step variant
captured once into a CUDA graph.

The JAX package runs a segment as one device program (``jax.lax.while_loop``
or ``fori_loop`` over its step, the rebuild a ``lax.cond``). Here
:class:`DeviceAdvance` copies the state into buffers (its tensors and its
engine state's, the step as a 0-d int64 counter) and runs each step on
them in place: NVT's target comes from a device table that the host fills
once a segment, and the rebuild runs through :func:`device_if`, the drift
test's kernel setting the handle of a conditional node under capture. A
subclass says what its test, its rebuild and its step are
(:class:`mdtpu_torch.integrate.slot_step.SlotAdvance`,
:class:`mdtpu_torch.integrate.step.ParticleAdvance`).
"""

from __future__ import annotations

import dataclasses

import torch

from mdtpu_torch.core.types import NVT, SimulationState
from mdtpu_torch.integrate import verlet_update
from mdtpu_torch.integrate.velocity_finish import TargetTable, finish_buffer
from mdtpu_torch.ops import philox_draws
from mdtpu_torch.utils import counters

# The tensors of a state that a step or a rebuild may replace (those that
# are not None): the advance's buffers hold one copy of each.
STATE_TENSORS = ("positions", "velocities", "forces", "images", "diameters",
                 "unitcell", "unitcell_inv", "step", "energy", "virial",
                 "temperature", "pos_comp", "vel_comp", "virial_accum",
                 "nprom", "ids")
# Rebuild steps an advance logs (later ones overwrite the last entry).
REBUILD_LOG = 4096


def state_names(state: SimulationState):
    """The names of :data:`STATE_TENSORS` that ``state`` holds."""
    return tuple(n for n in STATE_TENSORS if getattr(state, n) is not None)


def nbrs_names(nbrs):
    """The tensor fields of an engine state (a dataclass; none for the naive
    engine's ``()``)."""
    if not dataclasses.is_dataclass(nbrs):
        return ()
    return tuple(f.name for f in dataclasses.fields(nbrs)
                 if isinstance(getattr(nbrs, f.name), torch.Tensor))


def copy_into(dst: SimulationState, src: SimulationState, skip=()):
    """Write ``src``'s tensors into ``dst``'s (the buffers), in place;
    a tensor that is the buffer itself is left alone."""
    for owner_d, owner_s, names in ((dst, src, state_names(dst)),
                                    (dst.nbrs, src.nbrs,
                                     nbrs_names(dst.nbrs))):
        for name in names:
            d, t = getattr(owner_d, name), getattr(owner_s, name)
            if name not in skip and t is not d:
                d.copy_(t)


def clone(state: SimulationState, step=None) -> SimulationState:
    """A copy of ``state`` whose tensors are its own (aliases split), its
    temperature a :func:`~mdtpu_torch.integrate.velocity_finish.
    finish_buffer`; ``step``: the step field to put in."""
    nbrs = state.nbrs
    if dataclasses.is_dataclass(nbrs):
        nbrs = dataclasses.replace(nbrs, **{
            n: getattr(nbrs, n).clone() for n in nbrs_names(nbrs)})
    return state.replace(nbrs=nbrs, step=state.step if step is None else step,
                         **{n: (finish_buffer(getattr(state, n))
                                if n == "temperature"
                                else getattr(state, n).clone())
                            for n in state_names(state) if n != "step"})


def device_if(flag, test, body, pool=None):
    """Run ``body()`` where ``test(handle)`` sets the 0-d bool tensor
    ``flag``: an advance's rebuild decision. Under a CUDA-graph capture the
    test is captured with an IF node's handle, which its kernel sets, and
    ``body`` into that node (its allocations from ``pool``, a
    ``torch.cuda.MemPool`` kept with the graph): the card decides at every
    replay. Eagerly ``test(None)`` runs and the flag is read on the host,
    the segment's one host read a step (free on the CPU)."""
    if flag.is_cuda and torch.cuda.is_current_stream_capturing():
        with philox_draws.graph_if(test, flag.device, pool):
            body()
        return
    test(None)
    if bool(flag):
        body()


class DeviceAdvance:
    """``advance(state, k) -> state`` after ``k`` steps on one device, the
    step counter, NVT's target and the rebuild decision on the device.

    The state is copied into buffers (:func:`clone`; the step a 0-d int64
    counter), and each step reads them and writes its results back in
    place. The state returned is a copy of the buffers, its step the host
    int ``state.step + k``. A subclass gives :meth:`_test` (the drift test
    into a flag, setting an IF node's handle where given),
    :meth:`_rebuilt` (the buffers' state after a rebuild) and
    :meth:`_step` (one step on the buffers, calling ``refresh`` where the
    test and the rebuild go), and calls :meth:`_run` for each step variant
    of a segment.

    ``graph``: on the card each step variant is captured once into a CUDA
    graph with the rebuild in a conditional node, and a segment of ``k``
    steps is ``k`` graph launches and no host read; ``census[name]`` holds
    each variant's nodes, read from the graph at its capture
    (:func:`philox_draws.capture_census`, and the programmatic edges into
    the Brownian update, :func:`verlet_update.capture_census`). Eagerly the
    same code runs step by step, the flag read on the host. The launch
    counters count each replay (:mod:`mdtpu_torch.utils.counters`). A
    capture or a launch that fails raises; nothing falls back to the eager
    loop."""

    def __init__(self, engine, ensemble, graph):
        self.engine, self.graph = engine, graph
        self.schedule = (ensemble.ktemp if isinstance(ensemble, NVT)
                         else None)
        self.bufs = self.table = None
        self.graphs, self.census = {}, {}
        self._pool = None

    # -- what a subclass gives -------------------------------------------

    def _test(self, b, flag, handle):
        raise NotImplementedError

    def _rebuilt(self, b):
        raise NotImplementedError

    def _step(self, b, step_fn, refresh):
        raise NotImplementedError

    # -- buffers and segment inputs --------------------------------------

    def _layout(self, state):
        nbrs = state.nbrs
        return (state.seed, state.nf, state.cutoff,
                tuple((t.shape, t.dtype, t.device) for t in
                      [getattr(state, n) for n in state_names(state)
                       if n != "step"]
                      + [getattr(nbrs, n) for n in nbrs_names(nbrs)]))

    def _load(self, state):
        """Put ``state`` into the buffers (made anew, and the graphs
        dropped, where its layout, seed or nf changed)."""
        if self.bufs is None or self._layout(self.bufs) != self._layout(
                state):
            device = state.device
            self.graphs = {}
            self.bufs = clone(state, torch.full(
                (), state.step, dtype=torch.int64, device=device))
            self.base = torch.zeros((), dtype=torch.int64, device=device)
            self.flag = torch.zeros((), dtype=torch.bool, device=device)
            self.rebuilds = torch.zeros((), dtype=torch.int64, device=device)
            self.rebuilt_at = torch.zeros(REBUILD_LOG, dtype=torch.int64,
                                          device=device)
        else:
            copy_into(self.bufs, state, skip=("step",))
            self.bufs.step.fill_(state.step)
        self.base.fill_(state.step)

    def _fill_table(self, base, k):
        """NVT's ``ktemp(step + 1)`` for the segment's steps, evaluated on
        the host in float64 as the schedule gives it, rounded to the
        state's dtype and sent in one copy."""
        if self.schedule is None:
            return
        b = self.bufs
        if self.table is None or self.table.numel() < k:
            self.graphs = {}
            self.table = torch.empty(max(k, 1024), dtype=b.dtype,
                                     device=b.device)
        values = torch.tensor([float(self.schedule(s + 1))
                               for s in range(base, base + k)],
                              dtype=torch.float64).to(b.dtype)
        if b.device.type == "cuda":
            self.table[:k].copy_(values.pin_memory(), non_blocking=True)
        else:
            self.table[:k].copy_(values)

    def _target(self):
        return None if self.table is None else TargetTable(self.table,
                                                           self.base)

    # -- one step on the buffers -----------------------------------------

    def _rebuild(self):
        before = counters.snapshot()
        b = self.bufs
        copy_into(b, self._rebuilt(b))
        slot = self.rebuilds.clamp(max=REBUILD_LOG - 1).reshape(1)
        self.rebuilt_at.index_copy_(0, slot, b.step.reshape(1))
        self.rebuilds.add_(1)
        # The launches a rebuild counts (under capture: those of the IF
        # node's body).
        self._rebuild_counts = counters.difference(counters.snapshot(),
                                                   before)

    def _refresh(self):
        """The drift test and, where it is set, the rebuild, on the
        buffers."""
        device_if(self.flag,
                  lambda handle: self._test(self.bufs, self.flag, handle),
                  self._rebuild, self._pool)

    def _one(self, step_fn):
        self._step(self.bufs, step_fn, self._refresh)

    # -- graphs ----------------------------------------------------------

    def _captured(self, name, step_fn):
        """``(graph, counts)`` of one step variant: captured on first use
        after a warm-up of the step and the rebuild on copies of the
        buffers (libraries built, plans made), the counters put back, and
        the counts one replay adds."""
        if name in self.graphs:
            return self.graphs[name]
        before = counters.snapshot()
        b = clone(self.bufs, self.bufs.step.clone())
        flag = torch.empty_like(self.flag)

        def warm():
            self._test(b, flag, None)
            copy_into(b, self._rebuilt(b))

        side = torch.cuda.Stream(b.device)
        side.wait_stream(torch.cuda.current_stream(b.device))
        with torch.cuda.stream(side):
            self._step(b, step_fn, warm)
        torch.cuda.current_stream(b.device).wait_stream(side)
        del b
        warm_counts = counters.snapshot()
        graph = torch.cuda.CUDAGraph()
        pool = self._pool = torch.cuda.MemPool()
        self._rebuild_counts = {}
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._one(step_fn)
                self.census[name] = {
                    **philox_draws.capture_census(self.bufs.device),
                    **verlet_update.capture_census(self.bufs.device)}
        finally:
            self._pool = None
        # A replay adds the step's counts; the IF node's body's come in by
        # the rebuilds the device tallied (counters.add_later).
        body = self._rebuild_counts
        delta = {k: v - body.get(k, 0) for k, v in counters.difference(
            counters.snapshot(), warm_counts).items() if v != body.get(k, 0)}
        counters.restore(before)
        self.graphs[name] = (graph, delta, body, pool)
        return self.graphs[name]

    def _run(self, name, step_fn, times):
        if times <= 0:
            return
        if not self.graph:
            for _ in range(times):
                self._one(step_fn)
            return
        graph, delta, body, _ = self._captured(name, step_fn)
        first = self.rebuilds.clone() if body else None
        for _ in range(times):
            graph.replay()
        counters.add(delta, times)
        if body:
            counters.add_later(body, first, self.rebuilds.clone())

    def _resolve_graph(self, state, eager_only):
        """Settle ``graph=None`` for ``state``: captured on the card unless
        ``eager_only`` (a potential without a kernel functor: a user's
        evaluation may do host work); ``graph=True`` raises where it cannot
        be had."""
        if self.graph is None:
            self.graph = state.device.type == "cuda" and not eager_only
        elif self.graph and (state.device.type != "cuda" or eager_only):
            raise ValueError("graph=True takes a CUDA state and a potential "
                             "with a kernel functor")

    def rebuild_steps(self):
        """The steps in which this advance rebuilt, in order (the first
        :data:`REBUILD_LOG`; a host read)."""
        n = int(self.rebuilds)
        return self.rebuilt_at[:min(n, REBUILD_LOG)].tolist()
