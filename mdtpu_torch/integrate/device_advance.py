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
test's kernel setting the handle of a conditional node under capture; the
captured segment is one graph launch, a WHILE node (:func:`device_while`)
looping the step while the counter is below the segment's end, as the JAX
package's ``while_loop`` does. A subclass says what its test, its rebuild
and its step are
(:class:`mdtpu_torch.integrate.slot_step.SlotAdvance`,
:class:`mdtpu_torch.integrate.step.ParticleAdvance`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc

import torch

from mdtpu_torch.core.types import NVT, SimulationState
from mdtpu_torch.integrate import verlet_update
from mdtpu_torch.integrate.velocity_finish import TargetTable, finish_buffer
from mdtpu_torch.ops import philox_draws
from mdtpu_torch.potentials.base import (CaptureContractError,
                                         abandon_capture, checking_contract)
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


def layout(state: SimulationState):
    """What buffers made for ``state`` (and graphs captured on them) fit:
    the seed, nf, cutoff and each tensor's shape, dtype and device."""
    nbrs = state.nbrs
    return (state.seed, state.nf, state.cutoff,
            tuple((t.shape, t.dtype, t.device) for t in
                  [getattr(state, n) for n in state_names(state)
                   if n != "step"]
                  + [getattr(nbrs, n) for n in nbrs_names(nbrs)]))


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


def settle_graph(graph, device) -> bool:
    """Whether a loop on ``device`` runs captured: ``graph=None`` captures
    on the card and runs eagerly on the CPU, whatever the potential (a
    user's runs captured too: the capture contract of
    :mod:`mdtpu_torch.potentials.base`); False runs eagerly; True raises on
    the CPU. The one rule of the advances' segments and FIRE's
    minimization."""
    cuda = torch.device(device).type == "cuda"
    if graph is None:
        return cuda
    if graph and not cuda:
        raise ValueError("graph=True takes a CUDA state")
    return bool(graph)


def capturing(device) -> bool:
    """Whether the current stream of ``device`` is capturing a CUDA graph
    (never on the CPU)."""
    return (torch.device(device).type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def device_if(flag, test, body, pools=None):
    """Run ``body()`` where ``test(handle)`` sets the 0-d bool tensor
    ``flag``: an advance's rebuild decision. Under a CUDA-graph capture the
    test is captured with an IF node's handle, which its kernel sets, and
    ``body`` into that node (its allocations from a ``torch.cuda.MemPool``
    appended to ``pools``, a list kept with the graph): the card decides at
    every replay. Eagerly ``test(None)`` runs and the flag is read on the
    host, the segment's one host read a step (free on the CPU)."""
    if capturing(flag.device):
        with philox_draws.graph_if(test, flag.device, pools):
            body()
        return
    test(None)
    if bool(flag):
        body()


def device_while(flag, test, body, pools=None):
    """Run ``body(handle)`` again and again while the 0-d bool tensor
    ``flag`` is set: ``test(handle)`` sets it for the first entry and
    ``body``'s last kernel on every pass (the JAX package's
    ``lax.while_loop``). Under a CUDA-graph capture ``test`` is captured
    with a WHILE node's handle and ``body`` into the node (allocations as
    :func:`device_if`'s), and both kernels set the handle: the loop runs on
    the card, no host read. Eagerly ``test(None)`` runs, then ``body(None)``
    while the flag, read on the host after each (free on the CPU), is set;
    a body that returns a bool (it read the flag itself) is taken at its
    word."""
    if capturing(flag.device):
        with philox_draws.graph_while(test, flag.device, pools) as handle:
            body(handle)
        return
    test(None)
    going = bool(flag)
    while going:
        going = body(None)
        if going is None:
            going = bool(flag)


class LoopCounts:
    """The launch counts a replay of a captured loop adds
    (:mod:`mdtpu_torch.utils.counters`): a launch recorded into the WHILE
    node's body runs at each pass, one in an IF node's body (a rebuild)
    only where the device takes it. During the capture :meth:`loop_body`
    and :meth:`if_body` note what the body and an IF body added (every IF
    body of one graph adds the same); :meth:`close` splits the capture's
    counts into ``once``, ``per_pass`` (its IF bodies apart) and
    ``per_if``; :meth:`add` adds a replay's."""

    def __init__(self):
        self.once, self.per_pass, self.per_if = {}, {}, {}
        self._ifs = self._pass_ifs = 0

    @contextlib.contextmanager
    def loop_body(self):
        before, ifs = counters.snapshot(), self._ifs
        yield
        self.per_pass = counters.difference(counters.snapshot(), before)
        self._pass_ifs = self._ifs - ifs

    @contextlib.contextmanager
    def if_body(self):
        before = counters.snapshot()
        yield
        self.per_if = counters.difference(counters.snapshot(), before)
        self._ifs += 1

    def close(self, total):
        """Split ``total``, the capture's counts."""
        for k, v in self.per_if.items():
            self.per_pass[k] = self.per_pass.get(k, 0) - v * self._pass_ifs
        self.once = dict(total)
        for k in set(self.per_pass) | set(self.per_if):
            self.once[k] = (self.once.get(k, 0) - self.per_pass.get(k, 0)
                            - self.per_if.get(k, 0) * self._ifs)
        self.once, self.per_pass = ({k: v for k, v in d.items() if v}
                                    for d in (self.once, self.per_pass))

    def add(self, passes, ifs):
        """The counts of a replay that ran ``passes`` passes and took
        ``ifs`` IF bodies: a host int, or a device tally's ``(first,
        last)`` (:func:`counters.add_later`, no host read)."""
        counters.add(self.once)
        counters.add(self.per_pass, passes)
        if not self.per_if:
            return
        if isinstance(ifs, tuple):
            counters.add_later(self.per_if, *ifs)
        else:
            counters.add(self.per_if, ifs)


def noting(counts, part):
    """``counts``' :meth:`LoopCounts.loop_body` or ``if_body`` (``part``:
    ``"loop"`` or ``"if"``) during a capture, else nothing."""
    if counts is None:
        return contextlib.nullcontext()
    return counts.loop_body() if part == "loop" else counts.if_body()


def capture(device, warm, program):
    """``(graph, pools, counts)``: ``warm()`` run on a side stream first
    (libraries built and loaded, plans made, outside any capture), then
    ``program(pools, counts)`` captured into a CUDA graph on ``device``,
    its conditional bodies' memory pools appended to ``pools`` (kept with
    the graph) and its loop's counts noted in ``counts``
    (:class:`LoopCounts`); the counters put back as they were. The loops on
    the device share it: an advance's segment, FIRE's minimization."""
    before = counters.snapshot()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    # The warm-up runs each potential under the capture contract's guard
    # and in a trial capture of its own: a potential that breaks the
    # contract raises before the loop's capture begins.
    try:
        with torch.cuda.stream(side), checking_contract():
            warm()
    except Exception:
        counters.restore(before)
        raise
    torch.cuda.current_stream(device).wait_stream(side)
    graph, pools, counts = torch.cuda.CUDAGraph(), [], LoopCounts()
    start = counters.snapshot()
    stream = torch.cuda.current_stream(device)
    # A collection during the capture could free an earlier graph or pool
    # kept alive by a reference cycle, which the runtime refuses while a
    # stream captures: collect first, and hold the collector off until the
    # capture ends.
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            program(pools, counts)
    except Exception as exc:
        abandon_capture(graph, stream)
        counters.restore(before)
        named = contract_error(exc)
        if named is None or named is exc:
            raise
        raise CaptureContractError(str(named)) from exc
    finally:
        if collecting:
            gc.enable()
    counts.close(counters.difference(counters.snapshot(), start))
    counters.restore(before)
    return graph, pools, counts


def contract_error(exc):
    """The :class:`~mdtpu_torch.potentials.base.CaptureContractError` in
    the chain of ``exc`` (a failed capture raises again on its way out, so
    the potential's error may sit in the context of a later one), or
    None."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        if isinstance(exc, CaptureContractError):
            return exc
        seen.add(id(exc))
        exc = exc.__cause__ or exc.__context__
    return None


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
    graph whose WHILE node loops the step (the rebuild in an IF node nested
    in its body) while the step counter is below the segment's end, and a
    segment is one graph launch a variant and no host read; ``census[name]``
    holds the nodes of one step, read from the WHILE node's body at its
    capture
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
        self._pools = self._counts = None

    # -- what a subclass gives -------------------------------------------

    def _test(self, b, flag, handle):
        raise NotImplementedError

    def _rebuilt(self, b):
        raise NotImplementedError

    def _step(self, b, step_fn, refresh):
        raise NotImplementedError

    # -- buffers and segment inputs --------------------------------------

    def _load(self, state):
        """Put ``state`` into the buffers (made anew, and the graphs
        dropped, where its layout, seed or nf changed)."""
        if self.bufs is None or layout(self.bufs) != layout(state):
            device = state.device
            self.graphs = {}
            self.bufs = clone(state, torch.full(
                (), state.step, dtype=torch.int64, device=device))
            self.base = torch.zeros((), dtype=torch.int64, device=device)
            self.flag = torch.zeros((), dtype=torch.bool, device=device)
            self.rebuilds = torch.zeros((), dtype=torch.int64, device=device)
            self.rebuilt_at = torch.zeros(REBUILD_LOG, dtype=torch.int64,
                                          device=device)
            self.end = torch.zeros((), dtype=torch.int64, device=device)
            self.going = torch.zeros((), dtype=torch.bool, device=device)
        else:
            copy_into(self.bufs, state, skip=("step",))
            self.bufs.step.fill_(state.step)
        self.base.fill_(state.step)
        self._at = state.step

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
        with noting(self._counts, "if"):
            b = self.bufs
            copy_into(b, self._rebuilt(b))
            slot = self.rebuilds.clamp(max=REBUILD_LOG - 1).reshape(1)
            self.rebuilt_at.index_copy_(0, slot, b.step.reshape(1))
            self.rebuilds.add_(1)

    def _refresh(self):
        """The drift test and, where it is set, the rebuild, on the
        buffers."""
        device_if(self.flag,
                  lambda handle: self._test(self.bufs, self.flag, handle),
                  self._rebuild, self._pools)

    def _one(self, step_fn):
        self._step(self.bufs, step_fn, self._refresh)

    # -- graphs ----------------------------------------------------------

    def _loop_test(self, handle):
        """The segment's loop test: the step counter below the segment's
        end, into ``going`` and the WHILE node's handle."""
        philox_draws.step_below(self.bufs.step, self.end, self.going, handle)

    def _captured(self, name, step_fn):
        """``(graph, counts, pools)`` of one step variant: a segment of it
        captured on first use, a WHILE node looping the step while the step
        counter is below :attr:`end` (the rebuild's IF node nested in its
        body), after a warm-up of the step, the rebuild and the loop test on
        copies of the buffers (libraries built, plans made); ``counts``:
        its :class:`LoopCounts`."""
        if name in self.graphs:
            return self.graphs[name]
        b = clone(self.bufs, self.bufs.step.clone())
        flag = torch.empty_like(self.flag)

        def warm():
            self._test(b, flag, None)
            copy_into(b, self._rebuilt(b))

        def warm_step():
            self._step(b, step_fn, warm)
            philox_draws.step_below(b.step, self.end.clone(), flag)

        def body(handle):
            with noting(self._counts, "loop"):
                self._one(step_fn)
                # The census of one step: the WHILE node's body so far.
                self.census[name] = {
                    **philox_draws.capture_census(self.bufs.device),
                    **verlet_update.capture_census(self.bufs.device)}
                self._loop_test(handle)

        def program(pools, counts):
            self._pools, self._counts = pools, counts
            device_while(self.going, self._loop_test, body, pools)

        try:
            self.graphs[name] = capture(self.bufs.device, warm_step,
                                        program)
        finally:
            self._pools = self._counts = None
        return self.graphs[name]

    def _run(self, name, step_fn, times):
        """``times`` steps of ``step_fn`` from the buffers: eagerly step by
        step; on the card one launch of the variant's graph, its WHILE
        node running the steps up to the segment's end (the rebuilds' counts
        from the device's tally)."""
        if times <= 0:
            return
        if not self.graph:
            for _ in range(times):
                self._one(step_fn)
            self._at += times
            return
        graph, _, counts = self._captured(name, step_fn)
        first = self.rebuilds.clone() if counts.per_if else None
        self.end.fill_(self._at + times)
        graph.replay()
        self._at += times
        counts.add(times, 0 if first is None else (first,
                                                   self.rebuilds.clone()))

    def _resolve_graph(self, state):
        """Settle ``graph`` for ``state`` (:func:`settle_graph`)."""
        self.graph = settle_graph(self.graph, state.device)

    def rebuild_steps(self):
        """The steps in which this advance rebuilt, in order (the first
        :data:`REBUILD_LOG`; a host read)."""
        n = int(self.rebuilds)
        return self.rebuilt_at[:min(n, REBUILD_LOG)].tolist()
