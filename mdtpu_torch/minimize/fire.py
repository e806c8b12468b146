"""FIRE (Fast Inertial Relaxation Engine) energy minimizer.

Counterpart of ``mdtpu/minimize/fire.py``: the defaults of the reference's
code (f_inc 1.2, f_dec 0.2, dt in [0.01, 0.1], alpha0 0.1, Nmin 5, tol 1e-6
on the RMS force |F| / sqrt(ndof), ndof = d (N - 1)), a per-particle
displacement cap ``dmax``, velocities reset to true zeros when the power
turns negative, and one return shape ``(state, energy, converged, n_steps)``
whether or not it converged.

A cell-grid engine runs FIRE in the slot layout (:func:`make_slot_fire`, as
the dynamics' slot loop: no scatter or gather per force evaluation, the wrap
deferred to rebuilds, the lean sweep inside the loop and one full sweep at
exit); other engines run it in particle order (:func:`_fire_once`). As the
JAX package runs the whole minimization as one device program, so here
(:class:`DeviceFire`): FIRE's scalars, the step, the force test, the rebin
decision and the sticky overflow flag live in device buffers, an iteration
is the kernels of :mod:`mdtpu_torch.minimize.fire_update` around the sweep,
and on the card the whole minimization is one CUDA graph launch, a WHILE
node looping the iteration with the rebuild in an IF node nested in it; the
result costs one host read at the end. The graph is captured once for each
engine, layout and set of hyper-parameters (``max_steps`` and ``tol`` are
device values) and reused across calls; a grown-capacity retry, whose
engine serves one run, runs eagerly and is not kept. A potential without a
kernel functor is captured too, its ``evaluate_r2`` in the WHILE node's
body (the capture contract of :mod:`mdtpu_torch.potentials.base`). On the
CPU and with ``graph=False`` the same code runs eagerly, reading the
loop's flags on the host once an iteration (particle order: once more
where the engine tests for a rebuild). The sharded FIRE is the same
program over a shard ring, its reductions and test split where the JAX
package has ``pmax``/``psum``, the ring's all-reduces between, captured
like the rest on the card.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from mdtpu_torch.core.types import Parameters, SimulationState
from mdtpu_torch.integrate import slot_step as slots
from mdtpu_torch.integrate.device_advance import (REBUILD_LOG, capture,
                                                  capturing, clone, copy_into,
                                                  device_if, device_while,
                                                  layout, noting,
                                                  settle_graph)
from mdtpu_torch.minimize import fire_update as fu
from mdtpu_torch.ops import philox_draws
from mdtpu_torch.utils import counters
from mdtpu_torch.utils.device import resolve_device

# Minimizations kept captured (engine, layout, hyper-parameters), the last
# used kept longest; a grown-capacity retry's is not kept.
CACHE_SIZE = 4
_CACHE: "collections.OrderedDict" = collections.OrderedDict()


def fire_minimize(state: SimulationState, params: Parameters, engine, *,
                  max_steps: int = 10000, tol: float = 1e-6,
                  dt_initial: float = 0.01, dt_max: float = 0.1,
                  alpha0: float = 0.1, f_inc: float = 1.2, f_dec: float = 0.2,
                  n_min: int = 5, dmax: float = 0.1, device=None,
                  graph=None):
    """Minimize the potential energy of ``state``. Returns ``(new_state,
    energy, converged, n_steps)``. ``device``: where it runs, ``"cuda"`` by
    default (raises without a card unless the caller passes ``"cpu"``).
    ``graph``: None runs each minimization as one CUDA graph launch on the
    card (any potential) and eagerly on the CPU; False eagerly on the card
    too; True asks for the graph (raises on the CPU).

    Engine capacity overflow would truncate forces and let the force test
    converge on a configuration that still has contacts: the run is retried
    from the start with a grown capacity until the overflow flag clears."""
    from mdtpu_torch.core.types import state_to

    state = state_to(state, resolve_device(device))
    hyper = dict(max_steps=max_steps, tol=tol, dt_initial=dt_initial,
                 dt_max=dt_max, alpha0=alpha0, f_inc=f_inc, f_dec=f_dec,
                 n_min=n_min, dmax=dmax, graph=graph)
    if getattr(engine, "runs_in_slots", False):
        return _fire_slots_with_retries(state, params, engine, **hyper)
    caller_engine = engine
    grew = False
    for _ in range(slots.MAX_GROWS):
        out = make_row_fire(engine, **(_retried(hyper) if grew else hyper))(
            state)
        new_state = out[0]
        over = getattr(new_state.nbrs, "overflow", None)
        grow = getattr(engine, "with_grown_capacity", None)
        if over is None or not bool(over) or grow is None:
            if grew:
                # The state's engine state must match the caller's engine.
                nbrs = caller_engine.allocate(
                    new_state.positions, new_state.diameters,
                    new_state.unitcell, new_state.unitcell_inv)
                return (new_state.replace(nbrs=nbrs),) + tuple(out[1:])
            return out
        grew = True
        engine = grow()
        state = state.replace(nbrs=None)
    raise RuntimeError(
        "engine capacity still overflowing after 8 grows during FIRE "
        "minimization: forces would be silently truncated")


def _retried(hyper):
    """A grown-capacity retry's settings: its run is not cached (its engine
    serves this one run) and, unless the caller asked for the graph, eager
    (no capture for one replay)."""
    graph = hyper["graph"]
    return dict(hyper, graph=False if graph is None else graph, cached=False)


class DeviceFire:
    """FIRE's whole minimization on buffers on one device, as the JAX
    package runs it as one device program.

    The state is copied into buffers (:func:`~mdtpu_torch.integrate.
    device_advance.clone`), FIRE's scalars and counters into the buffers of
    :func:`fire_update.buffers`, and :meth:`_program` runs the
    minimization on them: the entry sweep and test, a loop
    (:func:`~mdtpu_torch.integrate.device_advance.device_while`) of
    :func:`fire_update.fire_reduce`, :func:`fire_update.fire_move`, the
    sweep and :func:`fire_update.fire_test`, the rebuild inside
    :func:`~mdtpu_torch.integrate.device_advance.device_if`. ``graph``
    (settled by :func:`~mdtpu_torch.integrate.device_advance.
    settle_graph`, as the advances settle it): on the card the program is
    captured once into a CUDA graph (after a warm-up of it on copies of the
    buffers) and each call is one
    replay and one host read of the counters; eagerly it runs as written,
    the loop's flags read on the host. ``census`` holds the captured
    graph's top-level nodes (``"graph"``) and the WHILE node's body
    (``"pass"``), with the programmatic edges into FIRE's reductions. A
    subclass gives the layout: :meth:`_program` and :meth:`_rebuilt`."""

    def __init__(self, engine, hyper: fu.FireHyper, graph):
        self.engine, self.hyper, self.graph = engine, hyper, graph
        self.bufs = None
        self.captured = None
        self.census = {}
        self._counts = None

    # -- what a subclass gives -------------------------------------------

    def _program(self, b, x, warm=False):
        raise NotImplementedError

    def _rebuilt(self, b):
        raise NotImplementedError

    # -- buffers ---------------------------------------------------------

    def _load(self, state):
        """Put ``state`` into the buffers (made anew, and the graph dropped,
        where its layout changed)."""
        if self.bufs is None or layout(self.bufs[0]) != layout(state):
            b = clone(state)
            n = b.forces.numel()
            scal, ints, red, work, flags = fu.buffers(b.dtype, b.device, n)
            self.bufs = (b, _Scratch(
                scal=scal, ints=ints, red=red, work=work, flags=flags,
                drift=torch.zeros((), dtype=torch.bool, device=b.device),
                v=torch.zeros_like(b.positions),
                rebuilt_at=torch.zeros(REBUILD_LOG, dtype=torch.int64,
                                       device=b.device),
                sqrt_ndof=float(self._ndof(state)) ** 0.5, pools=None))
            self.captured = None
        else:
            copy_into(self.bufs[0], state)

    def _ndof(self, state):
        return state.nf

    def _inputs(self, x, max_steps, tol):
        """FIRE's starting scalars and the call's ``max_steps`` and ``tol``,
        copied into the buffers ahead of the program (on the card from
        pinned memory, without a synchronisation; the last run's copies
        ended before its result was read)."""
        h = self.hyper
        pinned = x.scal.is_cuda
        scal = torch.zeros(fu.SCAL, dtype=x.scal.dtype, pin_memory=pinned)
        scal[fu.DT], scal[fu.ALPHA], scal[fu.TOL] = h.dt_initial, h.alpha0, tol
        ints = torch.zeros(fu.INTS, dtype=torch.int64, pin_memory=pinned)
        ints[fu.MAX_STEPS] = max_steps
        x.scal.copy_(scal, non_blocking=pinned)
        x.ints.copy_(ints, non_blocking=pinned)
        # The host tensors live until the copies ran.
        x.staged = (scal, ints)

    def _rebuild(self, b, x):
        """The rebuild on the buffers, its step logged and counted (under
        capture, its launch counts noted)."""
        with noting(self._counts, "if"):
            copy_into(b, self._rebuilt(b))
            n = x.ints[fu.REBINS:fu.REBINS + 1]
            x.rebuilt_at.index_copy_(0, n.clamp(max=REBUILD_LOG - 1),
                                     x.ints[fu.STEP:fu.STEP + 1])
            n.add_(1)

    def _pass(self, fn):
        """``fn``, the loop's body, with its launch counts and, under
        capture, the census of the WHILE node's body noted."""
        def body(handle):
            with noting(self._counts, "loop"):
                going = fn(handle)
                if capturing(self.bufs[0].device):
                    self.census["pass"] = _census(self.bufs[0].device)
            return going
        return body

    # -- the loop's parts ------------------------------------------------

    def _reduce(self, v, b, x, overflow):
        fu.fire_reduce(v, b.forces, x.scal, x.ints, x.red[:fu.RED], x.work,
                       self.hyper, overflow)

    def _test(self, b, x, handle, entry, overflow=None, drift=None,
              then=None):
        """The force test into the flags (and under capture ``handle``, the
        WHILE node's, and ``then``, an IF node's)."""
        fu.fire_test(b.forces, x.scal, x.ints, x.red[fu.RED:], x.work,
                     x.sqrt_ndof, x.flags, overflow=overflow, drift=drift,
                     entry=entry, handle=handle, handle_then=then)

    # -- capture and run -------------------------------------------------

    def _capture(self):
        """The program captured into a CUDA graph, after a warm-up of it on
        copies of the buffers (libraries built, plans made; one pass, a
        rebuild at each test): ``captured`` is ``(graph, pools, counts)``,
        ``counts`` the :class:`~mdtpu_torch.integrate.device_advance.
        LoopCounts` a replay adds by its passes and rebuilds."""
        b, x = self.bufs
        wb = clone(b)
        wx = dataclasses.replace(x, **{
            k: getattr(x, k).clone() for k in ("scal", "ints", "red", "work",
                                               "flags", "drift", "v",
                                               "rebuilt_at")})

        def program(pools, counts):
            x.pools, self._counts = pools, counts
            self._program(b, x)
            self.census["graph"] = _census(b.device)

        try:
            self.captured = capture(b.device, lambda: self._program(
                wb, wx, warm=True), program)
        finally:
            x.pools = self._counts = None

    def run(self, state: SimulationState, max_steps, tol):
        """The minimization from ``state``: ``(buffers' state, f_rms (0-d),
        converged, n_steps, overflow, rebuilds)`` (host values but f_rms);
        one host read of the counters at the end."""
        graph = self._settle(state)
        self._load(state)
        b, x = self.bufs
        self._inputs(x, max_steps, tol)
        if graph:
            if self.captured is None:
                self._capture()
            self.captured[0].replay()
        else:
            self._program(b, x)
        ints = x.ints.tolist()
        if graph:
            self.captured[2].add(ints[fu.PASSES], ints[fu.REBINS])
        return (b, x.scal[fu.FRMS].clone(), bool(ints[fu.CONVERGED]),
                ints[fu.STEP], bool(ints[fu.OVERFLOW]), ints[fu.REBINS])

    def _settle(self, state):
        """Whether a run from ``state`` is captured
        (:func:`~mdtpu_torch.integrate.device_advance.settle_graph`)."""
        return settle_graph(self.graph, state.device)

    def rebuild_steps(self):
        """The steps after which the last run rebuilt (a host read)."""
        x = self.bufs[1]
        n = int(x.ints[fu.REBINS])
        return x.rebuilt_at[:min(n, REBUILD_LOG)].tolist()


def _census(device):
    """The graph being captured: its nodes (``philox_draws.capture_census``)
    and the programmatic edges into FIRE's reductions
    (``fire_update.capture_census``)."""
    return {**philox_draws.capture_census(device),
            **fu.capture_census(device)}


@dataclasses.dataclass
class _Scratch:
    """FIRE's device buffers beside the state's (see
    :mod:`mdtpu_torch.minimize.fire_update`); ``v``: FIRE's own velocity in
    particle order; ``drift``: the drift test's flag; ``pools``: the
    conditional bodies' memory pools during a capture."""

    scal: torch.Tensor
    ints: torch.Tensor
    red: torch.Tensor
    work: torch.Tensor
    flags: torch.Tensor
    drift: torch.Tensor
    v: torch.Tensor
    rebuilt_at: torch.Tensor
    sqrt_ndof: float
    pools: object
    staged: object = None


class SlotFire(DeviceFire):
    """FIRE over a slot-layout state (``velocities`` carry FIRE's own
    velocity; vacant slots hold zeros and never move, so every reduction is
    exact), as the JAX package's ``make_slot_fire`` nests it: a rebin on
    entry (where the loop runs), then iterations, each followed by a rebin
    where the drift test fired and the loop goes on; an overflow after a
    rebin ends the loop before any further step (the kernels leave the
    state alone and the test counts no step). Inside the loop the sweep is
    lean; one full sweep at exit refreshes energy and virial; a sweep's
    overflow (the pair list's) joins the state's flag.

    ``ring``: the shard ring of a sharded state (the engine a
    :class:`mdtpu_torch.parallel.HaloSlotEngine`), as the JAX package runs
    ``make_slot_fire`` under one ``shard_map``: the reduction and the test
    each run as their maxima, the ring's maximum, their sums, the ring's
    sum and their tail (:data:`fire_update.MAXIMA`, ``SUMS``, ``TAIL``).
    The state's overflow flag rides in both maxima's all-reduces and the
    drift test's flag in the test's, so the kernels, the loop and the
    rebuild's IF node read the ring's flags and every rank replays the
    same collectives: two all-reduces a reduction, two a test."""

    def __init__(self, engine, hyper, graph, ring=None):
        super().__init__(engine, hyper, graph)
        self.ring = ring

    def _rebuilt(self, b):
        return slots._engine_rebin(b, self.engine)

    def _sweep(self, b, observables):
        nbrs = slots._sweep_in(
            self.engine, b.positions, b.diameters, b.unitcell,
            b.unitcell_inv, b.nbrs, observables, out=b.forces,
            scalars_out=(b.energy, b.virial) if observables else None)[3]
        if nbrs.overflow is not b.nbrs.overflow:
            b.nbrs.overflow.copy_(nbrs.overflow)

    def _reduce(self, v, b, x, overflow):
        if self.ring is None:
            return super()._reduce(v, b, x, overflow)
        red = x.red[:fu.RED]
        args = (v, b.forces, x.scal, x.ints, red, x.work, self.hyper)
        fu.fire_reduce(*args, mode=fu.MAXIMA)
        # The overflow flag rides in the sums' first value, which the sums
        # then write.
        _vote(self.ring, red, {fu.SUM_AB: overflow})
        fu.fire_reduce(*args, overflow, mode=fu.SUMS)
        self.ring.sum_(red[fu.SUM_AB:])
        fu.fire_reduce(*args, overflow, mode=fu.TAIL)

    def _test(self, b, x, handle, entry, overflow=None, drift=None,
              then=None):
        if self.ring is None:
            return super()._test(b, x, handle, entry, overflow, drift, then)
        red = x.red[fu.RED:]
        args = (b.forces, x.scal, x.ints, red, x.work, x.sqrt_ndof, x.flags)
        fu.fire_test(*args, mode=fu.MAXIMA)
        # The flags ride in two values the test does not use.
        _vote(self.ring, red, {fu.SUM_AB: overflow, fu.MAX_A: drift})
        fu.fire_test(*args, overflow=overflow, mode=fu.SUMS)
        self.ring.sum_(red[fu.SUM_BB:])
        fu.fire_test(*args, overflow=overflow, drift=drift, entry=entry,
                     mode=fu.TAIL, handle=handle, handle_then=then)

    def _program(self, b, x, warm=False):
        ovf = b.nbrs.overflow
        b.velocities.zero_()
        if b.vel_comp is not None:
            b.vel_comp.zero_()
        self._sweep(b, True)

        def tested(handle, entry):
            """The test, then the rebin where the loop goes on and (past the
            entry) the drift test fired (the warm-up rebins at each).
            Eagerly one host read of both flags; returns whether the loop
            goes on."""
            drift = None if entry else x.drift
            if handle is not None:
                device_if(x.flags[1], lambda then: self._test(
                    b, x, handle, entry, ovf, drift, then),
                    lambda: self._rebuild(b, x), x.pools)
                return None
            self._test(b, x, None, entry, ovf, drift)
            going, then = x.flags.tolist()
            if then or warm:
                self._rebuild(b, x)
            return going and not warm

        def body(handle):
            self._reduce(b.velocities, b, x, ovf)
            fu.fire_move(b.positions, b.velocities, b.forces, x.scal, x.ints,
                         self.hyper.dmax, rows=False, overflow=ovf)
            self._sweep(b, False)
            philox_draws.rebuild_flag(b.positions, b.nbrs.ref_positions,
                                      self.engine.skin, out=x.drift)
            return tested(handle, entry=False)

        body = self._pass(body)
        if warm:
            tested(None, True)
            body(None)
        else:
            device_while(x.flags[0], lambda handle: tested(handle, True),
                         body, x.pools)
        self._sweep(b, True)


def _vote(ring, red, flags):
    """The ring's maximum of ``red[:3]``, with each 0-d bool flag of
    ``flags`` (by its place in ``red``; None: none there) put in first and
    set after from the ring's value: true where any rank's is."""
    for i, flag in flags.items():
        if flag is not None:
            red[i].copy_(flag)
    ring.max_(red[:fu.SUM_AB + 1])
    for i, flag in flags.items():
        if flag is not None:
            torch.gt(red[i], 0, out=flag)


class RowFire(DeviceFire):
    """FIRE over ``(N, d)`` particle rows (``_fire_once``: the naive engine,
    the neighbour list, ``PlaneEngine``), as the JAX package's one
    ``while_loop``: each force evaluation tests for a rebuild first (the
    engine's ``needs_rebuild`` setting an IF node's handle, ``allocate``
    inside it; the naive engine's static ``False`` makes no test); the move
    wraps into the box. The caller's velocities are left alone: FIRE's own
    is a buffer of its own."""

    def __init__(self, engine, hyper, graph):
        super().__init__(engine, hyper, graph)
        self._untested = None

    def _ndof(self, state):
        return state.dimension * (state.n_particles - 1.0)

    def _load(self, state):
        if self._untested is None:
            before = counters.snapshot()
            self._untested = self.engine.needs_rebuild(
                state.positions, state.nbrs, state.unitcell,
                state.unitcell_inv) is False
            counters.restore(before)
        super()._load(state)

    def _rebuilt(self, b):
        fresh = self.engine.allocate(b.positions, b.diameters, b.unitcell,
                                     b.unitcell_inv)
        return b.replace(nbrs=dataclasses.replace(
            fresh, overflow=fresh.overflow | b.nbrs.overflow))

    def _forces(self, b, x, warm):
        """The engine's drift test and rebuild (the warm-up rebuilds each
        time), then its forces, energy and virial into the buffers."""
        if warm and not self._untested:
            self._rebuild(b, x)
        elif not self._untested:
            device_if(x.drift, lambda handle: self.engine.needs_rebuild(
                b.positions, b.nbrs, b.unitcell, b.unitcell_inv,
                out=x.drift, handle=handle),
                lambda: self._rebuild(b, x), x.pools)
        e, w, f, _ = self.engine.compute(b.positions, b.diameters, b.unitcell,
                                         b.unitcell_inv, b.nbrs)
        copy_into(b, b.replace(forces=f, energy=e, virial=w))

    def _program(self, b, x, warm=False):
        x.v.zero_()
        self._forces(b, x, warm)

        def test(handle, entry):
            self._test(b, x, handle, entry)
            return None if handle is not None else (
                bool(x.flags[0]) and not warm)

        def body(handle):
            self._reduce(x.v, b, x, None)
            fu.fire_move(b.positions, x.v, b.forces, x.scal, x.ints,
                         self.hyper.dmax, rows=True, images=b.images,
                         cell=b.unitcell, cell_inv=b.unitcell_inv)
            self._forces(b, x, warm)
            return test(handle, entry=False)

        body = self._pass(body)
        if warm:
            test(None, True)
            body(None)
        else:
            device_while(x.flags[0], lambda handle: test(handle, True), body,
                         x.pools)


def _device_fire(kind, engine, hyper, graph, cached, ring=None):
    """The :class:`DeviceFire` of ``kind`` (:class:`SlotFire`, over
    ``ring`` where given, or :class:`RowFire`) for ``engine`` and
    ``hyper``: where ``cached``, the one kept for ``engine`` (by value, as
    the JAX package caches its program; by identity where the engine does
    not hash), ``hyper``, ``graph`` and the ring (by identity), made on
    first use (at most :data:`CACHE_SIZE` are kept); else one of its
    own."""
    def make():
        return (SlotFire(engine, hyper, graph, ring) if kind == "slots"
                else RowFire(engine, hyper, graph))

    if not cached:
        return make()
    try:
        key = (kind, engine, hyper, graph, ring)
        fire = _CACHE.get(key)
    except (TypeError, RuntimeError):
        key = (kind, id(engine), hyper, graph, ring)
        fire = _CACHE.get(key)
    if fire is None:
        fire = _CACHE[key] = make()
    _CACHE.move_to_end(key)
    while len(_CACHE) > CACHE_SIZE:
        _CACHE.popitem(last=False)
    return fire


def make_row_fire(engine, *, max_steps=10000, tol=1e-6, dt_initial=0.01,
                  dt_max=0.1, alpha0=0.1, f_inc=1.2, f_dec=0.2, n_min=5,
                  dmax=0.1, graph=None, cached=True):
    """``run(state) -> (state, energy, converged, n_steps)``: the whole
    minimization in particle order (:class:`RowFire`; on the card one graph
    launch), the state's velocities the caller's; ``run.fire`` the
    :class:`RowFire`, kept for the next call of the same engine and
    hyper-parameters unless ``cached`` is False."""
    hyper = fu.FireHyper(dt_initial=dt_initial, dt_max=dt_max, alpha0=alpha0,
                         f_inc=f_inc, f_dec=f_dec, n_min=n_min, dmax=dmax)
    fire = _device_fire("rows", engine, hyper, graph, cached)

    def run(state):
        if state.nbrs is None:
            state = state.replace(nbrs=engine.allocate(
                state.positions, state.diameters, state.unitcell,
                state.unitcell_inv))
        b, _, converged, n_steps, _, _ = fire.run(state, max_steps, tol)
        out = clone(b, state.step).replace(velocities=state.velocities)
        return out, out.energy, converged, n_steps

    run.fire = fire
    return run


def _fire_once(state: SimulationState, params: Parameters, engine, *,
               max_steps, tol, dt_initial, dt_max, alpha0, f_inc, f_dec,
               n_min, dmax, graph=None):
    """FIRE in particle order (:func:`make_row_fire`). Returns ``(state,
    energy, converged, n_steps)``, the state's velocities the caller's."""
    return make_row_fire(engine, max_steps=max_steps, tol=tol,
                         dt_initial=dt_initial, dt_max=dt_max, alpha0=alpha0,
                         f_inc=f_inc, f_dec=f_dec, n_min=n_min, dmax=dmax,
                         graph=graph)(state)


# --------------------------------------------------------------- slot space


def make_slot_fire(engine, *, max_steps=10000, tol=1e-6, dt_initial=0.01,
                   dt_max=0.1, alpha0=0.1, f_inc=1.2, f_dec=0.2, n_min=5,
                   dmax=0.1, ring=None, graph=None, cached=True):
    """``run(slot_state) -> (slot_state, f_rms, converged, n_steps,
    overflow)``: the whole minimization over a slot-layout state, whose
    ``velocities`` carry FIRE's own velocity (:class:`SlotFire`; on the
    card one graph launch; ``run.fire`` the :class:`SlotFire`, kept for the
    next call of the same engine and hyper-parameters unless ``cached`` is
    False). ``overflow`` is sticky: a True run must be retried from the
    original state at a grown capacity (an overflowed rebin drops rows).

    ``ring``: the shard ring of a sharded state (the engine a
    :class:`mdtpu_torch.parallel.HaloSlotEngine`, whose rebuild migrates
    rows), the :class:`SlotFire` over it: on the card one graph launch
    too, the ring's all-reduces inside."""
    hyper = fu.FireHyper(dt_initial=dt_initial, dt_max=dt_max, alpha0=alpha0,
                         f_inc=f_inc, f_dec=f_dec, n_min=n_min, dmax=dmax)
    fire = _device_fire("slots", engine, hyper, graph, cached, ring)

    def run(state):
        b, f_rms, converged, n_steps, ovf, _ = fire.run(state, max_steps, tol)
        return clone(b, state.step), f_rms, converged, n_steps, ovf

    run.fire = fire
    return run


def fire_minimize_slots(state: SimulationState, engine, **hyper):
    """FIRE over an already slotified state. Returns ``(slot_state, f_rms,
    converged, n_steps, overflow)``; the state's ``velocities`` hold FIRE's
    own velocity."""
    return make_slot_fire(engine, **hyper)(state)


def _fire_slots_with_retries(state, params, engine, **hyper):
    """Particle order in and out over the slot FIRE: slotify, run,
    unslotify, restore the caller's velocities. On capacity overflow
    (initial binning or a rebin in the loop) retry from the original state
    at a grown capacity."""
    velocities0 = state.velocities
    start = state.replace(nbrs=None)
    for attempt in range(slots.MAX_GROWS):
        slot_state, engine = slots.slotify_grown(start, engine)
        slot_state, _, converged, n_steps, ovf = fire_minimize_slots(
            slot_state, engine, **(_retried(hyper) if attempt else hyper))
        if not ovf:
            out = slots.unslotify_state(slot_state)
            out = out.replace(velocities=velocities0)
            return out, out.energy, converged, n_steps
        engine = engine.with_grown_capacity()
    raise RuntimeError(
        "engine capacity still overflowing after 8 grows during FIRE "
        "minimization: forces would be silently truncated")


def fire_minimize_sharded(state: SimulationState, params: Parameters,
                          engine=None, group=None, *, device=None, **hyper):
    """FIRE over the ranks of a shard ring, the counterpart of the JAX
    package's ``fire_minimize_sharded``: ``state`` is an ``(N, d)``
    particle-order state (the same on every rank), ``engine`` a
    :class:`mdtpu_torch.parallel.HaloSlotEngine` (default: one made over
    the ring of ``group`` and ``device``, as ``run_simulation_sharded``
    makes it). The slot FIRE of :func:`make_slot_fire` runs on each rank's
    slab with the ring's reductions. Returns ``(state, energy, converged,
    n_steps)`` in particle order on every rank, with the caller's
    velocities; on a capacity or migration overflow the run is retried from
    the start on a grown engine. ``graph`` as in :func:`fire_minimize`: on
    the card each minimization is one CUDA graph launch, the ring's
    all-reduces captured inside, for any potential (True raises on the
    CPU)."""
    from mdtpu_torch.core.types import state_to
    from mdtpu_torch.parallel.driver import build_grown, sharded_engine
    from mdtpu_torch.parallel.halo_slot import unshard_slot_state

    hyper.setdefault("graph", None)
    engine = sharded_engine(state, params.potential, engine, group, device)
    ring = engine.ring
    start = state_to(state.replace(nbrs=None, ids=None), ring.device)
    velocities0 = start.velocities
    for attempt in range(slots.MAX_GROWS):
        sh, engine = build_grown(start, engine)
        sh, _, converged, n_steps, ovf = make_slot_fire(
            engine, ring=ring, **(_retried(hyper) if attempt else hyper))(sh)
        if not ovf:
            out = unshard_slot_state(sh, ring).replace(velocities=velocities0)
            return out, out.energy, converged, n_steps
        engine = engine.with_grown_capacity()
    raise RuntimeError(
        "engine capacity still overflowing after 8 grows during sharded "
        "FIRE minimization: forces would be silently truncated")
