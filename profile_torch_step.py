#!/usr/bin/env python3
"""Where the time of one step goes in the PyTorch/CUDA port, on one GPU.

    python3 profile_torch_step.py [--engine cellgrid|plane|slot|neighbor|sharded]
                                  [--potential lj|user] [--brownian] [--eager]
                                  [--plain-launch]
                                  [--tree DIR]

Builds the bench configuration (N = 65,536 Lennard-Jones, rho 0.8, r_c 2.5,
f32, NVT(1.0, 0.4), dt 0.002), melts it for 300 steps through
``mdtpu_torch.run_simulation``, then times the bare step function with the
host clock and profiles 50 steps with ``torch.profiler``. ``--engine
cellgrid`` (the default) steps the cell-grid engine in particle order
with Kahan compensation; ``--engine plane`` steps ``PlaneEngine`` (the
Newton half-stencil sweep) with ``compensated=False``, as the JAX package
drives its B2 kernel; ``--engine neighbor`` steps ``NeighborListEngine``
(``select_engine(..., prefer="neighbor")``) in particle order with Kahan
compensation. These three step as ``run_simulation`` does in particle
order: ``make_particle_advance`` over one segment of the timed or
profiled length, each step one CUDA-graph launch with the rebuild decided
on the device (its nodes under ``step_graph_nodes``), or with ``--eager``
the same steps launched one by one with the rebuild flag read on the host
every step; a tree whose package has no particle advance steps its
``make_step`` in a Python loop (its rebuilds not counted). ``--engine
slot`` steps the slot
layout as ``run_simulation`` does on the cell grid: ``make_slot_advance``
over one segment of the timed or profiled length (its lean inner steps, the
rebuilds that come due, one full step at the end; each step one CUDA-graph
launch with the rebuild decided on the device, or with ``--eager`` the same
steps launched one by one with the rebuild flag read on the host every
step), and reports the rebuilds in each window, then does the same for an
NVE segment from the NVT end (on the hi/lo sweep, as ``run_simulation``
takes float32 NVE; its numbers under ``"nve"``), each captured route with
the nodes of its step graphs (``SlotAdvance.census``); ``--engine sharded``
steps the same through ``HaloSlotEngine`` on a one-rank NCCL group (a file
store in a temporary directory), as ``run_simulation_sharded`` does
(``make_sharded_slot_advance``: the slab's ghost exchange and launch, the
all-reduced flags and sums, a rebuild, with its migration, at the start of
each window, after every step the ring's vote flagged and before its last
step; captured, each segment one graph launch a step variant, the ring's
all-reduces inside, or with ``--eager`` launched step by step, the vote
read on the host every lean step; the nodes of its step graphs under
``step_graph_nodes``; a tree whose sharded advance is a host loop steps
that loop, its rebuilds counted at each call). Prints one JSON line: ms per step,
device busy time per step and the device's idle share over the profiled
window, CUDA kernel launches, CUDA-graph launches and host synchronisations
per step (stream and event synchronisations: each read of a tensor on the
host is one; the window's own closing ``torch.cuda.synchronize`` is counted
apart), the kernels, memsets and copies the device ran per step (under
graph replay, the step graph's nodes of those kinds), the host's own time
to issue a window's steps, the device's span of the timed window by CUDA
events (from its first work to its last, the gaps inside included), and
the kernels that take the most device time. Where a captured segment
loops its step inside a WHILE node (``route`` ``graph`` in a package
with ``philox_draws.graph_while``), ``torch.profiler`` does not see the
kernels inside the node: the device busy time, the idle shares, the
kernels, memsets and copies and the top kernels are then null, and the
kernels a step runs come from the step graphs' census instead
(``device_kernels_per_step_census``: each variant's WHILE-body kernel
nodes times the steps it runs in a segment, and the loop test; the
rebuilds' IF bodies not counted); ``device_idle_share_outside_span``,
one less the span over the wall time, is then the least the idle share
can be. For ``sharded`` also the host ms of the step's own parts alone
(``sharded_parts``: the rebuild flag's all-reduce and read, a scalar
all-reduce, the ghost exchange and assembly).
``--brownian`` (with ``slot`` or ``plane``, the latter compensated as
``chip_smoke.py``'s Brownian path runs it) steps ``chip_smoke.py``'s
Brownian system instead (65,536 pseudo-hard spheres at rho 0.5, f32,
Brownian(1.0), dt 1e-5, from its jittered lattice, no melt) and no NVE
segment.
``--potential user`` (with ``slot`` or ``sharded``) takes BASELINE config 4
instead, as ``chip_smoke.py`` builds it (2D, N = 65,536, rho 0.9, diameters
U(0.8, 1.2), a user potential without a kernel functor, so every sweep is
the pair list, f64, NVT(0.5, 0.01), dt 1e-4) on its lattice: captured like
every other route (the user's ``evaluate_r2`` in the WHILE node's body),
``--eager`` launched step by step; with ``slot`` an NVE segment follows
(f64, no hi/lo). The JSON line gives the card's peak memory allocated
(``peak_memory_bytes``: the captured variants keep the potential's
temporaries at the list's capacity in their pools). ``--tree
DIR`` profiles the package of another checkout (``compare_torch_host.py``
times two trees with this one script). ``--plain-launch`` launches the
velocity finish and the Brownian noise in plain stream order, where the
package launches them as programmatic dependents of the kernel before
them (inside ``philox_draws.plain_launch``); the JSON line says which
(``launch``), with the card's name and power limit and the package's
directory. For the velocity finish, the noise and the Brownian update
the profile also gives their device time in the step, the gap before each on the device's
timeline (from the end of the node before it to its start: a programmatic
dependent may start before that node ends) and the time from the end of
that node to the end of each (gap and device time: what the node adds to
the step).
"""

import argparse
import contextlib
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

N = 65536
PROFILED_STEPS = 50


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--engine",
                        choices=("cellgrid", "plane", "slot", "neighbor",
                                 "sharded"),
                        default="cellgrid")
    parser.add_argument("--potential", choices=("lj", "user"), default="lj")
    parser.add_argument("--brownian", action="store_true",
                        help="slot, plane: the Brownian system")
    parser.add_argument("--eager", action="store_true",
                        help="launch each step's kernels one by one")
    parser.add_argument("--tree", help="the checkout whose package to time")
    parser.add_argument("--plain-launch", action="store_true",
                        help="launch the small kernels in plain stream "
                             "order")
    args = parser.parse_args()
    if args.potential == "user" and args.engine not in ("slot", "sharded"):
        parser.error("--potential user takes --engine slot or sharded")
    if args.brownian and (args.engine not in ("slot", "plane")
                          or args.potential != "lj"):
        parser.error("--brownian takes --engine slot or plane and the LJ "
                     "potential")
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: no CUDA device")
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))

    import mdtpu_torch as mt
    if args.tree and not mt.__file__.startswith(os.path.abspath(args.tree)):
        raise SystemExit(f"profile_torch_step: {mt.__file__} is not in "
                         f"{args.tree}")
    from mdtpu_torch.ops import philox_draws
    programmatic = hasattr(philox_draws, "plain_launch")
    plain = args.plain_launch and programmatic
    with philox_draws.plain_launch() if plain else contextlib.nullcontext():
        profile(args, programmatic and not plain)


def profile(args, programmatic):
    """Builds, times and profiles the step ``args`` names and prints its
    JSON line; ``programmatic``: whether the small kernels launch as
    programmatic dependents."""
    import mdtpu_torch as mt
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.integrate import step as step_mod
    from mdtpu_torch.ops import philox_draws
    from mdtpu_torch.ops.experimental import PlaneEngine
    from mdtpu_torch.sim.initialization import lattice_fluid_state

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if args.potential == "user":
        from chip_smoke import CUTOFF_USER, user_lattice
        from mdtpu_torch.sim.initialization import initialize_velocities
        cutoff = CUTOFF_USER
        state, params = user_lattice(mt)
        state = state.replace(velocities=initialize_velocities(
            0.5, 1, N, 2, dtype=torch.float64, device="cuda"))
        ensemble = mt.NVT(0.5, 0.01)
    elif args.brownian:
        from chip_smoke import brownian_state
        cutoff = 1.5
        state = brownian_state()
        params = mt.Parameters(density=0.5, n_particles=N, dt=1e-5,
                               potential=mt.PseudoHS())
        ensemble = mt.Brownian(1.0)
    else:
        cutoff = 2.5
        state = lattice_fluid_state(N, 0.8, 1.0, dtype=torch.float32,
                                    cutoff=cutoff, jitter=0.01,
                                    device="cuda")
        params = mt.Parameters(density=0.8, n_particles=N, dt=0.002,
                               potential=mt.LennardJones(r_cut=cutoff))
        ensemble = mt.NVT(1.0, 0.4)
    engine = mt.select_engine(
        params.potential, cutoff, state,
        prefer="neighbor" if args.engine == "neighbor" else None)
    compensated = args.engine != "plane" or args.brownian
    if args.engine == "plane":
        engine = PlaneEngine.create(params.potential, cutoff, 0.3,
                                    state.unitcell, N)
    if not args.brownian:
        with tempfile.TemporaryDirectory() as d:
            state = mt.run_simulation(state, params, ensemble, 300, 300, d,
                                      engine=engine, compensated=compensated)
    if args.engine == "sharded":
        import torch.distributed as dist
        from mdtpu_torch.parallel import HaloSlotEngine, ShardRing
        from mdtpu_torch.parallel.halo_slot import (
            build_sharded_slot_state, make_sharded_slot_advance)
        store = tempfile.mkdtemp()
        dist.init_process_group("nccl", init_method=f"file://{store}/store",
                                world_size=1, rank=0,
                                device_id=torch.device("cuda", 0))
        engine = HaloSlotEngine.create(params.potential, cutoff,
                                       state.unitcell, N, ShardRing(),
                                       diameters=state.diameters)
        state = build_sharded_slot_state(state.replace(nbrs=None), engine)
        if "graph" in inspect.signature(
                make_sharded_slot_advance).parameters:
            advance = make_sharded_slot_advance(
                params, ensemble, engine,
                graph=False if args.eager else None)
            run, totals = slot_run(advance)
        else:
            # A tree whose sharded advance is a host loop (always eager).
            advance = make_sharded_slot_advance(params, ensemble, engine)
            run, totals = host_loop_run(slot_step, advance)
    elif args.engine == "slot":
        state = slot_step.slot_forces(slot_step.slotify(state, engine),
                                      engine)
        advance = slot_step.make_slot_advance(
            params, ensemble, engine, graph=False if args.eager else None)
        run, totals = slot_run(advance)
    else:
        state = state.replace(nbrs=engine.allocate(
            state.positions, state.diameters, state.unitcell,
            state.unitcell_inv))
        advance = particle_advance(step_mod, params, ensemble, engine,
                                   compensated, args.eager)
        run, totals = slot_run(advance)

    def looped(adv):
        """Whether ``adv``'s segments ran inside a WHILE node (known once
        it ran: ``graph=None`` settles at the first call)."""
        return lambda: (hasattr(philox_draws, "graph_while")
                        and bool(getattr(adv, "graph", False)))

    state, metrics = measure(run, state, looped=looped(advance))
    extra = {}
    rebuilds = window_rebuilds(totals)
    with_census(metrics, advance)
    if args.engine == "slot" and not args.brownian:
        nve = slot_step.make_slot_advance(
            params, mt.NVE(), engine, hilo=args.potential == "lj",
            graph=False if args.eager else None)
        run, totals = slot_run(nve)
        _, extra["nve"] = measure(run, state, looped=looped(nve))
        extra["nve"]["rebuilds_timed_profiled"] = window_rebuilds(
            totals)[1:]
        with_census(extra["nve"], nve)
    print(json.dumps({
        "card": card, "engine": args.engine, "potential": args.potential,
        "ensemble": type(ensemble).__name__,
        "launch": "programmatic" if programmatic else "plain",
        "route": ("eager" if args.eager or not getattr(advance, "graph",
                                                        False)
                  else "graph"),
        "compensated": compensated,
        "n": N, "grid": list(engine.grid),
        "capacity": engine.cell_capacity, **metrics,
        # Slot layouts: rebuilds in the timed and in the profiled window.
        "rebuilds_timed_profiled": rebuilds[1:], **extra,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "package": os.path.dirname(os.path.abspath(mt.__file__)),
        **({"sharded_parts": sharded_parts(engine, state)}
           if args.engine == "sharded" else {}),
    }))
    if args.engine == "sharded":
        torch.distributed.destroy_process_group()


def particle_advance(step_mod, params, ensemble, engine, compensated,
                     eager):
    """The particle-order advance of the package profiled: its
    ``make_particle_advance`` (captured unless ``eager``); in a tree whose
    package has none, its ``make_md_step`` in a Python loop, the rebuild
    read on the host every step (``rebuilds`` stays 0: not counted)."""
    make = getattr(step_mod, "make_particle_advance", None)
    if make is not None:
        return make(params, ensemble, engine, compensated,
                    graph=False if eager else None)
    step = step_mod.make_step(params, ensemble, engine, compensated)

    def loop(s, k):
        for _ in range(k):
            s = step(s)
        return s

    loop.rebuilds = torch.zeros((), dtype=torch.int64)
    return loop


def host_loop_run(slot_step, advance):
    """``(run, totals)`` for an advance that is a host loop: each call's
    rebuilds counted at ``slot_step._engine_rebin``, their running total
    appended to ``totals`` after each segment."""
    totals, count = [], [0]
    engine_rebin = slot_step._engine_rebin

    def counted(s, e):
        count[0] += 1
        return engine_rebin(s, e)

    slot_step._engine_rebin = counted

    def run(s, k):
        s = advance(s, k)
        totals.append(count[0])
        return s

    return run, totals


def slot_run(advance):
    """``(run, totals)``: ``run(s, k)`` advances one segment and appends
    the advance's rebuild count after it to ``totals``."""
    totals = []

    def run(s, k):
        s = advance(s, k)
        totals.append(advance.rebuilds.clone())
        return s

    return run, totals


# The steps each step variant runs in a captured segment of k steps.
VARIANT_STEPS = {"lean": lambda k: k - 1, "last": lambda k: 1,
                 "full": lambda k: k, "step": lambda k: k}


def with_census(metrics, advance):
    """``metrics`` with the advance's step graphs' nodes and, where the
    profiler could not see the kernels (a looped segment), the kernels a
    step runs by the census, over the profiled window's one segment."""
    census = getattr(advance, "census", None)
    metrics["step_graph_nodes"] = census
    if census and metrics["device_kernels_per_step"] is None:
        k = metrics["profiled_steps"]
        kernels = sum(nodes["kernels"] * VARIANT_STEPS[name](k)
                      for name, nodes in census.items())
        # The loop test: once a pass and once at each variant's entry.
        metrics["device_kernels_per_step_census"] = (
            kernels + k + len(census)) / k


def window_rebuilds(totals):
    """Rebuilds in each window from the counts after each."""
    totals = [int(t) for t in totals]
    return [0] + [b - a for a, b in zip(totals, totals[1:])]


def measure(run, state, n_timed=200, n_profiled=PROFILED_STEPS,
            looped=lambda: False):
    """``(state, metrics)`` of ``run(state, k)`` (k steps, one segment):
    after a warm-up of 20, the host clock over ``n_timed`` steps, with the
    time the host takes to issue them (before the closing synchronize)
    apart, and the device's span of them by CUDA events; then
    ``torch.profiler`` over
    ``n_profiled`` steps: device busy time and idle share, launches of
    kernels and of CUDA graphs, host synchronisations (each read of a
    tensor on the host is one), copy calls, and the kernels that take the
    most device time, each a step. ``looped()``: whether the segment looped
    inside a WHILE node, whose kernels the profiler does not see: what it
    would read from them is then null."""
    state = run(state, 20)
    torch.cuda.synchronize()
    first, last = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t_start = time.perf_counter()
    first.record()
    state = run(state, n_timed)
    last.record()
    issue_ms = (time.perf_counter() - t_start) / n_timed * 1e3
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t_start) / n_timed * 1e3
    span_ms = first.elapsed_time(last) / n_timed

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        state = run(state, n_profiled)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)

    avgs = prof.key_averages()
    # Device-side entries only: a CPU op's entry also carries the device
    # time of the kernels it launched.
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in avgs if e.device_type == cuda and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3

    def calls(*names):
        return sum(e.count for e in avgs if e.key in names)

    launches = calls("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx")
    syncs = calls("cudaStreamSynchronize", "cudaEventSynchronize")
    memcpy = sum(e.count for e in avgs if e.key.startswith("cudaMemcpy"))
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    gaps = kernel_gaps(prof, GAP_KERNELS)
    # What the device ran, by kind (under graph replay, the step graph's
    # nodes of those kinds; a node that runs in no time is not seen).
    dev_memset = sum(e.count for e in kernels if e.key.startswith("Memset"))
    dev_memcpy = sum(e.count for e in kernels if e.key.startswith("Memcpy"))
    dev_kernels = sum(e.count for e in kernels) - dev_memset - dev_memcpy
    unseen = {}
    looped = looped()
    if looped:
        unseen = dict.fromkeys((
            "device_busy_ms_per_step", "device_idle_share_profiled",
            "device_idle_share_timed", "device_kernels_per_step",
            "device_memsets_per_step", "device_copies_per_step",
            "top_device_kernels"))
        gaps = {}
    return state, {
        "ms_per_step_host_clock": ms_per_step,
        "steps_per_s": 1e3 / ms_per_step,
        "issue_ms_per_step": issue_ms,
        "device_span_ms_per_step": span_ms,
        "device_idle_share_outside_span": 1.0 - span_ms / ms_per_step,
        "device_seen_by_profiler": not looped,
        "profiled_steps": n_profiled,
        "profiled_wall_ms_per_step": wall_ms / n_profiled,
        "device_busy_ms_per_step": busy_ms / n_profiled,
        # From the profiled window, whose host side the profiler slows.
        "device_idle_share_profiled": 1.0 - busy_ms / wall_ms,
        # The profiled busy time against the timed window's wall time.
        "device_idle_share_timed": 1.0 - busy_ms / n_profiled / ms_per_step,
        "kernel_launches_per_step": launches / n_profiled,
        "graph_launches_per_step": calls("cudaGraphLaunch") / n_profiled,
        "host_syncs_per_step": syncs / n_profiled,
        "device_syncs_in_window": calls("cudaDeviceSynchronize"),
        "memcpy_calls_per_step": memcpy / n_profiled,
        "device_kernels_per_step": dev_kernels / n_profiled,
        "device_memsets_per_step": dev_memset / n_profiled,
        "device_copies_per_step": dev_memcpy / n_profiled,
        **gaps,
        "top_device_kernels": [
            {"name": e.key[:90], "calls_per_step": e.count / n_profiled,
             "ms_per_step": dev_us(e) / 1e3 / n_profiled} for e in top],
        **unseen,
    }


# The kernels whose gap from the node before them the profile reports.
GAP_KERNELS = {"velocity_finish": "velocity_finish_kernel",
               "uniform_noise": "uniform_noise",
               "brownian_update": "brownian_update_kernel"}


def kernel_gaps(prof, names):
    """For each of ``names`` (a label and the text of its kernel's name)
    that ran: its mean device time in us, the mean gap in us from the end
    of the device activity that started just before it (a kernel, copy or
    memset) to its start, on the device's timeline (a negative gap is an
    overlap), and their sum, from that end to its own."""
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((e for e in prof.events() if e.device_type == cuda),
                    key=lambda e: e.time_range.start)
    out = {}
    for label, text in names.items():
        gaps, times = [], []
        for before, e in zip(events, events[1:]):
            if text in e.name:
                gaps.append(e.time_range.start - before.time_range.end)
                times.append(e.time_range.end - e.time_range.start)
        if times:
            out[f"{label}_us"] = sum(times) / len(times)
            out[f"{label}_gap_us"] = sum(gaps) / len(gaps)
            out[f"{label}_after_us"] = (sum(times) + sum(gaps)) / len(times)
    return out


def sharded_parts(engine, state, reps=200):
    """Host ms of the sharded step's own parts, each alone and synced: one
    rebuild-flag decision (``any`` over the ring and its host read, as the
    eager advance reads its vote every lean step), one all-reduce of a
    scalar sum (the kinetic energy of an NVT step) and the slab's ghost
    exchange and assembly (``slab_inputs``)."""
    ring = engine.ring
    flag = torch.zeros((), dtype=torch.bool, device=ring.device)
    value = torch.ones((), dtype=state.dtype, device=ring.device)

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    return {
        "rebuild_flag_any_and_read_ms": host_ms(lambda: bool(ring.any(flag))),
        "scalar_sum_ms": host_ms(lambda: ring.sum(value)),
        "slab_inputs_ms": host_ms(lambda: engine.slab_inputs(
            state.positions, state.diameters, state.nbrs.counts,
            state.unitcell.contiguous())),
        "local_flag_read_ms": host_ms(lambda: bool(flag.any())),
    }


if __name__ == "__main__":
    main()
