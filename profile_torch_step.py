#!/usr/bin/env python3
"""Where the time of one step goes in the PyTorch/CUDA port, on one GPU.

    python3 profile_torch_step.py [--engine cellgrid|plane|slot|neighbor|sharded]
                                  [--potential lj|user]

Builds the bench configuration (N = 65,536 Lennard-Jones, rho 0.8, r_c 2.5,
f32, NVT(1.0, 0.4), dt 0.002), melts it for 300 steps through
``mdtpu_torch.run_simulation``, then times the bare step function with the
host clock and profiles 50 steps with ``torch.profiler``. ``--engine
cellgrid`` (the default) steps the cell-grid engine in particle order
(``make_md_step``) with Kahan compensation; ``--engine plane`` steps
``PlaneEngine`` (the Newton half-stencil sweep) with ``compensated=False``,
as the JAX package drives its B2 kernel; ``--engine neighbor`` steps
``NeighborListEngine`` (``select_engine(..., prefer="neighbor")``) in
particle order with Kahan compensation; ``--engine slot`` steps the slot
layout as ``run_simulation`` does on the cell grid: ``make_slot_advance``
over one segment of the timed or profiled length (its lean inner steps, the
rebuild check read every step, the rebuilds that come due, one full step at
the end), and reports the rebuilds in each window; ``--engine sharded``
steps the same through ``HaloSlotEngine`` on a one-rank NCCL group (a file
store in a temporary directory): the slab's ghost exchange and launch, the
all-reduced flags and sums, a rebuild (with its migration) at the start of
each window and before its last step. Prints one JSON line: ms per step,
device busy time per step and the device's idle share over the profiled
window, CUDA kernel launches and host synchronisations per step, and the
kernels that take the most device time; for ``sharded`` a second line with
the host ms of the step's own parts alone (the rebuild flag's all-reduce
and read, a scalar all-reduce, the ghost exchange and assembly).
``--potential user`` (with ``slot`` or ``sharded``) takes BASELINE config 4
instead, as ``chip_smoke.py`` builds it (2D, N = 65,536, rho 0.9, diameters
U(0.8, 1.2), a user potential without a kernel functor, so every sweep is
the pair list, f64, NVT(0.5, 0.01), dt 1e-4) on its lattice.
"""

import argparse
import json
import subprocess
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
    args = parser.parse_args()
    if args.potential == "user" and args.engine not in ("slot", "sharded"):
        parser.error("--potential user takes --engine slot or sharded")
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: no CUDA device")

    import mdtpu_torch as mt
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.integrate.step import make_md_step
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
    compensated = args.engine != "plane"
    if args.engine == "plane":
        engine = PlaneEngine.create(params.potential, 2.5, 0.3,
                                    state.unitcell, N)
    with tempfile.TemporaryDirectory() as d:
        state = mt.run_simulation(state, params, ensemble, 300, 300, d,
                                  engine=engine, compensated=compensated)
    rebuilds = []
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
        advance = make_sharded_slot_advance(params, ensemble, engine)
        engine_rebin = slot_step._engine_rebin

        def counted_engine_rebin(s, e):
            rebuilds[-1] += 1
            return engine_rebin(s, e)

        slot_step._engine_rebin = counted_engine_rebin

        def run(s, k):
            rebuilds.append(0)
            return advance(s, k)
    elif args.engine == "slot":
        state = slot_step.slot_forces(slot_step.slotify(state, engine),
                                      engine)
        advance = slot_step.make_slot_advance(params, ensemble, engine)
        rebin = slot_step._rebin

        def counted_rebin(s, e):
            rebuilds[-1] += 1
            return rebin(s, e)

        slot_step._rebin = counted_rebin

        def run(s, k):
            rebuilds.append(0)
            return advance(s, k)
    else:
        step = make_md_step(params, ensemble, engine, compensated)

        def run(s, k):
            for _ in range(k):
                s = step(s)
            return s

    state = run(state, 20)
    torch.cuda.synchronize()
    n_timed = 200
    t0 = time.perf_counter()
    state = run(state, n_timed)
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) / n_timed * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        state = run(state, PROFILED_STEPS)
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
    launches = sum(e.count for e in avgs if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"))
    syncs = sum(e.count for e in avgs if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize"))
    memcpy = sum(e.count for e in avgs if e.key.startswith("cudaMemcpy"))
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    print(json.dumps({
        "card": card, "engine": args.engine, "potential": args.potential,
        "compensated": compensated,
        "n": N, "grid": list(engine.grid),
        "capacity": engine.cell_capacity,
        "ms_per_step_host_clock": ms_per_step,
        "steps_per_s": 1e3 / ms_per_step,
        "profiled_steps": PROFILED_STEPS,
        "profiled_wall_ms_per_step": wall_ms / PROFILED_STEPS,
        "device_busy_ms_per_step": busy_ms / PROFILED_STEPS,
        # Both from the profiled window, whose host side the profiler slows.
        "device_idle_share_profiled": 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_step": launches / PROFILED_STEPS,
        "host_syncs_per_step": syncs / PROFILED_STEPS,
        "memcpy_calls_per_step": memcpy / PROFILED_STEPS,
        # Slot layouts: rebuilds in the timed and in the profiled window.
        "rebuilds_timed_profiled": rebuilds[1:],
        "top_device_kernels": [
            {"name": e.key[:90], "calls_per_step": e.count / PROFILED_STEPS,
             "ms_per_step": dev_us(e) / 1e3 / PROFILED_STEPS} for e in top],
    }))
    if args.engine == "sharded":
        print(json.dumps({"card": card, "engine": "sharded",
                          **sharded_parts(engine, state)}))
        torch.distributed.destroy_process_group()


def sharded_parts(engine, state, reps=200):
    """Host ms of the sharded step's own parts, each alone and synced: one
    rebuild-flag decision (``any`` over the ring and its host read, as the
    advance makes it every step), one all-reduce of a scalar sum (the
    kinetic energy of an NVT step) and the slab's ghost exchange and
    assembly (``slab_inputs``)."""
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
