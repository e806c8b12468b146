#!/usr/bin/env python3
"""Where the time of one step goes in the PyTorch/CUDA port, on one GPU.

    python3 profile_torch_step.py

Builds the bench configuration (N = 65,536 Lennard-Jones, rho 0.8, r_c 2.5,
f32, NVT(1.0, 0.4), dt 0.002), melts it for 300 steps through
``mdtpu_torch.run_simulation``, then times the bare step function
(``make_md_step`` on the cell-grid engine) with the host clock and profiles
50 steps with ``torch.profiler``. Prints one JSON line: ms per step, device
busy time per step and the device's idle share over the profiled window,
CUDA kernel launches and host synchronisations per step, and the kernels
that take the most device time.
"""

import json
import subprocess
import tempfile
import time

import torch

N = 65536
PROFILED_STEPS = 50


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: no CUDA device")

    import mdtpu_torch as mt
    from mdtpu_torch.integrate.step import make_md_step
    from mdtpu_torch.sim.initialization import lattice_fluid_state

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    state = lattice_fluid_state(N, 0.8, 1.0, dtype=torch.float32,
                                cutoff=2.5, jitter=0.01, device="cuda")
    params = mt.Parameters(density=0.8, n_particles=N, dt=0.002,
                           potential=mt.LennardJones(r_cut=2.5))
    ensemble = mt.NVT(1.0, 0.4)
    engine = mt.select_engine(params.potential, 2.5, state)
    with tempfile.TemporaryDirectory() as d:
        state = mt.run_simulation(state, params, ensemble, 300, 300, d,
                                  engine=engine)
    step = make_md_step(params, ensemble, engine)

    for _ in range(20):
        state = step(state)
    torch.cuda.synchronize()
    n_timed = 200
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state = step(state)
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) / n_timed * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            state = step(state)
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
        "card": card, "n": N, "grid": list(engine.grid),
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
        "top_device_kernels": [
            {"name": e.key[:90], "calls_per_step": e.count / PROFILED_STEPS,
             "ms_per_step": dev_us(e) / 1e3 / PROFILED_STEPS} for e in top],
    }))


if __name__ == "__main__":
    main()
