#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mdtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, the torch and CUDA versions, and
   builds the CUDA pair sweep from ``mdtpu_torch/csrc`` (``nvcc -Xptxas -v``
   summary: registers, shared memory, spills).
2. Kernel phase: at the bench geometry (N = 65,536 Lennard-Jones, rho 0.8,
   r_c 2.5: a 15^3 grid with capacity C = 37) and for pseudo-hard spheres
   (rho 0.76, r_c 1.5), launches ``cell_sweep`` at f32 and f64 and holds it
   against ``cell_sweep_plain`` on the same inputs: f64 to rtol 1e-12 on
   energy and virial and 1e-10 on each particle's force relative to the
   larger of its own magnitude and the RMS force; f32 to 1e-5 on both (the
   two sum in different orders). Times both with CUDA events and works out
   the bound from this run's inputs: each unordered pair inside the cutoff
   once, each input and output moved once.
3. Main path: ``mdtpu_torch.run_simulation`` at the bench configuration on
   the card, 600 NVT (Bussi) steps then 500 NVE steps, thermo every 100 and
   trajectory every 500 steps, then 500 NVE steps from the NVT end state with
   the force-shifted potential; checks finite output, the NVT temperature,
   NVE energy conservation (to 1e-4 per particle with the force shift), the
   output files, and that every step went through the kernel (launch
   count).
4. Prints the ``kernels`` JSON line, then as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a card, when the package is
missing, or when any build, launch or check fails.
"""

import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

N_BENCH = 65536
BENCH_GEOMETRY = ((15, 15, 15), 37)   # CellGridEngine.create at skin 0.3
NVT_STEPS, NVE_STEPS = 600, 500
THERMO_EVERY, TRAJ_EVERY = 100, 500

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, no sparsity): HBM3
# 3.35 TB/s; 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor
# cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}
# Operations per pair, by hand count of csrc/cell_sweep.cu: the distance
# and the engine-cutoff test (3 subtractions, 3 multiplies, 2 adds, 1
# compare), sigma mixing and the potential's cutoff test, and, inside the
# potential's cutoff, its arithmetic plus the energy, virial and force
# accumulation.
OPS_DISTANCE = 9
OPS_ENGINE_PAIR = 4
OPS_POTENTIAL_PAIR = {"LennardJones": 25, "PseudoHS": 33}


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps, warmup):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class PairCounter:
    """A stand-in potential of energy 1 per pair closer than ``r_cut``:
    through ``cell_sweep_plain`` its energy is the number of unordered pairs
    closer than both ``r_cut`` and the engine cutoff."""

    def __init__(self, r_cut):
        self.r_cut = r_cut

    def evaluate_r2(self, r2, d_i, d_j):
        return (r2 < self.r_cut ** 2).to(r2.dtype), torch.zeros_like(r2)


def pair_counts(inputs, grid, cutoff, pot_cutoff):
    """Ordered candidate pairs the full 27-cell stencil visits (from the
    per-cell counts), and the unordered pairs inside the engine cutoff and
    inside the potential's cutoff (from the masks of ``cell_sweep_plain``)."""
    from mdtpu_torch.ops.cell_sweep import cell_sweep_plain
    counts = inputs[2]
    cnt = counts.reshape(grid)
    near = sum(torch.roll(cnt, off, dims=(0, 1, 2))
               for off in itertools.product((-1, 0, 1), repeat=3))
    cand = int((cnt * near).sum() - cnt.sum())
    f64 = [t.double() if t.is_floating_point() else t for t in inputs]
    inside, inside_pot = (
        round(float(cell_sweep_plain(*f64, grid, cutoff, PairCounter(r))[0]))
        for r in (cutoff, pot_cutoff))
    return cand, inside, inside_pot


def force_error(f1, f0, n_particles):
    """Largest per-particle force error |f1_i - f0_i| / max(|f0_i|, rms):
    each particle is held to its own force, or to the RMS force where its
    own is smaller (a nearly balanced particle). Also the largest absolute
    error and the RMS force."""
    f1, f0 = f1.double(), f0.double()
    err = (f1 - f0).norm(dim=0)
    mag = f0.norm(dim=0)
    rms = float(torch.sqrt((mag * mag).sum() / n_particles))
    return float((err / mag.clamp(min=rms)).max()), float(err.max()), rms


def kernel_phase(mt):
    from mdtpu_torch.ops.cell_sweep import cell_sweep, cell_sweep_plain
    from mdtpu_torch.ops.cell_grid import CellGridEngine
    from mdtpu_torch.sim.initialization import lattice_fluid_state

    # Jitter in standard normals of the lattice spacing. At 0.03 the pseudo-
    # hard-sphere lattice (spacing 1.096, potential cutoff 1.02) has
    # thousands of interacting pairs and none much closer than 0.9 sigma, so
    # no single pair's r^-50 force dwarfs the rest.
    cases = [
        ("lj_bench", mt.LennardJones(r_cut=2.5), 0.8, 2.5, 0.01),
        ("pseudo_hs", mt.PseudoHS(), 0.76, 1.5, 0.03),
    ]
    results, failures = {}, []
    for name, pot, rho, cutoff, jitter in cases:
        for dtype in (torch.float32, torch.float64):
            state = lattice_fluid_state(N_BENCH, rho, 1.0, dtype=dtype,
                                        cutoff=cutoff, jitter=jitter,
                                        device="cuda")
            eng = mt.select_engine(pot, cutoff, state)
            assert isinstance(eng, CellGridEngine), eng
            if name == "lj_bench":
                assert (eng.grid, eng.cell_capacity) == BENCH_GEOMETRY, \
                    (eng.grid, eng.cell_capacity)
            nb = eng.allocate(state.positions, state.diameters,
                              state.unitcell, state.unitcell_inv)
            assert not bool(nb.overflow)
            inputs = eng.slot_inputs(state.positions, state.unitcell,
                                     state.unitcell_inv, nb)
            args = (*inputs, eng.grid, eng.cutoff, pot)
            e1, w1, f1 = cell_sweep(*args)
            torch.cuda.synchronize()
            e0, w0, f0 = cell_sweep_plain(*args)
            torch.cuda.synchronize()
            f64 = dtype == torch.float64
            rtol_ew, tol_f = (1e-12, 1e-10) if f64 else (1e-5, 1e-5)
            worst, max_abs, rms = force_error(f1, f0, N_BENCH)
            rel_e = abs(float(e1) - float(e0)) / abs(float(e0))
            rel_w = abs(float(w1) - float(w0)) / abs(float(w0))
            ok = (math.isfinite(float(e1)) and rel_e <= rtol_ew
                  and rel_w <= rtol_ew and worst <= tol_f)
            kernel_ms = cuda_time_ms(lambda: cell_sweep(*args), 20, 3)
            plain_ms = cuda_time_ms(lambda: cell_sweep_plain(*args), 3, 1)

            # The bound counts what the function needs: each unordered pair
            # inside the cutoff once, each input read and each output
            # written once. The full stencil's candidate pairs, each seen
            # from both sides, are the design's work, printed beside it.
            cand, inside, inside_pot = pair_counts(
                inputs, eng.grid, eng.cutoff,
                pot.max_cutoff(float(state.diameters.max())))
            pot_ops = OPS_POTENTIAL_PAIR[type(pot).__name__]
            ops = (inside * (OPS_DISTANCE + OPS_ENGINE_PAIR)
                   + inside_pot * pot_ops)
            design_ops = (cand * OPS_DISTANCE + 2 * inside * OPS_ENGINE_PAIR
                          + 2 * inside_pot * pot_ops)
            b = inputs[0].element_size()
            n_slots, n_cells = inputs[0].shape[1], inputs[2].shape[0]
            nbytes = (4 * n_slots * b + n_cells * 8 + 3 * b     # inputs
                      + 3 * n_slots * b + 2 * n_cells * b)     # outputs
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[dtype] * 1e3
            rec = {
                "kernel_check": name, "dtype": str(dtype).split(".")[-1],
                "grid": list(eng.grid), "capacity": eng.cell_capacity,
                "ok": ok, "rel_err_energy": rel_e, "rel_err_virial": rel_w,
                "force_err_per_particle": worst, "max_abs_err": max_abs,
                "rms_force": rms,
                "max_force": float(f0.double().norm(dim=0).max()),
                "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "ops_bound_ms": t_ops, "bytes_bound_ms": t_bytes,
                "pairs_in_engine_cutoff": inside,
                "pairs_in_potential_cutoff": inside_pot, "ops": ops,
                "bytes": nbytes, "stencil_candidates": cand,
                "stencil_ops": design_ops,
                "stencil_ops_ms": design_ops / PEAK_OPS[dtype] * 1e3,
                "library_ms": None,
            }
            log(json.dumps(rec))
            results[(name, dtype)] = rec
            if not ok:
                failures.append(f"{name} {dtype}")
            del state, nb, inputs, args, f0, f1
            torch.cuda.empty_cache()
    return results, failures


def main_path(mt, workdir):
    from mdtpu_torch.ops.cell_sweep import cell_sweep
    from mdtpu_torch.sim.initialization import lattice_fluid_state

    state = lattice_fluid_state(N_BENCH, 0.8, 1.0, dtype=torch.float32,
                                cutoff=2.5, jitter=0.01, device="cuda")
    params = mt.Parameters(density=0.8, n_particles=N_BENCH, dt=0.002,
                           potential=mt.LennardJones(r_cut=2.5))
    nvt_dir, nve_dir, fs_dir = (os.path.join(workdir, d)
                                for d in ("nvt", "nve", "nve_fs"))
    cell_sweep.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mid = mt.run_simulation(state, params, mt.NVT(1.0, 0.4), NVT_STEPS,
                            THERMO_EVERY, nvt_dir, traj_frequency=TRAJ_EVERY)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    end = mt.run_simulation(mid, params, mt.NVE(), NVE_STEPS, THERMO_EVERY,
                            nve_dir, traj_frequency=TRAJ_EVERY)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # NVE again from the NVT end state with the force-shifted potential (V
    # and F continuous at r_c), whose total energy no cutoff crossing moves.
    fs_params = dataclasses.replace(
        params, potential=mt.LennardJones(r_cut=2.5, force_shift=True))
    fs_end = mt.run_simulation(mid, fs_params, mt.NVE(), NVE_STEPS,
                               THERMO_EVERY, fs_dir, traj_frequency=TRAJ_EVERY)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = cell_sweep.launches

    failures = []

    def check(cond, what):
        if not cond:
            failures.append(what)

    steps = NVT_STEPS + NVE_STEPS
    for st in (end, fs_end):
        check(st.step == steps, f"final step {st.step} != {steps}")
        check(bool(torch.isfinite(st.positions).all())
              and bool(torch.isfinite(st.velocities).all()),
              "non-finite state")
    check(launches >= steps + NVE_STEPS,
          f"cell_sweep launched {launches} < {steps + NVE_STEPS} times")
    nvt_rows = _rows(os.path.join(nvt_dir, "thermo.txt"))
    nve_rows = _rows(os.path.join(nve_dir, "thermo.txt"))
    fs_rows = _rows(os.path.join(fs_dir, "thermo.txt"))
    check(len(nvt_rows) == NVT_STEPS // THERMO_EVERY, "NVT thermo rows")
    check(len(nve_rows) == NVE_STEPS // THERMO_EVERY, "NVE thermo rows")
    check(len(fs_rows) == NVE_STEPS // THERMO_EVERY, "NVE (shifted) rows")
    rows = nvt_rows + nve_rows + fs_rows
    check(all(math.isfinite(v) for r in rows for v in r), "non-finite thermo")
    t_nvt = [r[2] for r in nvt_rows[2:]]
    mean_t = sum(t_nvt) / max(len(t_nvt), 1)
    check(abs(mean_t - 1.0) < 0.1, f"NVT mean temperature {mean_t}")
    # Total energy per particle: potential (thermo column) + kinetic. The
    # bench potential is truncated without a shift, so each pair crossing
    # r_c changes the total by V(r_c) = -0.0163; while the lattice-started
    # fluid still relaxes, the count of pairs inside r_c drifts, and the total
    # with it (1.5e-3 per particle over these steps on an H100). A wrong
    # force moves it by far more. With the force-shifted potential only the
    # integrator and the forces move the total: it holds to 1e-4.
    ke = end.nf / (2.0 * N_BENCH)
    e_tot = [r[1] + ke * r[2] for r in nve_rows]
    drift = max(e_tot) - min(e_tot)
    check(drift < 5e-3, f"NVE total energy per particle moved {drift}")
    fs_tot = [r[1] + ke * r[2] for r in fs_rows]
    fs_drift = max(fs_tot) - min(fs_tot)
    check(fs_drift < 1e-4,
          f"NVE (shifted) energy per particle moved {fs_drift}")
    for path, frames in ((os.path.join(nvt_dir, "trajectory.xyz"),
                          NVT_STEPS // TRAJ_EVERY + (NVT_STEPS % TRAJ_EVERY > 0)),
                         (os.path.join(nve_dir, "trajectory.xyz"), 1),
                         (os.path.join(fs_dir, "trajectory.xyz"), 1)):
        with open(path) as f:
            text = f.read()
        check(text.count("ITEM: TIMESTEP") == frames, f"frames in {path}")
        check(text.count("\n") == frames * (9 + N_BENCH), f"rows in {path}")
    for d in (nvt_dir, nve_dir, fs_dir):
        with open(os.path.join(d, "final.xyz")) as f:
            check(sum(1 for _ in f) == N_BENCH + 2, f"final.xyz in {d}")
    rec = {
        "main_path": "run_simulation NVT->NVE, N=65536 LJ rho 0.8 f32",
        "steps": steps, "nvt_s": t1 - t0, "nve_s": t2 - t1,
        "steps_per_s": steps / (t2 - t0),
        "particle_steps_per_s": steps * N_BENCH / (t2 - t0),
        "cell_sweep_launches": launches, "nvt_mean_T": mean_t,
        "nve_total_energy_per_particle": e_tot, "nve_energy_range": drift,
        "nve_shifted_s": t3 - t2,
        "nve_shifted_total_energy_per_particle": fs_tot,
        "nve_shifted_energy_range": fs_drift,
        "thermo_nvt": nvt_rows, "thermo_nve": nve_rows,
        "card": torch.cuda.get_device_name(0),
    }
    log(json.dumps(rec))
    return rec, failures


def _rows(path):
    with open(path) as f:
        return [[float(x) for x in line.split()] for line in f
                if line.strip() and not line.startswith("#")]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import mdtpu_torch as mt
    from mdtpu_torch.ops import cell_sweep as sweep_mod

    log(nvidia_smi_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    report = sweep_mod.build_report()
    log(f"built {sweep_mod.SOURCE.name} in {time.perf_counter() - t:.1f} s")
    for line in report.splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry",
                                   "smem")):
            log("  ptxas: " + line.strip())

    results, failures = kernel_phase(mt)
    with tempfile.TemporaryDirectory() as workdir:
        main_rec, main_failures = main_path(mt, workdir)
    failures += main_failures
    bench = results[("lj_bench", torch.float32)]
    kernels = {"kernels": [{
        "name": "cell_sweep", "route": "cuda",
        "source": "mdtpu_torch/csrc/cell_sweep.cu",
        "replaces": "mdtpu/ops/experimental/pallas_cell.py:77",
        "launches": main_rec["cell_sweep_launches"],
        "max_abs_err": bench["max_abs_err"], "ms": bench["kernel_ms"],
        "plain_ms": bench["plain_ms"], "bound_ms": bench["bound_ms"],
        "bound_by": bench["bound_by"], "library_ms": None,
    }]}
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
