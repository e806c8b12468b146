#!/usr/bin/env python3
"""Hold the full-stencil pair sweeps of two trees of this repository against
each other on one NVIDIA GPU: are the results equal bit for bit, and which is
faster.

    git archive <commit> | tar -x -C out_parent      # the other tree
    python3 compare_torch_sweep.py --parent out_parent

Makes the inputs once with this tree's code: the bench geometry (N = 65,536
Lennard-Jones, rho 0.8, r_c 2.5: 15^3 cells, C = 37) as the jittered lattice
and as the melted fluid (the lattice after 300 NVT steps), at f64, f32 and as
f32 hi/lo words, and pseudo-hard spheres (rho 0.76, r_c 1.5) on the lattice.
Then each tree runs ``cell_sweep`` / ``cell_sweep_hilo`` on them in a process
of its own, in the order parent, change, change, parent, so both are timed
on the same card within one call (a CUDA graph of one wrapper call replayed
20 times between two CUDA events, the median of 5 rounds: the device's time
without the host's). Prints one JSON line per case: whether forces, energy and virial of
the two trees are equal bit for bit, the largest force difference, both
times and their ratio; then the card's name and power limit.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

N = 65536
HERE = os.path.dirname(os.path.abspath(__file__))


def make_inputs(path):
    import mdtpu_torch as mt
    from mdtpu_torch.sim.initialization import lattice_fluid_state

    lj, hs = mt.LennardJones(r_cut=2.5), mt.PseudoHS()
    lattice = lattice_fluid_state(N, 0.8, 1.0, dtype=torch.float64,
                                  cutoff=2.5, jitter=0.01, device="cuda")
    params = mt.Parameters(density=0.8, n_particles=N, dt=0.002, potential=lj)
    with tempfile.TemporaryDirectory() as d:
        melted = mt.run_simulation(lattice, params, mt.NVT(1.0, 0.4), 300,
                                   300, d)
    hs_lattice = lattice_fluid_state(N, 0.76, 1.0, dtype=torch.float64,
                                     cutoff=1.5, jitter=0.03, device="cuda")
    cases = {}
    for name, pot_name, pot, cutoff, state in (
            ("lj_lattice", "lj", lj, 2.5, lattice),
            ("lj_melted", "lj", lj, 2.5, melted),
            ("pseudo_hs_lattice", "pseudo_hs", hs, 1.5, hs_lattice)):
        eng = mt.select_engine(pot, cutoff, state)
        pos = state.positions
        hi = pos.float()
        lo = (pos - hi.double()).float()
        cell32, cinv32 = state.unitcell.float(), state.unitcell_inv.float()
        nb = eng.allocate(pos, state.diameters, state.unitcell,
                          state.unitcell_inv)
        nb32 = eng.allocate(hi, state.diameters.float(), cell32, cinv32)
        assert not bool(nb.overflow) and not bool(nb32.overflow)
        common = {"pot": pot_name, "grid": eng.grid, "cutoff": eng.cutoff}
        cases[f"{name}_f64"] = dict(common, kind="plain", inputs=eng.slot_inputs(
            pos, state.unitcell, state.unitcell_inv, nb))
        cases[f"{name}_f32"] = dict(common, kind="plain", inputs=eng.slot_inputs(
            hi, cell32, cinv32, nb32))
        cases[f"{name}_hilo"] = dict(common, kind="hilo",
                                     inputs=eng.slot_inputs_hilo(
                                         hi, lo, cell32, cinv32, nb32))
    torch.save({k: dict(v, inputs=[t.cpu() for t in v["inputs"]])
                for k, v in cases.items()}, path)


def worker(tree, inputs_path, out_path):
    sys.path.insert(0, tree)
    import mdtpu_torch as mt
    from mdtpu_torch.ops.cell_sweep import cell_sweep, cell_sweep_hilo

    assert os.path.abspath(mt.__file__).startswith(os.path.abspath(tree))
    pots = {"lj": mt.LennardJones(r_cut=2.5), "pseudo_hs": mt.PseudoHS()}
    out = {}
    for name, case in torch.load(inputs_path, weights_only=False).items():
        fn = cell_sweep_hilo if case["kind"] == "hilo" else cell_sweep
        args = (*(t.cuda() for t in case["inputs"]), case["grid"],
                case["cutoff"], pots[case["pot"]])
        energy, virial, force = fn(*args)
        torch.cuda.synchronize()
        # Device time: one wrapper call captured in a CUDA graph, replayed.
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn(*args)
        rounds = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                graph.replay()
            stop.record()
            torch.cuda.synchronize()
            rounds.append(start.elapsed_time(stop) / 20)
        out[name] = {"energy": energy.cpu(), "virial": virial.cpu(),
                     "force": force.cpu(), "ms": statistics.median(rounds)}
    torch.save(out, out_path)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="directory of the other tree")
    parser.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_torch_sweep: no CUDA device")
    if args.worker:
        return worker(*args.worker)
    if not args.parent:
        parser.error("--parent is required")
    sys.path.insert(0, HERE)
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        make_inputs(inputs)
        runs = []
        for i, tree in enumerate((args.parent, HERE, HERE, args.parent)):
            out = os.path.join(tmp, f"out{i}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", os.path.abspath(tree), inputs, out],
                           check=True)
            runs.append(torch.load(out, weights_only=False))
    parent, change = (runs[0], runs[3]), (runs[1], runs[2])
    for name in runs[0]:
        p, c = parent[0][name], change[0][name]
        p_ms = [r[name]["ms"] for r in parent]
        c_ms = [r[name]["ms"] for r in change]
        print(json.dumps({
            "case": name,
            "force_equal": bool(torch.equal(p["force"], c["force"])),
            "energy_equal": bool(torch.equal(p["energy"], c["energy"])),
            "virial_equal": bool(torch.equal(p["virial"], c["virial"])),
            "max_abs_force_diff": float((p["force"] - c["force"]).abs().max()),
            "parent_ms": p_ms, "change_ms": c_ms,
            "parent_over_change": statistics.mean(p_ms)
            / statistics.mean(c_ms),
            "change_faster_in_every_run": max(c_ms) < min(p_ms)}),
            flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
