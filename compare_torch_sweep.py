#!/usr/bin/env python3
"""Hold the CUDA kernels of two trees of this repository against each other on
one NVIDIA GPU: are the results equal bit for bit, and which is faster.

    git archive <commit> | tar -x -C out_parent      # the other tree
    python3 compare_torch_sweep.py --parent out_parent

Makes the inputs once with this tree's code: the bench geometry (N = 65,536
Lennard-Jones, rho 0.8, r_c 2.5: 15^3 cells, C = 37) as the jittered lattice
and as the melted fluid (the lattice after 300 NVT steps), at f64, f32 and as
f32 hi/lo words, pseudo-hard spheres (rho 0.76, r_c 1.5) on the lattice, and
the Brownian grid (pseudo-hard spheres at rho 0.5 through
``PlaneEngine.create``, f32); for the pair list, BASELINE config 4 (2D,
65,536, rho 0.9, diameters U(0.8, 1.2), r_c 1.8: 128^2 cells, C = 13) on a
lattice jittered by 0.05 at f64, f32 and hi/lo, and the bench's 3D lattice
with a user potential at f32 and hi/lo; for the neighbour list, the bench's
lattice, melted fluid and the lattice with its particles shuffled (a random
order of the same positions) at f64 and f32 (15^3 cells, C = 57, K = 128)
and the lattice at 262,144 f32, binned and listed once by this tree's
engine; for the RDF histogram (200 bins), the melted fluid at f64 and f32
and the bench's start in the tilted box [[L, L/8, L/12], [0, L, L/6], [0,
0, L]] at f32, each at r_max 3 and at half the narrowest width, the
lattice at 262,144 at r_max 3 (f64, f32), and ``validate_torch.py``'s
triple point shape (4,096 at rho 0.84, a lattice jittered by 0.05, f32)
at r_max 3; for the list's reduction, config 4's list (f64, f32) with the
user potential's values on it.
Then each tree runs ``cell_sweep``
and ``plane_sweep`` (the hi/lo words: ``cell_sweep_hilo``; the Brownian
grid: ``plane_sweep``; the list cases: ``pair_list`` and ``pair_sweep`` with
the user potential of ``examples/03_polydisperse_2d.py``; the neighbour-list
cases: ``nl_build`` (K1) and ``nl_forces`` (K2) with Lennard-Jones on the
same list, each given the particles' order by cell where the tree's wrapper
takes it; the RDF cases: ``rdf_histogram``; the reduction cases:
``pair_reduce``, full and lean) on them, and the
probe (``probe_sweep``: ``full`` at chunks 45, 15 and 5, ``nodiv``,
``reduce_only``) on its own input, in a process of its own, in the order
parent, change, change, parent, so both are timed on the same card within
one call (a CUDA graph of one wrapper call replayed 20 times between two
CUDA events, the median of 5 rounds: the device's time without the
host's). Prints one JSON line per case and kernel: whether forces (the
probe: ``fx``), energy and virial of the two trees are equal bit for bit
(NaN equal to NaN), the largest force difference, both times and their
ratio, and the relative differences of energy and virial (for
``pair_list``: whether every buffer of the list, the per-slot counts and
starts and the total are equal bit for bit, padding included; for
``nl_build``: whether the rows, padding included, the counts and the flag
are; for ``rdf_histogram``: whether the counts are equal, the device
time by graph replay of what can be captured (the old tree's whole call;
this tree's launch on its plan, the cell route's binning included) and
the whole call's time between two CUDA events, host included, the median
of 5; for ``pair_reduce``: the kernels a full call launches, by the
profiler); then the card's name and power limit.
"""

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

N = 65536
NL_CASES = (("lattice", N, ("f64", "f32")), ("melted", N, ("f64", "f32")),
            ("shuffled", N, ("f64", "f32")), ("lattice", 262144, ("f32",)))
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
    from mdtpu_torch.ops.experimental import PlaneEngine
    bd = lattice_fluid_state(N, 0.5, 1.0, dtype=torch.float32, cutoff=1.5,
                             jitter=0.05, device="cuda")
    eng = PlaneEngine.create(hs, 1.5, 0.3, bd.unitcell, N)
    nb = eng.allocate(bd.positions, bd.diameters, bd.unitcell,
                      bd.unitcell_inv)
    assert not bool(nb.overflow)
    cases["brownian_grid_f32"] = {
        "pot": "pseudo_hs", "grid": eng.grid, "cutoff": eng.cutoff,
        "kind": "plane", "inputs": eng.slot_inputs(
            bd.positions, bd.unitcell, bd.unitcell_inv, nb)}
    # The pair list: config 4 on a lattice (chip_smoke.py's user_lattice)
    # and the bench's 3D lattice, with the user potential (the list depends
    # on the cutoff and the diameters only).
    from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                                lattice_positions)
    L = (N / 0.9) ** 0.5
    cell2 = torch.eye(2, dtype=torch.float64) * L
    pos2 = lattice_positions(N, cell2, 2, dtype=torch.float64, jitter=0.05,
                             seed=4, device="cuda")
    diam2 = 0.8 + 0.4 * torch.rand(N, generator=torch.Generator()
                                   .manual_seed(6), dtype=torch.float64)
    config4 = build_state_from_arrays(pos2, diam2, cell2, 0,
                                      dtype=torch.float64, cutoff=1.8,
                                      device="cuda")
    user = user_potential(mt)
    for name, state, cutoff, kinds in (
            ("config4", config4, 1.8, ("f64", "f32", "hilo")),
            ("user_3d_lattice", lattice, 2.5, ("f32", "hilo"))):
        eng = mt.select_engine(user, cutoff, state)
        assert eng.uses_pair_list
        pos = state.positions
        hi = pos.float()
        lo = (pos - hi.double()).float()
        cell32, cinv32 = state.unitcell.float(), state.unitcell_inv.float()
        common = {"pot": "user", "grid": eng.grid, "cutoff": eng.cutoff,
                  "capacity": eng.pair_list_capacity}
        for kind in kinds:
            if kind == "f64":
                nb = eng.allocate(pos, state.diameters, state.unitcell,
                                  state.unitcell_inv)
                inputs = eng.slot_inputs(pos, state.unitcell,
                                         state.unitcell_inv, nb)
            else:
                nb = eng.allocate(hi, state.diameters.float(), cell32,
                                  cinv32)
                inputs = (eng.slot_inputs(hi, cell32, cinv32, nb)
                          if kind == "f32" else
                          eng.slot_inputs_hilo(hi, lo, cell32, cinv32, nb))
            assert not bool(nb.overflow)
            cases[f"{name}_{kind}"] = dict(
                common, kind="list_hilo" if kind == "hilo" else "list",
                inputs=inputs)
    # The neighbour list: the bench's lattice and melted fluid, and the
    # lattice at 262,144; the list K2 runs on is this tree's K1's.
    big = lattice_fluid_state(262144, 0.8, 1.0, dtype=torch.float64,
                              cutoff=2.5, jitter=0.01, device="cuda")
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(9))
    states = {("lattice", N): lattice, ("melted", N): melted,
              ("shuffled", N): lattice.replace(
                  positions=lattice.positions[perm.cuda()].contiguous()),
              ("lattice", 262144): big}
    for kind, n, tags in NL_CASES:
        state = states[kind, n]
        for tag in tags:
            dtype = torch.float64 if tag == "f64" else torch.float32
            pos = state.positions.to(dtype).contiguous()
            cell = state.unitcell.to(dtype)
            cell_inv = state.unitcell_inv.to(dtype)
            eng = mt.select_engine(lj, 2.5, state, prefer="neighbor")
            cid, buf, counts, order, starts = eng.bin_sorted(pos, cell_inv)
            nb = eng.allocate(pos, state.diameters.to(dtype), cell,
                              cell_inv)
            assert not bool(nb.overflow)
            cases[f"nl_{kind}_{n}_{tag}"] = {
                "kind": "nl", "grid": eng.grid, "cutoff": eng.cutoff,
                "r_list": eng.cutoff + eng.skin,
                "max_neighbors": eng.max_neighbors,
                "inputs": [pos, cid, buf, counts,
                           torch.diagonal(cell).contiguous(), order, starts,
                           state.diameters.to(dtype), nb.idx, nb.count]}
    # The RDF histogram: the melted fluid, the tilted start, the lattice at
    # 262,144 and the triple point's shape.
    L = (N / 0.8) ** (1 / 3)
    tcell = torch.tensor([[L, L / 8, L / 12], [0.0, L, L / 6],
                          [0.0, 0.0, L]], dtype=torch.float64)
    tilted = build_state_from_arrays(
        lattice_positions(N, tcell, 3, dtype=torch.float64, jitter=0.01,
                          seed=0, device="cuda"), torch.ones(N), tcell, 1,
        dtype=torch.float64, cutoff=2.5, device="cuda")
    triple = lattice_fluid_state(4096, 0.84, 0.75, dtype=torch.float64,
                                 cutoff=2.5, jitter=0.05, device="cuda")
    for name, state, tags, with_half in (
            ("melted", melted, ("f64", "f32"), True),
            ("tilted", tilted, ("f32",), True),
            ("lattice_262144", big, ("f64", "f32"), False),
            ("triple_4096", triple, ("f32",), False)):
        # Half the narrowest perpendicular width (sample_rdf's default).
        half = 0.5 / float(torch.linalg.norm(
            torch.linalg.inv(state.unitcell), dim=1).max())
        radii = [("r_max_3", 3.0)] + [("half_width", half)] * with_half
        for tag in tags:
            dtype = torch.float64 if tag == "f64" else torch.float32
            for r_name, r_max in radii:
                cases[f"rdf_{name}_{tag}_{r_name}"] = {
                    "kind": "rdf", "r_max": r_max,
                    "inputs": [state.positions.to(dtype).contiguous()],
                    "cell": [state.unitcell.to(dtype).cpu(),
                             state.unitcell_inv.to(dtype).cpu()]}
    # The reduction: config 4's list at f64 and f32 (this tree's), the
    # user potential's values on it.
    from mdtpu_torch.ops.cell_pairs import pair_list
    for tag in ("f64", "f32"):
        case = cases[f"config4_{tag}"]
        plist = pair_list(*case["inputs"], case["grid"], case["cutoff"],
                          case["capacity"])
        u, f = user.evaluate_r2(plist.r2, plist.sigma_i, plist.sigma_j)
        cases[f"reduce_config4_{tag}"] = {
            "kind": "reduce", "inputs": [], "plist": {
                k: getattr(plist, k).cpu() for k in LIST_FIELDS + (
                    "overflow",)}, "u": u.cpu(), "f": f.cpu()}
    del big, states
    # The cases' boxes are orthorhombic: pass the box lengths, which every
    # tree's wrappers take (the cell matrix only since the 2D and tilted
    # sweeps).
    torch.save({k: dict(v, inputs=[
        torch.diagonal(t).contiguous().cpu() if t.dim() == 2
        and t.shape[0] == t.shape[1] == 3 else t.cpu()
        for t in v["inputs"]]) for k, v in cases.items()}, path)


PROBE_SPECS = ("full:45", "full:15", "full:5", "nodiv:45", "reduce_only:45")
LIST_FIELDS = ("neighbour", "disp", "r2", "sigma_i", "sigma_j", "count",
               "start", "total")


def user_potential(mt):
    """The user potential of ``examples/03_polydisperse_2d.py`` against the
    ``Potential`` of the tree ``mt`` comes from (no kernel has a functor for
    it: the cell grid takes the pair list)."""
    from mdtpu_torch.utils.math import ipow

    class NonAdditivePHS(mt.Potential):
        def evaluate(self, r, sigma_i, sigma_j):
            sigma = 0.5 * (sigma_i + sigma_j) * (1.0 - 0.2 * torch.abs(
                sigma_i - sigma_j))
            cutoff = 1.25 * sigma
            inside = r < cutoff
            r_safe = torch.where(inside, r, torch.ones_like(r))
            u_raw = ipow(sigma / r_safe, 12)
            f_raw = 12 * u_raw / r_safe
            u_c = 0.8 ** 12   # a number, not a tensor: capturable
            f_c = 12 * u_c / cutoff
            zero = torch.zeros_like(r)
            return (torch.where(inside, u_raw - u_c + (r_safe - cutoff) * f_c,
                                zero),
                    torch.where(inside, f_raw - f_c, zero))

    return NonAdditivePHS()


def replay_ms(fn):
    """Device time of one call of ``fn`` (already called once): a CUDA graph
    of the call replayed 20 times between two CUDA events, the median of 5
    rounds."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
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
    return statistics.median(rounds)


def worker(tree, inputs_path, out_path):
    sys.path.insert(0, tree)
    import mdtpu_torch as mt
    from mdtpu_torch.ops.cell_pairs import pair_list, pair_sweep
    from mdtpu_torch.ops.cell_sweep import cell_sweep, cell_sweep_hilo
    from mdtpu_torch.ops.experimental import probe
    from mdtpu_torch.ops.plane_sweep import plane_sweep

    assert os.path.abspath(mt.__file__).startswith(os.path.abspath(tree))
    pots = {"lj": mt.LennardJones(r_cut=2.5), "pseudo_hs": mt.PseudoHS(),
            "user": user_potential(mt)}
    kernels = {"plain": {"cell_sweep": cell_sweep, "plane_sweep": plane_sweep},
               "hilo": {"cell_sweep_hilo": cell_sweep_hilo},
               "plane": {"plane_sweep": plane_sweep}}
    out = {}
    for name, case in torch.load(inputs_path, weights_only=False).items():
        if case["kind"] in ("list", "list_hilo"):
            out.update(list_runs(name, case, pots["user"], pair_list,
                                 pair_sweep))
            continue
        if case["kind"] == "nl":
            out.update(nl_runs(name, case, pots["lj"]))
            continue
        if case["kind"] == "rdf":
            out.update(rdf_runs(name, case))
            continue
        if case["kind"] == "reduce":
            out.update(reduce_runs(name, case))
            continue
        args = (*(t.cuda() for t in case["inputs"]), case["grid"],
                case["cutoff"], pots[case["pot"]])
        for kernel, fn in kernels[case["kind"]].items():
            energy, virial, force = fn(*args)
            out[f"{name} {kernel}"] = {
                "energy": energy.cpu(), "virial": virial.cpu(),
                "force": force.cpu(), "ms": replay_ms(lambda: fn(*args))}
    w = probe.random_input(0, device="cuda")
    for spec in PROBE_SPECS:
        variant, chunk = probe.parse_variant(spec)
        fx, energy = probe.probe_sweep(w, variant, chunk)
        out[f"probe {spec}"] = {
            "energy": energy.cpu(), "virial": torch.zeros(()),
            "force": fx.cpu(),
            "ms": replay_ms(lambda: probe.probe_sweep(w, variant, chunk))}
    torch.save(out, out_path)


def list_runs(name, case, pot, pair_list, pair_sweep):
    """``pair_list`` (every buffer, the per-slot counts and starts, the
    total) and ``pair_sweep`` with the user potential on a list case."""
    t = [x.cuda() for x in case["inputs"]]
    lo = t.pop(1) if case["kind"] == "list_hilo" else None
    args = (*t, case["grid"], case["cutoff"])
    cap = case["capacity"]
    plist = pair_list(*args, cap, slot_lo=lo)
    energy, virial, force, _ = pair_sweep(*args, pot, cap, slot_lo=lo)
    return {
        f"{name} pair_list": {
            "list": {k: getattr(plist, k).cpu() for k in LIST_FIELDS},
            "entries": int(plist.total),
            "ms": replay_ms(lambda: pair_list(*args, cap, slot_lo=lo))},
        f"{name} pair_sweep": {
            "energy": energy.cpu(), "virial": virial.cpu(),
            "force": force.cpu(),
            "ms": replay_ms(lambda: pair_sweep(*args, pot, cap,
                                               slot_lo=lo))}}


def nl_runs(name, case, pot):
    """``nl_build`` (the rows, padding included, the counts and the flag)
    and ``nl_forces`` on the case's list, each given the particles' order
    by cell (and the build the cells' starts) where the tree's wrapper
    takes it."""
    from mdtpu_torch.ops import neighbor_list as nl

    pos, cid, buf, counts, lengths, order, starts, diam, idx, count = (
        t.cuda() for t in case["inputs"])
    b_args = (pos, cid, buf, counts, lengths, case["grid"], case["r_list"],
              case["max_neighbors"])
    b_kw = ({"order": order, "starts": starts} if "order" in
            inspect.signature(nl.nl_build).parameters else {})
    f_args = (pos, diam, idx, count, lengths, case["cutoff"], pot)
    f_kw = ({"order": order} if "order" in
            inspect.signature(nl.nl_forces).parameters else {})
    built = nl.nl_build(*b_args, **b_kw)
    energy, virial, force = nl.nl_forces(*f_args, **f_kw)
    return {
        f"{name} nl_build": {
            "list": {k: v.cpu() for k, v in
                     zip(("idx", "count", "overflow"), built)},
            "entries": int(built[1].sum()),
            "ms": replay_ms(lambda: nl.nl_build(*b_args, **b_kw))},
        f"{name} nl_forces": {
            "energy": energy.cpu(), "virial": virial.cpu(),
            "force": force.cpu(),
            "ms": replay_ms(lambda: nl.nl_forces(*f_args, **f_kw))}}


def call_ms(fn, reps=5):
    """The median time of ``reps`` whole calls of ``fn`` between two CUDA
    events each (the host's work inside the call included)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def rdf_runs(name, case):
    """``rdf_histogram``: the counts, the device time of what a CUDA graph
    can hold (the whole call on a tree without ``rdf_plan``, else the
    launch on the plan) and the whole call's time."""
    from mdtpu_torch.ops import rdf

    pos = case["inputs"][0].cuda()
    cell, inv = (t.cuda() for t in case["cell"])
    args = (pos, cell, inv, case["r_max"], 200)
    counts = rdf.rdf_histogram(*args)
    if hasattr(rdf, "rdf_plan"):
        plan = rdf.rdf_plan(*args)
        device = (lambda: rdf.rdf_launch(plan, pos))
    else:
        device = (lambda: rdf.rdf_histogram(*args))
    return {f"{name} rdf_histogram": {
        "counts": counts.cpu(), "ms": replay_ms(device),
        "call_ms": call_ms(lambda: rdf.rdf_histogram(*args))}}


def reduce_runs(name, case):
    """``pair_reduce`` full and lean on a list: energy, virial, forces,
    device times by graph replay, and the kernels of one full call."""
    from torch.profiler import ProfilerActivity, profile

    from mdtpu_torch.ops.cell_pairs import PairList, pair_reduce

    plist = PairList(**{k: v.cuda() for k, v in case["plist"].items()})
    u, f = case["u"].cuda(), case["f"].cuda()
    energy, virial, force = pair_reduce(plist, f, u)
    lean = pair_reduce(plist, f)[2]
    for _ in range(3):   # a profile that saw nothing on the device: again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pair_reduce(plist, f, u)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset"))]
        if kernels:
            break
    return {
        f"{name} pair_reduce": {
            "energy": energy.cpu(), "virial": virial.cpu(),
            "force": force.cpu(), "kernels_a_call": len(kernels),
            "ms": replay_ms(lambda: pair_reduce(plist, f, u))},
        f"{name} pair_reduce_lean": {
            "energy": torch.zeros(()), "virial": torch.zeros(()),
            "force": lean.cpu(),
            "ms": replay_ms(lambda: pair_reduce(plist, f))}}


def rel_diff(a, b):
    """The largest difference of ``a`` and ``b`` over the largest of ``b``
    (NaN as 0)."""
    a, b = (torch.nan_to_num(t.double(), nan=0.0) for t in (a, b))
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def same_bits(a, b):
    """Equal bit for bit, a NaN equal to a NaN at the same place."""
    if not a.is_floating_point():
        return a.dtype == b.dtype and bool(torch.equal(a, b))
    return bool(torch.equal(torch.nan_to_num(a, nan=0.0),
                            torch.nan_to_num(b, nan=0.0))
                and torch.equal(torch.isnan(a), torch.isnan(b)))


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
        times = {"parent_ms": p_ms, "change_ms": c_ms,
                 "parent_over_change": statistics.mean(p_ms)
                 / statistics.mean(c_ms),
                 "change_faster_in_every_run": max(c_ms) < min(p_ms)}
        if "counts" in p:
            print(json.dumps({
                "case": name, "counts_equal": same_bits(p["counts"],
                                                        c["counts"]),
                "pairs_inside": int(c["counts"].sum()) // 2,
                "parent_call_ms": [r[name]["call_ms"] for r in parent],
                "change_call_ms": [r[name]["call_ms"] for r in change],
                **times}), flush=True)
            continue
        if "list" in p:
            unequal = [k for k in p["list"]
                       if not same_bits(p["list"][k], c["list"][k])]
            print(json.dumps({"case": name, "list_equal": not unequal,
                              "unequal": unequal,
                              "entries": c["entries"], **times}),
                  flush=True)
            continue
        kernels = {f"{k}_kernels_a_call": r["kernels_a_call"]
                   for k, r in (("parent", p), ("change", c))
                   if "kernels_a_call" in r}
        print(json.dumps({
            "case": name, **kernels,
            "force_equal": same_bits(p["force"], c["force"]),
            "energy_equal": same_bits(p["energy"], c["energy"]),
            "virial_equal": same_bits(p["virial"], c["virial"]),
            "rel_energy_diff": rel_diff(c["energy"], p["energy"]),
            "rel_virial_diff": rel_diff(c["virial"], p["virial"]),
            "max_abs_force_diff": float(torch.nan_to_num(
                p["force"] - c["force"], nan=0.0).abs().max()),
            "max_abs_force": float(torch.nan_to_num(
                p["force"], nan=0.0).abs().max()), **times}),
            flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
