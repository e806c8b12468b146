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
at r_max 3; for the list's reduction, config 4's list (f64, f32) and the
3D lattice's (f32) with the user potential's values on them.
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
profiler, and each call's device time also by a graph of 100 calls,
``many_ms``, the host's replay spread over them); then the card's name and
power limit.

``--only slot`` holds the slot advance of the two trees to each other on
the bench's shapes (65,536 at f32, from this tree's start: the bench's
lattice, its cubic box and the tilted one [[L, L/8, L/12], [0, L, L/6],
[0, 0, L]], ``bench_2d.py``'s disks, and ``chip_smoke.py``'s Brownian
system, pseudo-hard spheres at rho 0.5 jittered by 0.05): NVT(1.0, 0.4)
then NVE on the hi/lo sweep (the 2D path's NVE on the plain one), or 225
Brownian(1.0) steps at dt 1e-5, each leg in segments of one step (25 of
them, each step full) then of 50 (lean steps inside); after every segment
energy, virial, temperature, the step and the Brownian accumulators, and
the bits of positions, their compensation, velocities, theirs, forces and
images (an int64 sum of each array's words, and the arrays themselves at
the end), and the rebuild steps. Each tree steps on its default route
(captured on the card), in the order parent, change, change, parent; it
prints one line per case: whether the arrays, the rebuild steps and the
temperature, step and sample count are equal bit for bit, whether energy,
virial and the virial's accumulator (sums whose order a tree may change)
agree within rel 1e-6, whether every row is equal bit for bit and repeats
within each tree, and the seconds each run took.

``--only reduce`` compares the list's reduction alone, on its three
lists (~2 min).

``--only draws`` compares the slot step's small kernels alone, each timed
by a CUDA graph of 100 calls back to back (replayed 20 times, over the
calls; the median of 5 rounds), where a graph of one call would time the
host's replay: ``bussi_draw`` (f32 and f64, the bench's nf - 1),
``uniform_noise``
on the bench's slots (3, 124,875) and the Brownian slot path's (3,
263,424), f32 and f64, ``rebuild_flag`` on the bench's slots f32,
``velocity_finish`` called directly on those slots (NVT summing with the
target from a device table and from the host, given the kinetic energy
with each, NVE summing), and the velocity finish's tail as each tree's
step runs it (``md_velocity_finish`` on those slots: NVT with its target
read from a device table at the step, and NVE; its kernels a call by the
profiler), with their values; and, where the tree has
``philox_draws.empty``, the launch floor (an empty kernel timed the same
way), where it takes ``programmatic`` also as a programmatic dependent.
Where the tree launches the finish and the noise as programmatic
dependents (it has ``philox_draws.plain_launch``), each is also timed in
plain stream order (`` plain launch``). It first prints which
trees were compared (the parent's directory and each tree's last line of
``CHANGES.md``), last the card's name and power limit.

``--only fire`` compares FIRE's kernels alone, timed the same way (a
graph of 100 in-place calls): ``fire_reduce`` (one pass), ``fire_test``
and ``fire_move`` at bench_fire's slots (3, 124,875) and particle rows
(65,536, 3, with the wrap in a cubic box of 40.3), f32 and f64, on one
set of inputs (forces ~30, velocities along them, positions in [0, 40),
dt 0.03, alpha 0.07, tol 1e-3, the loop going on), each tree's buffers
from its own ``fire_update.buffers``; each line gives the values (red and
scal after one call, the trees may sum in other orders, so their largest
relative difference beside bit equality; the move's positions,
velocities and images after one reduction and one move), the kernels a
call, both trees' times and the bound (the arrays read and written once
at 3.35 TB/s). The move also in turn with the reduction, a graph of 100
pairs as the FIRE loops run them, each tree's way of launching. Beside
them, as a yardstick over the same bytes (not the same
function), ``torch.linalg.vector_norm`` of F, and the launch floor. Then
FIRE's whole minimization in each tree (captured on the card) from
``bench_fire.py``'s system (65,536 f32): in slots, on ``PlaneEngine`` and
on the list (200 iterations at tol 0), sharded on a one-rank NCCL group,
and the packer (``initialize_state`` at rho 0.8): whether the positions
(bit for bit), the energy, the iterations and the rebuild steps are
equal across the trees and runs, and each run's seconds.

``--only rows`` compares the particle rows' drift test and Brownian move
alone (``rebuild_flag_rows``, ``brownian_rows``) at 65,536 rows, f32 and
f64, each timed by a graph of 100 in-place calls: the drift test by the
cell in the cubic and the tilted box, by the box lengths (the cell's
diagonal, a view) and in 2D (by the cell), on references with every
particle within skin/2 (0.3) and, for its value, also with one past it;
the Brownian move compensated and not, in place on a device step counter
(its values after one call from the same start: positions, compensation,
images, the virial's sample, the temperature, the step). Each line gives
whether the values are equal, both trees' times and the bound (the bytes
each must move at 3.35 TB/s). Beside them the launch floor (also as a
programmatic dependent where the tree has it), this tree's kernels in
plain stream order where it launches them as programmatic dependents, and,
as a yardstick over the same rows (not the same function), ``torch.any``
of a (65,536,) bool mask. Then the particle-order advance of the two trees
held to each other as ``--only slot`` holds the slot advance (the same
lines), on its default route (captured on the card): ``PlaneEngine`` (150
NVT steps uncompensated, then 100 NVE on the hi/lo sweep), the neighbour
list (150 NVT, 100 NVE) and Brownian on ``PlaneEngine`` (150 steps at dt
1e-5), from the bench's lattice and the Brownian system (65,536, f32),
each leg in segments of one step (25) then of 25.
"""

import argparse
import contextlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile
from types import SimpleNamespace

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
    cases.update(reduce_cases(cases, user))
    del big, states
    # The cases' boxes are orthorhombic: pass the box lengths, which every
    # tree's wrappers take (the cell matrix only since the 2D and tilted
    # sweeps).
    torch.save({k: dict(v, inputs=[
        torch.diagonal(t).contiguous().cpu() if t.dim() == 2
        and t.shape[0] == t.shape[1] == 3 else t.cpu()
        for t in v["inputs"]]) for k, v in cases.items()}, path)


def reduce_cases(cases, user):
    """The reduction's cases: config 4's list at f64 and f32 and the 3D
    lattice's at f32 (this tree's), the user potential's values on them."""
    from mdtpu_torch.ops.cell_pairs import pair_list
    out = {}
    for name in ("config4_f64", "config4_f32", "user_3d_lattice_f32"):
        case = cases[name]
        plist = pair_list(*case["inputs"], case["grid"], case["cutoff"],
                          case["capacity"])
        u, f = user.evaluate_r2(plist.r2, plist.sigma_i, plist.sigma_j)
        out[f"reduce_{name}"] = {
            "kind": "reduce", "inputs": [], "plist": {
                k: getattr(plist, k).cpu() for k in LIST_FIELDS + (
                    "overflow",)}, "u": u.cpu(), "f": f.cpu()}
    return out


def make_reduce_inputs(path):
    """The reduction's cases alone (:func:`reduce_cases`)."""
    import mdtpu_torch as mt
    from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                                lattice_fluid_state,
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
    lattice = lattice_fluid_state(N, 0.8, 1.0, dtype=torch.float64,
                                  cutoff=2.5, jitter=0.01, device="cuda")
    user = user_potential(mt)
    cases = {}
    for name, state, cutoff, dtype in (
            ("config4_f64", config4, 1.8, torch.float64),
            ("config4_f32", config4, 1.8, torch.float32),
            ("user_3d_lattice_f32", lattice, 2.5, torch.float32)):
        eng = mt.select_engine(user, cutoff, state)
        pos, cell = state.positions.to(dtype), state.unitcell.to(dtype)
        cinv = state.unitcell_inv.to(dtype)
        nb = eng.allocate(pos, state.diameters.to(dtype), cell, cinv)
        assert not bool(nb.overflow)
        cases[name] = {"grid": eng.grid, "cutoff": eng.cutoff,
                       "capacity": eng.pair_list_capacity,
                       "inputs": eng.slot_inputs(pos, cell, cinv, nb)}
    torch.save(reduce_cases(cases, user), path)


FIRE_SHAPES = {"slots": (3, 124875), "rows": (65536, 3)}
ROWS_FORMS = ("cell", "tilted", "lengths", "2d")


def make_rows_inputs(path):
    """The particle rows' inputs at 65,536 (f64; each tree rounds them to
    its dtype): for each drift-test form a box of side 43.7 (the bench's;
    the tilted one [[L, L/8, L/12], [0, L, L/6], [0, 0, L]], 2D a square),
    references in it and positions within 0.05 of them per axis; for the
    Brownian move positions, forces ~30, compensation ~1e-7 and images in
    the cubic box."""
    g = torch.Generator().manual_seed(22)
    n, side = 65536, (65536 / 0.8) ** (1.0 / 3.0)
    cases = {}
    for form in ROWS_FORMS:
        d = 2 if form == "2d" else 3
        cell = torch.eye(d, dtype=torch.float64) * side
        if form == "tilted":
            cell = torch.tensor([[side, side / 8, side / 12],
                                 [0.0, side, side / 6], [0.0, 0.0, side]],
                                dtype=torch.float64)
        frac = torch.rand((n, d), generator=g, dtype=torch.float64)
        ref = frac @ cell.T
        pos = ref + (torch.rand((n, d), generator=g, dtype=torch.float64)
                     - 0.5) * 0.1
        cases[f"rows {form}"] = {"kind": "rows", "form": form,
                                 "inputs": [ref, pos, cell]}
    cell = torch.eye(3, dtype=torch.float64) * side
    x = torch.rand((n, 3), generator=g, dtype=torch.float64) * side
    f = torch.randn((n, 3), generator=g, dtype=torch.float64) * 30
    xc = torch.randn((n, 3), generator=g, dtype=torch.float64) * 1e-7
    images = torch.randint(-3, 4, (n, 3), generator=g)
    cases["rows brownian"] = {"kind": "rows", "form": "brownian",
                              "inputs": [x, f, xc, images, cell]}
    starts = os.path.join(os.path.dirname(path), "starts.pt")
    make_slot_inputs(starts)
    slot = torch.load(starts, weights_only=False)
    for route, start in PARTICLE_ROUTES.items():
        cases[f"particle {route}"] = {**slot[start], "kind": "particle",
                                      "route": route}
    torch.save(cases, path)


# Particle-order routes: the start (a slot case's), then (ensemble, steps,
# compensated, hi/lo) legs.
PARTICLE_ROUTES = {"b2": "bench", "nl": "bench", "brownian": "brownian"}
PARTICLE_LEGS = {"b2": (("nvt", 150, False, False), ("nve", 100, True, True)),
                 "nl": (("nvt", 150, True, False), ("nve", 100, True, False)),
                 "brownian": (("brownian", 150, True, False),)}


def particle_runs(name, case):
    """The particle-order advance of the tree on one route, as
    :func:`slot_runs` records the slot advance."""
    import time

    import mdtpu_torch as mt
    from mdtpu_torch.integrate import step as tstep
    from mdtpu_torch.ops.experimental import PlaneEngine
    from mdtpu_torch.sim.initialization import build_state_from_arrays

    route = case["route"]
    brownian = route == "brownian"
    cutoff = 1.5 if brownian else 2.5
    pot = mt.PseudoHS() if brownian else mt.LennardJones(r_cut=2.5)
    state = build_state_from_arrays(
        case["positions"].cuda(), torch.ones(N), case["cell"], 1,
        dtype=torch.float32, cutoff=cutoff, device="cuda")
    if not brownian:
        state = state.replace(velocities=case["velocities"].cuda())
    eng = (mt.select_engine(pot, cutoff, state, prefer="neighbor")
           if route == "nl" else
           PlaneEngine.create(pot, cutoff, 0.3, state.unitcell, N))
    params = mt.Parameters(*((0.5, N, 1e-5) if brownian
                             else (0.8, N, 0.002)), pot)
    ensembles = {"nvt": mt.NVT(1.0, 0.4), "nve": mt.NVE(),
                 "brownian": mt.Brownian(1.0)}
    s, rows, words, rebuilds = state, [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ens, steps, comp, hilo in PARTICLE_LEGS[route]:
        advance = tstep.make_particle_advance(params, ensembles[ens], eng,
                                              comp, hilo=hilo)
        for k in [1] * 25 + [25] * ((steps - 25) // 25):
            s = advance(s, k)
            rows.append([float(s.energy), float(s.virial),
                         float(s.temperature), int(s.step),
                         float(s.virial_accum), int(s.nprom)])
            words.append([_words(getattr(s, f)) for f in SLOT_FIELDS])
        rebuilds.append(advance.rebuild_steps())
    torch.cuda.synchronize()
    return {f"{name} particle_advance": {
        "rows": rows, "words": words, "rebuilds": rebuilds,
        "arrays": {f: getattr(s, f).cpu() for f in SLOT_FIELDS},
        "seconds": time.perf_counter() - t0}}


def rows_runs(name, case):
    """``rebuild_flag_rows`` (a drift-test form) or ``brownian_rows`` as
    this tree has them on the case's inputs, f32 and f64: values after one
    call, a graph of 100 in-place calls each (also in plain stream order
    where the tree launches them as programmatic dependents), the bound;
    beside the drift test ``torch.any`` of a bool mask over the rows; the
    launch floor."""
    import types

    from mdtpu_torch.integrate import verlet_update as vu
    from mdtpu_torch.ops import philox_draws as draws
    ways = ([("", contextlib.nullcontext)] if not hasattr(draws, "rows_grid")
            else [("", contextlib.nullcontext),
                  (" plain launch", draws.plain_launch)])
    out = {}
    for dtype in (torch.float32, torch.float64):
        tag = "" if dtype == torch.float32 else " f64"
        size = torch.empty((), dtype=dtype).element_size()
        if case["form"] != "brownian":
            ref, pos, cell = (t.to(device="cuda", dtype=dtype)
                              for t in case["inputs"])
            n, d = ref.shape
            box = (dict(lengths=torch.diagonal(cell))
                   if case["form"] == "lengths" else
                   dict(cell=cell,
                        cell_inv=torch.linalg.inv(cell).contiguous()))
            moved = pos.clone()
            moved[n // 3] += 0.2

            def values(box=box, moved=moved):
                return torch.stack([draws.rebuild_flag_rows(
                    p, ref, 0.3, **box) for p in (pos, moved)]).double().cpu()
            flag = torch.empty((), dtype=torch.bool, device="cuda")

            def call():
                draws.rebuild_flag_rows(pos, ref, 0.3, out=flag, **box)
            bound = 2 * n * d * size / 3.35e12 * 1e3
            mask = torch.zeros(n, dtype=torch.bool, device="cuda")
            out[f"{name} torch_any{tag}"] = {
                "values": torch.any(mask).reshape(1).double().cpu(),
                "ms": many_ms(lambda: torch.any(mask)),
                "bound_ms": n / 3.35e12 * 1e3,
                **kernels_of(lambda: torch.any(mask))}
            kernels = {f"{name} rebuild_flag_rows{tag}": (call, values,
                                                          bound)}
        else:
            x, f, xc, images, cell = case["inputs"]
            x, f, xc, cell = (t.to(device="cuda", dtype=dtype)
                              for t in (x, f, xc, cell))
            images = images.cuda()
            n, d = x.shape
            cell_inv = torch.linalg.inv(cell).contiguous()
            coeffs = vu.brownian_coefficients(1e-5, 1.0, dtype)
            w = torch.tensor(-1234.5, dtype=dtype, device="cuda")
            kernels = {}
            for comp in (True, False):
                def state():
                    return types.SimpleNamespace(
                        positions=x.clone(), pos_comp=xc.clone(),
                        images=images.clone(), unitcell=cell,
                        unitcell_inv=cell_inv, seed=3,
                        step=torch.tensor(123450, device="cuda"),
                        dtype=dtype, device=x.device,
                        virial_accum=torch.tensor(2.5, dtype=dtype,
                                                  device="cuda"),
                        nprom=torch.tensor(4, device="cuda"),
                        temperature=torch.tensor(0.0, dtype=dtype,
                                                 device="cuda"))
                def values(state=state, comp=comp):
                    st = state()
                    vu.brownian_rows(f, w, st, *coeffs, comp, in_place=True)
                    return torch.cat([t.double().reshape(-1).cpu() for t in (
                        st.positions, st.pos_comp, st.images,
                        st.virial_accum, st.nprom, st.temperature, st.step)])
                timed = state()
                arrays = 5 if comp else 3
                kernels[f"{name} brownian_rows"
                        f"{'' if comp else ' uncompensated'}{tag}"] = (
                    (lambda st=timed, comp=comp: vu.brownian_rows(
                        f, w, st, *coeffs, comp, in_place=True)),
                    values, (arrays * size + 16) * n * d / 3.35e12 * 1e3)
        for key, (call, values, bound) in kernels.items():
            for suffix, way in ways:
                with way():
                    call()
                    out[key + suffix] = {"values": values(),
                                         "ms": many_ms(call),
                                         "bound_ms": bound,
                                         **kernels_of(call)}
    if hasattr(draws, "empty"):
        out["launch_floor"] = {"ms": many_ms(lambda: draws.empty("cuda"))}
        if "programmatic" in inspect.signature(draws.empty).parameters:
            out["launch_floor programmatic"] = {"ms": many_ms(
                lambda: draws.empty("cuda", True))}
    return out


def make_fire_inputs(path):
    """FIRE's kernels' inputs at bench_fire's slots and particle rows
    (f64; each tree rounds them to its dtype): forces ~30, velocities
    along them, and positions in [0, 40) (rows: in a cubic box of
    40.3)."""
    g = torch.Generator().manual_seed(21)
    cases = {}
    for layout, shape in FIRE_SHAPES.items():
        f = torch.randn(shape, generator=g, dtype=torch.float64) * 30
        v = torch.randn(shape, generator=g, dtype=torch.float64) + 0.01 * f
        x = torch.rand(shape, generator=g, dtype=torch.float64) * 40.0
        cases[f"fire {layout}"] = {"kind": "fire", "inputs": [f, v, x],
                                   "rows": layout == "rows"}
    cases["minimize"] = {"kind": "fire_min"}
    torch.save(cases, path)


def fire_runs(name, case):
    """``fire_reduce``, ``fire_test`` and ``fire_move`` as this tree has
    them on the case's inputs, f32 and f64, a graph of 100 in-place calls
    each, their values after one call (the move's after one reduction,
    from its scalars), the bound; the reduction and the move in turn, a
    graph of 100 pairs (the FIRE loops' order); ``vector_norm`` of F the
    same way; the launch floor."""
    from mdtpu_torch.minimize import fire_update as fu
    from mdtpu_torch.ops import philox_draws as draws
    out = {}
    rows = case["rows"]
    for dtype in (torch.float32, torch.float64):
        f, v, x = (t.to(device="cuda", dtype=dtype) for t in case["inputs"])
        size = f.element_size()
        tag = "" if dtype == torch.float32 else " f64"
        box = {}
        if rows:
            # Contiguous, as the FIRE loops hand the box over (a box the
            # wrapper had to copy would add a kernel to each call).
            cell = torch.eye(3, dtype=dtype, device="cuda") * 40.3
            box = dict(cell=cell,
                       cell_inv=torch.linalg.inv(cell).contiguous())
        img = torch.zeros(f.shape, dtype=torch.int64, device="cuda")

        def buffers():
            scal, ints, red, work, flags = fu.buffers(dtype, "cuda",
                                                      f.numel())
            scal[fu.DT], scal[fu.ALPHA], scal[fu.TOL] = 0.03, 0.07, 1e-3
            ints[fu.MAX_STEPS] = 1 << 60
            return scal, ints, red, work, flags

        hyper = fu.FireHyper()
        calls = {
            "fire_reduce": (2, lambda b: fu.fire_reduce(
                v, f, b[0], b[1], b[2][:fu.RED], b[3], hyper)),
            "fire_test": (1, lambda b: fu.fire_test(
                f, b[0], b[1], b[2][fu.RED:], b[3], 17.0, b[4]))}
        for kernel, (arrays, call) in calls.items():
            b = buffers()
            call(b)
            values = torch.cat([b[2].double(), b[0].double()]).cpu()
            b = buffers()
            out[f"{name} {kernel}{tag}"] = {
                "values": values, "ms": many_ms(lambda: call(b)),
                "bound_ms": arrays * f.numel() * size / 3.35e12 * 1e3,
                **kernels_of(lambda: call(b))}

        def move(b, xs, vs, imgs):
            kw = dict(box, images=imgs) if rows else {}
            fu.fire_move(xs, vs, f, b[0], b[1], hyper.dmax, rows=rows, **kw)

        # The move from one reduction's scalars: x, v (and images) after it.
        b = buffers()
        calls["fire_reduce"][1](b)
        xs, vs, imgs = x.clone(), v.clone(), img.clone()
        move(b, xs, vs, imgs)
        values = torch.cat([xs.double().flatten(), vs.double().flatten()]
                           + ([imgs.double().flatten()] if rows else [])).cpu()
        move_bytes = (5 * size + (16 if rows else 0)) * f.numel()
        xs, vs, imgs = x.clone(), v.clone(), img.clone()
        out[f"{name} fire_move{tag}"] = {
            "values": values, "ms": many_ms(lambda: move(b, xs, vs, imgs)),
            "bound_ms": move_bytes / 3.35e12 * 1e3,
            **kernels_of(lambda: move(b, xs, vs, imgs))}

        def pair(b):
            calls["fire_reduce"][1](b)
            move(b, xs, vs, imgs)
        b = buffers()
        out[f"{name} fire_reduce+fire_move{tag}"] = {
            "values": values, "ms": many_ms(lambda: pair(b)),
            "bound_ms": (move_bytes + 2 * size * f.numel()) / 3.35e12 * 1e3,
            **kernels_of(lambda: pair(b))}
        norm = torch.linalg.vector_norm(f).reshape(1).double().cpu()
        out[f"{name} vector_norm{tag}"] = {
            "values": norm, "ms": many_ms(lambda: torch.linalg.vector_norm(f)),
            "bound_ms": f.numel() * size / 3.35e12 * 1e3,
            **kernels_of(lambda: torch.linalg.vector_norm(f))}
    if hasattr(draws, "empty"):
        out["launch_floor"] = {"ms": many_ms(lambda: draws.empty("cuda"))}
    return out


# The minimizations each tree runs (the bench_fire system, 65,536 f32): by
# the engine (the cell grid in slots, PlaneEngine, the list, the sharded
# engine) and the packer; and the iterations at tol 0.
FIRE_MINIMIZATIONS = ("slots", "plane", "list", "sharded", "pack")
FIRE_MIN_ITERS = 200


def fire_min_runs(name, case):
    """FIRE's whole minimization as the tree runs it (captured on the
    card): ``bench_fire.py``'s system (the bench's lattice jittered by
    0.05, 65,536 LJ f32) through ``fire_minimize`` on the cell grid in
    slots, on ``PlaneEngine`` and on the list in particle order, 200
    iterations at tol 0, through ``fire_minimize_sharded`` on a one-rank
    NCCL group, and the packer (``initialize_state`` at 65,536, rho 0.8,
    seed 0): each run's positions, energy, iterations and the iterations
    after which it rebuilt (the last minimization's)."""
    import tempfile as _tempfile
    import time

    import torch.distributed as dist

    import mdtpu_torch as mt
    from mdtpu_torch.minimize import fire as fire_mod
    from mdtpu_torch.ops.experimental import PlaneEngine
    from mdtpu_torch.sim.initialization import lattice_fluid_state
    out = {}
    params = mt.Parameters(density=0.8, n_particles=N, dt=0.002,
                           potential=mt.LennardJones(r_cut=2.5))
    with _tempfile.TemporaryDirectory() as work:
        for kind in FIRE_MINIMIZATIONS:
            state = lattice_fluid_state(N, 0.8, 1.0, dtype=torch.float32,
                                        cutoff=2.5, jitter=0.05,
                                        device="cuda")
            runs = []
            record = fire_mod.fire_minimize

            def recorded(*args, **kwargs):
                result = record(*args, **kwargs)
                runs.append(result[3])
                return result
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "pack":
                fire_mod.fire_minimize = recorded
                try:
                    end = mt.initialize_state(
                        params, os.path.join(work, "pack"), seed=0,
                        cutoff=2.5, device="cuda")
                finally:
                    fire_mod.fire_minimize = record
                energy, n = end.energy, runs
            elif kind == "sharded":
                from mdtpu_torch.minimize import fire_minimize_sharded
                dist.init_process_group(
                    "nccl", init_method="file://" + os.path.join(
                        work, "store"), world_size=1, rank=0,
                    device_id=torch.device("cuda", 0))
                end, energy, _, n = fire_minimize_sharded(
                    state, params, max_steps=FIRE_MIN_ITERS, tol=0.0)
            else:
                engine = {"slots": lambda: mt.select_engine(
                              params.potential, 2.5, state),
                          "plane": lambda: PlaneEngine.create(
                              params.potential, 2.5, 0.3, state.unitcell, N),
                          "list": lambda: mt.select_engine(
                              params.potential, 2.5, state,
                              prefer="neighbor")}[kind]()
                end, energy, _, n = mt.fire_minimize(
                    state, params, engine, max_steps=FIRE_MIN_ITERS, tol=0.0)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            fire = next(reversed(fire_mod._CACHE.values()), None)
            out[f"{name} {kind}"] = {
                "positions": end.positions.cpu(),
                "energy": float(energy), "iterations": n,
                "rebuilds": fire.rebuild_steps() if fire else None,
                "seconds": seconds}
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


def make_draw_inputs(path):
    """The draws' inputs: reference positions, a drift below skin/2 and
    velocities on the bench's slots (3, 15^3 x 37), f32."""
    g = torch.Generator().manual_seed(4)
    shape = (3, 15 ** 3 * 37)
    ref = torch.rand(shape, generator=g) * 40.0
    drift = (torch.rand(shape, generator=g) - 0.5) * 0.08
    v = torch.randn(shape, generator=g)
    torch.save({"bench": {"kind": "draws", "inputs": [ref, drift, v]}}, path)


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


def many_ms(fn, calls=100):
    """Device time of one call of ``fn`` (already called once): a CUDA
    graph of ``calls`` calls replayed 20 times between two CUDA events,
    over the calls; the median of 5 rounds."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
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
        rounds.append(start.elapsed_time(stop) / 20 / calls)
    return statistics.median(rounds)


def kernels_of(fn):
    """The kernels one call of ``fn`` runs on the device, by the profiler
    (copies and memsets apart); a profile that saw nothing is taken
    again."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return {"kernels": sum(not n.startswith(("Memcpy", "Memset"))
                           for n in names),
            "memsets": sum(n.startswith("Memset") for n in names)}


# The Brownian slot path's slots (the Brownian system at rho 0.5 on
# select_engine's cell grid, as chip_smoke.py builds it).
BROWNIAN_SLOTS = (3, 263424)


def draw_runs(name, case):
    """The slot step's small kernels and its velocity finish as this tree
    has them, on the case's inputs; where the tree launches the finish and
    the noise as programmatic dependents, each also in plain stream order
    (`` plain launch``)."""
    import mdtpu_torch as mt
    from mdtpu_torch.integrate import step as tstep
    from mdtpu_torch.integrate import velocity_finish as vf
    from mdtpu_torch.ops import philox_draws as draws

    ref, drift, v = (t.cuda() for t in case["inputs"])
    pos = ref + drift
    shape = tuple(v.shape)
    step = torch.tensor(123456, device="cuda")
    dof = 3.0 * (N - 1) - 1.0
    out = {}
    ways = {"": contextlib.nullcontext}
    if hasattr(draws, "plain_launch"):
        ways[" plain launch"] = draws.plain_launch

    def record(kernel, fn, value_fn, both_ways=False):
        """Times ``fn`` the tree's way and, where ``both_ways``, in each of
        ``ways``."""
        for label, way in ways.items():
            if label and not both_ways:
                continue
            with way():
                values = value_fn()
                out[f"{name} {kernel}{label}"] = {
                    "values": values, "ms": many_ms(fn), **kernels_of(fn)}

    for dname, dtype in (("", torch.float32), (" f64", torch.float64)):
        record(f"bussi_draw{dname}",
               lambda dtype=dtype: draws.bussi_draw(0, step, dof, dtype),
               lambda dtype=dtype: draws.bussi_draw(0, step, dof,
                                                    dtype).cpu())
    for sname, shp in (("", shape), (" brownian_slot", BROWNIAN_SLOTS)):
        for dname, dtype in (("", torch.float32), (" f64", torch.float64)):
            record(f"uniform_noise{sname}{dname}",
                   lambda shp=shp, dtype=dtype: draws.uniform_noise(
                       3, step, shp, dtype),
                   lambda shp=shp, dtype=dtype: draws.uniform_noise(
                       3, step, shp, dtype).cpu(), True)
    flag = torch.ones((), dtype=torch.bool, device="cuda")
    record("rebuild_flag",
           lambda: draws.rebuild_flag(pos, ref, 0.3, out=flag),
           lambda: draws.rebuild_flag(pos, ref, 0.3, out=flag).cpu()
           .reshape(1))
    # The velocity finish's variants called directly: NVT summing with
    # the target from a device table and from the host, given K (the
    # sharded route's call) with each, NVE summing.
    table = torch.linspace(1.4, 0.9, 1024, device="cuda")
    base = torch.tensor(123000, device="cuda")
    kin = (0.5 * (v.double() ** 2).sum()).float()
    for label, kv, target in (
            ("nvt table", (v, None), lambda: vf.TargetTable(table, base)),
            ("nvt host", (v, None), lambda: 1.0),
            ("given_k table", (None, kin),
             lambda: vf.TargetTable(table, base)),
            ("given_k host", (None, kin), lambda: 1.0),
            ("nve", (v, None), lambda: None)):
        def finish(kv=kv, target=target):
            return vf.velocity_finish(*kv, 7, step, 3.0 * (N - 1), 0.002,
                                      0.4, target())
        record(f"velocity_finish {label}", finish,
               lambda finish=finish: torch.stack(finish()).cpu(), True)
    # The tail as the tree's slot step calls it: NVT's target from the
    # advance's device table at the step (a TargetTable where the tree has
    # one, else the 0-d target its advance read by index_select).
    state = SimpleNamespace(step=step, seed=7, nf=3.0 * (N - 1))
    vc = torch.zeros_like(v)
    try:
        from mdtpu_torch.integrate.velocity_finish import TargetTable

        def target():
            return TargetTable(table, base)
    except ImportError:
        def target():
            return table.index_select(0, (step - base).reshape(1))[0]
    for label, ens in (("nvt_tail", mt.NVT(1.0, 0.4)), ("nve_tail",
                                                        mt.NVE())):
        def tail(ens=ens):
            return tstep.md_velocity_finish(
                ens, v, vc, state, 0.002, True,
                ktemp=target() if isinstance(ens, mt.NVT) else None)

        def values(tail=tail):
            vv, _, temp = tail()
            scale = (vv.double().norm() / v.double().norm()).reshape(1)
            return torch.cat([scale, temp.double().reshape(1)]).cpu()
        record(label, tail, values, True)
    if hasattr(draws, "empty"):
        out["launch_floor"] = {"ms": many_ms(lambda: draws.empty("cuda"))}
        if "programmatic" in inspect.signature(draws.empty).parameters:
            out["launch_floor programmatic"] = {"ms": many_ms(
                lambda: draws.empty("cuda", True))}
    return out


# The slot cases: (name, start, NVT steps, NVE steps, NVE on hi/lo); the
# Brownian case's first number is its Brownian steps.
SLOT_CASES = (("bench", "cubic", 75, 75, True),
              ("tilted", "tilted", 75, 75, True),
              ("2d", "2d", 75, 75, False),
              ("brownian", "brownian", 225, 0, False))
# Row columns: energy, virial, temperature, step, virial_accum, nprom. A
# sum's columns may differ between trees by its order (rel
# SLOT_SUM_RTOL); the others are held bit for bit.
SLOT_SUM_COLUMNS = (0, 1, 4)
SLOT_SUM_RTOL = 1e-6
SLOT_FIELDS = ("positions", "pos_comp", "velocities", "vel_comp", "forces",
               "images")


def make_slot_inputs(path):
    """The slot cases' starts in particle order (f32): positions,
    velocities, diameters and the cell matrix."""
    from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                                initialize_velocities,
                                                lattice_positions)
    cases = {}
    for name, kind, *_ in SLOT_CASES:
        dim = 2 if kind == "2d" else 3
        rho = {"2d": 0.7, "brownian": 0.5}.get(kind, 0.8)
        L = (N / rho) ** (1.0 / dim)
        cell = torch.eye(dim, dtype=torch.float64) * L
        if kind == "tilted":
            cell[0, 1], cell[0, 2], cell[1, 2] = L / 8, L / 12, L / 6
        pos = lattice_positions(N, cell, dim, dtype=torch.float64,
                                jitter=0.05 if kind == "brownian" else 0.01,
                                seed=0, device="cuda")
        state = build_state_from_arrays(
            pos, torch.ones(N), cell, 1, dtype=torch.float32,
            cutoff=1.5 if kind in ("2d", "brownian") else 2.5,
            device="cuda")
        vel = initialize_velocities(1.0, 2, N, dim, dtype=torch.float32,
                                    device="cuda")
        cases[name] = {"kind": "slot", "positions": state.positions.cpu(),
                       "velocities": vel.cpu(), "cell": cell}
    torch.save(cases, path)


def _words(t):
    """An int64 sum of the array's words: equal arrays give equal sums."""
    t = t.contiguous()
    w = t.view(torch.int32) if t.element_size() == 4 else t.view(
        torch.int64)
    return int(w.sum(dtype=torch.int64))


def slot_runs(name, case):
    """The slot advance of the tree on one case: after every segment its
    numbers and its arrays' word sums; the final arrays; the rebuilds."""
    import time

    import mdtpu_torch as mt
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.sim.initialization import build_state_from_arrays

    _, kind, n_first, n_nve, hilo = next(c for c in SLOT_CASES
                                         if c[0] == name)
    dim = case["cell"].shape[0]
    brownian = kind == "brownian"
    cutoff = 2.5 if kind in ("cubic", "tilted") else 1.5
    pot = mt.LennardJones(r_cut=2.5) if cutoff == 2.5 else mt.PseudoHS()
    state = build_state_from_arrays(
        case["positions"].cuda(), torch.ones(N), case["cell"], 1,
        dtype=torch.float32, cutoff=cutoff, device="cuda")
    if not brownian:
        state = state.replace(velocities=case["velocities"].cuda())
    eng = mt.select_engine(pot, cutoff, state)
    params = mt.Parameters(*{"2d": (0.7, N, 0.001), "brownian": (
        0.5, N, 1e-5)}.get(kind, (0.8, N, 0.002)), pot)
    s = slot_step.slotify(state, eng)
    if not brownian:
        s = slot_step.slot_forces(s, eng)
    rows, words, rebuilds = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    legs = (((mt.Brownian(1.0), n_first, False),) if brownian else
            ((mt.NVT(1.0, 0.4), n_first, False), (mt.NVE(), n_nve, hilo)))
    for ens, steps, h in legs:
        advance = slot_step.make_slot_advance(params, ens, eng, hilo=h)
        segments = [1] * 25 + [50] * ((steps - 25) // 50)
        for k in segments:
            s = advance(s, k)
            rows.append([float(s.energy), float(s.virial),
                         float(s.temperature), int(s.step),
                         float(s.virial_accum), int(s.nprom)])
            words.append([_words(getattr(s, f)) for f in SLOT_FIELDS])
        rebuilds.append(advance.rebuild_steps())
    torch.cuda.synchronize()
    return {f"{name} slot_advance": {
        "rows": rows, "words": words, "rebuilds": rebuilds,
        "arrays": {f: getattr(s, f).cpu() for f in SLOT_FIELDS},
        "seconds": time.perf_counter() - t0}}


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
    cases = torch.load(inputs_path, weights_only=False)
    for name, case in cases.items():
        if case["kind"] == "slot":
            out.update(slot_runs(name, case))
            continue
        if case["kind"] == "draws":
            out.update(draw_runs(name, case))
            continue
        if case["kind"] == "fire":
            out.update(fire_runs(name, case))
            continue
        if case["kind"] == "fire_min":
            out.update(fire_min_runs(name, case))
            continue
        if case["kind"] == "rows":
            out.update(rows_runs(name, case))
            continue
        if case["kind"] == "particle":
            out.update(particle_runs(name, case))
            continue
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
    if all(c["kind"] in ("draws", "slot", "reduce", "fire", "fire_min",
                         "rows", "particle") for c in cases.values()):
        torch.save(out, out_path)
        return
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
            "ms": replay_ms(lambda: pair_reduce(plist, f, u)),
            "many_ms": many_ms(lambda: pair_reduce(plist, f, u))},
        f"{name} pair_reduce_lean": {
            "energy": torch.zeros(()), "virial": torch.zeros(()),
            "force": lean.cpu(),
            "ms": replay_ms(lambda: pair_reduce(plist, f)),
            "many_ms": many_ms(lambda: pair_reduce(plist, f))}}


def last_change(tree):
    """The last line of ``tree``'s ``CHANGES.md`` (its first 160
    characters): which state of the repository the tree is."""
    try:
        with open(os.path.join(tree, "CHANGES.md")) as f:
            lines = [x for x in f.read().splitlines() if x.strip()]
    except OSError:
        return None
    return lines[-1][:160] if lines else None


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
    parser.add_argument("--only", choices=("draws", "slot", "reduce",
                                           "fire", "rows"),
                        help="compare the slot step's small kernels alone, "
                        "the slot advance's bits alone, the list's "
                        "reduction alone, FIRE's three kernels alone, or "
                        "the particle rows' drift test and Brownian move "
                        "alone")
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
        {"draws": make_draw_inputs, "slot": make_slot_inputs,
         "reduce": make_reduce_inputs, "fire": make_fire_inputs,
         "rows": make_rows_inputs}.get(
             args.only, make_inputs)(inputs)
        runs = []
        for i, tree in enumerate((args.parent, HERE, HERE, args.parent)):
            out = os.path.join(tmp, f"out{i}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", os.path.abspath(tree), inputs, out],
                           check=True)
            runs.append(torch.load(out, weights_only=False))
    parent, change = (runs[0], runs[3]), (runs[1], runs[2])
    print(json.dumps({"parent_tree": os.path.abspath(args.parent),
                      "parent_last_change": last_change(args.parent),
                      "change_last_change": last_change(HERE)}), flush=True)
    # What only this tree has (the floor, the plain launch of the same
    # kernels): its times alone.
    for name in runs[1]:
        if name not in runs[0] or name.startswith("launch_floor"):
            base = name.removesuffix(" plain launch")
            same = ({"values_equal_to_the_trees_way": same_bits(
                runs[1][name]["values"], runs[1][base]["values"])}
                if base != name and "values" in runs[1][name] else {})
            print(json.dumps({"case": name, **same, "change_ms": [
                r[name]["ms"] for r in change], **({"parent_ms": [
                    r[name]["ms"] for r in parent]}
                    if name in runs[0] else {})}), flush=True)
    for name in runs[0]:
        if name.startswith("launch_floor") or name not in runs[1]:
            continue
        p, c = parent[0][name], change[0][name]
        if "positions" in p:
            equal = {
                "positions": all(same_bits(r[name]["positions"],
                                           p["positions"]) for r in runs),
                **{k: all(r[name][k] == p[k] for r in runs)
                   for k in ("energy", "iterations", "rebuilds")}}
            print(json.dumps({
                "case": name, "equal": all(equal.values()), **equal,
                "energy": c["energy"], "iterations": c["iterations"],
                "rebuild_steps": c["rebuilds"],
                "parent_seconds": [r[name]["seconds"] for r in parent],
                "change_seconds": [r[name]["seconds"] for r in change]}),
                flush=True)
            continue
        if "rows" in p:
            exact = [i for i in range(len(p["rows"][0]))
                     if i not in SLOT_SUM_COLUMNS]
            equal = {k: all(r[name][k] == p[k] for r in runs)
                     for k in ("words", "rebuilds")}
            equal["exact_columns"] = all(
                [row[i] for i in exact] == [prow[i] for i in exact]
                for r in runs for row, prow in zip(r[name]["rows"],
                                                   p["rows"]))
            equal["arrays"] = all(same_bits(r[name]["arrays"][f],
                                            p["arrays"][f])
                                  for r in runs for f in SLOT_FIELDS)
            sum_rel = max(abs(row[i] - prow[i]) / max(abs(prow[i]), 1e-300)
                          for r in change for row, prow in
                          zip(r[name]["rows"], p["rows"])
                          for i in SLOT_SUM_COLUMNS)
            equal["sum_columns_within_rtol"] = sum_rel <= SLOT_SUM_RTOL
            print(json.dumps({
                "case": name, "equal": all(equal.values()), **equal,
                "rows_bits_equal": all(r[name]["rows"] == p["rows"]
                                       for r in runs),
                "rows_repeat": all(r[name]["rows"] == rr[name]["rows"]
                                   for r, rr in (parent, change)),
                "sum_columns_max_rel_diff": sum_rel,
                "segments": len(p["rows"]), "steps": p["rows"][-1][3],
                "rebuilds": [len(b) for b in p["rebuilds"]],
                "parent_seconds": [r[name]["seconds"] for r in parent],
                "change_seconds": [r[name]["seconds"] for r in change]}),
                flush=True)
            continue
        p_ms = [r[name]["ms"] for r in parent]
        c_ms = [r[name]["ms"] for r in change]
        times = {"parent_ms": p_ms, "change_ms": c_ms,
                 "parent_over_change": statistics.mean(p_ms)
                 / statistics.mean(c_ms),
                 "change_faster_in_every_run": max(c_ms) < min(p_ms)}
        if "values" in p:
            print(json.dumps({
                "case": name,
                "values_equal": same_bits(p["values"], c["values"]),
                "values_max_rel_diff": rel_diff(c["values"], p["values"]),
                **({"bound_ms": c["bound_ms"]} if "bound_ms" in c else {}),
                **({"parent_values": p["values"].tolist(),
                    "change_values": c["values"].tolist()}
                   if p["values"].numel() <= 8 else {}),
                **{f"{t}_{k}": r[k] for t, r in (("parent", p), ("change", c))
                   for k in ("kernels", "memsets")}, **times}), flush=True)
            continue
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
        if "many_ms" in p:
            kernels.update(
                parent_many_ms=[r[name]["many_ms"] for r in parent],
                change_many_ms=[r[name]["many_ms"] for r in change])
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
