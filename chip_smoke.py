#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mdtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, the torch and CUDA versions, and
   builds the six CUDA sources of ``mdtpu_torch/csrc`` and its host C++
   frame formatter (one ``nvcc`` or ``g++`` each, started together;
   ``-Xptxas -v`` summary: registers and spills of every entry of
   ``cell_sweep.cu`` and ``plane_sweep.cu``, the report lines of the probe,
   the pair list, the RDF histogram and the neighbour list).
2. Kernel phase, at the bench geometry (N = 65,536 Lennard-Jones, rho 0.8,
   r_c 2.5: a 15^3 grid with capacity C = 37) on the jittered lattice and on
   the melted fluid (the lattice after 300 NVT steps), and for pseudo-hard
   spheres (rho 0.76, r_c 1.5), each kernel against its plain version on the
   same inputs:
   * ``cell_sweep`` and ``plane_sweep`` at f32 and f64: f64 to rtol 1e-12 on
     energy and virial and 1e-10 on each particle's force relative to the
     larger of its own magnitude and the RMS force; f32 to 1e-5 on both (the
     two sum in different orders). ``plane_sweep`` also against
     ``cell_sweep``: at f64 to the same 1e-12 / 1e-10; at f32 both against
     the f64 plain sweep on the same inputs (a pair that crosses the box edge
     rounds its displacement differently from its two sides, so the two f32
     sweeps differ by the rounding of absolute coordinates): the half
     stencil's per-particle error at most twice the full stencil's, energy
     and virial within 1e-5;
   * ``cell_sweep_hilo`` at f32 on hi/lo words of an f64 state: against its
     plain version to 1e-5, and against the f64 plain sweep on hi + lo, where
     its per-particle error must be at least 5 times smaller than the plain
     f32 sweep's on hi;
   * ``cell_sweep``, ``cell_sweep_hilo`` and ``plane_sweep`` launched twice
     on the same inputs give the same bits (forces, energy, virial);
   * ``plane_sweep`` at f32 and f64 against its plain version, at the same
     tolerances, on the grid and capacity of the Brownian path below
     (pseudo-hard spheres, rho 0.5, r_c 1.5, through ``PlaneEngine.create``);
   * the lean variants (``observables=False``) of ``cell_sweep`` (f32, f64)
     and ``cell_sweep_hilo`` on the Lennard-Jones cases: forces bit-equal to
     the full variant's, against the plain lean version at the full
     variant's force tolerance, two launches bit for bit;
   * the packer's ``Overlap`` functor through ``cell_sweep`` (full and lean,
     f32 and f64) on the packing path's start (65,536 uniform random
     positions at rho 0.8, tol 1, the engine grown as the path grows it),
     against the plain version at the same tolerances;
   * 2D and tilted boxes: ``cell_sweep`` (f64, f32, full and lean) and
     ``cell_sweep_hilo`` (full and lean) on ``bench_2d.py``'s 2D system
     after 200 NVT steps, on the same in a box tilted by L/8, and on the
     bench's LJ start in the tilted 3D box of the tilted path, at the same
     tolerances, lean forces bit-equal, two launches bit for bit, timed in
     turns;
   * the pair list (``cell_pairs``, f64, f32 and hi/lo) entry for entry
     against its plain version, and its reduction (``pair_reduce``, f64
     and f32, full and lean) against its plain version and timed against
     ``index_add_``, the full one's kernels a call counted by the profiler
     (one), each against its own bound, on config 4's density and
     diameters on a lattice.
   Times the sweeps in turns within this call (cell, plane, hi/lo and the
   lean variants, there and back, five times, and their medians): each
   wrapper call is
   captured in a CUDA graph once and the graph replayed 20 times between two
   CUDA events, so the time is the device's (the kernel and the wrapper's two
   sums, without the host's time between launches, which at these kernel
   times would be most of it). Prints each sweep's staging plan, its resident
   blocks per SM and, for ``plane_sweep``, the registers of the kernel it
   runs (from the compiler's report), and works out the bound from this
   run's inputs:
   each unordered pair inside the cutoff once, each occupied slot's inputs
   read once, each output written once; the stencil's own work beside it.
3. Probe phase: the probe's path (``probe.run`` over its default variants),
   then every variant of ``plane_probe`` against its plain version (NaN
   positions equal, finite values to 1e-5 of the largest), timed by
   CUDA-graph replay (a wrapper call takes the host ~0.1 ms, more than the
   kernel); prints the ratio of ``full`` at chunk 45 to chunk 5. RDF
   phase: ``rdf_histogram`` against its plain version on the melted bench
   fluid, the 2D start and the tilted start (65,536), f64 and f32, at r_max
   3 (200 bins, ``validate.py``'s) and at half the narrowest width
   (``sample_rdf``'s), and on the bench lattice at 262,144 at r_max 3: the
   counts bin for bin (a difference only within twice the pairs at a bin
   edge, counted in f64), two launches alike, the plan's route (cell or
   tile) and zero pattern; where the cell route is taken the tile route
   forced on the same inputs gives the same counts; timed by graph replay
   (the launch on the plan, binning included; the binning alone and the
   tile route beside the cell route), the whole call by events, against
   both bounds (the pairs inside r_max, and every unordered pair); also
   ``validate_torch.py``'s triple point shape (4,096 at rho 0.84) at
   r_max 3. List phase: the neighbour
   list's build (``nl_build``, K1) and force pass (``nl_forces``, K2)
   against their plain versions on the bench's jittered lattice and melted
   fluid at 65,536 and 262,144 and the lattice with its particles shuffled
   at 65,536, f64 and f32: K1's rows bit for bit the
   stencil-order plain build's (padding included) and equal as sets to the
   default plain build's, its counts and overflow flag equal; with C a
   quarter and K 32 both flags up and the rows and counts equal; with C
   grown twice (the stencil staged 9 cells at a time) the rows equal; K2
   on K1's list, its rows in cell order, to f64 1e-12 / 1e-10, f32 1e-5,
   its forces bit-equal to the particle-order launch's; two launches of
   each bit for bit; timed by graph replay in turns with B1 (full and lean)
   on the same state and K2 in particle order, the whole ``allocate``
   (binning and K1) and the plain versions by events, against bounds from
   this run's list. Slab phase:
   B1's slab launch (``HaloSlotEngine`` on a ring of one: the box one slab
   of a grid with a ghost x-plane on each side, the blocks over its
   interior cells) on the bench's lattice at 65,536 and 262,144 and the
   melted fluid, f64, f32 and hi/lo, full and lean: against its plain
   version and against the periodic launch on the global slots (f64 1e-12
   / 1e-10, f32 1e-5), lean forces bit-equal to full, two launches bit for
   bit; timed by graph replay in turns with the periodic launches, the
   plain versions by events, the bound from this run's pairs (the ghost
   planes' reads included); the sharded ``compute_slots`` (exchange,
   assembly, launch) by events beside the periodic engine's. List slab
   phase: the pair list's slab launch (the sharded engine's sweep for a
   user potential, on a ring of one) on config 4's lattice (f64, f32) and
   the bench's 3D lattice (f32, hi/lo): its entries, counts and starts
   equal to its plain version's and repeating bit for bit, the sweep on it
   against the plain reduction (f64 1e-12 / 1e-10, f32 1e-5) and bit for
   bit against the periodic list route; timed in turns with the periodic
   list by graph replay, against its bound (the ghost planes' reads
   included).
4. Paths, each with the kernels' launch counts set to 0 just before it and
   read just after:
   * B1: ``run_simulation`` at the bench configuration, 600 NVT (Bussi) then
     500 NVE steps (the f32 NVE legs take the hi/lo sweep), thermo every 100
     and trajectory every 500 steps, then 500 NVE steps from the NVT end
     state with the force-shifted potential;
   * B2: the same three legs through ``PlaneEngine`` with
     ``compensated=False``;
   * Brownian: 65,536 pseudo-hard spheres at rho 0.5, kT 1, dt 1e-5, 200
     steps through ``PlaneEngine`` with ``log_times=True``;
   * Brownian on the slot route: the same system through ``select_engine``'s
     cell grid, 200 steps, thermo every 100, a frame at step 0;
   * FIRE: the ``bench_fire.py`` system (65,536 LJ, rho 0.8, jitter 0.05)
     through ``fire_minimize`` on the cell grid, 20 iterations, then 200 at
     tol 0, timed;
   * packing: ``initialize_state`` without positions (mode D) at 65,536
     particles, rho 0.8;
   * 2D: ``bench_2d.py``'s configuration (65,536 polydisperse pseudo-hard
     disks, rho 0.7, f32) through ``run_simulation`` on the slot route,
     600 NVT(1.0, 0.1) then 200 NVE steps (hi/lo), one frame a leg;
   * tilted: the bench's LJ fluid in the box [[L, L/8, L/12], [0, L, L/6],
     [0, 0, L]], the same legs at NVT(1.0, 0.4);
   * user potential: BASELINE config 4 at 65,536 (a user's non-additive
     polydisperse potential, f64, rho 0.9) from an XYZ snapshot through
     ``initialize_state(from_file=...)``, ``minimize`` (slot FIRE on the
     pair list, 1000 iterations at dmax 0.01) and 300 NVT(0.5, 0.01) steps
     at dt 1e-4;
   * resume: the bench on the slot route, 400 NVT steps with thermo every
     100, frames every 200 (zstd where libzstd is found), a checkpoint
     every 200 and the perf log; then a crash resume from
     ``checkpoint.200.npz`` into the same directory: labels equal, rows and
     frames below the checkpoint's step byte for byte, ``perf.txt``
     appended to, the first resumed row's E/N within 1e-4; 200 NVE steps
     from a state and from its saved and loaded copy, f32 and f64, bit for
     bit; one 65,536-atom frame through the writer thread, plain and zstd,
     timed in turns, and formatted by the native formatter and by
     ``format_lammps_frame`` (bytes equal, both timed);
   * the list: B1's three legs through ``select_engine(...,
     prefer="neighbor")`` (the particle-order step, compensated): every
     step through K2, rebuilds through K1 (counted), no sweep kernel; the
     force-shifted NVE leg's energy per particle within 1e-4;
   * sharded: a one-rank NCCL group formed here (a file store in the work
     directory; a failure to form it fails the run), then the bench's 600
     NVT + 500 NVE steps through ``run_simulation_sharded`` (every sweep a
     slab launch, NVE on hi/lo), its first thermo rows against the B1
     path's within 1e-4; then ``fire_minimize_sharded`` on
     ``bench_fire.py``'s system, 20 iterations, below the start's energy;
     then BASELINE config 4 at 65,536 (the user potential, every sweep the
     pair list's slab launch): ``fire_minimize_sharded`` from the user
     path's XYZ start, 1000 iterations at dmax 0.01, finite and below the
     start's energy, and ``run_simulation_sharded`` NVT(0.5, 0.01) for 300
     steps from the user path's minimized state and velocities, its rows
     at steps 0 and 100 within 1e-8 of that path's.
   The B1, B2 and list paths end with the observables of their final
   state: ``sample_rdf`` through the RDF kernel at the half width (the
   tile route) and at r_max 3 (the cell route), the first peak of each,
   the MSD from the start, ``read_thermo`` of the NVE leg equal to the
   file's rows.
   B1, the slot Brownian path, FIRE and packing run in the slot layout (the
   slot step's counter must show it for the dynamics), and so do the 2D,
   tilted and user paths; built-in potentials never launch the pair list,
   and the user potential never the sweep kernels; only the list path takes
   the list's kernels; every frame and snapshot of the Brownian path goes
   through the native formatter. Checks finite output,
   the NVT temperature, NVE energy conservation (to 1e-4 per particle with the force
   shift), the T column of the Brownian rows, the output and snapshot files,
   FIRE's energy after its first iterations below its start, the packer's
   convergence and no pair closer than tol beyond f32 rounding, and the
   launch counts.
5. Prints the ``kernels`` JSON line, then as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a card, when the package is
missing, or when any build, launch or check fails.
"""

import dataclasses
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

N_BENCH = 65536
BENCH_GEOMETRY = ((15, 15, 15), 37)   # CellGridEngine.create at skin 0.3
NVT_STEPS, NVE_STEPS = 600, 500
THERMO_EVERY, TRAJ_EVERY = 100, 500
BROWNIAN_STEPS, BROWNIAN_THERMO_EVERY = 200, 100
SOURCES = ("cell_sweep", "plane_sweep", "plane_probe", "cell_pairs",
           "rdf_histogram", "neighbor_list", "lammps_format")
PROBE_PATH = ("full_static", "full_static:15", "full:5")  # probe_kernel.py
PROBE_SPECS = ("full", "full_static", "nodiv", "reduce_only", "full:5",
               "full_static:15", "nodiv:5", "reduce_only:15")

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, no sparsity): HBM3
# 3.35 TB/s; 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor
# cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}
# Operations per pair, by hand count of csrc/cell_sweep.cu and
# csrc/pair_potentials.cuh (a multiply-add counts 2): the distance and the
# cutoff test (3 subtractions, 3 multiplies, 2 adds, 1 compare; the hi/lo
# displacement takes a two_sum and 3 adds a component instead of the
# subtraction); per pair inside the engine cutoff the test for the own
# diameter and the potential's cutoff test (sigma mixing, sigma^2 and the
# shift constants are per-thread set-up now); and, inside the potential's
# cutoff, its arithmetic (LJ: a division and 10 more; pseudo-hard spheres: an
# rsqrt and 18 more; overlap: a square root, a division and 5 more) plus the
# 11 of the energy, virial and force sums. The lean variant does only the
# force's share: LJ without its energy term (3), pseudo-hard spheres without
# theirs (3), overlap without its square (1), and of the sums only the 6 of
# the force.
OPS_DISTANCE = 9
OPS_DISTANCE_HILO = 33
# In 2D: 2 subtractions, 2 multiplies, 1 add and the compare; hi/lo two
# components of 9. The potential's force sums lose one component (2).
OPS_DISTANCE_2D = 6
OPS_DISTANCE_HILO_2D = 22
OPS_FORCE_COMPONENT = 2
OPS_ENGINE_PAIR = 2
OPS_POTENTIAL_PAIR = {"LennardJones": 22, "PseudoHS": 30,
                      "OverlapPotential": 18}
OPS_POTENTIAL_PAIR_LEAN = {"LennardJones": 14, "PseudoHS": 22,
                           "OverlapPotential": 12}
N_FIRE_ITERS = 200
N_FIRE_DESCENT = 20
PACK_DENSITY = 0.8
# Operations per candidate pair of the probe (csrc/plane_probe.cu): distance
# 8, compare 1, the block (full: divide, powers, u and f, 11; nodiv: 2),
# 2 selects, energy add 1, 3 force multiply-adds 6.
OPS_PROBE = {"full": 29, "full_static": 29, "nodiv": 20}
# The kernels' potential functors (csrc/pair_potentials.cuh) by class.
POT_FUNCTOR = {"LennardJones": "LJ", "PseudoHS": "PseudoHS"}
# The 2D path: bench_2d.py's configuration (65,536 polydisperse pseudo-hard
# disks, rho 0.7, diameters 1 + 0.2 (U - 0.5), cutoff 1.021 * 1.1 + 0.2,
# dt 0.001, NVT(1.0, 0.1), f32, a lattice jittered by 0.01), then NVE.
RHO_2D, POLY_2D = 0.7, 0.2
CUTOFF_2D = 1.021 * (1.0 + POLY_2D / 2) + 0.2
# The tilted path: the bench's Lennard-Jones fluid in the box whose columns
# carry tests/test_cell_grid.py:128-130's off-diagonals scaled to L.
GEO_NVT_STEPS, GEO_NVE_STEPS = 600, 200
# The user-potential path: BASELINE config 4 (examples/03_polydisperse_2d.py)
# at 65,536: 2D, rho 0.9, diameters U(0.8, 1.2), cutoff 1.8, f64, an XYZ
# start of uniform random positions, minimize, then NVT(0.5, 0.01) at
# dt 1e-4. FIRE with the reference's step cap (dmax 0.1) climbs on this
# start in both packages (the JAX package's at N = 1200: 1.14 a particle
# after 1000 iterations, 57.9 after 3000), and NVT at dt 1e-4 then blows
# up; with dmax 0.01 (0.25 a particle at 1000) it does not.
RHO_USER, CUTOFF_USER, USER_DMAX = 0.9, 1.8, 0.01
USER_FIRE_ITERS, USER_NVT_STEPS = 1000, 300
# The RDF histogram: validate.py's 200 bins at r_max 3 and sample_rdf's
# half width. Operations per distance, by hand count of the function
# (mdtpu/observables.py:21): in 3D the displacement (3 subtractions), the
# fractional components (3 x (3 multiplies, 2 adds)), their rint and
# subtraction (6), the Cartesian components (15), r^2 (3 multiplies, 2
# adds), the square root and the compare: 46; in 2D 2 + 6 + 4 + 6 + 3 + 2
# = 23. A product with a zero entry of the cell or its inverse is no work
# (csrc/rdf_histogram.cu drops it with its add): upper triangular 3D 46 -
# 2 x (3 multiplies + 3 adds) = 34, 2D 23 - 2 x 2 = 19; diagonal 3D 46 -
# 2 x (6 + 6) = 22, 2D 23 - 2 x (2 + 2) = 15. Per pair inside r_max the
# bin: a division, a multiply, the conversion, the clamp and the
# shared-memory add. The bound counts each unordered pair inside r_max
# once (its distance and its bin), as B1's and K2's count the pairs inside
# their cutoff; the first design's bound, every unordered pair's distance
# by the general count, is printed beside it as all_pairs_ms.
RDF_BINS, RDF_R_MAX = 200, 3.0
OPS_RDF_DISTANCE = {3: (46, 34, 22), 2: (23, 19, 15)}  # by zero pattern
OPS_RDF_HIT = 5
# The neighbour list (csrc/neighbor_list.cu): the bench system and the same
# system at 262,144. Operations per list candidate of K1 and per list entry
# of K2, by hand count: per component a subtraction, the division by L, its
# rint, the product with L and the subtraction (5), then 3 squares, 2 adds
# and the compare. The potential's operations per pair inside its cutoff
# are OPS_POTENTIAL_PAIR's (with the energy, virial and force sums).
NL_SIZES = (N_BENCH, 262144)
OPS_NL_DISTANCE = 21
# The resume path: the bench configuration, NVT with a checkpoint at 200;
# then a continuation from a state and from its checkpoint.
RESUME_STEPS, RESUME_AT, RESUME_THERMO, RESUME_TRAJ = 400, 200, 100, 200
CONTINUE_STEPS = 200


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


def profiled_kernels(fn, tries=3):
    """The names of the kernels one call of ``fn`` launches, by
    ``torch.profiler`` (copies and fills by the runtime left out). A
    profile that recorded nothing on the device is taken again, up to
    ``tries`` times (the profiler has missed a whole call's events)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith(("Memcpy", "Memset"))]
        if names:
            break
    return names


def graph_of(fn):
    """A CUDA graph of one call of ``fn`` (already called once, so nothing
    is built or loaded during the capture)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


class PairCounter:
    """A stand-in potential of energy 1 per pair closer than ``r_cut``:
    through ``cell_sweep_plain`` its energy is the number of unordered pairs
    closer than both ``r_cut`` and the engine cutoff."""

    def __init__(self, r_cut):
        self.r_cut = r_cut

    def evaluate_r2(self, r2, d_i, d_j):
        return (r2 < self.r_cut ** 2).to(r2.dtype), torch.zeros_like(r2)


def pair_counts(inputs, grid, cutoff, pot_cutoff):
    """Ordered candidate pairs the full stencil (27 cells, 9 in 2D) and the
    half stencil (3D only; None in 2D) visit (from the per-cell counts), and
    the unordered pairs inside the engine cutoff and inside the potential's
    cutoff (from the masks of ``cell_sweep_plain``)."""
    from mdtpu_torch.ops.cell_sweep import cell_sweep_plain
    from mdtpu_torch.ops.plane_sweep import NEWTON_CELLS, SELF_COLUMN
    slot_pos, slot_diam, counts, box = inputs
    dim = len(grid)
    cnt = counts.reshape(grid)

    def candidates(offsets):
        near = sum(torch.roll(cnt, tuple(-o for o in off),
                              dims=tuple(range(dim))) for off in offsets)
        return int((cnt * near).sum() - cnt.sum())

    full = candidates(itertools.product((-1, 0, 1), repeat=dim))
    half = candidates(SELF_COLUMN + NEWTON_CELLS) if dim == 3 else None
    f64 = (slot_pos.double(), slot_diam.double(), counts, box.double())
    inside, inside_pot = (
        round(float(cell_sweep_plain(*f64, grid, cutoff, PairCounter(r))[0]))
        for r in (cutoff, pot_cutoff))
    return full, half, inside, inside_pot


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


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def bound(inputs, counts_, pot, dtype, hilo=False, observables=True):
    """The least time for the function on these inputs: bytes (each input
    read once, each output written once) over HBM, operations (each
    unordered pair inside the cutoff once) over the peak rate. The sweeps
    read only the occupied slots (their loops stop at each cell's count), so
    the inputs count those; the outputs cover every slot. A lean sweep
    (``observables=False``) counts only the force's work and output."""
    _, _, inside, inside_pot = counts_
    slot_pos, _, counts, _ = inputs
    dim = slot_pos.shape[0]
    dist = distance_ops(dim, hilo)
    per_pot = (OPS_POTENTIAL_PAIR if observables
               else OPS_POTENTIAL_PAIR_LEAN)[type(pot).__name__]
    per_pot -= (3 - dim) * OPS_FORCE_COMPONENT
    ops = inside * (dist + OPS_ENGINE_PAIR) + inside_pot * per_pot
    b = slot_pos.element_size()
    n_slots, n_cells = slot_pos.shape[1], counts.shape[0]
    occupied = int(counts.sum())
    words = dim + 1 + (dim if hilo else 0)
    nbytes = (words * occupied * b + n_cells * 8 + dim * dim * b  # inputs
              + dim * n_slots * b                             # forces
              + (2 * n_cells * b if observables else 0))      # partials
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_bound_ms": t_ops, "bytes_bound_ms": t_bytes, "ops": ops,
            "bytes": nbytes}


def distance_ops(dim, hilo=False):
    """Operations of one pair's distance and cutoff test."""
    if dim == 2:
        return OPS_DISTANCE_HILO_2D if hilo else OPS_DISTANCE_2D
    return OPS_DISTANCE_HILO if hilo else OPS_DISTANCE


def stencil_work(counts_, pot, dtype, half, hilo=False, dim=3):
    """The design's own work: the stencil's candidate pairs, the pairs
    inside the cutoffs evaluated once (half stencil, Newton cells) or from
    both sides. The full-stencil kernel filters every candidate with the
    plain distance and computes the distance of a hit again (hi/lo: the
    exact one) when it evaluates it."""
    full_cand, half_cand, inside, inside_pot = counts_
    pot_ops = (OPS_POTENTIAL_PAIR[type(pot).__name__]
               - (3 - dim) * OPS_FORCE_COMPONENT)
    cand = half_cand if half else full_cand
    sides = 1 if half else 2
    again = 0 if half else distance_ops(dim, hilo)
    ops = (cand * distance_ops(dim) + sides * inside
           * (again + OPS_ENGINE_PAIR) + sides * inside_pot * pot_ops)
    return {"stencil_candidates": cand, "stencil_ops": ops,
            "stencil_ops_ms": ops / PEAK_OPS[dtype] * 1e3}


def kernel_turns(calls, rounds=5, reps=20):
    """Device times of the sweeps in ``calls`` (name -> a call of its
    wrapper on the case's inputs), taken in turns (first .. last, last ..
    first) ``rounds`` times within this call: two kernels are compared only
    so. Each is a CUDA graph of one wrapper call, replayed ``reps`` times."""
    graphs = {name: graph_of(fn) for name, fn in calls.items()}
    turns = {name: [] for name in calls}
    order = list(calls) + list(calls)[::-1]
    for _ in range(rounds):
        for name in order:
            turns[name].append(cuda_time_ms(graphs[name].replay, reps, 2))
    return turns


def repeats(kernel, args, first):
    """A second launch on the same inputs against the first, bit for bit."""
    again = kernel(*args)
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, again))


def melted_state(mt, n=N_BENCH):
    """The bench lattice (``n`` particles) after 300 NVT steps (f64, so that
    the f32 and the hi/lo inputs are words of one state)."""
    from mdtpu_torch.sim.initialization import lattice_fluid_state
    state = lattice_fluid_state(n, 0.8, 1.0, dtype=torch.float64,
                                cutoff=2.5, jitter=0.01, device="cuda")
    params = mt.Parameters(density=0.8, n_particles=n, dt=0.002,
                           potential=mt.LennardJones(r_cut=2.5))
    with tempfile.TemporaryDirectory() as d:
        return mt.run_simulation(state, params, mt.NVT(1.0, 0.4), 300, 300, d)


def as_dtype(state, dtype):
    """The state with its floating-point tensors cast to ``dtype``."""
    changes = {f.name: getattr(state, f.name).to(dtype)
               for f in dataclasses.fields(state)
               if isinstance(getattr(state, f.name), torch.Tensor)
               and getattr(state, f.name).is_floating_point()}
    return state.replace(nbrs=None, **changes)


def hilo_args(eng, state64, pot):
    """The hi/lo sweep's arguments: f32 hi/lo words of an f64 state."""
    hi = state64.positions.float()
    lo = (state64.positions - hi.double()).float()
    cell = state64.unitcell.float()
    cinv = state64.unitcell_inv.float()
    nb = eng.allocate(hi, state64.diameters.float(), cell, cinv)
    assert not bool(nb.overflow)
    return (*eng.slot_inputs_hilo(hi, lo, cell, cinv, nb), eng.grid,
            eng.cutoff, pot)


def plane_plan(cap, dtype, pot, registers):
    """The half-stencil sweep's staging plan at capacity ``cap``, its
    resident blocks per SM and the registers of the kernel it launches."""
    from mdtpu_torch.ops import plane_sweep as ps
    list_len, mask_words, smem, threads = ps.plane_stage_plan(cap, dtype)
    key = ("f32" if dtype == torch.float32 else "f64",
           POT_FUNCTOR[type(pot).__name__], 256 if threads <= 256 else 1024)
    return {"list_len": list_len, "mask_words": mask_words,
            "smem_bytes": smem, "threads": threads,
            "blocks_per_sm": ps.blocks_per_sm(cap, dtype, pot),
            "registers": registers[key][0],
            "spill_store_bytes": registers[key][1]}


def kernel_phase(mt, plane_registers):
    from mdtpu_torch.ops.cell_grid import CellGridEngine
    from mdtpu_torch.ops.cell_sweep import (blocks_per_sm, cell_sweep,
                                            cell_sweep_hilo,
                                            cell_sweep_hilo_plain,
                                            cell_sweep_plain, stage_plan)
    from mdtpu_torch.ops.plane_sweep import plane_sweep, plane_sweep_plain
    from mdtpu_torch.sim.initialization import lattice_fluid_state

    # Jitter in standard normals of the lattice spacing. At 0.03 the pseudo-
    # hard-sphere lattice (spacing 1.096, potential cutoff 1.02) has
    # thousands of interacting pairs and none much closer than 0.9 sigma, so
    # no single pair's r^-50 force dwarfs the rest. The lattice gives every
    # particle the same number of pairs; the melted fluid (no jitter: made
    # by 300 NVT steps) does not.
    cases = [
        ("lj_bench", mt.LennardJones(r_cut=2.5), 0.8, 2.5, 0.01),
        ("lj_melted", mt.LennardJones(r_cut=2.5), 0.8, 2.5, None),
        ("pseudo_hs", mt.PseudoHS(), 0.76, 1.5, 0.03),
    ]
    melted = melted_state(mt)
    results, failures = {}, []

    def record(rec, ok, what):
        rec["ok"] = ok
        log(json.dumps(rec))
        results[(rec["kernel_check"], rec["case"], rec["dtype"])] = rec
        if not ok:
            failures.append(what)

    for name, pot, rho, cutoff, jitter in cases:
        f64_state = None
        for dtype in (torch.float64, torch.float32):
            if jitter is None:
                state = as_dtype(melted, dtype)
            else:
                state = lattice_fluid_state(N_BENCH, rho, 1.0, dtype=dtype,
                                            cutoff=cutoff, jitter=jitter,
                                            device="cuda")
            if dtype == torch.float64:
                f64_state = state
            eng = mt.select_engine(pot, cutoff, state)
            assert isinstance(eng, CellGridEngine), eng
            if name.startswith("lj_"):
                assert (eng.grid, eng.cell_capacity) == BENCH_GEOMETRY, \
                    (eng.grid, eng.cell_capacity)
            nb = eng.allocate(state.positions, state.diameters,
                              state.unitcell, state.unitcell_inv)
            assert not bool(nb.overflow)
            inputs = eng.slot_inputs(state.positions, state.unitcell,
                                     state.unitcell_inv, nb)
            args = (*inputs, eng.grid, eng.cutoff, pot)
            counts_ = pair_counts(inputs, eng.grid, eng.cutoff,
                                  pot.max_cutoff(float(state.diameters.max())))
            f64 = dtype == torch.float64
            rtol_ew, tol_f = (1e-12, 1e-10) if f64 else (1e-5, 1e-5)
            tag = str(dtype).split(".")[-1]
            base = {"case": name, "dtype": tag, "grid": list(eng.grid),
                    "capacity": eng.cell_capacity,
                    "pairs_in_engine_cutoff": counts_[2],
                    "pairs_in_potential_cutoff": counts_[3],
                    "library_ms": None}
            list_len, smem, threads = stage_plan(eng.cell_capacity, dtype)
            plan = {"list_len": list_len, "smem_bytes": smem,
                    "threads": threads, "blocks_per_sm": blocks_per_sm(
                        eng.cell_capacity, dtype, False, pot)}

            calls = {"cell_sweep": lambda: cell_sweep(*args),
                     "plane_sweep": lambda: plane_sweep(*args)}
            lj = name.startswith("lj_")
            if lj:
                calls["cell_sweep_lean"] = lambda: cell_sweep(
                    *args, observables=False)
            if not f64:
                h_args = hilo_args(eng, f64_state, pot)
                calls["cell_sweep_hilo"] = lambda: cell_sweep_hilo(*h_args)
                if lj:
                    calls["cell_sweep_hilo_lean"] = lambda: cell_sweep_hilo(
                        *h_args, observables=False)
            turns = kernel_turns(calls)
            out = {}
            for kname, kernel, plain, half in (
                    ("cell_sweep", cell_sweep, cell_sweep_plain, False),
                    ("plane_sweep", plane_sweep, plane_sweep_plain, True)):
                r1 = kernel(*args)
                torch.cuda.synchronize()
                r0 = plain(*args)
                torch.cuda.synchronize()
                out[kname] = r1
                worst, max_abs, rms = force_error(r1[2], r0[2], N_BENCH)
                rec = {"kernel_check": kname, **base,
                       "rel_err_energy": rel(r1[0], r0[0]),
                       "rel_err_virial": rel(r1[1], r0[1]),
                       "force_err_per_particle": worst,
                       "max_abs_err": max_abs, "rms_force": rms,
                       "max_force": float(r0[2].double().norm(dim=0).max()),
                       "ms": statistics.median(turns[kname]),
                       "ms_turns": turns[kname],
                       "plain_ms": cuda_time_ms(lambda: plain(*args), 3, 1),
                       **bound(inputs, counts_, pot, dtype),
                       **stencil_work(counts_, pot, dtype, half)}
                ok = (math.isfinite(float(r1[0]))
                      and rec["rel_err_energy"] <= rtol_ew
                      and rec["rel_err_virial"] <= rtol_ew
                      and worst <= tol_f)
                rec["stage_plan"] = plan if not half else plane_plan(
                    eng.cell_capacity, dtype, pot, plane_registers)
                rec["repeats_bit_for_bit"] = repeats(kernel, args, r1)
                ok = ok and rec["repeats_bit_for_bit"]
                record(rec, ok, f"{kname} {name} {tag}")

            # The half stencil against the full one on the same inputs.
            (e1, w1, f1), (e2, w2, f2) = out["plane_sweep"], out["cell_sweep"]
            pairs = zip(turns["plane_sweep"], turns["cell_sweep"])
            rec = {"kernel_check": "plane_vs_cell", "case": name,
                   "dtype": tag, "rel_err_energy": rel(e1, e2),
                   "rel_err_virial": rel(w1, w2),
                   "force_err_per_particle": force_error(f1, f2, N_BENCH)[0],
                   "median_ms_ratio_plane_over_cell":
                       statistics.median(turns["plane_sweep"])
                       / statistics.median(turns["cell_sweep"]),
                   "turns_plane_faster": sum(p < c for p, c in pairs),
                   "turns": len(turns["plane_sweep"])}
            if f64:
                ok = (rec["rel_err_energy"] <= 1e-12
                      and rec["rel_err_virial"] <= 1e-12
                      and rec["force_err_per_particle"] <= 1e-10)
            else:
                e0, w0, f0 = cell_sweep_plain(
                    inputs[0].double(), inputs[1].double(), inputs[2],
                    inputs[3].double(), eng.grid, eng.cutoff, pot)
                rec["plane_err_vs_f64"] = force_error(f1, f0, N_BENCH)[0]
                rec["cell_err_vs_f64"] = force_error(f2, f0, N_BENCH)[0]
                ok = (rec["rel_err_energy"] <= 1e-5
                      and rec["rel_err_virial"] <= 1e-5
                      and rec["plane_err_vs_f64"]
                      <= 2 * rec["cell_err_vs_f64"])
            record(rec, ok, f"plane_vs_cell {name} {tag}")

            if lj:
                lean_check("cell_sweep", cell_sweep, cell_sweep_plain, args,
                           out["cell_sweep"], inputs, counts_, pot, base,
                           record, turns)
            if not f64:
                h_full = hilo_check(h_args, pot, counts_, base, record, turns)
                if lj:
                    lean_check("cell_sweep_hilo", cell_sweep_hilo,
                               cell_sweep_hilo_plain, h_args, h_full,
                               (h_args[0], *h_args[2:5]), counts_, pot, base,
                               record, turns, hilo=True)
                del h_args
            del state, nb, inputs, args, out, calls
            torch.cuda.empty_cache()
    brownian_geometry_check(mt, record, plane_registers)
    overlap_check(mt, record)
    geometry_check(mt, record, "bench_2d", melted_2d(mt), mt.PseudoHS(),
                   CUTOFF_2D)
    geometry_check(mt, record, "bench_2d_tilted", melted_2d(mt, tilt=True),
                   mt.PseudoHS(), CUTOFF_2D)
    geometry_check(mt, record, "bench_tilted",
                   state_tilted(mt, torch.float64),
                   mt.LennardJones(r_cut=2.5), 2.5)
    pair_list_check(mt, record, *user_lattice(mt))
    return results, failures


def brownian_geometry_check(mt, record, plane_registers):
    """``plane_sweep`` against its plain version at f32 and f64 on the grid
    and capacity the Brownian path gives it (``PlaneEngine.create`` at rho
    0.5, r_c 1.5, the path's starting state); two launches bit for bit."""
    from mdtpu_torch.ops.experimental import PlaneEngine
    from mdtpu_torch.ops.plane_sweep import plane_sweep, plane_sweep_plain
    pot = mt.PseudoHS()
    for dtype in (torch.float64, torch.float32):
        state = as_dtype(brownian_state(), dtype)
        eng = PlaneEngine.create(pot, 1.5, 0.3, state.unitcell, N_BENCH)
        nb = eng.allocate(state.positions, state.diameters, state.unitcell,
                          state.unitcell_inv)
        assert not bool(nb.overflow)
        inputs = eng.slot_inputs(state.positions, state.unitcell,
                                 state.unitcell_inv, nb)
        args = (*inputs, eng.grid, eng.cutoff, pot)
        r1 = plane_sweep(*args)
        torch.cuda.synchronize()
        r0 = plane_sweep_plain(*args)
        worst, max_abs, rms = force_error(r1[2], r0[2], N_BENCH)
        f64 = dtype == torch.float64
        rtol_ew, tol_f = (1e-12, 1e-10) if f64 else (1e-5, 1e-5)
        tag = str(dtype).split(".")[-1]
        rec = {"kernel_check": "plane_sweep", "case": "brownian",
               "dtype": tag, "grid": list(eng.grid),
               "capacity": eng.cell_capacity,
               "rel_err_energy": rel(r1[0], r0[0]),
               "rel_err_virial": rel(r1[1], r0[1]),
               "force_err_per_particle": worst, "max_abs_err": max_abs,
               "rms_force": rms,
               "repeats_bit_for_bit": repeats(plane_sweep, args, r1),
               "stage_plan": plane_plan(eng.cell_capacity, dtype, pot,
                                        plane_registers),
               "ms": cuda_time_ms(
                   graph_of(lambda: plane_sweep(*args)).replay, 20, 3)}
        ok = (math.isfinite(float(r1[0])) and rec["rel_err_energy"] <= rtol_ew
              and rec["rel_err_virial"] <= rtol_ew and worst <= tol_f
              and rec["repeats_bit_for_bit"])
        record(rec, ok, f"plane_sweep brownian {tag}")


def hilo_check(args, pot, counts_, base, record, turns):
    """The hi/lo sweep at f32 on the hi/lo words of an f64 state."""
    from mdtpu_torch.ops.cell_sweep import (blocks_per_sm, cell_sweep,
                                            cell_sweep_hilo,
                                            cell_sweep_hilo_plain,
                                            cell_sweep_plain, stage_plan)
    r1 = cell_sweep_hilo(*args)
    torch.cuda.synchronize()
    r0 = cell_sweep_hilo_plain(*args)
    slot_hi, slot_lo, diam, counts, box, grid, cutoff, _ = args
    dim = len(grid)
    r64 = cell_sweep_plain(slot_hi.double() + slot_lo.double(), diam.double(),
                           counts, box.double(), grid, cutoff, pot)
    rp = cell_sweep(slot_hi, diam, counts, box, grid, cutoff, pot)
    torch.cuda.synchronize()
    worst, max_abs, rms = force_error(r1[2], r0[2], N_BENCH)
    sweep_inputs = (slot_hi, diam, counts, box)
    list_len, smem, threads = stage_plan(base["capacity"], torch.float32,
                                         True, dim)
    ms, cell_ms = (statistics.median(turns[k])
                   for k in ("cell_sweep_hilo", "cell_sweep"))
    rec = {"kernel_check": "cell_sweep_hilo", **base,
           "rel_err_energy": rel(r1[0], r0[0]),
           "rel_err_virial": rel(r1[1], r0[1]),
           "force_err_per_particle": worst, "max_abs_err": max_abs,
           "rms_force": rms,
           "hilo_err_vs_f64": force_error(r1[2], r64[2], N_BENCH)[0],
           "plain_f32_err_vs_f64": force_error(rp[2], r64[2], N_BENCH)[0],
           "repeats_bit_for_bit": repeats(cell_sweep_hilo, args, r1),
           "stage_plan": {"list_len": list_len, "smem_bytes": smem,
                          "threads": threads, "blocks_per_sm": blocks_per_sm(
                              base["capacity"], torch.float32, True, pot,
                              dim=dim)},
           "ms": ms, "ms_turns": turns["cell_sweep_hilo"],
           "median_ms_ratio_hilo_over_cell": ms / cell_ms,
           "plain_ms": cuda_time_ms(lambda: cell_sweep_hilo_plain(*args), 3,
                                    1),
           **bound(sweep_inputs, counts_, pot, torch.float32, hilo=True),
           **stencil_work(counts_, pot, torch.float32, False, hilo=True,
                          dim=dim)}
    ok = (math.isfinite(float(r1[0])) and rec["rel_err_energy"] <= 1e-5
          and rec["rel_err_virial"] <= 1e-5 and worst <= 1e-5
          and 5 * rec["hilo_err_vs_f64"] <= rec["plain_f32_err_vs_f64"]
          and rec["repeats_bit_for_bit"])
    record(rec, ok, f"cell_sweep_hilo {base['case']}")
    return r1


def lean_check(name, kernel, plain, args, full, sweep_inputs, counts_, pot,
               base, record, turns, hilo=False):
    """The lean variant of ``kernel`` (``observables=False``) on the full
    variant's inputs: forces bit-equal to the full variant's ``full``, zero
    energy and virial, against the plain lean version at the full variant's
    force tolerance, two launches bit for bit; timed in the turns."""
    from mdtpu_torch.ops.cell_sweep import blocks_per_sm, stage_plan

    def lean(*a):
        return kernel(*a, observables=False)

    r1 = lean(*args)
    torch.cuda.synchronize()
    r0 = plain(*args, observables=False)
    torch.cuda.synchronize()
    dtype = sweep_inputs[0].dtype
    dim = len(base["grid"])
    worst, max_abs, rms = force_error(r1[2], r0[2], N_BENCH)
    ms = statistics.median(turns[f"{name}_lean"])
    list_len, smem, threads = stage_plan(base["capacity"], dtype, hilo, dim)
    rec = {"kernel_check": f"{name}_lean", **base,
           "forces_bit_equal_to_full": torch.equal(r1[2], full[2]),
           "energy_virial_zero": float(r1[0]) == 0.0 == float(r1[1]),
           "force_err_per_particle": worst, "max_abs_err": max_abs,
           "rms_force": rms, "repeats_bit_for_bit": repeats(lean, args, r1),
           "stage_plan": {"list_len": list_len, "smem_bytes": smem,
                          "threads": threads,
                          "blocks_per_sm": blocks_per_sm(
                              base["capacity"], dtype, hilo, pot,
                              observables=False, dim=dim)},
           "ms": ms, "ms_turns": turns[f"{name}_lean"],
           "median_ms_ratio_lean_over_full":
               ms / statistics.median(turns[name]),
           "plain_ms": cuda_time_ms(lambda: plain(*args, observables=False),
                                    3, 1),
           **bound(sweep_inputs, counts_, pot, dtype, hilo=hilo,
                   observables=False)}
    tol_f = 1e-10 if dtype == torch.float64 else 1e-5
    ok = (rec["forces_bit_equal_to_full"] and rec["energy_virial_zero"]
          and worst <= tol_f and rec["repeats_bit_for_bit"])
    record(rec, ok, f"{name}_lean {base['case']} {base['dtype']}")


def pack_engine(mt, positions, cell):
    """The packing path's engine for ``positions``: ``select_engine``'s cell
    grid for the overlap potential, grown until the binning fits (as
    ``slotify_grown`` grows it)."""
    from mdtpu_torch.sim.pack import OverlapPotential
    pot = OverlapPotential(tol=1.0)
    eng = mt.select_engine(pot, 1.0, unitcell=cell.cpu().numpy(),
                           n_particles=N_BENCH)
    cinv = torch.linalg.inv(cell.double()).to(cell.dtype)
    ones = torch.ones(N_BENCH, dtype=cell.dtype, device=cell.device)
    while True:
        nb = eng.allocate(positions, ones, cell, cinv)
        if not bool(nb.overflow):
            return eng, nb, cinv
        eng = eng.with_grown_capacity()


def overlap_check(mt, record):
    """The ``Overlap`` functor through ``cell_sweep`` (full and lean, f64 and
    f32) on the packing path's start: the uniform draws of ``initialize_state
    (seed=0)`` at rho 0.8, on the engine the path grows to."""
    from mdtpu_torch.ops.cell_sweep import (blocks_per_sm, cell_sweep,
                                            cell_sweep_plain, stage_plan)
    from mdtpu_torch.sim import pack
    for dtype in (torch.float64, torch.float32):
        L = (N_BENCH / PACK_DENSITY) ** (1.0 / 3.0)
        cell = torch.eye(3, dtype=dtype, device="cuda") * L
        positions = pack.uniform_fractions(0, (N_BENCH, 3), dtype,
                                           "cuda") * L
        eng, nb, cinv = pack_engine(mt, positions, cell)
        pot = eng.potential
        inputs = eng.slot_inputs(positions, cell, cinv, nb)
        args = (*inputs, eng.grid, eng.cutoff, pot)
        counts_ = pair_counts(inputs, eng.grid, eng.cutoff, pot.max_cutoff())
        turns = kernel_turns({
            "cell_sweep": lambda: cell_sweep(*args),
            "cell_sweep_lean": lambda: cell_sweep(*args, observables=False)})
        r1 = cell_sweep(*args)
        torch.cuda.synchronize()
        r0 = cell_sweep_plain(*args)
        torch.cuda.synchronize()
        worst, max_abs, rms = force_error(r1[2], r0[2], N_BENCH)
        f64 = dtype == torch.float64
        rtol_ew, tol_f = (1e-12, 1e-10) if f64 else (1e-5, 1e-5)
        tag = str(dtype).split(".")[-1]
        list_len, smem, threads = stage_plan(eng.cell_capacity, dtype)
        base = {"case": "pack_start", "dtype": tag, "grid": list(eng.grid),
                "capacity": eng.cell_capacity,
                "pairs_in_engine_cutoff": counts_[2],
                "pairs_in_potential_cutoff": counts_[3], "library_ms": None}
        rec = {"kernel_check": "cell_sweep_overlap", **base,
               "rel_err_energy": rel(r1[0], r0[0]),
               "rel_err_virial": rel(r1[1], r0[1]),
               "force_err_per_particle": worst, "max_abs_err": max_abs,
               "rms_force": rms,
               "repeats_bit_for_bit": repeats(cell_sweep, args, r1),
               "stage_plan": {"list_len": list_len, "smem_bytes": smem,
                              "threads": threads,
                              "blocks_per_sm": blocks_per_sm(
                                  eng.cell_capacity, dtype, False, pot)},
               "ms": statistics.median(turns["cell_sweep"]),
               "ms_turns": turns["cell_sweep"],
               "plain_ms": cuda_time_ms(lambda: cell_sweep_plain(*args), 3,
                                        1),
               **bound(inputs, counts_, pot, dtype),
               **stencil_work(counts_, pot, dtype, False)}
        ok = (math.isfinite(float(r1[0])) and rec["rel_err_energy"] <= rtol_ew
              and rec["rel_err_virial"] <= rtol_ew and worst <= tol_f
              and rec["repeats_bit_for_bit"])
        record(rec, ok, f"cell_sweep_overlap {tag}")
        lean_check("cell_sweep", cell_sweep, cell_sweep_plain, args, r1,
                   inputs, counts_, pot, {**base, "case": "pack_start_lean"},
                   record, turns)
        del positions, nb, inputs, args
        torch.cuda.empty_cache()


# ----------------------------------------------------- 2D and tilted boxes

def user_potential(mt):
    """The user potential of ``examples/03_polydisperse_2d.py`` written
    against the port's ``Potential``, as a user writes one: pseudo-HS-style
    repulsion with non-additive cross diameters sigma_ij = 0.5 (s_i + s_j)
    (1 - 0.2 |s_i - s_j|), energy- and force-shifted at 1.25 sigma_ij. No
    kernel has a functor for it: the cell grid takes the pair-list route."""
    from mdtpu_torch.utils.math import ipow

    @dataclasses.dataclass(frozen=True)
    class NonAdditivePHS(mt.Potential):
        lam: int = 12

        def evaluate(self, r, sigma_i, sigma_j):
            sigma = 0.5 * (sigma_i + sigma_j) * (1.0 - 0.2 * torch.abs(
                sigma_i - sigma_j))
            cutoff = 1.25 * sigma
            inside = r < cutoff
            r_safe = torch.where(inside, r, torch.ones_like(r))
            sr = sigma / r_safe
            u_raw = ipow(sr, self.lam)
            f_raw = self.lam * u_raw / r_safe
            u_c = ipow(torch.tensor(1 / 1.25, dtype=r.dtype,
                                    device=r.device), self.lam)
            f_c = self.lam * u_c / cutoff
            u = u_raw - u_c + (r_safe - cutoff) * f_c
            f = f_raw - f_c
            zero = torch.zeros_like(u)
            return (torch.where(inside, u, zero),
                    torch.where(inside, f, zero))

    return NonAdditivePHS()


def _uniform(seed, shape, dtype=torch.float64):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return torch.rand(shape, generator=g, dtype=dtype)


def tilted_cell(L):
    """[[L, L/8, L/12], [0, L, L/6], [0, 0, L]]: tests/test_cell_grid.py's
    off-diagonals scaled to L."""
    return torch.tensor([[L, L / 8, L / 12], [0.0, L, L / 6],
                         [0.0, 0.0, L]], dtype=torch.float64)


def state_2d(mt, dtype, tilt=False):
    """bench_2d.py's start at 65,536: a lattice jittered by 0.01 of the
    spacing's normals, diameters 1 + 0.2 (U - 0.5), velocities at T = 1;
    ``tilt``: the box's second column leans by L/8."""
    from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                                initialize_velocities,
                                                lattice_positions)
    L = float(torch.tensor((N_BENCH / RHO_2D) ** 0.5, dtype=torch.float32))
    cell = torch.eye(2, dtype=torch.float64) * L
    if tilt:
        cell[0, 1] = L / 8
    pos = lattice_positions(N_BENCH, cell, 2, dtype=torch.float64,
                            jitter=0.01, seed=0, device="cuda")
    diam = 1.0 + POLY_2D * (_uniform(3, (N_BENCH,)) - 0.5)
    state = build_state_from_arrays(pos, diam, cell, 1, dtype=dtype,
                                    cutoff=CUTOFF_2D, device="cuda")
    return state.replace(velocities=initialize_velocities(
        1.0, 2, N_BENCH, 2, dtype=dtype, device="cuda"))


def melted_2d(mt, tilt=False):
    """The 2D start after 200 NVT steps at f64 (the lattice start's disks
    do not touch yet), as the 2D path's sweeps see it."""
    params = mt.Parameters(density=RHO_2D, n_particles=N_BENCH, dt=0.001,
                           potential=mt.PseudoHS())
    with tempfile.TemporaryDirectory() as d:
        return mt.run_simulation(state_2d(mt, torch.float64, tilt), params,
                                 mt.NVT(1.0, 0.1), 200, 200, d)


def state_tilted(mt, dtype):
    """The bench's Lennard-Jones start (rho 0.8, a lattice jittered by 0.01,
    T = 1) in the tilted box."""
    from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                                initialize_velocities,
                                                lattice_positions)
    cell = tilted_cell((N_BENCH / 0.8) ** (1.0 / 3.0))
    pos = lattice_positions(N_BENCH, cell, 3, dtype=torch.float64,
                            jitter=0.01, seed=0, device="cuda")
    state = build_state_from_arrays(pos, torch.ones(N_BENCH), cell, 1,
                                    dtype=dtype, cutoff=2.5, device="cuda")
    return state.replace(velocities=initialize_velocities(
        1.0, 2, N_BENCH, 3, dtype=dtype, device="cuda"))


def user_start(mt, workdir):
    """Config 4's start at 65,536: uniform random positions and diameters
    U(0.8, 1.2) written as an XYZ snapshot, read back by
    ``initialize_state(from_file=...)`` (f64)."""
    from mdtpu_torch.io.xyz import write_xyz
    L = (N_BENCH / RHO_USER) ** 0.5
    pos = _uniform(5, (N_BENCH, 2)) * L
    diam = 0.8 + 0.4 * _uniform(6, (N_BENCH,))
    os.makedirs(workdir, exist_ok=True)
    snap = os.path.join(workdir, "start.xyz")
    write_xyz(snap, 0, torch.eye(2, dtype=torch.float64) * L, pos, diam,
              mode="w")
    params = mt.Parameters(density=RHO_USER, n_particles=N_BENCH, dt=1e-4,
                           potential=user_potential(mt))
    state = mt.initialize_state(params, workdir, from_file=snap,
                                dimension=2, cutoff=CUTOFF_USER,
                                dtype=torch.float64, device="cuda")
    return state, params


def user_lattice(mt):
    """Config 4's density, diameters and potential on a lattice jittered by
    0.05 (f64): the list kernels' check state, with the path's grid and
    list size but forces of a fluid's size (the path's uniform random start
    holds pairs at 1e-2 of a diameter, whose forces swamp every other)."""
    from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                                lattice_positions)
    L = (N_BENCH / RHO_USER) ** 0.5
    cell = torch.eye(2, dtype=torch.float64) * L
    pos = lattice_positions(N_BENCH, cell, 2, dtype=torch.float64,
                            jitter=0.05, seed=4, device="cuda")
    diam = 0.8 + 0.4 * _uniform(6, (N_BENCH,))
    state = build_state_from_arrays(pos, diam, cell, 0, dtype=torch.float64,
                                    cutoff=CUTOFF_USER, device="cuda")
    return state, mt.Parameters(density=RHO_USER, n_particles=N_BENCH,
                                dt=1e-4, potential=user_potential(mt))


def geometry_check(mt, record, case, state64, pot, cutoff):
    """``cell_sweep`` (f64, f32; full and lean) and ``cell_sweep_hilo``
    (full and lean; on the hi/lo words of the f64 state) against their
    plain versions on the path's start in a 2D or tilted box, two launches
    bit for bit, the lean forces the full variant's bits; timed in turns."""
    from mdtpu_torch.ops.cell_sweep import (blocks_per_sm, cell_sweep,
                                            cell_sweep_hilo,
                                            cell_sweep_hilo_plain,
                                            cell_sweep_plain, stage_plan)
    dim = state64.dimension
    for dtype in (torch.float64, torch.float32):
        state = as_dtype(state64, dtype)
        eng = mt.select_engine(pot, cutoff, state)
        nb = eng.allocate(state.positions, state.diameters, state.unitcell,
                          state.unitcell_inv)
        assert not bool(nb.overflow) and len(eng.grid) == dim
        inputs = eng.slot_inputs(state.positions, state.unitcell,
                                 state.unitcell_inv, nb)
        args = (*inputs, eng.grid, eng.cutoff, pot)
        counts_ = pair_counts(inputs, eng.grid, eng.cutoff,
                              pot.max_cutoff(float(state.diameters.max())))
        f64 = dtype == torch.float64
        rtol_ew, tol_f = (1e-12, 1e-10) if f64 else (1e-5, 1e-5)
        tag = str(dtype).split(".")[-1]
        base = {"case": case, "dtype": tag, "grid": list(eng.grid),
                "capacity": eng.cell_capacity,
                "pairs_in_engine_cutoff": counts_[2],
                "pairs_in_potential_cutoff": counts_[3], "library_ms": None}
        calls = {"cell_sweep": lambda: cell_sweep(*args),
                 "cell_sweep_lean": lambda: cell_sweep(*args,
                                                       observables=False)}
        if not f64:
            h_args = hilo_args(eng, state64, pot)
            calls["cell_sweep_hilo"] = lambda: cell_sweep_hilo(*h_args)
            calls["cell_sweep_hilo_lean"] = lambda: cell_sweep_hilo(
                *h_args, observables=False)
        turns = kernel_turns(calls)
        r1 = cell_sweep(*args)
        torch.cuda.synchronize()
        r0 = cell_sweep_plain(*args)
        torch.cuda.synchronize()
        worst, max_abs, rms = force_error(r1[2], r0[2], N_BENCH)
        list_len, smem, threads = stage_plan(eng.cell_capacity, dtype,
                                             False, dim)
        rec = {"kernel_check": "cell_sweep", **base,
               "rel_err_energy": rel(r1[0], r0[0]),
               "rel_err_virial": rel(r1[1], r0[1]),
               "force_err_per_particle": worst, "max_abs_err": max_abs,
               "rms_force": rms,
               "repeats_bit_for_bit": repeats(cell_sweep, args, r1),
               "stage_plan": {"list_len": list_len, "smem_bytes": smem,
                              "threads": threads,
                              "blocks_per_sm": blocks_per_sm(
                                  eng.cell_capacity, dtype, False, pot,
                                  dim=dim)},
               "ms": statistics.median(turns["cell_sweep"]),
               "ms_turns": turns["cell_sweep"],
               "plain_ms": cuda_time_ms(lambda: cell_sweep_plain(*args), 3,
                                        1),
               **bound(inputs, counts_, pot, dtype),
               **stencil_work(counts_, pot, dtype, False, dim=dim)}
        ok = (math.isfinite(float(r1[0])) and rec["rel_err_energy"] <= rtol_ew
              and rec["rel_err_virial"] <= rtol_ew and worst <= tol_f
              and rec["repeats_bit_for_bit"])
        record(rec, ok, f"cell_sweep {case} {tag}")
        lean_check("cell_sweep", cell_sweep, cell_sweep_plain, args, r1,
                   inputs, counts_, pot, base, record, turns)
        if not f64:
            h_full = hilo_check(h_args, pot, counts_, base, record, turns)
            lean_check("cell_sweep_hilo", cell_sweep_hilo,
                       cell_sweep_hilo_plain, h_args, h_full,
                       (h_args[0], *h_args[2:5]), counts_, pot, base, record,
                       turns, hilo=True)
            del h_args
        del state, nb, inputs, args, calls
        torch.cuda.empty_cache()


def list_bound(plist, inputs, counts_, observables=True):
    """The list's and the reduction's least times on these inputs: bytes
    (each input read once, each output written once) over HBM and
    operations over the peak rate. The list reads the occupied slots and
    writes every entry (neighbour int, d + 3 floats) and each own slot's
    count and start (the slots of ``plist.count``: a slab launch's interior
    only); its work is one distance per unordered pair inside the cutoff.
    The full reduction reads every entry's displacement, f, r^2 and u and
    each slot's segment, writes the forces (and two values); 2 d + 4
    operations an entry. The lean one (``observables=False``) reads only
    the displacement and f: d + 1 values and 2 d operations an entry."""
    slot_pos, _, counts, _ = inputs
    dim = slot_pos.shape[0]
    n_slots = plist.count.shape[0]
    b = slot_pos.element_size()
    entries = int(plist.total)
    occupied = int(counts.sum())
    out = {}
    list_bytes = ((dim + 1) * occupied * b + counts.shape[0] * 8
                  + dim * dim * b + entries * (4 + (dim + 3) * b)
                  + 12 * n_slots)
    list_ops = counts_[2] * distance_ops(dim)
    red_bytes = (entries * (dim + 1 + 2 * int(observables)) * b
                 + 12 * n_slots + dim * n_slots * b)
    red_ops = entries * (2 * dim + (4 if observables else 0))
    peak = PEAK_OPS[slot_pos.dtype]
    for name, nbytes, ops in (("list", list_bytes, list_ops),
                              ("reduce", red_bytes, red_ops)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / peak * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "bytes": nbytes, "ops": ops}
    return out


def pair_list_check(mt, record, state64, params):
    """The pair list (count and fill kernels) and the reduction kernel at
    f64 and f32 on config 4's lattice (:func:`user_lattice`), and the
    list's hi/lo variant at f32:
    the list entry for entry against its plain version (the same entries in
    the same order, the same bits: both compute each displacement and r^2
    with the same operations), the reduction against its plain version
    (f64: rtol 1e-12 energy and virial, 1e-10 per particle; f32: 1e-5), the
    lean reduction's forces the full one's bits, two launches bit for bit.
    Timed by graph replay, the reduction also against ``index_add_`` (one
    PyTorch call computing the forces' segmented sum, as its yardstick)."""
    from mdtpu_torch.ops import cell_pairs as cp
    pot = params.potential
    for dtype in (torch.float64, torch.float32):
        state = as_dtype(state64, dtype)
        eng = mt.select_engine(pot, CUTOFF_USER, state)
        assert eng.uses_pair_list and len(eng.grid) == 2
        # The uniform random start's fullest cells overflow the engine's
        # first capacity; grow it as the path does (slotify_grown).
        while True:
            nb = eng.allocate(state.positions, state.diameters,
                              state.unitcell, state.unitcell_inv)
            if not bool(nb.overflow):
                break
            eng = eng.with_grown_capacity()
        inputs = eng.slot_inputs(state.positions, state.unitcell,
                                 state.unitcell_inv, nb)
        cap = eng.pair_list_capacity
        l1 = cp.pair_list(*inputs, eng.grid, eng.cutoff, cap)
        torch.cuda.synchronize()
        l0 = cp.pair_list_plain(*inputs, eng.grid, eng.cutoff, cap)
        total = int(l0.total)
        same = (int(l1.total) == total and not bool(l1.overflow)
                and torch.equal(l1.count, l0.count)
                and all(torch.equal(getattr(l1, k)[..., :total],
                                    getattr(l0, k)[..., :total])
                        for k in ("neighbour", "disp", "r2", "sigma_i",
                                  "sigma_j")))
        again = cp.pair_list(*inputs, eng.grid, eng.cutoff, cap)
        rep_list = all(torch.equal(getattr(l1, k)[..., :total],
                                   getattr(again, k)[..., :total])
                       for k in ("neighbour", "disp", "r2"))
        u, f = pot.evaluate_r2(l1.r2, l1.sigma_i, l1.sigma_j)
        r1 = cp.pair_reduce(l1, f, u)
        torch.cuda.synchronize()
        r0 = cp.pair_reduce_plain(l1, f, u)
        lean = cp.pair_reduce(l1, f)
        worst, max_abs, rms = force_error(r1[2], r0[2], N_BENCH)
        f64 = dtype == torch.float64
        rtol_ew, tol_f = (1e-12, 1e-10) if f64 else (1e-5, 1e-5)
        counts_ = pair_counts(inputs, eng.grid, eng.cutoff, eng.cutoff)
        bounds = list_bound(l1, inputs, counts_)
        lean_bound = list_bound(l1, inputs, counts_, observables=False)
        reduce_kernels = profiled_kernels(lambda: cp.pair_reduce(l1, f, u))
        own = torch.repeat_interleave(
            torch.arange(inputs[0].shape[1], device="cuda"),
            l1.count.long())
        fd = f[:total] * l1.disp[:, :total]
        force_lib = torch.zeros_like(r1[2])
        g_list = graph_of(lambda: cp.pair_list(*inputs, eng.grid,
                                               eng.cutoff, cap))
        # The engines' way: the buffers kept across calls, padded only
        # where an earlier call's hits may lie; the same list as a fresh
        # one, padding included.
        ws = cp.PairListWorkspace()
        g_kept = graph_of(lambda: cp.pair_list(*inputs, eng.grid,
                                               eng.cutoff, cap,
                                               workspace=ws))
        g_kept.replay()
        torch.cuda.synchronize()
        kept_same = all(torch.equal(ws.buffers[k], getattr(l1, k)) for k in
                        ("neighbour", "disp", "r2", "sigma_i", "sigma_j"))
        g_red = graph_of(lambda: cp.pair_reduce(l1, f, u))
        g_lean = graph_of(lambda: cp.pair_reduce(l1, f))
        tag = str(dtype).split(".")[-1]
        base = {"case": "config4_lattice", "dtype": tag,
                "grid": list(eng.grid), "capacity": eng.cell_capacity,
                "list_capacity": cap, "entries": total,
                "pairs_in_engine_cutoff": counts_[2]}
        rec = {"kernel_check": "cell_pairs", **base,
               "list_equal_to_plain": same, "repeats_bit_for_bit": rep_list,
               "kept_buffers_equal": kept_same,
               "max_abs_err": 0.0 if same else float("inf"),
               "ms": cuda_time_ms(g_list.replay, 20, 3),
               "kept_buffers_ms": cuda_time_ms(g_kept.replay, 20, 3),
               "plain_ms": cuda_time_ms(lambda: cp.pair_list_plain(
                   *inputs, eng.grid, eng.cutoff, cap), 3, 1),
               "library_ms": None, **bounds["list"]}
        record(rec, same and rep_list and kept_same, f"cell_pairs {tag}")
        rec = {"kernel_check": "pair_reduce", **base,
               "rel_err_energy": rel(r1[0], r0[0]),
               "rel_err_virial": rel(r1[1], r0[1]),
               "force_err_per_particle": worst, "max_abs_err": max_abs,
               "rms_force": rms,
               "lean_forces_bit_equal": torch.equal(lean[2], r1[2]),
               "repeats_bit_for_bit": repeats(
                   lambda *a: cp.pair_reduce(l1, f, u), (), r1),
               "ms": cuda_time_ms(g_red.replay, 20, 3),
               "lean_ms": cuda_time_ms(g_lean.replay, 20, 3),
               "plain_ms": cuda_time_ms(lambda: cp.pair_reduce_plain(
                   l1, f, u), 3, 1),
               "library_ms": cuda_time_ms(lambda: force_lib.index_add_(
                   1, own, fd), 20, 3),
               "library_call": "Tensor.index_add_ (forces only)",
               "kernels_a_call": len(reduce_kernels),
               "lean_bound_ms": lean_bound["reduce"]["bound_ms"],
               "lean_bound_by": lean_bound["reduce"]["bound_by"],
               **bounds["reduce"]}
        ok = (math.isfinite(float(r1[0])) and rec["rel_err_energy"] <= rtol_ew
              and rec["rel_err_virial"] <= rtol_ew and worst <= tol_f
              and rec["lean_forces_bit_equal"] and rec["repeats_bit_for_bit"]
              and len(reduce_kernels) == 1)
        record(rec, ok, f"pair_reduce {tag}")
        if not f64:
            hi = state64.positions.float()
            lo = (state64.positions - hi.double()).float()
            cell = state64.unitcell.float()
            cinv = state64.unitcell_inv.float()
            nbh = eng.allocate(hi, state64.diameters.float(), cell, cinv)
            assert not bool(nbh.overflow)
            h = eng.slot_inputs_hilo(hi, lo, cell, cinv, nbh)
            h1 = cp.pair_list(h[0], *h[2:], eng.grid, eng.cutoff, cap,
                              slot_lo=h[1])
            torch.cuda.synchronize()
            h0 = cp.pair_list_plain(h[0], *h[2:], eng.grid, eng.cutoff, cap,
                                    slot_lo=h[1])
            total = int(h0.total)
            same = (int(h1.total) == total
                    and all(torch.equal(getattr(h1, k)[..., :total],
                                        getattr(h0, k)[..., :total])
                            for k in ("neighbour", "disp", "r2")))
            g_hilo = graph_of(lambda: cp.pair_list(
                h[0], *h[2:], eng.grid, eng.cutoff, cap, slot_lo=h[1]))
            rec = {"kernel_check": "cell_pairs_hilo", **base,
                   "entries": total, "list_equal_to_plain": same,
                   "max_abs_err": 0.0 if same else float("inf"),
                   "ms": cuda_time_ms(g_hilo.replay, 20, 3),
                   "plain_ms": cuda_time_ms(lambda: cp.pair_list_plain(
                       h[0], *h[2:], eng.grid, eng.cutoff, cap,
                       slot_lo=h[1]), 3, 1),
                   "library_ms": None}
            record(rec, same, "cell_pairs_hilo")
        del state, nb, inputs, l0, l1, again
        torch.cuda.empty_cache()


def probe_phase():
    from mdtpu_torch.ops.experimental import probe

    probe.probe_sweep.launches = 0
    path = [probe.run(spec, reps=20) for spec in PROBE_PATH]
    launches = probe.probe_sweep.launches

    failures, records = [], {}
    w = probe.random_input(0, device="cuda")
    dense = w * (5.0 / 40.0)
    in_bytes = 3 * probe.NX * probe.ROWS * probe.C3 * 4
    out_bytes = probe.NX * probe.ROWS * probe.CAP * 4 + probe.NX * 4
    for spec in PROBE_SPECS:
        variant, chunk = probe.parse_variant(spec)
        worst = 0.0
        ok = True
        for x in (w, dense):
            got = probe.probe_sweep(x, variant, chunk)
            want = probe.probe_sweep_plain(x, variant, chunk)
            for g, h in zip(got, want):
                nan_g, nan_h = torch.isnan(g), torch.isnan(h)
                ok &= bool(torch.equal(nan_g, nan_h))
                fin = ~nan_h
                if bool(fin.any()):
                    err = float((g[fin] - h[fin]).abs().max())
                    scale = max(float(h[fin].abs().max()), 1e-30)
                    worst = max(worst, err)
                    ok &= err <= 1e-5 * scale
        if variant == "reduce_only":
            n_pairs = probe.NX * (probe.ROWS // chunk) * probe.N_OFF
            ops = n_pairs * 23
            nbytes = n_pairs * 6 * 4 + out_bytes
        else:
            n_pairs = (probe.NX * probe.ROWS * probe.CAP * probe.C3
                       * probe.N_OFF)
            ops = n_pairs * OPS_PROBE[variant]
            nbytes = in_bytes + out_bytes
        t_ops = ops / PEAK_OPS[torch.float32] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rec = {"kernel_check": "plane_probe", "variant": variant,
               "chunk": chunk, "ok": ok, "max_abs_err": worst,
               "nan_in_output": bool(torch.isnan(got[1]).any()),
               "ms": cuda_time_ms(graph_of(
                   lambda: probe.probe_sweep(w, variant, chunk)).replay,
                   50, 3),
               "plain_ms": cuda_time_ms(
                   lambda: probe.probe_sweep_plain(w, variant, chunk), 2, 1),
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "candidate_pairs": n_pairs, "ops": ops, "bytes": nbytes,
               "library_ms": None}
        log(json.dumps(rec))
        records[spec] = rec
        if not ok:
            failures.append(f"plane_probe {spec}")
    log(json.dumps({"probe_full_chunk45_over_chunk5_ms":
                    records["full"]["ms"] / records["full:5"]["ms"]}))
    if launches < len(PROBE_PATH):
        failures.append(f"probe path launched plane_probe {launches} times")
    return records, launches, path, failures


def md_path(mt, workdir, label, engine_for, compensated):
    """600 NVT + 500 NVE + 500 force-shifted NVE steps at the bench
    configuration; ``engine_for(state, potential)`` gives the engine."""
    from mdtpu_torch.sim.initialization import lattice_fluid_state

    state = lattice_fluid_state(N_BENCH, 0.8, 1.0, dtype=torch.float32,
                                cutoff=2.5, jitter=0.01, device="cuda")
    params = mt.Parameters(density=0.8, n_particles=N_BENCH, dt=0.002,
                           potential=mt.LennardJones(r_cut=2.5))
    fs_params = dataclasses.replace(
        params, potential=mt.LennardJones(r_cut=2.5, force_shift=True))
    nvt_dir, nve_dir, fs_dir = (os.path.join(workdir, label, d)
                                for d in ("nvt", "nve", "nve_fs"))

    def run(st, prm, ens, steps, out):
        return mt.run_simulation(st, prm, ens, steps, THERMO_EVERY, out,
                                 traj_frequency=TRAJ_EVERY,
                                 engine=engine_for(st, prm.potential),
                                 compensated=compensated)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mid = run(state, params, mt.NVT(1.0, 0.4), NVT_STEPS, nvt_dir)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    end = run(mid, params, mt.NVE(), NVE_STEPS, nve_dir)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # NVE again from the NVT end state with the force-shifted potential (V
    # and F continuous at r_c), whose total energy no cutoff crossing moves.
    fs_end = run(mid, fs_params, mt.NVE(), NVE_STEPS, fs_dir)
    torch.cuda.synchronize()
    t3 = time.perf_counter()

    failures = []

    def check(cond, what):
        if not cond:
            failures.append(f"{label}: {what}")

    steps = NVT_STEPS + NVE_STEPS
    for st in (end, fs_end):
        check(st.step == steps, f"final step {st.step} != {steps}")
        check(bool(torch.isfinite(st.positions).all())
              and bool(torch.isfinite(st.velocities).all()),
              "non-finite state")
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
                          -(-NVT_STEPS // TRAJ_EVERY)),
                         (os.path.join(nve_dir, "trajectory.xyz"),
                          -(-NVE_STEPS // TRAJ_EVERY)),
                         (os.path.join(fs_dir, "trajectory.xyz"),
                          -(-NVE_STEPS // TRAJ_EVERY))):
        with open(path) as f:
            text = f.read()
        check(text.count("ITEM: TIMESTEP") == frames, f"frames in {path}")
        check(text.count("\n") == frames * (9 + N_BENCH), f"rows in {path}")
    for d in (nvt_dir, nve_dir, fs_dir):
        with open(os.path.join(d, "final.xyz")) as f:
            check(sum(1 for _ in f) == N_BENCH + 2, f"final.xyz in {d}")
    # Observables of the final state: g(r) through the RDF kernel at
    # sample_rdf's half width (the tile route) and at validate.py's r_max 3
    # (the cell route), the liquid's first peak in both; the MSD from the
    # lattice start (images 0), and read_thermo of the NVE leg's file.
    from mdtpu_torch.observables import (mean_squared_displacement,
                                         read_thermo, sample_rdf)
    rdf_peak = []
    for r_max in (None, RDF_R_MAX):
        centers, g = sample_rdf(end, r_max=r_max)
        peak = max(range(len(g)), key=lambda k: g[k])
        rdf_peak.append([float(centers[peak]), float(g[peak])])
        check(0.95 < rdf_peak[-1][0] < 1.25 and 1.5 < rdf_peak[-1][1] < 5.0,
              f"first RDF peak {rdf_peak[-1]} (r_max {r_max})")
    msd = mean_squared_displacement(end, state.positions)
    check(math.isfinite(msd) and msd > 0.01, f"MSD {msd}")
    cols = read_thermo(os.path.join(nve_dir, "thermo.txt"))
    check([[float(cols[k][i]) for k in ("step", "energy", "temperature",
                                        "pressure")]
           for i in range(len(cols["step"]))] == nve_rows,
          "read_thermo columns != the file's rows")
    rec = {
        "path": label, "compensated": compensated,
        "steps": steps, "nvt_s": t1 - t0, "nve_s": t2 - t1,
        "steps_per_s": steps / (t2 - t0),
        "particle_steps_per_s": steps * N_BENCH / (t2 - t0),
        "nvt_mean_T": mean_t,
        "nve_total_energy_per_particle": e_tot, "nve_energy_range": drift,
        "nve_shifted_s": t3 - t2,
        "nve_shifted_total_energy_per_particle": fs_tot,
        "nve_shifted_energy_range": fs_drift,
        "thermo_nvt": nvt_rows, "thermo_nve": nve_rows,
        "rdf_first_peak": rdf_peak, "msd_from_start": msd,
    }
    return rec, failures


def brownian_state():
    """The Brownian path's start: 65,536 particles at rho 0.5, f32. Jitter
    0.05 of the spacing 1.26: a few hundred pairs start inside the
    pseudo-hard-sphere range (1.02), the closest near 0.9, so the first moves
    stay well below a cell (measured at 8,000 particles on the CPU: the
    largest first move 0.04)."""
    from mdtpu_torch.sim.initialization import lattice_fluid_state
    return lattice_fluid_state(N_BENCH, 0.5, 1.0, dtype=torch.float32,
                               cutoff=1.5, jitter=0.05, device="cuda")


def brownian_path(mt, workdir, slots=False):
    """Brownian dynamics through PlaneEngine with log-time snapshots, or
    (``slots``) through ``select_engine``'s cell grid, in the slot layout,
    with a frame at step 0 only."""
    from mdtpu_torch.ops.experimental import PlaneEngine

    state = brownian_state()
    params = mt.Parameters(density=0.5, n_particles=N_BENCH, dt=1e-5,
                           potential=mt.PseudoHS())
    label = "brownian_slot" if slots else "brownian"
    engine = None if slots else PlaneEngine.create(
        params.potential, 1.5, 0.3, state.unitcell, N_BENCH)
    out_dir = os.path.join(workdir, label)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    end = mt.run_simulation(state, params, mt.Brownian(1.0), BROWNIAN_STEPS,
                            BROWNIAN_THERMO_EVERY, out_dir, engine=engine,
                            log_times=not slots,
                            traj_frequency=BROWNIAN_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    failures = []

    def check(cond, what):
        if not cond:
            failures.append(f"{label}: {what}")

    check(end.step == BROWNIAN_STEPS, "final step")
    check(bool(torch.isfinite(end.positions).all()), "non-finite positions")
    rows = _rows(os.path.join(out_dir, "thermo.txt"))
    check(len(rows) == BROWNIAN_STEPS // BROWNIAN_THERMO_EVERY,
          "thermo rows")
    check(all(math.isfinite(v) for r in rows for v in r), "non-finite thermo")
    check(all(r[2] == 1.0 for r in rows), "T column is not kT")
    rec = {"path": label, "steps": BROWNIAN_STEPS, "seconds": seconds,
           "steps_per_s": BROWNIAN_STEPS / seconds, "thermo": rows}
    if slots:
        with open(os.path.join(out_dir, "trajectory.xyz")) as f:
            text = f.read()
        check(text.count("ITEM: TIMESTEP") == 1
              and text.count("\n") == 9 + N_BENCH, "trajectory frame")
        with open(os.path.join(out_dir, "final.xyz")) as f:
            check(sum(1 for _ in f) == N_BENCH + 2, "final.xyz")
        return rec, failures
    with open(os.path.join(out_dir, "new-log-times.txt")) as f:
        times = [int(x) for x in f.read().split()[1:]]
    want = sorted({0} | {s for s in times if s < BROWNIAN_STEPS})
    snaps = sorted(int(name.split(".")[1]) for name in os.listdir(out_dir)
                   if name.startswith("snapshot."))
    check(snaps == want, f"snapshots {snaps} != {want}")
    for s in snaps:
        with open(os.path.join(out_dir, f"snapshot.{s}")) as f:
            text = f.read()
        check(text.count("\n") == 9 + N_BENCH
              and text.startswith(f"ITEM: TIMESTEP\n{s}\n"),
              f"snapshot.{s}")
    rec["snapshots"] = snaps
    return rec, failures


def fire_path(mt):
    """FIRE on the bench_fire.py system at 65,536 particles through
    ``fire_minimize`` on ``select_engine``'s cell grid (the slot FIRE): first
    N_FIRE_DESCENT iterations, whose energy must lie below the start's, then
    N_FIRE_ITERS at tol 0, timed. The reference's step limits (dt_max 0.1,
    dmax 0.1) overshoot on this dense fluid after a few dozen iterations and
    the energy climbs above the start's, in the JAX package too
    (``tests/test_torch_fire.py`` holds the port's climb to the JAX
    package's on this system at N = 500, and run as a script prints both to
    200 iterations), so the long run is held to a finite state and its
    iteration count only. The start's
    energy comes from the plain sweep, which launches nothing."""
    from mdtpu_torch.ops.cell_sweep import cell_sweep_plain
    from mdtpu_torch.sim.initialization import lattice_fluid_state
    state = lattice_fluid_state(N_BENCH, 0.8, 1.0, dtype=torch.float32,
                                cutoff=2.5, jitter=0.05, device="cuda")
    params = mt.Parameters(density=0.8, n_particles=N_BENCH, dt=0.002,
                           potential=mt.LennardJones(r_cut=2.5))
    engine = mt.select_engine(params.potential, 2.5, state)
    nb = engine.allocate(state.positions, state.diameters, state.unitcell,
                         state.unitcell_inv)
    e0 = float(cell_sweep_plain(
        *engine.slot_inputs(state.positions, state.unitcell,
                            state.unitcell_inv, nb),
        engine.grid, engine.cutoff, engine.potential)[0])

    def run(iterations):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mt.fire_minimize(state, params, engine,
                               max_steps=iterations, tol=0.0)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (_, descent, _, n_descent), _ = run(N_FIRE_DESCENT)
    (end, energy, _, n_steps), seconds = run(N_FIRE_ITERS)
    failures = []

    def check(cond, what):
        if not cond:
            failures.append(f"fire: {what}")

    descent, energy = float(descent), float(energy)
    check(n_descent == N_FIRE_DESCENT and n_steps == N_FIRE_ITERS,
          f"ran {n_descent} and {n_steps} iterations")
    check(descent < e0, f"energy {descent} after {n_descent} iterations "
          f"not below the start's {e0}")
    check(bool(torch.isfinite(end.positions).all()) and math.isfinite(energy),
          "non-finite state")
    check(torch.equal(end.velocities, state.velocities),
          "caller's velocities not restored")
    return {"path": "fire", "iterations": n_steps, "seconds": seconds,
            "iterations_per_s": n_steps / seconds, "energy_start": e0,
            f"energy_after_{N_FIRE_DESCENT}": descent,
            f"energy_after_{N_FIRE_ITERS}": energy,
            "grid": list(engine.grid),
            "capacity": engine.cell_capacity}, failures


def pack_path(mt, workdir):
    """``initialize_state`` without positions (mode D, packing) at 65,536
    particles, rho 0.8. The packer's FIRE must converge (its result is
    recorded on the way), and no pair of the packed positions may be closer
    than tol by more than 4 eps L: the f32 positions are folded into the box
    on the host, and the check takes their minimum image, each rounding a
    coordinate by up to half an ulp of L, so a pair that FIRE left just at
    tol can come out closer by a few ulps. Every pair's overlap is at most
    the square root of the overlap energy (by the plain sweep, which
    launches nothing)."""
    from mdtpu_torch.minimize import fire as fire_mod
    from mdtpu_torch.ops.cell_sweep import cell_sweep_plain
    params = mt.Parameters(density=PACK_DENSITY, n_particles=N_BENCH,
                           dt=0.001, potential=mt.LennardJones(r_cut=2.5))
    out_dir = os.path.join(workdir, "pack")
    minimizations = []
    fire_minimize = fire_mod.fire_minimize

    def recorded(*args, **kwargs):
        out = fire_minimize(*args, **kwargs)
        minimizations.append((out[2], out[3]))
        return out

    fire_mod.fire_minimize = recorded
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = mt.initialize_state(params, out_dir, seed=0, cutoff=2.5,
                                    device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        fire_mod.fire_minimize = fire_minimize
    failures = []

    def check(cond, what):
        if not cond:
            failures.append(f"pack: {what}")

    pos = state.positions
    L = float(state.unitcell[0, 0])
    check(tuple(pos.shape) == (N_BENCH, 3)
          and bool(torch.isfinite(pos).all()), "positions")
    check(float(pos.min()) >= 0.0 and float(pos.max()) < L, "outside the box")
    check(os.path.isfile(os.path.join(out_dir, "init.xyz")), "init.xyz")
    check(len(minimizations) == 1 and minimizations[0][0],
          f"FIRE did not converge: {minimizations}")
    eng, nb, cinv = pack_engine(mt, pos, state.unitcell)
    energy = float(cell_sweep_plain(
        *eng.slot_inputs(pos, state.unitcell, cinv, nb), eng.grid,
        eng.cutoff, eng.potential)[0])
    overlap_limit = 4 * torch.finfo(torch.float32).eps * L
    check(math.sqrt(energy) <= overlap_limit,
          f"overlap energy {energy} after packing")
    return {"path": "pack", "n": N_BENCH, "density": PACK_DENSITY,
            "seconds": seconds, "fire_iterations": minimizations[0][1],
            "overlap_energy": energy, "largest_overlap_at_most":
            math.sqrt(energy), "overlap_limit": overlap_limit}, failures


def geo_path(mt, workdir, label, state, params, nvt):
    """``run_simulation`` on ``select_engine``'s cell grid (the slot route)
    from ``state``: GEO_NVT_STEPS of ``nvt``, then GEO_NVE_STEPS of NVE
    (f32 NVE takes the hi/lo sweep), thermo every 100 steps, one trajectory
    frame a leg."""
    nvt_dir, nve_dir = (os.path.join(workdir, label, d)
                        for d in ("nvt", "nve"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mid = mt.run_simulation(state, params, nvt, GEO_NVT_STEPS, THERMO_EVERY,
                            nvt_dir, traj_frequency=GEO_NVT_STEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    end = mt.run_simulation(mid, params, mt.NVE(), GEO_NVE_STEPS,
                            THERMO_EVERY, nve_dir,
                            traj_frequency=GEO_NVE_STEPS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    failures = []

    def check(cond, what):
        if not cond:
            failures.append(f"{label}: {what}")

    steps = GEO_NVT_STEPS + GEO_NVE_STEPS
    check(end.step == steps, f"final step {end.step} != {steps}")
    check(bool(torch.isfinite(end.positions).all())
          and bool(torch.isfinite(end.velocities).all()), "non-finite state")
    nvt_rows = _rows(os.path.join(nvt_dir, "thermo.txt"))
    nve_rows = _rows(os.path.join(nve_dir, "thermo.txt"))
    check(len(nvt_rows) == GEO_NVT_STEPS // THERMO_EVERY, "NVT thermo rows")
    check(len(nve_rows) == GEO_NVE_STEPS // THERMO_EVERY, "NVE thermo rows")
    check(all(math.isfinite(v) for r in nvt_rows + nve_rows for v in r),
          "non-finite thermo")
    # Past the lattice start's relaxation, as the bench path reads it.
    t_nvt = [r[2] for r in nvt_rows[2:]]
    mean_t = sum(t_nvt) / max(len(t_nvt), 1)
    check(abs(mean_t - nvt.ktemp(0)) < 0.1, f"NVT mean temperature {mean_t}")
    ke = end.nf / (2.0 * N_BENCH)
    e_tot = [r[1] + ke * r[2] for r in nve_rows]
    drift = max(e_tot) - min(e_tot)
    check(drift < 5e-3, f"NVE total energy per particle moved {drift}")
    for d, leg in ((nvt_dir, GEO_NVT_STEPS), (nve_dir, GEO_NVE_STEPS)):
        with open(os.path.join(d, "trajectory.xyz")) as f:
            text = f.read()
        check(text.count("ITEM: TIMESTEP") == 1
              and text.count("\n") == 9 + N_BENCH, f"frame in {d}")
        with open(os.path.join(d, "final.xyz")) as f:
            check(sum(1 for _ in f) == N_BENCH + 2, f"final.xyz in {d}")
    return {"path": label, "dimension": end.dimension,
            "cell": end.unitcell.tolist(), "steps": steps,
            "nvt_s": t1 - t0, "nve_s": t2 - t1,
            "steps_per_s": steps / (t2 - t0),
            "particle_steps_per_s": steps * N_BENCH / (t2 - t0),
            "nvt_mean_T": mean_t, "nve_energy_range": drift,
            "thermo_nvt": nvt_rows, "thermo_nve": nve_rows}, failures


def user_path(mt, workdir, kept):
    """BASELINE config 4 at 65,536 through the pair-list route: the XYZ
    start, ``minimize`` (slot FIRE on the cell grid, tol 1e-4, at most
    USER_FIRE_ITERS iterations at dmax USER_DMAX, timed), then NVT(0.5,
    0.01) at dt 1e-4 for USER_NVT_STEPS steps (timed). The start's energy
    comes from the plain list route, which launches nothing. ``kept``
    receives the start's energy, the NVT leg's start (the minimized state
    with its velocities), the parameters and the NVT rows, for the sharded
    user path."""
    from mdtpu_torch.ops import cell_pairs as cp
    from mdtpu_torch.sim.initialization import initialize_velocities
    out_dir = os.path.join(workdir, "user")
    state, params = user_start(mt, out_dir)
    eng = mt.select_engine(params.potential, CUTOFF_USER, state,
                           workload="minimize")
    nb = eng.allocate(state.positions, state.diameters, state.unitcell,
                      state.unitcell_inv)
    slot_inputs = eng.slot_inputs(state.positions, state.unitcell,
                                  state.unitcell_inv, nb)
    plist = cp.pair_list_plain(*slot_inputs, eng.grid, eng.cutoff,
                               eng.pair_list_capacity)
    u, f = params.potential.evaluate_r2(plist.r2, plist.sigma_i,
                                        plist.sigma_j)
    e0 = float(cp.pair_reduce_plain(plist, f, u)[0])
    del plist, u, f, slot_inputs, nb
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, energy, converged, n_iter = mt.minimize(
        state, params, out_dir, 2, tol=1e-4, max_steps=USER_FIRE_ITERS,
        dmax=USER_DMAX)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state = state.replace(velocities=initialize_velocities(
        0.5, 1, N_BENCH, 2, dtype=torch.float64, device="cuda"))
    kept.update(energy_start=e0, nvt_start=state, params=params)
    nvt_dir = os.path.join(out_dir, "nvt")
    end = mt.run_simulation(state, params, mt.NVT(0.5, 0.01), USER_NVT_STEPS,
                            THERMO_EVERY, nvt_dir,
                            traj_frequency=USER_NVT_STEPS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    failures = []

    def check(cond, what):
        if not cond:
            failures.append(f"user: {what}")

    energy = float(energy)
    check(math.isfinite(energy) and energy < e0,
          f"energy {energy} after {n_iter} iterations, start {e0}")
    check(os.path.isfile(os.path.join(out_dir, "minimized.xyz")),
          "minimized.xyz")
    check(end.step == USER_NVT_STEPS
          and bool(torch.isfinite(end.positions).all()), "NVT state")
    rows = _rows(os.path.join(nvt_dir, "thermo.txt"))
    kept["rows"] = rows
    check(len(rows) == USER_NVT_STEPS // THERMO_EVERY
          and all(math.isfinite(v) for r in rows for v in r), "NVT rows")
    # The Bussi thermostat at tau = 100 dt holds T near 0.5 once the
    # minimized state no longer holds overlaps that heat it.
    check(all(abs(r[2] - 0.5) < 0.25 for r in rows[1:]),
          f"NVT temperatures {[r[2] for r in rows]}")
    return {"path": "user", "potential": "NonAdditivePHS (pair-list route)",
            "grid": list(eng.grid), "capacity": eng.cell_capacity,
            "list_capacity": eng.pair_list_capacity,
            "energy_start": e0, "energy_minimized": energy,
            "energy_minimized_per_particle": energy / N_BENCH,
            "fire_dmax": USER_DMAX,
            "fire_converged": converged, "fire_iterations": n_iter,
            "fire_s": t1 - t0, "iterations_per_s": n_iter / (t1 - t0),
            "nvt_steps": USER_NVT_STEPS, "nvt_s": t2 - t1,
            "steps_per_s": USER_NVT_STEPS / (t2 - t1), "thermo": rows}, \
        failures


def timed_once(fn):
    """``fn()`` and its device time in ms (one call between two events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def near_edge_pairs(pos, cell, cell_inv, r_max, n_bins, tol):
    """Ordered pairs inside ``r_max`` whose scaled distance r / r_max *
    n_bins lies within ``tol`` of an integer, in float64 (row chunks): the
    pairs a rounding of the last bit could move to the next bin."""
    p, c, ci = pos.double(), cell.double(), cell_inv.double()
    n = p.shape[0]
    rows = max(1, (1 << 22) // n)
    count = 0
    for a in range(0, n, rows):
        f = (p[a:a + rows, None, :] - p[None, :, :]) @ ci.T
        f = f - torch.round(f)
        r = torch.linalg.norm(f @ c.T, dim=-1)
        x = r / r_max * n_bins
        near = ((x - torch.round(x)).abs() < tol) & (r < r_max)
        own = torch.arange(near.shape[0], device=p.device)
        near[own, own + a] = False
        count += int(near.sum())
    return count


def rdf_bound(n, dim, dtype, hits, n_bins, pattern):
    """The least time of the histogram: each unordered pair inside r_max
    once, its distance by the box's zero pattern and its bin (operations),
    the positions and the cell read once and the counts written once
    (bytes); ``all_pairs_ms``: the first design's bound, every unordered
    pair's distance by the general count."""
    ops = hits * (OPS_RDF_DISTANCE[dim][pattern] + OPS_RDF_HIT)
    all_ops = (n * (n - 1) // 2 * OPS_RDF_DISTANCE[dim][0]
               + hits * OPS_RDF_HIT)
    b = torch.finfo(dtype).bits // 8
    nbytes = n * dim * b + 2 * dim * dim * b + n_bins * 8
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes, "ops_bound_ms": t_ops,
            "bytes_bound_ms": t_bytes,
            "all_pairs_ms": max(all_ops / PEAK_OPS[dtype] * 1e3, t_bytes)}


def call_ms(fn, reps=5):
    """The median time of ``reps`` whole calls of ``fn``, each between two
    CUDA events (the host's work inside the call included)."""
    times = []
    for _ in range(reps):
        times.append(timed_once(fn)[1])
    return statistics.median(times)


def rdf_phase(mt):
    """``rdf_histogram`` against its plain version on the bench fluid
    (``melted_state``), the 2D start and the tilted start at 65,536, in f64
    and f32, at r_max 3 and at half the narrowest width, and on the bench
    lattice at 262,144 at r_max 3: the counts bin for bin (or within twice
    the pairs at a bin edge, counted in f64 to 1e-12 or, at f32, 1e-6),
    two launches alike; also ``validate_torch.py``'s triple point shape
    (4,096 at rho 0.84) at r_max 3. Records the plan (route, zero pattern,
    grid) and times by graph replay in turns the launch on the plan (the
    cell route's binning included), and where the cell route is taken its
    binning alone and the tile route forced on the same inputs; the whole
    call (plan and its host reads included; for the cell route also the
    forced tile route's) and the plain version by events."""
    from mdtpu_torch.observables import half_min_width
    from mdtpu_torch.ops import rdf
    from mdtpu_torch.sim.initialization import lattice_fluid_state

    melted = melted_state(mt)
    big = lattice_fluid_state(4 * N_BENCH, 0.8, 1.0, dtype=torch.float64,
                              cutoff=2.5, jitter=0.05, device="cuda")
    triple = lattice_fluid_state(4096, 0.84, 0.75, dtype=torch.float64,
                                 cutoff=2.5, jitter=0.05, device="cuda")
    cases = (("bench_melted", lambda dt: as_dtype(melted, dt), True),
             ("bench_2d", lambda dt: state_2d(mt, dt), True),
             ("bench_tilted", lambda dt: state_tilted(mt, dt), True),
             ("lattice_262144", lambda dt: as_dtype(big, dt), False),
             ("triple_4096", lambda dt: as_dtype(triple, dt), False))
    results, failures = {}, []
    for name, make, with_half in cases:
        for dtype in (torch.float64, torch.float32):
            st = make(dtype)
            args = (st.positions.contiguous(), st.unitcell, st.unitcell_inv)
            pos = args[0]
            n, dim = st.positions.shape
            tag = str(dtype).split(".")[-1]
            radii = [("r_max_3", RDF_R_MAX)] + [
                ("half_width", half_min_width(st.unitcell))] * with_half
            for rname, r_max in radii:
                plan = rdf.rdf_plan(*args, r_max, RDF_BINS)
                first = rdf.rdf_histogram(*args, r_max, RDF_BINS)
                again = rdf.rdf_histogram(*args, r_max, RDF_BINS)
                plain, plain_ms = timed_once(
                    lambda: rdf.rdf_histogram_plain(*args, r_max, RDF_BINS))
                diff = (first - plain).abs()
                excused = 0
                if int(diff.sum()):
                    excused = near_edge_pairs(
                        *args, r_max, RDF_BINS,
                        1e-12 if dtype == torch.float64 else 1e-6)
                calls = {"rdf": lambda: rdf.rdf_launch(plan, pos)}
                tile_same = None
                if plan.route == rdf.CELL:
                    # The binning alone (the cell route's torch part).
                    calls["binning"] = lambda: torch.index_select(
                        pos, 0, rdf.bin_by_cell(plan.frac, plan.grid)[1])
                    tile = rdf.rdf_plan(*args, r_max, RDF_BINS,
                                        route=rdf.TILE)
                    calls["tile"] = lambda: rdf.rdf_launch(tile, pos)
                    tile_same = bool(torch.equal(calls["tile"](), first))
                reps = 20 if plan.route == rdf.CELL else 3
                turns = kernel_turns(calls, rounds=3, reps=reps)
                hits = int(first.sum()) // 2
                rec = {"kernel_check": "rdf_histogram", "case": name,
                       "dtype": tag, "r_max": r_max, "r_max_case": rname,
                       "n": n, "dim": dim, "route": plan.route,
                       "pattern": ("general", "upper", "diagonal")[
                           plan.pattern], "grid": plan.grid,
                       "pairs_inside": hits,
                       "bins_differing": int((diff > 0).sum()),
                       "total_difference": int(diff.sum()),
                       "pairs_excused": excused,
                       "max_abs_err": float(diff.max()),
                       "repeats_exactly": bool(torch.equal(first, again)),
                       "tile_route_equal": tile_same,
                       "ms": statistics.median(turns["rdf"]),
                       "ms_turns": turns["rdf"],
                       "tile_route_ms": (statistics.median(turns["tile"])
                                         if "tile" in turns else None),
                       "binning_ms": (statistics.median(turns["binning"])
                                      if "binning" in turns else None),
                       "call_ms": call_ms(lambda: rdf.rdf_histogram(
                           *args, r_max, RDF_BINS)),
                       "tile_route_call_ms": (call_ms(
                           lambda: rdf.rdf_launch(rdf.rdf_plan(
                               *args, r_max, RDF_BINS, route=rdf.TILE),
                               pos)) if "tile" in turns else None),
                       "plain_ms": plain_ms, "library_ms": None,
                       **rdf_bound(n, dim, dtype, hits, RDF_BINS,
                                   plan.pattern)}
                ok = (int(diff.sum()) <= 2 * excused and hits > 0
                      and rec["repeats_exactly"] and tile_same is not False)
                rec["ok"] = ok
                log(json.dumps(rec))
                results[(name, tag, rname)] = rec
                if not ok:
                    failures.append(f"rdf_histogram {name} {tag} {rname}")
            del st, args, pos
            torch.cuda.empty_cache()
    return results, failures


def nl_bound(n, dim, dtype, *, candidates=0, occupied=0, n_cells=0, k=0,
             entries=0, inside_pot=0, pot=None):
    """The least time of K1 (``candidates`` > 0: each stencil candidate's
    distance and test once; the positions, the particles' cells, the cells'
    counts and the buckets' occupied entries read once, the whole (N, K)
    list and the counts written once) or of K2 (each list entry's distance
    and test once, each unordered pair inside the potential's cutoff
    evaluated once; the list's entries, counts, positions and diameters
    read once, the forces written once). The bytes count only what the
    function needs: not the binning's ``order`` and starts, which only
    schedule the kernels' work."""
    b = torch.finfo(dtype).bits // 8
    if candidates:
        ops = candidates * OPS_NL_DISTANCE
        nbytes = (n * dim * b + 4 * n + 4 * occupied + 8 * n_cells
                  + 4 * n * k + 4 * n + 4)
    else:
        ops = (entries * OPS_NL_DISTANCE
               + inside_pot * OPS_POTENTIAL_PAIR[type(pot).__name__])
        nbytes = 4 * entries + 4 * n + n * (dim + 1) * b + n * dim * b
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes, "ops_bound_ms": t_ops,
            "bytes_bound_ms": t_bytes}


def stencil_candidates(counts, grid, cap):
    """Candidates K1 visits: for every particle the occupied slots of its
    3^d stencil cells (itself included)."""
    dim = len(grid)
    cnt = counts.clamp(max=cap).reshape(grid)
    near = sum(torch.roll(cnt, tuple(-o for o in off),
                          dims=tuple(range(dim)))
               for off in itertools.product((-1, 0, 1), repeat=dim))
    return int((counts.reshape(grid) * near).sum())


def same(a, b):
    """Two results (tuples of tensors) equal bit for bit."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


def list_phase(mt):
    """K1 (``nl_build``) and K2 (``nl_forces``) against their plain versions
    on the bench's jittered lattice and melted fluid at 65,536 and 262,144,
    and the lattice with its particles shuffled (a random order of the same
    positions, as a packing leaves them) at 65,536, f64 and f32. K1, given
    the binning's ``order`` and starts: its rows bit for bit the
    stencil-order plain build's (padding included) and equal as sets to
    the default plain build's, its counts and flag equal; again with C a
    quarter and K 32 (both flags up, rows, counts equal) and with C grown
    twice (a stage of 9 stencil cells, rows equal). K2 on K1's list, its
    rows in the state's cell order, within f64 1e-12 / 1e-10, f32 1e-5, and
    its forces bit-equal to the particle-order launch's; two launches of
    each bit for bit. Times by graph replay in turns with B1 (full and lean)
    on the same state and K2 in particle order, the plain versions and the
    whole ``allocate`` (binning and K1) by events; bounds from this run's
    list."""
    from mdtpu_torch.ops import neighbor_list as nl
    from mdtpu_torch.ops.cell_sweep import cell_sweep
    from mdtpu_torch.sim.initialization import lattice_fluid_state

    pot = mt.LennardJones(r_cut=2.5)
    results, failures = {}, []
    for n in NL_SIZES:
        melted = melted_state(mt, n)
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(9))
        for case in ("lattice", "melted", "shuffled")[:3 if n == N_BENCH
                                                      else 2]:
            for dtype in (torch.float64, torch.float32):
                tag = str(dtype).split(".")[-1]
                st = (as_dtype(melted, dtype) if case == "melted" else
                      lattice_fluid_state(n, 0.8, 1.0, dtype=dtype,
                                          cutoff=2.5, jitter=0.01,
                                          device="cuda"))
                if case == "shuffled":
                    st = st.replace(positions=st.positions[
                        perm.to(st.positions.device)])
                eng = mt.select_engine(pot, 2.5, st, prefer="neighbor")
                assert isinstance(eng, nl.NeighborListEngine), eng
                lengths = torch.diagonal(st.unitcell).contiguous()
                pos = st.positions.contiguous()

                def build_args(e):
                    cid, buf, counts, order, starts = e.bin_sorted(
                        pos, st.unitcell_inv)
                    return ((pos, cid, buf, counts, lengths, e.grid,
                             e.cutoff + e.skin, e.max_neighbors),
                            {"order": order, "starts": starts})

                b_args, b_kw = build_args(eng)
                counts = b_args[3]
                idx, count, over = nl.nl_build(*b_args, **b_kw)
                torch.cuda.synchronize()
                ordered = nl.nl_build_plain(*b_args, stencil_order=True)
                idx0, count0, over0 = nl.nl_build_plain(*b_args)
                rows_differ = int((idx != ordered[0]).any(1).sum())
                sets_differ = int((torch.sort(idx, 1).values
                                   != torch.sort(idx0, 1).values)
                                  .any(1).sum())
                build_repeats = same(nl.nl_build(*b_args, **b_kw),
                                     (idx, count, over))
                small_args, small_kw = build_args(dataclasses.replace(
                    eng, cell_capacity=eng.cell_capacity // 4,
                    max_neighbors=32))
                small = nl.nl_build(*small_args, **small_kw)
                small0 = nl.nl_build_plain(*small_args, stencil_order=True)
                grown = eng.with_grown_capacity().with_grown_capacity()
                g_args, g_kw = build_args(grown)
                g_out = nl.nl_build(*g_args, **g_kw)
                g_want = nl.nl_build_plain(*g_args, stencil_order=True)
                order = b_kw["order"]
                f_args = (pos, st.diameters, idx, count, lengths,
                          eng.cutoff, pot)
                e1, w1, f1 = nl.nl_forces(*f_args, order=order)
                torch.cuda.synchronize()
                e0, w0, f0 = nl.nl_forces_plain(*f_args)
                forces_repeat = same(nl.nl_forces(*f_args, order=order),
                                     (e1, w1, f1))
                unordered = nl.nl_forces(*f_args)
                worst, max_abs, rms = force_error(f1.T, f0.T, n)
                # B1 on the same state, in the same turns.
                cg = mt.select_engine(pot, 2.5, st)
                nb = cg.allocate(pos, st.diameters, st.unitcell,
                                 st.unitcell_inv)
                assert not bool(nb.overflow)
                sw = (*cg.slot_inputs(pos, st.unitcell, st.unitcell_inv,
                                      nb), cg.grid, cg.cutoff, pot)
                turns = kernel_turns({
                    "nl_build": lambda: nl.nl_build(*b_args, **b_kw),
                    "nl_build_grown": lambda: nl.nl_build(*g_args, **g_kw),
                    "nl_forces": lambda: nl.nl_forces(*f_args, order=order),
                    "nl_forces_particle_order": lambda: nl.nl_forces(
                        *f_args),
                    "cell_sweep": lambda: cell_sweep(*sw),
                    "cell_sweep_lean": lambda: cell_sweep(
                        *sw, observables=False)})
                inside_pot = round(float(nl.nl_forces_plain(
                    pos.double(), st.diameters.double(), idx, count,
                    lengths.double(), eng.cutoff, PairCounter(2.5))[0]))
                entries = int(count.sum())
                base = {"case": f"{case}_{n}", "n": n, "dtype": tag,
                        "grid": list(eng.grid), "capacity":
                        eng.cell_capacity, "max_neighbors":
                        eng.max_neighbors, "list_entries": entries,
                        "mean_list_length": entries / n,
                        "pairs_in_potential_cutoff": inside_pot,
                        "b1_ms": statistics.median(turns["cell_sweep"]),
                        "b1_lean_ms": statistics.median(
                            turns["cell_sweep_lean"]),
                        "library_ms": None}
                rec = {"kernel_check": "nl_build", **base,
                       "stage_cells": nl.build_plan(eng.cell_capacity, 3,
                                                    dtype),
                       "rows_differing_stencil_order": rows_differ,
                       "rows_differing_as_sets": sets_differ,
                       "max_abs_err": float(rows_differ + sets_differ),
                       "counts_equal": bool(torch.equal(count, count0)
                                            and torch.equal(count,
                                                            ordered[1])),
                       "overflow": [bool(over), bool(over0),
                                    bool(ordered[2])],
                       "overflow_small": [bool(small[2]), bool(small0[2])],
                       "small_equal_stencil_order": same(small, small0),
                       "counts_equal_small": bool(torch.equal(
                           small[1], nl.nl_build_plain(*small_args)[1])),
                       "grown_capacity": grown.cell_capacity,
                       "grown_stage_cells": nl.build_plan(
                           grown.cell_capacity, 3, dtype),
                       "grown_equal_stencil_order": same(g_out, g_want),
                       "grown_ms": statistics.median(
                           turns["nl_build_grown"]),
                       "repeats_bit_for_bit": build_repeats,
                       "ms": statistics.median(turns["nl_build"]),
                       "ms_turns": turns["nl_build"],
                       "plain_ms": cuda_time_ms(
                           lambda: nl.nl_build_plain(*b_args), 2, 1),
                       "allocate_ms": cuda_time_ms(
                           lambda: eng.allocate(pos, st.diameters,
                                                st.unitcell,
                                                st.unitcell_inv), 5, 2),
                       **nl_bound(n, 3, dtype, candidates=stencil_candidates(
                           counts, eng.grid, eng.cell_capacity),
                           occupied=int(counts.clamp(
                               max=eng.cell_capacity).sum()),
                           n_cells=counts.numel(), k=eng.max_neighbors)}
                ok = (rows_differ == 0 and sets_differ == 0
                      and rec["counts_equal"]
                      and rec["overflow"] == [False] * 3
                      and rec["overflow_small"] == [True, True]
                      and rec["small_equal_stencil_order"]
                      and rec["counts_equal_small"]
                      and rec["grown_stage_cells"] < rec["stage_cells"]
                      and rec["grown_equal_stencil_order"]
                      and not bool(g_out[2]) and build_repeats)
                rec["ok"] = ok
                log(json.dumps(rec))
                results[("nl_build", f"{case}_{n}", tag)] = rec
                if not ok:
                    failures.append(f"nl_build {case} {n} {tag}")
                f64 = dtype == torch.float64
                rtol_ew, tol_f = (1e-12, 1e-10) if f64 else (1e-5, 1e-5)
                rec = {"kernel_check": "nl_forces", **base,
                       "lanes": nl.LANES,
                       "rel_err_energy": rel(e1, e0),
                       "rel_err_virial": rel(w1, w0),
                       "force_err_per_particle": worst,
                       "max_abs_err": max_abs, "rms_force": rms,
                       "repeats_bit_for_bit": forces_repeat,
                       "forces_equal_particle_order": bool(torch.equal(
                           unordered[2], f1)),
                       "rel_err_energy_particle_order": rel(unordered[0],
                                                            e1),
                       "particle_order_ms": statistics.median(
                           turns["nl_forces_particle_order"]),
                       "ms": statistics.median(turns["nl_forces"]),
                       "ms_turns": turns["nl_forces"],
                       "plain_ms": cuda_time_ms(
                           lambda: nl.nl_forces_plain(*f_args), 3, 1),
                       **nl_bound(n, 3, dtype, entries=entries,
                                  inside_pot=inside_pot, pot=pot)}
                ok = (math.isfinite(float(e1))
                      and rec["rel_err_energy"] <= rtol_ew
                      and rec["rel_err_virial"] <= rtol_ew
                      and worst <= tol_f and forces_repeat
                      and rec["forces_equal_particle_order"]
                      and rec["rel_err_energy_particle_order"] <= rtol_ew)
                rec["ok"] = ok
                log(json.dumps(rec))
                results[("nl_forces", f"{case}_{n}", tag)] = rec
                if not ok:
                    failures.append(f"nl_forces {case} {n} {tag}")
                del st, idx, idx0, ordered, small, small0, g_out, g_want
                del f_args, b_args, g_args, small_args, sw, nb, unordered
                torch.cuda.empty_cache()
    return results, failures


# ------------------------------------------------- the sharded slab launch

SLAB_SIZES = (N_BENCH, 262144)
SLAB_COVERS = "mdtpu/parallel/halo_slot.py:322 compute_slots (XLA)"


def slab_bound(ext_inputs, interior, counts_, pot, dtype, hilo=False,
               observables=True):
    """B1's bound for the slab launch: its work on the slab's pairs and its
    inputs read once, the two ghost planes' occupied slots included, with
    the outputs (forces, partials) of the interior cells only."""
    rec = bound(ext_inputs, counts_, pot, dtype, hilo, observables)
    slot_pos, _, counts, _ = ext_inputs
    b = slot_pos.element_size()
    dim = slot_pos.shape[0]
    cap = slot_pos.shape[1] // counts.shape[0]
    ghost_cells = counts.shape[0] - interior[1]
    nbytes = rec["bytes"] - (dim * ghost_cells * cap * b
                             + (2 * ghost_cells * b if observables else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = rec["ops_bound_ms"]
    rec.update(bytes=nbytes, bytes_bound_ms=t_bytes,
               bound_ms=max(t_bytes, t_ops),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    return rec


def slab_phase(mt):
    """B1's slab launch (``HaloSlotEngine`` on a ring of one: the box is one
    slab with a ghost plane on each side) on the bench's jittered lattice at
    65,536 and 262,144 and on the melted fluid at 65,536, f64 and f32 (and
    hi/lo words of the f64 state): against its plain version on the same
    inputs and against the periodic launch on the global slots, f64 1e-12 /
    1e-10, f32 and hi/lo 1e-5; lean forces bit-equal to full; two launches
    bit for bit. Times (graph replay, in turns with the periodic launches
    of the same state), plain versions by events, bounds from this run's
    pairs; and ``compute_slots`` (the exchange and the extended grid's
    assembly with the launch) by events beside the periodic engine's."""
    from mdtpu_torch.ops.cell_sweep import (cell_sweep, cell_sweep_hilo,
                                            cell_sweep_hilo_plain,
                                            cell_sweep_plain)
    from mdtpu_torch.parallel import HaloSlotEngine, ShardRing
    from mdtpu_torch.parallel.halo_slot import build_sharded_slot_state
    from mdtpu_torch.sim.initialization import lattice_fluid_state

    pot = mt.LennardJones(r_cut=2.5)
    ring = ShardRing(device="cuda")
    results, failures = {}, []
    cases = [(f"lattice_{n}", n) for n in SLAB_SIZES] + [("melted", N_BENCH)]
    for case, n in cases:
        state = (melted_state(mt) if case == "melted" else
                 lattice_fluid_state(n, 0.8, 1.0, dtype=torch.float64,
                                     cutoff=2.5, jitter=0.01, device="cuda"))
        halo = HaloSlotEngine.create(pot, 2.5, state.unitcell, n, ring)
        single = halo.as_single_chip()
        sh = build_sharded_slot_state(state.replace(nbrs=None), halo)
        assert not bool(sh.nbrs.overflow)
        for dtype in (torch.float64, torch.float32):
            tag = str(dtype).split(".")[-1]
            f64 = dtype == torch.float64
            hi = sh.positions.to(dtype)
            cell = sh.unitcell.to(dtype).contiguous()
            diam = sh.diameters.to(dtype)
            counts = sh.nbrs.counts
            pos, _, ediam, ecounts, grid, interior = halo.slab_inputs(
                hi, diam, counts, cell)
            slab = (pos, ediam, ecounts, cell, grid, 2.5, pot)
            periodic = (hi, diam, counts, cell, halo.grid, 2.5, pot)
            ext_inputs = (pos, ediam, ecounts, cell)
            counts_ = pair_counts((hi.double(), diam.double(), counts,
                                   cell.double()), halo.grid, 2.5, 2.5)
            calls = {
                "slab": lambda: cell_sweep(*slab, interior=interior),
                "slab_lean": lambda: cell_sweep(*slab, observables=False,
                                                interior=interior),
                "b1": lambda: cell_sweep(*periodic),
                "b1_lean": lambda: cell_sweep(*periodic, observables=False)}
            variants = [("cell_sweep_slab", cell_sweep, cell_sweep_plain,
                         slab, periodic, True, False),
                        ("cell_sweep_slab_lean", cell_sweep, cell_sweep_plain,
                         slab, periodic, False, False)]
            if not f64:
                lo = (sh.positions - hi.double()).float()
                hpos, hlo, hdiam, hcounts, _, _ = halo.slab_inputs(
                    hi, diam, counts, cell, lo)
                h_slab = (hpos, hlo, hdiam, hcounts, cell, grid, 2.5, pot)
                h_periodic = (hi, lo, diam, counts, cell, halo.grid, 2.5,
                              pot)
                calls.update({
                    "slab_hilo": lambda: cell_sweep_hilo(
                        *h_slab, interior=interior),
                    "slab_hilo_lean": lambda: cell_sweep_hilo(
                        *h_slab, observables=False, interior=interior),
                    "b1_hilo": lambda: cell_sweep_hilo(*h_periodic),
                    "b1_hilo_lean": lambda: cell_sweep_hilo(
                        *h_periodic, observables=False)})
                variants += [
                    ("cell_sweep_slab_hilo", cell_sweep_hilo,
                     cell_sweep_hilo_plain, h_slab, h_periodic, True, True),
                    ("cell_sweep_slab_hilo_lean", cell_sweep_hilo,
                     cell_sweep_hilo_plain, h_slab, h_periodic, False, True)]
            turns = kernel_turns(calls)
            full_forces = {}
            for kname, kernel, plain, args, per_args, obs, hilo in variants:
                r1 = kernel(*args, observables=obs, interior=interior)
                torch.cuda.synchronize()
                r0 = plain(*args, observables=obs, interior=interior)
                rp = kernel(*per_args, observables=obs)
                torch.cuda.synchronize()
                worst, max_abs, rms = force_error(r1[2], r0[2], n)
                rtol_ew, tol_f = (1e-12, 1e-10) if f64 else (1e-5, 1e-5)
                key = kname.replace("cell_sweep_", "")
                b1_key = key.replace("slab", "b1")
                rec = {"kernel_check": kname, "case": case, "dtype": tag,
                       "grid": list(halo.grid),
                       "capacity": halo.cell_capacity,
                       "extended_grid": list(grid), "interior": list(interior),
                       "force_err_per_particle": worst,
                       "max_abs_err": max_abs, "rms_force": rms,
                       "force_err_vs_periodic": force_error(r1[2], rp[2],
                                                            n)[0],
                       "ms": statistics.median(turns[key]),
                       "ms_turns": turns[key],
                       "b1_ms_same_turns": statistics.median(turns[b1_key]),
                       "plain_ms": cuda_time_ms(
                           lambda: plain(*args, observables=obs,
                                         interior=interior), 3, 1),
                       "repeats_bit_for_bit": repeats(
                           lambda *a: kernel(*a, observables=obs,
                                             interior=interior), args, r1),
                       "library_ms": None,
                       **slab_bound(ext_inputs, interior, counts_, pot,
                                    torch.float32 if hilo else dtype, hilo,
                                    obs)}
                ok = (rec["force_err_per_particle"] <= tol_f
                      and rec["force_err_vs_periodic"] <= tol_f
                      and rec["repeats_bit_for_bit"])
                if obs:
                    full_forces[hilo] = r1[2]
                    for name, ref in (("plain", r0), ("periodic", rp)):
                        rec[f"rel_err_energy_vs_{name}"] = rel(r1[0], ref[0])
                        rec[f"rel_err_virial_vs_{name}"] = rel(r1[1], ref[1])
                        ok = (ok and rec[f"rel_err_energy_vs_{name}"]
                              <= rtol_ew
                              and rec[f"rel_err_virial_vs_{name}"] <= rtol_ew)
                else:
                    rec["lean_bit_equal_full"] = bool(
                        torch.equal(r1[2], full_forces[hilo]))
                    ok = (ok and rec["lean_bit_equal_full"]
                          and float(r1[0]) == float(r1[1]) == 0.0)
                rec["ok"] = ok
                log(json.dumps(rec))
                results[(kname, case, tag)] = rec
                if not ok:
                    failures.append(f"{kname} {case} {tag}")
            # The whole sharded sweep (exchange, extended grid, launch, sums)
            # against the periodic engine's, by events.
            step_calls = {
                "slab_compute_slots": lambda: halo.compute_slots(
                    hi, diam, cell, None, sh.nbrs),
                "periodic_compute_slots": lambda: single.compute_slots(
                    hi, diam, cell, None, sh.nbrs)}
            for name, fn in step_calls.items():
                results[(name, case, tag)] = {"ms": cuda_time_ms(fn, 20, 3)}
            log(json.dumps({"slab_step": case, "dtype": tag, **{
                k: results[(k, case, tag)]["ms"] for k in step_calls}}))
        del state, sh
        torch.cuda.empty_cache()
    return results, failures


LIST_SLAB_COVERS = ("mdtpu/parallel/halo_slot.py:464,588 make_pair_block in "
                    "the slab sweep (XLA)")


def list_slab_phase(mt):
    """The pair list's slab launch (``HaloSlotEngine`` on a ring of one: the
    box one slab of a ghost-extended grid, the list over its interior
    cells) with the user potential, on config 4's lattice (2D, 65,536,
    128^2 x C 13; f64 and f32) and on the bench's 3D lattice (65,536,
    15^3 x C 37; f32 and hi/lo): the list against its plain version on the
    same inputs (every entry, count and start, bit for bit), two launches
    alike; the sweep on it (the user's potential, the reduction) against
    the plain reduction of the plain list (f64 1e-12 / 1e-10, f32 1e-5) and
    bit for bit against the periodic list route on the global slots. Timed
    by graph replay in turns with the periodic list, the plain list by
    events; the bound from this run's list, the ghost planes' reads
    included, the per-slot outputs of the interior only."""
    from mdtpu_torch.ops import cell_pairs as cp
    from mdtpu_torch.parallel import HaloSlotEngine, ShardRing
    from mdtpu_torch.parallel.halo_slot import build_sharded_slot_state
    from mdtpu_torch.sim.initialization import lattice_fluid_state

    ring = ShardRing(device="cuda")
    pot = user_potential(mt)
    results, failures = {}, []
    lattice_2d, _ = user_lattice(mt)
    cases = [("config4_lattice", lattice_2d, CUTOFF_USER,
              (torch.float64, torch.float32), False),
             ("user_3d_lattice",
              lattice_fluid_state(N_BENCH, 0.8, 1.0, dtype=torch.float64,
                                  cutoff=2.5, jitter=0.01, device="cuda"),
              2.5, (torch.float32,), True)]
    for case, state, cutoff, dtypes, with_hilo in cases:
        halo = HaloSlotEngine.create(pot, cutoff, state.unitcell, N_BENCH,
                                     ring, diameters=state.diameters)
        sh = build_sharded_slot_state(state.replace(nbrs=None), halo)
        assert halo.uses_pair_list and not bool(sh.nbrs.overflow)
        cap = halo.pair_list_capacity
        kinds = [(d, False) for d in dtypes] + ([(torch.float32, True)]
                                                if with_hilo else [])
        for dtype, hilo in kinds:
            tag = "hilo" if hilo else str(dtype).split(".")[-1]
            hi = sh.positions.to(dtype)
            lo = (sh.positions - hi.double()).float() if hilo else None
            cell = sh.unitcell.to(dtype).contiguous()
            diam = sh.diameters.to(dtype)
            pos_e, lo_e, diam_e, counts_e, grid_e, interior = \
                halo.slab_inputs(hi, diam, sh.nbrs.counts, cell, lo)
            slab = (pos_e, diam_e, counts_e, cell, grid_e, cutoff)
            per = (hi, diam, sh.nbrs.counts, cell, halo.grid, cutoff)

            def slab_list():
                return cp.pair_list(*slab, cap, slot_lo=lo_e,
                                    interior=interior)

            l1 = slab_list()
            again = slab_list()
            torch.cuda.synchronize()
            l0 = cp.pair_list_plain(*slab, cap, slot_lo=lo_e,
                                    interior=interior)
            total = int(l0.total)
            fields = ("neighbour", "disp", "r2", "sigma_i", "sigma_j")
            same = (int(l1.total) == total and not bool(l1.overflow)
                    and torch.equal(l1.count, l0.count)
                    and torch.equal(l1.start, l0.start)
                    and all(torch.equal(getattr(l1, k), getattr(l0, k))
                            for k in fields))
            rep = all(torch.equal(getattr(l1, k), getattr(again, k))
                      for k in fields + ("count", "start"))
            s1 = cp.pair_sweep(*slab, pot, cap, True, lo_e,
                               interior=interior)
            sp = cp.pair_sweep(*per, pot, cap, True, lo)
            torch.cuda.synchronize()
            bit_equal = all(torch.equal(a, b) for a, b in zip(s1[:3],
                                                               sp[:3]))
            u0, f0 = pot.evaluate_r2(l0.r2, l0.sigma_i, l0.sigma_j)
            r0 = cp.pair_reduce_plain(l0, f0, u0)
            worst, max_abs, rms = force_error(s1[2], r0[2], N_BENCH)
            f64 = dtype == torch.float64
            rtol_ew, tol_f = (1e-12, 1e-10) if f64 else (1e-5, 1e-5)
            turns = kernel_turns({
                "slab": slab_list,
                "periodic": lambda: cp.pair_list(*per, cap, slot_lo=lo)})
            counts_ = pair_counts((hi.double(), diam.double(),
                                   sh.nbrs.counts, cell.double()), halo.grid,
                                  cutoff, cutoff)
            rec = {"kernel_check": "cell_pairs_slab", "case": case,
                   "dtype": tag, "grid": list(halo.grid),
                   "capacity": halo.cell_capacity, "list_capacity": cap,
                   "extended_grid": list(grid_e), "interior": list(interior),
                   "entries": total, "list_equal_to_plain": same,
                   "repeats_bit_for_bit": rep,
                   "sweep_bit_equal_to_periodic": bit_equal,
                   "rel_err_energy": rel(s1[0], r0[0]),
                   "rel_err_virial": rel(s1[1], r0[1]),
                   "force_err_per_particle": worst,
                   "max_abs_err": 0.0 if same else float("inf"),
                   "sweep_max_abs_err": max_abs, "rms_force": rms,
                   "ms": statistics.median(turns["slab"]),
                   "ms_turns": turns["slab"],
                   "periodic_ms_same_turns": statistics.median(
                       turns["periodic"]),
                   "plain_ms": cuda_time_ms(lambda: cp.pair_list_plain(
                       *slab, cap, slot_lo=lo_e, interior=interior), 3, 1),
                   "library_ms": None,
                   **list_bound(l1, (pos_e, diam_e, counts_e, cell),
                                counts_)["list"]}
            ok = (same and rep and bit_equal and math.isfinite(float(s1[0]))
                  and rec["rel_err_energy"] <= rtol_ew
                  and rec["rel_err_virial"] <= rtol_ew and worst <= tol_f)
            rec["ok"] = ok
            log(json.dumps(rec))
            results[(case, tag)] = rec
            if not ok:
                failures.append(f"cell_pairs_slab {case} {tag}")
            del l0, l1, again, s1, sp, r0
        del sh, halo
        torch.cuda.empty_cache()
    return results, failures


def libzstd_found():
    from mdtpu_torch.io.compress import require_libzstd
    try:
        require_libzstd()
    except RuntimeError:
        return False
    return True


def _traj_text(path):
    """A trajectory's text, decompressed where it is a ``.zst``."""
    if not path.endswith(".zst"):
        with open(path) as f:
            return f.read()
    from mdtpu_torch.io.compress import decompressed_chunks
    with open(path, "rb") as f:
        return b"".join(decompressed_chunks(f)).decode()


def _labels(text):
    lines = text.splitlines()
    return [int(b) for a, b in zip(lines, lines[1:])
            if a.startswith("ITEM: TIMESTEP")]


def writer_turns(state, workdir, compress):
    """One 65,536-atom frame through the trajectory writer's thread, from
    ``write_frame`` to ``close``, plain and (``compress``) zstd, in turns
    (plain, zst, zst, plain); and the formatting alone on this thread, by
    the native formatter and by ``format_lammps_frame``, byte for byte."""
    from mdtpu_torch.io.lammps import format_lammps_frame
    from mdtpu_torch.io.native_writer import format_frame
    from mdtpu_torch.io.writer import TrajectoryWriter
    frame = (0, state.unitcell.cpu().numpy(),
             state.positions.float().cpu().numpy(),
             state.images.cpu().numpy().astype("int32"),
             state.diameters.cpu().numpy())
    t0 = time.perf_counter()
    text = format_lammps_frame(*frame)
    t1 = time.perf_counter()
    native = format_frame(*frame)
    rec = {"format_s": t1 - t0, "native_format_s": time.perf_counter() - t1,
           "native_equal": native == text.encode(),
           "frame_bytes": len(text.encode())}
    kinds = ("plain", "zst", "zst", "plain") if compress else ("plain",) * 2
    for kind in kinds:
        path = os.path.join(workdir, f"frame.{kind}")
        t0 = time.perf_counter()
        w = TrajectoryWriter(path, compress=kind == "zst")
        w.write_frame(*frame)
        w.close()
        rec.setdefault(f"{kind}_s", []).append(time.perf_counter() - t0)
        rec[f"{kind}_file_bytes"] = os.path.getsize(path)
    return rec


def resume_path(mt, workdir):
    """A crash resume at the bench configuration on the slot route (f32):
    run A, 400 NVT steps (thermo every 100, frames every 200, a checkpoint
    every 200, the perf log, zstd where libzstd is found); then resume from
    ``checkpoint.200.npz`` into A's directory as a crash left it. Thermo
    and frame labels equal A's, the rows and frames below the checkpoint's
    step byte for byte, the perf log appended to, the first resumed row's
    E/N within 1e-4 of A's (the slot route sums in slot order: a resume is
    exact physics, not exact bits). Then 200 NVE steps from A's end state
    and from that state saved and loaded, at f32 and f64: positions and
    velocities bit for bit. And one frame through the writer, plain and
    compressed."""
    from mdtpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from mdtpu_torch.sim.initialization import lattice_fluid_state

    compress = libzstd_found()
    start = lattice_fluid_state(N_BENCH, 0.8, 1.0, dtype=torch.float32,
                                cutoff=2.5, jitter=0.01, device="cuda")
    params = mt.Parameters(density=0.8, n_particles=N_BENCH, dt=0.002,
                           potential=mt.LennardJones(r_cut=2.5))
    run_dir = os.path.join(workdir, "resume")
    traj = os.path.join(run_dir, "trajectory.xyz" + (".zst" if compress
                                                     else ""))
    thermo, perf = (os.path.join(run_dir, f)
                    for f in ("thermo.txt", "perf.txt"))
    kw = dict(traj_frequency=RESUME_TRAJ, perf_log=True, compress=compress)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a_end = mt.run_simulation(start, params, mt.NVT(1.0, 0.4), RESUME_STEPS,
                              RESUME_THERMO, run_dir,
                              checkpoint_every=RESUME_AT, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with open(thermo) as f:
        a_thermo = f.read().splitlines()
    a_traj = _traj_text(traj)
    with open(perf) as f:
        a_perf = f.read().splitlines()
    mid = load_checkpoint(os.path.join(run_dir, f"checkpoint.{RESUME_AT}.npz"),
                          start)
    b_end = mt.run_simulation(mid, params, mt.NVT(1.0, 0.4),
                              RESUME_STEPS - mid.step, RESUME_THERMO, run_dir,
                              **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with open(thermo) as f:
        b_thermo = f.read().splitlines()
    b_traj = _traj_text(traj)
    with open(perf) as f:
        b_perf = f.read().splitlines()
    failures = []

    def check(cond, what):
        if not cond:
            failures.append(f"resume: {what}")

    def label(line):
        return int(line.split()[0])

    check(mid.step == RESUME_AT + 1, f"checkpoint step {mid.step}")
    check(b_end.step == RESUME_STEPS, f"final step {b_end.step}")
    check([label(r) for r in b_thermo[1:]] == [label(r) for r in a_thermo[1:]]
          == list(range(0, RESUME_STEPS, RESUME_THERMO)), "thermo labels")
    kept = [r for r in a_thermo if r.startswith("#") or label(r) < mid.step]
    check(b_thermo[:len(kept)] == kept, "rows below the checkpoint changed")
    first = next(r for r in b_thermo[1:] if label(r) >= mid.step)
    a_first = next(r for r in a_thermo[1:] if label(r) == label(first))
    e_diff = abs(float(first.split()[1]) - float(a_first.split()[1]))
    check(e_diff <= 1e-4, f"first resumed row's E/N moved {e_diff}")
    check(_labels(b_traj) == _labels(a_traj)
          == list(range(0, RESUME_STEPS, RESUME_TRAJ)), "frame labels")
    cut = a_traj.find(f"ITEM: TIMESTEP\n{RESUME_AT + RESUME_TRAJ}\n")
    a_kept = a_traj if cut < 0 else a_traj[:cut]
    check(b_traj.startswith(a_kept), "frames below the checkpoint changed")
    check(len(b_perf) > len(a_perf) and b_perf[:len(a_perf)] == a_perf,
          "perf.txt not appended to")
    check(bool(torch.isfinite(b_end.positions).all()), "non-finite state")

    continuation = {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split(".")[-1]
        base = a_end if dtype == torch.float32 else as_dtype(a_end, dtype)
        path = os.path.join(workdir, f"continue_{tag}.npz")
        save_checkpoint(base, path)
        back = load_checkpoint(path, base)
        ends = [mt.run_simulation(s, params, mt.NVE(), CONTINUE_STEPS,
                                  RESUME_THERMO,
                                  os.path.join(workdir, f"cont_{tag}_{i}"))
                for i, s in enumerate((base, back))]
        same = all(torch.equal(getattr(ends[0], k), getattr(ends[1], k))
                   for k in ("positions", "velocities"))
        continuation[tag] = same
        check(same, f"continuation from the checkpoint at {tag} not bit "
              "for bit")
    rec = {"path": "resume", "compress": compress,
           "run_a_s": t1 - t0, "resume_s": t2 - t1,
           "steps_per_s_a": RESUME_STEPS / (t1 - t0),
           "thermo_a": a_thermo[1:], "thermo_resumed": b_thermo[1:],
           "first_resumed_energy_diff": e_diff,
           "perf_rows": len(b_perf) - 1,
           "continuation_bit_for_bit": continuation,
           "writer": writer_turns(a_end, workdir, compress)}
    check(rec["writer"]["native_equal"],
          "native frame differs from format_lammps_frame")
    return rec, failures


def nccl_group(workdir):
    """A one-rank NCCL group over a file store in ``workdir``, its
    communicator formed now (one all-reduce): a failure to form it is the
    run's failure."""
    import torch.distributed as dist
    store = os.path.join(workdir, "nccl_store")
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    probe = torch.ones((), device="cuda")
    dist.all_reduce(probe)
    torch.cuda.synchronize()
    if float(probe) != 1.0:
        raise RuntimeError(f"NCCL all-reduce of one rank gave {probe}")
    return dist


def sharded_path(mt, workdir, b1_nvt_rows):
    """``run_simulation_sharded`` on the one-rank NCCL group (the default
    group): the bench, 600 NVT then 500 NVE steps (hi/lo), thermo every 100
    and frames every 500; its first thermo rows against the B1 path's
    (``run_simulation`` from the same start) within f32's tolerance."""
    from mdtpu_torch.sim.initialization import lattice_fluid_state

    state = lattice_fluid_state(N_BENCH, 0.8, 1.0, dtype=torch.float32,
                                cutoff=2.5, jitter=0.01, device="cuda")
    params = mt.Parameters(density=0.8, n_particles=N_BENCH, dt=0.002,
                           potential=mt.LennardJones(r_cut=2.5))
    nvt_dir, nve_dir = (os.path.join(workdir, "sharded", d)
                        for d in ("nvt", "nve"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mid = mt.run_simulation_sharded(state, params, mt.NVT(1.0, 0.4),
                                    NVT_STEPS, THERMO_EVERY, nvt_dir,
                                    traj_frequency=TRAJ_EVERY)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    end = mt.run_simulation_sharded(mid, params, mt.NVE(), NVE_STEPS,
                                    THERMO_EVERY, nve_dir,
                                    traj_frequency=TRAJ_EVERY)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    failures = []

    def check(cond, what):
        if not cond:
            failures.append(f"sharded: {what}")

    steps = NVT_STEPS + NVE_STEPS
    check(end.step == steps, f"final step {end.step} != {steps}")
    check(bool(torch.isfinite(end.positions).all()), "non-finite state")
    nvt_rows = _rows(os.path.join(nvt_dir, "thermo.txt"))
    nve_rows = _rows(os.path.join(nve_dir, "thermo.txt"))
    check(len(nvt_rows) == NVT_STEPS // THERMO_EVERY, "NVT thermo rows")
    check(len(nve_rows) == NVE_STEPS // THERMO_EVERY, "NVE thermo rows")
    t_nvt = [r[2] for r in nvt_rows[2:]]
    mean_t = sum(t_nvt) / max(len(t_nvt), 1)
    check(abs(mean_t - 1.0) < 0.1, f"NVT mean temperature {mean_t}")
    ke = end.nf / (2.0 * N_BENCH)
    e_tot = [r[1] + ke * r[2] for r in nve_rows]
    drift = max(e_tot) - min(e_tot)
    check(drift < 5e-3, f"NVE total energy per particle moved {drift}")
    # The same start and the same Bussi draws as the B1 path: the rows part
    # only by rounding (the sharded advance rebuilds on the JAX package's
    # schedule), which the fluid's chaos grows.
    first = [[rel(a, b) for a, b in zip(r[1:], q[1:])]
             for r, q in zip(nvt_rows[:2], b1_nvt_rows[:2])]
    check(all(r[0] == q[0] for r, q in zip(nvt_rows[:2], b1_nvt_rows[:2]))
          and max(max(x) for x in first) <= 1e-4,
          f"first rows {nvt_rows[:2]} against the B1 path's "
          f"{b1_nvt_rows[:2]}")
    for path, frames in ((os.path.join(nvt_dir, "trajectory.xyz"),
                          -(-NVT_STEPS // TRAJ_EVERY)),
                         (os.path.join(nve_dir, "trajectory.xyz"),
                          -(-NVE_STEPS // TRAJ_EVERY))):
        with open(path) as f:
            text = f.read()
        check(text.count("ITEM: TIMESTEP") == frames, f"frames in {path}")
        check(text.count("\n") == frames * (9 + N_BENCH), f"rows in {path}")
    return {"path": "sharded", "group": "nccl, 1 rank", "steps": steps,
            "nvt_s": t1 - t0, "nve_s": t2 - t1,
            "steps_per_s": steps / (t2 - t0),
            "particle_steps_per_s": steps * N_BENCH / (t2 - t0),
            "nvt_mean_T": mean_t, "nve_energy_range": drift,
            "first_rows_rel_err_vs_b1": first,
            "thermo_nvt": nvt_rows, "thermo_nve": nve_rows}, failures


def sharded_fire_path(mt):
    """``fire_minimize_sharded`` on the one-rank NCCL group: bench_fire.py's
    system, N_FIRE_DESCENT iterations at tol 0, its energy below the
    start's (from the plain sweep), the caller's velocities returned."""
    from mdtpu_torch.minimize import fire_minimize_sharded
    from mdtpu_torch.ops.cell_sweep import cell_sweep_plain
    from mdtpu_torch.sim.initialization import lattice_fluid_state
    state = lattice_fluid_state(N_BENCH, 0.8, 1.0, dtype=torch.float32,
                                cutoff=2.5, jitter=0.05, device="cuda")
    params = mt.Parameters(density=0.8, n_particles=N_BENCH, dt=0.002,
                           potential=mt.LennardJones(r_cut=2.5))
    engine = mt.select_engine(params.potential, 2.5, state)
    nb = engine.allocate(state.positions, state.diameters, state.unitcell,
                         state.unitcell_inv)
    e0 = float(cell_sweep_plain(
        *engine.slot_inputs(state.positions, state.unitcell,
                            state.unitcell_inv, nb),
        engine.grid, engine.cutoff, engine.potential)[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    end, energy, _, n_steps = fire_minimize_sharded(
        state, params, max_steps=N_FIRE_DESCENT, tol=0.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    failures = []
    energy = float(energy)
    if n_steps != N_FIRE_DESCENT or not energy < e0:
        failures.append(f"sharded fire: {n_steps} iterations, energy "
                        f"{energy} against the start's {e0}")
    if not (torch.equal(end.velocities, state.velocities)
            and bool(torch.isfinite(end.positions).all())):
        failures.append("sharded fire: velocities not restored or "
                        "non-finite state")
    return {"path": "sharded_fire", "iterations": n_steps,
            "seconds": seconds, "iterations_per_s": n_steps / seconds,
            "energy_start": e0, f"energy_after_{N_FIRE_DESCENT}": energy}, \
        failures


def sharded_user_path(mt, workdir, kept):
    """Config 4 at 65,536 on the one-rank NCCL group, through the pair
    list's slab launch: ``fire_minimize_sharded`` from the user path's XYZ
    start (USER_FIRE_ITERS iterations at dmax USER_DMAX, tol 1e-4, timed),
    its energy finite and below the start's (FIRE is chaotic, ROADMAP C7
    and C8, so its end state is not held to the single-device FIRE's); then
    ``run_simulation_sharded`` NVT(0.5, 0.01) for USER_NVT_STEPS steps from
    the single-device path's NVT start (the same velocities and seed,
    timed), its rows at steps 0 and 100 within 1e-8 of that path's (at dt
    1e-4, 100 steps are too short for chaos to grow rounding that far)."""
    from mdtpu_torch.minimize import fire_minimize_sharded
    out_dir = os.path.join(workdir, "user_sharded")
    state, params = user_start(mt, out_dir)
    e0 = kept["energy_start"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    end, energy, converged, n_iter = fire_minimize_sharded(
        state, params, tol=1e-4, max_steps=USER_FIRE_ITERS, dmax=USER_DMAX)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    nvt_dir = os.path.join(out_dir, "nvt")
    final = mt.run_simulation_sharded(
        kept["nvt_start"], kept["params"], mt.NVT(0.5, 0.01), USER_NVT_STEPS,
        THERMO_EVERY, nvt_dir, traj_frequency=USER_NVT_STEPS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    failures = []

    def check(cond, what):
        if not cond:
            failures.append(f"sharded user: {what}")

    energy = float(energy)
    check(math.isfinite(energy) and energy < e0,
          f"FIRE energy {energy} after {n_iter} iterations, start {e0}")
    check(torch.equal(end.velocities, state.velocities)
          and bool(torch.isfinite(end.positions).all()),
          "FIRE: velocities not restored or non-finite state")
    check(final.step == USER_NVT_STEPS
          and bool(torch.isfinite(final.positions).all()), "NVT state")
    rows = _rows(os.path.join(nvt_dir, "thermo.txt"))
    ref = kept["rows"]
    first = [[rel(a, b) for a, b in zip(r[1:], q[1:])]
             for r, q in zip(rows[:2], ref[:2])]
    check(len(rows) == USER_NVT_STEPS // THERMO_EVERY
          and [r[0] for r in rows[:2]] == [q[0] for q in ref[:2]] == [0, 100]
          and max(max(x) for x in first) <= 1e-8,
          f"rows {rows[:2]} against the single-device path's {ref[:2]}")
    return {"path": "sharded_user", "group": "nccl, 1 rank",
            "potential": "NonAdditivePHS (the pair list's slab launch)",
            "energy_start": e0, "energy_minimized": energy,
            "fire_converged": converged, "fire_iterations": n_iter,
            "fire_s": t1 - t0, "iterations_per_s": n_iter / (t1 - t0),
            "nvt_steps": USER_NVT_STEPS, "nvt_s": t2 - t1,
            "steps_per_s": USER_NVT_STEPS / (t2 - t1),
            "rows_rel_err_vs_single_device": first, "thermo": rows}, \
        failures


def _rows(path):
    with open(path) as f:
        return [[float(x) for x in line.split()] for line in f
                if line.strip() and not line.startswith("#")]


def run_paths(mt, workdir):
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.io import native_writer
    from mdtpu_torch.ops import cell_pairs as cp
    from mdtpu_torch.ops import cell_sweep as cs
    from mdtpu_torch.ops import neighbor_list as nl
    from mdtpu_torch.ops import plane_sweep as ps
    from mdtpu_torch.ops import rdf
    from mdtpu_torch.ops.experimental import PlaneEngine

    def counted(fn):
        """Run one path with every count set to 0 just before it; its
        launches (each wrapper's total and lean) and slot steps after."""
        cs.reset_launches()
        cp.reset_launches()
        ps.plane_sweep.launches = 0
        rdf.rdf_histogram.launches = rdf.rdf_histogram.cell_launches = 0
        nl.reset_launches()
        slot_step.make_slot_step.steps = 0
        frames = native_writer.format_frame.calls
        rec, failures = fn()
        rec["launches"] = {
            "cell_sweep": cs.cell_sweep.launches,
            "cell_sweep_lean": cs.cell_sweep.lean_launches,
            "cell_sweep_hilo": cs.cell_sweep_hilo.launches,
            "cell_sweep_hilo_lean": cs.cell_sweep_hilo.lean_launches,
            "cell_sweep_slab": cs.cell_sweep.slab_launches,
            "cell_sweep_slab_lean": cs.cell_sweep.slab_lean_launches,
            "cell_sweep_slab_hilo": cs.cell_sweep_hilo.slab_launches,
            "cell_sweep_slab_hilo_lean": cs.cell_sweep_hilo.slab_lean_launches,
            "plane_sweep": ps.plane_sweep.launches,
            "cell_pairs": cp.pair_list.launches,
            "cell_pairs_slab": cp.pair_list.slab_launches,
            "pair_reduce": cp.pair_reduce.launches,
            "pair_reduce_lean": cp.pair_reduce.lean_launches,
            "rdf_histogram": rdf.rdf_histogram.launches,
            "rdf_histogram_cell": rdf.rdf_histogram.cell_launches,
            "nl_build": nl.nl_build.launches,
            "nl_forces": nl.nl_forces.launches}
        rec["slot_steps"] = slot_step.make_slot_step.steps
        rec["native_frames"] = native_writer.format_frame.calls - frames
        log(json.dumps(rec))
        return rec, failures

    b1, f1 = counted(lambda: md_path(
        mt, workdir, "b1", lambda st, pot: None, True))
    b2, f2 = counted(lambda: md_path(
        mt, workdir, "b2",
        lambda st, pot: PlaneEngine.create(pot, 2.5, 0.3, st.unitcell,
                                           N_BENCH), False))
    bd, f3 = counted(lambda: brownian_path(mt, workdir))
    bds, f4 = counted(lambda: brownian_path(mt, workdir, slots=True))
    fire, f5 = counted(lambda: fire_path(mt))
    pack, f6 = counted(lambda: pack_path(mt, workdir))
    lj = mt.LennardJones(r_cut=2.5)
    b1_2d, f7 = counted(lambda: geo_path(
        mt, workdir, "b1_2d", state_2d(mt, torch.float32),
        mt.Parameters(density=RHO_2D, n_particles=N_BENCH, dt=0.001,
                      potential=mt.PseudoHS()), mt.NVT(1.0, 0.1)))
    b1_tilted, f8 = counted(lambda: geo_path(
        mt, workdir, "b1_tilted", state_tilted(mt, torch.float32),
        mt.Parameters(density=0.8, n_particles=N_BENCH, dt=0.002,
                      potential=lj), mt.NVT(1.0, 0.4)))
    kept = {}
    user, f9 = counted(lambda: user_path(mt, workdir, kept))
    resume, f10 = counted(lambda: resume_path(mt, workdir))
    nlp, f11 = counted(lambda: md_path(
        mt, workdir, "nl",
        lambda st, pot: mt.select_engine(pot, 2.5, st, prefer="neighbor"),
        True))
    failures = f1 + f2 + f3 + f4 + f5 + f6 + f7 + f8 + f9 + f10 + f11
    # The sharded driver and FIRE on a one-rank NCCL group (the default
    # group while they run).
    dist = nccl_group(workdir)
    try:
        sharded, f12 = counted(lambda: sharded_path(mt, workdir,
                                                    b1["thermo_nvt"]))
        sharded_fire, f13 = counted(lambda: sharded_fire_path(mt))
        sharded_user, f14 = counted(lambda: sharded_user_path(mt, workdir,
                                                              kept))
    finally:
        dist.destroy_process_group()
    failures += f12 + f13 + f14
    # The sharded user path takes the pair list's slab launch for every
    # sweep (FIRE's and the NVT leg's), and no sweep kernel.
    n = sharded_user["launches"]
    if (n["cell_pairs"] < sharded_user["fire_iterations"] + USER_NVT_STEPS
            or n["cell_pairs_slab"] != n["cell_pairs"]
            or n["pair_reduce"] != n["cell_pairs"]
            or n["pair_reduce_lean"] < 1
            or n["cell_sweep"] or n["cell_sweep_hilo"]
            or sharded_user["slot_steps"] != USER_NVT_STEPS):
        failures.append(f"sharded user: launches {n}, slot steps "
                        f"{sharded_user['slot_steps']}")
    # Every sweep of the sharded paths is a slab launch: the plain sweep in
    # NVT and FIRE, the hi/lo sweep in NVE, lean inside each segment.
    n = sharded["launches"]
    if (n["cell_sweep_slab"] < NVT_STEPS
            or n["cell_sweep_slab_hilo"] < NVE_STEPS
            or n["cell_sweep_slab_lean"] < NVT_STEPS // 2
            or n["cell_sweep_slab_hilo_lean"] < NVE_STEPS // 2
            or n["cell_sweep"] != n["cell_sweep_slab"]
            or n["cell_sweep_hilo"] != n["cell_sweep_slab_hilo"]
            or sharded["slot_steps"] != NVT_STEPS + NVE_STEPS):
        failures.append(f"sharded: launches {n}, slot steps "
                        f"{sharded['slot_steps']}")
    n = sharded_fire["launches"]
    if (n["cell_sweep_slab_lean"] != N_FIRE_DESCENT
            or n["cell_sweep"] != n["cell_sweep_slab"]):
        failures.append(f"sharded fire: launches {n}")
    for rec in (b1, b2, bd, bds, fire, pack, b1_2d, b1_tilted, user, resume,
                nlp):
        if (rec["launches"]["cell_sweep_slab"]
                or rec["launches"]["cell_sweep_slab_hilo"]
                or rec["launches"]["cell_pairs_slab"]):
            failures.append(f"{rec['path']}: took the slab launch "
                            f"{rec['launches']}")
    # The list path: every step through K2, its rebuilds through K1 (one
    # build at each leg's start besides), and no sweep kernel.
    n = nlp["launches"]
    nlp["rebuilds"] = n["nl_build"] - 3
    log(json.dumps({"path": "nl", "rebuilds": nlp["rebuilds"]}))
    if (n["nl_forces"] < NVT_STEPS + 2 * NVE_STEPS or n["nl_build"] < 4
            or n["cell_sweep"] or n["cell_sweep_hilo"] or n["plane_sweep"]
            or n["cell_pairs"] or nlp["slot_steps"]):
        failures.append(f"nl: launches {n}, slot steps {nlp['slot_steps']}")
    for rec in (b1, b2, bd, bds, fire, pack, b1_2d, b1_tilted, user, resume):
        if rec["launches"]["nl_build"] or rec["launches"]["nl_forces"]:
            failures.append(f"{rec['path']}: took the neighbour list "
                            f"{rec['launches']}")
    # Every frame and snapshot goes through the native formatter: the
    # Brownian path's log-time snapshots and its frame at step 0.
    if bd["native_frames"] != len(bd["snapshots"]) + 1:
        failures.append(f"brownian: {bd['native_frames']} native frames for "
                        f"{len(bd['snapshots'])} snapshots and one frame")
    # The bench paths' observables launch the RDF kernel twice each: the
    # half width on the tile route, r_max 3 on the cell route.
    for rec in (b1, b2, nlp):
        if (rec["launches"]["rdf_histogram"] != 2
                or rec["launches"]["rdf_histogram_cell"] != 1):
            failures.append(f"{rec['path']}: rdf_histogram launches "
                            f"{rec['launches']}")
    n = resume["launches"]
    if (n["cell_sweep"] < RESUME_STEPS or n["cell_sweep_hilo"]
            < 2 * CONTINUE_STEPS or resume["slot_steps"]
            != 2 * RESUME_STEPS - RESUME_AT - 1 + 4 * CONTINUE_STEPS):
        failures.append(f"resume: launches {n}, slot steps "
                        f"{resume['slot_steps']}")
    geo_steps = GEO_NVT_STEPS + GEO_NVE_STEPS
    for rec in (b1_2d, b1_tilted):
        n = rec["launches"]
        if (n["cell_sweep"] < 1 or n["cell_sweep_lean"] < 1
                or n["cell_sweep_hilo"] < 1 or n["cell_sweep_hilo_lean"] < 1
                or rec["slot_steps"] != geo_steps):
            failures.append(f"{rec['path']}: launches {n}, slot steps "
                            f"{rec['slot_steps']}")
    # Built-in potentials never take the pair list; the user potential
    # never takes the sweep kernels.
    for rec in (b1, b2, bd, bds, fire, pack, b1_2d, b1_tilted):
        if rec["launches"]["cell_pairs"] or rec["launches"]["pair_reduce"]:
            failures.append(f"{rec['path']}: took the pair list "
                            f"{rec['launches']}")
    n = user["launches"]
    if (n["cell_pairs"] < user["fire_iterations"] + USER_NVT_STEPS
            or n["pair_reduce"] != n["cell_pairs"]
            or n["pair_reduce_lean"] < 1
            or n["cell_sweep"] or n["cell_sweep_hilo"]):
        failures.append(f"user: launches {n}")
    # NVT takes the plain sweep; each f32 NVE leg the hi/lo sweep (its
    # initial forces, as the JAX package's, the plain one). In the slot
    # layout every step but the last of a segment takes the lean variant.
    steps = NVT_STEPS + 2 * NVE_STEPS
    if b1["launches"]["cell_sweep"] < NVT_STEPS:
        failures.append(f"b1: cell_sweep launches {b1['launches']}")
    if b1["launches"]["cell_sweep_hilo"] < 2 * NVE_STEPS:
        failures.append(f"b1: cell_sweep_hilo launches {b1['launches']}")
    if min(b1["launches"]["cell_sweep_lean"],
           b1["launches"]["cell_sweep_hilo_lean"]) < NVE_STEPS:
        failures.append(f"b1: lean launches {b1['launches']}")
    if b1["slot_steps"] != steps:
        failures.append(f"b1: {b1['slot_steps']} slot steps, not {steps}")
    if b2["launches"]["plane_sweep"] < steps:
        failures.append(f"b2: plane_sweep launches {b2['launches']}")
    if b2["slot_steps"] or bd["slot_steps"]:
        failures.append("b2/brownian: PlaneEngine took the slot step")
    if bd["launches"]["plane_sweep"] < BROWNIAN_STEPS:
        failures.append(f"brownian: plane_sweep launches {bd['launches']}")
    if (bds["launches"]["cell_sweep"] < BROWNIAN_STEPS
            or bds["slot_steps"] != BROWNIAN_STEPS):
        failures.append(f"brownian_slot: launches {bds['launches']}, "
                        f"slot steps {bds['slot_steps']}")
    if fire["launches"]["cell_sweep_lean"] != N_FIRE_ITERS + N_FIRE_DESCENT:
        failures.append(f"fire: launches {fire['launches']}")
    if pack["launches"]["cell_sweep_lean"] < 1:
        failures.append(f"pack: launches {pack['launches']}")
    return {"b1": b1, "b2": b2, "brownian": bd, "brownian_slot": bds,
            "fire": fire, "pack": pack, "b1_2d": b1_2d,
            "b1_tilted": b1_tilted, "user": user,
            "resume": resume, "nl": nlp, "sharded": sharded,
            "sharded_fire": sharded_fire, "sharded_user": sharded_user}, \
        failures


def ptxas_summary(name, report):
    """The compiler's report: for the sweeps one line per kernel entry
    (dimension, type, potential, hi/lo, full or lean, the block size it is
    compiled for, registers, spill bytes); for the probe and the pair list
    their report lines. Returns ``{(type, potential functor, block size[,
    "hilo"][, "lean"][, "2d"]): (registers, spill store bytes)}`` of the
    sweep kernels."""
    entry, spill, table = None, "", {}
    for line in report.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"(?:cell|plane)_sweep_kernelI([fd])(?:Li([23])E)?"
                          r"N5mdtpu\d+([A-Za-z]+)I[fd]EE((?:Lb[01]E)*)"
                          r"Li(\d+)EE", line)
            flags = m and re.findall(r"Lb([01])E", m[4])
            entry = m and ("f32" if m[1] == "f" else "f64", m[3],
                           "hilo" if flags[:1] == ["1"] else "plain",
                           "lean" if flags[1:2] == ["0"] else "full", m[5],
                           "2d" if m[2] == "2" else "3d")
            if entry is None:
                log(f"  ptxas {name}: " + line.strip())
        elif "spill" in line and entry:
            spill = line.strip()
        elif "registers" in line and entry:
            regs = int(re.search(r"Used (\d+) registers", line)[1])
            stores = int(re.search(r"(\d+) bytes spill stores", spill)[1])
            key = ((entry[0], entry[1], int(entry[4]))
                   + (("hilo",) if entry[2] == "hilo" else ())
                   + (("lean",) if entry[3] == "lean" else ())
                   + (("2d",) if entry[5] == "2d" else ()))
            table[key] = (regs, stores)
            log(f"  ptxas {name}: {entry[5]} {' '.join(entry[:4])} for "
                f"blocks up to {entry[4]}: {regs} registers; {spill}")
        elif any(k in line for k in ("registers", "spill", "smem")):
            log(f"  ptxas {name}: " + line.strip())
    return table


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import mdtpu_torch as mt
    from mdtpu_torch.ops import _cuda_build

    log(nvidia_smi_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    _cuda_build.build_all(SOURCES)
    log(f"built {', '.join(_cuda_build.source(s).name for s in SOURCES)} "
        f"in {time.perf_counter() - t:.1f} s")
    registers = {name: ptxas_summary(name, _cuda_build.build_report(name))
                 for name in SOURCES}

    t = time.perf_counter()
    results, failures = kernel_phase(mt, registers["plane_sweep"])
    probes, probe_launches, probe_path, probe_failures = probe_phase()
    failures += probe_failures
    rdf_results, rdf_failures = rdf_phase(mt)
    failures += rdf_failures
    nl_results, nl_failures = list_phase(mt)
    failures += nl_failures
    slab_results, slab_failures = slab_phase(mt)
    failures += slab_failures
    list_slab_results, list_slab_failures = list_slab_phase(mt)
    failures += list_slab_failures
    log(f"kernel and probe phases: {time.perf_counter() - t:.1f} s")
    with tempfile.TemporaryDirectory() as workdir:
        paths, path_failures = run_paths(mt, workdir)
    failures += path_failures

    def entry(name, source, replaces, launches, rec, extra=None):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None,
                **(extra or {})}

    by_path = {p: paths[p]["launches"] for p in paths}
    # The probe's entry: its full variant at the default chunk, with the
    # largest error over every variant's check.
    probe_rec = dict(probes["full"], max_abs_err=max(
        r["max_abs_err"] for r in probes.values()))
    b1 = by_path["b1"]
    pallas_cell = "mdtpu/ops/experimental/pallas_cell.py:77"
    overlap = results[("cell_sweep_overlap", "pack_start", "float32")]
    overlap_lean = results[("cell_sweep_lean", "pack_start_lean", "float32")]
    kernels = {"kernels": [
        entry("cell_sweep", "mdtpu_torch/csrc/cell_sweep.cu", pallas_cell,
              b1["cell_sweep"] - b1["cell_sweep_lean"],
              results[("cell_sweep", "lj_bench", "float32")],
              {"launches_brownian_slot": by_path["brownian_slot"][
                  "cell_sweep"],
               "launches_fire": by_path["fire"]["cell_sweep"]
               - by_path["fire"]["cell_sweep_lean"]}),
        entry("cell_sweep_hilo", "mdtpu_torch/csrc/cell_sweep.cu",
              pallas_cell,
              b1["cell_sweep_hilo"] - b1["cell_sweep_hilo_lean"],
              results[("cell_sweep_hilo", "lj_bench", "float32")]),
        entry("cell_sweep_lean", "mdtpu_torch/csrc/cell_sweep.cu",
              pallas_cell, b1["cell_sweep_lean"],
              results[("cell_sweep_lean", "lj_bench", "float32")],
              {"launches_fire": by_path["fire"]["cell_sweep_lean"]}),
        entry("cell_sweep_hilo_lean", "mdtpu_torch/csrc/cell_sweep.cu",
              pallas_cell, b1["cell_sweep_hilo_lean"],
              results[("cell_sweep_hilo_lean", "lj_bench", "float32")]),
        entry("cell_sweep_overlap", "mdtpu_torch/csrc/cell_sweep.cu",
              pallas_cell, by_path["pack"]["cell_sweep"]
              - by_path["pack"]["cell_sweep_lean"], overlap,
              {"potential": "OverlapPotential (Overlap functor)",
               "launches_lean": by_path["pack"]["cell_sweep_lean"],
               "lean_ms": overlap_lean["ms"],
               "lean_plain_ms": overlap_lean["plain_ms"],
               "lean_bound_ms": overlap_lean["bound_ms"],
               "lean_bound_by": overlap_lean["bound_by"]}),
        entry("plane_sweep", "mdtpu_torch/csrc/plane_sweep.cu",
              "mdtpu/ops/experimental/pallas_plane.py:70",
              paths["b2"]["launches"]["plane_sweep"],
              results[("plane_sweep", "lj_bench", "float32")],
              {"launches_brownian": by_path["brownian"]["plane_sweep"]}),
        entry("plane_probe", "mdtpu_torch/csrc/plane_probe.cu",
              "probe_kernel.py:29", probe_launches, probe_rec,
              {"variant": "full:45"}),
    ]}
    # The 2D and tilted variants of B1 (template dimension; the cell matrix)
    # cover the XLA sweep's 2D and triclinic cases (mdtpu/ops/cell_grid.py
    # :556, :736-739), which reach no pl.pallas_call; each entry's launches
    # are its path's. The tilted 2D box runs the 2D kernels: its check's
    # numbers ride on the 2D entries.
    for path, case, label in (("b1_2d", "bench_2d", "2d"),
                              ("b1_tilted", "bench_tilted", "tilted")):
        n = by_path[path]
        for kname, launches in (
                ("cell_sweep", n["cell_sweep"] - n["cell_sweep_lean"]),
                ("cell_sweep_lean", n["cell_sweep_lean"]),
                ("cell_sweep_hilo",
                 n["cell_sweep_hilo"] - n["cell_sweep_hilo_lean"]),
                ("cell_sweep_hilo_lean", n["cell_sweep_hilo_lean"])):
            extra = {"covers": "mdtpu/ops/cell_grid.py:556 _ywindow_sweep"
                     if label == "2d" else
                     "mdtpu/ops/cell_grid.py:736-739 (triclinic shifts)"}
            if label == "2d":
                t = results[(kname, "bench_2d_tilted", "float32")]
                extra.update(tilted_ms=t["ms"], tilted_plain_ms=t["plain_ms"],
                             tilted_bound_ms=t["bound_ms"],
                             tilted_max_abs_err=t["max_abs_err"])
            kernels["kernels"].append(entry(
                f"{kname}_{label}", "mdtpu_torch/csrc/cell_sweep.cu",
                pallas_cell, launches, results[(kname, case, "float32")],
                extra))
    user = by_path["user"]
    pairs_rec = results[("cell_pairs", "config4_lattice", "float64")]
    reduce_rec = results[("pair_reduce", "config4_lattice", "float64")]
    kernels["kernels"] += [
        entry("cell_pairs", "mdtpu_torch/csrc/cell_pairs.cu", pallas_cell,
              user["cell_pairs"], pairs_rec,
              {"potential": "NonAdditivePHS (a user potential, float64)"}),
        {**entry("pair_reduce", "mdtpu_torch/csrc/cell_pairs.cu",
                 pallas_cell, user["pair_reduce"], reduce_rec,
                 {"launches_lean": user["pair_reduce_lean"],
                  "lean_ms": reduce_rec["lean_ms"],
                  "lean_bound_ms": reduce_rec["lean_bound_ms"],
                  "lean_bound_by": reduce_rec["lean_bound_by"],
                  "kernels_a_call": reduce_rec["kernels_a_call"],
                  "library_call": reduce_rec["library_call"]}),
         "library_ms": reduce_rec["library_ms"]},
    ]
    # The RDF histogram is XLA in the JAX package (no pl.pallas_call). Its
    # two routes are two kernels of one source: the tile route's entry is
    # the bench fluid at f32 and sample_rdf's half width, the cell route's
    # at validate.py's r_max 3, the calls the bench paths make, each with
    # its route's other cases beside it.
    b1_rdf = by_path["b1"]
    for kname, rname, launches in (
            ("rdf_histogram", "half_width",
             b1_rdf["rdf_histogram"] - b1_rdf["rdf_histogram_cell"]),
            ("rdf_histogram_cell", "r_max_3",
             b1_rdf["rdf_histogram_cell"])):
        route = "cell" if kname.endswith("cell") else "tile"
        main_rec = rdf_results[("bench_melted", "float32", rname)]
        extra = {"covers": "mdtpu/observables.py:21 rdf_histogram (XLA)",
                 "kernel": f"rdf_{route}_kernel",
                 "all_pairs_ms": main_rec["all_pairs_ms"],
                 "call_ms": main_rec["call_ms"],
                 "launches_b2": by_path["b2"]["rdf_histogram"]
                 - by_path["b2"]["rdf_histogram_cell"] if route == "tile"
                 else by_path["b2"]["rdf_histogram_cell"]}
        for (case, tag, rn), r in rdf_results.items():
            if r["route"] == route and r is not main_rec:
                extra[f"{case}_{tag}_{rn}"] = {k: r[k] for k in (
                    "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                    "all_pairs_ms", "max_abs_err", "pattern")}
        kernels["kernels"].append(entry(
            kname, "mdtpu_torch/csrc/rdf_histogram.cu",
            "mdtpu/observables.py:21", launches, main_rec, extra))
    # The neighbour list is XLA in the JAX package (no pl.pallas_call); each
    # entry is the bench lattice at f32 with B1's times from the same turns,
    # the other cases beside it, and its launches on the list path.
    for kname, line in (("nl_build", "mdtpu/ops/neighbor_list.py:172"),
                        ("nl_forces", "mdtpu/ops/neighbor_list.py:224")):
        main_rec = nl_results[(kname, f"lattice_{N_BENCH}", "float32")]
        extra = {"covers": f"{line} (XLA)",
                 "b1_ms_same_turns": main_rec["b1_ms"],
                 "b1_lean_ms_same_turns": main_rec["b1_lean_ms"],
                 "rebuilds_on_path": paths["nl"]["rebuilds"]}
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                "b1_ms", "b1_lean_ms")
        if kname == "nl_build":
            own = ("allocate_ms", "stage_cells", "grown_capacity",
                   "grown_stage_cells", "grown_ms")
        else:
            own = ("lanes", "particle_order_ms")
        extra.update({key: main_rec[key] for key in own})
        for (k, case, tag), r in nl_results.items():
            if k == kname and (case, tag) != (f"lattice_{N_BENCH}",
                                              "float32"):
                extra[f"{case}_{tag}"] = {key: r[key] for key in
                                          keys + own}
        kernels["kernels"].append(entry(
            kname, "mdtpu_torch/csrc/neighbor_list.cu", line,
            by_path["nl"][kname], main_rec, extra))
    # B1's slab launch (the sharded engine's sweep; JAX's is XLA, no
    # pl.pallas_call): the bench lattice at f32, its launches on the sharded
    # path, the other cases beside it.
    def slab_launches(n):
        # Each variant's own launches: the full ones less the lean.
        return {"cell_sweep_slab": n["cell_sweep_slab"]
                - n["cell_sweep_slab_lean"],
                "cell_sweep_slab_lean": n["cell_sweep_slab_lean"],
                "cell_sweep_slab_hilo": n["cell_sweep_slab_hilo"]
                - n["cell_sweep_slab_hilo_lean"],
                "cell_sweep_slab_hilo_lean": n["cell_sweep_slab_hilo_lean"]}

    sh_fire = slab_launches(by_path["sharded_fire"])
    for kname, launches in slab_launches(by_path["sharded"]).items():
        main_rec = slab_results[(kname, f"lattice_{N_BENCH}", "float32")]
        extra = {"covers": SLAB_COVERS,
                 "b1_ms_same_turns": main_rec["b1_ms_same_turns"],
                 "launches_sharded_fire": sh_fire[kname]}
        for (k, case, tag), r in slab_results.items():
            if k == kname and (case, tag) != (f"lattice_{N_BENCH}",
                                              "float32"):
                extra[f"{case}_{tag}"] = {key: r[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                    "b1_ms_same_turns")}
        kernels["kernels"].append(entry(
            kname, "mdtpu_torch/csrc/cell_sweep.cu", pallas_cell, launches,
            main_rec, extra))
    # The pair list's slab launch (the sharded engine's sweep for a
    # potential without a functor; JAX's is XLA, no pl.pallas_call): config
    # 4 at f64, its launches on the sharded user path, the other cases
    # beside it.
    main_rec = list_slab_results[("config4_lattice", "float64")]
    extra = {"covers": LIST_SLAB_COVERS,
             "potential": "NonAdditivePHS (a user potential, float64)",
             "periodic_ms_same_turns": main_rec["periodic_ms_same_turns"],
             "launches_sharded_fire_and_nvt": by_path["sharded_user"][
                 "cell_pairs_slab"]}
    for (case, tag), r in list_slab_results.items():
        if (case, tag) != ("config4_lattice", "float64"):
            extra[f"{case}_{tag}"] = {key: r[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                "periodic_ms_same_turns")}
    kernels["kernels"].append(entry(
        "cell_pairs_slab", "mdtpu_torch/csrc/cell_pairs.cu", pallas_cell,
        by_path["sharded_user"]["cell_pairs_slab"], main_rec, extra))
    log(json.dumps({"compute_slots_ms": {
        f"{k}_{case}_{tag}": r["ms"] for (k, case, tag), r in
        slab_results.items() if k.endswith("compute_slots")}}))
    for k in kernels["kernels"]:
        if k["launches"] <= 0:
            failures.append(f"{k['name']} never launched on its path")
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
