#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mdtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, the torch and CUDA versions, and
   builds the nine CUDA sources of ``mdtpu_torch/csrc`` and its host C++
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
   included). Draws phase: the slot advance's kernels of
   ``csrc/philox_draws.cu`` against their plain versions at the bench's
   shapes: Philox-4x32-10's three known answers and 65,536 random counters
   word for word; ``bussi_draw`` at the bench's nf - 1 (f64 r1 and r2 to
   rel 1e-12, the card's libm not being the CPU's; f32 to one rounding of
   that; bit for bit its plain version run on the card; timed, f32 and
   f64),
   ``uniform_noise`` on the bench's and the Brownian path's slots
   (f32 and f64, two ranks) bit for bit, ``rebuild_flag`` on the same two
   shapes (rows 1 and 2 start off 16-byte alignment) with every slot below
   skin/2 and with one slot one ulp of the threshold short of it or past
   it (f32, f64); ``velocity_finish`` given the kinetic energy bit for bit
   the torch composition on the card (its draws from ``bussi_draw``) at
   f32 and f64, NVT at a fixed target and on a ramp's device table, and
   NVE, at five steps and four energies; summing the bench's slot
   velocities itself bit for bit its plain version (the kernel's sum
   order) and within rel 2e-13 (f64) / 2e-6 (f32) of the composition on
   ``torch.sum``; two launches of each bit for bit; each timed by a CUDA
   graph of 100 calls back to back (replayed 20 times, divided by the
   calls), beside the launch floor (an empty kernel timed the same way),
   its plain version, one PyTorch call, the composition the tail replaced,
   and its bound. The velocity finish (NVT summing with the device table's
   and a host target, given K with each, NVE) and the noise (both shapes,
   f32 and f64) are timed both ways, as programmatic dependents (how they
   launch) and in plain stream order, in turns, and so is the floor (with
   the attribute the empty kernel waits for the one before). Verlet
   phase: the slot step's Verlet chain (``csrc/verlet_update.cu``:
   kick-drift, with and without the hi/lo low word, kick, rescale) at the
   bench's slots against the torch composition on the card bit for bit
   (f32 and f64, compensated and not, in place and into new tensors, the
   step counter advanced), each timed by a graph of 100 in-place calls
   beside the composition timed the same way, the launch floor and its
   bound (the bytes it moves). Brownian update phase: the Brownian slot
   step's update (``csrc/verlet_update.cu`` ``brownian_update_kernel``,
   the noise drawn inside) at the Brownian slot path's slots (3, 263,424)
   and the bench's (3, 124,875), f32 and f64, compensated and not,
   against the torch composition on the card fed by the ``uniform_noise``
   kernel bit for bit (into new tensors and in place, the step counter,
   the virial's sample, the temperature), each timed by a graph of 100
   in-place calls beside the composition timed the same way, the launch
   floor and its bound (the bytes it moves). Particle phase: the
   particle-order step's kernels at 65,536 (``verlet_update.cu``
   ``kick_drift_wrap_kernel`` and ``brownian_rows_kernel``,
   ``philox_draws.cu`` ``rebuild_rows_kernel``) against their plain
   versions on the card bit for bit, two launches alike: kick-drift-wrap
   on the bench's lattice (f32, f64, compensated and not, the hi/lo low
   word, into new tensors and in place), in the tilted box and the 2D
   start; the Brownian move on the Brownian start (f32, f64, a device
   counter and a host step); the drift test by the cell (cubic, tilted)
   and by the box lengths (the cell's diagonal, a view) on displacements
   of 0.98-1.02 skin/2, a row at a time and all at once; the drift test
   and the Brownian move also at the edges of their grid
   (``philox_draws.rows_edge_counts``, d 2 and 3, f32 and f64, aligned
   and misaligned rows, the only hit at the first, the last and the last
   Philox period's first row); each timed by a graph of 100 in-place calls
   beside its plain version timed the same way, the launch floor and its
   bound; the drift test and the Brownian move also split into phases by
   a stamped copy of their sources (``probe_torch_rows.py``), with their
   earlier design's times on their log lines only.
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
     slab launch, NVE on hi/lo; captured, each segment one graph launch a
     step variant), its first thermo rows against the B1 path's within
     1e-4; then ``fire_minimize_sharded`` (one graph launch) on
     ``bench_fire.py``'s system, 20 iterations, below the start's energy;
     then BASELINE config 4 at 65,536 (the user potential, every sweep the
     pair list's slab launch): ``fire_minimize_sharded`` from the user
     path's XYZ start, 1000 iterations at dmax 0.01, finite and below the
     start's energy, and ``run_simulation_sharded`` NVT(0.5, 0.01) for 300
     steps from the user path's minimized state and velocities, its rows
     at steps 0 and 100 within 1e-8 of that path's.
   * reference: checks that catch an error common to a kernel and its
     plain version, on wrapped positions at 65,536 and f64: the virial
     pressure against -dU/dV (a central difference in the box scale, eps
     1e-5, rel 1e-6) and |sum F| / (N rms |F|) < 1e-10 through B1 (the
     melted bench fluid, force-shifted LJ), B1 in the tilted box, B1 in 2D
     (the 2D path's melted start), B2, K2 and the pair list (config 4's
     potential on its lattice); the RDF's counts at r_max 3 (cell and tile
     routes) sum to twice the pairs inside r_max counted by the plain
     sweep;
   * examples (on the one-rank NCCL group): each of ``examples_torch/01``
     -``05``'s ``main`` as a user runs it (published N and step counts;
     the naive engine for 01-04, the slab launch for 05), then at 65,536
     through the same ``main`` (01, 02, 04 on B1 in slots, 03 on the pair
     list, 05 the slab launch) with the cuts of ``EXAMPLE_CUTS`` and FIRE
     capped at 1000 iterations (03 at dmax 0.01), all printed; each run's
     files, trajectory frames and thermo rows (all finite) as the schedule
     gives them, each NVT leg's second-half mean T within 5% of its target
     (a ramp's at the rows' steps), 01's NVE energy range printed, each
     leg's steps/s, engine and launches.
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
   Each MD step of the B1 path finishes through ``velocity_finish`` (the
   NVT steps draw there; ``bussi_draw`` is not launched) and tests
   ``rebuild_flag`` once; each Brownian step in slots runs its update,
   the noise drawn inside, as one ``brownian_update`` launch (no
   ``uniform_noise``, which no step launches since the particle-order
   Brownian step draws inside its move too; its record rides on
   ``brownian_rows``' entry); each MD slot step runs its Verlet chain through
   ``verlet_update``: kick-drift and kick once a step, the rescale once an
   NVT step (none on the Brownian path in slots). Each particle-order step
   (the B2, list and Brownian paths) runs captured, one graph launch a
   step (``ParticleAdvance.graph_steps``): an MD step ``kick_drift_wrap``,
   ``rebuild_flag_rows``, the kick and NVT's rescale; a Brownian step
   ``rebuild_flag_rows`` and ``brownian_rows`` (no ``uniform_noise``); so
   do the examples' steps at their published sizes (the naive engine, no
   drift test). On the card the slot route runs captured: each step
   one CUDA-graph launch, the drift test setting the handle of the
   conditional node that holds the rebuild; the counts a capture recorded
   are added at every replay.
5. Graph phase: the bench (600 NVT + 500 NVE on hi/lo), Brownian in slots
   (200 steps) and the 2D path (600 NVT + 200 NVE) through
   ``run_simulation``, each from one start on the eager slot route
   (``make_slot_advance(..., graph=False)``, the flag read on the host once
   a step) and on the captured one: positions, velocities, forces, images,
   every thermo row and the rebuild steps equal bit for bit, steps/s of
   both; then one NVT and one NVE (hi/lo) segment of the bench's slot
   advance on each route, in turns (eager, captured, captured, eager),
   through ``profile_torch_step.measure``: host ms, the host's time to
   issue a step, device busy ms and the idle share (on a captured route,
   whose kernels run inside a WHILE node that the profiler does not see,
   null: there the device's span by CUDA events), kernel and graph
   launches, and host reads a step (none inside a captured segment, or the
   run fails), and each captured step's nodes read from its graph: one
   node for the drift test, one for the velocity finish, one conditional
   node, one for each of the Verlet chain's launches (3 NVT, 2 NVE) and no
   memset, the lean step at most 8 nodes (NVT) or 7 (NVE) and no copy,
   the full last step the lean step's nodes and no copy (B1 sums its
   energy and virial into the buffers in its last block), or the run
   fails. Every captured step of the three paths enters its velocity
   finish (MD) or its update (Brownian, which draws the noise) by one
   programmatic edge, its graph's only one, and a captured Brownian step
   holds at most 5 nodes (the drift test, the IF node, B1, the update),
   no copy and no memset, or the run fails.
   Particle-order phase: ``PlaneEngine`` (300 NVT steps uncompensated,
   then 200 NVE on the hi/lo sweep), the list (300 NVT, 200 NVE), Brownian
   on ``PlaneEngine`` (200 steps) and the cell grid with
   ``compensated=False`` (300 NVT), each through ``run_simulation`` from
   one start on the eager particle advance (``graph=False``) and the
   captured one: positions, velocities, images, forces, energy, virial,
   every thermo row and the rebuild steps bit for bit, steps/s of both;
   each captured step's nodes (one drift test, one IF node, one
   kick-drift-wrap or Brownian move, no noise kernel); then one segment of
   each route and ensemble profiled on each advance (host ms, busy ms,
   idle share, launches, graph launches and host reads a step: none in a
   captured segment, or the run fails). Each captured segment is one
   graph launch a step variant (a WHILE node loops the
   step while the step counter is below the segment's end, ``step_below``
   setting its handle; the rebuild's IF node nested in its body): the
   captured routes above are held to the eager ones, the segment
   profiles to one graph launch a variant (two in slots: the lean steps
   and the full last step; one in particle order) and no host read.
   FIRE phase: FIRE's kernels (``fire_reduce`` and ``fire_test`` in one
   pass and in the shard ring's split, ``fire_move``;
   ``csrc/fire_update.cu``) against their plain versions at f32 and f64,
   in slots (3, 124,875) and in particle rows (65,536, 3), to rel 1e-12 /
   2e-6 (the move bit for bit, also launched as a programmatic dependent
   of a reduction), flags and counters equal, each twice bit for bit; the
   two
   reductions also at the edges of their grid (1, 3, one block's count
   and its neighbours, an odd count, one wave's count and past it) on
   aligned views, views whose data_ptr is not 16-byte aligned and views
   of v and F misaligned apart; each timed at f32 and f64 by a graph of
   ``MANY_CALLS`` calls (logged beside the earlier design's times; the
   move also after ``fire_reduce`` and over copies of its arrays that
   the L2 cannot hold, ``hbm_ms``),
   the launch floor, the bound and ``torch.linalg.vector_norm`` of F (a
   yardstick over the same bytes), and split into phases by a stamped
   copy of the source (``probe_torch_fire.py``); ``step_below`` against
   its plain version. FIRE graph phase: FIRE captured (one graph launch a
   minimization) against FIRE eager from one start at 65,536:
   ``bench_fire.py``'s system in slots (20, then 200 iterations at tol 0,
   one capture), the packer's start (converging at tol 1e-10),
   ``PlaneEngine`` and the list in particle order (200 iterations):
   positions, FIRE's velocities, forces, energy, virial, n_steps,
   converged and the rebuild steps bit for bit; a census of each captured
   minimization printed (graph launches and host reads by the profiler:
   one launch, one read at the end; the WHILE body's nodes, one IF node
   in it; the rebuilds), or the run fails. FIRE's kernels must carry the
   FIRE, packing, sharded FIRE and user paths' updates (one launch each
   an iteration; the sharded FIRE's reduction and test split three ways).
   Sharded graph phase, on a one-rank NCCL group of its own: the bench
   (600 NVT + 500 NVE) through ``run_simulation_sharded`` from one start
   on the eager sharded advance (``graph=False``) and the captured one
   (the default on the card: each segment one graph launch a step
   variant, the ring's all-reduces captured inside): positions,
   velocities, images, forces, every thermo row and the rebuild steps bit
   for bit; each captured step's nodes (the lean step: the drift test,
   ``rebuild_vote`` and one IF node; the full last step's rebuild inline);
   one NVT segment of each route profiled in turns (two graph launches a
   captured segment, no host read inside); the sharded FIRE (200
   iterations on ``bench_fire.py``'s system) eager against captured, bit
   for bit with equal rebuild steps, and its census (one graph launch,
   one read of the result), or the run fails. ``rebuild_vote`` against
   its plain version in the FIRE phase, beside ``step_below``. User
   graph phase: BASELINE config 4 at 65,536 (f64, the pair list) on the
   captured route (the default on the card for any potential: the user's
   ``evaluate_r2`` recorded in the WHILE node's body) against
   ``graph=False``: the user path's NVT (300 steps in 3 segments through
   ``run_simulation``) from its minimized state, positions, velocities,
   images, forces, energy, virial, every thermo row and the rebuild steps
   bit for bit; an NVT and an NVE segment of the slot advance profiled in
   turns (two graph launches a captured segment, no host read inside, the
   two routes' end states bit for bit), each captured variant's nodes
   and the capture's seconds; the slot FIRE (200 iterations at tol 0 from
   the XYZ start) eager against captured, a second captured call a
   replay of the first's graph, bit for bit, and its census; then on a
   one-rank NCCL group of its own the same NVT through
   ``run_simulation_sharded`` and the sharded FIRE; steps/s and
   iterations/s both ways and the peak memory after each part, or the
   run fails. The examples phase runs example 03's user potential
   captured too (at its published 1200 on the naive engine, timed).
6. Prints the ``kernels`` JSON line, then as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a card, when the package is
missing, or when any build, launch or check fails.
"""

import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_BENCH = 65536
BENCH_GEOMETRY = ((15, 15, 15), 37)   # CellGridEngine.create at skin 0.3
NVT_STEPS, NVE_STEPS = 600, 500
THERMO_EVERY, TRAJ_EVERY = 100, 500
BROWNIAN_STEPS, BROWNIAN_THERMO_EVERY = 200, 100
SOURCES = ("cell_sweep", "plane_sweep", "plane_probe", "cell_pairs",
           "rdf_histogram", "neighbor_list", "philox_draws", "verlet_update",
           "fire_update", "lammps_format")
PROBE_PATH = ("full_static", "full_static:15", "full:5")  # probe_kernel.py
PROBE_SPECS = ("full", "full_static", "nodiv", "reduce_only", "full:5",
               "full_static:15", "nodiv:5", "reduce_only:15")

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, no sparsity): HBM3
# 3.35 TB/s; 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor
# cores.
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
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
# Iterations of the sharded FIRE held captured against eager.
N_FIRE_GRAPH = 200
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

def load_example(name):
    """``examples_torch/{name}.py`` of this checkout, loaded by path."""
    import importlib.util
    key = f"examples_torch_{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(
        key, os.path.join(REPO, "examples_torch", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def user_potential(mt):
    """The user potential of BASELINE config 4, ``examples_torch/
    03_polydisperse_2d.py``'s, as a user writes one: pseudo-HS-style
    repulsion with non-additive cross diameters sigma_ij = 0.5 (s_i + s_j)
    (1 - 0.2 |s_i - s_j|), energy- and force-shifted at 1.25 sigma_ij. No
    kernel has a functor for it: the cell grid takes the pair-list route."""
    return load_example("03_polydisperse_2d").NonAdditivePHS()


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
    lean reduction's forces the full one's bits and the plain version's
    in list order (on the CPU), two launches bit for bit.
    Timed by graph replay; the reduction (small beside a replay's host
    cost) by a graph of ``MANY_CALLS`` calls, as ``index_add_`` beside it
    (one PyTorch call computing the forces' segmented sum, as its
    yardstick)."""
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
        # The plain version on the CPU adds in list order, as each thread
        # of the kernel does: the forces' bits.
        cpu = cp.PairList(**{fl.name: getattr(l1, fl.name).cpu()
                             for fl in dataclasses.fields(cp.PairList)})
        in_order = cp.pair_reduce_plain(cpu, f.cpu(), u.cpu())[2]
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
               "forces_bit_equal_to_plain_in_list_order": torch.equal(
                   r1[2].cpu(), in_order),
               "repeats_bit_for_bit": repeats(
                   lambda *a: cp.pair_reduce(l1, f, u), (), r1),
               "ms": many_ms(lambda: cp.pair_reduce(l1, f, u)),
               "lean_ms": many_ms(lambda: cp.pair_reduce(l1, f)),
               "replay_ms": cuda_time_ms(g_red.replay, 20, 3),
               "lean_replay_ms": cuda_time_ms(g_lean.replay, 20, 3),
               "staged": cp.staged_reduce(cap, l1.count.shape[0]),
               "plain_ms": cuda_time_ms(lambda: cp.pair_reduce_plain(
                   l1, f, u), 3, 1),
               "library_ms": many_ms(lambda: force_lib.index_add_(
                   1, own, fd)),
               "library_call": "Tensor.index_add_ (forces only)",
               "kernels_a_call": len(reduce_kernels),
               "lean_bound_ms": lean_bound["reduce"]["bound_ms"],
               "lean_bound_by": lean_bound["reduce"]["bound_by"],
               **bounds["reduce"]}
        ok = (math.isfinite(float(r1[0])) and rec["rel_err_energy"] <= rtol_ew
              and rec["rel_err_virial"] <= rtol_ew and worst <= tol_f
              and rec["lean_forces_bit_equal"] and rec["repeats_bit_for_bit"]
              and rec["forces_bit_equal_to_plain_in_list_order"]
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


def nccl_group(workdir, name="nccl_store"):
    """A one-rank NCCL group over a file store ``name`` in ``workdir``, its
    communicator formed now (one all-reduce): a failure to form it is the
    run's failure."""
    import torch.distributed as dist
    store = os.path.join(workdir, name)
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


# ------------------------------------------------------------ the examples

# The port's examples (examples_torch/), each ``main`` run twice: as a user
# runs it (its published N and step counts; select_engine gives the naive
# engine for 01-04 at these N, as in the JAX package, and 05 the slab launch
# on the one-rank NCCL group), then at N_BENCH through the same ``main``, so
# 01, 02 and 04 take the cell grid (B1, in slots), 03 the pair list and 05
# the slab launch, with the step counts cut as EXAMPLE_CUTS says. FIRE at
# N_BENCH stops after EXAMPLE_FIRE_CAP iterations, and 03's takes dmax 0.01
# (ROADMAP C8: at the example's 0.1 FIRE climbs on this start).
EXAMPLE_NAMES = ("01_pseudohs_nvt_nve", "02_brownian", "03_polydisperse_2d",
                 "04_quench_fire", "05_sharded_multichip")
EXAMPLE_CUTS = {"01_pseudohs_nvt_nve": {"nvt_steps": 2000,
                                        "nve_steps": 2000},
                "02_brownian": {"steps": 2000},
                "03_polydisperse_2d": {"steps": 3000},
                "04_quench_fire": {},
                "05_sharded_multichip": {"steps": 1000}}
EXAMPLE_FIRE_CAP = 1000
EXAMPLE_DMAX = {"03_polydisperse_2d": USER_DMAX}
# An NVT leg's second-half mean temperature against the mean of its
# targets (a ramp's too, at the rows' steps).
EXAMPLE_T_TOL = 0.05


def _frames(path):
    """Frames of a LAMMPS trajectory, zstd-compressed or not."""
    if path.endswith(".zst"):
        from mdtpu_torch.io.compress import decompress_zstd
        path = decompress_zstd(path)
    with open(path) as f:
        return f.read().count("ITEM: TIMESTEP")


def _engine_of(mt, call, state, params):
    """The engine a leg takes, as its entry point picks it."""
    if call == "run_simulation_sharded":
        name = "HaloSlotEngine"
        from mdtpu_torch.ops.cell_sweep import kernel_params
        uses_list = kernel_params(params.potential) is None
    else:
        eng = mt.select_engine(params.potential, state.cutoff, state,
                               workload="minimize" if call == "minimize"
                               else "dynamics")
        name = type(eng).__name__
        uses_list = getattr(eng, "uses_pair_list", False)
    return name + (" (pair list)" if uses_list else "")


def _timed_entry_points(mt, mod, legs, fire_kw):
    """Replace the example's entry points by wrappers that time each call
    (synchronised), record its engine and kernel launches into ``legs``
    and, for ``minimize``, add ``fire_kw``. Returns the originals."""
    import inspect
    originals = {}
    for attr in ("run_simulation", "minimize", "run_simulation_sharded"):
        if not hasattr(mod, attr):
            continue
        fn = originals[attr] = getattr(mod, attr)

        def run(*args, _fn=fn, _attr=attr, **kwargs):
            if _attr == "minimize":
                kwargs.update(fire_kw)
            a = inspect.signature(_fn).bind(*args, **kwargs).arguments
            leg = {"call": _attr, "engine": _engine_of(mt, _attr, a["state"],
                                                        a["params"])}
            before = launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            leg["s"] = time.perf_counter() - t
            after = launch_counts()
            leg["launches"] = {k: after[k] - before[k] for k in after
                               if after[k] != before[k]}
            if _attr == "minimize":
                leg.update(fire_kw, iterations=int(out[3]),
                           converged=bool(out[2]),
                           energy_per_particle=float(out[1])
                           / a["state"].n_particles,
                           iterations_per_s=int(out[3]) / leg["s"])
            else:
                first = a["state"].step
                leg.update(ensemble=a["ensemble"], steps=a["total_steps"],
                           pathname=a["pathname"],
                           compress=a.get("compress", False),
                           rows=len(range(first + (-first) % a["frequency"],
                                          first + a["total_steps"],
                                          a["frequency"])),
                           steps_per_s=a["total_steps"] / leg["s"])
            legs.append(leg)
            return out

        setattr(mod, attr, run)
    return originals


def _example_files(name, out):
    """The files a run must leave besides each leg's thermo and trajectory
    (held by the legs' checks), as its JAX twin's test asserts and the
    example writes."""
    names = {"01_pseudohs_nvt_nve": ("final.xyz", "../{}_nve/final.xyz"),
             "02_brownian": ("final.xyz", "snapshot.0",
                             "new-log-times.txt"),
             "03_polydisperse_2d": ("start.xyz", "minimized.xyz",
                                    "final.xyz"),
             "04_quench_fire": ("minimized.xyz", "final.xyz"),
             "05_sharded_multichip": ("final.xyz",)}[name]
    return [os.path.normpath(os.path.join(
        out, f.format(os.path.basename(out)))) for f in names]


def example_run(mt, name, size, workdir):
    """One example's ``main`` at ``size`` ("published" or "large"),
    checked: the files and frame counts, every thermo row finite, each NVT
    leg's second-half mean T within EXAMPLE_T_TOL of its targets; 01's NVE
    energy range printed. Returns ``(record, failures)``."""
    import inspect
    mod = load_example(name)
    defaults = {k: v.default for k, v in
                inspect.signature(mod.main).parameters.items()}
    kw = {k: defaults[k] for k in defaults if k not in ("out", "device")}
    fire_kw = {}
    if size == "large":
        kw.update(EXAMPLE_CUTS[name], n_particles=N_BENCH)
        fire_kw = {"max_steps": EXAMPLE_FIRE_CAP}
        if name in EXAMPLE_DMAX:
            fire_kw["dmax"] = EXAMPLE_DMAX[name]
    out = os.path.join(workdir, "examples", f"{name}_{size}")
    legs, failures = [], []
    originals = _timed_entry_points(mt, mod, legs, fire_kw)
    t = time.perf_counter()
    try:
        mod.main(out=out, **kw)
    except Exception as exc:  # a failed example fails the run
        failures.append(f"{name} {size}: {type(exc).__name__}: {exc}")
    finally:
        for attr, fn in originals.items():
            setattr(mod, attr, fn)
    seconds = time.perf_counter() - t

    def check(cond, what):
        if not cond:
            failures.append(f"{name} {size}: {what}")

    if not failures:
        for path in _example_files(name, out):
            check(os.path.isfile(path), f"no {path}")
    for leg in legs:
        ens = leg.pop("ensemble", None)
        if ens is None:
            continue
        leg["ensemble"] = type(ens).__name__
        path = leg.pop("pathname")
        traj = os.path.join(path, "trajectory.xyz"
                            + (".zst" if leg.pop("compress") else ""))
        frames = _frames(traj) if os.path.isfile(traj) else None
        check(frames == leg["rows"], f"{traj}: {frames} frames, not "
              f"{leg['rows']}")
        path = os.path.join(path, "thermo.txt")
        rows = _rows(path) if os.path.isfile(path) else []
        check(len(rows) == leg["rows"] and all(
            math.isfinite(v) for r in rows for v in r),
            f"{path}: {len(rows)} rows, not {leg['rows']} finite rows")
        if not rows:
            continue
        if isinstance(ens, mt.NVT):
            half = rows[len(rows) // 2:]
            mean_t = sum(r[2] for r in half) / len(half)
            target = sum(float(ens.ktemp(int(r[0]) + 1)) for r in half) \
                / len(half)
            leg.update(second_half_mean_t=mean_t, target_t=target)
            check(abs(mean_t / target - 1.0) < EXAMPLE_T_TOL,
                  f"NVT second-half mean T {mean_t} against {target}")
        elif isinstance(ens, mt.NVE):
            n = kw["n_particles"]
            total = [r[1] + 1.5 * r[2] * (n - 1) / n for r in rows]
            leg.update(nve_energy_per_particle_range=max(total) - min(total),
                       nve_energy_per_particle=[min(total), max(total)])
    launches = {}
    for leg in legs:
        for k, v in leg["launches"].items():
            launches[k] = launches.get(k, 0) + v
    rec = {"example": name, "size": size, "n_particles": kw["n_particles"],
           "cuts": EXAMPLE_CUTS[name] if size == "large" else {},
           "fire": fire_kw, "s": seconds, "legs": legs,
           "launches": launches}
    log(json.dumps({"example_run": rec}))
    return rec, failures


# The kernel each example's run at N_BENCH must launch (at the published N
# only 05 launches one, the slab sweep).
EXAMPLE_KERNELS = {"01_pseudohs_nvt_nve": ("cell_sweep", "cell_sweep_hilo"),
                   "02_brownian": ("cell_sweep",),
                   "03_polydisperse_2d": ("cell_pairs", "pair_reduce"),
                   "04_quench_fire": ("cell_sweep",),
                   "05_sharded_multichip": ("cell_sweep_slab",)}


# The kernels of the particle-order step and of FIRE besides the draws'
# (the naive engine's steps and minimizations at the examples' published
# sizes launch these; a captured segment's loop test too).
PARTICLE_CHAIN = ("verlet_kick", "verlet_rescale", "kick_drift_wrap",
                  "brownian_rows", "rebuild_flag_rows", "step_below",
                  "fire_reduce", "fire_move", "fire_test")


def examples_phase(mt, workdir):
    """Every example at both sizes (see EXAMPLE_NAMES), on the one-rank
    NCCL group formed by the caller (example 05's default group). A failed
    example, file or check is a failure; so is a run at N_BENCH that did
    not launch its kernels, or one at the published N of 01-04 that
    launched a pair kernel or took another engine than the naive one."""
    from mdtpu_torch.integrate.step import ParticleAdvance
    runs, failures = [], []
    t = time.perf_counter()
    for size in ("published", "large"):
        for name in EXAMPLE_NAMES:
            before = (ParticleAdvance.steps, ParticleAdvance.graph_steps)
            rec, fails = example_run(mt, name, size, workdir)
            runs.append(rec)
            failures += fails
            # Particle-order steps (01-04 at their published sizes, on the
            # naive engine, 03's user potential too) run captured, one
            # graph launch a segment.
            steps = ParticleAdvance.steps - before[0]
            graph = ParticleAdvance.graph_steps - before[1]
            rec["particle_steps"], rec["particle_graph_steps"] = steps, graph
            want = steps
            if graph != want or (size == "published"
                                 and not name.startswith("05") and not steps):
                failures.append(f"{name} {size}: {graph} of {steps} "
                                f"particle-order steps captured, not {want}")
            n = rec["launches"]
            if size == "large" or name.startswith("05"):
                missing = [k for k in EXAMPLE_KERNELS[name]
                           if n.get(k, 0) <= 0]
                if missing:
                    failures.append(f"{name} {size}: no {missing} launch "
                                    f"({n})")
            else:
                # The naive engine launches no pair kernel; its steps run
                # the particle-order chain and draw through the draws'
                # kernels.
                engines = {leg["engine"] for leg in rec["legs"]}
                pair = {k: v for k, v in n.items() if k not in DRAWS_REPLACE
                        and k not in PARTICLE_CHAIN}
                if pair or engines != {"NaivePairEngine"}:
                    failures.append(f"{name} {size}: engines {engines}, "
                                    f"launches {n}")
    # Example 03 as published (N = 1200, the naive engine, captured): its
    # legs' seconds and rates.
    ex03 = [{k: leg.get(k) for k in ("call", "engine", "s", "iterations",
                                     "iterations_per_s", "steps",
                                     "steps_per_s")}
            for r in runs if r["example"] == "03_polydisperse_2d"
            and r["size"] == "published" for leg in r["legs"]]
    log(json.dumps({"example_03_published_captured": ex03}))
    return {"path": "examples", "s": time.perf_counter() - t,
            "example_03_published": ex03,
            "runs": [{k: r[k] for k in ("example", "size", "s",
                                         "particle_steps",
                                         "particle_graph_steps")}
                     for r in runs]}, failures


# ------------------------------------------------------ the reference checks

REF_EPS = 1e-5


def wrapped(state):
    """The state with its positions folded into the box (the engines'
    contract: a cell engine takes positions inside the box)."""
    cell = state.unitcell
    frac = state.positions @ state.unitcell_inv.T
    return state.replace(positions=(frac - torch.floor(frac)) @ cell.T)


def _energy_virial_forces(engine, state, scale):
    """The engine's energy, virial and forces on ``state`` with positions
    and cell scaled by ``scale`` (fractional coordinates fixed)."""
    from mdtpu_torch.sim.initialization import build_state_from_arrays
    s = build_state_from_arrays(state.positions * scale, state.diameters,
                                state.unitcell.cpu().numpy() * scale,
                                dtype=torch.float64, cutoff=engine.cutoff,
                                device="cuda")
    args = (s.positions, s.diameters, s.unitcell, s.unitcell_inv)
    e, w, f, nb = engine.compute(*args, engine.allocate(*args))
    if bool(getattr(nb, "overflow", False)):
        return None
    return float(e), float(w), f


def _scaled_evaluations(engine, state):
    """:func:`_energy_virial_forces` at the scales 1 and 1 +- REF_EPS with
    one engine, grown until none of the three overflows. Returns the
    engine and the three results."""
    for _ in range(8):
        got = [_energy_virial_forces(engine, state, x)
               for x in (1.0, 1.0 + REF_EPS, 1.0 - REF_EPS)]
        if all(g is not None for g in got):
            return engine, got
        engine = engine.with_grown_capacity()
    raise RuntimeError(f"{type(engine).__name__} still overflowing")


def reference_phase(mt):
    """Checks that catch an error common to a kernel and its plain version,
    at 65,536 and f64 on wrapped positions: the virial pressure W/(d V)
    against -dU/dV by a central difference in the box scale (eps REF_EPS,
    rel 1e-6) and |sum F| / (N rms |F|) < 1e-10, through B1 (the melted
    bench fluid, force-shifted LJ), B1 in the tilted box, B1 in 2D (the 2D
    path's melted start), B2 (``PlaneEngine``), K2 (the neighbour list) and
    the pair list (config 4's potential on its lattice); and the RDF's
    normalisation: its counts (cell route and tile route, r_max 3) sum to
    twice the pairs inside r_max counted by the plain sweep, within twice
    the pairs whose r^2 lies within 1e-12 of r_max^2."""
    from mdtpu_torch.ops import rdf
    from mdtpu_torch.ops.cell_grid import CellGridEngine
    from mdtpu_torch.ops.cell_sweep import cell_sweep_plain
    from mdtpu_torch.ops.experimental import PlaneEngine

    melted = wrapped(melted_state(mt))
    lj = mt.LennardJones(r_cut=2.5, force_shift=True)
    user_state, user_params = user_lattice(mt)

    def cell_grid(pot, cutoff):
        return lambda s: CellGridEngine.create(
            pot, cutoff, 0.3, s.unitcell, s.n_particles,
            diameters=s.diameters)

    cases = (
        ("b1", melted, cell_grid(lj, 2.5), "cell_sweep"),
        ("b1_tilted", wrapped(state_tilted(mt, torch.float64)),
         cell_grid(lj, 2.5), "cell_sweep"),
        ("b1_2d", wrapped(melted_2d(mt)),
         cell_grid(mt.PseudoHS(), CUTOFF_2D), "cell_sweep"),
        ("b2", melted, lambda s: PlaneEngine.create(
            lj, 2.5, 0.3, s.unitcell, s.n_particles), "plane_sweep"),
        ("k2", melted, lambda s: mt.select_engine(lj, 2.5, s,
                                                  prefer="neighbor"),
         "nl_forces"),
        ("pair_list", wrapped(user_state),
         cell_grid(user_params.potential, CUTOFF_USER), "cell_pairs"))
    results, failures = {}, []
    t = time.perf_counter()
    for name, state, make, kernel in cases:
        before = launch_counts()[kernel]
        engine, ((e, w, f), (up, _, _), (down, _, _)) = _scaled_evaluations(
            make(state), state)
        launches = launch_counts()[kernel] - before
        d = state.dimension
        vol = abs(float(torch.linalg.det(state.unitcell.cpu())))
        p_virial = w / (d * vol)
        p_deriv = -(up - down) / (vol * ((1 + REF_EPS) ** d
                                         - (1 - REF_EPS) ** d))
        f = f.reshape(state.n_particles, d)
        rms = float(torch.sqrt((f * f).sum(dim=1).mean()))
        momentum = (float(f.sum(dim=0).norm()) / (state.n_particles * rms)
                    if rms > 0 else math.inf)
        rec = {"engine": type(engine).__name__, "kernel": kernel,
               "launches": launches, "energy_per_particle":
               e / state.n_particles, "p_virial": p_virial,
               "p_dudv": p_deriv, "rel_err": rel(p_virial, p_deriv),
               "net_force_over_n_rms": momentum}
        results[name] = rec
        log(json.dumps({"reference": name, **rec}))
        if not (abs(p_virial - p_deriv) <= 1e-6 * abs(p_deriv) + 1e-9):
            failures.append(f"reference {name}: virial {p_virial} against "
                            f"-dU/dV {p_deriv}")
        if not momentum < 1e-10:
            failures.append(f"reference {name}: |sum F| / (N rms) "
                            f"{momentum}")
        if launches <= 0:
            failures.append(f"reference {name}: {kernel} not launched")
    # The RDF's normalisation on the melted fluid at r_max 3.
    engine = CellGridEngine.create(lj, RDF_R_MAX, 0.0, melted.unitcell,
                                   melted.n_particles)
    while True:
        nb = engine.allocate(melted.positions, melted.diameters,
                             melted.unitcell, melted.unitcell_inv)
        if not bool(nb.overflow):
            break
        engine = engine.with_grown_capacity()
    inputs = engine.slot_inputs(melted.positions, melted.unitcell,
                                melted.unitcell_inv, nb)

    def pairs_within(r):
        return round(float(cell_sweep_plain(*inputs, engine.grid, RDF_R_MAX,
                                            PairCounter(r))[0]))

    inside = pairs_within(RDF_R_MAX)
    edge = (pairs_within(RDF_R_MAX * (1 + 1e-12))
            - pairs_within(RDF_R_MAX * (1 - 1e-12)))
    args = (melted.positions, melted.unitcell, melted.unitcell_inv)
    for route in ("cell", "tile"):
        plan = rdf.rdf_plan(*args, RDF_R_MAX, RDF_BINS, route=route)
        total = int(rdf.rdf_launch(plan, melted.positions).sum())
        rec = {"route": plan.route, "counts_sum": total,
               "pairs_inside_plain": inside, "pairs_at_edge": edge}
        results[f"rdf_{route}"] = rec
        log(json.dumps({"reference": f"rdf_{route}", **rec}))
        if abs(total - 2 * inside) > 2 * edge:
            failures.append(f"reference rdf {route}: counts sum {total}, "
                            f"twice the pairs inside {2 * inside}")
    return {"path": "reference", "s": time.perf_counter() - t,
            "cases": results}, failures


# The graph phase: the slot advance on the device. Random123's known
# answers for Philox-4x32-10: (counter, key, words).
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
DRAWS_SOURCE = "mdtpu_torch/csrc/philox_draws.cu"
DRAWS_REPLACE = {
    "velocity_finish": "mdtpu/integrate/thermostat.py:52",
    "uniform_noise": "mdtpu/integrate/step.py:110",
    "rebuild_flag": "mdtpu/integrate/slot_step.py:460",
}
DRAWS_COVER = {
    "velocity_finish": "mdtpu/integrate/thermostat.py:52-67 "
                       "bussi_scale_from_kinetic with :31 compute_kinetic "
                       "and :37-40 compute_temperature (one XLA fusion; "
                       "its draws :43-50 sum_noises, :59-61, XLA "
                       "jax.random.normal, jax.random.gamma)",
    "uniform_noise": "mdtpu/integrate/step.py:110-119 brownian_noise (XLA "
                     "jax.random.uniform)",
    "rebuild_flag": "mdtpu/integrate/slot_step.py:460 slot_needs_rebin "
                    "(XLA)",
}
# Integer operations of one Philox-4x32-10 block: ten rounds of two 32x32
# products (hi and lo words: 4), four xors and two key adds.
OPS_PHILOX_BLOCK = 100
# Floating-point operations of one Box-Muller normal (the uniforms' scaling,
# the log, the square root, the cosine; each transcendental counted 20) and
# of one Marsaglia-Tsang test beyond it.
OPS_BOX_MULLER = 70
OPS_GAMMA_TEST = 35
# The many-call timing of the small kernels: a CUDA graph of this many calls
# back to back, so one replay's host cost is spread over them.
MANY_CALLS = 100
# The velocity finish's checks: NVT at a fixed target and on a ramp (a
# device table read at the step), NVE; kinetic energies around the bench's
# (3 N T / 2 at T 1); steps; the bench's nf, dt and tau.
FINISH_STEPS = (0, 1, 599, 123456, 2 ** 33 + 5)
FINISH_KINETIC = (98302.5, 97000.25, 101234.125, 0.5)
# The in-kernel sum against torch.sum: float64 to rel 1e-13, float32 to
# 1e-6 (the kernel adds the exact squares in float64; torch.sum adds
# float32 in float32); scale and temperature inherit it.
FINISH_SUM_RTOL = {torch.float64: 1e-13, torch.float32: 1e-6}


def _slot_shape(mt, state, cutoff):
    """``(d, n_slots)`` of ``state`` on ``select_engine``'s cell grid."""
    eng = mt.select_engine(mt.PseudoHS() if cutoff < 2 else
                           mt.LennardJones(r_cut=cutoff), cutoff, state)
    return (state.dimension, eng.n_cells * eng.cell_capacity)


def many_ms(fn, calls=MANY_CALLS, replays=20, rounds=5):
    """Device ms of one call of ``fn``: a CUDA graph of ``calls`` calls
    back to back (after one call outside it), replayed ``replays`` times
    between two CUDA events and divided by calls x replays; the median of
    ``rounds``. A graph of one call would time the host's replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return statistics.median(cuda_time_ms(graph.replay, replays, 2) / calls
                             for _ in range(rounds))


def launch_floor_ms(programmatic=False):
    """The card's launch floor: :func:`many_ms` of a kernel that does
    nothing (``philox_draws.empty``); ``programmatic``: each launched as a
    programmatic dependent of the one before, which it waits for."""
    from mdtpu_torch.ops import philox_draws as draws
    return many_ms(lambda: draws.empty("cuda", programmatic))


def launch_ways_ms(fn):
    """:func:`many_ms` of ``fn`` with the velocity finish and the noise
    launched as programmatic dependents (the package's way) and in plain
    stream order (inside ``philox_draws.plain_launch``), in turns
    (programmatic, plain, plain, programmatic): the mean of each way."""
    from mdtpu_torch.ops import philox_draws as draws
    times = {True: [], False: []}
    for way in (True, False, False, True):
        with contextlib.nullcontext() if way else draws.plain_launch():
            times[way].append(many_ms(fn))
    return statistics.mean(times[True]), statistics.mean(times[False])


def floor_ways_ms():
    """The launch floor both ways, in turns as :func:`launch_ways_ms`:
    ``(programmatic, plain)``."""
    times = {True: [], False: []}
    for way in (True, False, False, True):
        times[way].append(launch_floor_ms(way))
    return statistics.mean(times[True]), statistics.mean(times[False])


def _finish_target(kind, dtype):
    """NVT's target as the step gives it to ``velocity_finish``: a host
    number (``fixed``), a ramp's device table read at the step (``ramp``:
    base 0 for small steps), or None (``nve``)."""
    from mdtpu_torch.integrate import velocity_finish as vf
    if kind == "fixed":
        return lambda step: 1.0
    if kind == "nve":
        return lambda step: None
    table = torch.linspace(1.4, 0.9, 600, dtype=torch.float64).to(
        dtype).cuda()

    def ramp(step):
        base = min(step, 599)
        return vf.TargetTable(table, torch.tensor(step - base, device="cuda"))
    return ramp


def finish_check(mt, failures):
    """``velocity_finish`` on the card: given the kinetic energy, bit for
    bit the torch composition on the card (``velocity_finish_plain``, its
    draws from ``bussi_draw``) at f32 and f64, NVT at a fixed target and on
    a ramp, and NVE; summing the bench's slot velocities itself, bit for
    bit the plain version with the kernel's sum order (``kinetic_plain``)
    and within ``FINISH_SUM_RTOL`` of the composition on ``torch.sum``; two
    launches bit for bit. Timed by :func:`many_ms` (the summing NVT variant
    on the ramp, the step's call; the other variants beside it), the
    composition it replaced by events and in a graph of many calls, and
    bounds from this run's inputs."""
    from mdtpu_torch.integrate import thermostat
    from mdtpu_torch.integrate import velocity_finish as vf
    from mdtpu_torch.ops import philox_draws as draws

    nf = 3.0 * (N_BENCH - 1)
    dt, tau, seed = 0.002, 0.4, 7
    errs, sum_errs, order_errs = [], [], []
    for dtype in (torch.float32, torch.float64):
        for kind in ("fixed", "ramp", "nve"):
            target = _finish_target(kind, dtype)
            for s in FINISH_STEPS:
                step = torch.tensor(s, device="cuda")
                for k in FINISH_KINETIC:
                    kin = torch.tensor(k, dtype=dtype, device="cuda")
                    got = torch.stack(vf.velocity_finish(
                        None, kin, seed, step, nf, dt, tau, target(s)))
                    again = torch.stack(vf.velocity_finish(
                        None, kin, seed, s, nf, dt, tau, target(s)))
                    want = torch.stack(vf.velocity_finish_plain(
                        None, kin, seed, step, nf, dt, tau, target(s)))
                    errs.append(float((got - want).abs().max()))
                    if not (torch.equal(got, want) and torch.equal(got,
                                                                   again)):
                        failures.append(
                            f"velocity_finish {dtype} {kind} step {s} K {k}:"
                            f" {got.tolist()} vs {want.tolist()}")
    # Summing the bench's slot velocities (f32: the B1 path's call).
    shape = (3, 15 ** 3 * 37)
    g = torch.Generator(device="cuda").manual_seed(5)
    v64 = torch.randn(shape, device="cuda", dtype=torch.float64,
                      generator=g)
    v64[:, ::7] = 0.0   # vacant slots
    for dtype in (torch.float32, torch.float64):
        v = v64.to(dtype)
        for kind in ("ramp", "nve"):
            target = _finish_target(kind, dtype)(599)
            step = torch.tensor(599, device="cuda")
            got = torch.stack(vf.velocity_finish(v, None, seed, step, nf, dt,
                                                 tau, target))
            again = torch.stack(vf.velocity_finish(v, None, seed, step, nf,
                                                   dt, tau, target))
            want = torch.stack(vf.velocity_finish_plain(
                v, None, seed, step, nf, dt, tau, target))
            summed = torch.stack(vf.velocity_finish_plain(
                None, thermostat.compute_kinetic(v), seed, step, nf, dt, tau,
                target))
            err = float(((got - summed) / summed).abs().max())
            sum_errs.append(err)
            order_errs.append(float((got - want).abs().max()))
            if not (torch.equal(got, want) and torch.equal(got, again)
                    and err <= 2 * FINISH_SUM_RTOL[dtype]):
                failures.append(f"velocity_finish summing {dtype} {kind}: "
                                f"{got.tolist()} vs {want.tolist()} (kernel "
                                f"order), {summed.tolist()} (torch.sum)")

    v = v64.float()
    step = torch.tensor(599, device="cuda")
    ramp = _finish_target("ramp", torch.float32)(599)
    kin = thermostat.compute_kinetic(v)
    n = v.numel()
    b_bytes = (4 * n + 8) / HBM_BYTES_PER_S * 1e3
    b_ops = 2 * n / PEAK_OPS[torch.float64] * 1e3
    floor_pdl, floor = floor_ways_ms()
    # Each variant launched both ways, in turns: NVT summing with the
    # target from the device table (the step's call) and from the host,
    # given K (the sharded route's) with each target, NVE summing.
    ways = {}
    for label, kv, target in (
            ("", (v, None), ramp), ("host_target_", (v, None), 1.0),
            ("given_kinetic_", (None, kin), ramp),
            ("given_kinetic_host_target_", (None, kin), 1.0),
            ("nve_", (v, None), None)):
        pdl, plain = launch_ways_ms(
            lambda kv=kv, target=target: vf.velocity_finish(
                *kv, seed, step, nf, dt, tau, target))
        ways[f"{label}ms"], ways[f"{label}plain_launch_ms"] = pdl, plain
    rec = {
        "max_abs_err": max(errs),
        "summing_max_abs_err_vs_plain": max(order_errs),
        "summing_rel_err_vs_torch_sum": max(sum_errs),
        "shape": list(shape), "blocks": vf.finish_blocks(n), **ways,
        "plain_ms": call_ms(lambda: vf.velocity_finish_plain(
            v, None, seed, step, nf, dt, tau, ramp)),
        # What it replaced on the step: the torch composition on torch.sum
        # and bussi_draw, in a graph of many calls.
        "composition_ms": many_ms(lambda: vf.velocity_finish_plain(
            None, thermostat.compute_kinetic(v), seed, step, nf, dt, tau,
            ramp)),
        "composition_nve_ms": many_ms(
            lambda: thermostat.compute_temperature(v, nf)),
        "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "launch_floor_ms": floor,
        "launch_floor_programmatic_ms": floor_pdl,
        "library_ms": None,
        "library_call": "none: no single PyTorch call draws and rescales"}
    # The least time the card meets launched the way each time beside it
    # was: as a programmatic dependent (``ms``) or in plain stream order.
    rec["bound_meetable_ms"] = max(rec["bound_ms"], floor_pdl)
    rec["bound_meetable_plain_launch_ms"] = max(rec["bound_ms"], floor)
    return rec


def draws_check(mt):
    """The slot step's kernels of ``csrc/philox_draws.cu`` on the card
    against their plain versions at the bench's shapes: Philox's words and
    the noise bit for bit, ``bussi_draw``'s r1 and r2 to rel 1e-12 in
    float64 and one float32 rounding of that in float32, the rebuild flag
    equal at drifts just below and just past skin/2, ``velocity_finish`` as
    :func:`finish_check` holds it; two launches bit for bit, the
    generator's three known answers. Each timed by :func:`many_ms` (a graph
    of ``MANY_CALLS`` calls), beside the launch floor (an empty kernel the
    same way), its plain version on the card by events, one PyTorch call
    and its bound from this run's inputs."""
    from mdtpu_torch.ops import philox_draws as draws

    failures, results = [], {}
    ctr = torch.tensor([k[0] for k in PHILOX_KAT], device="cuda")
    key = torch.tensor([k[1] for k in PHILOX_KAT], device="cuda")
    words = draws.philox_words(ctr, key).cpu().tolist()
    if words != [list(k[2]) for k in PHILOX_KAT]:
        failures.append(f"philox known answers: {words}")
    g = torch.Generator().manual_seed(9)
    ctr = torch.randint(0, 2 ** 32, (1 << 16, 4), generator=g)
    key = torch.randint(0, 2 ** 32, (1 << 16, 2), generator=g)
    if not torch.equal(draws.philox_words(ctr.cuda(), key.cuda()).cpu(),
                       draws.philox_words(ctr, key)):
        failures.append("philox words differ from the plain version")
    floor_pdl, floor = floor_ways_ms()
    results["launch_floor"] = {"ms": floor, "programmatic_ms": floor_pdl,
                               "calls_a_graph": MANY_CALLS}

    # Bussi: the bench's nf - 1; four steps, both dtypes.
    dof = 3.0 * (N_BENCH - 1) - 1.0
    steps = (0, 1, 123456, 2 ** 33 + 5)
    errs = []
    for dtype in (torch.float64, torch.float32):
        rtol = 1e-12 if dtype == torch.float64 else 1.2e-7
        for s in steps:
            step = torch.tensor(s, device="cuda")
            got = draws.bussi_draw(0, step, dof, dtype)
            again = draws.bussi_draw(0, step, dof, dtype)
            want = draws.bussi_draw(0, torch.tensor(s), dof, dtype)
            # Bit for bit the plain version run on the card.
            on_card = torch.stack(draws.bussi_draw_plain(0, step, dof)).to(
                dtype)
            err = (got.cpu().double() - want.double()).abs()
            errs.append(float(err.max()))
            if (not torch.equal(got, again) or not torch.equal(got, on_card)
                    or bool((err > rtol * want.double().abs()).any())):
                failures.append(f"bussi_draw {dtype} step {s}: {got} vs "
                                f"{want} (CPU), {on_card} (card)")
    step = torch.tensor(steps[2], device="cuda")
    # This run's work: the attempts the gamma draw took at that step.
    r1, r2 = draws.bussi_draw_plain(0, torch.tensor(steps[2]), dof)
    attempts = _gamma_attempts(draws, 0, steps[2], dof)
    ops = (1 + 2 * attempts) * OPS_PHILOX_BLOCK + (1 + attempts) * \
        OPS_BOX_MULLER + attempts * OPS_GAMMA_TEST
    b = max(16 / HBM_BYTES_PER_S, ops / PEAK_OPS[torch.float64]) * 1e3
    alpha = torch.full((), 0.5 * dof, dtype=torch.float32, device="cuda")
    # f32 out, and f64.
    bussi_ms = {dtype: many_ms(
        lambda dtype=dtype: draws.bussi_draw(0, step, dof, dtype))
        for dtype in (torch.float32, torch.float64)}
    results["bussi_draw"] = {
        "max_abs_err": max(errs), "attempts": attempts,
        "ms": bussi_ms[torch.float32], "f64_ms": bussi_ms[torch.float64],
        "launch_floor_ms": floor, "launch_floor_programmatic_ms": floor_pdl,
        "plain_ms": call_ms(lambda: draws.bussi_draw_plain(0, step, dof)),
        "bound_ms": b, "bound_by": "bytes" if b == 16 / HBM_BYTES_PER_S
        * 1e3 else "operations", "bound_meetable_ms": max(b, floor_pdl),
        "library_ms": many_ms(lambda: (
            torch._standard_gamma(alpha), torch.randn((), device="cuda"))),
        "library_call": "torch._standard_gamma + torch.randn",
        "r1_r2_step_123456": [float(r1), float(r2)]}

    # Brownian noise: the bench's slot shape and the Brownian path's.
    shapes = {"bench": (3, 15 ** 3 * 37),
              "brownian_slot": _slot_shape(mt, brownian_state(), 1.5)}
    errs = []
    for dtype in (torch.float32, torch.float64):
        for name, shape in shapes.items():
            for rank in (None, 5):
                got = draws.uniform_noise(3, step, shape, dtype, rank)
                again = draws.uniform_noise(3, step, shape, dtype, rank)
                want = draws.uniform_noise(3, torch.tensor(steps[2]), shape,
                                           dtype, rank)
                errs.append(float((got.cpu() - want).abs().max()))
                if not (torch.equal(got.cpu(), want)
                        and torch.equal(got, again)):
                    failures.append(f"uniform_noise {name} {dtype} rank "
                                    f"{rank} differs")
    shape = shapes["bench"]
    n = shape[0] * shape[1]
    nbytes, ops = 4 * n, -(-n // 4) * (OPS_PHILOX_BLOCK + 4 * 3)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b = max(b_bytes, ops / PEAK_OPS[torch.float32] * 1e3)
    # Both ways, in turns, on both shapes and dtypes: [programmatic, plain].
    noise_ways = {
        f"{name}_{str(dtype)[6:]}": list(launch_ways_ms(
            lambda shp=shp, dtype=dtype: draws.uniform_noise(
                3, step, shp, dtype)))
        for name, shp in shapes.items()
        for dtype in (torch.float32, torch.float64)}
    pdl_ms, plain_launch_ms = noise_ways["bench_float32"]
    results["uniform_noise"] = {
        "max_abs_err": max(errs), "shape": list(shape),
        "ms": pdl_ms, "plain_launch_ms": plain_launch_ms,
        "ways_ms": noise_ways,
        "plain_ms": call_ms(lambda: draws.uniform_noise_plain(
            3, step, shape, torch.float32)),
        "bound_ms": b, "bound_by": "bytes" if b == b_bytes
        else "operations",
        # Meetable launched as ``ms`` was (a programmatic dependent), and
        # as ``plain_launch_ms`` was.
        "bound_meetable_ms": max(b, floor_pdl),
        "bound_meetable_plain_launch_ms": max(b, floor),
        "library_ms": many_ms(lambda: torch.rand(shape, device="cuda")),
        "library_call": "torch.rand",
        "brownian_slot_shape": list(shapes["brownian_slot"])}

    # The rebuild flag: drifts below skin/2, then one slot just below and
    # just past it (the threshold's own dtype), on the bench's slots and
    # the Brownian path's (rows that start off 16-byte alignment).
    skin = 0.3
    for name, shp in shapes.items():
        g = torch.Generator(device="cuda").manual_seed(4)
        ref = torch.rand(shp, device="cuda", generator=g) * 40.0
        drift = (torch.rand(shp, device="cuda", generator=g) - 0.5) * 0.08
        out = torch.zeros((), dtype=torch.bool, device="cuda")
        for dtype in (torch.float32, torch.float64):
            for slot, row, past in ((None, 0, 0.0), (0, 2, 1.0),
                                    (shp[1] // 2, 1, 1.0),
                                    (shp[1] - 1, 2, 1.0),
                                    (shp[1] - 3, 1, 1.0),
                                    (shp[1] // 3, 0, -1.0),
                                    (shp[1] - 2, 2, -1.0)):
                pos = (ref + drift).to(dtype)
                r = ref.to(dtype)
                if slot is not None:
                    # A drift along one axis just past (or just short of)
                    # skin/2: the threshold's ulp either side.
                    half = torch.tensor(0.5 * skin, dtype=dtype)
                    edge = torch.nextafter(half, torch.tensor(
                        2.0 if past > 0 else 0.0, dtype=dtype))
                    pos[:, slot] = r[:, slot]
                    pos[row, slot] = r[row, slot] + edge.cuda()
                want = draws.rebuild_flag(pos.cpu(), r.cpu(), skin)
                got = draws.rebuild_flag(pos, r, skin, out=out)
                again = draws.rebuild_flag(pos, r, skin)
                if not (bool(got) == bool(want) == bool(again)):
                    failures.append(f"rebuild_flag {name} {dtype} slot "
                                    f"{slot} row {row} past {past}")
    # Timed on the bench's slots, f32, below skin/2.
    shape = shapes["bench"]
    g = torch.Generator(device="cuda").manual_seed(4)
    ref = torch.rand(shape, device="cuda", generator=g) * 40.0
    drift = (torch.rand(shape, device="cuda", generator=g) - 0.5) * 0.08
    pos, r = (ref + drift).contiguous(), ref.contiguous()
    n = shape[0] * shape[1]
    d2 = ((pos - r) ** 2).sum(0) > 0.15 ** 2
    b = 2 * 4 * n / HBM_BYTES_PER_S * 1e3
    out = torch.zeros((), dtype=torch.bool, device="cuda")
    results["rebuild_flag"] = {
        "max_abs_err": 0.0,
        "ms": many_ms(lambda: draws.rebuild_flag(pos, r, skin, out=out)),
        "plain_ms": call_ms(lambda: draws.rebuild_flag_plain(pos, r, skin)),
        "bound_ms": b, "bound_by": "bytes", "bound_meetable_ms": max(b,
                                                                     floor),
        "library_ms": many_ms(lambda: torch.any(d2)),
        "library_call": "torch.any of the drift test's mask"}
    results["velocity_finish"] = finish_check(mt, failures)
    for name, rec in results.items():
        log(json.dumps({"draws": name, **rec}))
    return results, failures


VERLET_SOURCE = "mdtpu_torch/csrc/verlet_update.cu"
VERLET_REPLACES = "mdtpu/integrate/slot_step.py:579"
VERLET_COVERS = ("mdtpu/integrate/slot_step.py:579-605 make_slot_step's "
                 "Verlet update with mdtpu/integrate/step.py:78-100 "
                 "md_velocity_finish's rescale (XLA, fused into the "
                 "segment's while_loop; no pl.pallas_call)")
# Arrays each variant reads and writes at the bench's compensated step
# (kick-drift: f, v, vc, x, xc in, v, vc, x, xc out; with the hi/lo low
# word one more out; kick: f, v, vc in, v, vc out; rescale: v in, v, vc
# out).
VERLET_ARRAYS = {"kick_drift": 9, "kick_drift_hilo": 10, "kick": 5,
                 "rescale": 3}


def verlet_check(mt):
    """The Verlet update's three variants (``integrate/verlet_update.py``)
    on the card at the bench's slots (3, 124,875): each against its plain
    version on the card's tensors (the torch composition the step ran),
    bit for bit, at f32 and f64, compensated and not, kick-drift also with
    the hi/lo low word, in place and into new tensors, the step counter
    advanced; two launches alike. Each timed by :func:`many_ms` (a graph of
    ``MANY_CALLS`` in-place calls), its plain version the same way, beside
    the launch floor; its bound the bytes it must move."""
    from mdtpu_torch.integrate import verlet_update as vu
    shape = (3, BENCH_GEOMETRY[1] * math.prod(BENCH_GEOMETRY[0]))
    half, dt = 0.001, 0.002
    failures, results = [], {}

    def rows(dtype):
        g = torch.Generator(device="cuda").manual_seed(12)
        f = torch.randn(shape, device="cuda", generator=g) * 30.0
        v = torch.randn(shape, device="cuda", generator=g)
        vc = torch.randn(shape, device="cuda", generator=g) * 1e-8
        x = torch.rand(shape, device="cuda", generator=g) * 40.0
        xc = torch.randn(shape, device="cuda", generator=g) * 1e-7
        return [t.to(dtype) for t in (f, v, vc, x, xc)]

    same = True
    for dtype in (torch.float32, torch.float64):
        for comp in (True, False):
            f, v, vc, x, xc = rows(dtype)
            scale = torch.tensor(1.0123, dtype=dtype, device="cuda")
            want = vu.kick_drift_plain(f, v, vc, x, xc, half, dt, comp, comp)
            lo = torch.empty_like(xc) if comp else None
            got = vu.kick_drift(f, v, vc, x, xc, half, dt, comp, lo=lo)
            again = vu.kick_drift(f, v, vc, x, xc, half, dt, comp)
            same &= all(torch.equal(a, b) and torch.equal(a, c)
                        for a, b, c in zip(got, want, again))
            same &= lo is None or torch.equal(lo, want[4])
            step = torch.tensor(599, device="cuda")
            v, vc = got[0], got[1].clone()
            kv, kvc = vu.kick_plain(f, v, vc, half, comp)
            vu.kick(f, v, vc, half, comp, step)
            same &= torch.equal(v, kv) and torch.equal(vc, kvc)
            rv, rvc = vu.rescale_plain(v, vc, scale, comp)
            vu.rescale(v, vc, scale, comp, step)
            same &= torch.equal(v, rv) and torch.equal(vc, rvc)
            same &= int(step) == 601
    if not same:
        failures.append("verlet_update differs from its plain version")
    floor = launch_floor_ms()
    f, v, vc, x, xc = rows(torch.float32)
    one = torch.tensor(1.0, device="cuda")
    lo = torch.empty_like(xc)
    n = v.numel()
    calls = {
        "kick_drift": (
            lambda: vu.kick_drift(f, v, vc, x, xc, half, dt, True,
                                  out=(v, vc, x, xc)),
            lambda: vu.kick_drift_plain(f, v, vc, x, xc, half, dt, True)),
        "kick_drift_hilo": (
            lambda: vu.kick_drift(f, v, vc, x, xc, half, dt, True,
                                  out=(v, vc, x, xc), lo=lo),
            lambda: vu.kick_drift_plain(f, v, vc, x, xc, half, dt, True,
                                        True)),
        "kick": (lambda: vu.kick(f, v, vc, half, True),
                 lambda: vu.kick_plain(f, v, vc, half, True)),
        "rescale": (lambda: vu.rescale(v, vc, one, True),
                    lambda: vu.rescale_plain(v, vc, one, True)),
    }
    for name, (kernel, plain) in calls.items():
        b = VERLET_ARRAYS[name] * 4 * n / HBM_BYTES_PER_S * 1e3
        results[name] = {
            "max_abs_err": 0.0 if same else float("inf"),
            "ms": many_ms(kernel), "plain_ms": many_ms(plain),
            "plain_timing": "a graph of the composition's calls, as ms",
            "bound_ms": b, "bound_by": "bytes",
            "bound_meetable_ms": max(b, floor), "launch_floor_ms": floor,
            "library_ms": None,
            "library_call": "none, no single PyTorch call",
            "shape": list(shape), "dtype": "float32"}
        log(json.dumps({"verlet_update": name, **results[name]}))
    return results, failures


BROWNIAN_REPLACES = "mdtpu/integrate/slot_step.py:557"
BROWNIAN_COVERS = ("mdtpu/integrate/slot_step.py:557-577 make_slot_step's "
                   "Brownian update with mdtpu/integrate/step.py:110 "
                   "brownian_noise and :122 brownian_virial_sample (XLA, "
                   "fused into the segment's while_loop; no pl.pallas_call)")
# Rows of d * S values the update moves: f, x, xc read, x, xc written.
BROWNIAN_ROWS = 5
# Operations a value: the drift and noise products, their sum, the Kahan
# add's four, the noise's scaling (2u - 1, times sqrt 3); and a Philox
# block a 16-byte group.
OPS_BROWNIAN_VALUE = 10


def brownian_update_check(mt):
    """The Brownian slot step's update (``integrate/verlet_update.py``
    ``brownian_update``) on the card at the Brownian slot path's slots
    (3, 263,424) and the bench's (3, 124,875), f32 and f64, compensated
    and not: against its plain version on the card's tensors (the torch
    composition, its noise from the ``uniform_noise`` kernel) bit for bit,
    into new tensors and in place, the step counter, the virial's sample
    and the temperature; two launches alike. Each timed by
    :func:`many_ms` (a graph of ``MANY_CALLS`` in-place calls) beside the
    launch floor as a programmatic dependent, the composition it replaced
    timed the same way, and its bound from this run's inputs: the bytes
    it must move."""
    import types

    from mdtpu_torch.integrate import verlet_update as vu
    shapes = {"brownian_slot": _slot_shape(mt, brownian_state(), 1.5),
              "bench": (3, BENCH_GEOMETRY[1] * math.prod(
                  BENCH_GEOMETRY[0]))}
    failures, results = [], {}

    def state_of(shape, dtype, step):
        g = torch.Generator(device="cuda").manual_seed(17)
        occ = torch.rand(shape[1], device="cuda", generator=g) < 0.25
        f = torch.randn(shape, device="cuda", generator=g) * 30.0 * occ
        x = torch.rand(shape, device="cuda", generator=g) * 80.0 * occ
        xc = torch.randn(shape, device="cuda", generator=g) * 1e-7 * occ
        return types.SimpleNamespace(
            positions=x.to(dtype), pos_comp=xc.to(dtype), seed=3,
            nbrs=types.SimpleNamespace(occupied=occ), dtype=dtype,
            step=torch.tensor(step, device="cuda"), device=x.device,
            virial_accum=torch.tensor(2.5, dtype=dtype, device="cuda"),
            nprom=torch.tensor(4, device="cuda"),
            temperature=torch.tensor(0.0, dtype=dtype, device="cuda")), \
            f.to(dtype), torch.tensor(-1234.5, dtype=dtype, device="cuda")

    same = True
    for name, shape in shapes.items():
        for dtype in (torch.float32, torch.float64):
            coeffs = vu.brownian_coefficients(1e-5, 1.0, dtype)
            for comp, step in ((True, 123450), (False, 123457)):
                st, f, w = state_of(shape, dtype, step)
                want = vu.brownian_update_plain(f, w, st, *coeffs, comp)
                got = vu.brownian_update(f, w, st, *coeffs, comp)
                again = vu.brownian_update(f, w, st, *coeffs, comp)
                same &= all(torch.equal(a, b) and torch.equal(a, c) for
                            a, b, c in zip(got[:2] + got[3:], want,
                                           again[:2] + again[3:]))
                same &= int(got[2]) == step + 1 == int(again[2])
                vu.brownian_update(f, w, st, *coeffs, comp, in_place=True)
                same &= all(torch.equal(a, b) for a, b in zip(
                    (st.positions, st.pos_comp, st.virial_accum, st.nprom,
                     st.temperature), want))
                same &= int(st.step) == step + 1
    if not same:
        failures.append("brownian_update differs from its plain version")
    floor = launch_floor_ms(True)
    for name, shape in shapes.items():
        for dtype in (torch.float32, torch.float64):
            coeffs = vu.brownian_coefficients(1e-5, 1.0, dtype)
            st, f, w = state_of(shape, dtype, 123450)
            n = shape[0] * shape[1]
            size = torch.tensor([], dtype=dtype).element_size()
            nbytes = BROWNIAN_ROWS * size * n + shape[1]
            ops = (-(-n // (16 // size)) * OPS_PHILOX_BLOCK
                   + n * OPS_BROWNIAN_VALUE)
            b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            b = max(b_bytes, ops / PEAK_OPS[dtype] * 1e3)
            key = f"{name}_{str(dtype)[6:]}"
            results[key] = {
                "max_abs_err": 0.0 if same else float("inf"),
                "ms": many_ms(lambda: vu.brownian_update(
                    f, w, st, *coeffs, True, in_place=True)),
                "plain_ms": many_ms(lambda: vu.brownian_update_plain(
                    f, w, st, *coeffs, True)),
                "plain_timing": "a graph of the composition's calls (the "
                                "noise kernel and the torch operations), "
                                "as ms",
                "bound_ms": b, "bound_by": "bytes" if b == b_bytes
                else "operations", "bound_bytes": nbytes,
                "bound_meetable_ms": max(b, floor),
                "launch_floor_programmatic_ms": floor,
                "library_ms": None,
                "library_call": "none, no single PyTorch call",
                "shape": list(shape)}
            log(json.dumps({"brownian_update": key, **results[key]}))
    return results, failures


PARTICLE_REPLACES = {
    "kick_drift_wrap": "mdtpu/integrate/step.py:160",
    "brownian_rows": "mdtpu/integrate/step.py:233",
    "rebuild_flag_rows": "mdtpu/integrate/step.py:52",
}
PARTICLE_COVERS = {
    "kick_drift_wrap": "mdtpu/integrate/step.py:160-169 make_md_step's "
                       "half-kick, drift and wrap with mdtpu/core/box.py"
                       ":66-103 wrap_positions[_compensated] (XLA, fused "
                       "into the segment's fori_loop; no pl.pallas_call)",
    "brownian_rows": "mdtpu/integrate/step.py:233-246 make_brownian_step's "
                     "noise, move, wrap and virial sample (XLA, fused "
                     "into the segment's fori_loop; no pl.pallas_call)",
    "rebuild_flag_rows": "mdtpu/integrate/step.py:52-68 engine_forces' "
                         "drift test and lax.cond with mdtpu/ops/"
                         "cell_grid.py:522 and mdtpu/ops/neighbor_list.py"
                         ":212 needs_rebuild (XLA)",
}
# Operations a particle-row value, by hand count of csrc/verlet_update.cu
# (d = 3): the kick and the drift (two products, two Kahan adds of four),
# the wrap's fractional product row (2d - 1), floor, the crossing's
# product row (2d - 1) and its Kahan add (4), the image add: 28. The
# Brownian move: the drift and noise products and their sum, the Kahan
# add, the noise's scaling, the wrap: 25, and a Philox block for each
# block a particle's values touch. The drift test: a subtraction, the
# minimum image (cell: two product rows of 2d - 1 and a rint and
# subtraction; lengths: a division, rint, product, subtraction), a square
# and an add: 15 (cell), 7 (lengths).
OPS_KDW_VALUE, OPS_BROWNIAN_ROW_VALUE = 28, 25
OPS_FLAG_ROW_VALUE = {"cell": 15, "lengths": 7}
# The drift test's and the Brownian move's times in their earlier design (a
# particle a thread, 256 blocks of 256 at 65,536, plain stream order, the
# ticket of atomicOr, atomicAdd and two fences; a graph of 100 in-place
# calls, f32 unless named, on an H100 80GB HBM3 at 700 W), logged beside
# this tree's in the particle phase's lines; not in the kernels line,
# which holds only what this run measured.
PARTICLE_EARLIER_MS = {"rebuild_flag_rows_cell": 0.00330,
                       "rebuild_flag_rows_cell_tilted": 0.00331,
                       "rebuild_flag_rows_lengths": 0.00334,
                       "brownian_rows": 0.00467,
                       "brownian_rows_f64": 0.00530}


def _rows_view(rows, offset):
    """``rows`` copied into a flat buffer of their dtype at ``offset``
    values: a view whose data_ptr is 16-byte aligned only where the
    offset's bytes are a multiple of 16."""
    n, d = rows.shape
    buf = torch.empty(n * d + offset, dtype=rows.dtype, device=rows.device)
    view = buf[offset:].view(n, d)
    view.copy_(rows)
    return view


def rows_edge_check(draws, vu):
    """The drift test and the Brownian move at the edges of their grid
    (``philox_draws.rows_edge_counts``: 1, 3, one Philox period and its
    neighbours, an odd count, one block's count and its neighbours, one
    wave's and past it), d = 2 and 3, f32 and f64, on rows 16-byte aligned
    and at an offset of one value (positions) and two (references): the
    drift test by the cell and by the box lengths (the cell's diagonal, a
    view) with no particle past skin/2 and with only the first row, the
    last row or the last Philox period's first row past it, its flag against the
    plain version's, twice alike; the Brownian move compensated and not,
    into new tensors and in place, bit for bit its plain version and twice
    alike. ``(flags_ok, moves_ok, record)``."""
    import types
    flags_ok = moves_ok = True
    cases = 0
    for d in (2, 3):
        for dtype in (torch.float32, torch.float64):
            side = 12.0
            cell = torch.eye(d, dtype=dtype, device="cuda") * side
            if d == 3:
                cell[0, 1], cell[0, 2], cell[1, 2] = side / 8, side / 12, \
                    side / 6
            boxes = (dict(cell=cell, cell_inv=torch.linalg.inv(cell)),
                     dict(lengths=torch.diagonal(
                         torch.eye(d, dtype=dtype, device="cuda") * side)))
            coeffs = vu.brownian_coefficients(1e-3, 1.3, dtype)
            w = torch.tensor(-1234.5, dtype=dtype, device="cuda")
            for n in draws.rows_edge_counts(d, dtype):
                g = torch.Generator(device="cuda").manual_seed(n)
                ref = torch.rand((n, d), device="cuda", generator=g,
                                 dtype=torch.float64) * side
                disp = (torch.rand((n, d), device="cuda", generator=g,
                                   dtype=torch.float64) - 0.5) * 0.1
                period = draws.rows_grid(n, d, dtype).period
                for op, orf in ((0, 0), (1, 2)):
                    for hit in (None, 0, n - 1, (n - 1) // period * period):
                        moved = disp.clone()
                        if hit is not None:
                            moved[hit] = 0.2
                        r = _rows_view(ref.to(dtype), orf)
                        p = _rows_view((ref + moved).to(dtype), op)
                        for box in boxes:
                            plain = (box.get("cell"), box.get("cell_inv"),
                                     box.get("lengths"))
                            a = draws.rebuild_flag_rows(p, r, 0.3, **box)
                            again = draws.rebuild_flag_rows(p, r, 0.3, **box)
                            b = draws.rebuild_flag_rows_plain(p, r, 0.3,
                                                              *plain)
                            flags_ok &= (bool(a) == bool(b) == bool(again)
                                         == (hit is not None))
                            cases += 1
                f = torch.randn((n, d), device="cuda", generator=g,
                                dtype=torch.float64).to(dtype) * 30
                x = (ref + disp * 20).to(dtype)
                xc = (torch.randn((n, d), device="cuda", generator=g)
                      * 1e-7).to(dtype)
                img = torch.randint(-3, 4, (n, d), device="cuda",
                                    generator=g)
                for off in (0, 1):
                    def state_of(off=off):
                        return types.SimpleNamespace(
                            positions=_rows_view(x, off),
                            pos_comp=_rows_view(xc, off),
                            images=_rows_view(img, off), unitcell=cell,
                            unitcell_inv=torch.linalg.inv(cell), seed=3,
                            step=torch.tensor(2 ** 33 + 10, device="cuda"),
                            dtype=dtype, device=x.device,
                            virial_accum=torch.tensor(2.5, dtype=dtype,
                                                      device="cuda"),
                            nprom=torch.tensor(4, device="cuda"),
                            temperature=torch.tensor(0.0, dtype=dtype,
                                                     device="cuda"))
                    fv = _rows_view(f, off)
                    for comp in (True, False):
                        st = state_of()
                        want = vu.brownian_rows_plain(fv, w, st, *coeffs,
                                                      comp)
                        got = vu.brownian_rows(fv, w, st, *coeffs, comp)
                        again = vu.brownian_rows(fv, w, st, *coeffs, comp)
                        moves_ok &= all(
                            torch.equal(a, b) and torch.equal(a, c)
                            for a, b, c in zip(got[:3] + got[4:], want,
                                               again[:3] + again[4:]))
                        st = state_of()
                        vu.brownian_rows(fv, w, st, *coeffs, comp,
                                         in_place=True)
                        mine = (st.positions, st.pos_comp, st.images,
                                st.virial_accum, st.nprom, st.temperature)
                        moves_ok &= all(torch.equal(a, b) for i, (a, b) in
                                        enumerate(zip(mine, want))
                                        if comp or i != 1)
                        moves_ok &= int(st.step) == 2 ** 33 + 11
                        cases += 1
    return flags_ok, moves_ok, {
        "cases": cases, "flags_equal": flags_ok, "moves_equal": moves_ok,
        "counts": {f"{d}d_{str(t)[6:]}": list(draws.rows_edge_counts(d, t))
                   for d in (2, 3) for t in (torch.float32, torch.float64)}}


def _particle_rows(state, dtype):
    """f, v, vc, x, xc, images, cell, cell_inv of a particle-order state
    on the card, cast to ``dtype``: forces, velocities and compensations
    drawn from a seed, and the positions shifted by up to 0.75 along each
    axis, so the wrap folds those it takes across a face."""
    g = torch.Generator(device="cuda").manual_seed(21)
    shape = state.positions.shape
    f = torch.randn(shape, device="cuda", generator=g) * 30.0
    v = torch.randn(shape, device="cuda", generator=g) * 3.0
    vc = torch.randn(shape, device="cuda", generator=g) * 1e-8
    xc = torch.randn(shape, device="cuda", generator=g) * 1e-7
    shift = (torch.rand(shape, device="cuda", generator=g) - 0.5) * 1.5
    x = state.positions.double() + shift
    return ([t.to(dtype) for t in (f, v, vc, x, xc)]
            + [state.images.clone(), state.unitcell.to(dtype),
               state.unitcell_inv.to(dtype)])


def particle_check(mt, rows_probe=None):
    """The particle-order step's kernels (``verlet_update.kick_drift_wrap``
    and ``brownian_rows``, ``philox_draws.rebuild_flag_rows``) on the card
    at 65,536 particles against their plain versions on the card's
    tensors (the torch compositions), bit for bit, and two launches alike:
    the bench's lattice (cubic, f32 and f64, compensated and not, the
    hi/lo low word, into new tensors and in place), the tilted box and the
    2D start (f32); the Brownian move on the Brownian path's start (f32,
    f64; a device counter and a host step); the drift test by the cell
    (cubic, tilted) and by the box lengths on displacements around skin/2,
    a row at a time and all at once; both at the edges of their grid
    (:func:`rows_edge_check`). Each timed by :func:`many_ms` (a graph of
    ``MANY_CALLS`` in-place calls) beside its plain version timed the same
    way, the launch floor (also as a programmatic dependent), and its bound
    from this run's inputs (the bytes it must move, or its operations);
    the drift test and the Brownian move also with the phase split of a
    stamped copy of their source (``rows_probe``: a future of
    ``probe_torch_rows.build_stamped``) and their earlier design's times
    (``PARTICLE_EARLIER_MS``) on their log lines."""
    import types

    from mdtpu_torch.integrate import verlet_update as vu
    from mdtpu_torch.ops import philox_draws as draws
    failures, results, same = [], {}, True
    bench, half, dt = lattice_start(), 0.005, 0.01
    starts = {"bench": bench, "tilted": state_tilted(mt, torch.float32),
              "2d": state_2d(mt, torch.float32)}

    def kdw_same(rows, comp):
        f, v, vc, x, xc, img, c, ci = rows
        want = vu.kick_drift_wrap_plain(f, v, vc, x, xc, img, c, ci, half,
                                        dt, comp, comp)
        lo = torch.empty_like(xc) if comp else None
        got = vu.kick_drift_wrap(f, v, vc, x, xc, img, c, ci, half, dt, comp,
                                 lo=lo)
        again = vu.kick_drift_wrap(f, v, vc, x, xc, img, c, ci, half, dt,
                                   comp)
        ok = all(torch.equal(a, b) and torch.equal(a, r)
                 for a, b, r in zip(got, want[:5], again))
        ok &= lo is None or torch.equal(lo, want[5])
        ok &= not torch.equal(want[4], img)          # some were folded
        vu.kick_drift_wrap(f, v, vc, x, xc, img, c, ci, half, dt, comp,
                           out=(v, vc, x, xc, img))
        return ok and all(torch.equal(a, b) for a, b in zip(
            (v, vc, x, xc, img), want[:5]))

    for name, st in starts.items():
        for dtype in ((torch.float32, torch.float64) if name == "bench"
                      else (torch.float32,)):
            for comp in (True, False):
                same &= kdw_same(_particle_rows(st, dtype), comp)
    if not same:
        failures.append("kick_drift_wrap differs from its plain version")

    bst = brownian_state()
    b_same = True
    for dtype in (torch.float32, torch.float64):
        coeffs = vu.brownian_coefficients(1e-5, 1.0, dtype)
        f, _, _, x, xc, img, c, ci = _particle_rows(bst, dtype)
        for comp, step in ((True, torch.tensor(123450, device="cuda")),
                           (False, 123457)):
            st = types.SimpleNamespace(
                positions=x.clone(), pos_comp=xc.clone(), images=img.clone(),
                unitcell=c, unitcell_inv=ci, seed=3, step=step, dtype=dtype,
                device=x.device,
                virial_accum=torch.tensor(2.5, dtype=dtype, device="cuda"),
                nprom=torch.tensor(4, device="cuda"),
                temperature=torch.tensor(0.0, dtype=dtype, device="cuda"))
            w = torch.tensor(-1234.5, dtype=dtype, device="cuda")
            want = vu.brownian_rows_plain(f, w, st, *coeffs, comp)
            got = vu.brownian_rows(f, w, st, *coeffs, comp)
            again = vu.brownian_rows(f, w, st, *coeffs, comp)
            b_same &= all(torch.equal(a, b) and torch.equal(a, r) for a, b, r
                          in zip(got[:3] + got[4:], want,
                                 again[:3] + again[4:]))
            b_same &= int(got[3]) == int(step) + 1 == int(again[3])
    if not b_same:
        failures.append("brownian_rows differs from its plain version")

    # The drift test: displacements of length 0.98-1.02 skin/2 from
    # references at the box's faces too, each row alone (256 of them) and
    # all rows at once with none past it and with one.
    flag_same, skin, forms = True, 0.3, {}
    for name, st in (("cell", bench), ("cell_tilted", starts["tilted"]),
                     ("lengths", bench)):
        g = torch.Generator(device="cuda").manual_seed(23)
        ref = st.positions.contiguous()
        u = torch.randn(ref.shape, device="cuda", generator=g)
        u = u / u.norm(dim=1, keepdim=True)
        ratio = 0.98 + 0.04 * torch.rand((ref.shape[0], 1), device="cuda",
                                         generator=g)
        pos = ref + u * ratio * 0.5 * skin
        box = (dict(lengths=torch.diagonal(st.unitcell))
               if name == "lengths" else
               dict(cell=st.unitcell, cell_inv=st.unitcell_inv))
        plain_box = (box.get("cell"), box.get("cell_inv"), box.get("lengths"))
        for i in range(0, ref.shape[0], ref.shape[0] // 256):
            a = draws.rebuild_flag_rows(pos[i:i + 1], ref[i:i + 1], skin,
                                        **box)
            b = draws.rebuild_flag_rows_plain(pos[i:i + 1], ref[i:i + 1],
                                              skin, *plain_box)
            flag_same &= bool(a) == bool(b)
        inside = (ref + (pos - ref) * 0.5).contiguous()
        moved = inside.clone()
        moved[7] = ref[7] + 0.2
        for rows, want in ((inside, False), (moved, True)):
            a = draws.rebuild_flag_rows(rows, ref, skin, **box)
            again = draws.rebuild_flag_rows(rows, ref, skin, **box)
            b = draws.rebuild_flag_rows_plain(rows, ref, skin, *plain_box)
            flag_same &= bool(a) == bool(b) == bool(again) == want
        forms[name] = (inside, ref, box, plain_box)
    edge_flags, edge_moves, edges = rows_edge_check(draws, vu)
    flag_same &= edge_flags
    b_same &= edge_moves
    log(json.dumps({"particle_rows_edges": edges}))
    if not edge_moves:
        failures.append("brownian_rows differs from its plain version at "
                        "the edges of its grid")
    if not flag_same:
        failures.append("rebuild_flag_rows differs from its plain version")

    floor = launch_floor_ms()
    floor_pdl = launch_floor_ms(True)
    n = N_BENCH * 3

    def entry(kernel, plain, nbytes, ops, dtype, extra):
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b = max(b_bytes, ops / PEAK_OPS[dtype] * 1e3)
        return {"ms": many_ms(kernel), "plain_ms": many_ms(plain),
                "plain_timing": "a graph of the composition's calls, as ms",
                "bound_ms": b, "bound_by": "bytes" if b == b_bytes
                else "operations", "bound_bytes": nbytes,
                "bound_meetable_ms": max(b, floor), "launch_floor_ms": floor,
                "launch_floor_programmatic_ms": floor_pdl,
                "library_ms": None,
                "library_call": "none, no single PyTorch call", **extra}

    ok = {"kick_drift_wrap": same, "brownian_rows": b_same,
          "rebuild_flag_rows": flag_same}
    for dtype, hilo in ((torch.float32, False), (torch.float32, True),
                        (torch.float64, False)):
        f, v, vc, x, xc, img, c, ci = _particle_rows(bench, dtype)
        size = torch.tensor([], dtype=dtype).element_size()
        lo = torch.empty_like(xc) if hilo else None
        key = "kick_drift_wrap" + ("_hilo" if hilo else "") + (
            "" if dtype == torch.float32 else "_f64")
        results[key] = entry(
            lambda: vu.kick_drift_wrap(f, v, vc, x, xc, img, c, ci, half,
                                       dt, True, out=(v, vc, x, xc, img),
                                       lo=lo),
            lambda: vu.kick_drift_wrap_plain(f, v, vc, x, xc, img, c, ci,
                                             half, dt, True, hilo),
            (9 + hilo) * size * n + 2 * 8 * n, OPS_KDW_VALUE * n, dtype,
            {"shape": [N_BENCH, 3], "dtype": str(dtype)[6:]})
    for dtype in (torch.float32, torch.float64):
        coeffs = vu.brownian_coefficients(1e-5, 1.0, dtype)
        f, _, _, x, xc, img, c, ci = _particle_rows(bst, dtype)
        st = types.SimpleNamespace(
            positions=x, pos_comp=xc, images=img, unitcell=c,
            unitcell_inv=ci, seed=3,
            step=torch.tensor(123450, device="cuda"), dtype=dtype,
            device=x.device,
            virial_accum=torch.tensor(2.5, dtype=dtype, device="cuda"),
            nprom=torch.tensor(4, device="cuda"),
            temperature=torch.tensor(0.0, dtype=dtype, device="cuda"))
        w = torch.tensor(-1234.5, dtype=dtype, device="cuda")
        size = torch.tensor([], dtype=dtype).element_size()
        per = 16 // size
        blocks = sum(-(-(3 * i + 3) // per) - (3 * i) // per
                     for i in range(per))       # a period of `per` rows
        key = "brownian_rows" + ("" if dtype == torch.float32 else "_f64")
        phases = ({"phases": _rows_phases(rows_probe, "brownian_rows",
                                          dtype)}
                  if rows_probe is not None else {})
        results[key] = entry(
            lambda: vu.brownian_rows(f, w, st, *coeffs, True, in_place=True),
            lambda: vu.brownian_rows_plain(f, w, st, *coeffs, True),
            5 * size * n + 2 * 8 * n,
            OPS_BROWNIAN_ROW_VALUE * n
            + N_BENCH // per * blocks * OPS_PHILOX_BLOCK, dtype,
            {"shape": [N_BENCH, 3], "dtype": str(dtype)[6:],
             "philox_blocks": N_BENCH // per * blocks,
             "plain_timing": "a graph of the composition's calls (the "
                             "noise kernel and the torch operations), "
                             "as ms", **phases})
    cube = forms["cell"]
    forms["cell_f64"] = (cube[0].double(), cube[1].double(),
                         {k: v.double() for k, v in cube[2].items()},
                         tuple(t.double() for t in cube[3][:2]) + (None,))
    out_mask = torch.zeros(N_BENCH, dtype=torch.bool, device="cuda")
    for name, (inside, ref, box, plain_box) in forms.items():
        out = torch.empty((), dtype=torch.bool, device="cuda")
        kind = "lengths" if name == "lengths" else "cell"
        dtype = inside.dtype
        extra = {"shape": [N_BENCH, 3], "dtype": str(dtype)[6:],
                 "form": name.removesuffix("_f64"),
                 "yardstick_torch_any_ms": many_ms(
                     lambda: torch.any(out_mask)),
                 "yardstick": "torch.any of a (65,536,) bool mask: the "
                              "same rows, not the same function"}
        if rows_probe is not None and name in ("cell", "cell_f64",
                                               "lengths"):
            extra["phases"] = _rows_phases(rows_probe, "rebuild_rows",
                                           dtype, kind)
        size = inside.element_size()
        results[f"rebuild_flag_rows_{name}"] = entry(
            lambda: draws.rebuild_flag_rows(inside, ref, skin, out=out,
                                            **box),
            lambda: draws.rebuild_flag_rows_plain(inside, ref, skin,
                                                  *plain_box),
            2 * size * n, OPS_FLAG_ROW_VALUE[kind] * n, dtype, extra)
    for key, rec in results.items():
        base = next(k for k in ok if key.startswith(k))
        rec["max_abs_err"] = 0.0 if ok[base] else float("inf")
        log(json.dumps({"particle_kernel": key, **rec,
                        "earlier_design_ms": PARTICLE_EARLIER_MS.get(key)}))
    return results, failures


def _rows_phases(rows_probe, kernel, dtype, form="cell"):
    """The probe's phase split of ``kernel`` at 65,536 rows of ``dtype``
    (``probe_torch_rows.case_split`` on the stamped libraries that
    ``rows_probe``, a future, holds)."""
    import probe_torch_rows
    return probe_torch_rows.case_split(rows_probe.result(), kernel, dtype,
                                       form)


PARTICLE_ROUTES = {
    # name: (start, params kind, engine, [(ensemble, steps, compensated)])
    "b2": ("bench", "plane", [("nvt", 300, False), ("nve", 200, True)]),
    "nl": ("bench", "neighbor", [("nvt", 300, True), ("nve", 200, True)]),
    "brownian": ("brownian", "plane", [("brownian", 200, True)]),
    "cellgrid_uncompensated": ("bench", "cellgrid", [("nvt", 300, False)]),
}


def particle_paths(mt, workdir):
    """The particle-order route at 65,536 through ``run_simulation``, each
    case from one start on the eager advance (``graph=False``, the flag
    read on the host) and the captured one (the default): ``PlaneEngine``
    (NVT uncompensated as the B2 path runs it, then NVE compensated on the
    hi/lo sweep), the list (NVT, NVE), Brownian on ``PlaneEngine`` and the
    cell grid with ``compensated=False``: positions, velocities, images,
    forces, energy, virial, every thermo row and the rebuild steps bit for
    bit, steps/s of both. Then one segment of each route and ensemble on
    each advance through ``profile_torch_step.measure`` (host ms, device
    busy ms and idle share, launches, graph launches and host reads a
    step: none inside a captured segment, or the run fails), and the nodes
    of each captured step, read from its graph."""
    from mdtpu_torch.integrate import step as step_mod
    from mdtpu_torch.ops.cell_grid import CellGridEngine
    from mdtpu_torch.ops.experimental import PlaneEngine
    from profile_torch_step import measure

    lj = mt.LennardJones(r_cut=2.5)
    params = {"bench": mt.Parameters(density=0.8, n_particles=N_BENCH,
                                     dt=0.002, potential=lj),
              "brownian": mt.Parameters(density=0.5, n_particles=N_BENCH,
                                        dt=1e-5, potential=mt.PseudoHS())}
    starts = {"bench": lattice_start, "brownian": brownian_state}
    ensembles = {"nvt": mt.NVT(1.0, 0.4), "nve": mt.NVE(),
                 "brownian": mt.Brownian(1.0)}

    def engine_of(kind, st, pot, cutoff):
        if kind == "plane":
            return PlaneEngine.create(pot, cutoff, 0.3, st.unitcell, N_BENCH)
        if kind == "neighbor":
            return mt.select_engine(pot, cutoff, st, prefer="neighbor")
        return CellGridEngine.create(pot, cutoff, 0.3, st.unitcell, N_BENCH)

    failures, rec = [], {}
    for name, (start, kind, legs) in PARTICLE_ROUTES.items():
        prm = params[start]
        cutoff = 2.5 if start == "bench" else 1.5
        runs, census = {}, []
        for route, graph in (("eager", False), ("graph", None)):
            real, make, made = _recording_advance(
                graph, step_mod, "make_particle_advance")
            step_mod.make_particle_advance = make
            try:
                st, rows = starts[start](), []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i, (ens, steps, comp) in enumerate(legs):
                    out = os.path.join(workdir, f"particle_{name}_{route}_{i}")
                    st = mt.run_simulation(
                        st, prm, ensembles[ens], steps, THERMO_EVERY, out,
                        engine=engine_of(kind, st, prm.potential, cutoff),
                        compensated=comp, traj_frequency=steps)
                    with open(os.path.join(out, "thermo.txt")) as f:
                        rows.append(f.read())
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            finally:
                step_mod.make_particle_advance = real
            if any(a.graph is not bool(graph is None) for a in made):
                failures.append(f"particle {name}: an advance took the "
                                f"other route")
            if graph is None:
                census += [a.census for a in made]
            runs[route] = (st, rows, [s for a in made
                                      for s in a.rebuild_steps()],
                           sum(s for _, s, _ in legs) / seconds)
        (e_end, e_rows, e_reb, e_rate), (g_end, g_rows, g_reb, g_rate) = (
            runs["eager"], runs["graph"])
        same = {f: torch.equal(getattr(e_end, f), getattr(g_end, f))
                for f in ("positions", "velocities", "images", "forces",
                          "energy", "virial", "pos_comp")}
        if not (all(same.values()) and e_rows == g_rows and e_reb == g_reb):
            failures.append(f"particle {name}: the routes differ: {same}, "
                            f"rows equal {e_rows == g_rows}, rebuilds "
                            f"{e_reb} vs {g_reb}")
        if not e_reb:
            failures.append(f"particle {name}: no rebuild in the run")
        moves = "brownian_rows" if start == "brownian" else "kick_drift_wrap"
        for c in census:
            nodes = c["step"]
            if (nodes["conditionals"], nodes["rebuild_rows"],
                    nodes[moves], nodes["rebuild_flag"],
                    nodes["uniform_noise"], nodes["unreadable"]) != (
                        1, 1, 1, 0, 0, 0):
                failures.append(f"particle {name}: step nodes {nodes}")
        rec[name] = {"steps": sum(s for _, s, _ in legs),
                     "rebuilds": len(g_reb), "rebuild_steps": g_reb,
                     "steps_per_s_eager": e_rate,
                     "steps_per_s_graph": g_rate,
                     "step_nodes": [{k: c["step"][k] for k in (
                         "nodes", "kernels", "copies", "memsets",
                         "conditionals")} for c in census]}
        log(json.dumps({"particle_path": name, **rec[name]}))

    # One segment of each route on each advance, in turns (graph, eager),
    # from the melted bench fluid (the Brownian start as it is).
    melted = as_dtype(melted_state(mt), torch.float32)
    rec["segment_profile"] = {}
    for name, (start, kind, legs) in PARTICLE_ROUTES.items():
        prm = params[start]
        cutoff = 2.5 if start == "bench" else 1.5
        for ens, _, comp in legs:
            st = melted if start == "bench" else brownian_state()
            eng = engine_of(kind, st, prm.potential, cutoff)
            nbrs = eng.allocate(st.positions, st.diameters, st.unitcell,
                                st.unitcell_inv)
            if ens != "brownian":
                e, w, f, nbrs = eng.compute(st.positions, st.diameters,
                                            st.unitcell, st.unitcell_inv,
                                            nbrs)
                st = st.replace(forces=f, energy=e, virial=w)
            st = st.replace(nbrs=nbrs)
            hilo = (kind != "neighbor" and ens == "nve" and comp)
            profiles, nodes = {}, None
            for route in ("graph", "eager"):
                advance = step_mod.make_particle_advance(
                    prm, ensembles[ens], eng, comp, hilo=hilo,
                    graph=None if route == "graph" else False)
                _, metrics = measure(advance, st, n_timed=100,
                                     n_profiled=30,
                                     looped=lambda: bool(advance.graph))
                metrics.pop("top_device_kernels")
                metrics["rebuilds"] = int(advance.rebuilds)
                profiles[route] = metrics
                if route == "graph":
                    nodes = advance.census.get("step")
            key = f"{name}_{ens}" + ("_hilo" if hilo else "")
            log(json.dumps({"particle_segment_profile": key,
                            "nodes": nodes, **profiles}))
            graph_launches = (profiles["graph"]["graph_launches_per_step"]
                              * profiles["graph"]["profiled_steps"])
            if profiles["graph"]["host_syncs_per_step"] or round(
                    graph_launches) != 1:
                failures.append(f"particle {key}: host reads or graph "
                                f"launches inside a captured segment "
                                f"{profiles['graph']}")
            rec["segment_profile"][key] = {"profiles": profiles,
                                           "nodes": nodes}
    return rec, failures


def _gamma_attempts(draws, seed, step, dof):
    """The Marsaglia-Tsang attempts the draw at ``step`` took."""
    k0, k1 = draws.seed_key(seed)
    s = torch.tensor(step)
    lo, hi = s & draws.MASK, (s >> 32) & draws.MASK
    a = 0.5 * dof
    d = (a + 1.0 if a < 1.0 else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    for t in range(draws.GAMMA_ATTEMPTS):
        wn = draws.philox4x32_10(torch.tensor(1 + 2 * t), lo, hi, 0, k0, k1)
        wu = draws.philox4x32_10(torch.tensor(2 + 2 * t), lo, hi, 0, k0, k1)
        x = float(draws._box_muller(*wn))
        v = (1.0 + c * x) ** 3
        u = 1.0 - float(draws._u53(wu[0], wu[1]))
        if v > 0 and math.log(u) < 0.5 * x * x + d - d * v + d * math.log(v):
            return t + 1
    return draws.GAMMA_ATTEMPTS


def _recording_advance(graph, owner=None, name="make_slot_advance"):
    """A stand-in for ``owner.name`` (``slot_step.make_slot_advance`` by
    default) with ``graph`` set, and the advances it made."""
    if owner is None:
        from mdtpu_torch.integrate import slot_step as owner
    real, made = getattr(owner, name), []

    def make(*args, **kwargs):
        advance = real(*args, graph=graph, **kwargs)
        made.append(advance)
        return advance

    return real, make, made


def routes_run(graph, fn, census=None, owner=None,
               name="make_slot_advance"):
    """``fn()`` with every slot advance the driver makes on route
    ``graph`` (False: eager; None: captured); returns ``(fn's result, the
    rebuild steps of its advances, seconds)``. ``census``: a list to which
    each captured advance's step graphs' nodes are added. ``owner.name``:
    the maker the driver calls (``slot_step.make_slot_advance`` by
    default)."""
    if owner is None:
        from mdtpu_torch.integrate import slot_step as owner
    real, make, made = _recording_advance(graph, owner, name)
    setattr(owner, name, make)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        setattr(owner, name, real)
    if any(a.graph is not bool(graph is None) for a in made):
        raise RuntimeError("an advance took the other route")
    if census is not None:
        census += [a.census for a in made]
    return out, [s for a in made for s in a.rebuild_steps()], seconds


def graph_paths(mt, workdir):
    """The bench (600 NVT + 500 NVE on hi/lo), Brownian in slots (200
    steps) and the 2D path (600 NVT + 200 NVE), each from one start on the
    eager route and on the captured one (the default): positions,
    velocities, every thermo row and the rebuild steps equal bit for bit;
    steps/s of both. Then one NVT and one NVE segment of the bench's slot
    advance on each route through ``profile_torch_step.measure``: host ms,
    device busy ms and the idle share (captured: the device's span by CUDA
    events instead), launches, graph launches and host reads a step, and
    the nodes of each captured step (one for the drift test,
    one for the velocity finish, no memset)."""
    from mdtpu_torch.integrate import slot_step
    from profile_torch_step import measure

    lj = mt.LennardJones(r_cut=2.5)
    bench = mt.Parameters(density=0.8, n_particles=N_BENCH, dt=0.002,
                          potential=lj)
    bd = mt.Parameters(density=0.5, n_particles=N_BENCH, dt=1e-5,
                       potential=mt.PseudoHS())
    p2d = mt.Parameters(density=RHO_2D, n_particles=N_BENCH, dt=0.001,
                        potential=mt.PseudoHS())

    def legs(start, params, nvt, n_nvt, n_nve, label):
        def run():
            out = os.path.join(workdir, label)
            mid = mt.run_simulation(start(), params, nvt, n_nvt,
                                    THERMO_EVERY, os.path.join(out, "nvt"),
                                    traj_frequency=TRAJ_EVERY)
            if not n_nve:
                return mid, [os.path.join(out, "nvt")]
            end = mt.run_simulation(mid, params, mt.NVE(), n_nve,
                                    THERMO_EVERY, os.path.join(out, "nve"),
                                    traj_frequency=TRAJ_EVERY)
            return end, [os.path.join(out, "nvt"), os.path.join(out, "nve")]
        return run

    cases = {
        "bench": (lambda: lattice_start(), bench, mt.NVT(1.0, 0.4),
                  NVT_STEPS, NVE_STEPS),
        "brownian_slot": (brownian_state, bd, mt.Brownian(1.0),
                          BROWNIAN_STEPS, 0),
        "2d": (lambda: state_2d(mt, torch.float32), p2d, mt.NVT(1.0, 0.1),
               GEO_NVT_STEPS, GEO_NVE_STEPS),
    }
    failures, rec = [], {}
    for name, (start, params, nvt, n_nvt, n_nve) in cases.items():
        runs, census = {}, []
        for route, graph in (("eager", False), ("graph", None)):
            (end, dirs), rebuilds, seconds = routes_run(
                graph, legs(start, params, nvt, n_nvt, n_nve,
                            f"graph_{name}_{route}"),
                census if graph is None else None)
            thermo = []
            for d in dirs:
                with open(os.path.join(d, "thermo.txt")) as f:
                    thermo.append(f.read())
            runs[route] = (end, thermo, rebuilds,
                           (n_nvt + n_nve) / seconds)
        (e_end, e_rows, e_reb, e_rate), (g_end, g_rows, g_reb, g_rate) = (
            runs["eager"], runs["graph"])
        same = {f: torch.equal(getattr(e_end, f), getattr(g_end, f))
                for f in ("positions", "velocities", "images", "forces")}
        if not (all(same.values()) and e_rows == g_rows and e_reb == g_reb
                and e_end.step == g_end.step == n_nvt + n_nve):
            failures.append(f"graph {name}: the routes differ: {same}, "
                            f"rows equal {e_rows == g_rows}, rebuilds "
                            f"{len(e_reb)} vs {len(g_reb)}")
        if not e_reb:
            failures.append(f"graph {name}: no rebuild in the run")
        # Each captured step takes its velocity finish (MD) or its update
        # (Brownian, which draws the noise) by a programmatic edge from the
        # kernel before it.
        into = ("programmatic_into_brownian_update"
                if name == "brownian_slot"
                else "programmatic_into_velocity_finish")
        edges = [{v: (nodes[into], nodes["programmatic_edges"],
                      nodes["edges_error"]) for v, nodes in c.items()}
                 for c in census]
        if not census or any(e != (1, 1, 0) for c in edges
                             for e in c.values()):
            failures.append(f"graph {name}: programmatic edges {edges}")
        # A captured Brownian step: the drift test, the IF node, B1 (its
        # energy and virial summed in its last block) and the update, no
        # copy, no memset, no noise kernel.
        if name == "brownian_slot" and any(
                nodes["nodes"] > 5 or nodes["copies"] or nodes["memsets"]
                or nodes["brownian_update"] != 1 or nodes["uniform_noise"]
                for c in census for nodes in c.values()):
            failures.append(f"graph {name}: step nodes {census}")
        rec[name] = {"steps": n_nvt + n_nve, "rebuilds": len(g_reb),
                     "steps_per_s_eager": e_rate,
                     "steps_per_s_graph": g_rate,
                     "programmatic_edges": edges,
                     "step_nodes": [{v: {k: nodes[k] for k in (
                         "nodes", "kernels", "copies", "memsets")}
                         for v, nodes in c.items()} for c in census]}
        log(json.dumps({"graph_path": name, **rec[name]}))

    # One segment of the bench's slot advance on each route, NVT and then
    # NVE (hi/lo, as run_simulation takes float32 NVE), from the melted
    # bench fluid in slots, in turns (eager, graph, graph, eager), with the
    # nodes of each captured step variant read from its graph.
    st = as_dtype(melted_state(mt), torch.float32)
    eng = mt.select_engine(lj, 2.5, st)
    slots = slot_step.slot_forces(slot_step.slotify(st, eng), eng)
    rec["segment_profile"] = {}
    for ens_name, ensemble, hilo in (("nvt", mt.NVT(1.0, 0.4), False),
                                     ("nve", mt.NVE(), True)):
        profiles = {"eager": [], "graph": []}
        census = None
        for route in ("eager", "graph", "graph", "eager"):
            advance = slot_step.make_slot_advance(
                bench, ensemble, eng, hilo=hilo,
                graph=False if route == "eager" else None)
            _, metrics = measure(advance, slots,
                                 looped=lambda: bool(advance.graph))
            metrics.pop("top_device_kernels")
            profiles[route].append(metrics)
            if route == "graph":
                census = advance.census
        for route, ms in profiles.items():
            log(json.dumps({"graph_segment_profile": route,
                            "ensemble": ens_name, "turns": ms}))
        log(json.dumps({"graph_step_nodes": ens_name, **census}))
        # A captured segment is one graph launch a step variant (the lean
        # steps' WHILE node, the full last step's).
        if any(m["host_syncs_per_step"] or round(
                m["graph_launches_per_step"] * m["profiled_steps"]) != 2
               for m in profiles["graph"]):
            failures.append(f"graph {ens_name}: host reads or graph "
                            f"launches inside a captured segment "
                            f"{profiles['graph']}")
        # One node each for the drift test (no memset, no kernel copying
        # the flag into the handle) and the velocity finish; the rebuild
        # in one conditional node.
        # The Verlet chain: kick-drift, kick and NVT's rescale, one node
        # each; the lean step at most 8 nodes (NVT) or 7 (NVE), none of
        # them a copy into the buffers.
        chain = 3 if ens_name == "nvt" else 2
        for variant, nodes in census.items():
            if (nodes["rebuild_flag"], nodes["velocity_finish"],
                    nodes["bussi_draw"], nodes["memsets"],
                    nodes["conditionals"], nodes["if_dependencies"],
                    nodes["if_root_kernels"], nodes["unreadable"],
                    nodes["programmatic_into_velocity_finish"],
                    nodes["edges_error"], nodes["verlet_update"]) != (
                        1, 1, 0, 0, 1, 1, 1, 0, 1, 0, chain):
                failures.append(f"graph {ens_name} {variant} step nodes: "
                                f"{nodes}")
        # The full last step: the same nodes as the lean one (its sweep
        # sums energy and virial into the buffers in its last block), no
        # copy.
        lean, last = census["lean"], census["last"]
        if lean["copies"] or lean["nodes"] > chain + 5:
            failures.append(f"graph {ens_name} lean step: {lean['nodes']} "
                            f"nodes, {lean['copies']} copies")
        if last["copies"] or last["nodes"] != lean["nodes"]:
            failures.append(f"graph {ens_name} last step: {last['nodes']} "
                            f"nodes, {last['copies']} copies")
        rec["segment_profile"][ens_name] = {"profiles": profiles,
                                            "nodes": census}
    return rec, failures


def sharded_graph_paths(mt, workdir):
    """On a one-rank NCCL group of its own: the bench (600 NVT + 500 NVE
    on hi/lo) through ``run_simulation_sharded`` from one start on the
    eager sharded advance (``graph=False``, one host read a lean step) and
    the captured one (the default): positions, velocities, images, forces,
    every thermo row and the rebuild steps bit for bit, steps/s of both;
    each captured step variant's nodes (the lean step: the drift test, the
    vote's kernel and one IF node holding the rebuild; the full last step
    its rebuild inline, no IF node); one NVT segment of the sharded advance
    profiled on each route in turns (eager, graph, graph, eager) through
    ``profile_torch_step.measure``: host ms, the device's span by CUDA
    events, graph launches and host reads a step (captured: two graph
    launches a segment, none of them read). Then the sharded FIRE
    (``make_slot_fire(..., ring=)``) on ``bench_fire.py``'s system, 200
    iterations at tol 0, eager and captured from one start: positions,
    FIRE's velocities, forces, energy, virial, n_steps and the rebuild
    steps bit for bit, iterations/s both ways, and the census of a captured
    minimization (one graph launch, the one read of its result, the WHILE
    body's nodes, one IF node in it)."""
    import mdtpu_torch.parallel.driver as driver_mod
    from mdtpu_torch.minimize import fire as fire_mod
    from mdtpu_torch.parallel.driver import build_grown, sharded_engine
    from mdtpu_torch.parallel.halo_slot import make_sharded_slot_advance
    from mdtpu_torch.sim.initialization import lattice_fluid_state
    from profile_torch_step import measure

    lj = mt.LennardJones(r_cut=2.5)
    bench = mt.Parameters(density=0.8, n_particles=N_BENCH, dt=0.002,
                          potential=lj)
    failures, rec = [], {}

    def legs(label):
        def run():
            out = os.path.join(workdir, label)
            mid = mt.run_simulation_sharded(
                lattice_start(), bench, mt.NVT(1.0, 0.4), NVT_STEPS,
                THERMO_EVERY, os.path.join(out, "nvt"),
                traj_frequency=TRAJ_EVERY)
            end = mt.run_simulation_sharded(
                mid, bench, mt.NVE(), NVE_STEPS, THERMO_EVERY,
                os.path.join(out, "nve"), traj_frequency=TRAJ_EVERY)
            return end, [os.path.join(out, d) for d in ("nvt", "nve")]
        return run

    dist = nccl_group(workdir, "nccl_store_graph")
    try:
        runs, census = {}, []
        for route, graph in (("eager", False), ("graph", None)):
            (end, dirs), rebuilds, seconds = routes_run(
                graph, legs(f"sharded_graph_{route}"),
                census if graph is None else None, owner=driver_mod,
                name="make_sharded_slot_advance")
            thermo = []
            for d in dirs:
                with open(os.path.join(d, "thermo.txt")) as f:
                    thermo.append(f.read())
            runs[route] = (end, thermo, rebuilds,
                           (NVT_STEPS + NVE_STEPS) / seconds)
        (e_end, e_rows, e_reb, e_rate), (g_end, g_rows, g_reb, g_rate) = (
            runs["eager"], runs["graph"])
        same = {f: torch.equal(getattr(e_end, f), getattr(g_end, f))
                for f in ("positions", "velocities", "images", "forces")}
        if not (all(same.values()) and e_rows == g_rows and e_reb == g_reb
                and e_end.step == g_end.step == NVT_STEPS + NVE_STEPS):
            failures.append(f"sharded graph: the routes differ: {same}, "
                            f"rows equal {e_rows == g_rows}, rebuilds "
                            f"{len(e_reb)} vs {len(g_reb)}")
        if len(e_reb) <= 4:
            failures.append(f"sharded graph: rebuilds {e_reb}")
        keys = ("nodes", "kernels", "copies", "memsets", "conditionals",
                "rebuild_flag", "rebuild_vote", "velocity_finish",
                "verlet_update")
        nodes = [{v: {k: n[k] for k in keys} for v, n in c.items()}
                 for c in census]
        # The lean step tests, votes and rebuilds in an IF node; the full
        # last step rebuilds without a test. (Its one memset is torch's,
        # for the kinetic energy's sum before the ring's all-reduce.)
        if not census or any(
                (c["lean"]["rebuild_flag"], c["lean"]["rebuild_vote"],
                 c["lean"]["conditionals"], c["last"]["rebuild_flag"],
                 c["last"]["rebuild_vote"], c["last"]["conditionals"])
                != (1, 1, 1, 0, 0, 0) for c in nodes):
            failures.append(f"sharded graph: step nodes {nodes}")
        rec["bench"] = {"steps": NVT_STEPS + NVE_STEPS,
                        "rebuilds": len(g_reb), "steps_per_s_eager": e_rate,
                        "steps_per_s_graph": g_rate, "step_nodes": nodes}
        rec["census"] = nodes[0] if nodes else {}
        log(json.dumps({"sharded_graph_path": "bench", **rec["bench"]}))

        # One NVT segment on each route, in turns, from the bench's start
        # in the sharded layout.
        start = lattice_start()
        engine = sharded_engine(start, lj, None, None, None)
        sh, engine = build_grown(start, engine)
        profiles = {"eager": [], "graph": []}
        for route in ("eager", "graph", "graph", "eager"):
            advance = make_sharded_slot_advance(
                bench, mt.NVT(1.0, 0.4), engine,
                graph=False if route == "eager" else None)
            _, metrics = measure(advance, sh,
                                 looped=lambda: bool(advance.graph))
            metrics.pop("top_device_kernels")
            profiles[route].append(metrics)
        log(json.dumps({"sharded_segment_profile": profiles}))
        if any(m["host_syncs_per_step"] or round(
                m["graph_launches_per_step"] * m["profiled_steps"]) != 2
               for m in profiles["graph"]):
            failures.append(f"sharded graph: host reads or graph launches "
                            f"inside a captured segment "
                            f"{profiles['graph']}")
        rec["segment_profile"] = profiles

        # The sharded FIRE, eager and captured, from one start.
        fstart = lattice_fluid_state(N_BENCH, 0.8, 1.0, dtype=torch.float32,
                                     cutoff=2.5, jitter=0.05, device="cuda")
        fengine = sharded_engine(fstart, lj, None, None, None)
        fsh, fengine = build_grown(fstart, fengine)
        fire_runs = {}
        for route, graph in (("eager", False), ("graph", None)):
            run = fire_mod.make_slot_fire(
                fengine, ring=fengine.ring, max_steps=N_FIRE_GRAPH, tol=0.0,
                graph=graph, cached=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _, conv, n, ovf = run(fsh)
            torch.cuda.synchronize()
            fire_runs[route] = (st, n, ovf, run.fire.rebuild_steps(),
                                time.perf_counter() - t0, run)
        (e_st, e_n, e_ovf, e_rb, e_s, _), (g_st, g_n, g_ovf, g_rb, g_s,
                                           g_run) = (fire_runs["eager"],
                                                     fire_runs["graph"])
        same = {f: torch.equal(getattr(e_st, f), getattr(g_st, f))
                for f in ("positions", "velocities", "forces", "energy",
                          "virial")}
        if not (all(same.values()) and e_n == g_n == N_FIRE_GRAPH
                and e_rb == g_rb and len(g_rb) > 1 and not g_ovf
                and g_run.fire.captured is not None):
            failures.append(f"sharded fire graph: the routes differ: "
                            f"{same}, n {e_n} vs {g_n}, rebuilds "
                            f"{len(e_rb)} vs {len(g_rb)}, overflow {g_ovf}")
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            g_run(fsh)
            torch.cuda.synchronize()
        avgs = prof.key_averages()

        def count(*names):
            return sum(e.count for e in avgs if e.key in names)

        fire = g_run.fire
        fire_census = {
            "graph_launches": count("cudaGraphLaunch"),
            "host_reads": count("cudaStreamSynchronize",
                                "cudaEventSynchronize"),
            "pass_nodes": {k: fire.census["pass"][k] for k in (
                "nodes", "kernels", "copies", "memsets", "conditionals",
                *FIRE_EDGES)},
            "graph_nodes": {k: fire.census["graph"][k] for k in (
                "nodes", "kernels", "copies", "memsets", "conditionals")},
            "rebuilds": len(fire.rebuild_steps())}
        if (fire_census["graph_launches"] != 1
                or fire_census["host_reads"] != 1
                or fire_census["pass_nodes"]["conditionals"] != 1
                or fire_census["pass_nodes"][
                    "programmatic_into_fire_move"] < 1):
            failures.append(f"sharded fire graph: census {fire_census}")
        rec["fire"] = {"iterations": g_n, "rebuilds": len(g_rb),
                       "rebuild_steps": g_rb[:64],
                       "iterations_per_s_graph": g_n / g_s,
                       "iterations_per_s_eager": e_n / e_s,
                       "census": fire_census}
        log(json.dumps({"sharded_fire_graph_path": rec["fire"]}))
    finally:
        dist.destroy_process_group()
    return rec, failures


USER_GRAPH_KEYS = ("nodes", "kernels", "copies", "memsets", "conditionals",
                   "rebuild_flag", "rebuild_vote", "velocity_finish",
                   "verlet_update", "fire_reduce", "fire_test")


def _nodes(census):
    """The keys of USER_GRAPH_KEYS a census holds."""
    return {k: census[k] for k in USER_GRAPH_KEYS if k in census}


def _fire_census(run, start):
    """One more run of ``run`` (a captured FIRE) from ``start`` under
    ``torch.profiler``: its graph launches and host reads, and its
    graph's and WHILE body's nodes."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(start)
        torch.cuda.synchronize()
    avgs = prof.key_averages()

    def count(*names):
        return sum(e.count for e in avgs if e.key in names)

    fire = run.fire
    return {"graph_launches": count("cudaGraphLaunch"),
            "host_reads": count("cudaStreamSynchronize",
                                "cudaEventSynchronize"),
            "graph_nodes": _nodes(fire.census["graph"]),
            "pass_nodes": _nodes(fire.census["pass"])}


def _fire_both_ways(make, start, label, failures):
    """FIRE eager (``graph=False``) and captured from ``start``: the state,
    f_rms, iterations and rebuild steps bit for bit; iterations/s both
    ways, the captured one's first call (the capture paid) and a second
    (a replay, its result the first's), the capture's seconds, its
    census and the peak memory after it."""
    runs = {}
    for route, graph in (("eager", False), ("graph", None), ("again", None)):
        if route != "again":
            run = make(graph)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, f_rms, _, n, ovf = run(start)
        torch.cuda.synchronize()
        runs[route] = (st, f_rms, n, ovf, run.fire.rebuild_steps(),
                       time.perf_counter() - t0)
    (e, ef, en, eo, er, es), (g, gf, gn, go, gr, gs) = (runs["eager"],
                                                         runs["graph"])
    a, af, an, _, ar, as_ = runs["again"]
    fields = ("positions", "velocities", "forces", "energy", "virial")
    same = {f: torch.equal(getattr(e, f), getattr(g, f))
            and torch.equal(getattr(g, f), getattr(a, f)) for f in fields}
    if not (all(same.values()) and torch.equal(ef, gf)
            and torch.equal(gf, af) and en == gn == an == N_FIRE_GRAPH
            and er == gr == ar and not eo and not go
            and run.fire.captured is not None):
        failures.append(f"{label}: the routes differ: {same}, n {en} vs "
                        f"{gn} vs {an}, rebuilds {len(er)} vs {len(gr)} vs "
                        f"{len(ar)}, overflow {eo} {go}")
    census = _fire_census(run, start)
    if census["graph_launches"] != 1 or census["host_reads"] != 1:
        failures.append(f"{label}: census {census}")
    return {"iterations": gn, "rebuilds": len(gr), "f_rms": float(gf),
            "iterations_per_s_eager": en / es,
            "iterations_per_s_graph_first_call": gn / gs,
            "iterations_per_s_graph_replay": an / as_,
            "capture_s": gs - as_, "census": census,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def user_graph_paths(mt, workdir, kept):
    """BASELINE config 4 at 65,536 (f64, the pair list) on the captured
    route against ``graph=False``, as the JAX package runs a user's
    potential inside its jitted loops. ``kept``: the user path's NVT start
    (its minimized state) and parameters. On one device: the user path's
    NVT (USER_NVT_STEPS in 3 segments through ``run_simulation``) on both
    routes, positions, velocities, images, forces, energy, virial, every
    thermo row and the rebuild steps bit for bit, steps/s both ways; then
    from the slotified start an NVT and an NVE segment of the slot advance
    on each route in turns (eager, graph, graph, eager) through
    ``profile_torch_step.measure``: host ms, the device's span by CUDA
    events, graph launches and host reads a step (captured: two graph
    launches a segment, no read), the two routes' end states bit for bit,
    each captured variant's nodes, and the capture's seconds (a fresh
    advance's first segment less its second); the slot FIRE from the XYZ
    start (N_FIRE_GRAPH iterations at USER_DMAX, tol 0) eager against
    captured (:func:`_fire_both_ways`). Then on a one-rank NCCL group of
    its own the same NVT through ``run_simulation_sharded`` and the
    sharded FIRE. Peak memory after each part, beside the card's name and
    power limit."""
    import mdtpu_torch.parallel.driver as driver_mod
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.minimize import fire as fire_mod
    from mdtpu_torch.parallel.driver import build_grown, sharded_engine
    from profile_torch_step import measure

    failures, rec = [], {"card": nvidia_smi_line()}
    if "nvt_start" not in kept:
        return rec, ["user graph: the user path left no NVT start"]
    start, params = kept["nvt_start"], kept["params"]
    torch.cuda.reset_peak_memory_stats()
    nvt = mt.NVT(0.5, 0.01)

    def legs(run_fn, label):
        def run():
            out = os.path.join(workdir, label)
            end = run_fn(start, params, nvt, USER_NVT_STEPS, THERMO_EVERY,
                         out, traj_frequency=USER_NVT_STEPS)
            return end, out
        return run

    def both_routes(run_fn, label, owner=None, name="make_slot_advance"):
        runs, census = {}, []
        for route, graph in (("eager", False), ("graph", None)):
            (end, out), rebuilds, seconds = routes_run(
                graph, legs(run_fn, f"user_graph_{label}_{route}"),
                census if graph is None else None, owner=owner, name=name)
            with open(os.path.join(out, "thermo.txt")) as f:
                rows = f.read()
            runs[route] = (end, rows, rebuilds, USER_NVT_STEPS / seconds)
        (e, e_rows, e_reb, e_rate), (g, g_rows, g_reb, g_rate) = (
            runs["eager"], runs["graph"])
        same = {f: torch.equal(getattr(e, f), getattr(g, f))
                for f in ("positions", "velocities", "images", "forces",
                          "energy", "virial")}
        if not (all(same.values()) and e_rows == g_rows and e_reb == g_reb
                and e.step == g.step == start.step + USER_NVT_STEPS):
            failures.append(f"user graph {label}: the routes differ: "
                            f"{same}, rows equal {e_rows == g_rows}, "
                            f"rebuilds {len(e_reb)} vs {len(g_reb)}")
        out = {"steps": USER_NVT_STEPS, "segments": 3,
               "rebuilds": len(g_reb), "steps_per_s_eager": e_rate,
               "steps_per_s_graph": g_rate,
               "step_nodes": [{v: _nodes(n) for v, n in c.items()}
                              for c in census],
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        log(json.dumps({"user_graph_path": label, **out}))
        return out

    rec["nvt"] = both_routes(mt.run_simulation, "nvt")

    # Segments of the slot advance, NVT then NVE, each route in turns.
    eng = mt.select_engine(params.potential, CUTOFF_USER, start)
    slots, eng = slot_step.slotify_grown(start.replace(nbrs=None), eng)
    slots = slot_step.slot_forces(slots, eng)
    rec["segments"] = {}
    for ens_name, ensemble in (("nvt", nvt), ("nve", mt.NVE())):
        profiles, ends, census = {"eager": [], "graph": []}, {}, None
        for route in ("eager", "graph", "graph", "eager"):
            advance = slot_step.make_slot_advance(
                params, ensemble, eng,
                graph=False if route == "eager" else None)
            end, metrics = measure(advance, slots,
                                   looped=lambda: bool(advance.graph))
            metrics.pop("top_device_kernels")
            profiles[route].append(metrics)
            ends.setdefault(route, end)
            if route == "graph":
                census = {v: _nodes(n) for v, n in advance.census.items()}
        same = {f: torch.equal(getattr(ends["eager"], f),
                               getattr(ends["graph"], f))
                for f in ("positions", "velocities", "forces", "energy",
                          "virial")}
        if not all(same.values()):
            failures.append(f"user graph {ens_name} segments: the routes "
                            f"differ: {same}")
        if any(m["host_syncs_per_step"] or round(
                m["graph_launches_per_step"] * m["profiled_steps"]) != 2
               for m in profiles["graph"]):
            failures.append(f"user graph {ens_name}: host reads or graph "
                            f"launches inside a captured segment "
                            f"{profiles['graph']}")
        # The capture's seconds: a fresh advance's first segment (both
        # variants captured) less its second.
        advance = slot_step.make_slot_advance(params, ensemble, eng)
        times, s = [], slots
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = advance(s, 3)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rec["segments"][ens_name] = {
            "profiles": profiles, "nodes": census,
            "capture_s": times[0] - times[1], "first_segment_s": times[0],
            "second_segment_s": times[1],
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        log(json.dumps({"user_graph_segments": ens_name,
                        **rec["segments"][ens_name]}))
    del slots, advance

    # The slot FIRE from the XYZ start.
    fstart, fparams = user_start(mt, os.path.join(workdir, "user_graph"))
    feng = mt.select_engine(fparams.potential, CUTOFF_USER, fstart,
                            workload="minimize")
    fslots, feng = slot_step.slotify_grown(fstart, feng)
    rec["fire"] = _fire_both_ways(
        lambda graph: fire_mod.make_slot_fire(
            feng, max_steps=N_FIRE_GRAPH, tol=0.0, dmax=USER_DMAX,
            graph=graph, cached=False), fslots, "user graph fire", failures)
    log(json.dumps({"user_graph_fire": rec["fire"]}))
    del fslots

    # The sharded route on a one-rank NCCL group of its own.
    dist = nccl_group(workdir, "nccl_store_user_graph")
    try:
        rec["sharded_nvt"] = both_routes(
            mt.run_simulation_sharded, "sharded_nvt", owner=driver_mod,
            name="make_sharded_slot_advance")
        sengine = sharded_engine(fstart, fparams.potential, None, None,
                                 None)
        ssh, sengine = build_grown(fstart.replace(nbrs=None), sengine)
        rec["sharded_fire"] = _fire_both_ways(
            lambda graph: fire_mod.make_slot_fire(
                sengine, ring=sengine.ring, max_steps=N_FIRE_GRAPH, tol=0.0,
                dmax=USER_DMAX, graph=graph, cached=False), ssh,
            "user graph sharded fire", failures)
        log(json.dumps({"user_graph_sharded_fire": rec["sharded_fire"]}))
    finally:
        dist.destroy_process_group()
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return rec, failures


def lattice_start():
    """The bench's lattice start (jitter 0.01, f32) on the card."""
    from mdtpu_torch.sim.initialization import lattice_fluid_state
    return lattice_fluid_state(N_BENCH, 0.8, 1.0, dtype=torch.float32,
                               cutoff=2.5, jitter=0.01, device="cuda")


FIRE_SOURCE = "mdtpu_torch/csrc/fire_update.cu"
FIRE_REPLACES = {"fire_reduce": "mdtpu/minimize/fire.py:323",
                 "fire_move": "mdtpu/minimize/fire.py:355",
                 "fire_test": "mdtpu/minimize/fire.py:299"}
FIRE_COVERS = {
    "fire_reduce": ("mdtpu/minimize/fire.py:325-353 fire_step's kick, "
                    "maxima, max-scaled sums and scalar tail (:179-204 in "
                    "particle order; XLA inside the while_loop, no "
                    "pl.pallas_call)"),
    "fire_move": ("mdtpu/minimize/fire.py:355-367 the mix, the capped "
                  "displacement and the move (:209-217 in particle order, "
                  "with the wrap; XLA)"),
    "fire_test": ("mdtpu/minimize/fire.py:299-302 g_f_rms and the "
                  "while_loop's cond (:386-410, :171-172; XLA)")}
FIRE_TOL = {torch.float64: 1e-12, torch.float32: 2e-6}
# The kernel check's cases: the power positive, negative, positive past
# n_min with ~1e25 forces and dt clamped at dt_max, v = F = 0, and the
# sticky overflow flag set.
FIRE_CASES = ("positive", "negative", "grow", "rest", "overflow")
# Arrays of the (d, S) or (N, d) shape each kernel reads or writes once:
# fire_reduce reads v and F; fire_move reads x, v and F and writes x and v
# (rows also read and write the int64 images); fire_test reads F.
FIRE_ARRAYS = {"fire_reduce": 2, "fire_move": 5, "fire_test": 1}
# Operations a value: the kick (2), two abs and maxima (4), two divisions,
# three products and three sums (8) in fire_reduce; the kick and the mix
# (6), disp (1), the norm's max, division, square and sum (4), the cap's
# product and the add (2) in fire_move; abs, max, division, square and sum
# in fire_test (5).
OPS_FIRE_VALUE = {"fire_reduce": 14, "fire_move": 13, "fire_test": 5}
# The fire graph phase: name: (engine kind, system, [(max_steps, tol)]).
FIRE_SYSTEMS = {
    "bench_fire": ("slots", "lattice", [(N_FIRE_DESCENT, 0.0),
                                        (N_FIRE_ITERS, 0.0)]),
    "pack": ("slots", "pack", [(2000, 1e-10)]),
    "plane": ("plane", "lattice", [(N_FIRE_ITERS, 0.0)]),
    "list": ("neighbor", "lattice", [(N_FIRE_ITERS, 0.0)]),
}


# The two reductions' times in their earlier design (a plain launch,
# blocks of 2,048 values, two block reductions, the tail on one thread from
# device memory; a graph of 100 in-place calls, f32, on an H100 80GB HBM3
# at 700 W), logged beside this tree's in the FIRE phase's lines; not in
# the kernels line, which holds only what this run measured.
FIRE_EARLIER_MS = {("fire_reduce", "slots"): 0.00758,
                   ("fire_reduce", "rows"): 0.00536,
                   ("fire_test", "slots"): 0.00827,
                   ("fire_test", "rows"): 0.00567}
# The programmatic edges a FIRE census reads (the graph's, and those into
# the two reductions).
FIRE_EDGES = ("programmatic_edges", "programmatic_into_fire_reduce",
              "programmatic_into_fire_test", "programmatic_into_fire_move",
              "edges_error", "fire_edges_error")
# Views of v and F for the edge checks: offsets in values into a larger
# tensor (both misaligned alike: a scalar head; apart: scalar loads).
FIRE_ALIGNS = {"aligned": (0, 0), "head": (1, 1), "apart": (1, 2)}


def fire_bound(name, shape, dtype, images=False):
    """The least time of one call of FIRE kernel ``name`` on values of
    ``shape`` in ``dtype``: its arrays read and written once (the images
    too where it wraps), or its operations at the card's rate."""
    n = math.prod(shape)
    size = torch.finfo(dtype).bits // 8
    nbytes = FIRE_ARRAYS[name] * n * size + (2 * n * 8 if images else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_FIRE_VALUE[name] * n / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def move_hbm_ms(fu, hyper, arrays, box, scal, ints, rows, replays=20,
                rounds=5):
    """Device ms of one ``fire_move`` whose arrays come from memory, not
    the L2: a CUDA graph of one call on each of enough copies of its
    arrays (F, v, x; rows also the images) to hold twice the L2 (50 MB on
    the H100), in turn, replayed ``replays`` times between two CUDA
    events and divided by the calls; the median of ``rounds``. Returns
    ``(ms, copies)``."""
    f, v, x = arrays
    per_copy = sum(t.numel() * t.element_size() for t in arrays) + (
        box["images"].numel() * 8 if rows else 0)
    sets = max(2, math.ceil(2 * L2_BYTES / per_copy))
    copies = [[t.clone() for t in arrays]
              + [box["images"].clone() if rows else None]
              for _ in range(sets)]
    extra = dict(cell=box["cell"], cell_inv=box["cell_inv"]) if rows else {}

    def call(c):
        fu.fire_move(c[2], c[1], c[0], scal, ints, hyper.dmax, rows=rows,
                     images=c[3], **extra)
    for c in copies:
        call(c)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in copies:
            call(c)
    ms = statistics.median(cuda_time_ms(graph.replay, replays, 2) / sets
                           for _ in range(rounds))
    return ms, sets


def fire_edge_check(fu, hyper, ring, copies, rel_each):
    """The two reductions at the grid's edges (``fire_update.edge_counts``),
    f32 and f64, in every case of :data:`FIRE_CASES` and on every view of
    :data:`FIRE_ALIGNS`: one pass and the ring's split against the plain
    versions (rel 1e-12 / 2e-6; counters and flags equal), each twice bit
    for bit. Returns ``(record, failures)``."""
    failures, worst = [], {}
    for dtype in (torch.float32, torch.float64):
        tol, tag = FIRE_TOL[dtype], str(dtype)[6:]
        for n, align, case in itertools.product(
                fu.edge_counts(dtype), FIRE_ALIGNS, FIRE_CASES):
            g = torch.Generator(device="cuda").manual_seed(n)
            f = torch.randn(n + 2, device="cuda", generator=g) * 30.0
            v = torch.randn(n + 2, device="cuda", generator=g)
            if case == "grow":
                f = f * (1e25 / 30.0)
            v = -v - 0.05 * f if case == "negative" else v + 0.01 * f
            if case == "rest":
                v, f = torch.zeros_like(v), torch.zeros_like(f)
            of, ov = FIRE_ALIGNS[align]
            f, v = f.to(dtype)[of:of + n], v.to(dtype)[ov:ov + n]
            bufs = fu.buffers(dtype, "cuda", n)
            bufs[0][fu.DT] = 0.09 if case == "grow" else 0.03
            bufs[0][fu.ALPHA], bufs[0][fu.TOL] = 0.07, 1e-3
            bufs[1][fu.SSN] = 7 if case == "grow" else 2
            bufs[1][fu.MAX_STEPS] = 10
            over = torch.tensor(case == "overflow", device="cuda")
            p = copies(bufs)
            fu.fire_reduce_plain(v, f, p[0], p[1], p[2][:fu.RED], hyper,
                                 over)
            errs, same = {}, True
            for label, modes in (("reduce", (fu.ONE_PASS,)),
                                 ("reduce_ring", ring)):
                k, k2 = copies(bufs), copies(bufs)
                for t in (k, k2):
                    for mode in modes:
                        fu.fire_reduce(v, f, t[0], t[1], t[2][:fu.RED], t[3],
                                       hyper, over, mode=mode)
                errs[label] = max(rel_each(k[0], p[0]),
                                  rel_each(k[2][:fu.RED], p[2][:fu.RED]))
                same &= (torch.equal(k[1], p[1]) and torch.equal(k[0], k2[0])
                         and torch.equal(k[1], k2[1])
                         and torch.equal(k[2], k2[2]))
            tp = copies(p)
            fu.fire_test_plain(f, tp[0], tp[1], tp[2][fu.RED:], 17.0, tp[4],
                               overflow=over)
            for label, modes in (("test", (fu.ONE_PASS,)),
                                 ("test_ring", ring)):
                k, k2 = copies(p), copies(p)
                for t in (k, k2):
                    for mode in modes:
                        fu.fire_test(f, t[0], t[1], t[2][fu.RED:], t[3], 17.0,
                                     t[4], overflow=over, mode=mode)
                errs[label] = rel_each(k[0], tp[0])
                same &= (torch.equal(k[1], tp[1]) and torch.equal(k[4], tp[4])
                         and torch.equal(k[0], k2[0])
                         and torch.equal(k[1], k2[1]))
            worst[tag] = max(worst.get(tag, 0.0), max(errs.values()))
            if not same or max(errs.values()) > tol:
                failures.append(f"fire edges {tag} n {n} {align} {case}: "
                                f"errors {errs}, counters, flags and repeats "
                                f"equal {same}")
    rec = {"counts": {str(d)[6:]: list(fu.edge_counts(d))
                      for d in (torch.float32, torch.float64)},
           "views": list(FIRE_ALIGNS), "cases": list(FIRE_CASES),
           "max_rel_err": worst, "failures": len(failures)}
    log(json.dumps({"fire_edges": rec}))
    return rec, failures


def fire_check(mt, probe_lib=None):
    """FIRE's three kernels (``minimize/fire_update.py``) against their
    plain versions on the card, at f32 and f64, in slots (the bench_fire
    cell grid's (3, 124,875)) and in particle rows ((65,536, 3), with the
    wrap), in each case of :data:`FIRE_CASES` (every branch of the tail,
    the one-pass rescaling of ~1e25 forces, the overflow guard): from one
    set of FIRE buffers, ``fire_reduce`` in one pass and split as the shard
    ring launches it (every scalar and the reductions to rel 1e-12 at f64,
    2e-6 at f32, do_mix, positive and the step counters equal),
    ``fire_move`` on the plain reduction's scalars (positions, velocities
    and images bit for bit, launched plain and as a programmatic dependent
    of a reduction), ``fire_test`` in one pass and split (f_rms to the same,
    the step, the flags and converged equal); each kernel twice on the
    same inputs bit for bit. The two reductions also at each count of
    ``fire_update.edge_counts``, in every case, on each view of
    :data:`FIRE_ALIGNS`, one pass and split, the same way. Each timed by
    :func:`many_ms` (a graph of ``MANY_CALLS`` in-place calls, the
    positive case) at f32 and f64, its plain version the same way, beside
    the launch floor, its bound and ``vector_norm`` of F (the move: as a
    programmatic dependent, the package's launch, and in plain stream
    order, alone and after ``fire_reduce``), and logged beside the earlier
    design's times (:data:`FIRE_EARLIER_MS`);
    ``probe_lib`` (a future of ``probe_torch_fire.build_stamped``): the
    reductions' phases at f32 from its stamped copy."""
    from mdtpu_torch.minimize import fire_update as fu
    from mdtpu_torch.ops import philox_draws as draws
    hyper = fu.FireHyper()
    slots_shape = (3, BENCH_GEOMETRY[1] * math.prod(BENCH_GEOMETRY[0]))
    rows_shape = (N_BENCH, 3)
    failures, results, errors = [], {}, {}
    ring = (fu.MAXIMA, fu.SUMS, fu.TAIL)

    def inputs(shape, dtype, rows, case="positive"):
        g = torch.Generator(device="cuda").manual_seed(21)
        f = torch.randn(shape, device="cuda", generator=g) * 30.0
        v = torch.randn(shape, device="cuda", generator=g)
        x = torch.rand(shape, device="cuda", generator=g) * 40.0
        if case == "grow":
            f = f * (1e25 / 30.0)
        # v + dt F against F: positive, negative (v' = -r - 0.02 F).
        v = -v - 0.05 * f if case == "negative" else v + 0.01 * f
        if case == "rest":
            v, f = torch.zeros_like(v), torch.zeros_like(f)
        cell = torch.eye(3, device="cuda", dtype=dtype) * 40.3
        img = torch.zeros(shape, dtype=torch.int64, device="cuda")
        scal, ints, red, work, flags = fu.buffers(dtype, "cuda",
                                                  math.prod(shape))
        # grow: the steps since a negative power past n_min, dt * f_inc
        # past dt_max.
        scal[fu.DT] = 0.09 if case == "grow" else 0.03
        scal[fu.ALPHA], scal[fu.TOL] = 0.07, 1e-3
        ints[fu.SSN], ints[fu.MAX_STEPS] = (7 if case == "grow" else 2), 10
        # The box contiguous, as the FIRE loops hand it over.
        box = dict(images=img, cell=cell,
                   cell_inv=torch.linalg.inv(cell).contiguous()) \
            if rows else {}
        over = torch.tensor(case == "overflow", device="cuda")
        return ([t.to(dtype) for t in (f, v, x)], box,
                (scal, ints, red, work, flags), over)

    def copies(bufs):
        return tuple(t.clone() for t in bufs)

    def rel_err(a, b):
        """Arrays: the largest difference over the largest value."""
        a, b = a.double(), b.double()
        scale = max(float(b.abs().max()), 1e-300)
        return float((a - b).abs().max()) / scale

    def rel_each(a, b):
        """Scalars: the largest difference, each over its own value."""
        a, b = a.double(), b.double()
        return float(((a - b).abs() / b.abs().clamp(min=1e-300)).max())

    for layout, shape in (("slots", slots_shape), ("rows", rows_shape)):
        rows = layout == "rows"
        for dtype, case in itertools.product(
                (torch.float32, torch.float64), FIRE_CASES):
            tol = FIRE_TOL[dtype]
            key = f"{layout}_{str(dtype)[6:]}_{case}"
            (f, v, x), box, bufs, over = inputs(shape, dtype, rows, case)
            errs, same = {}, True
            # fire_reduce, in one pass and split, against the plain.
            p = copies(bufs)
            fu.fire_reduce_plain(v, f, p[0], p[1], p[2][:fu.RED], hyper,
                                 over)
            for label, modes in (("reduce", (fu.ONE_PASS,)),
                                 ("reduce_ring", ring)):
                k = copies(bufs)
                for mode in modes:
                    fu.fire_reduce(v, f, k[0], k[1], k[2][:fu.RED], k[3],
                                   hyper, over, mode=mode)
                errs[label] = max(rel_each(k[0], p[0]),
                                  rel_each(k[2][:fu.RED], p[2][:fu.RED]))
                same &= torch.equal(k[1], p[1])
            again = copies(bufs)
            fu.fire_reduce(v, f, again[0], again[1], again[2][:fu.RED],
                           again[3], hyper, over)
            k1 = copies(bufs)
            fu.fire_reduce(v, f, k1[0], k1[1], k1[2][:fu.RED], k1[3], hyper,
                           over)
            same &= torch.equal(again[0], k1[0]) and torch.equal(
                again[2], k1[2])
            # fire_move from the plain reduction's scalars.
            xs = [x.clone() for _ in range(3)]
            vs = [v.clone() for _ in range(3)]
            imgs = [box["images"].clone() for _ in range(3)] if rows else [
                None] * 3
            extra = dict(cell=box["cell"], cell_inv=box["cell_inv"]) \
                if rows else {}
            fu.fire_move_plain(xs[0], vs[0], f, p[0], p[1], hyper.dmax, rows,
                               imgs[0], *(extra.values()), overflow=over)
            for i in (1, 2):
                if i == 2:
                    # As the FIRE loops launch it: a programmatic dependent
                    # of a reduction (its own buffers) over the same v, F.
                    r = copies(bufs)
                    fu.fire_reduce(vs[i], f, r[0], r[1], r[2][:fu.RED], r[3],
                                   hyper, over)
                fu.fire_move(xs[i], vs[i], f, p[0], p[1], hyper.dmax,
                             rows=rows, images=imgs[i], overflow=over,
                             **extra)
            errs["move"] = max(rel_err(xs[1], xs[0]), rel_err(vs[1], vs[0]))
            # The move is held to its plain version bit for bit.
            same &= all(torch.equal(a[1], a[0]) and torch.equal(a[2], a[0])
                        for a in (xs, vs) + ((imgs,) if rows else ()))
            # fire_test, in one pass and split.
            tp = copies(p)
            fu.fire_test_plain(f, tp[0], tp[1], tp[2][fu.RED:], 17.0, tp[4],
                               overflow=over)
            for label, modes in (("test", (fu.ONE_PASS,)),
                                 ("test_ring", ring)):
                tk, tk2 = copies(p), copies(p)
                for t in (tk, tk2):
                    for mode in modes:
                        fu.fire_test(f, t[0], t[1], t[2][fu.RED:], t[3], 17.0,
                                     t[4], overflow=over, mode=mode)
                errs[label] = rel_each(tk[0], tp[0])
                same &= (torch.equal(tk[1], tp[1])
                         and torch.equal(tk[4], tp[4])
                         and torch.equal(tk[0], tk2[0])
                         and torch.equal(tk[1], tk2[1]))
            errors[key] = errs
            if not same or max(errs.values()) > tol:
                failures.append(f"fire kernels {key}: errors {errs}, flags, "
                                f"counters and repeats equal {same}")
    log(json.dumps({"fire_kernel_errors": errors}))
    edges, edge_failures = fire_edge_check(fu, hyper, ring, copies,
                                           rel_each)
    failures += edge_failures
    # Times at the bench_fire slots and the particle rows, f32 and f64.
    floor = launch_floor_ms()
    for (layout, shape), dtype in itertools.product(
            (("slots", slots_shape), ("rows", rows_shape)),
            (torch.float32, torch.float64)):
        rows = layout == "rows"
        (f, v, x), box, (scal, ints, red, work, flags), _ = inputs(
            shape, dtype, rows)
        extra = dict(box) if rows else {}
        plain_box = (box["images"], box["cell"], box["cell_inv"]) \
            if rows else ()
        calls = {
            "fire_reduce": (
                lambda: fu.fire_reduce(v, f, scal, ints, red[:fu.RED], work,
                                       hyper),
                lambda: fu.fire_reduce_plain(v, f, scal, ints, red[:fu.RED],
                                             hyper)),
            "fire_move": (
                lambda: fu.fire_move(x, v, f, scal, ints, hyper.dmax,
                                     rows=rows, **extra),
                lambda: fu.fire_move_plain(x, v, f, scal, ints, hyper.dmax,
                                           rows, *plain_box)),
            "fire_test": (
                lambda: fu.fire_test(f, scal, ints, red[fu.RED:], work, 17.0,
                                     flags),
                lambda: fu.fire_test_plain(f, scal, ints, red[fu.RED:], 17.0,
                                           flags)),
        }
        tag = str(dtype)[6:]
        for name, (kernel, plain) in calls.items():
            b, by = fire_bound(name, shape, dtype,
                               images=rows and name == "fire_move")
            rec = {"max_abs_err": max(
                       max(e.values()) for k, e in errors.items()
                       if k.startswith(f"{layout}_{tag}_")),
                   "ms": many_ms(kernel), "plain_ms": many_ms(plain),
                   "plain_timing": "a graph of the composition's calls, as "
                                   "ms",
                   "bound_ms": b, "bound_by": by,
                   "bound_meetable_ms": max(b, floor),
                   "launch_floor_ms": floor, "library_ms": None,
                   "library_call": "none, no single PyTorch call",
                   "shape": list(shape), "dtype": tag}
            if name == "fire_move":
                # After fire_reduce, as the FIRE loops launch it; and over
                # buffers the L2 cannot hold (the in-place calls' 4-15 MB
                # stay in it), as its bytes bound assumes.
                def pair():
                    calls["fire_reduce"][0]()
                    kernel()
                rec["after_reduce_ms"] = many_ms(pair)
                rec["hbm_ms"], rec["hbm_sets"] = move_hbm_ms(
                    fu, hyper, (f, v, x), box, scal, ints, rows)
            else:
                rec["yardstick_vector_norm_ms"] = many_ms(
                    lambda: torch.linalg.vector_norm(f))
                if probe_lib is not None and dtype == torch.float32:
                    import probe_torch_fire
                    rec["phases"] = probe_torch_fire.case_split(
                        probe_lib.result(), name, shape, dtype)
                    if name == "fire_test" and not rows:
                        rec["phases_before_if_node"] = \
                            probe_torch_fire.case_split(
                                probe_lib.result(), name, shape, dtype,
                                with_if=True)
            key = f"{name}_{layout}" + ("" if dtype == torch.float32
                                        else f"_{tag}")
            results[key] = rec
            earlier = FIRE_EARLIER_MS.get((name, layout)) \
                if dtype == torch.float32 else None
            log(json.dumps({"fire_kernel": name, "layout": layout, **rec,
                            "earlier_design_ms": earlier}))
    results["edges"] = edges
    # The captured segment's loop test, against its plain version.
    counter = torch.tensor(599, device="cuda")
    flag = torch.zeros((), dtype=torch.bool, device="cuda")
    for end in (598, 599, 600):
        end = torch.tensor(end, device="cuda")
        draws.step_below(counter, end, flag)
        if bool(flag) != bool(draws.step_below_plain(counter, end)):
            failures.append(f"step_below at end {int(end)}")
    b = 17 / HBM_BYTES_PER_S * 1e3
    results["step_below"] = {
        "max_abs_err": 0.0, "ms": many_ms(
            lambda: draws.step_below(counter, end, flag)),
        "plain_ms": many_ms(lambda: flag.copy_(draws.step_below_plain(
            counter, end))),
        "plain_timing": "a graph of the composition's calls, as ms",
        "bound_ms": b, "bound_by": "bytes", "bound_meetable_ms": floor,
        "launch_floor_ms": floor, "library_ms": None,
        "library_call": "none, no single PyTorch call",
        "covers": "the while_loop's cond of mdtpu/integrate/slot_step.py:"
                  "642-690 (XLA)"}
    log(json.dumps({"step_below": results["step_below"]}))
    # A sharded segment's rebuild decision from the ring's vote, against
    # its plain version: each vote, the counter at the segment's first step
    # or past it.
    votes = torch.zeros((), dtype=torch.int32, device="cuda")
    first = torch.tensor(599, device="cuda")
    for vote, at in ((0, 599), (0, 600), (1, 600), (3, 599)):
        votes.fill_(vote)
        counter.fill_(at)
        draws.rebuild_vote(votes, counter, first, flag)
        if bool(flag) != bool(draws.rebuild_vote_plain(votes, counter,
                                                       first)):
            failures.append(f"rebuild_vote at vote {vote}, step {at}")
    results["rebuild_vote"] = {
        "max_abs_err": 0.0, "ms": many_ms(
            lambda: draws.rebuild_vote(votes, counter, first, flag)),
        "plain_ms": many_ms(lambda: flag.copy_(draws.rebuild_vote_plain(
            votes, counter, first))),
        "plain_timing": "a graph of the composition's calls, as ms",
        # The vote (4 bytes) and two counters read, the flag written.
        "bound_ms": 21 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bound_meetable_ms": floor, "launch_floor_ms": floor,
        "library_ms": None, "library_call": "none, no single PyTorch call",
        "covers": "the psum'd rebin decision of mdtpu/integrate/"
                  "slot_step.py:648-677 under shard_map (XLA)"}
    log(json.dumps({"rebuild_vote": results["rebuild_vote"]}))
    return results, failures


def _fire_start(mt, system):
    """A FIRE phase's start at 65,536, f32: bench_fire.py's jittered
    lattice (LJ r_c 2.5, rho 0.8) or the packer's uniform draw (the overlap
    potential, tol 1, rho 0.8); ``(state, params)``."""
    from mdtpu_torch.potentials.overlap import OverlapPotential
    from mdtpu_torch.sim.initialization import (build_state_from_arrays,
                                                lattice_fluid_state)
    from mdtpu_torch.sim.pack import uniform_fractions
    if system == "lattice":
        state = lattice_fluid_state(N_BENCH, 0.8, 1.0, dtype=torch.float32,
                                    cutoff=2.5, jitter=0.05, device="cuda")
        return state, mt.Parameters(density=0.8, n_particles=N_BENCH,
                                    dt=0.002,
                                    potential=mt.LennardJones(r_cut=2.5))
    length = (N_BENCH / PACK_DENSITY) ** (1 / 3)
    cell = torch.eye(3, dtype=torch.float32, device="cuda") * length
    frac = uniform_fractions(0, (N_BENCH, 3), torch.float32, "cuda")
    state = build_state_from_arrays(frac * length, torch.ones(N_BENCH), cell,
                                    0, dtype=torch.float32, cutoff=1.0,
                                    device="cuda")
    pot = OverlapPotential(tol=1.0)
    return state, mt.Parameters(density=PACK_DENSITY, n_particles=N_BENCH,
                                dt=0.0, potential=pot)


def fire_graph_paths(mt):
    """FIRE captured (one graph launch a minimization, the default on the
    card) against FIRE eager (``graph=False``, the flags read on the host
    each iteration) from one start, at 65,536: ``bench_fire.py``'s system
    in slots, 20 then 200 iterations at tol 0 (the second call replays the
    first's graph); the packer's start in slots (the overlap potential,
    converging at tol 1e-10, dt_max 0.15); and particle-order FIRE on
    ``PlaneEngine`` and on the list (200 iterations). Positions,
    velocities (FIRE's own), energy, n_steps, converged and the rebuild
    steps bit for bit. A census of each captured minimization: graph
    launches and host reads inside it (``torch.profiler``: one launch, the
    one read of the result at its end), the WHILE body's nodes, rebuilds
    and iterations/s both ways."""
    from mdtpu_torch.integrate import slot_step as slots
    from mdtpu_torch.minimize import fire as fire_mod
    from mdtpu_torch.ops.experimental import PlaneEngine

    failures, rec = [], {}
    for name, (kind, system, calls) in FIRE_SYSTEMS.items():
        start, params = _fire_start(mt, system)
        pot, cutoff = params.potential, (1.0 if system == "pack" else 2.5)
        if kind == "slots":
            engine = mt.select_engine(pot, cutoff, start, workload="minimize")
        elif kind == "plane":
            engine = PlaneEngine.create(pot, cutoff, 0.3, start.unitcell,
                                        N_BENCH)
        else:
            engine = mt.select_engine(pot, cutoff, start, prefer="neighbor")
        hyper = dict(dt_max=0.15) if system == "pack" else {}
        if kind == "slots":
            start, engine = slots.slotify_grown(start, engine)
        else:
            # The engine state built outside the timed and profiled calls.
            start = start.replace(nbrs=engine.allocate(
                start.positions, start.diameters, start.unitcell,
                start.unitcell_inv))
        def minimize(graph, max_steps, tol):
            """One minimization from the start: ``(state, converged,
            n_steps, overflow, its DeviceFire)``."""
            if kind == "slots":
                run = fire_mod.make_slot_fire(engine, max_steps=max_steps,
                                              tol=tol, graph=graph, **hyper)
                st, _, conv, n, ovf = run(start)
                return st, conv, n, ovf, run.fire
            run = fire_mod.make_row_fire(engine, max_steps=max_steps,
                                         tol=tol, graph=graph)
            st, _, conv, n = run(start)
            return st, conv, n, False, run.fire

        runs = {}
        for route, graph in (("eager", False), ("graph", None)):
            outs = []
            for max_steps, tol in calls:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, conv, n, ovf, fire = minimize(graph, max_steps, tol)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                velocities = (st.velocities if kind == "slots"
                              else fire.bufs[1].v).clone()
                outs.append({"state": st, "v": velocities, "n": n,
                             "converged": conv, "overflow": ovf,
                             "rebuilds": fire.rebuild_steps(),
                             "seconds": seconds, "fire": fire})
            runs[route] = outs
        rec[name] = {"calls": []}
        for e, g, (max_steps, tol) in zip(runs["eager"], runs["graph"],
                                          calls):
            same = {f: torch.equal(getattr(e["state"], f),
                                   getattr(g["state"], f))
                    for f in ("positions", "forces", "energy", "virial")}
            same["velocities"] = torch.equal(e["v"], g["v"])
            if not (all(same.values()) and e["n"] == g["n"]
                    and e["converged"] == g["converged"]
                    and e["rebuilds"] == g["rebuilds"]):
                failures.append(f"fire graph {name} ({max_steps}): the "
                                f"routes differ: {same}, n {e['n']} vs "
                                f"{g['n']}, rebuilds {len(e['rebuilds'])} "
                                f"vs {len(g['rebuilds'])}")
            if g["fire"].captured is None or e["fire"].graph is not False:
                failures.append(f"fire graph {name}: a run took the other "
                                f"route")
            if not (tol > 0 and g["converged"] or g["n"] == max_steps):
                failures.append(f"fire graph {name}: {g['n']} iterations, "
                                f"converged {g['converged']}")
            if g["overflow"] or not g["rebuilds"]:
                failures.append(f"fire graph {name}: overflow "
                                f"{g['overflow']}, rebuilds {g['rebuilds']}")
            rec[name]["calls"].append({
                "max_steps": max_steps, "tol": tol, "n_steps": g["n"],
                "converged": g["converged"], "rebuilds": len(g["rebuilds"]),
                "rebuild_steps": g["rebuilds"][:64],
                "iterations_per_s_graph": g["n"] / g["seconds"],
                "iterations_per_s_eager": e["n"] / e["seconds"],
                "seconds_graph": g["seconds"],
                "seconds_eager": e["seconds"]})
        # The census of a captured minimization: one more call, profiled.
        fire = runs["graph"][-1]["fire"]
        max_steps, tol = calls[-1]
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            minimize(None, max_steps, tol)
            torch.cuda.synchronize()
        avgs = prof.key_averages()

        def count(*names):
            return sum(e.count for e in avgs if e.key in names)

        census = {
            "graph_launches": count("cudaGraphLaunch"),
            "host_reads": count("cudaStreamSynchronize",
                                "cudaEventSynchronize"),
            "kernel_launches": count("cudaLaunchKernel",
                                     "cudaLaunchKernelExC",
                                     "cuLaunchKernel", "cuLaunchKernelEx"),
            "pass_nodes": {k: fire.census["pass"][k] for k in (
                "nodes", "kernels", "copies", "memsets", "conditionals",
                *FIRE_EDGES)},
            "graph_nodes": {k: fire.census["graph"][k] for k in (
                "nodes", "kernels", "copies", "memsets", "conditionals",
                *FIRE_EDGES)},
            "rebuilds": len(fire.rebuild_steps())}
        rec[name]["census"] = census
        # One graph launch, the one read of the result (no read inside),
        # the loop one WHILE node whose body holds the rebuild's IF node
        # (slots: the pass's trailing rebin; particle order: the engine's).
        if (census["graph_launches"] != 1 or census["host_reads"] != 1
                or census["pass_nodes"]["conditionals"] != 1
                or census["graph_nodes"]["conditionals"] < 1
                or census["pass_nodes"]["programmatic_into_fire_move"] < 1):
            failures.append(f"fire graph {name}: census {census}")
        log(json.dumps({"fire_graph_path": name, **rec[name]}))
    return rec, failures


def reset_counts():
    """Every kernel wrapper's launch counts and the slot step's and the
    particle advance's step counts to 0."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.integrate import step as step_mod
    from mdtpu_torch.integrate import velocity_finish as vf
    from mdtpu_torch.integrate import verlet_update as vu
    from mdtpu_torch.minimize import fire_update as fu
    from mdtpu_torch.ops import cell_pairs as cp
    from mdtpu_torch.ops import cell_sweep as cs
    from mdtpu_torch.ops import neighbor_list as nl
    from mdtpu_torch.ops import philox_draws as draws
    from mdtpu_torch.ops import plane_sweep as ps
    from mdtpu_torch.ops import rdf
    from mdtpu_torch.utils import counters
    counters.settle()
    vf.velocity_finish.launches = 0
    vu.reset_launches()
    fu.reset_launches()
    cs.reset_launches()
    cp.reset_launches()
    draws.reset_launches()
    ps.plane_sweep.launches = 0
    rdf.rdf_histogram.launches = rdf.rdf_histogram.cell_launches = 0
    nl.reset_launches()
    slot_step.make_slot_step.steps = 0
    step_mod.ParticleAdvance.steps = step_mod.ParticleAdvance.graph_steps = 0


def launch_counts():
    """Each wrapper's launches (total and lean, periodic and slab) since
    the last :func:`reset_counts` (those of captured rebuilds settled
    first: one host read)."""
    from mdtpu_torch.integrate import velocity_finish as vf
    from mdtpu_torch.integrate import verlet_update as vu
    from mdtpu_torch.minimize import fire_update as fu
    from mdtpu_torch.ops import cell_pairs as cp
    from mdtpu_torch.ops import cell_sweep as cs
    from mdtpu_torch.ops import neighbor_list as nl
    from mdtpu_torch.ops import philox_draws as draws
    from mdtpu_torch.ops import plane_sweep as ps
    from mdtpu_torch.ops import rdf
    from mdtpu_torch.utils import counters
    counters.settle()
    return {
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
        "nl_forces": nl.nl_forces.launches,
        "bussi_draw": draws.bussi_draw.launches,
        "velocity_finish": vf.velocity_finish.launches,
        "uniform_noise": draws.uniform_noise.launches,
        "rebuild_flag": draws.rebuild_flag.launches,
        "verlet_kick_drift": vu.kick_drift.launches,
        "verlet_kick": vu.kick.launches,
        "verlet_rescale": vu.rescale.launches,
        "brownian_update": vu.brownian_update.launches,
        "kick_drift_wrap": vu.kick_drift_wrap.launches,
        "brownian_rows": vu.brownian_rows.launches,
        "rebuild_flag_rows": draws.rebuild_flag_rows.launches,
        "step_below": draws.step_below.launches,
        "rebuild_vote": draws.rebuild_vote.launches,
        "fire_reduce": fu.fire_reduce.launches,
        "fire_move": fu.fire_move.launches,
        "fire_test": fu.fire_test.launches}


def own_launches(n):
    """Each kernel entry's own launches from :func:`launch_counts`: a
    wrapper's total less its lean and slab launches."""
    return {
        "cell_sweep": n["cell_sweep"] - n["cell_sweep_lean"]
        - n["cell_sweep_slab"] + n["cell_sweep_slab_lean"],
        "cell_sweep_lean": n["cell_sweep_lean"] - n["cell_sweep_slab_lean"],
        "cell_sweep_hilo": n["cell_sweep_hilo"] - n["cell_sweep_hilo_lean"]
        - n["cell_sweep_slab_hilo"] + n["cell_sweep_slab_hilo_lean"],
        "cell_sweep_hilo_lean": n["cell_sweep_hilo_lean"]
        - n["cell_sweep_slab_hilo_lean"],
        "cell_sweep_slab": n["cell_sweep_slab"] - n["cell_sweep_slab_lean"],
        "cell_sweep_slab_lean": n["cell_sweep_slab_lean"],
        "cell_sweep_slab_hilo": n["cell_sweep_slab_hilo"]
        - n["cell_sweep_slab_hilo_lean"],
        "cell_sweep_slab_hilo_lean": n["cell_sweep_slab_hilo_lean"],
        "plane_sweep": n["plane_sweep"],
        "cell_pairs": n["cell_pairs"] - n["cell_pairs_slab"],
        "cell_pairs_slab": n["cell_pairs_slab"],
        "pair_reduce": n["pair_reduce"],
        "rdf_histogram": n["rdf_histogram"] - n["rdf_histogram_cell"],
        "rdf_histogram_cell": n["rdf_histogram_cell"],
        "nl_build": n["nl_build"], "nl_forces": n["nl_forces"],
        "bussi_draw": n["bussi_draw"],
        "velocity_finish": n["velocity_finish"],
        "uniform_noise": n["uniform_noise"],
        "rebuild_flag": n["rebuild_flag"],
        "verlet_kick_drift": n["verlet_kick_drift"],
        "verlet_kick": n["verlet_kick"],
        "verlet_rescale": n["verlet_rescale"],
        "brownian_update": n["brownian_update"],
        "kick_drift_wrap": n["kick_drift_wrap"],
        "brownian_rows": n["brownian_rows"],
        "rebuild_flag_rows": n["rebuild_flag_rows"],
        "step_below": n["step_below"], "rebuild_vote": n["rebuild_vote"],
        "fire_reduce": n["fire_reduce"],
        "fire_move": n["fire_move"], "fire_test": n["fire_test"]}


def run_paths(mt, workdir, kept=None):
    """Every path, each with the counts set to 0 just before it; ``kept``
    receives the user path's NVT start and parameters (the user graph
    phase's)."""
    from mdtpu_torch.integrate import slot_step
    from mdtpu_torch.integrate import step as step_mod
    from mdtpu_torch.io import native_writer
    from mdtpu_torch.ops.experimental import PlaneEngine

    def counted(fn):
        """Run one path with every count set to 0 just before it; its
        launches (each wrapper's total and lean) and slot steps after."""
        reset_counts()
        frames = native_writer.format_frame.calls
        rec, failures = fn()
        rec["launches"] = launch_counts()
        rec["slot_steps"] = slot_step.make_slot_step.steps
        rec["particle_steps"] = step_mod.ParticleAdvance.steps
        rec["particle_graph_steps"] = step_mod.ParticleAdvance.graph_steps
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
    kept = {} if kept is None else kept
    user, f9 = counted(lambda: user_path(mt, workdir, kept))
    resume, f10 = counted(lambda: resume_path(mt, workdir))
    nlp, f11 = counted(lambda: md_path(
        mt, workdir, "nl",
        lambda st, pot: mt.select_engine(pot, 2.5, st, prefer="neighbor"),
        True))
    reference, f_ref = counted(lambda: reference_phase(mt))
    failures = (f1 + f2 + f3 + f4 + f5 + f6 + f7 + f8 + f9 + f10 + f11
                + f_ref)
    # The sharded driver and FIRE on a one-rank NCCL group (the default
    # group while they run), then the examples (05 runs on that group).
    dist = nccl_group(workdir)
    try:
        sharded, f12 = counted(lambda: sharded_path(mt, workdir,
                                                    b1["thermo_nvt"]))
        sharded_fire, f13 = counted(lambda: sharded_fire_path(mt))
        sharded_user, f14 = counted(lambda: sharded_user_path(mt, workdir,
                                                              kept))
        examples, f_ex = counted(lambda: examples_phase(mt, workdir))
    finally:
        dist.destroy_process_group()
    failures += f12 + f13 + f14 + f_ex
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
    # Every MD step finishes through velocity_finish (its NVT steps draw
    # there, none through bussi_draw), every Brownian step in slots draws
    # in its update (brownian_update, no uniform_noise), every Brownian
    # step on PlaneEngine through uniform_noise; every slot step tests the
    # rebuild flag once.
    if (b1["launches"]["velocity_finish"] < NVT_STEPS + 2 * NVE_STEPS
            or b1["launches"]["bussi_draw"]
            or b1["launches"]["rebuild_flag"] < NVT_STEPS + 2 * NVE_STEPS
            or bds["launches"]["brownian_update"] != BROWNIAN_STEPS
            or bds["launches"]["uniform_noise"]
            or bds["launches"]["rebuild_flag"] < BROWNIAN_STEPS):
        failures.append(f"b1/brownian: draw launches {b1['launches']} "
                        f"{bds['launches']} {bd['launches']}")
    for rec in (b1, b2, bd, nlp):
        if rec["launches"]["brownian_update"]:
            failures.append(f"{rec['path']}: launched brownian_update "
                            f"{rec['launches']}")
    # Every MD slot step runs the Verlet chain as the kernel's launches:
    # kick-drift and kick once a step, the rescale once an NVT step; the
    # Brownian slot step none; no slot path the particle rows' kernels.
    n = b1["launches"]
    if (n["verlet_kick_drift"] != steps or n["verlet_kick"] != steps
            or n["verlet_rescale"] != NVT_STEPS):
        failures.append(f"b1: verlet_update launches {n}")
    for rec in (b2, bd, bds, nlp):
        if rec["launches"]["verlet_kick_drift"]:
            failures.append(f"{rec['path']}: launched the slot kick-drift "
                            f"{rec['launches']}")
    for rec in (b1, bds, b1_2d, b1_tilted, fire, resume):
        n = rec["launches"]
        if (n["kick_drift_wrap"] or n["brownian_rows"]
                or n["rebuild_flag_rows"] or rec["particle_steps"]):
            failures.append(f"{rec['path']}: took the particle-order step "
                            f"{n}")
    # Every particle-order step (B2, the list, Brownian on PlaneEngine)
    # runs through the particle rows' kernels, one CUDA-graph launch a
    # step: an MD step kick-drift-wrap, the drift test, the kick and NVT's
    # rescale; a Brownian step the drift test and the move with its noise
    # drawn inside (no noise kernel, no slot chain).
    for rec in (b2, nlp):
        n = rec["launches"]
        if (n["kick_drift_wrap"] != steps or n["verlet_kick"] != steps
                or n["verlet_rescale"] != NVT_STEPS
                or n["rebuild_flag_rows"] != steps or n["brownian_rows"]
                or n["velocity_finish"] != steps):
            failures.append(f"{rec['path']}: particle-order launches {n}")
    n = bd["launches"]
    if (n["brownian_rows"] != BROWNIAN_STEPS or n["uniform_noise"]
            or n["rebuild_flag_rows"] != BROWNIAN_STEPS
            or n["kick_drift_wrap"] or n["verlet_kick"]):
        failures.append(f"brownian: particle-order launches {n}")
    for rec, want in ((b2, steps), (nlp, steps), (bd, BROWNIAN_STEPS)):
        if not (rec["particle_steps"] == rec["particle_graph_steps"]
                == want):
            failures.append(f"{rec['path']}: {rec['particle_graph_steps']} "
                            f"of {rec['particle_steps']} particle-order "
                            f"steps captured, not {want}")
    if fire["launches"]["cell_sweep_lean"] != N_FIRE_ITERS + N_FIRE_DESCENT:
        failures.append(f"fire: launches {fire['launches']}")
    # FIRE's update runs through its three kernels, one launch each an
    # iteration (the test once more at each minimization's entry), and its
    # slots' drift test once an iteration; the sharded FIRE launches the
    # reduction and the test three ways apart (the ring's all-reduces
    # between), the user path (config 4, captured) as the slot FIRE does. No
    # torch composition of the update is left to count.
    iters = N_FIRE_ITERS + N_FIRE_DESCENT
    n = fire["launches"]
    if (n["fire_reduce"] != iters or n["fire_move"] != iters
            or n["fire_test"] != iters + 2 or n["rebuild_flag"] != iters):
        failures.append(f"fire: FIRE kernel launches {n}")
    n = pack["launches"]
    if (n["fire_reduce"] < 1 or n["fire_move"] != n["fire_reduce"]
            or n["fire_test"] <= n["fire_reduce"]):
        failures.append(f"pack: FIRE kernel launches {n}")
    n = sharded_fire["launches"]
    if (n["fire_reduce"] != 3 * N_FIRE_DESCENT
            or n["fire_move"] != N_FIRE_DESCENT
            or n["fire_test"] != 3 * (N_FIRE_DESCENT + 1)):
        failures.append(f"sharded fire: FIRE kernel launches {n}")
    n = user["launches"]
    if (n["fire_reduce"] < user["fire_iterations"]
            or n["fire_move"] != n["fire_reduce"]):
        failures.append(f"user: FIRE kernel launches {n}")
    if pack["launches"]["cell_sweep_lean"] < 1:
        failures.append(f"pack: launches {pack['launches']}")
    return {"b1": b1, "b2": b2, "brownian": bd, "brownian_slot": bds,
            "fire": fire, "pack": pack, "b1_2d": b1_2d,
            "b1_tilted": b1_tilted, "user": user,
            "resume": resume, "nl": nlp, "sharded": sharded,
            "sharded_fire": sharded_fire, "sharded_user": sharded_user,
            "reference": reference, "examples": examples}, failures


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
    try:
        import mdtpu_torch as mt
    except ImportError as err:
        # A copy of this script without the repository beside it.
        print(f"chip_smoke: the package mdtpu_torch is not beside this "
              f"script ({err})", file=sys.stderr)
        return 1
    from mdtpu_torch.ops import _cuda_build

    log(nvidia_smi_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    # The stamped copies of FIRE's reductions (probe_torch_fire.py) and of
    # the particle rows' drift test and Brownian move (probe_torch_rows.py)
    # build beside the package's sources.
    import probe_torch_fire
    import probe_torch_rows
    probe_dir = tempfile.mkdtemp(prefix="fire_probe_")
    rows_dir = tempfile.mkdtemp(prefix="rows_probe_")
    probe_pool = ThreadPoolExecutor(max_workers=2)
    probe_lib = probe_pool.submit(probe_torch_fire.build_stamped, probe_dir)
    rows_probe = probe_pool.submit(probe_torch_rows.build_stamped, rows_dir)
    try:
        return run_phases(mt, _cuda_build, t, probe_lib, rows_probe)
    finally:
        probe_pool.shutdown(wait=True)
        shutil.rmtree(probe_dir, ignore_errors=True)
        shutil.rmtree(rows_dir, ignore_errors=True)


def run_phases(mt, _cuda_build, t, probe_lib, rows_probe):
    """Every phase after the build (started at ``t``) and the result lines;
    the process's exit code."""
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
    draws_results, draws_failures = draws_check(mt)
    failures += draws_failures
    verlet_results, verlet_failures = verlet_check(mt)
    failures += verlet_failures
    brownian_results, brownian_failures = brownian_update_check(mt)
    failures += brownian_failures
    particle_results, particle_failures = particle_check(mt, rows_probe)
    failures += particle_failures
    fire_results, fire_failures = fire_check(mt, probe_lib)
    failures += fire_failures
    log(f"kernel and probe phases: {time.perf_counter() - t:.1f} s")
    with tempfile.TemporaryDirectory() as workdir:
        user_kept = {}
        paths, path_failures = run_paths(mt, workdir, user_kept)
        failures += path_failures
        t = time.perf_counter()
        graph_rec, graph_failures = graph_paths(mt, workdir)
        failures += graph_failures
        log(f"graph phase: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        particle_rec, particle_path_failures = particle_paths(mt, workdir)
        failures += particle_path_failures
        log(f"particle-order phase: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        fire_rec, fire_graph_failures = fire_graph_paths(mt)
        failures += fire_graph_failures
        log(f"fire graph phase: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        sharded_rec, sharded_graph_failures = sharded_graph_paths(mt,
                                                                  workdir)
        failures += sharded_graph_failures
        log(f"sharded graph phase: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        user_graph_rec, user_graph_failures = user_graph_paths(
            mt, workdir, user_kept)
        failures += user_graph_failures
        del user_kept
        log(f"user graph phase: {time.perf_counter() - t:.1f} s")

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
               - by_path["fire"]["cell_sweep_lean"],
               "energy_virial": "summed in the kernel's last block (one "
                                "launch a call)"}),
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
    reduce_f32 = results[("pair_reduce", "config4_lattice", "float32")]
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
                  "library_call": reduce_rec["library_call"],
                  "replay_ms": reduce_rec["replay_ms"],
                  "lean_replay_ms": reduce_rec["lean_replay_ms"],
                  "staged": reduce_rec["staged"],
                  "f32": {k: reduce_f32[k] for k in (
                      "ms", "lean_ms", "replay_ms", "lean_replay_ms",
                      "bound_ms", "lean_bound_ms", "library_ms",
                      "max_abs_err")}}),
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
    sh_own = own_launches(by_path["sharded"])
    sh_fire = own_launches(by_path["sharded_fire"])
    for kname in ("cell_sweep_slab", "cell_sweep_slab_lean",
                  "cell_sweep_slab_hilo", "cell_sweep_slab_hilo_lean"):
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
            kname, "mdtpu_torch/csrc/cell_sweep.cu", pallas_cell,
            sh_own[kname], main_rec, extra))
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
    # The slot advance's tail, noise and rebuild test (XLA in the JAX
    # package, no pl.pallas_call): the tail's and the test's launches on the
    # B1 path, the noise's on the Brownian slot path; each with the launch
    # floor, and the tail's and the test's nodes in a captured bench step.
    # bussi_draw, which the step no longer launches (velocity_finish draws
    # in it), rides on the tail's entry.
    nodes = graph_rec["segment_profile"]["nvt"]["nodes"]["lean"]
    floor = draws_results["launch_floor"]["ms"]
    for kname, path in (("velocity_finish", "b1"),
                        ("rebuild_flag", "b1")):
        rec = draws_results[kname]
        extra = {k: v for k, v in rec.items() if k not in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
        extra["launch_floor_ms"] = floor
        extra["launch_floor_programmatic_ms"] = draws_results[
            "launch_floor"]["programmatic_ms"]
        extra["nodes_in_captured_nvt_step"] = nodes[kname]
        if kname == "velocity_finish":
            extra["draw_kernel"] = dict(
                draws_results["bussi_draw"], name="bussi_draw",
                launches=by_path["b1"]["bussi_draw"],
                replaces="mdtpu/integrate/thermostat.py:43")
        kernels["kernels"].append({
            **entry(kname, DRAWS_SOURCE, DRAWS_REPLACE[kname],
                    by_path[path][kname], rec, extra),
            "library_ms": rec["library_ms"],
            "covers": DRAWS_COVER[kname]})
    # The slot step's Verlet chain (XLA in the JAX package, no
    # pl.pallas_call): one kernel's three variants, each with its launches
    # on the B1 path and its nodes in a captured bench step (the hi/lo
    # kick-drift rides on the kick-drift's entry).
    for kname, label in (("kick_drift", "verlet_kick_drift"),
                         ("kick", "verlet_kick"),
                         ("rescale", "verlet_rescale")):
        rec = verlet_results[kname]
        extra = {k: v for k, v in rec.items() if k not in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
        extra["covers"] = VERLET_COVERS
        extra["kernel"] = "verlet_update_kernel"
        if kname == "kick_drift":
            extra["hilo"] = {k: verlet_results["kick_drift_hilo"][k]
                             for k in ("ms", "plain_ms", "bound_ms")}
        kernels["kernels"].append(entry(label, VERLET_SOURCE,
                                        VERLET_REPLACES, by_path["b1"][label],
                                        rec, extra))
    # The Brownian slot step's update (XLA in the JAX package, no
    # pl.pallas_call): the Brownian slot path's slots at f32, the other
    # shapes and dtypes beside it, its launches on that path and its nodes
    # in a captured Brownian step.
    main_rec = brownian_results["brownian_slot_float32"]
    extra = {k: v for k, v in main_rec.items() if k not in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}
    extra.update(covers=BROWNIAN_COVERS, kernel="brownian_update_kernel",
                 launches_b1=by_path["b1"]["brownian_update"],
                 nodes_in_captured_brownian_step=graph_rec[
                     "brownian_slot"]["step_nodes"])
    for key, r in brownian_results.items():
        if r is not main_rec:
            extra[key] = {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "shape")}
    kernels["kernels"].append(entry(
        "brownian_update", VERLET_SOURCE, BROWNIAN_REPLACES,
        by_path["brownian_slot"]["brownian_update"], main_rec, extra))
    # The particle-order step's kernels (XLA in the JAX package, no
    # pl.pallas_call): the bench's 65,536 particles at f32 (the Brownian
    # path's start for the move), the other cases beside it, the launches
    # on the B2 path (the move's on the Brownian path), the list path's
    # and the nodes of the captured steps beside.
    for kname, main_key, path in (
            ("kick_drift_wrap", "kick_drift_wrap", "b2"),
            ("brownian_rows", "brownian_rows", "brownian"),
            ("rebuild_flag_rows", "rebuild_flag_rows_cell", "b2")):
        main_rec = particle_results[main_key]
        extra = {k: v for k, v in main_rec.items() if k not in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
        if kname == "brownian_rows":
            # The noise kernel, which no step launches since the Brownian
            # moves draw inside (the plain versions' noise on the card),
            # rides on the move's entry, as bussi_draw on the finish's.
            extra["noise_kernel"] = {
                **draws_results["uniform_noise"], "name": "uniform_noise",
                "launches": by_path["brownian"]["uniform_noise"],
                "source": DRAWS_SOURCE,
                "replaces": DRAWS_REPLACE["uniform_noise"],
                "covers": DRAWS_COVER["uniform_noise"]}
        extra.update(covers=PARTICLE_COVERS[kname],
                     kernel=f"{kname.replace('_flag', '')}_kernel",
                     launches_nl=by_path["nl"][kname],
                     launches_brownian=by_path["brownian"][kname],
                     nodes_in_captured_steps={
                         k: r["step_nodes"] for k, r in particle_rec.items()
                         if k != "segment_profile"})
        for key, r in particle_results.items():
            if key.startswith(kname) and r is not main_rec:
                extra[key] = {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "shape", "dtype")}
        kernels["kernels"].append(entry(
            kname, DRAWS_SOURCE if kname == "rebuild_flag_rows"
            else VERLET_SOURCE, PARTICLE_REPLACES[kname],
            by_path[path][kname], main_rec, extra))
    # FIRE's update (XLA in the JAX package's while_loop, no
    # pl.pallas_call): the bench_fire slots at f32, the particle rows
    # beside, the launches on the fire path and the other FIRE paths, the
    # census of each captured minimization.
    for kname in ("fire_reduce", "fire_move", "fire_test"):
        main_rec = fire_results[f"{kname}_slots"]
        extra = {k: v for k, v in main_rec.items() if k not in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                "shape", "yardstick_vector_norm_ms", "after_reduce_ms",
                "hbm_ms", "hbm_sets", "phases")
        extra.update(
            covers=FIRE_COVERS[kname], kernel="scaled_reduce_kernel"
            if kname != "fire_move" else "fire_move_slots_kernel, "
            "fire_move_rows_kernel",
            rows={k: fire_results[f"{kname}_rows"][k] for k in keys
                  if k in fire_results[f"{kname}_rows"]},
            f64={layout: {k: fire_results[f"{kname}_{layout}_float64"][k]
                          for k in keys
                          if k in fire_results[f"{kname}_{layout}_float64"]}
                 for layout in ("slots", "rows")},
            launches_pack=by_path["pack"][kname],
            launches_sharded_fire=by_path["sharded_fire"][kname],
            launches_user=by_path["user"][kname],
            minimizations={k: r["census"] for k, r in fire_rec.items()})
        if kname != "fire_move":
            extra["edges"] = fire_results["edges"]
        extra["launch"] = "a programmatic dependent (cudaLaunchKernelEx)"
        kernels["kernels"].append(entry(kname, FIRE_SOURCE,
                                        FIRE_REPLACES[kname],
                                        by_path["fire"][kname], main_rec,
                                        extra))
    # The captured segment's loop test (the while_loop's cond, XLA): its
    # launches on the B1 path (one a step and one at each segment's start).
    rec = fire_results["step_below"]
    kernels["kernels"].append(entry(
        "step_below", DRAWS_SOURCE, "mdtpu/integrate/slot_step.py:642",
        by_path["b1"]["step_below"], rec,
        {k: v for k, v in rec.items() if k not in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}))
    # The sharded segment's rebuild decision (the psum'd flag's rebin,
    # XLA): its launches on the sharded path (one a lean step).
    rec = fire_results["rebuild_vote"]
    kernels["kernels"].append(entry(
        "rebuild_vote", DRAWS_SOURCE, "mdtpu/integrate/slot_step.py:652",
        by_path["sharded"]["rebuild_vote"], rec,
        {**{k: v for k, v in rec.items() if k not in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
         "nodes_in_captured_sharded_step": sharded_rec["census"]["lean"][
             "rebuild_vote"]}))
    log(json.dumps({"particle_segment_profile": {
        k: {route: {m: p[m] for m in (
            "ms_per_step_host_clock", "device_busy_ms_per_step",
            "device_idle_share_timed", "device_span_ms_per_step",
            "device_idle_share_outside_span", "kernel_launches_per_step",
            "graph_launches_per_step", "host_syncs_per_step")}
            for route, p in r["profiles"].items()}
        for k, r in particle_rec["segment_profile"].items()},
        "particle_step_nodes": {k: r["nodes"] for k, r in
                                particle_rec["segment_profile"].items()}}))
    log(json.dumps({"launch_floor_ms": floor, "calls_a_graph": MANY_CALLS,
                    "graph_step_nodes": {
                        e: r["nodes"] for e, r in
                        graph_rec["segment_profile"].items()}}))
    log(json.dumps({"user_graph": {
        k: v for k, v in user_graph_rec.items() if k != "segments"},
        "user_graph_segments": {
            e: {k: r[k] for k in ("nodes", "capture_s", "peak_memory_bytes")}
            for e, r in user_graph_rec.get("segments", {}).items()}}))
    log(json.dumps({"compute_slots_ms": {
        f"{k}_{case}_{tag}": r["ms"] for (k, case, tag), r in
        slab_results.items() if k.endswith("compute_slots")}}))
    # Each kernel's launches in the examples and reference phases (the 2D
    # and tilted entries share their wrapper's counts with the 3D ones).
    for phase in ("examples", "reference"):
        own = own_launches(by_path[phase])
        for k in kernels["kernels"]:
            if k["name"] in own:
                k[f"launches_{phase}"] = own[k["name"]]
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
