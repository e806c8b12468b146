#!/usr/bin/env python3
"""Hold the host side of two trees of this repository against each other on
one NVIDIA GPU: the bare step's host-clock time and the dynamics paths'
steps/s, both trees within one call.

    git archive <commit> | tar -x -C out_parent      # the other tree
    python3 compare_torch_host.py --parent out_parent

Each tree runs, in the order parent, change, change, parent, and each in
processes of its own started in that tree (so each builds and loads its own
kernels): this tree's ``profile_torch_step.py --tree <tree>`` (one script,
so both trees are measured alike) with ``--engine cellgrid`` (the cell
grid in particle order), ``--engine plane`` (``PlaneEngine``) and
``--engine neighbor`` (the list), each on the particle advance captured
and, ``--eager``, launched step by step (a tree without the advance steps
its ``make_step`` loop both times), ``--engine plane --brownian`` (the
Brownian step on ``PlaneEngine``, both ways), ``--engine
slot`` (the slot advance ``run_simulation`` runs on the cell grid, captured;
an NVT and an NVE segment), the same with ``--plain-launch`` (the small
kernels in plain stream order where the tree launches them as
programmatic dependents), ``--engine slot --eager`` (the same launched
step by step) and ``--engine slot --brownian`` (the Brownian slot step,
captured and, ``--eager``, launched step by step, and with
``--plain-launch``), then the
``b1``, ``b2`` and ``nl`` paths (600 NVT + 500 NVE + 500 force-shifted
NVE at the bench configuration, in slots, on ``PlaneEngine`` and on the
list) and the Brownian paths on ``PlaneEngine`` and in slots of its
``chip_smoke.py``. ``--only slot``: the slot step captured and eager, the
Brownian slot step, and the ``b1`` and Brownian-in-slots paths alone (~6
min); ``--only particle``: the particle-order steps (cell grid,
``PlaneEngine``, list, Brownian on ``PlaneEngine``; captured and eager)
and the ``b2``, ``nl`` and Brownian paths alone; ``--only fire``: the
captured slot step (NVT and NVE), ``chip_smoke.py``'s FIRE path (20 then
200 iterations on ``bench_fire.py``'s system, its iterations/s) and its
packing path (65,536 at rho 0.8: seconds and FIRE's iterations), each
CUDA graph replay of those two paths timed on the device by CUDA events
around it (the same instrument in both trees: ``CUDAGraph.replay``
wrapped in the worker); ``--only sharded``: the sharded step (``--engine
sharded`` on a one-rank NCCL group; captured and, ``--eager``, launched
step by step; a tree whose sharded advance is a host loop steps that loop
both times), then the ``b1`` path (whose first thermo rows the sharded
path is held to), ``chip_smoke.py``'s sharded path (600 NVT + 500 NVE
through ``run_simulation_sharded``, its steps/s) and its sharded FIRE
path (20 iterations through ``fire_minimize_sharded``, its iterations/s
and each replay's span by events), both on a one-rank NCCL group formed
in the worker (~5 min); ``--only user``: BASELINE config 4's step in slots
and sharded (``--potential user``: the pair list; captured and, ``--eager``,
launched step by step; a tree whose user routes are eager runs them eagerly
both times), then ``chip_smoke.py``'s user path (``minimize``'s 1000 FIRE
iterations and 300 NVT steps at 65,536, their iterations/s, steps/s and
seconds, a capture included where the tree captures) and its sharded user
path (``fire_minimize_sharded`` and ``run_simulation_sharded`` of the same,
on a one-rank NCCL group). The host's clock moves
with the machine and with what
else runs on it, so two trees are compared only within one such call.
Prints one JSON line per tree and run: each profile's host ms, device busy
ms, idle share, the device's span by CUDA events, launches, host reads and
the kernels and memsets the device ran per step (null where a captured
segment loops inside a WHILE node, which the profiler does not see: then
the kernels by the step graphs' census; the NVE segment's under ``nve``),
the velocity finish's,
the noise's and the Brownian update's device time in the step and the gap
before each, how the small kernels launched, each captured step
variant's nodes, copies and programmatic edges (lean, and the segment's
full last step), and each path's steps/s; then the card's name and power
limit.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
PROFILE_KEYS = ("ms_per_step_host_clock", "device_busy_ms_per_step",
                "device_idle_share_profiled", "device_idle_share_timed",
                "device_span_ms_per_step", "device_idle_share_outside_span",
                "device_seen_by_profiler",
                "kernel_launches_per_step", "host_syncs_per_step",
                "graph_launches_per_step", "device_kernels_per_step",
                "device_kernels_per_step_census",
                "device_memsets_per_step", "device_copies_per_step")
GAP_KEYS = tuple(f"{k}{s}" for k in ("velocity_finish", "uniform_noise",
                                      "brownian_update")
                 for s in ("_us", "_gap_us", "_after_us"))
ENGINES = {"cellgrid": ("--engine", "cellgrid"),
           "cellgrid_eager": ("--engine", "cellgrid", "--eager"),
           "plane": ("--engine", "plane"),
           "plane_eager": ("--engine", "plane", "--eager"),
           "neighbor": ("--engine", "neighbor"),
           "neighbor_eager": ("--engine", "neighbor", "--eager"),
           "plane_brownian": ("--engine", "plane", "--brownian"),
           "plane_brownian_eager": ("--engine", "plane", "--brownian",
                                    "--eager"),
           "slot": ("--engine", "slot"),
           "slot_plain_launch": ("--engine", "slot", "--plain-launch"),
           "slot_eager": ("--engine", "slot", "--eager"),
           "slot_brownian": ("--engine", "slot", "--brownian"),
           "slot_brownian_eager": ("--engine", "slot", "--brownian",
                                   "--eager"),
           "slot_brownian_plain_launch": ("--engine", "slot", "--brownian",
                                          "--plain-launch"),
           "sharded": ("--engine", "sharded"),
           "sharded_eager": ("--engine", "sharded", "--eager"),
           "slot_user": ("--engine", "slot", "--potential", "user"),
           "slot_user_eager": ("--engine", "slot", "--potential", "user",
                               "--eager"),
           "sharded_user": ("--engine", "sharded", "--potential", "user"),
           "sharded_user_eager": ("--engine", "sharded", "--potential",
                                  "user", "--eager")}


ONLY = {"slot": (("slot", "slot_eager", "slot_brownian",
                   "slot_brownian_eager"), ("b1", "brownian_slot")),
        "fire": (("slot",), ("fire", "pack")),
        "particle": (("cellgrid", "cellgrid_eager", "plane", "plane_eager",
                      "neighbor", "neighbor_eager", "plane_brownian",
                      "plane_brownian_eager"), ("b2", "nl", "brownian")),
        "sharded": (("sharded", "sharded_eager"),
                    ("b1", "sharded", "sharded_fire")),
        "user": (("slot_user", "slot_user_eager", "sharded_user",
                  "sharded_user_eager"), ("user", "sharded_user"))}
PATHS = ("b1", "b2", "nl", "brownian", "brownian_slot", "fire", "pack",
         "sharded", "sharded_fire", "user", "sharded_user")
# The paths whose CUDA graph replays are timed by events.
REPLAY_TIMED = ("fire", "pack", "sharded_fire")
# The paths that run on a one-rank NCCL group.
SHARDED = ("sharded", "sharded_fire", "sharded_user")


@contextlib.contextmanager
def replay_spans():
    """Within the block, each ``torch.cuda.CUDAGraph.replay`` is timed on
    the device by a CUDA event recorded just before it and one just after
    it on the current stream; yields a list that, after the block, holds
    each replay's span in ms."""
    import torch
    replay, pairs, spans = torch.cuda.CUDAGraph.replay, [], []

    def timed(graph, *args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = replay(graph, *args, **kwargs)
        end.record()
        pairs.append((start, end))
        return out

    torch.cuda.CUDAGraph.replay = timed
    try:
        yield spans
    finally:
        torch.cuda.CUDAGraph.replay = replay
        torch.cuda.synchronize()
        spans.extend(s.elapsed_time(e) for s, e in pairs)


def paths_worker(tree, only=PATHS):
    """Run the tree's paths of ``only`` (the sharded ones after ``b1``, on
    a one-rank NCCL group); print their steps/s or iterations/s."""
    sys.path.insert(0, tree)
    import chip_smoke
    import mdtpu_torch as mt
    from mdtpu_torch.ops.experimental import PlaneEngine

    out, failures, recs, group, kept = {}, [], {}, [], {}
    with tempfile.TemporaryDirectory() as workdir, \
            contextlib.ExitStack() as stack:
        for label, run in (
                ("b1", lambda: chip_smoke.md_path(
                    mt, workdir, "b1", lambda st, pot: None, True)),
                ("b2", lambda: chip_smoke.md_path(
                    mt, workdir, "b2",
                    lambda st, pot: PlaneEngine.create(
                        pot, 2.5, 0.3, st.unitcell, chip_smoke.N_BENCH),
                    False)),
                ("nl", lambda: chip_smoke.md_path(
                    mt, workdir, "nl",
                    lambda st, pot: mt.select_engine(pot, 2.5, st,
                                                     prefer="neighbor"),
                    True)),
                ("brownian", lambda: chip_smoke.brownian_path(mt, workdir)),
                ("brownian_slot", lambda: chip_smoke.brownian_path(
                    mt, workdir, slots=True)),
                ("fire", lambda: chip_smoke.fire_path(mt)),
                ("pack", lambda: chip_smoke.pack_path(mt, workdir)),
                ("sharded", lambda: chip_smoke.sharded_path(
                    mt, workdir, recs["b1"]["thermo_nvt"])),
                ("sharded_fire", lambda: chip_smoke.sharded_fire_path(mt)),
                ("user", lambda: chip_smoke.user_path(mt, workdir, kept)),
                ("sharded_user", lambda: chip_smoke.sharded_user_path(
                    mt, workdir, kept))):
            if label not in only:
                continue
            if label in SHARDED and not group:
                group.append(chip_smoke.nccl_group(workdir))
                stack.callback(group[0].destroy_process_group)
            with (replay_spans() if label in REPLAY_TIMED
                  else contextlib.nullcontext([])) as spans:
                rec, more = run()
            recs[label] = rec
            failures += more
            if label in ("fire", "sharded_fire"):
                out[f"{label}_iterations_per_s"] = rec["iterations_per_s"]
                # The timed run is the last replay.
                out[f"{label}_replay_ms"] = spans
                out[f"{label}_replay_ms_per_iteration"] = (
                    spans[-1] / rec["iterations"] if spans else None)
            elif label in ("user", "sharded_user"):
                for k in ("iterations_per_s", "steps_per_s", "fire_s",
                          "nvt_s", "fire_iterations"):
                    out[f"{label}_{k}"] = rec[k]
            elif label == "pack":
                out["pack_seconds"] = rec["seconds"]
                out["pack_fire_iterations"] = rec["fire_iterations"]
                out["pack_replay_ms"] = spans
                out["pack_replay_ms_per_iteration"] = (
                    sum(spans) / rec["fire_iterations"] if spans else None)
            else:
                out[f"{label}_steps_per_s"] = rec["steps_per_s"]
    if failures:
        raise SystemExit(f"paths failed in {tree}: {failures}")
    print(json.dumps(out))


def step_record(prof, launch=None):
    """A profile's numbers of :data:`PROFILE_KEYS` and of the velocity
    finish's and the noise's time and gap in the step, how the small
    kernels launched (``launch``: the run's, for a segment's profile), and
    where the step was captured, the nodes and programmatic edges of its
    lean step's graph."""
    rec = {k: prof[k] for k in PROFILE_KEYS + GAP_KEYS + ("sharded_parts",)
           if k in prof}
    rec["launch"] = launch or prof.get("launch", "plain")
    for variant, nodes in (prof.get("step_graph_nodes") or {}).items():
        rec[f"{variant}_step_nodes"] = nodes["nodes"]
        rec[f"{variant}_step_copies"] = nodes["copies"]
        rec[f"{variant}_step_programmatic_edges"] = nodes.get(
            "programmatic_edges")
    return rec


def last_json(cmd, cwd):
    done = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"{cmd} in {cwd} failed:\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="directory of the other tree")
    parser.add_argument("--paths-worker", help=argparse.SUPPRESS)
    parser.add_argument("--paths", default=",".join(PATHS),
                        help=argparse.SUPPRESS)
    parser.add_argument("--only", choices=sorted(ONLY),
                        help="slot: the slot steps and the b1 and Brownian "
                        "slot paths alone; particle: the particle-order "
                        "steps and the b2, list and Brownian paths alone; "
                        "fire: the captured slot step, FIRE's iterations/s "
                        "and the packing's seconds; sharded: the sharded "
                        "step, the b1 and sharded paths and the sharded "
                        "FIRE; user: config 4's step in slots and sharded "
                        "and its single-device and sharded paths")
    args = parser.parse_args()
    if args.paths_worker:
        return paths_worker(args.paths_worker, args.paths.split(","))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("compare_torch_host: no CUDA device")
    if not args.parent:
        raise SystemExit("compare_torch_host: --parent is required")
    trees = {"parent": os.path.abspath(args.parent), "change": HERE}
    for run, label in enumerate(("parent", "change", "change", "parent")):
        tree = trees[label]
        rec = {"tree": label, "run": run}
        for engine, flags in ENGINES.items():
            if args.only and engine not in ONLY[args.only][0]:
                continue
            prof = last_json([sys.executable,
                              os.path.join(HERE, "profile_torch_step.py"),
                              "--tree", tree, *flags], tree)
            rec[engine] = step_record(prof)
            if "nve" in prof:
                rec[engine]["nve"] = step_record(prof["nve"],
                                                 prof.get("launch"))
        rec.update(last_json([sys.executable, os.path.abspath(__file__),
                              "--paths-worker", tree, "--paths",
                              ",".join(ONLY[args.only][1] if args.only
                                       else PATHS)],
                             tree))
        print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
