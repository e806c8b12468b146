#!/usr/bin/env python3
"""Hold the host side of two trees of this repository against each other on
one NVIDIA GPU: the bare step's host-clock time and the dynamics paths'
steps/s, both trees within one call.

    git archive <commit> | tar -x -C out_parent      # the other tree
    python3 compare_torch_host.py --parent out_parent

Each tree runs, in the order parent, change, change, parent, and each in
processes of its own started in that tree (so each builds and loads its own
kernels): its ``profile_torch_step.py --engine cellgrid`` (the cell grid in
particle order) and ``--engine plane`` (``PlaneEngine``), then the ``b2``
path (600 NVT + 500 NVE + 500 force-shifted NVE at the bench configuration
on ``PlaneEngine``) and the Brownian path on ``PlaneEngine`` of its
``chip_smoke.py``. The host's clock moves with the machine and with what
else runs on it, so two trees are compared only within one such call.
Prints one JSON line per tree and run: each profile's host ms, device busy
ms, launches and host reads per step, and each path's steps/s; then the
card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
PROFILE_KEYS = ("ms_per_step_host_clock", "device_busy_ms_per_step",
                "device_idle_share_profiled", "kernel_launches_per_step",
                "host_syncs_per_step")


def paths_worker(tree):
    """Run the tree's ``b2`` and Brownian paths; print their steps/s."""
    sys.path.insert(0, tree)
    import chip_smoke
    import mdtpu_torch as mt
    from mdtpu_torch.ops.experimental import PlaneEngine

    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        b2, failures = chip_smoke.md_path(
            mt, workdir, "b2",
            lambda st, pot: PlaneEngine.create(pot, 2.5, 0.3, st.unitcell,
                                               chip_smoke.N_BENCH), False)
        bd, more = chip_smoke.brownian_path(mt, workdir)
    if failures + more:
        raise SystemExit(f"paths failed in {tree}: {failures + more}")
    out["b2_steps_per_s"] = b2["steps_per_s"]
    out["brownian_steps_per_s"] = bd["steps_per_s"]
    print(json.dumps(out))


def last_json(cmd, cwd):
    done = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"{cmd} in {cwd} failed:\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="directory of the other tree")
    parser.add_argument("--paths-worker", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.paths_worker:
        return paths_worker(args.paths_worker)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("compare_torch_host: no CUDA device")
    if not args.parent:
        raise SystemExit("compare_torch_host: --parent is required")
    trees = {"parent": os.path.abspath(args.parent), "change": HERE}
    for run, label in enumerate(("parent", "change", "change", "parent")):
        tree = trees[label]
        rec = {"tree": label, "run": run}
        for engine in ("cellgrid", "plane"):
            prof = last_json([sys.executable, "profile_torch_step.py",
                              "--engine", engine], tree)
            rec[engine] = {k: prof[k] for k in PROFILE_KEYS}
        rec.update(last_json([sys.executable, os.path.abspath(__file__),
                              "--paths-worker", tree], tree))
        print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
