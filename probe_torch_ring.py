#!/usr/bin/env python3
"""Whether a shard ring's collectives can sit inside CUDA-graph conditional
nodes on this stack: the all-reduces of ``mdtpu_torch.parallel.ShardRing``
over a one-rank NCCL group, captured into a plain graph, into a WHILE
node's body (``philox_draws.graph_while``) and into an IF node's body
nested in that WHILE body (``philox_draws.graph_if``), then replayed and
checked.

    python3 probe_torch_ring.py [--out FILE]

Each case runs in a process of its own (a failed capture leaves nothing
behind for the next; a hung collective is killed after 120 s) and prints
one JSON line: whether the capture and the replay succeeded, the values
against the expected ones, the nodes of each body as
``philox_draws.capture_census`` reads them (what a one-rank all-reduce
adds to a graph), and the error, verbatim, where one was raised. The
cases:

  * ``plain``: an all-reduce (``ring.sum``, a clone then NCCL) in a plain
    graph;
  * ``while``: a WHILE node of 5 passes whose body adds one to a counter,
    all-reduces it (``ring.max``, and in place) and adds the result to an
    accumulator, the loop test ``philox_draws.step_below`` last;
  * ``if_in_while``: the same WHILE node, its body also holding an IF
    node, taken in the first 3 passes (``step_below`` against a second
    end sets its handle), whose body all-reduces (``ring.sum``) and adds
    to a second accumulator.

Then the PyTorch, CUDA and NCCL versions, the card's name and power limit.
``--out`` keeps the lines (default ``out_probe/probe_torch_ring.jsonl``,
ignored by git).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import traceback

import torch

CASES = ("plain", "while", "if_in_while")
PASSES, IF_PASSES = 5, 3
TIMEOUT = 120


def _group(workdir):
    import torch.distributed as dist
    dist.init_process_group("nccl",
                            init_method=f"file://{workdir}/nccl_store",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    return dist


def run_case(case):
    """One case in this process: its record."""
    from mdtpu_torch.integrate.device_advance import capture, device_while
    from mdtpu_torch.ops import philox_draws
    from mdtpu_torch.parallel.mesh import ShardRing

    workdir = tempfile.mkdtemp(prefix="probe_ring_")
    dist = _group(workdir)
    rec = {"case": case}
    try:
        ring = ShardRing()
        dev = ring.device
        i64 = dict(dtype=torch.int64, device=dev)
        counter = torch.zeros((), **i64)
        end = torch.full((), PASSES, **i64)
        # The IF node is taken while the counter, advanced first in the
        # pass, is at most IF_PASSES.
        if_end = torch.full((), IF_PASSES + 1, **i64)
        acc = torch.zeros((), dtype=torch.float64, device=dev)
        acc_if = torch.zeros_like(acc)
        acc_inplace = torch.zeros_like(acc)
        going = torch.zeros((), dtype=torch.bool, device=dev)
        taken = torch.zeros_like(going)
        census = {}

        def body_work():
            counter.add_(1)
            acc.add_(ring.max(counter.double()))
            t = counter.double()
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
            acc_inplace.add_(t)

        def if_body():
            acc_if.add_(ring.sum(counter.double()))
            census["if_body"] = philox_draws.capture_census(dev)

        def program(pools, counts):
            if case == "plain":
                body_work()
                census["graph"] = philox_draws.capture_census(dev)
                return

            def body(handle):
                body_work()
                if case == "if_in_while":
                    with philox_draws.graph_if(
                            lambda h: philox_draws.step_below(
                                counter, if_end, taken, h), dev, pools):
                        if_body()
                census["while_body"] = philox_draws.capture_census(dev)
                philox_draws.step_below(counter, end, going, handle)

            device_while(going, lambda h: philox_draws.step_below(
                counter, end, going, h), body, pools)
            census["graph"] = philox_draws.capture_census(dev)

        def warm():
            body_work()
            acc_if.add_(ring.sum(counter.double()))

        try:
            graph, pools, _ = capture(dev, warm, program)
            rec["captured"] = True
        except Exception as e:  # the outcome is the record
            rec.update(captured=False, error=repr(e),
                       traceback=traceback.format_exc()[-4000:])
            return rec
        for t in (counter, acc, acc_if, acc_inplace):
            t.zero_()
        try:
            graph.replay()
            torch.cuda.synchronize()
            rec["replayed"] = True
        except Exception as e:
            rec.update(replayed=False, error=repr(e),
                       traceback=traceback.format_exc()[-4000:])
            return rec
        n = 1 if case == "plain" else PASSES
        want = {"counter": n, "acc": n * (n + 1) / 2,
                "acc_inplace": n * (n + 1) / 2,
                "acc_if": (IF_PASSES * (IF_PASSES + 1) / 2
                           if case == "if_in_while" else 0.0)}
        got = {"counter": int(counter), "acc": float(acc),
               "acc_inplace": float(acc_inplace), "acc_if": float(acc_if)}
        rec.update(got=got, want=want, ok=got == want,
                   census={k: {n: v for n, v in c.items()
                               if n in ("nodes", "kernels", "copies",
                                        "memsets", "conditionals", "others",
                                        "dot_nodes")}
                           for k, c in census.items()})
        return rec
    finally:
        dist.destroy_process_group()


def versions():
    nccl = torch.cuda.nccl.version()
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nccl": ".".join(map(str, nccl)) if isinstance(nccl, tuple)
            else nccl, "device": torch.cuda.get_device_name(0)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--case", choices=CASES,
                        help="run one case in this process")
    parser.add_argument("--out", default="out_probe/probe_torch_ring.jsonl")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_ring.py needs a CUDA device", file=sys.stderr)
        return 2
    if args.case:
        print(json.dumps(run_case(args.case)), flush=True)
        return 0
    lines = [json.dumps(versions())]
    here = os.path.dirname(os.path.abspath(__file__))
    for case in CASES:
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--case", case],
                cwd=here, capture_output=True, text=True, timeout=TIMEOUT)
            out = [line for line in proc.stdout.splitlines()
                   if line.startswith("{")]
            rec = (json.loads(out[-1]) if out else
                   {"case": case, "exit": proc.returncode,
                    "stderr": proc.stderr[-4000:]})
        except subprocess.TimeoutExpired:
            rec = {"case": case, "error": f"timed out after {TIMEOUT} s"}
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    lines.append(json.dumps({"nvidia_smi": smi}))
    print(lines[0])
    print(lines[-1])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
