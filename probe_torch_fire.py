#!/usr/bin/env python3
"""Where the time of FIRE's two reductions goes on one NVIDIA GPU: a probe
copy of ``mdtpu_torch/csrc/fire_update.cu`` with ``%globaltimer`` and
``clock64`` stamps, built apart from the package (the package has no switch
for it).

    python3 probe_torch_fire.py [--parent DIR] [--calls 100] [--out FILE]

For this tree (and, with ``--parent``, another tree's source: its design is
recognised by its text) the probe inserts stamps at fixed points of
``scaled_reduce_kernel``: a block's entry, after ``griddepcontrol.wait``
(the entry in a design without it), after its thread 0 holds its values
(loads and its own arithmetic), after the block's combine, after the
ticket, and in the last block after the combine of the partials and after
the tail. Thread 0 of each block keeps its stamps in registers and writes
them at its exit, by the call's index. Each source is built twice with the
package's flags, with and without the stamps; this tree's also in variants
(the ticket in a module global, plain stream order, 512 threads a block).

Then ``fire_reduce`` and ``fire_test`` run at bench_fire's slots (3,
124,875) and rows (65,536, 3), f32 and f64, as graphs of ``--calls``
back-to-back calls: each build's device time a call (the graph replayed 20
times between CUDA events, the median of 5 rounds), and from the stamped
build the critical path along the block that took the last ticket, the
median over the calls: ``launch`` (the previous call's end to this call's
first block), ``start`` (its first block to the last block's entry),
``wait``, ``loads``, ``block``, ``ticket``, ``combine``, ``tail``; and
``span`` (first block to the tail's end) and ``period`` (one end to the
next). ``fire_test`` also before an IF node whose handle it sets (the slot
FIRE's pass), which adds ``cudaGraphSetConditional`` to its tail. One JSON
line a case, then the card's name and power limit; ``--out`` keeps the
lines (default ``out_probe/probe_torch_fire.jsonl``, ignored by git).
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

PHASES = ("entry", "wait", "loads", "block", "ticket", "combine", "end")
MAX_BLOCKS = 256
SLOTS, ROWS = (3, 124875), (65536, 3)
WORK = 4096

PROBE_HEAD = r"""
#define PROBE_CALLS 128
#define PROBE_BLOCKS 256
#define PROBE_PHASES 7
__device__ unsigned long long
    g_probe[PROBE_CALLS][PROBE_BLOCKS][PROBE_PHASES][2];
__device__ unsigned int g_probe_call;
__device__ unsigned int g_probe_ticket;
__device__ __forceinline__ unsigned long long probe_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}
#define PROBE_DECL unsigned long long probe_t[PROBE_PHASES][2] = {}; \
  unsigned probe_call = 0;
#define STAMP(k) if (threadIdx.x == 0) { probe_t[k][0] = probe_now(); \
  probe_t[k][1] = clock64(); }
#define PROBE_CALL() if (threadIdx.x == 0) \
  probe_call = *(volatile unsigned*)&g_probe_call;
#define FLUSH() if (threadIdx.x == 0 && probe_call < PROBE_CALLS && \
  blockIdx.x < PROBE_BLOCKS) { for (int k = 0; k < PROBE_PHASES; ++k) { \
  g_probe[probe_call][blockIdx.x][k][0] = probe_t[k][0]; \
  g_probe[probe_call][blockIdx.x][k][1] = probe_t[k][1]; } }
#define FLUSH_LAST() FLUSH(); if (threadIdx.x == 0) { __threadfence(); \
  atomicAdd(&g_probe_call, 1u); }
"""

PROBE_TAIL = r"""
extern "C" int mdtpu_probe_read(unsigned long long* out, unsigned* calls) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  if (!rc) rc = cudaMemcpyFromSymbol(calls, g_probe_call, sizeof(unsigned));
  return (int)rc;
}
extern "C" int mdtpu_probe_reset() {
  static unsigned long long zero[PROBE_CALLS][PROBE_BLOCKS][PROBE_PHASES][2];
  const unsigned z = 0;
  cudaError_t rc = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  if (!rc) rc = cudaMemcpyToSymbol(g_probe_call, &z, sizeof(z));
  return (int)rc;
}
"""

# (anchor, replacement) pairs: the stamps of each design, by its text.
STAMPS = {
    "programmatic": [
        ("  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;\n"
         "  // Before the wait",
         "  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;\n"
         "  PROBE_DECL STAMP(0)\n  // Before the wait"),
        ("  wait_for_dependencies();\n  const bool ovf",
         "  wait_for_dependencies();\n  STAMP(1) PROBE_CALL()\n"
         "  const bool ovf"),
        ("  Part<T> p = thread_part<T, TWO, MAXIMA, SUMS, VEC>(v, f, span, dt,"
         " g);\n",
         "  Part<T> p = thread_part<T, TWO, MAXIMA, SUMS, VEC>(v, f, span, dt,"
         " g);\n  STAMP(2)\n"),
        ("  combine_lanes<T, TWO, MAXIMA, SUMS, MAXIMA, kWarps / 2>(p);\n",
         "  combine_lanes<T, TWO, MAXIMA, SUMS, MAXIMA, kWarps / 2>(p);\n"
         "  STAMP(3)\n"),
        ("    last = __shfl_sync(kAll, (int)last, 0) != 0;\n"
         "    if (!last) return;\n",
         "    last = __shfl_sync(kAll, (int)last, 0) != 0;\n    STAMP(4)\n"
         "    if (!last) { FLUSH() return; }\n"),
        ("    if (lane == 0) ticket.store(0u, cuda::memory_order_relaxed);\n",
         "    STAMP(5)\n"
         "    if (lane == 0) ticket.store(0u, cuda::memory_order_relaxed);\n"),
        ("      test_tail<T>(p, false, drift, s, scal, ints, sqrt_ndof, t);\n"
         "  }\n}\n",
         "      test_tail<T>(p, false, drift, s, scal, ints, sqrt_ndof, t);\n"
         "  }\n  STAMP(6) FLUSH_LAST()\n}\n"),
    ],
    "stream_order": [
        ("  __shared__ bool last;\n",
         "  __shared__ bool last;\n  PROBE_DECL STAMP(0) STAMP(1) "
         "PROBE_CALL()\n"),
        ("      block_reduce<T, 2, 2>(m, s);\n    } else {",
         "      STAMP(2)\n      block_reduce<T, 2, 2>(m, s);\n    } else {"),
        ("      block_reduce<T, 3, 0>(q, s);\n    }\n",
         "      block_reduce<T, 3, 0>(q, s);\n    }\n    STAMP(3)\n"),
        ("      last = atomicAdd(ticket, 1u) == (unsigned)grid - 1;\n",
         "      last = atomicAdd(ticket, 1u) == (unsigned)grid - 1;\n"
         "      STAMP(4)\n"),
        ("    if (!last) return;\n", "    if (!last) { FLUSH() return; }\n"),
        ("    if (threadIdx.x == 0) {\n      red[kMaxA] = g[0];",
         "    STAMP(5)\n    if (threadIdx.x == 0) {\n      red[kMaxA] = g[0];"),
        ("                t.h_a, t.h_b, t.set_a, t.set_b);\n  }\n}\n",
         "                t.h_a, t.h_b, t.set_a, t.set_b);\n  }\n"
         "  STAMP(6) FLUSH_LAST()\n}\n"),
    ],
}

# This tree's variants (on the programmatic design): name -> edits.
VARIANTS = {
    "global_ticket": [
        ("ticket(\n        *reinterpret_cast<unsigned*>(work));",
         "ticket(\n        g_probe_ticket);")],
    "plain_launch": [("  cfg.numAttrs = 1;\n", "  cfg.numAttrs = 0;\n")],
    "threads512": [("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 512;")],
}


def design(src):
    return "programmatic" if "griddepcontrol.wait" in src else "stream_order"


def patched(src, edits):
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"probe: anchor not found once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def probe_source(src, stamped):
    """The source with the probe's globals (and, where ``stamped``, the
    stamps of its design) inserted after its includes."""
    if stamped:
        src = patched(src, STAMPS[design(src)])
    at = src.index("namespace {")
    return src[:at] + PROBE_HEAD + src[at:] + PROBE_TAIL


def build(name, src, csrc, out_dir):
    """Compile ``src`` (a variant of ``csrc/fire_update.cu``) with the
    package's flags into ``out_dir/lib<name>.so``."""
    from mdtpu_torch.ops import _cuda_build
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{name}.so")
    cmd = [_cuda_build.nvcc(), *_cuda_build.NVCC_FLAGS, "-I", csrc, "-o",
           lib, path]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"probe: nvcc failed on {name}:\n{proc.stderr}")
    return lib


def load(lib_path):
    P, I, L, D, Q = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_double, ctypes.c_ulonglong)
    lib = ctypes.CDLL(lib_path)
    for s in ("f32", "f64"):
        getattr(lib, f"mdtpu_fire_reduce_{s}").argtypes = [
            P, P, L, P, P, P, P, L, P, I, D, D, D, D, D, L, P]
        getattr(lib, f"mdtpu_fire_test_{s}").argtypes = [
            P, L, P, P, P, P, L, P, P, P, D, I, I, Q, Q, I, I, P]
    lib.mdtpu_probe_read.argtypes = [P, P]
    return lib


class Case:
    """One kernel's inputs at one shape and dtype: FIRE's buffers (dt 0.03,
    alpha 0.07, tol 1e-3, the loop going on), forces ~30, velocities
    along them."""

    def __init__(self, kernel, shape, dtype):
        g = torch.Generator(device="cuda").manual_seed(21)
        self.kernel, self.dtype = kernel, dtype
        self.f = (torch.randn(shape, device="cuda", generator=g) * 30).to(
            dtype)
        self.v = (torch.randn(shape, device="cuda", generator=g)
                  + 0.01 * self.f).to(dtype)
        self.scal = torch.zeros(7, dtype=dtype, device="cuda")
        self.scal[0], self.scal[1], self.scal[3] = 0.03, 0.07, 1e-3
        self.ints = torch.zeros(9, dtype=torch.int64, device="cuda")
        self.ints[2] = 1 << 60
        self.red = torch.zeros(5, dtype=dtype, device="cuda")
        self.work = torch.zeros(WORK, dtype=dtype, device="cuda")
        self.flags = torch.zeros(2, dtype=torch.bool, device="cuda")
        self.drift = torch.ones((), dtype=torch.bool, device="cuda")

    def call(self, lib, h_b=0):
        s = "f32" if self.dtype == torch.float32 else "f64"
        stream = torch.cuda.current_stream().cuda_stream
        if self.kernel == "fire_reduce":
            rc = getattr(lib, f"mdtpu_fire_reduce_{s}")(
                self.v.data_ptr(), self.f.data_ptr(), self.f.numel(),
                self.scal.data_ptr(), self.ints.data_ptr(),
                self.red.data_ptr(), self.work.data_ptr(), WORK, None, 7,
                1.2, 0.2, 0.1, 0.01, 0.1, 5, stream)
        else:
            rc = getattr(lib, f"mdtpu_fire_test_{s}")(
                self.f.data_ptr(), self.f.numel(), self.scal.data_ptr(),
                self.ints.data_ptr(), self.red.data_ptr(),
                self.work.data_ptr(), WORK, None, self.drift.data_ptr(),
                self.flags.data_ptr(), 17.0, 7, 0, 0, h_b, 0, int(h_b != 0),
                stream)
        if rc:
            raise SystemExit(f"probe: {self.kernel} launch failed ({rc})")


def captured(case, lib, calls, with_if):
    """A CUDA graph of ``calls`` calls of the case (each before an IF node
    whose handle it sets, where ``with_if``)."""
    from mdtpu_torch.ops import philox_draws
    case.call(lib)
    torch.cuda.synchronize()
    graph, pools = torch.cuda.CUDAGraph(), []
    device = torch.device("cuda", torch.cuda.current_device())
    with torch.cuda.graph(graph):
        for _ in range(calls):
            if with_if:
                with philox_draws.graph_if(
                        lambda h: case.call(lib, h_b=h), device, pools):
                    pass
            else:
                case.call(lib)
    return graph, pools


def replay_ms(graph, calls):
    """Device ms a call: the graph replayed 20 times between two CUDA
    events, over the calls; the median of 5 rounds."""
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


def split(lib, graph, calls):
    """One replay's stamps: the critical path along the block that took the
    last ticket, each phase's median over the calls (ns; clock64 cycles
    beside), the first calls left out."""
    if lib.mdtpu_probe_reset():
        raise SystemExit("probe: reset failed")
    graph.replay()
    torch.cuda.synchronize()
    raw = np.zeros((128, MAX_BLOCKS, len(PHASES), 2), dtype=np.uint64)
    got = ctypes.c_uint(0)
    if lib.mdtpu_probe_read(raw.ctypes.data, ctypes.byref(got)):
        raise SystemExit("probe: read failed")
    n = min(got.value, calls, 128)
    t = raw[:n, :, :, 0].astype(np.int64)
    c = raw[:n, :, :, 1].astype(np.int64)
    seen = t[:, :, 0] > 0
    rows = {k: [] for k in ("launch", "start", "wait", "loads", "block",
                            "ticket", "combine", "tail", "span", "period",
                            "blocks")}
    cycles = {k: [] for k in ("wait", "loads", "block", "ticket", "combine",
                              "tail")}
    prev_end = None
    for i in range(n):
        blocks = np.flatnonzero(seen[i])
        first = t[i, blocks, 0].min()
        # The block that ran the tail (the last ticket, or the only block).
        last = blocks[np.argmax(t[i, blocks, 6])]
        s = t[i, last]
        cs = c[i, last]
        ended = s[6]
        if s[4] == 0:       # one block: no ticket
            s = s.copy()
            cs = cs.copy()
            s[4] = s[5] = s[3]
            cs[4] = cs[5] = cs[3]
        if i >= 3:
            rows["launch"].append(first - prev_end)
            rows["start"].append(s[0] - first)
            for k, (a, b) in (("wait", (0, 1)), ("loads", (1, 2)),
                              ("block", (2, 3)), ("ticket", (3, 4)),
                              ("combine", (4, 5)), ("tail", (5, 6))):
                rows[k].append(s[b] - s[a])
                cycles[k].append(cs[b] - cs[a])
            rows["span"].append(ended - first)
            rows["period"].append(ended - prev_end)
            rows["blocks"].append(len(blocks))
        prev_end = ended
    ticks = np.diff(np.unique(t[:n, :, :][t[:n, :, :] > 0]))
    return {"ns": {k: float(np.median(v)) for k, v in rows.items() if v},
            "clock64_cycles": {k: float(np.median(v))
                               for k, v in cycles.items() if v},
            "calls_read": int(n),
            "globaltimer_step_ns": int(ticks[ticks > 0].min())
            if ticks.size and (ticks > 0).any() else None}


def build_stamped(out_dir, tree=HERE):
    """``tree``'s source with its design's stamps, built into ``out_dir``
    and loaded."""
    csrc = os.path.join(tree, "mdtpu_torch", "csrc")
    with open(os.path.join(csrc, "fire_update.cu")) as f:
        src = f.read()
    return load(build("stamped", probe_source(src, True), csrc, out_dir))


def case_split(lib, kernel, shape, dtype, calls=100, with_if=False):
    """:func:`split` of ``kernel`` at ``shape`` and ``dtype`` from a stamped
    library, and that graph's time a call (``stamped_ms``)."""
    case = Case(kernel, shape, dtype)
    graph, pools = captured(case, lib, calls, with_if)
    rec = split(lib, graph, calls)
    rec["stamped_ms"] = replay_ms(graph, calls)
    del pools
    return rec


CASES = [(k, layout, shape, dtype)
         for k in ("fire_reduce", "fire_test")
         for layout, shape in (("slots", SLOTS), ("rows", ROWS))
         for dtype in (torch.float32, torch.float64)]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="another tree's directory")
    parser.add_argument("--calls", type=int, default=100)
    parser.add_argument("--out", default=os.path.join(
        HERE, "out_probe", "probe_torch_fire.jsonl"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_fire: no CUDA device")
    trees = {"change": HERE}
    if args.parent:
        trees["parent"] = os.path.abspath(args.parent)
    sources = {}
    for label, tree in trees.items():
        csrc = os.path.join(tree, "mdtpu_torch", "csrc")
        with open(os.path.join(csrc, "fire_update.cu")) as f:
            src = f.read()
        sources[label] = (src, csrc)
        if label == "change":
            for name, edits in VARIANTS.items():
                sources[name] = (patched(src, edits), csrc)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    lines = []

    def emit(rec):
        print(json.dumps(rec), flush=True)
        lines.append(json.dumps(rec))

    with tempfile.TemporaryDirectory() as tmp:
        jobs = {(label, stamped): (f"{label}_{int(stamped)}",
                                   probe_source(src, stamped), csrc)
                for label, (src, csrc) in sources.items()
                for stamped in (False, True)}
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futures = {key: pool.submit(build, *job, tmp)
                       for key, job in jobs.items()}
        libs = {key: load(fut.result()) for key, fut in futures.items()}
        emit({"built": sorted(f"{a}{'_stamped' if b else ''}"
                              for a, b in libs),
              "designs": {label: design(src)
                          for label, (src, _) in sources.items()}})
        for kernel, layout, shape, dtype in CASES:
            ifs = (False, True) if kernel == "fire_test" and dtype == \
                torch.float32 and layout == "slots" else (False,)
            for with_if in ifs:
                case = Case(kernel, shape, dtype)
                rec = {"kernel": kernel, "layout": layout,
                       "dtype": str(dtype)[6:], "shape": list(shape),
                       "before_if_node": with_if, "ms": {}, "split": {}}
                # In turns: each build timed, then each stamped build split.
                order = list(sources) + list(reversed(list(sources)))
                times = {label: [] for label in sources}
                for label in order:
                    graph, _pools = captured(case, libs[(label, False)],
                                             args.calls, with_if)
                    times[label].append(replay_ms(graph, args.calls))
                rec["ms"] = {k: statistics.mean(v) for k, v in times.items()}
                for label in sources:
                    rec["split"][label] = case_split(
                        libs[(label, True)], kernel, shape, dtype,
                        args.calls, with_if)
                emit(rec)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"card": smi})
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
