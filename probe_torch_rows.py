#!/usr/bin/env python3
"""Where the time of the particle rows' drift test and Brownian move goes on
one NVIDIA GPU: probe copies of ``mdtpu_torch/csrc/philox_draws.cu``
(``rebuild_rows_kernel``) and ``mdtpu_torch/csrc/verlet_update.cu``
(``brownian_rows_kernel``) with ``%globaltimer`` and ``clock64`` stamps,
built apart from the package (the package has no switch for it).

    python3 probe_torch_rows.py [--parent DIR] [--calls 100] [--out FILE]

For this tree (and, with ``--parent``, another tree's sources: each
kernel's design is recognised by its text) the probe inserts stamps at
fixed points of each kernel. The drift test: a block's entry, after
``griddepcontrol.wait`` (the entry in a design without it), after its
thread 0 has tested its particles (loads and arithmetic), after the
block's OR, after the ticket, and in the last block after the flag and the
IF node's handle. The Brownian move: the entry, after thread 0's Philox
draws and loads, after the wait (the draws' stamp in a design without
it), after its particle is moved and stored, after its block is done
(this design: thread 0's own work; the design before: the block's
barrier), after the ticket, and in the last block after the step's
scalars (this design: both by the ticket warp's thread, beside the
particles). Thread 0 of each block keeps its stamps in registers and
writes them at its exit, by the call's index. Each source is built twice
with the package's flags, with and without the stamps, each in a
directory of its own (a source takes the shared headers beside it first);
this tree's also in variants: 128 threads a block, and the drift test's
word in a buffer of the probe's instead of a module global. This tree's
kernels are also timed in plain stream order (their options word 0).

Then each kernel runs at 65,536 particle rows (the bench's count, d = 3):
the drift test by the cell (f32, f64) and by the box lengths (f32; this
tree reads the cell's diagonal at stride 4, the parent a contiguous copy),
no particle past skin/2, and by the cell before an IF node whose handle it
sets (f32); the Brownian move compensated (f32, f64), in place with a
device step counter. Each as a graph of ``--calls`` back-to-back calls:
each build's device time a call (the graph replayed 20 times between CUDA
events, the median of 5 rounds; builds in turns), and from the stamped
build the critical path along the block that ran the tail, the median over
the calls: ``launch`` (the previous call's end to this call's first
block), ``start`` (its first block to that block's entry), then each
phase, ``span`` (first block to the tail's end) and ``period`` (one end to
the next). One JSON line a case, then the card's name and power limit;
``--out`` keeps the lines (default ``out_probe/probe_torch_rows.jsonl``,
ignored by git).
"""

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

N = 65536
BOX = (N / 0.8) ** (1.0 / 3.0)
MAX_BLOCKS = 512
PHASES = {"rebuild_rows": ("entry", "wait", "tested", "block", "ticket",
                           "end"),
          "brownian_rows": ("entry", "draws", "wait", "moved", "block",
                            "ticket", "end")}
SOURCES = {"rebuild_rows": "philox_draws", "brownian_rows": "verlet_update"}
# Where each kernel's text starts: its stamps go in from there.
KERNEL_AT = {"rebuild_rows": "    rebuild_rows_kernel(const T* __restrict__ "
                             "pos, const T* __restrict__ ref,",
             "brownian_rows": "    brownian_rows_kernel(BrownianRowsArgs<T> "
                              "a, int64_t n, T drift, T sigma,"}

PROBE_HEAD = r"""
#define PROBE_CALLS 128
#define PROBE_BLOCKS 512
#define PROBE_PHASES 7
__device__ unsigned long long
    g_probe[PROBE_CALLS][PROBE_BLOCKS][PROBE_PHASES][2];
__device__ unsigned int g_probe_call;
__constant__ unsigned int* g_probe_word;
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
  blockIdx.x < PROBE_BLOCKS) { for (int k = 0; k < PROBE_PHASES; ++k) \
  if (probe_t[k][0]) { \
  g_probe[probe_call][blockIdx.x][k][0] = probe_t[k][0]; \
  g_probe[probe_call][blockIdx.x][k][1] = probe_t[k][1]; } }
#define PROBE_AT(c, k) if ((c) < PROBE_CALLS && blockIdx.x < PROBE_BLOCKS) \
  { g_probe[c][blockIdx.x][k][0] = probe_now(); \
  g_probe[c][blockIdx.x][k][1] = clock64(); }
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
extern "C" int mdtpu_probe_word(unsigned* word) {
  return (int)cudaMemcpyToSymbol(g_probe_word, &word, sizeof(word));
}
"""

# (anchor, replacement) pairs inside each kernel's text, by its design.
STAMPS = {
    ("rebuild_rows", "programmatic"): [
        ("  const int64_t threads = (int64_t)gridDim.x * blockDim.x;\n",
         "  PROBE_DECL STAMP(0)\n"
         "  const int64_t threads = (int64_t)gridDim.x * blockDim.x;\n"),
        ("  wait_for_dependencies();\n  RowsBox<T, D, CELL> box;\n",
         "  wait_for_dependencies();\n  STAMP(1) PROBE_CALL()\n"
         "  RowsBox<T, D, CELL> box;\n"),
        ("  any = __syncthreads_or(any);\n",
         "  STAMP(2)\n  any = __syncthreads_or(any);\n  STAMP(3)\n"),
        ("    if ((before & 0xFFFFu) != gridDim.x - 1) return;\n",
         "    STAMP(4)\n    if ((before & 0xFFFFu) != gridDim.x - 1) "
         "{ FLUSH() return; }\n"),
        ("  if (set_handle) cudaGraphSetConditional(handle, any ? 1u : 0u);"
         "\n}\n",
         "  if (set_handle) cudaGraphSetConditional(handle, any ? 1u : 0u);"
         "\n  STAMP(5) FLUSH_LAST()\n}\n"),
    ],
    ("rebuild_rows", "plain"): [
        ("  T len[D];\n",
         "  PROBE_DECL STAMP(0) STAMP(1) PROBE_CALL()\n  T len[D];\n"),
        ("  any = __syncthreads_or(any);\n",
         "  STAMP(2)\n  any = __syncthreads_or(any);\n  STAMP(3)\n"),
        ("  if (atomicAdd(&g_rows_ticket, 1u) != gridDim.x - 1) return;\n",
         "  const bool probe_last = atomicAdd(&g_rows_ticket, 1u) == "
         "gridDim.x - 1;\n  STAMP(4)\n  if (!probe_last) { FLUSH() return; }"
         "\n"),
        ("  if (set_handle) cudaGraphSetConditional(handle, hit ? 1u : 0u);"
         "\n}\n",
         "  if (set_handle) cudaGraphSetConditional(handle, hit ? 1u : 0u);"
         "\n  STAMP(5) FLUSH_LAST()\n}\n"),
    ],
    # Thread 0 stamps the particles' phases; the ticket warp's thread, which
    # takes the ticket and writes the step's scalars beside them, stamps its
    # own two into the same record.
    ("brownian_rows", "programmatic"): [
        ("                         T ktemp, uint2 key, uint32_t stream) {\n",
         "                         T ktemp, uint2 key, uint32_t stream) {\n"
         "  PROBE_DECL STAMP(0)\n"),
        ("    __syncthreads();  // the tile's noise",
         "    STAMP(1)\n    __syncthreads();  // the tile's noise"),
        ("      wait_for_dependencies();\n      waited = true;\n",
         "      wait_for_dependencies();\n      waited = true;\n"
         "      STAMP(2) PROBE_CALL()\n"),
        ("      store_row<int64_t, D>(a.img_out, i, img);\n    }\n",
         "      store_row<int64_t, D>(a.img_out, i, img);\n      STAMP(3)\n"
         "    }\n"),
        ("  if (!waited) wait_for_dependencies();\n"
         "  if (threadIdx.x != kBrownianRowsThreads - 1) return;\n",
         "  if (!waited) wait_for_dependencies();\n  STAMP(4) FLUSH()\n"
         "  if (threadIdx.x != kBrownianRowsThreads - 1) return;\n"
         "  const unsigned probe_c = *(volatile unsigned*)&g_probe_call;\n"),
        ("  if (ticket.fetch_add(1u, cuda::memory_order_acq_rel) != gridDim.x - 1)"
         "\n    return;\n",
         "  const bool probe_last = ticket.fetch_add(1u, "
         "cuda::memory_order_acq_rel) == gridDim.x - 1;\n"
         "  PROBE_AT(probe_c, 5)\n  if (!probe_last) return;\n"),
        ("  ticket.store(0u, cuda::memory_order_relaxed);\n}\n",
         "  ticket.store(0u, cuda::memory_order_relaxed);\n"
         "  PROBE_AT(probe_c, 6)\n  __threadfence();\n"
         "  atomicAdd(&g_probe_call, 1u);\n}\n"),
    ],
    ("brownian_rows", "plain"): [
        ("                         T ktemp, uint2 key, uint32_t stream) {\n",
         "                         T ktemp, uint2 key, uint32_t stream) {\n"
         "  PROBE_DECL STAMP(0) PROBE_CALL()\n"),
        ("    T f[D], x[D], xc[D];\n",
         "    STAMP(1) STAMP(2)\n    T f[D], x[D], xc[D];\n"),
        ("    if (COMP) store_row<T, D>(a.xc_out, i, xc);\n  }\n",
         "    if (COMP) store_row<T, D>(a.xc_out, i, xc);\n  }\n"
         "  STAMP(3)\n"),
        ("  __syncthreads();\n  if (threadIdx.x != 0) return;\n",
         "  __syncthreads();\n  STAMP(4)\n  if (threadIdx.x != 0) return;\n"),
        ("  if (ticket.fetch_add(1u, cuda::memory_order_acq_rel) != gridDim.x - 1)"
         "\n    return;\n",
         "  const bool probe_last = ticket.fetch_add(1u, "
         "cuda::memory_order_acq_rel) == gridDim.x - 1;\n  STAMP(5)\n"
         "  if (!probe_last) { FLUSH() return; }\n"),
        ("  ticket.store(0u, cuda::memory_order_relaxed);\n}\n",
         "  ticket.store(0u, cuda::memory_order_relaxed);\n"
         "  STAMP(6) FLUSH_LAST()\n}\n"),
    ],
}

# This tree's variants: (file, anchor, replacement) edits.
VARIANTS = {
    "threads128": [("particle_rows.cuh", "constexpr int kRowsThreads = 256;",
                    "constexpr int kRowsThreads = 128;")],
    "word_in_buffer": [
        ("philox_draws.cu",
         "    cuda::atomic_ref<unsigned, cuda::thread_scope_device> word("
         "g_rows_word);",
         "    cuda::atomic_ref<unsigned, cuda::thread_scope_device> word("
         "*g_probe_word);")],
}


def design(src, kernel):
    """``programmatic`` (a programmatic dependent: this slice's design) or
    ``plain`` (plain stream order, the design before it)."""
    at = src.index(KERNEL_AT[kernel])
    return ("programmatic" if "wait_for_dependencies" in src[at:at + 3000]
            else "plain")


def patched(src, edits, start=0):
    """``src`` with each (anchor, replacement) made once, after ``start``."""
    head, body = src[:start], src[start:]
    for old, new in edits:
        if body.count(old) < 1:
            raise SystemExit(f"probe: anchor not found: {old[:60]!r}")
        body = body.replace(old, new, 1)
    return head + body


def probe_source(src, name, stamped):
    """The source of library ``name`` with the probe's globals (and, where
    ``stamped``, the stamps of its kernel's design) inserted."""
    kernel = next(k for k, s in SOURCES.items() if s == name)
    if stamped:
        at = src.index(KERNEL_AT[kernel])
        src = patched(src, STAMPS[(kernel, design(src, kernel))], at)
    at = src.index("namespace {")
    return src[:at] + PROBE_HEAD + src[at:] + PROBE_TAIL


def build(label, files, name, out_dir):
    """Write ``files`` ({file name: text}: the source and the shared headers
    beside it) into a directory of their own and compile ``name``.cu with
    the package's flags into ``lib<name>.so`` there."""
    from mdtpu_torch.ops import _cuda_build
    where = os.path.join(out_dir, label)
    os.makedirs(where, exist_ok=True)
    for fname, text in files.items():
        with open(os.path.join(where, fname), "w") as f:
            f.write(text)
    lib = os.path.join(where, f"lib{name}.so")
    cmd = [_cuda_build.nvcc(), *_cuda_build.NVCC_FLAGS, "-I", where, "-o",
           lib, os.path.join(where, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"probe: nvcc failed on {label}:\n{proc.stderr}")
    return lib


def tree_files(tree):
    """Every source and header of ``tree``'s csrc, by file name."""
    csrc = os.path.join(tree, "mdtpu_torch", "csrc")
    return {f: open(os.path.join(csrc, f)).read() for f in os.listdir(csrc)
            if f.endswith((".cu", ".cuh"))}


def jobs_of(label, files, stamped):
    """The builds of one tree's files: {(label, kernel, stamped): args}."""
    out = {}
    for kernel, name in SOURCES.items():
        src = probe_source(files[f"{name}.cu"], name, stamped)
        headers = {f: t for f, t in files.items() if f.endswith(".cuh")}
        out[(label, kernel, stamped)] = (
            f"{label}_{name}_{int(stamped)}", {**headers, f"{name}.cu": src},
            name)
    return out


P, I, L, D, Q, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_double, ctypes.c_ulonglong, ctypes.c_uint)


def load(lib_path, kernel, groups):
    """The library with its kernel's entry points typed for its design
    (``groups``: this slice's, which takes the lengths' stride and the
    launch options)."""
    lib = ctypes.CDLL(lib_path)
    for s in ("f32", "f64"):
        if kernel == "rebuild_rows":
            args = ([P, P, P, P, L, I, L, D, P, Q, I, I, P] if groups
                    else [P, P, P, P, I, L, D, P, Q, I, P])
            getattr(lib, f"mdtpu_rebuild_rows_{s}").argtypes = args
        else:
            args = [I, I, L] + [P] * 17 + [L, D, D, D, U, U, U] + (
                [I, P] if groups else [P])
            getattr(lib, f"mdtpu_brownian_rows_{s}").argtypes = args
    lib.mdtpu_probe_read.argtypes = [P, P]
    lib.mdtpu_probe_word.argtypes = [P]
    lib.groups = groups
    return lib


class Case:
    """One kernel's inputs at 65,536 rows (d = 3) of ``dtype``: positions in
    the bench's cubic box and references within 0.05 of them (the drift
    test, skin 0.3: no particle past skin/2), or forces ~30, compensation
    ~1e-7, images and a device step counter (the Brownian move)."""

    def __init__(self, kernel, dtype, form="cell"):
        g = torch.Generator(device="cuda").manual_seed(22)
        self.kernel, self.dtype, self.form = kernel, dtype, form
        shape = (N, 3)
        self.x = (torch.rand(shape, device="cuda", generator=g,
                             dtype=torch.float64) * BOX).to(dtype)
        self.cell = torch.eye(3, dtype=dtype, device="cuda") * BOX
        self.cell_inv = torch.eye(3, dtype=dtype, device="cuda") / BOX
        self.lengths = torch.diagonal(self.cell).contiguous()
        self.ref = (self.x.double() + (torch.rand(
            shape, device="cuda", generator=g, dtype=torch.float64) - 0.5)
            * 0.1).to(dtype)
        self.flag = torch.zeros((), dtype=torch.bool, device="cuda")
        self.f = (torch.randn(shape, device="cuda", generator=g) * 30).to(
            dtype)
        self.xc = (torch.randn(shape, device="cuda", generator=g)
                   * 1e-7).to(dtype)
        self.img = torch.zeros(shape, dtype=torch.int64, device="cuda")
        self.scalars = torch.zeros(4, dtype=dtype, device="cuda")
        self.nprom = torch.zeros((), dtype=torch.int64, device="cuda")
        self.step = torch.full((), 123450, dtype=torch.int64, device="cuda")

    def call(self, lib, handle=0, options=1):
        s = "f32" if self.dtype == torch.float32 else "f64"
        stream = torch.cuda.current_stream().cuda_stream
        if self.kernel == "rebuild_rows":
            cell = self.form == "cell"
            m = self.cell.data_ptr() if cell else None
            if lib.groups:
                mi = (self.cell_inv if cell else self.cell).data_ptr()
                rc = getattr(lib, f"mdtpu_rebuild_rows_{s}")(
                    self.x.data_ptr(), self.ref.data_ptr(), m, mi,
                    1 if cell else 4, 3, N, 0.0225, self.flag.data_ptr(),
                    handle, int(handle != 0), options, stream)
            else:
                mi = (self.cell_inv if cell else self.lengths).data_ptr()
                rc = getattr(lib, f"mdtpu_rebuild_rows_{s}")(
                    self.x.data_ptr(), self.ref.data_ptr(), m, mi, 3, N,
                    0.0225, self.flag.data_ptr(), handle, int(handle != 0),
                    stream)
        else:
            sc = self.scalars.data_ptr()
            size = self.scalars.element_size()
            args = [1, 3, N, self.f.data_ptr(), self.x.data_ptr(),
                    self.xc.data_ptr(), self.img.data_ptr(),
                    self.cell.data_ptr(), self.cell_inv.data_ptr(), sc,
                    sc + size, self.nprom.data_ptr(), self.x.data_ptr(),
                    self.xc.data_ptr(), self.img.data_ptr(), sc + size,
                    self.nprom.data_ptr(), sc + 2 * size,
                    self.step.data_ptr(), self.step.data_ptr(), 0, 1e-5,
                    0.0044721359549995794, 1.0, 3, 0, 1]
            rc = getattr(lib, f"mdtpu_brownian_rows_{s}")(
                *args, *((options,) if lib.groups else ()), stream)
        if rc:
            raise SystemExit(f"probe: {self.kernel} launch failed ({rc})")


def captured(case, lib, calls, with_if=False, options=1):
    """A CUDA graph of ``calls`` calls of the case (each before an IF node
    whose handle it sets, where ``with_if``)."""
    from mdtpu_torch.ops import philox_draws
    case.call(lib, options=options)
    torch.cuda.synchronize()
    graph, pools = torch.cuda.CUDAGraph(), []
    device = torch.device("cuda", torch.cuda.current_device())
    with torch.cuda.graph(graph):
        for _ in range(calls):
            if with_if:
                with philox_draws.graph_if(
                        lambda h: case.call(lib, h, options), device, pools):
                    pass
            else:
                case.call(lib, options=options)
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


def split(lib, graph, calls, phases):
    """One replay's stamps: the critical path along the block that ran the
    tail, each phase's median over the calls (ns; clock64 cycles beside),
    the first calls left out."""
    if lib.mdtpu_probe_reset():
        raise SystemExit("probe: reset failed")
    graph.replay()
    torch.cuda.synchronize()
    raw = np.zeros((128, MAX_BLOCKS, 7, 2), dtype=np.uint64)
    got = ctypes.c_uint(0)
    if lib.mdtpu_probe_read(raw.ctypes.data, ctypes.byref(got)):
        raise SystemExit("probe: read failed")
    n = min(got.value, calls, 128)
    t = raw[:n, :, :, 0].astype(np.int64)
    c = raw[:n, :, :, 1].astype(np.int64)
    end, ticket = len(phases) - 1, phases.index("ticket")
    seen = t[:, :, 0] > 0
    names = phases[1:]
    rows = {k: [] for k in ("launch", "start", *names, "span", "period",
                            "blocks")}
    cycles = {k: [] for k in names}
    prev_end = None
    for i in range(n):
        blocks = np.flatnonzero(seen[i])
        if not blocks.size:
            continue
        first = t[i, blocks, 0].min()
        last = blocks[np.argmax(t[i, blocks, end])]
        s, cs = t[i, last].copy(), c[i, last].copy()
        if s[ticket] == 0:      # one block: no ticket
            s[ticket], cs[ticket] = s[ticket - 1], cs[ticket - 1]
        # The call ends with its latest stamp (the Brownian move's ticket
        # warp may end before the particles do).
        ended = t[i, blocks].max()
        if i >= 3 and prev_end is not None:
            rows["launch"].append(first - prev_end)
            rows["start"].append(s[0] - first)
            for k, name in enumerate(names, start=1):
                rows[name].append(s[k] - s[k - 1])
                cycles[name].append(cs[k] - cs[k - 1])
            rows["span"].append(ended - first)
            rows["period"].append(ended - prev_end)
            rows["blocks"].append(len(blocks))
        prev_end = ended
    ticks = np.diff(np.unique(t[:n][t[:n] > 0]))
    return {"ns": {k: float(np.median(v)) for k, v in rows.items() if v},
            "clock64_cycles": {k: float(np.median(v))
                               for k, v in cycles.items() if v},
            "calls_read": int(n),
            "globaltimer_step_ns": int(ticks[ticks > 0].min())
            if ticks.size and (ticks > 0).any() else None}


def build_stamped(out_dir, tree=HERE):
    """``tree``'s two sources with their designs' stamps, built into
    ``out_dir`` and loaded: {kernel: library}."""
    files = tree_files(tree)
    jobs = jobs_of("stamped", files, True)
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {key[1]: pool.submit(build, *job, out_dir)
                   for key, job in jobs.items()}
    return {k: load(f.result(), k, design(files[f"{SOURCES[k]}.cu"], k)
                    == "programmatic")
            for k, f in futures.items()}


def case_split(libs, kernel, dtype, form="cell", calls=100, with_if=False):
    """:func:`split` of ``kernel`` at 65,536 rows of ``dtype`` from the
    stamped libraries (:func:`build_stamped`), and that graph's time a
    call (``stamped_ms``)."""
    case = Case(kernel, dtype, form)
    graph, pools = captured(case, libs[kernel], calls, with_if)
    rec = split(libs[kernel], graph, calls, PHASES[kernel])
    rec["stamped_ms"] = replay_ms(graph, calls)
    del pools
    return rec


CASES = [("rebuild_rows", torch.float32, "cell", False),
         ("rebuild_rows", torch.float64, "cell", False),
         ("rebuild_rows", torch.float32, "lengths", False),
         ("rebuild_rows", torch.float32, "cell", True),
         ("brownian_rows", torch.float32, "cell", False),
         ("brownian_rows", torch.float64, "cell", False)]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="another tree's directory")
    parser.add_argument("--calls", type=int, default=100)
    parser.add_argument("--out", default=os.path.join(
        HERE, "out_probe", "probe_torch_rows.jsonl"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_rows: no CUDA device")
    trees = {"change": tree_files(HERE)}
    if args.parent:
        trees["parent"] = tree_files(os.path.abspath(args.parent))
    for name, edits in VARIANTS.items():
        files = dict(trees["change"])
        for fname, old, new in edits:
            if files[fname].count(old) != 1:
                raise SystemExit(f"probe: anchor not found once: {old!r}")
            files[fname] = files[fname].replace(old, new)
        trees[name] = files
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    lines = []

    def emit(rec):
        print(json.dumps(rec), flush=True)
        lines.append(json.dumps(rec))

    tmp = tempfile.mkdtemp(prefix="rows_probe_")
    try:
        jobs = {}
        for label, files in trees.items():
            for stamped in (False, True):
                jobs.update(jobs_of(label, files, stamped))
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futures = {key: pool.submit(build, *job, tmp)
                       for key, job in jobs.items()}
        libs = {key: load(fut.result(), key[1], design(
                    trees[key[0]][f"{SOURCES[key[1]]}.cu"], key[1])
                    == "programmatic")
                for key, fut in futures.items()}
        word = torch.zeros(1, dtype=torch.int32, device="cuda")
        for key, lib in libs.items():
            if lib.mdtpu_probe_word(word.data_ptr()):
                raise SystemExit("probe: could not set the word")
        emit({"built": sorted(f"{a}_{k}{'_stamped' if s else ''}"
                              for a, k, s in libs),
              "designs": {f"{label}_{k}": design(files[f"{SOURCES[k]}.cu"],
                                                 k)
                          for label, files in trees.items()
                          for k in SOURCES}})
        for kernel, dtype, form, with_if in CASES:
            case = Case(kernel, dtype, form)
            rec = {"kernel": kernel, "dtype": str(dtype)[6:], "form": form,
                   "rows": [N, 3], "before_if_node": with_if, "ms": {},
                   "split": {}}
            # In turns: each build timed (this tree's also in plain stream
            # order), then each stamped build split.
            ways = [(label, 1) for label in trees]
            ways.insert(1, ("change_plain_launch", 0))
            order = ways + ways[::-1]
            times = {label: [] for label, _ in ways}
            for label, options in order:
                lib = libs[(label.removesuffix("_plain_launch"), kernel,
                            False)]
                graph, _pools = captured(case, lib, args.calls, with_if,
                                         options)
                times[label].append(replay_ms(graph, args.calls))
                del graph, _pools
            rec["ms"] = {k: statistics.mean(v) for k, v in times.items()}
            for label in trees:
                rec["split"][label] = case_split(
                    {kernel: libs[(label, kernel, True)]}, kernel, dtype,
                    form, args.calls, with_if)
            emit(rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"card": smi})
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
