"""Build and load the package's native sources.

Every ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a``, and every
``csrc/<name>.cc`` (host C++) with ``g++``, into ``_build/lib<name>.so`` at
first use, with one set of flags each, and loaded with ctypes. A library is
rebuilt when its source is newer. Each build writes a file of its own and
installs it by an atomic rename, so processes that build at once (test
workers) never load a half-written library. The compiler's report (for
``nvcc``, ``-Xptxas -v``: registers, shared memory, spills) goes to
``_build/lib<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

# -fmad=false: no multiply-add contraction, so every product rounds as in the
# plain PyTorch versions and a kernel differs from its plain version only in
# the order of its sums. A contracted r^2 or lam sr^(lam+2) - (lam-1)
# sr^(lam+1) shifts a pseudo-hard-sphere force by ~1e-5 of itself in float32,
# and a contracted two_sum is no longer error-free. No fast-math either:
# divisions and square roots stay IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-lineinfo", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
# Host C++: -ffp-contract=off, so no multiply and add fuse and every product
# and sum rounds as numpy's do (the trajectory formatter's unwrapped
# coordinates are byte for byte Python's).
HOST_FLAGS = ("-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return found


def gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host C++ sources are built at "
                           "first use and need a C++ compiler")
    return found


def source(name: str) -> Path:
    """``csrc/<name>.cu``, or ``csrc/<name>.cc`` where there is no CUDA
    source of that name."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.is_file() else CSRC / f"{name}.cc"


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def log_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.log"


def build(name: str) -> None:
    """Compile ``csrc/<name>.cu`` (``nvcc``) or ``csrc/<name>.cc`` (``g++``)
    into ``_build/lib<name>.so`` unless a library newer than the source
    (and, for CUDA, the shared headers) is there."""
    src, lib = source(name), library_path(name)
    cuda = src.suffix == ".cu"
    newest = max(p.stat().st_mtime for p in
                 [src, *(CSRC.glob("*.cuh") if cuda else ())])
    if lib.is_file() and lib.stat().st_mtime >= newest:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
    cmd = ([nvcc(), *NVCC_FLAGS] if cuda else [gxx(), *HOST_FLAGS]) + [
        "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(cmd[0]).name} failed on {src.name} "
                           f"({proc.returncode}):\n{proc.stderr}"
                           f"{proc.stdout}")
    log_path(name).write_text(proc.stderr + proc.stdout)
    os.replace(tmp, lib)


def build_all(names) -> None:
    """Build several sources at once, one ``nvcc`` process each, all started
    together; raises the first failure after every build has ended."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = [pool.submit(build, n) for n in names]
    for f in futures:
        f.result()


@functools.lru_cache(maxsize=None)
def load(name: str, signatures: tuple) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built and loaded once per process.
    ``signatures``: ``((function, (argtypes...)[, restype]), ...)``; a
    function returns an int (0 or an error code) unless its entry names
    another type. A library that exports ``mdtpu_<name>_error_string(int)``
    has it bound too."""
    build(name)
    lib = ctypes.CDLL(str(library_path(name)))
    for fn_name, argtypes, *restype in signatures:
        fn = getattr(lib, fn_name)
        fn.restype = restype[0] if restype else ctypes.c_int
        fn.argtypes = list(argtypes)
    err = getattr(lib, f"mdtpu_{name}_error_string", None)
    if err is not None:
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
    return lib


def check(lib, name: str, rc: int, what: str) -> None:
    """Raise when a launch returned an error code."""
    if rc != 0:
        msg = getattr(lib, f"mdtpu_{name}_error_string")(rc).decode()
        raise RuntimeError(f"{what} launch failed ({rc}): {msg}")


def build_report(name: str) -> str:
    """The compiler's report of the last build of ``csrc/<name>.cu``."""
    build(name)
    path = log_path(name)
    return path.read_text() if path.is_file() else ""
