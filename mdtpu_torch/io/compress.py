"""zstd trajectory compression through libzstd, bound with ctypes.

Counterpart of ``mdtpu/io/compress.py``, which uses the ``zstandard``
package; the port calls the C library itself (the one
``native/trajwriter.cc`` links), found with ``ctypes.util.find_library``,
through its stable streaming API (``ZSTD_initCStream`` /
``ZSTD_compressStream`` / ``ZSTD_endStream`` and ``ZSTD_decompressStream``).
Streams go through in fixed-size chunks, so a trajectory of any size
compresses in constant memory. A compressed file may hold several zstd
frames one after another (a resumed run appends a frame); decompression
reads them all.

:func:`require_libzstd` raises ``RuntimeError`` naming libzstd where the
library is missing; ``run_simulation(compress=True)`` calls it before it
touches any file.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import os

_CHUNK = 1 << 17


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


_SIGNATURES = {
    "ZSTD_isError": (ctypes.c_uint, [ctypes.c_size_t]),
    "ZSTD_getErrorName": (ctypes.c_char_p, [ctypes.c_size_t]),
    "ZSTD_createCStream": (ctypes.c_void_p, []),
    "ZSTD_freeCStream": (ctypes.c_size_t, [ctypes.c_void_p]),
    "ZSTD_initCStream": (ctypes.c_size_t, [ctypes.c_void_p, ctypes.c_int]),
    "ZSTD_compressStream": (ctypes.c_size_t,
                            [ctypes.c_void_p, ctypes.POINTER(_OutBuffer),
                             ctypes.POINTER(_InBuffer)]),
    "ZSTD_endStream": (ctypes.c_size_t,
                       [ctypes.c_void_p, ctypes.POINTER(_OutBuffer)]),
    "ZSTD_createDStream": (ctypes.c_void_p, []),
    "ZSTD_freeDStream": (ctypes.c_size_t, [ctypes.c_void_p]),
    "ZSTD_initDStream": (ctypes.c_size_t, [ctypes.c_void_p]),
    "ZSTD_decompressStream": (ctypes.c_size_t,
                              [ctypes.c_void_p, ctypes.POINTER(_OutBuffer),
                               ctypes.POINTER(_InBuffer)]),
}


@functools.lru_cache(maxsize=None)
def _library():
    """The loaded libzstd, or None where the system has none."""
    path = ctypes.util.find_library("zstd")
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def require_libzstd():
    """The loaded libzstd; ``RuntimeError`` where it is missing."""
    lib = _library()
    if lib is None:
        raise RuntimeError(
            "compress=True needs the zstd C library (libzstd), which "
            "ctypes.util.find_library('zstd') did not find on this system")
    return lib


def _checked(lib, rc):
    if lib.ZSTD_isError(rc):
        raise RuntimeError(
            f"libzstd: {lib.ZSTD_getErrorName(rc).decode()}")
    return rc


class ZstdWriter:
    """A binary sink that compresses what is written to it into the open
    file ``fileobj`` as one zstd frame; :meth:`close` ends the frame and
    flushes (the file itself stays open)."""

    def __init__(self, fileobj, level: int = 3):
        self._lib = require_libzstd()
        self._file = fileobj
        self._stream = self._lib.ZSTD_createCStream()
        if not self._stream:
            raise MemoryError("ZSTD_createCStream failed")
        _checked(self._lib, self._lib.ZSTD_initCStream(self._stream, level))
        self._out = ctypes.create_string_buffer(_CHUNK)

    def _drain(self, out):
        if out.pos:
            self._file.write(self._out.raw[:out.pos])
        out.pos = 0

    def write(self, data: bytes):
        buf = ctypes.create_string_buffer(data, len(data))
        inp = _InBuffer(ctypes.cast(buf, ctypes.c_void_p), len(data), 0)
        out = _OutBuffer(ctypes.cast(self._out, ctypes.c_void_p), _CHUNK, 0)
        while inp.pos < inp.size:
            _checked(self._lib, self._lib.ZSTD_compressStream(
                self._stream, ctypes.byref(out), ctypes.byref(inp)))
            self._drain(out)

    def close(self):
        if self._stream is None:
            return
        out = _OutBuffer(ctypes.cast(self._out, ctypes.c_void_p), _CHUNK, 0)
        try:
            while True:
                left = _checked(self._lib, self._lib.ZSTD_endStream(
                    self._stream, ctypes.byref(out)))
                self._drain(out)
                if left == 0:
                    break
        finally:
            self._lib.ZSTD_freeCStream(self._stream)
            self._stream = None


def decompressed_chunks(fileobj):
    """The decompressed bytes of the open zstd file ``fileobj``, in chunks;
    every frame of the file, one after another."""
    lib = require_libzstd()
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("ZSTD_createDStream failed")
    try:
        _checked(lib, lib.ZSTD_initDStream(stream))
        out_buf = ctypes.create_string_buffer(_CHUNK)
        last = 0
        while True:
            data = fileobj.read(_CHUNK)
            if not data:
                break
            buf = ctypes.create_string_buffer(data, len(data))
            inp = _InBuffer(ctypes.cast(buf, ctypes.c_void_p), len(data), 0)
            while True:
                out = _OutBuffer(ctypes.cast(out_buf, ctypes.c_void_p),
                                 _CHUNK, 0)
                last = _checked(lib, lib.ZSTD_decompressStream(
                    stream, ctypes.byref(out), ctypes.byref(inp)))
                if out.pos:
                    yield out_buf.raw[:out.pos]
                # Done with this input once it is consumed and the output
                # buffer was not filled (nothing left buffered inside).
                if inp.pos == inp.size and out.pos < _CHUNK:
                    break
        if last != 0:
            raise RuntimeError("truncated zstd stream")
    finally:
        lib.ZSTD_freeDStream(stream)


def decompressed_lines(fileobj):
    """The decompressed text of the open zstd file ``fileobj``, line by
    line (each with its newline; invalid UTF-8 replaced)."""
    rest = b""
    for chunk in decompressed_chunks(fileobj):
        lines = (rest + chunk).split(b"\n")
        rest = lines.pop()
        for line in lines:
            yield (line + b"\n").decode("utf-8", errors="replace")
    if rest:
        yield rest.decode("utf-8", errors="replace")


def compress_zstd(filepath, level: int = 3,
                  remove_original: bool = True) -> str:
    """Compress ``filepath`` to ``filepath + '.zst'`` and delete the original
    (as the JAX package does). Returns the output path."""
    output_file = filepath + ".zst"
    require_libzstd()
    with open(filepath, "rb") as infile, open(output_file, "wb") as outfile:
        writer = ZstdWriter(outfile, level)
        try:
            while True:
                data = infile.read(_CHUNK)
                if not data:
                    break
                writer.write(data)
        finally:
            writer.close()
    if remove_original:
        os.remove(filepath)
    return output_file


def decompress_zstd(filepath, remove_original: bool = False) -> str:
    """Inverse of :func:`compress_zstd`: ``x.zst`` -> ``x``. Returns the
    output path."""
    if not filepath.endswith(".zst"):
        raise ValueError("expected a .zst file")
    require_libzstd()
    output_file = filepath[: -len(".zst")]
    with open(filepath, "rb") as infile, open(output_file, "wb") as outfile:
        for chunk in decompressed_chunks(infile):
            outfile.write(chunk)
    if remove_original:
        os.remove(filepath)
    return output_file
