"""ctypes bindings of the native host helpers (``native/ivfhnsw_native.cpp``).
Counterpart of ``ivfhnsw_tpu/utils/native.py``.

The library is compiled with ``g++`` at first use from the repository's
``native/ivfhnsw_native.cpp`` into ``build/torch_native/`` (a name that
carries a hash of the source, written through a temporary file and an
atomic rename, so concurrent first uses do not race). It never writes
``native/build/``, which is the JAX package's. Without a toolchain every
entry point returns None and the caller takes its numpy path
(``utils/io.py``), whose bytes are the same.

Host code, not a kernel: the xvec decoder and the length-prefixed series
parser and interleaver that the ``.index`` readers and writers call.
:func:`compiled` builds other host sources the same way (the single-thread
C++ search baseline of ``tools/bench.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "ivfhnsw_native.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "torch_native")
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False

_I64, _I32 = ctypes.c_int64, ctypes.c_int32
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "xvec_read_f32": [ctypes.c_char_p, _I64, _I64, _I64, _I32,
                      ctypes.POINTER(ctypes.c_float)],
    "lenvec_concat": [_U8P, _I64, _I64, _I64, _I64, _U8P, _I64, _I64P],
    "lenvec_total": [_U8P, _I64, _I64, _I64, _I64, _I64P],
    "lenvec_interleave": [_U8P, _I64, _I64P, _I64, _I64, _U8P],
}


def _target(source: str, stem: str, flags: list, suffix: str = "") -> str:
    """BUILD_DIR/<stem>-<hash of the source and flags><suffix>."""
    with open(source, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:12]}{suffix}")


def library_path() -> str:
    """The shared library of the current source."""
    return _target(SOURCE, "libivfhnsw_native", CXXFLAGS, ".so")


def _build(source: str, flags: list, path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(["g++", *flags, "-o", tmp, source], check=True,
                   capture_output=True)
    os.replace(tmp, path)


def compiled(source: str, stem: str, flags: list) -> str:
    """The executable of ``source`` built by g++ with ``flags`` into
    BUILD_DIR under a name that carries a hash of the source and flags
    (compiled at first use, through a temporary file and an atomic
    rename). Raises CalledProcessError when g++ fails."""
    path = _target(source, stem, flags)
    if not os.path.exists(path):
        _build(source, flags, path)
    return path


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not os.path.exists(path):
                _build(SOURCE, CXXFLAGS, path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.CalledProcessError):
            return None
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = _I64, argtypes
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


_KIND = {np.dtype(np.uint8): 0, np.dtype(np.float32): 1,
         np.dtype(np.int32): 2}


def xvec_read_f32(path: str, d: int, n: int, offset: int = 0,
                  dtype=np.uint8) -> np.ndarray | None:
    """n xvec records of dimension d from record ``offset`` on, promoted to
    f32 in one native pass: [n, d] f32, or None when the library is
    unavailable or a record fails its dim check (the caller's numpy path
    then reads the file and raises)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((n, d), np.float32)
    got = lib.xvec_read_f32(
        os.fsencode(path), d, offset, n, _KIND[np.dtype(dtype)],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if got == n else None


def lenvec_interleave(payload: np.ndarray, counts: np.ndarray, esize: int,
                      out: np.ndarray | None = None) -> np.ndarray | None:
    """The serialized series [u32 count | count * esize bytes]* of a flat
    payload and its per-record element counts, in one native pass, into
    ``out`` (u8 scratch of at least 4 * len(counts) + payload bytes,
    allocated when None). Returns the view of ``out`` written, or None
    when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    payload = np.ascontiguousarray(payload).view(np.uint8).reshape(-1)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    need = 4 * counts.size + payload.size
    if out is None:
        out = np.empty(need, np.uint8)
    elif out.size < need:
        raise ValueError(f"interleave scratch too small: {out.size} < {need}")
    rc = lib.lenvec_interleave(
        payload.ctypes.data_as(_U8P), payload.size,
        counts.ctypes.data_as(_I64P), counts.size, esize,
        out.ctypes.data_as(_U8P))
    if rc != need:
        raise ValueError("lenvec_interleave: counts and payload disagree")
    return out[:need]


def lenvec_series(buf: np.ndarray, pos: int, n: int, dtype) -> tuple | None:
    """n length-prefixed records parsed from a u8 buffer at ``pos``:
    (flat payload [total] of dtype, counts [n] int64, end position), or
    None when the library is unavailable. Raises ValueError when the
    buffer ends inside a record."""
    lib = _load()
    if lib is None:
        return None
    dt = np.dtype(dtype)
    buf = np.ascontiguousarray(buf, np.uint8)
    end = ctypes.c_int64(0)
    bufp = buf.ctypes.data_as(_U8P)
    total = lib.lenvec_total(bufp, buf.size, pos, n, dt.itemsize,
                             ctypes.byref(end))
    if total < 0:
        raise ValueError("corrupt length-prefixed series")
    data = np.empty(total * dt.itemsize, np.uint8)
    counts = np.empty(n, np.int64)
    rc = lib.lenvec_concat(bufp, buf.size, pos, n, dt.itemsize,
                           data.ctypes.data_as(_U8P), data.size,
                           counts.ctypes.data_as(_I64P))
    if rc < 0:
        raise ValueError("corrupt length-prefixed series")
    return data.view(dt), counts, int(rc)
