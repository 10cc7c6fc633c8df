"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` file exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/lib<name>_<hash>.so`` at
the root of the checkout, at first use. The hash covers the source, every
header under ``csrc/`` (``*.cuh``, ``*.h``: a source may include any of
them) and the flags, so an edited source or header builds anew and a stale
library is never loaded.
The compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
kept beside the library in ``lib<name>_<hash>.log``.

Nothing here runs at import time: the CPU-only test environment imports this
module but never builds. :func:`check_arg` is the wrappers' argument check.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def library_path(name: str) -> str:
    """Path of the shared library built from ``csrc/<name>.cu``."""
    h = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
                     + glob.glob(os.path.join(CSRC_DIR, "*.h")))
    for path in [os.path.join(CSRC_DIR, name + ".cu"), *headers]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; return the
    library path. Raises with the compiler's output when nvcc fails."""
    return build_all([name])[0]


def build_all(names) -> list[str]:
    """Compile every ``csrc/<name>.cu`` whose library does not exist yet,
    one nvcc process per source, all started together; return the library
    paths in order. Raises with the compiler's output when nvcc fails."""
    sos = [library_path(n) for n in names]
    jobs = []
    for name, so in zip(names, sos):
        if os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        src = os.path.join(CSRC_DIR, name + ".cu")
        log = open(so[:-3] + ".log", "w")
        jobs.append((so, tmp, src, log, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=log,
            stderr=subprocess.STDOUT)))
    failed = []
    for so, tmp, src, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            with open(so[:-3] + ".log") as f:
                failed.append(f"nvcc failed on {src} (rc {rc}):\n{f.read()}")
        else:
            os.replace(tmp, so)  # atomic: a loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return sos


def check_arg(name: str, t, dtype, shape: tuple, device, fn: str) -> None:
    """Raise unless tensor ``t`` has the device, dtype, shape and
    contiguity that kernel wrapper ``fn`` passes to its kernel as argument
    ``name``."""
    if t.device != device:
        raise ValueError(f"{fn}: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} is not contiguous")


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process."""
    return ctypes.CDLL(build(name))
