"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``csrc/build/lib<name>-<hash>.so`` (the hash is of the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source never
reuses a stale library).  The build happens
at first use, never at import: the CPU-only test environment imports every
module and has no ``nvcc``.  ``load_all`` builds several sources at once,
one ``nvcc`` each.  Processes that start together (the ranks of a mesh)
build each source once: an ``fcntl`` lock on the output path lets one
compile while the others wait for the library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(CSRC, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # a*b + c keeps two roundings, as the PyTorch plain versions compute it
    "-fmad=false",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # name -> nvcc/ptxas output of the last build
build_seconds: dict[str, float] = {}  # name -> wall seconds of the last build's nvcc


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every header in csrc/ it may include
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, path), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _compile(name: str, out: str, timeout: float = 600.0) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"  # renamed into place when complete
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"nvcc timed out building {name}.cu") from None
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = res.stdout
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}.cu:\n{res.stdout}")
    os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                # the lock dies with its holder, so a killed build leaves
                # nothing that blocks the next one
                with open(f"{path}.lock", "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    if not os.path.exists(path):  # another process built it meanwhile
                        _compile(name, path)
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib


def load_all(names) -> dict[str, ctypes.CDLL]:
    """Build (in parallel, one ``nvcc`` per source) and load every named
    source."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(load, names)))
