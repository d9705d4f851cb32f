"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, with the headers beside it, into one shared
library with a plain C interface under ``build/kernels/`` at the root of the
checkout, named by a hash of the sources so an edited source rebuilds and an
unchanged one loads at once. ``build()`` starts every missing library's
``nvcc`` at once and waits for them all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["KERNELS", "build", "library_path", "load", "nvcc"]

KERNELS = ("block_fft", "abft_fft", "ft_matmul")

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels build from source")
    return found


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library is built: named by a hash of its
    sources and flags; its build log is the same path with ``.log``."""
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, all at once.

    Returns ``{name: seconds}`` for the ones compiled; ``nvcc``'s output
    (``-Xptxas -v``: registers, shared memory, spills) goes to
    ``<library>.log``. Raises with the compiler's output if one fails.
    """
    todo = [name for name in names if not library_path(name).exists()]
    if not todo:
        return {}
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        lib = library_path(name)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        log = open(lib.with_suffix(".log"), "w")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       time.perf_counter(), lib, tmp, log)
    times, failed = {}, []
    for name, (proc, t0, lib, tmp, log) in procs.items():
        rc = proc.wait()
        times[name] = time.perf_counter() - t0
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          f"{lib.with_suffix('.log').read_text()}")
            continue
        os.replace(tmp, lib)      # atomic: concurrent builders never clash
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of kernel ``name`` (built first if needed), with
    ``argtypes``/``restype`` set from ``signatures`` = {symbol: argtypes}."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for sym, argtypes in signatures.items():
                fn = getattr(lib, sym)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib
