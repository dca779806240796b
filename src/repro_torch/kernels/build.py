"""Build and load the port's CUDA kernels, and count their launches.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), all sources in parallel, at first use. The libraries land in
``<repo>/build/repro_torch_kernels/`` under a name that carries a hash of
the source, so an edited source is rebuilt and a stale library never
loads. They are opened with ``ctypes``; every C entry point returns the
``cudaError_t`` of its launches, which :func:`check` turns into an
exception.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-lcuda",  # cuTensorMapEncodeTiled (gemm.cuh): nvcc links the toolkit's stub
]


class LaunchCounter:
    """Plain-integer launch count of one kernel wrapper. The wrapper adds
    one where it launches its kernel, and nowhere else; a run resets the
    counts before the work it wants to attribute."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        # launches by a key the wrapper names beside its count (flash: the
        # path and call shape), for runs that attribute launches to shapes
        self.by_call: Dict[tuple, int] = {}

    def add(self, key: tuple = ()) -> None:
        self.launches += 1
        if key:
            self.by_call[key] = self.by_call.get(key, 0) + 1

    def reset(self) -> None:
        self.launches = 0
        self.by_call = {}


COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    c = COUNTERS.setdefault(name, LaunchCounter(name))
    return c


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


def launch_counts() -> Dict[str, int]:
    return {name: c.launches for name, c in COUNTERS.items()}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _target(src: Path) -> Path:
    h = hashlib.sha1()
    for part in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


@functools.lru_cache(maxsize=None)
def build_all() -> Dict[str, dict]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet, one
    ``nvcc`` per source, all started together. Returns, per source stem,
    the library path, whether it was built in this call, and the compiler
    log (``-Xptxas -v`` register / shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    out: Dict[str, dict] = {}
    procs: List[tuple] = []
    t0 = time.perf_counter()
    for src in sources:
        target = _target(src)
        out[src.stem] = {"path": target, "built": False, "log": ""}
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src.stem, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for stem, target, tmp, proc in procs:
        log, _ = proc.communicate()
        out[stem]["log"] = log
        if proc.returncode != 0:
            failed.append(f"{stem}:\n{log}")
            continue
        os.replace(tmp, target)
        out[stem]["built"] = True
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for v in out.values():
        v["seconds"] = time.perf_counter() - t0
    return out


@functools.lru_cache(maxsize=None)
def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    lib = ctypes.CDLL(str(build_all()[stem]["path"]))
    lib.repro_error_string.restype = ctypes.c_char_p
    lib.repro_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=None)
def bind(stem: str, fn: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """A C entry point with its argument types declared: ``c_void_p`` for
    every pointer and for the stream, so ctypes never cuts a pointer to 32
    bits."""
    f = getattr(library(stem), fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def check(stem: str, fn: str, err: int) -> None:
    if err != 0:
        msg = library(stem).repro_error_string(err).decode()
        raise RuntimeError(f"{stem}.{fn}: CUDA error {err} ({msg})")
