"""Build the port's CUDA kernels and load them with ``ctypes``.

Every ``csrc/*.cu`` goes through one ``nvcc`` call for Hopper (``sm_90a``)
into one shared library with a plain C interface, under ``build/kernels/``
at the root of the checkout, the first time a kernel is launched. The
library's name carries a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded. Only sources in this
package go into the build.

Each C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; :func:`check` turns a non-zero code
into an exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Counter = Counter()
"""Kernel launches by kernel name. A wrapper adds one where it launches its
kernel and nowhere else; a caller resets it with ``LAUNCHES.clear()``."""

BUILD_INFO: dict = {}
"""``seconds`` and ``log`` (nvcc's and ptxas's output) of the last build
this process ran; empty when the library was already built."""


def sources():
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME "
                           "to build the CUDA kernels")
    return str(path)


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{digest.hexdigest()[:16]}.so"


def nvcc_command(out: Path):
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), *map(str, sources())]


def build(path: Path) -> None:
    """Compile every source into ``path`` (written under a temporary name and
    renamed, so a concurrent loader never sees half a library)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    t0 = time.monotonic()
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    BUILD_INFO.update(seconds=time.monotonic() - t0,
                      log=proc.stdout + proc.stderr)


@functools.cache
def load() -> ctypes.CDLL:
    path = library_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def function(name: str, argtypes: tuple):
    """The C entry point ``name`` with its argument types declared (pointers
    and the stream as ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    fn = getattr(load(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(code: int, name: str) -> None:
    if code != 0:
        msg = load().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
