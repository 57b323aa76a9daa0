"""Build the port's CUDA kernels and load them with ``ctypes``.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, under ``build/kernels/`` at the root of
the checkout, the first time a kernel is launched. The library's name
carries a hash of the sources and flags, so an edited source is rebuilt and
a stale library is never loaded. Only sources in this package go into the
build.

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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Counter = Counter()
"""Kernel launches by kernel name. A wrapper adds one where it launches its
kernel and nowhere else; a caller resets it with ``LAUNCHES.clear()``. A
wrapper whose call launches several kernels counts the call once:
``ssd_scan`` (3 or 2), ``flash_attention_bwd`` (3), ``rmsnorm_bwd`` (2),
``ssd_scan_bwd`` (8 or 9)."""

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


def compile_command(src: Path, obj: Path):
    return [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(objs, out: Path):
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(out), *map(str, objs)]


def _run_all(commands):
    """Run the commands in parallel; returns their (returncode, output).
    If a spawn or a wait raises, every child still running is killed and
    reaped before the exception propagates."""
    procs = []
    try:
        for c in commands:
            procs.append(subprocess.Popen(c, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        outs = [p.communicate()[0] for p in procs]
    finally:
        for p in procs:
            if p.returncode is None:      # not waited for: an exception
                p.kill()
                p.communicate()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def build(path: Path) -> None:
    """Compile every source (one nvcc each, in parallel) and link them into
    ``path`` (written under a temporary name and renamed, so a concurrent
    loader never sees half a library)."""
    tmp_dir = path.with_name(f"{path.name}.{os.getpid()}.objs")
    tmp_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    objs = [tmp_dir / f"{src.stem}.o" for src in sources()]
    t0 = time.monotonic()
    try:
        results = _run_all(compile_command(src, obj)
                           for src, obj in zip(sources(), objs))
        failed = [f"{src.name}:\n{out}" for src, (code, out)
                  in zip(sources(), results) if code != 0]
        if not failed:
            [(code, out)] = _run_all([link_command(objs, tmp)])
            results.append((code, out))
            failed = [f"link:\n{out}"] if code != 0 else []
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    BUILD_INFO.update(seconds=time.monotonic() - t0,
                      log="".join(out for _, out in results))


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
