"""Build the port's CUDA kernels and load them.

Each source under ``kernels/*/csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``build/`` at the repository root; the library is loaded with ``ctypes``.
A library's file name carries a hash of its source, the headers beside it,
the shared headers of ``kernels/common/csrc/`` (on every build's include
path) and the flags, so an edited source or header is rebuilt and never
shadowed by an old build.  Only sources in this package are compiled.
There is no fallback: without ``nvcc``, or when a build fails, the call
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable, Optional

import torch

KERNELS_DIR = Path(__file__).resolve().parent
# headers shared by several sources: on every build's include path, and
# hashed into every library's name
COMMON_DIR = KERNELS_DIR / "common" / "csrc"
BUILD_DIR = KERNELS_DIR.parents[2] / "build"
# the CUDA toolkit's default install prefix, tried after PATH and $CUDA_HOME
CUDA_HOME_DEFAULT = "/usr/local/cuda"

SOURCES = {
    "calibrated_update":
        KERNELS_DIR / "calibrated_update" / "csrc" / "calibrated_update.cu",
    "quantize": KERNELS_DIR / "quantize" / "csrc" / "quantize.cu",
    "flash_attention":
        KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention.cu",
    "flash_attention_bwd":
        KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention_bwd.cu",
    "ssd_scan": KERNELS_DIR / "ssd_scan" / "csrc" / "ssd_scan.cu",
    "ssd_scan_bwd": KERNELS_DIR / "ssd_scan" / "csrc" / "ssd_scan_bwd.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the dtype codes every kernel's C interface takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the ``nvcc`` to build with: on PATH, else under
    ``$CUDA_HOME/bin``, else under the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME_DEFAULT):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc was not found (not on PATH, not under $CUDA_HOME/bin, not "
        f"under {CUDA_HOME_DEFAULT}/bin): the port's CUDA kernels cannot "
        "be built.  Install the CUDA toolkit, or run on CPU tensors, which "
        "take the plain PyTorch versions.")


def library_path(name: str) -> Path:
    """Where library ``name`` is built: its file name carries a hash of the
    source, of every header (``*.cuh``) in the source's directory and in
    ``COMMON_DIR``, which the source may include, and of the flags."""
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for where, headers in (("", src.parent), ("common/", COMMON_DIR)):
        for header in sorted(headers.glob("*.cuh")):
            h.update(f"{where}{header.name}".encode() + b"\0"
                     + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> dict[str, float]:
    """Compile every named kernel library (all by default) that is not
    built yet, one ``nvcc`` per source, all started together.  Returns the
    seconds each build took from the common start; ``nvcc``'s output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside the
    library as ``.log``.  Raises ``RuntimeError`` with that output when a
    build fails."""
    todo = [n for n in (SOURCES if names is None else names)
            if not library_path(n).is_file()]
    if not todo:
        return {}
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    start = time.perf_counter()
    try:
        for name in todo:
            out = library_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            log = out.with_suffix(".log")
            with open(log, "w") as fh:
                proc = subprocess.Popen(
                    [exe, *NVCC_FLAGS, "-I", str(COMMON_DIR), "-o",
                     str(tmp), str(SOURCES[name])],
                    stdout=fh, stderr=subprocess.STDOUT)
            jobs.append((name, proc, tmp, out, log))
        seconds, errors = {}, []
        for name, proc, tmp, out, log in jobs:
            rc = proc.wait()
            seconds[name] = time.perf_counter() - start
            if rc != 0:
                errors.append(f"{name}: nvcc exited with {rc}:\n"
                              f"{log.read_text()}")
            else:
                os.replace(tmp, out)
    finally:
        for _, proc, _, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if errors:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(errors))
    return seconds


def build_log(name: str) -> str:
    """``nvcc``'s output from the build of ``name`` ('' if none kept)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib


def raise_on_launch_error(rc: int, name: str) -> None:
    """Raise for a nonzero ``cudaGetLastError()`` code returned by a
    kernel's C entry point (a launch that was refused never ran)."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{rc} (cudaError_t)")
