"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with :mod:`ctypes`: seconds to build, where a PyTorch
C++ extension takes minutes. The build happens at first use, never at
import, into ``build/repro_torch_kernels/`` at the root of the checkout,
under a file name keyed by a hash of the sources and flags, so an edited
kernel is rebuilt and an unchanged one is reused within a checkout.

There is no fallback: if ``nvcc`` is missing or the build fails, loading
raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "ef_sign.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# no --use_fast_math: bitwise parity rests on IEEE division and on no
# flush-to-zero; -Xptxas -v reports registers, shared memory and spills
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I64, _F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
# C entry points: argtypes keep 64-bit pointers and sizes from being cut to int
SIGNATURES = {
    "ef_bucket_stats": (_P, _P, _P, _P, _I64, _I64, _P),
    "ef_bucket_sign_compress": (_P, _P, _P, _P, _P, _I64, _I64, _P),
    "ef_bucket_decompress_mean": (_P, _P, _P, _I64, _I64, _I64, _F32, _P),
}


@dataclasses.dataclass
class BuildInfo:
    """What the last build did: library path, seconds spent, nvcc's log."""

    path: Path | None = None
    seconds: float = 0.0
    log: str = ""
    cached: bool = False


build_info = BuildInfo()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): cannot build the CUDA kernels")


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources unless a library of the same hash exists; return its path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"repro_torch_kernels_{_digest()}.so"
    build_info.path = out
    if out.exists():
        build_info.cached = True
        return out
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_info.seconds = time.perf_counter() - t0
    build_info.log = proc.stdout + proc.stderr
    build_info.cached = False
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
