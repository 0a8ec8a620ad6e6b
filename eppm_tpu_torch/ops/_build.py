"""Build and load the port's CUDA kernels.

The sources in ``eppm_tpu_torch/csrc`` export plain C functions.  At first
use each is compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a
-O3 --fmad=false`` (one nvcc per source, all started together), linked
into one shared library,
``eppm_tpu_torch/_build/libeppm_kernels-<hash>.so`` (the hash covers the
sources and the flags, so an edited source rebuilds), and loaded with
``ctypes``.  ``--fmad=false`` keeps each multiply and add rounded on its
own, as in the plain versions (``csrc/common.cuh``).  Nothing here runs at
import time, and nothing falls back: a missing ``nvcc`` or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

__all__ = ["CudaKernel", "BUILD_DIR", "CSRC_DIR", "build_library",
           "build_seconds", "library_path", "nvcc_path"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
NVCC_FLAGS = COMPILE_FLAGS + LINK_FLAGS


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _nvcc(*args: str) -> subprocess.Popen:
    return subprocess.Popen([nvcc_path(), *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(*jobs: subprocess.Popen) -> None:
    """Wait for every nvcc; raise with the output of those that failed."""
    logs = [job.communicate()[0] for job in jobs]
    failed = [f"nvcc failed ({' '.join(job.args)}):\n{log}"
              for job, log in zip(jobs, logs) if job.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libeppm_kernels-{h.hexdigest()[:12]}.so"


# The loaded library, and how long this process took to build it (None
# when it was built before).
_handle: Optional[ctypes.CDLL] = None
_build_seconds: Optional[float] = None


def build_library() -> ctypes.CDLL:
    """Compile the kernels unless their library exists, then load it."""
    global _handle, _build_seconds
    if _handle is not None:
        return _handle
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # build into a private name, then rename: concurrent builders never
        # load a half-written library
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            # one nvcc per source, all started together, then one link
            srcs = sorted(CSRC_DIR.glob("*.cu"))
            objs = [os.path.join(tmp, src.stem + ".o") for src in srcs]
            _wait(*(_nvcc(*COMPILE_FLAGS, "-c", "-o", obj, str(src))
                    for src, obj in zip(srcs, objs)))
            lib = os.path.join(tmp, "lib.so")
            _wait(_nvcc(*LINK_FLAGS, "-o", lib, *objs))
            os.replace(lib, out)
        _build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    lib.eppm_error_string.argtypes = [ctypes.c_int]
    lib.eppm_error_string.restype = ctypes.c_char_p
    _handle = lib
    return lib


def build_seconds() -> Optional[float]:
    """Seconds the build in this process took; None if none ran."""
    return _build_seconds


class CudaKernel:
    """One entry point of the kernel library.

    ``launch`` calls the C function, which launches the kernel on the given
    stream and returns ``cudaGetLastError()``; a non-zero code raises.
    ``launches`` counts successful launches and nothing else, so a run can
    show that it went through the kernel.  ``call`` calls an entry point
    that launches nothing (a query) and counts nothing."""

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = getattr(build_library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def call(self, *args) -> None:
        rc = self._entry()(*args)
        if rc != 0:
            msg = build_library().eppm_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {rc} ({msg})")

    def launch(self, *args) -> None:
        self.call(*args)
        self.launches += 1
