"""Build the package's CUDA sources with ``nvcc`` into ctypes-loadable libraries.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers, so it
compiles in seconds. The library goes to ``lpopc_tpu_torch/build/`` (ignored
by git), at first use, from the sources in the package only. A build that
fails raises with the compiler's output: nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: dict = {}


def package_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_dir() -> str:
    return os.path.join(package_dir(), "build")


def find_nvcc() -> str:
    """Path of ``nvcc``: on the ``PATH``, else the toolkit's usual place.
    Raises when there is none."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError(
            "nvcc not found (looked on PATH and at /usr/local/cuda/bin); "
            "the CUDA kernels of lpopc_tpu_torch cannot be built"
        )
    return nvcc


def library_path(name: str) -> str:
    return os.path.join(build_dir(), f"liblpopc_{name}.so")


def source_path(name: str) -> str:
    return os.path.join(package_dir(), "csrc", f"{name}.cu")


def build(name: str, extra_flags=(), timeout: float = 600.0) -> str:
    """Compile ``csrc/<name>.cu`` into :func:`library_path` and return the
    compiler's output. Raises when ``nvcc`` fails or runs past ``timeout`` seconds."""
    src = source_path(name)
    if not os.path.isfile(src):
        raise FileNotFoundError(src)
    os.makedirs(build_dir(), exist_ok=True)
    final = library_path(name)
    tmp = f"{final}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp, src]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {final}:\n{proc.stdout}")
    os.replace(tmp, final)   # atomic: no process loads a half-written file
    return proc.stdout


def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, compiled first if it is
    missing or older than its source."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        so, src = library_path(name), source_path(name)
        if (not os.path.exists(so)) or os.path.getmtime(so) < os.path.getmtime(src):
            build(name)
        lib = ctypes.CDLL(so)
        _LIBS[name] = lib
        return lib
