"""Build the package's native sources into ctypes-loadable libraries.

Each ``csrc/<name>.cu`` (CUDA, built with ``nvcc``) or ``csrc/<name>.cpp``
(host code, built with ``g++``) has a plain C interface and no PyTorch
headers, so it compiles in seconds. The library goes to
``lpopc_tpu_torch/build/`` (ignored by git), at first use, from the sources
in the package only, and is rebuilt when it is older than its source or a
header of ``csrc/``. A build that fails raises with the compiler's output:
nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

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
    """``csrc/<name>.cu`` if there is one, else ``csrc/<name>.cpp``."""
    cu = os.path.join(package_dir(), "csrc", f"{name}.cu")
    return cu if os.path.isfile(cu) else cu[:-3] + ".cpp"


def build(name: str, extra_flags=(), timeout: float = 600.0) -> str:
    """Compile ``csrc/<name>.cu`` (nvcc) or ``.cpp`` (g++) into
    :func:`library_path` and return the compiler's output. Raises when the
    compiler fails or runs past ``timeout`` seconds."""
    src = source_path(name)
    if not os.path.isfile(src):
        raise FileNotFoundError(src)
    os.makedirs(build_dir(), exist_ok=True)
    final = library_path(name)
    tmp = f"{final}.{os.getpid()}.tmp"
    if src.endswith(".cu"):
        cmd = [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp, src]
    else:
        cmd = ["g++", *HOST_FLAGS, *extra_flags, "-o", tmp, src]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}) building {final}:\n{proc.stdout}")
    os.replace(tmp, final)   # atomic: no process loads a half-written file
    return proc.stdout


def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` or ``.cpp``, compiled first
    if it is missing or older than its source or a header of ``csrc/``."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        so, src = library_path(name), source_path(name)
        headers = glob.glob(os.path.join(package_dir(), "csrc", "*.h"))
        newest = max(os.path.getmtime(f) for f in [src, *headers])
        if (not os.path.exists(so)) or os.path.getmtime(so) < newest:
            build(name)
        lib = ctypes.CDLL(so)
        _LIBS[name] = lib
        return lib
