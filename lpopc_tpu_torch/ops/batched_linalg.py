"""Batched small-matrix Cholesky and Cholesky-solve (hand-written CUDA kernels).

The IPM's per-instance condensed KKT matrices are small (n ~ 30-200); a sweep
factors hundreds of them per regularization round and solves against each
factor about five times. Two kernels carry that:

* :func:`lane_cholesky`  — K1, ``(B, n, n) -> (B, n, n)`` lower factors;
* :func:`lane_cho_solve` — K2, ``(B, n, n), (B, n) -> (B, n)`` solutions of
  ``L Lᵀ x = b``.

They keep the names of the JAX package's ``ops/batched_linalg.py``, whose
Pallas kernels ``_chol_kernel`` and ``_solve_kernel`` they replace. The TPU
kernels put the batch on the 128-wide lane axis of ``(n, n, B)`` arrays; the
CUDA kernels (``csrc/batched_linalg.cu``) instead give each matrix a thread
block and hold it in shared memory, in PyTorch's native ``(B, n, n)`` layout
with no padding — see the note at the top of the ``.cu`` file for the design
and its bound.

**Device rule.** For a CUDA tensor a wrapper launches its kernel or raises.
Only a tensor that lies on the CPU takes the plain PyTorch version
(:func:`lane_cholesky_plain`, :func:`lane_cho_solve_plain`), which runs the
same column recurrence in tensor ops and is what the CPU tests and the
on-card comparison use. ``torch.linalg.cholesky`` / ``torch.cholesky_solve``
are not used here.

Each wrapper counts its kernel launches in a plain integer attribute
(``lane_cholesky.launches``, ``lane_cho_solve.launches``).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.build import load_library

# shared memory one thread block may use on Hopper (227 KB)
MAX_BLOCK_SMEM = 232448

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_lib = None


def _library():
    """The built and bound kernel library (compiled with nvcc at first use)."""
    global _lib
    if _lib is None:
        lib = load_library("batched_linalg")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for sfx in _SUFFIX.values():
            f = getattr(lib, f"lpopc_lane_cholesky_{sfx}")
            f.argtypes = [vp, vp, i32, i32, i64, vp]
            f.restype = i32
            g = getattr(lib, f"lpopc_lane_cho_solve_{sfx}")
            g.argtypes = [vp, vp, vp, i32, i32, i64, i64, vp]
            g.restype = i32
        for name in ("lpopc_lane_cholesky_smem_bytes", "lpopc_lane_cho_solve_smem_bytes"):
            h = getattr(lib, name)
            h.argtypes = [i32, i32]
            h.restype = i64
        _lib = lib
    return _lib


def _check_launch(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {code}")


def _row_major(M: torch.Tensor) -> torch.Tensor:
    """(B, n, n) with contiguous matrices; the batch stride may be anything
    (0 for a broadcast operand)."""
    n = M.shape[-1]
    if M.stride(2) == 1 and M.stride(1) == n:
        return M
    return M.contiguous()


# ------------------------------------------------------------------ K1 ----

def lane_cholesky_plain(K: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: right-looking Cholesky, one column per
    step, rank-1 trailing update, upper triangle zeroed. A non-PD pivot
    gives NaN in its column and every later one (no early exit, no clamp)."""
    B, n, _ = K.shape
    A = K.clone()
    idx = torch.arange(n, device=K.device)
    zero = torch.zeros((), dtype=K.dtype, device=K.device)
    for j in range(n):
        piv = A[:, j, j]
        colj = torch.where(idx >= j, A[:, :, j] / torch.sqrt(piv)[:, None], zero)
        A[:, :, j] = colj
        trail = (idx[:, None] > j) & (idx[None, :] > j)
        A = A - torch.where(trail, colj[:, :, None] * colj[:, None, :], zero)
    return torch.tril(A)


def lane_cholesky(K: torch.Tensor) -> torch.Tensor:
    """Cholesky of a batch of SPD matrices. K: (B, n, n) -> L: (B, n, n)
    lower-triangular, NaN where a pivot was not positive. Only the lower
    triangle of K is read (the upper one is its mirror image)."""
    if K.dim() != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"lane_cholesky expects (B, n, n), got {tuple(K.shape)}")
    if K.dtype not in _SUFFIX:
        raise TypeError(f"lane_cholesky supports float64/float32, got {K.dtype}")
    if K.device.type == "cpu":
        return lane_cholesky_plain(K)
    if K.device.type != "cuda":
        raise RuntimeError(f"lane_cholesky: unsupported device {K.device}")
    B, n, _ = K.shape
    lib = _library()
    need = lib.lpopc_lane_cholesky_smem_bytes(n, K.element_size())
    if need > MAX_BLOCK_SMEM:
        raise ValueError(
            f"lane_cholesky: n={n} needs {need} bytes of shared memory per block, "
            f"more than the {MAX_BLOCK_SMEM} a block may use"
        )
    K = _row_major(K)
    L = torch.empty((B, n, n), dtype=K.dtype, device=K.device)
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(lib, f"lpopc_lane_cholesky_{_SUFFIX[K.dtype]}")
        code = fn(K.data_ptr(), L.data_ptr(), B, n, K.stride(0), stream)
    _check_launch(code, "lane_cholesky")
    lane_cholesky.launches += 1
    return L


lane_cholesky.launches = 0


# ------------------------------------------------------------------ K2 ----

def _broadcast_pair(L: torch.Tensor, b: torch.Tensor):
    """Batch an unbatched ``L`` (n, n) or ``b`` (n,) against the other with a
    stride-0 ``expand`` (no copy)."""
    if L.dim() == 2 and b.dim() == 1:
        L, b = L[None], b[None]
    elif L.dim() == 2:
        L = L[None].expand(b.shape[0], -1, -1)
    elif b.dim() == 1:
        b = b[None].expand(L.shape[0], -1)
    if L.dim() != 3 or b.dim() != 2 or L.shape[0] != b.shape[0] \
            or L.shape[1] != L.shape[2] or L.shape[1] != b.shape[1]:
        raise ValueError(
            f"lane_cho_solve expects L (B, n, n) and b (B, n), got "
            f"{tuple(L.shape)} and {tuple(b.shape)}"
        )
    return L, b


def lane_cho_solve_plain(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: forward then backward substitution, one
    row per step, dividing by the diagonal (so NaN/Inf propagate)."""
    L, b = _broadcast_pair(L, b)
    B, n, _ = L.shape
    y = torch.zeros((B, n), dtype=b.dtype, device=b.device)
    for j in range(n):
        acc = (L[:, j, :j] * y[:, :j]).sum(-1)
        y[:, j] = (b[:, j] - acc) / L[:, j, j]
    x = torch.zeros((B, n), dtype=b.dtype, device=b.device)
    for j in range(n - 1, -1, -1):
        acc = (L[:, j + 1 :, j] * x[:, j + 1 :]).sum(-1)
        x[:, j] = (y[:, j] - acc) / L[:, j, j]
    return x


def lane_cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L Lᵀ x = b for a batch. L: (B, n, n) lower factors, b: (B, n);
    an unbatched L (n, n) or b (n,) is broadcast against the other."""
    if L.dtype not in _SUFFIX or b.dtype != L.dtype:
        raise TypeError(
            f"lane_cho_solve supports matching float64/float32, got {L.dtype}, {b.dtype}"
        )
    if L.device != b.device:
        raise RuntimeError(f"lane_cho_solve: L on {L.device}, b on {b.device}")
    if L.device.type == "cpu":
        return lane_cho_solve_plain(L, b)
    if L.device.type != "cuda":
        raise RuntimeError(f"lane_cho_solve: unsupported device {L.device}")
    L, b = _broadcast_pair(L, b)
    B, n, _ = L.shape
    lib = _library()
    need = lib.lpopc_lane_cho_solve_smem_bytes(n, L.element_size())
    if need > MAX_BLOCK_SMEM:
        raise ValueError(
            f"lane_cho_solve: n={n} needs {need} bytes of shared memory per block, "
            f"more than the {MAX_BLOCK_SMEM} a block may use"
        )
    L = _row_major(L)
    if b.stride(1) != 1:
        b = b.contiguous()
    x = torch.empty((B, n), dtype=b.dtype, device=b.device)
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(lib, f"lpopc_lane_cho_solve_{_SUFFIX[L.dtype]}")
        code = fn(L.data_ptr(), b.data_ptr(), x.data_ptr(), B, n,
                  L.stride(0), b.stride(0), stream)
    _check_launch(code, "lane_cho_solve")
    lane_cho_solve.launches += 1
    return x


lane_cho_solve.launches = 0
