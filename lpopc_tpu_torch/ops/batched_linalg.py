"""Batched small-matrix Cholesky and Cholesky-solve (hand-written CUDA kernels).

The IPM's per-instance condensed KKT matrices are small to medium (n from a
few dozen up to the 699 of the dense path's block-KKT threshold, and any n
with ``block_kkt="off"``); a sweep factors hundreds of them per
regularization round and solves against each factor about five times. Two
kernels carry that:

* :func:`lane_cholesky`  — K1, ``(B, n, n) -> (B, n, n)`` lower factors;
* :func:`lane_cho_solve` — K2, ``(B, n, n), (B, n) -> (B, n)`` solutions of
  ``L Lᵀ x = b``.

They keep the names of the JAX package's ``ops/batched_linalg.py``, whose
Pallas kernels ``_chol_kernel`` and ``_solve_kernel`` they replace. The TPU
kernels put the batch on the 128-wide lane axis of ``(n, n, B)`` arrays; the
CUDA kernels (``csrc/batched_linalg.cu``) work in PyTorch's native
``(B, n, n)`` layout with no padding. K1 factors in panels of 32 columns
(one thread block per matrix, or, past shared memory, a few launches per
panel over many blocks per matrix). K2's shared variant gives each system
one warp; its global variant is a blocked substitution in tiles of 32 rows
that spreads ONE system over many one-warp blocks (one per tile and
direction), ordered by counters in a scratch buffer that the wrapper
allocates (:func:`global_scratch_bytes`), so a single large system still
uses the card. Each kernel has a shared-memory variant, for the matrices
that fit one block's shared memory, and a global-memory variant with no
size limit; :func:`variant` chooses from n and the element size, by the
rule of ``csrc/batched_linalg_layout.h`` that the launchers use (built for
the host with g++, so it needs no GPU). See the note at the top of the
``.cu`` file for the designs and their bounds.

**Device rule.** For a CUDA tensor a wrapper launches its kernel or raises.
Only a tensor that lies on the CPU takes the plain PyTorch version
(:func:`lane_cholesky_plain`, :func:`lane_cho_solve_plain`), which runs the
same column recurrence in tensor ops and is what the CPU tests and the
on-card comparison use. ``torch.linalg.cholesky`` / ``torch.cholesky_solve``
are not used here.

Each wrapper counts its kernel launches in plain integer attributes:
``launches`` (all), ``launches_shared`` and ``launches_global`` (each
variant), ``launches_f64`` and ``launches_f32`` (each element type), e.g.
``lane_cho_solve.launches_global``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.build import load_library

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_VARIANTS = ("shared", "global")
_lib = None
_layout = None


def _library():
    """The built and bound kernel library (compiled with nvcc at first use)."""
    global _lib
    if _lib is None:
        lib = load_library("batched_linalg")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for sfx in _SUFFIX.values():
            for name in (f"lpopc_lane_cholesky_{sfx}", f"lpopc_lane_cholesky_global_{sfx}"):
                f = getattr(lib, name)
                f.argtypes = [vp, vp, i32, i32, i64, vp]
                f.restype = i32
            g = getattr(lib, f"lpopc_lane_cho_solve_{sfx}")
            g.argtypes = [vp, vp, vp, i32, i32, i64, i64, vp]
            g.restype = i32
            g = getattr(lib, f"lpopc_lane_cho_solve_global_{sfx}")
            g.argtypes = [vp, vp, vp, vp, i32, i32, i64, i64, vp]
            g.restype = i32
        _lib = lib
    return _lib


def _layout_library():
    """The host library of ``csrc/batched_linalg_layout.cpp`` (g++, first use)."""
    global _layout
    if _layout is None:
        lib = load_library("batched_linalg_layout")
        for kernel in ("lane_cholesky", "lane_cho_solve"):
            f = getattr(lib, f"lpopc_{kernel}_variant")
            f.argtypes = [ctypes.c_int, ctypes.c_int]
            f.restype = ctypes.c_int
        lib.lpopc_lane_cho_solve_global_scratch_bytes.argtypes = [ctypes.c_int]
        lib.lpopc_lane_cho_solve_global_scratch_bytes.restype = ctypes.c_longlong
        _layout = lib
    return _layout


def variant(kernel: str, n: int, elem_size: int) -> str:
    """Which variant of ``kernel`` ("lane_cholesky" or "lane_cho_solve")
    runs an n x n system of ``elem_size``-byte elements: "shared" when it
    fits one block's shared memory, else "global" (no size limit). The rule
    is ``csrc/batched_linalg_layout.h``'s: K1 shared holds the packed lower
    triangle, n(n+1)/2 elements, and a 32-entry column buffer per warp
    (n <= 239 in f64, 339 in f32), K2 shared the same triangle per system
    and ceil(n/32) <= 8 rows per lane (n <= 240 in f64, 256 in f32)."""
    if kernel not in ("lane_cholesky", "lane_cho_solve"):
        raise ValueError(f"unknown kernel {kernel!r}")
    return _VARIANTS[getattr(_layout_library(), f"lpopc_{kernel}_variant")(n, elem_size)]


def global_scratch_bytes(B: int) -> int:
    """Bytes of scratch K2's global variant takes for a batch of B systems,
    by ``csrc/batched_linalg_layout.h``: a ticket counter and two progress
    counters per system, whatever n."""
    return int(_layout_library().lpopc_lane_cho_solve_global_scratch_bytes(B))


def _global_scratch(B: int, device) -> torch.Tensor:
    """The scratch K2's global variant is launched with (the launcher clears it)."""
    return torch.empty(global_scratch_bytes(B), dtype=torch.uint8, device=device)


def _count(wrapper, which: str, dtype):
    wrapper.launches += 1
    for key in (which, _SUFFIX[dtype]):
        setattr(wrapper, f"launches_{key}", getattr(wrapper, f"launches_{key}") + 1)


def reset_launches():
    """Set every launch count of both wrappers to 0."""
    for w in (lane_cholesky, lane_cho_solve):
        w.launches = w.launches_shared = w.launches_global = 0
        w.launches_f64 = w.launches_f32 = 0


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
    which = variant("lane_cholesky", n, K.element_size())
    lib = _library()
    K = _row_major(K)
    L = torch.empty((B, n, n), dtype=K.dtype, device=K.device)
    sfx = _SUFFIX[K.dtype]
    entry = "lpopc_lane_cholesky_" + ("global_" if which == "global" else "") + sfx
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(K.data_ptr(), L.data_ptr(), B, n, K.stride(0), stream)
    _check_launch(code, f"lane_cholesky ({which})")
    _count(lane_cholesky, which, K.dtype)
    return L


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
    which = variant("lane_cho_solve", n, L.element_size())
    lib = _library()
    L = _row_major(L)
    if b.stride(1) != 1:
        b = b.contiguous()
    x = torch.empty((B, n), dtype=b.dtype, device=b.device)
    sfx = _SUFFIX[L.dtype]
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream().cuda_stream
        if which == "shared":
            code = getattr(lib, f"lpopc_lane_cho_solve_{sfx}")(
                L.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, L.stride(0), b.stride(0), stream)
        else:
            scratch = _global_scratch(B, b.device)
            code = getattr(lib, f"lpopc_lane_cho_solve_global_{sfx}")(
                L.data_ptr(), b.data_ptr(), x.data_ptr(), scratch.data_ptr(), B, n,
                L.stride(0), b.stride(0), stream)
    _check_launch(code, f"lane_cho_solve ({which})")
    _count(lane_cho_solve, which, L.dtype)
    return x


reset_launches()
