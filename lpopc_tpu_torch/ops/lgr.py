"""Legendre–Gauss–Radau (LGR) collocation operators.

Capability parity with the reference's ``RPMGenerator``
(``Lpopc/src/Core/RPMGenerator.cpp:56-295``): LGR nodes and
quadrature weights, the barycentric differentiation matrix, the per-segment
integration matrix ``A = inv(D[:, 1:])``, the "unity" matrix ``B``, and the
composite (multi-segment) phase operators — all re-derived from scratch.

Design notes
------------
* Nodes/weights/matrices are computed **on host** in extended precision (the
  native ``long double`` C++ backend in ``lpopc_tpu_torch/native/lgr_native.cpp``)
  and memoized per degree, exactly because they are solve-time constants: they
  enter the device computation as constant tensors, so their construction cost
  and precision never touch the device. The shared library is built with
  ``g++`` on first use into the package's own ``build/`` directory
  (git-ignored). There is one backend: a build that fails raises, so nodes and
  weights are the same bits on every machine.
* Composite phase operators are built as **dense** matrices. The reference
  keeps a global sparse triplet matrix (``RPMGenerator.cpp:132-181``); a dense
  ``(N, N+1)`` differentiation matrix turns the defect evaluation into a
  single matmul, which beats any sparse representation for the mesh sizes
  this problem class produces (N ≲ a few thousand).
* Operators driven by RUNTIME mesh fractions (the hp-refinement path) are
  materialized from per-degree patterns (:func:`runtime_mesh_patterns`,
  :func:`materialize_phase_ops`) with the same identities
  ``make_segment_ops`` bakes into constants.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

_NATIVE_LOCK = threading.Lock()
_NATIVE_LIB = None


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")


def _build_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(__file__)), "build")


def _load_native():
    """Build (once) and load the long-double LGR backend. Raises when
    ``g++`` fails."""
    global _NATIVE_LIB
    with _NATIVE_LOCK:
        if _NATIVE_LIB is not None:
            return _NATIVE_LIB
        src = os.path.join(_native_dir(), "lgr_native.cpp")
        so = os.path.join(_build_dir(), "liblgr_native.so")
        os.makedirs(_build_dir(), exist_ok=True)
        if (not os.path.exists(so)) or os.path.getmtime(so) < os.path.getmtime(src):
            # build under a private name, then rename: concurrent
            # processes never load a half-written library
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=120,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}) building {so}:\n{proc.stdout}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        dbl_p = ctypes.POINTER(ctypes.c_double)
        for fn in (lib.lgr_nodes_weights, lib.diff_matrix):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int, dbl_p, dbl_p]
        _NATIVE_LIB = lib
        return lib


def _call_native(name: str, n: int, a: np.ndarray, b: np.ndarray):
    dbl_p = ctypes.POINTER(ctypes.c_double)
    rc = getattr(_load_native(), name)(n, a.ctypes.data_as(dbl_p), b.ctypes.data_as(dbl_p))
    if rc != 0:
        raise RuntimeError(f"lgr_native.{name}({n}) failed with code {rc}")


@functools.lru_cache(maxsize=None)
def lgr_nodes_weights(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The n LGR collocation points on [-1, 1) (τ₁ = -1) and quadrature weights.

    Quadrature is exact for polynomials of degree ≤ 2n-2. Memoized per degree,
    mirroring the reference's static caches (``RPMGenerator.cpp:17-41``).
    """
    if n < 1:
        raise ValueError(f"LGR degree must be >= 1, got {n}")
    nodes = np.empty(n, dtype=np.float64)
    weights = np.empty(n, dtype=np.float64)
    _call_native("lgr_nodes_weights", n, nodes, weights)
    nodes.setflags(write=False)
    weights.setflags(write=False)
    return nodes, weights


def barycentric_weights(pts: np.ndarray) -> np.ndarray:
    """Barycentric interpolation weights for arbitrary support points."""
    pts = np.asarray(pts, dtype=np.longdouble)
    diff = pts[:, None] - pts[None, :]
    np.fill_diagonal(diff, 1.0)
    return (1.0 / np.prod(diff, axis=1)).astype(np.float64)


def differentiation_matrix_full(pts: np.ndarray) -> np.ndarray:
    """Dense (m, m) differentiation matrix on arbitrary support points.

    ``D[i, j] = dL_j/dx (x_i)`` via the barycentric formula, with the diagonal
    from the negative-sum trick (cf. the reference's ``CollocD``,
    ``RPMGenerator.cpp:107-130``, re-derived here).
    """
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    m = pts.shape[0]
    D = np.empty((m, m), dtype=np.float64)
    _call_native("diff_matrix", m, pts, D)
    return D


@functools.lru_cache(maxsize=None)
def segment_matrices(n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-segment operators on the local domain [-1, 1].

    Returns ``(tau, w, D, A)`` where ``tau`` are the n LGR points, ``w`` the
    weights, ``D`` the (n, n+1) differentiation matrix on the n+1 support
    points (LGR nodes plus the right endpoint +1) restricted to collocation
    rows, and ``A = inv(D[:, 1:])`` the (n, n) integration matrix used by the
    error estimator (reference: ``RPMGenerator.cpp:85, 200-251``).
    """
    tau, w = lgr_nodes_weights(n)
    support = np.concatenate([tau, [1.0]])
    Dfull = differentiation_matrix_full(support)
    D = Dfull[:n, :]
    A = np.linalg.inv(D[:, 1:].astype(np.float64))
    for arr in (tau, w, D, A):
        arr.setflags(write=False)
    return tau, w, D, A


@dataclass(frozen=True)
class SegmentOps:
    """Composite collocation operators for one phase on the domain [-1, 1].

    Attributes
    ----------
    degrees: per-segment collocation point counts (static python tuple).
    fractions: K+1 mesh points on [-1, 1] (``fractions[0] = -1``,
        ``fractions[-1] = +1``), matching the reference's per-phase
        ``meshpoints``.
    tau: (N,) all collocation points mapped into the phase domain.
    tau_state: (N+1,) discretization (state) points = tau plus +1.
    w: (N,) quadrature weights scaled to the phase domain (sum = 2).
    D: (N, N+1) composite differentiation matrix in phase-domain coordinates,
        i.e. ``D @ X ≈ dX/dτ`` at collocation points. Dense and block
        bi-diagonal (one overlap column per segment boundary).
    seg_starts: collocation-row offset of each segment.
    """

    degrees: tuple[int, ...]
    fractions: tuple[float, ...]
    tau: np.ndarray = field(repr=False)
    tau_state: np.ndarray = field(repr=False)
    w: np.ndarray = field(repr=False)
    D: np.ndarray = field(repr=False)
    seg_starts: tuple[int, ...]

    @property
    def num_collocation(self) -> int:
        return int(self.tau.shape[0])

    @property
    def num_segments(self) -> int:
        return len(self.degrees)

    def segment_slice(self, k: int) -> slice:
        return slice(self.seg_starts[k], self.seg_starts[k] + self.degrees[k])

    def integration_matrix(self, k: int) -> np.ndarray:
        """Phase-domain integration matrix of segment k (for error estimation)."""
        _, _, _, A = segment_matrices(self.degrees[k])
        half_width = (self.fractions[k + 1] - self.fractions[k]) / 2.0
        return A * half_width


@functools.lru_cache(maxsize=None)
def make_segment_ops(
    degrees: tuple[int, ...], fractions: tuple[float, ...]
) -> SegmentOps:
    """Build composite phase operators for a mesh (memoized on the mesh key)."""
    degrees = tuple(int(d) for d in degrees)
    fractions = tuple(float(f) for f in fractions)
    if len(fractions) != len(degrees) + 1:
        raise ValueError("need len(fractions) == len(degrees) + 1")
    if abs(fractions[0] + 1.0) > 1e-12 or abs(fractions[-1] - 1.0) > 1e-12:
        raise ValueError("mesh fractions must span [-1, 1]")
    if any(b <= a for a, b in zip(fractions[:-1], fractions[1:])):
        raise ValueError("mesh fractions must be strictly increasing")
    N = sum(degrees)
    D = np.zeros((N, N + 1), dtype=np.float64)
    tau = np.empty(N, dtype=np.float64)
    w = np.empty(N, dtype=np.float64)
    seg_starts = []
    off = 0
    for k, nk in enumerate(degrees):
        seg_starts.append(off)
        a, b = fractions[k], fractions[k + 1]
        half = (b - a) / 2.0
        tau_loc, w_loc, D_loc, _ = segment_matrices(nk)
        tau[off : off + nk] = a + (tau_loc + 1.0) * half
        w[off : off + nk] = w_loc * half
        # local -> phase-domain derivative scaling: d/dτ = (1/half) d/dξ
        D[off : off + nk, off : off + nk + 1] = D_loc / half
        off += nk
    tau_state = np.concatenate([tau, [1.0]])
    for arr in (tau, tau_state, w, D):
        arr.setflags(write=False)
    return SegmentOps(
        degrees=degrees,
        fractions=fractions,
        tau=tau,
        tau_state=tau_state,
        w=w,
        D=D,
        seg_starts=tuple(seg_starts),
    )


@functools.lru_cache(maxsize=None)
def runtime_mesh_patterns(degrees: tuple[int, ...]):
    """Static patterns for materializing phase operators from RUNTIME fractions.

    For a fixed per-segment degree tuple, every collocation operator is a
    simple rescaling of per-segment constants by the segment half-widths:
    ``tau = a_s + (tau_loc+1)·h_s``, ``w = w_loc·h_s``, ``D = D_loc/h_s``
    (``make_segment_ops`` above bakes the same identities into constants).
    Exposing the unscaled patterns lets one solver take the mesh
    *fractions* as a runtime argument: every mesh with the same degree
    signature shares it (the shape-bucketed hp loop, ``core/solve.py``).

    Returns ``(tau_pat, w_pat, P, row_seg)``: per-collocation-row patterns
    ``tau_loc + 1`` and ``w_loc``, the unscaled block-diagonal ``D`` pattern
    ``P`` (N, N+1), and the row→segment index map.
    """
    degrees = tuple(int(d) for d in degrees)
    N = sum(degrees)
    P = np.zeros((N, N + 1))
    tau_pat = np.empty(N)
    w_pat = np.empty(N)
    row_seg = np.empty(N, dtype=np.int32)
    off = 0
    for k, nk in enumerate(degrees):
        tau_loc, w_loc, D_loc, _ = segment_matrices(nk)
        P[off : off + nk, off : off + nk + 1] = D_loc
        tau_pat[off : off + nk] = tau_loc + 1.0
        w_pat[off : off + nk] = w_loc
        row_seg[off : off + nk] = k
        off += nk
    for arr in (tau_pat, w_pat, P, row_seg):
        arr.setflags(write=False)
    return tau_pat, w_pat, P, row_seg


def materialize_phase_ops(degrees: tuple[int, ...], fracs: torch.Tensor):
    """(tau, tau_state, w, D) as tensors from runtime fractions ``fracs``
    ((S+1,) tensor spanning [-1, 1]), on ``fracs``' device and dtype."""
    tau_pat, w_pat, P, row_seg = runtime_mesh_patterns(tuple(degrees))
    t = lambda a: torch.as_tensor(np.array(a), device=fracs.device, dtype=fracs.dtype)
    seg = torch.as_tensor(np.array(row_seg, dtype=np.int64), device=fracs.device)
    half = (fracs[1:] - fracs[:-1]) / 2.0
    hs = half[seg]
    a_s = fracs[:-1][seg]
    tau = a_s + t(tau_pat) * hs
    w = t(w_pat) * hs
    D = t(P) / hs[:, None]
    tau_state = torch.cat([tau, torch.ones((1,), device=fracs.device, dtype=fracs.dtype)])
    return tau, tau_state, w, D


def uniform_fractions(num_segments: int) -> tuple[float, ...]:
    """K+1 equally spaced mesh points spanning [-1, 1]."""
    return tuple(np.linspace(-1.0, 1.0, num_segments + 1).tolist())


def uniform_mesh(num_segments: int, degree: int) -> tuple[tuple[int, ...], tuple[float, ...]]:
    """Convenience: uniform mesh with equal segment widths and degrees."""
    return (degree,) * num_segments, uniform_fractions(num_segments)
