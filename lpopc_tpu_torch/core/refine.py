"""Discretization-error estimation and hp-adaptive mesh refinement.

Error estimator (reference ``SolutionErrorChecker::CheckSolutionDiffError``,
``Lpopc/src/Core/LpSolutionError.cpp:112-169``): per segment,
interpolate the converged state/control to a grid with one extra LGR point,
evaluate the dynamics there, integrate with the fine integration matrix
``A = inv(D[:, 1:])``, and take the max relative mismatch
``|X_integrated - X_interpolated| / (1 + max_t |x_i(t)|)``.

"ph" strategy (Patterson–Hager–Rao; reference ``LpPhMeshRefineAlg.cpp:78-99``):
segments with error above tolerance either raise their degree by
``P = ceil(log(e/tol) / log(N))`` (if ``N + P <= Nmax``) or split into
``max(ceil((N+P)/Nmin), 2)`` equal subintervals of degree ``Nmin``.

"hp-Liu" strategy (Liu–Hager–Rao 2015; reference ``LpLiuHpMeshRefineAlg.cpp``):
adds a smoothness test (curvature ratio between meshes) deciding p- vs
h-refinement, degree *reduction* on converged smooth segments via the decay of
Legendre coefficients, and merging of adjacent satisfied segments.
Implemented in :mod:`.refine_liu`.

Everything here is host-side numpy/python — mesh decisions are control logic
between device solves, exactly where the reference keeps them. Only the
user's dynamics and path functions run on the solve's device, once per
phase for all segments' fine points together.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.interp import interpolation_matrix
from ..ops.lgr import lgr_nodes_weights, segment_matrices
from ..utils.device import resolve_device
from .postprocess import PhaseSolution, Solution, _node_values
from .problem import Problem


class _Segment(NamedTuple):
    """One mesh segment of a phase solution on its fine check grid."""

    a: float                 # segment bounds in phase tau
    b: float
    nk: int                  # degree
    off: int                 # first collocation row
    tau_f: np.ndarray        # (nk+1,) fine grid: one extra LGR point, phase tau
    seg_state: np.ndarray    # (nk+1,) the segment's state points, phase tau
    Xf: np.ndarray           # (nk+1, nx) state interpolated to tau_f
    Uf: np.ndarray           # (nk+1, nu) control interpolated to tau_f


def _fine_points(psol: PhaseSolution, with_control: bool) -> list:
    t0, tf = psol.t0, psol.tf
    tau_state = 2.0 * (psol.t_state - t0) / max(tf - t0, 1e-300) - 1.0
    tau_col = 2.0 * (psol.t_col - t0) / max(tf - t0, 1e-300) - 1.0
    segs = []
    off = 0
    for k, nk in enumerate(psol.mesh_degrees):
        a, b = psol.mesh_fractions[k], psol.mesh_fractions[k + 1]
        nf = nk + 1
        tau_f, _ = lgr_nodes_weights(nf)
        tau_f_phase = a + (tau_f + 1.0) * (b - a) / 2.0
        seg_state = tau_state[off : off + nk + 1]
        seg_col = tau_col[off : off + nk]
        Xf = interpolation_matrix(seg_state, tau_f_phase) @ psol.x[off : off + nk + 1]
        if with_control:
            Uf = interpolation_matrix(seg_col, tau_f_phase) @ psol.u[off : off + nk]
        else:
            Uf = np.zeros((nf, 0))
        segs.append(_Segment(a, b, nk, off, tau_f_phase, seg_state, Xf, Uf))
        off += nk
    return segs


def _at_fine_points(fn, k: int, psol: PhaseSolution, segs, *, device, dtype):
    """``fn(x, u, t, q)`` at every fine point of every segment, in one call
    on ``device``; returns one (nk+1, k) array per segment."""
    t0, tf = psol.t0, psol.tf
    X = np.concatenate([s.Xf for s in segs])
    U = np.concatenate([s.Uf for s in segs])
    t = np.concatenate([(s.tau_f + 1.0) * (tf - t0) / 2.0 + t0 for s in segs])
    vals = _node_values(fn, k, X, U, t, psol.q, device=device, dtype=dtype).reshape(-1, k)
    return np.split(vals, np.cumsum([s.nk + 1 for s in segs])[:-1])


def segment_errors(ph, psol: PhaseSolution, *, device=None, dtype=torch.float64) -> np.ndarray:
    """Per-segment max relative discretization error for one phase; the
    dynamics run on ``device`` (``None`` means ``"cuda"``)."""
    device = resolve_device(device)
    t0, tf = psol.t0, psol.tf
    X = psol.x
    x_scale = 1.0 + np.max(np.abs(X), axis=0)  # (nx,)
    segs = _fine_points(psol, ph.nu > 0)
    errs = np.zeros(len(segs))
    if not segs:
        return errs
    F_all = _at_fine_points(ph.dynamics, ph.nx, psol, segs, device=device, dtype=dtype)
    for k, (seg, F) in enumerate(zip(segs, F_all)):
        Xseg = X[seg.off : seg.off + seg.nk + 1]
        tau_f_state = np.concatenate([seg.tau_f, [seg.b]])
        _, _, _, A = segment_matrices(seg.nk + 1)
        A_phase = A * ((seg.b - seg.a) / 2.0)
        X_int = Xseg[0][None, :] + (tf - t0) / 2.0 * (A_phase @ F)
        X_ref = interpolation_matrix(seg.seg_state, tau_f_state[1:]) @ Xseg
        errs[k] = np.max(np.abs(X_int - X_ref) / x_scale[None, :]) if ph.nx else 0.0
    return errs


def estimate_errors(problem: Problem, sol: Solution, *, device=None,
                    dtype=torch.float64) -> list:
    return [
        segment_errors(ph, psol, device=device, dtype=dtype)
        for ph, psol in zip(problem.phases, sol.phases)
    ]


def segment_path_violations(ph, psol: PhaseSolution, with_peaks=False, *,
                            device=None, dtype=torch.float64):
    """Per-segment max INTER-NODE constraint violation at the fine check
    points: path-function rows against their bounds plus interior state
    bounds against the interpolated state.

    The reference explicitly does NOT measure path-constraint error
    (``doc/LpopcDoc.tex:1139`` — constraints hold only at collocation
    points, excursions between nodes are invisible). This estimator closes
    that observability gap: it reuses the same one-extra-LGR-point fine
    grid as :func:`segment_errors` and reports the max bound violation,
    normalized by ``1 + |bound|`` (relative, like the state error).

    With ``with_peaks`` also returns the phase-tau (mesh-fraction
    coordinate, in [-1, 1]) of each segment's worst violation — the knot
    location :func:`insert_knots` uses to DRIVE refinement when
    ``SolveOptions.path_violation_tol`` is set (beyond-reference: the
    reference never measures, let alone acts on, inter-node excursions).
    The path functions run on ``device`` (``None`` means ``"cuda"``).
    """
    device = resolve_device(device)
    x_lo = np.asarray(ph.x_bounds[0], float).reshape(-1)
    x_hi = np.asarray(ph.x_bounds[1], float).reshape(-1)
    x_norm = 1.0 + np.minimum(np.abs(x_lo), np.abs(x_hi))
    x_norm = np.where(np.isfinite(x_norm), x_norm, 1.0)
    if ph.npath:
        p_lo = np.asarray(ph.path_bounds[0], float).reshape(-1)
        p_hi = np.asarray(ph.path_bounds[1], float).reshape(-1)
        p_norm = 1.0 + np.minimum(np.abs(p_lo), np.abs(p_hi))
        p_norm = np.where(np.isfinite(p_norm), p_norm, 1.0)
    segs = _fine_points(psol, ph.nu > 0)
    viols = np.zeros(len(segs))
    peaks = np.full(len(segs), np.nan)
    C_all = (
        _at_fine_points(ph.path, ph.npath, psol, segs, device=device, dtype=dtype)
        if ph.npath and segs else [None] * len(segs)
    )
    for k, (seg, C) in enumerate(zip(segs, C_all)):
        tau_f_phase, Xf = seg.tau_f, seg.Xf
        v = 0.0
        peak = np.nan

        def scan(arr):
            nonlocal v, peak
            arr = np.where(np.isfinite(arr), arr, -np.inf)
            if arr.size == 0:
                return
            row, col = np.unravel_index(np.argmax(arr), arr.shape)
            if arr[row, col] > v:
                v = float(arr[row, col])
                peak = float(tau_f_phase[row])

        with np.errstate(invalid="ignore"):
            scan((x_lo[None, :] - Xf) / x_norm[None, :])
            scan((Xf - x_hi[None, :]) / x_norm[None, :])
        if ph.npath:
            with np.errstate(invalid="ignore"):
                scan((p_lo[None, :] - C) / p_norm[None, :])
                scan((C - p_hi[None, :]) / p_norm[None, :])
        viols[k] = max(v, 0.0)
        peaks[k] = peak
    if with_peaks:
        return viols, peaks
    return viols


def estimate_path_violations(problem: Problem, sol: Solution, with_peaks=False, *,
                             device=None, dtype=torch.float64):
    return [
        segment_path_violations(ph, psol, with_peaks=with_peaks, device=device, dtype=dtype)
        for ph, psol in zip(problem.phases, sol.phases)
    ]


def violation_knots(
    errs: np.ndarray, viols: np.ndarray, peaks: np.ndarray,
    tol: float, viol_tol: float,
) -> list:
    """Knot locations (phase-tau) that close measured inter-node violations.

    A segment whose state error already exceeds ``tol`` is being refined by
    the state-error strategy anyway; a segment that is state-converged but
    violates a bound BETWEEN its collocation points would never be touched —
    that is the blind spot this targets (a constrained arc's entry/exit
    kink sitting inside a segment: degree-raising converges slowly there,
    an h-point at the excursion peak kills it directly)."""
    knots = []
    for k in range(len(errs)):
        if (
            viols[k] > viol_tol
            and errs[k] <= tol
            and np.isfinite(peaks[k])
        ):
            knots.append(float(peaks[k]))
    return knots


def insert_knots(
    degrees: tuple, fractions: tuple, knots: list, min_sep: float = 0.05
) -> tuple[tuple, tuple, bool]:
    """Insert mesh points at the given phase-tau locations (both halves
    keep the split segment's degree). Knots closer than ``min_sep`` of the
    containing segment's width to an existing point are skipped — no
    sliver segments. Returns (degrees, fractions, changed)."""
    fr = list(fractions)
    dg = list(degrees)
    changed = False
    for p in sorted(knots):
        i = int(np.searchsorted(fr, p)) - 1
        i = min(max(i, 0), len(dg) - 1)
        a, b = fr[i], fr[i + 1]
        gap = min_sep * (b - a)
        if p - a < gap or b - p < gap:
            # peak rides an existing mesh point: bisect the segment instead
            p = 0.5 * (a + b)
            if p - a < 1e-12:
                continue
        fr.insert(i + 1, p)
        dg.insert(i, dg[i])
        changed = True
    return tuple(dg), tuple(fr), changed


#: degree buckets for shape-bucketed meshes. Coarse on purpose: the JAX
#: package pays one compile per distinct (bucket degree, segment count)
#: signature; the port keeps the same buckets so that both packages refine
#: through the same sequence of meshes.
DEGREE_BUCKETS = (4, 8, 16, 24, 32, 48, 64)


def bucket_degree(d: int, n_max: int = 64) -> int:
    """The uniform bucket degree a mesh with max degree ``d`` is padded to."""
    return next((b for b in DEGREE_BUCKETS if b >= d and b <= max(n_max, d)), d)


def pad_count(S: int) -> int:
    """The power-of-two segment count a mesh with ``S`` segments is padded to."""
    return 1 << (S - 1).bit_length() if S > 1 else 1


def bucket_mesh(
    degrees: tuple, fractions: tuple, n_max: int = 64
) -> tuple[tuple, tuple]:
    """Round a refined mesh UP to a bucketed shape signature.

    Pads every segment's degree to one uniform bucket value (≥ the max
    requested degree) and the segment count to the next power of two (by
    bisecting the widest intervals). Both transformations only ADD
    collocation points, so accuracy never drops; in exchange the mesh's
    shape signature takes one of O(log²) values (SURVEY.md §7, "shape
    bucketing/padding").
    """
    deg = bucket_degree(max(degrees), n_max)
    S_b = pad_count(len(degrees))
    fr = list(fractions)
    while len(fr) - 1 < S_b:
        widths = np.diff(fr)
        k = int(np.argmax(widths))
        fr.insert(k + 1, (fr[k] + fr[k + 1]) / 2.0)
    return (deg,) * (len(fr) - 1), tuple(fr)


def ph_refine_phase(
    degrees: tuple, fractions: tuple, errs: np.ndarray,
    tol: float, n_min: int, n_max: int,
) -> tuple[tuple, tuple, bool]:
    """One ph-refinement pass for a phase; returns (degrees, fractions, ok)."""
    new_deg = []
    new_frac = [fractions[0]]
    ok = True
    for k, nk in enumerate(degrees):
        a, b = fractions[k], fractions[k + 1]
        e = float(errs[k])
        if e <= tol:
            new_deg.append(nk)
            new_frac.append(b)
            continue
        ok = False
        P = max(1, math.ceil(math.log(e / tol) / math.log(max(nk, 2))))
        if nk + P <= n_max:
            new_deg.append(nk + P)
            new_frac.append(b)
        else:
            B = max(math.ceil((nk + P) / n_min), 2)
            for j in range(1, B + 1):
                new_deg.append(n_min)
                new_frac.append(a + (b - a) * j / B)
            new_frac[-1] = b  # exact endpoint
    return tuple(new_deg), tuple(new_frac), ok
