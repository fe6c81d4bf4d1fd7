"""hp-Liu mesh refinement (Liu–Hager–Rao 2015; reference v1.1.0's second
strategy, ``Lpopc/src/Core/LpLiuHpMeshRefineAlg.cpp``).

Re-designed from the algorithm's semantics (not translated): per segment,
four operations driven by the error estimate and a smoothness test —

* **increase N** (p-refinement) when the error exceeds tolerance but the
  solution is smooth there: ``N⁺ = ceil(N (e/tol)^(1/(q-5/2)))`` with the
  convergence rate q estimated from the two-mesh error history
  (reference ``Increasing_N``, ``LpLiuHpMeshRefineAlg.cpp:397-441``);
* **divide** (h-refinement) when non-smooth or the degree cap is hit:
  ``B = min(ceil((e/tol)^(1/q)), ceil(log(e/tol)/log N))`` pieces, ≥ 2
  (reference ``Dividing_mesh :347-395``);
* **reduce N** on converged segments whose Legendre-coefficient tail has
  decayed below threshold (reference ``Reducing_N :443-481``);
* **merge** adjacent converged equal-degree segments when one polynomial of
  that degree represents both to within tolerance (reference
  ``Merging_mesh :483-602``).

The smoothness test compares the max curvature of the current solution
interpolant on a segment with the previous grid's interpolant over the same
interval; ratio > R (default 1.2) means "still resolving new structure" →
divide (reference ``CanWeIncreaseN :604-681``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..ops.interp import interpolation_matrix
from ..ops.lgr import lgr_nodes_weights
from .postprocess import PhaseSolution


@dataclass
class LiuState:
    """Per-phase history carried across refinement iterations."""

    prev_tau_fine: np.ndarray = None   # fine sampling of the previous solution
    prev_x_fine: np.ndarray = None
    prev_segments: list = field(default_factory=list)  # (a, b, N, err) per segment


def _sample_solution(psol: PhaseSolution, n_samples: int = 2001):
    """Piecewise (per-segment) polynomial sampling of the state on [-1, 1]."""
    t0, tf = psol.t0, psol.tf
    tau_state = 2.0 * (psol.t_state - t0) / max(tf - t0, 1e-300) - 1.0
    taus = np.linspace(-1.0, 1.0, n_samples)
    out = np.empty((n_samples, psol.x.shape[1]))
    off = 0
    for k, nk in enumerate(psol.mesh_degrees):
        a, b = psol.mesh_fractions[k], psol.mesh_fractions[k + 1]
        mask = (taus >= a - 1e-15) & (taus <= b + 1e-15) if k == 0 else (taus > a) & (
            taus <= b + (1e-15 if k == len(psol.mesh_degrees) - 1 else 0.0)
        )
        support = tau_state[off : off + nk + 1]
        if np.any(mask):
            out[mask] = interpolation_matrix(support, taus[mask]) @ psol.x[off : off + nk + 1]
        off += nk
    return taus, out


def _max_curvature(taus, vals, a, b):
    """Max |second difference|/h^2 of the sampled interpolant on [a, b]."""
    mask = (taus >= a) & (taus <= b)
    if np.sum(mask) < 5:
        return 0.0
    t = taus[mask]
    v = vals[mask]
    h = t[1] - t[0]
    d2 = np.abs(v[2:] - 2 * v[1:-1] + v[:-2]) / (h * h)
    return float(np.max(d2))


def _legendre_tail_negligible(psol, k, off, nk, tol):
    """True when the last Legendre coefficients of every state are tiny —
    the segment's polynomial degree can be reduced."""
    tau_loc, w_loc = lgr_nodes_weights(nk)
    x_seg = psol.x[off : off + nk]  # values at the collocation points
    if np.max(np.abs(x_seg)) == 0:
        return True
    coeffs = []
    for j in range(nk):
        pj = np.polynomial.legendre.legval(tau_loc, [0.0] * j + [1.0])
        cj = (2 * j + 1) / 2.0 * np.sum(w_loc[:, None] * pj[:, None] * x_seg, axis=0)
        coeffs.append(cj)
    coeffs = np.abs(np.asarray(coeffs))  # (nk, nx)
    scale = np.maximum(np.max(coeffs, axis=0), 1e-300)
    tail = coeffs[-2:] / scale[None, :]
    return bool(np.all(tail < max(tol * 1e2, 1e-8)))


def liu_refine_phase(
    ph,
    psol: PhaseSolution,
    errs: np.ndarray,
    state: LiuState,
    tol: float,
    n_min: int,
    n_max: int,
    curvature_ratio: float = 1.2,
    bucket_aware: bool = False,
) -> tuple[tuple, tuple, bool]:
    """One hp-Liu pass for a phase.

    ``bucket_aware=True`` (used when the solver runs with
    ``mesh_bucketing="on"``) teaches the four operations the bucketed shape
    signature they actually produce (``refine.bucket_mesh`` pads all degrees
    to one bucket value and the segment count to a power of two):

    * degree *reductions* are kept only when they lower the phase-wide
      bucket degree — otherwise they are invisible after padding but churn
      the mesh history;
    * *merges* are committed only when they drop the padded (power-of-two)
      segment count — a merge inside the same pad bucket just makes
      ``bucket_mesh`` re-bisect the widest interval, which can undo the
      merge and oscillate indefinitely;
    * *increase-N* that would push the phase into a higher degree bucket is
      costed against dividing (padded cost model: S_pad · bucket(N)³ per
      factorization, the batched-Cholesky work) and the cheaper target wins.
    """
    degrees = tuple(psol.mesh_degrees)
    fractions = tuple(psol.mesh_fractions)
    taus, x_fine = _sample_solution(psol)
    if bucket_aware:
        from .refine import bucket_degree, pad_count
    cur_bucket = None if not bucket_aware else bucket_degree(max(degrees), n_max)

    def prev_curvature(a, b):
        if state.prev_tau_fine is None:
            return None
        return max(
            _max_curvature(state.prev_tau_fine, state.prev_x_fine[:, i], a, b)
            for i in range(state.prev_x_fine.shape[1])
        )

    def prev_error_for(a, b):
        """History entry overlapping [a, b] (for the convergence-rate model)."""
        for (pa, pb, pN, perr) in state.prev_segments:
            if pa <= (a + b) / 2 <= pb:
                return pN, perr
        return None

    new_deg: list = []
    new_frac: list = [fractions[0]]
    ok = True
    off = 0
    satisfied_flags = []
    reductions: list = []  # (index in new_deg, original degree)
    for k, nk in enumerate(degrees):
        a, b = fractions[k], fractions[k + 1]
        e = float(errs[k])
        if e <= tol:
            satisfied_flags.append(True)
            nd = nk
            if nk > n_min and _legendre_tail_negligible(psol, k, off, nk, tol):
                nd = max(n_min, nk - 2)
                reductions.append((len(new_deg), nk))
            new_deg.append(nd)
            new_frac.append(b)
            off += nk
            continue
        satisfied_flags.append(False)
        ok = False
        # smoothness: current vs previous curvature over this interval
        cur_c = max(
            _max_curvature(taus, x_fine[:, i], a, b) for i in range(x_fine.shape[1])
        )
        prev_c = prev_curvature(a, b)
        smooth = prev_c is None or cur_c <= curvature_ratio * max(prev_c, 1e-300)
        hist = prev_error_for(a, b)
        if hist is not None and hist[0] != nk and hist[1] > 0 and e > 0:
            q = abs(math.log(hist[1] / max(e, 1e-300)) / math.log(nk / hist[0]))
            q = min(max(q, 3.0), 30.0)
        else:
            q = max(3.0, 0.8 * nk)
        # divide target (shared by the h-branch and the bucket cost model)
        B = max(
            2,
            min(
                math.ceil((e / tol) ** (1.0 / q)),
                math.ceil(math.log(e / tol) / math.log(max(nk, 2))),
            ),
        )
        B = min(B, 8)
        if smooth:
            n_next = math.ceil(nk * (e / tol) ** (1.0 / max(q - 2.5, 0.5)))
            take_increase = n_next <= n_max
            if take_increase and bucket_aware:
                nb_inc = bucket_degree(max(n_next, max(degrees)), n_max)
                if nb_inc > cur_bucket:
                    # this p-step forces a phase-wide bucket jump: cost it
                    # against the h-step under the padded shape signature
                    # (factorization work ~ S_pad * deg_bucket^3)
                    S0 = len(degrees)
                    cost_inc = pad_count(S0) * nb_inc**3
                    cost_div = pad_count(S0 + B - 1) * cur_bucket**3
                    take_increase = cost_inc <= cost_div
            if take_increase:
                new_deg.append(max(n_next, nk + 1))
                new_frac.append(b)
                off += nk
                continue
        # divide
        for j in range(1, B + 1):
            new_deg.append(max(n_min, min(nk, n_max)))
            new_frac.append(a + (b - a) * j / B)
        new_frac[-1] = b
        off += nk

    # bucket-aware reduction veto: padding restores every degree to the
    # phase bucket, so reductions only matter when they LOWER the bucket
    if bucket_aware and reductions:
        if bucket_degree(max(new_deg), n_max) >= cur_bucket:
            for idx, orig in reductions:
                new_deg[idx] = orig

    # merge pass: adjacent satisfied equal-degree segments whose union is
    # represented by a single degree-N polynomial to within tolerance
    merged_deg: list = []
    merged_frac: list = [new_frac[0]]
    i = 0
    # map new segments back to "satisfied" only when they came from untouched
    # satisfied old segments (same count <=> no split happened before them);
    # conservative: only merge pairs whose endpoints coincide with old
    # satisfied segment boundaries
    old_sat_bounds = set()
    for k, s in enumerate(satisfied_flags):
        if s:
            old_sat_bounds.add((round(fractions[k], 12), round(fractions[k + 1], 12)))
    while i < len(new_deg):
        if i + 1 < len(new_deg):
            a0, b0, b1 = new_frac[i], new_frac[i + 1], new_frac[i + 2]
            pair_sat = ((round(a0, 12), round(b0, 12)) in old_sat_bounds
                        and (round(b0, 12), round(b1, 12)) in old_sat_bounds)
            if pair_sat and new_deg[i] == new_deg[i + 1] and _merge_ok(
                taus, x_fine, a0, b1, new_deg[i], tol
            ):
                merged_deg.append(new_deg[i])
                merged_frac.append(b1)
                i += 2
                continue
        merged_deg.append(new_deg[i])
        merged_frac.append(new_frac[i + 1])
        i += 1

    # bucket-aware merge veto: a merge that does not drop the padded
    # power-of-two segment count is undone by bucket_mesh's re-bisection of
    # the widest interval (often the just-merged one) — an oscillation with
    # zero shape-signature gain. Keep the unmerged mesh in that case.
    if bucket_aware and len(merged_deg) < len(new_deg):
        if pad_count(len(merged_deg)) >= pad_count(len(new_deg)):
            merged_deg = new_deg
            merged_frac = new_frac

    state.prev_tau_fine = taus
    state.prev_x_fine = x_fine
    state.prev_segments = [
        (fractions[k], fractions[k + 1], degrees[k], float(errs[k]))
        for k in range(len(degrees))
    ]
    return tuple(merged_deg), tuple(merged_frac), ok


def _merge_ok(taus, x_fine, a, b, n, tol):
    """Single degree-n LGR interpolant on [a, b] reproduces the sampled
    solution to within a tolerance-scaled threshold."""
    tau_loc, _ = lgr_nodes_weights(n)
    support = np.concatenate([a + (tau_loc + 1.0) * (b - a) / 2.0, [b]])
    mask = (taus >= a) & (taus <= b)
    if np.sum(mask) < n + 3:
        return False
    t = taus[mask]
    vals_at_support = np.stack(
        [np.interp(support, taus, x_fine[:, c]) for c in range(x_fine.shape[1])],
        axis=1,
    )
    recon = interpolation_matrix(support, t) @ vals_at_support
    scale = 1.0 + np.max(np.abs(x_fine), axis=0)
    err = np.max(np.abs(recon - x_fine[mask]) / scale[None, :])
    return bool(err < max(10 * tol, 1e-8))
