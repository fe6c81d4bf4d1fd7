"""Control-arc structure detection: bang / interior / singular arcs.

Reference-class tools solve bang-singular problems by a *user-chosen*
multi-phase decomposition (the reference has no automation here at all; its
Goddard-class cases are simply out of scope). This module automates the
detection step: given a (possibly stalled) single-phase solve, classify the
control trace into saturated ("lower"/"upper") and interior arcs, and flag
interior arcs showing the canonical singular signature — sustained
oscillation of the control between its bounds (the direct-method ringing on
an unresolved singular arc) together with a near-zero switching function
``H_u`` where costates are available.

Everything is host-side numpy control logic between device solves (like mesh
refinement); the switching function and the control curvature are evaluated
by ``torch.func`` on the phase's own functions, on the device of the solve
that produced the solution (``device=``; ``None`` means ``"cuda"``) — no
hand-derived variational algebra.

Typical use (see ``models/goddard.py::solve_auto``):

1. quick single-phase solve (regularized if control-affine),
2. ``detect_control_arcs`` → arc structure,
3. if a singular arc is flagged: either re-solve through
   ``models.goddard.solve_auto``-style regularization continuation, or build
   a multi-phase decomposition with the arc boundaries as switch-time
   guesses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

from ..utils.device import resolve_device
from .transcribe import _scalar, _vector


@dataclass
class Arc:
    kind: str          # "lower" | "upper" | "interior" | "singular"
    t_start: float
    t_end: float
    k_start: int       # first collocation-node index (inclusive)
    k_end: int         # last collocation-node index (inclusive)
    oscillations: int  # sign changes of du/dt within the arc
    mean_abs_hu: float = np.nan  # mean |switching function| (if provided)


def _tensors(device, dtype, *arrays):
    return tuple(torch.as_tensor(np.asarray(a, dtype=np.float64), device=device, dtype=dtype)
                 for a in arrays)


def switching_function(ph, psol, component: int = 0, *, device=None,
                       dtype=torch.float64) -> np.ndarray:
    """``H_u`` (∂Hamiltonian/∂u, given component) at every collocation node,
    from the converged costates — AD on the user's dynamics/lagrange, no
    hand algebra. Sign convention matches the costate estimate of
    :mod:`.postprocess` (Radau transform, reference ``Nlp2OPConverter.cpp:
    79-87``)."""
    device = resolve_device(device)
    lam = np.asarray(psol.costate)
    N = lam.shape[0]
    x, u, t, lam_t, q = _tensors(
        device, dtype, np.asarray(psol.x)[:N], np.asarray(psol.u)[:N],
        np.asarray(psol.t_col)[:N], lam, np.asarray(psol.q))

    def hamiltonian(xk, uk, tk, lamk):
        h = torch.dot(lamk, _vector(ph.dynamics(xk, uk, tk, q), xk, ph.nx))
        if ph.lagrange is not None:
            h = h + _scalar(ph.lagrange(xk, uk, tk, q), xk)
        return h

    hu = vmap(grad(hamiltonian, argnums=1))(x, u, t, lam_t)
    return hu.detach().cpu().numpy()[:, component]


def detect_control_arcs(
    t: np.ndarray,
    u: np.ndarray,
    lo: float,
    hi: float,
    sat_tol: float = 1e-2,
    min_nodes: int = 2,
    hu: np.ndarray | None = None,
    osc_threshold: int = 4,
    hu_tol: float | None = None,
) -> list[Arc]:
    """Segment a control trace into arcs.

    ``sat_tol`` is relative to the bound span: a node is "upper" when
    ``u > hi - sat_tol*(hi-lo)``, "lower" when ``u < lo + sat_tol*(hi-lo)``.
    Runs shorter than ``min_nodes`` are absorbed into the previous arc
    (chattering across a switch never splits an arc). An interior arc is
    promoted to "singular" when the control direction flips at least
    ``osc_threshold`` times inside it (direct-transcription ringing), or —
    when ``hu`` (the switching function from :func:`switching_function`) is
    given — when its mean magnitude over the arc is below ``hu_tol``
    (default: 5% of the trace's max |H_u|).
    """
    t = np.asarray(t, float)
    u = np.asarray(u, float).reshape(-1)
    N = u.shape[0]
    span = max(hi - lo, 1e-300)
    kinds = np.where(
        u > hi - sat_tol * span, 2, np.where(u < lo + sat_tol * span, 0, 1)
    )
    # run-length encode, absorbing short runs into their predecessor
    runs: list[list] = []  # [kind, k_start, k_end]
    for k in range(N):
        if runs and runs[-1][0] == kinds[k]:
            runs[-1][2] = k
        elif runs and (k - runs[-1][1]) >= 0 and runs[-1][2] - runs[-1][1] + 1 < min_nodes and len(runs) > 1:
            # previous run too short: merge it into the one before
            prev = runs.pop()
            runs[-1][2] = prev[2]
            if runs[-1][0] == kinds[k]:
                runs[-1][2] = k
            else:
                runs.append([int(kinds[k]), k, k])
        else:
            runs.append([int(kinds[k]), k, k])
    if len(runs) > 1 and runs[-1][2] - runs[-1][1] + 1 < min_nodes:
        prev = runs.pop()
        runs[-1][2] = prev[2]
    # mirror for a too-short FIRST run (the encoding loop's merge branch only
    # fires for len(runs) > 1, so a 1-node saturation blip at t0 would
    # otherwise survive as its own arc and feed a spurious extra phase into
    # decompose_by_arcs): absorb it into its successor
    while len(runs) > 1 and runs[0][2] - runs[0][1] + 1 < min_nodes:
        head = runs.pop(0)
        runs[0][1] = head[1]
    names = {0: "lower", 1: "interior", 2: "upper"}
    if hu is not None and hu_tol is None:
        hu_tol = 0.05 * max(float(np.max(np.abs(hu))), 1e-300)
    arcs: list[Arc] = []
    for kind, ks, ke in runs:
        name = names[kind]
        du = np.diff(u[ks : ke + 1])
        sgn = np.sign(du[np.abs(du) > 1e-12 * span])
        osc = int(np.sum(sgn[1:] != sgn[:-1])) if sgn.size > 1 else 0
        mh = float(np.mean(np.abs(hu[ks : ke + 1]))) if hu is not None else np.nan
        if name == "interior" and (
            osc >= osc_threshold or (hu is not None and mh < hu_tol)
        ):
            name = "singular"
        arcs.append(Arc(
            kind=name, t_start=float(t[ks]), t_end=float(t[ke]),
            k_start=ks, k_end=ke, oscillations=osc, mean_abs_hu=mh,
        ))
    return arcs


def control_affinity(ph, psol, lagrange=None, n_samples: int = 16, *, device=None,
                     dtype=torch.float64) -> float:
    """Max curvature of (dynamics, lagrange) in the control over trajectory
    samples, normalized by the corresponding first-derivative magnitude.

    ≈ 0 means the problem is control-affine along the solution — the
    precondition for an interior arc to be *singular* (on an affine problem
    ``H_u`` carries no ``u`` dependence, so interior optimal controls are
    determined only through higher-order conditions). ``lagrange`` overrides
    the phase's running cost (pass the UN-regularized one when the solve
    added an ``eps·u²`` term, whose curvature is exactly the regularization).
    """
    device = resolve_device(device)
    N = np.asarray(psol.u).shape[0]
    idx = np.linspace(0, N - 1, min(n_samples, N)).astype(int)
    x, u, t, q = _tensors(device, dtype, np.asarray(psol.x)[idx], np.asarray(psol.u)[idx],
                          np.asarray(psol.t_col)[idx], np.asarray(psol.q))
    lag = lagrange if lagrange is not None else ph.lagrange

    def curv(xk, uk, tk):
        f = lambda uu: _vector(ph.dynamics(xk, uu, tk, q), xk, ph.nx)
        c = hessian(f)(uk).abs().amax()
        d1 = jacfwd(f)(uk).abs().amax()
        if lag is not None:
            L = lambda uu: _scalar(lag(xk, uu, tk, q), xk)
            c = torch.maximum(c, hessian(L)(uk).abs().amax())
            d1 = torch.maximum(d1, grad(L)(uk).abs().amax())
        return c / torch.clamp(d1, min=1e-300)

    return float(vmap(curv)(x, u, t).amax())


def promote_interior_if_affine(
    arcs: list[Arc], affinity: float, tol: float = 1e-8
) -> list[Arc]:
    """On a control-affine problem (``control_affinity`` ≈ 0) an interior
    arc cannot be a regular stationary-H_u arc — H_u carries no u dependence
    — so every sustained interior arc is singular (bang/singular is the
    complete arc alphabet for affine H). Promote in place."""
    if affinity < tol:
        for a in arcs:
            if a.kind == "interior":
                a.kind = "singular"
    return arcs


def has_singular_arc(arcs: list[Arc], min_duration_frac: float = 0.1) -> bool:
    """True when a flagged singular arc covers a meaningful fraction of the
    horizon (isolated touch points don't count)."""
    if not arcs:
        return False
    total = arcs[-1].t_end - arcs[0].t_start
    return any(
        a.kind == "singular"
        and (a.t_end - a.t_start) >= min_duration_frac * max(total, 1e-300)
        for a in arcs
    )


def describe_arcs(arcs: list[Arc]) -> str:
    return " -> ".join(
        f"{a.kind}[{a.t_start:.4g},{a.t_end:.4g}]"
        + (f"(osc={a.oscillations})" if a.kind == "singular" else "")
        for a in arcs
    )
