"""Automatic multi-phase decomposition from a detected arc structure.

Given a single-phase solve and the arc structure found by
:mod:`.arcs` (bang / singular), build the multi-phase problem that
reference-class workflows construct BY HAND (e.g. the Goddard 3-phase
bang–singular–bang split, `models/goddard.py::make_problem_three_phase`):

* one phase per arc, switch times free (phase boundaries + automatic time
  linkage rows — the transcription already emits ``t0^{p+1} = tf^p``),
* bang arcs pin the control AT its bound (equal bounds — the IPM treats
  them as fixed variables, removing the ringing dimension entirely),
* singular arcs keep the control free with a small ``eps·û²`` regularizer
  confined to that phase (regularize exactly where the reduced Hessian is
  singular, nowhere else),
* full-state continuity linkages, per-arc guesses sliced from the source
  solution.

The endpoint functions (Mayer, events) of the original phase are mapped by
**AD-measured endpoint dependency**: a Mayer/event that touches only
``(xf, tf)`` goes to the last phase, only ``(x0, t0)`` to the first; one
that couples both endpoints cannot be split and raises (the continuation
path, which needs no decomposition, still handles it).

Why bother when eps-continuation already converges: the decomposition
resolves the switch TIMES as free variables (spectral accuracy at the
switches instead of smearing them across a mesh cell), which is exactly
why hand-built decompositions out-resolve regularized single-phase solves.

The AD runs on the device the caller names (``device=``; ``None`` means
``"cuda"``), and :func:`auto_singular_solve` runs every solve there.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacrev

from ..ops.lgr import uniform_fractions
from ..utils.device import resolve_device
from .arcs import Arc
from .problem import Linkage, Phase, Problem


def _endpoint_dependency(fn, nx, nq, sample):
    """(uses_initial, uses_final) measured by AD at a sample point.

    Full Jacobian per component (not a gradient of the component SUM —
    opposite-sign dependencies across event components would cancel there
    and misclassify). ``sample`` is ``(x0, t0, xf, tf, q)`` as tensors
    (``t0``/``tf`` 0-d) on the device where ``fn`` is evaluated."""
    x0, t0, xf, tf, q = sample

    def f(x0_, t0_, xf_, tf_):
        return torch.atleast_1d(torch.as_tensor(fn(x0_, t0_, xf_, tf_, q), dtype=x0_.dtype,
                                                device=x0_.device))

    J = jacrev(f, argnums=(0, 1, 2, 3))(x0, t0, xf, tf)
    m = [float(j.abs().amax()) if j.numel() else 0.0 for j in J]
    uses_initial = m[0] > 1e-12 or m[1] > 1e-12
    uses_final = m[2] > 1e-12 or m[3] > 1e-12
    return uses_initial, uses_final


def decompose_by_arcs(
    problem: Problem,
    psol,
    arcs: list[Arc],
    eps_singular: float = 1e-6,
    nodes_per_arc: int = 8,
    segments_per_arc: int = 2,
    min_duration: float = 1e-3,
    *,
    device=None,
    dtype=torch.float64,
) -> Problem:
    """Build the per-arc multi-phase :class:`Problem` (see module docstring).

    ``problem`` must be single-phase (the UN-regularized formulation);
    ``psol``/``arcs`` come from the regularized solve + detection
    (``sol.phases[0]`` / ``sol.arcs`` of a model's ``solve_auto``).
    """
    device = resolve_device(device)
    if len(problem.phases) != 1:
        raise ValueError("decompose_by_arcs expects a single-phase problem")
    src = problem.phases[0]
    if src.nu != 1:
        raise ValueError(
            "arc decomposition currently supports one control (the "
            "bang/singular alphabet is per-control)"
        )
    nx, nq = src.nx, src.nq
    if nq:
        raise ValueError(
            "static parameters are not yet supported in arc decomposition "
            "(pass the unregularized formulation)"
        )
    u_lo = float(np.asarray(src.u_bounds[0]).reshape(-1)[0])
    u_hi = float(np.asarray(src.u_bounds[1]).reshape(-1)[0])

    # endpoint-dependency classification of Mayer / events
    t0s, tfs = float(psol.t0), float(psol.tf)
    T = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=device, dtype=dtype)
    sample = (
        T(np.asarray(psol.x)[0]), T(t0s), T(np.asarray(psol.x)[-1]), T(tfs),
        T(np.asarray(psol.q)),
    )
    mayer_initial = mayer_final = False
    if src.mayer is not None:
        mayer_initial, mayer_final = _endpoint_dependency(src.mayer, nx, nq, sample)
        if mayer_initial and mayer_final:
            raise ValueError(
                "Mayer couples both endpoints; arc decomposition cannot "
                "split it — use the continuation path"
            )
    ev_initial = ev_final = False
    if src.nevent:
        ev_initial, ev_final = _endpoint_dependency(src.event, nx, nq, sample)
        if ev_initial and ev_final:
            raise ValueError(
                "events couple both endpoints; arc decomposition cannot "
                "split them — use the continuation path"
            )

    # time interpolants of the source solution for guesses
    t_state = np.asarray(psol.t_state)
    t_col = np.asarray(psol.t_col)
    X = np.asarray(psol.x)
    U = np.asarray(psol.u)

    lagrange_src = src.lagrange

    def singular_lagrange(x, u, t, q, _span=max(u_hi - u_lo, 1e-300)):
        reg = eps_singular * ((u[0] - u_lo) / _span) ** 2
        if lagrange_src is not None:
            return lagrange_src(x, u, t, q) + reg
        return reg

    horizon = max(tfs - t0s, 1e-300)
    phases = []
    n_arcs = len(arcs)
    for i, arc in enumerate(arcs):
        ts = t0s if i == 0 else arc.t_start
        te = tfs if i == n_arcs - 1 else arcs[i + 1].t_start
        first, last = i == 0, i == n_arcs - 1
        if arc.kind == "upper":
            u_b = (u_hi, u_hi)
            lag = lagrange_src
        elif arc.kind == "lower":
            u_b = (u_lo, u_lo)
            lag = lagrange_src
        else:  # interior / singular: free control, confined regularizer
            u_b = (u_lo, u_hi)
            lag = singular_lagrange
        # guesses sliced (and slightly extended) from the source solution
        gt = np.linspace(ts, te, 10)
        gx = np.stack([np.interp(gt, t_state, X[:, j]) for j in range(nx)], axis=1)
        gu = np.stack([np.interp(gt, t_col, U[:, j]) for j in range(src.nu)], axis=1)
        kw = dict(
            nx=nx, nu=src.nu, nq=0,
            dynamics=src.dynamics,
            lagrange=lag,
            path=src.path, npath=src.npath, path_bounds=src.path_bounds,
            x_bounds=src.x_bounds,
            u_bounds=u_b,
            x0_bounds=src.x0_bounds if first else src.x_bounds,
            xf_bounds=src.xf_bounds if last else src.x_bounds,
            t0_bounds=src.t0_bounds if first else (
                min(ts - 0.25 * horizon, ts), max(ts + 0.25 * horizon, ts)
            ),
            tf_bounds=src.tf_bounds if last else (
                min(te - 0.25 * horizon, te), max(te + 0.25 * horizon, te)
            ),
            duration_bounds=(min_duration, horizon),
            guess_t=gt, guess_x=gx, guess_u=gu,
            mesh_degrees=(nodes_per_arc,) * segments_per_arc,
            mesh_fractions=uniform_fractions(segments_per_arc),
            name=f"{src.name or 'arc'}-{arc.kind}-{i + 1}",
        )
        if first and (mayer_initial or ev_initial):
            if mayer_initial:
                kw["mayer"] = src.mayer
            if ev_initial:
                kw.update(nevent=src.nevent, event=src.event,
                          event_bounds=src.event_bounds)
        if last and (mayer_final or ev_final):
            if mayer_final:
                kw["mayer"] = src.mayer
            if ev_final:
                kw.update(nevent=src.nevent, event=src.event,
                          event_bounds=src.event_bounds)
        phases.append(Phase(**kw))

    links = tuple(
        Linkage(left=i, right=i + 1, nlink=nx,
                fn=lambda xfl, ql, x0r, qr: x0r - xfl)
        for i in range(n_arcs - 1)
    )
    return Problem(
        phases=tuple(phases), linkages=links,
        name=f"{problem.name or 'ocp'}-arcs",
    )


def auto_singular_solve(
    make_regularized,
    make_unregularized,
    u_bounds: tuple,
    options,
    eps_schedule=(1e-2, 1e-3, 1e-4, 1e-5),
    method: str = "decompose",
    decomposed_options=None,
    eps_singular: float = 1e-6,
    verbose: bool = False,
    *,
    device=None,
    dtype=torch.float64,
):
    """The generic automatic singular-arc workflow (model-independent).

    1. Solve ``make_regularized(eps_schedule[0])`` — a regular problem.
    2. Detect the arc structure (:mod:`.arcs`): saturation classes +
       ringing / switching-function flags + control-affinity promotion.
    3. If a singular arc is present:
       * ``method="decompose"`` (default): build the per-arc multi-phase
         split (:func:`decompose_by_arcs`) — switch times become free
         phase boundaries — and solve it. Falls back to continuation when
         the split is impossible (endpoint-coupled Mayer/events).
       * ``method="continuation"``: walk the remaining eps ladder,
         warm-started (every rung has the same functions when eps rides
         as a pinned parameter in ``make_regularized``).

    ``make_regularized(eps) -> Problem`` (single-phase),
    ``make_unregularized() -> Problem`` (same but eps term absent, nq=0),
    ``u_bounds = (lo, hi)`` of the (single) control. Every solve and every
    AD evaluation runs on ``device`` (``None`` means ``"cuda"``, and raises
    without one) in ``dtype``. Returns the final Solution with ``sol.arcs``
    attached.
    """
    from . import arcs as arcs_mod
    from . import solve as solve_mod
    from .postprocess import warm_start_problem

    device = resolve_device(device)
    on = dict(device=device, dtype=dtype)
    u_lo, u_hi = u_bounds
    sol = solve_mod.solve(make_regularized(eps_schedule[0]), options, **on)
    psol = sol.phases[0]
    ph0 = make_unregularized().phases[0]
    hu = arcs_mod.switching_function(ph0, psol, **on)
    arcs = arcs_mod.detect_control_arcs(
        psol.t_col, psol.u[:, 0], u_lo, u_hi, hu=hu
    )
    affinity = arcs_mod.control_affinity(ph0, psol, lagrange=None, **on)
    arcs = arcs_mod.promote_interior_if_affine(arcs, affinity)
    if verbose:
        print(f"arc structure: {arcs_mod.describe_arcs(arcs)} "
              f"(affinity {affinity:.1e})")
    sol.arcs = arcs
    if not arcs_mod.has_singular_arc(arcs):
        return sol

    if method == "decompose":
        try:
            dp = decompose_by_arcs(
                make_unregularized(), psol, arcs, eps_singular=eps_singular, **on
            )
            dsol = solve_mod.solve(dp, decomposed_options or options, **on)
            if dsol.solved:
                dsol.arcs = arcs
                return dsol
            if verbose:
                print(f"decomposed solve status {dsol.status}; "
                      "falling back to continuation")
        except ValueError as e:
            if verbose:
                print(f"decomposition impossible ({e}); continuation")

    for eps in eps_schedule[1:]:
        p = make_regularized(eps)
        sol = solve_mod.solve(warm_start_problem(p, sol), options, **on)
    sol.arcs = arcs
    return sol
