"""Tumor anti-angiogenesis (Ledzewicz–Schättler): bang–singular therapy.

``min p(tf)`` (minimal tumor volume) over a free horizon with a total-dose
budget, for the two-compartment model

    ṗ = -ξ p ln(p/q)                  (tumor volume, Gompertz growth)
    q̇ = q (b - μ - d p^(2/3) - G u)   (vascular carrying capacity)
    ẏ = u                             (cumulative dose)

with 0 ≤ u ≤ u_max and y(tf) ≤ A. The optimal therapy is
bang(u_max) → **singular** → bang(0): the canonical second singular-arc
benchmark after Goddard (H is affine in u), meant for the automatic
workflow (regularized solve → arc detection → eps-continuation) with no
hand-derived singular surface and no user-chosen phase split.

Constants follow the Ledzewicz–Schättler medium-dose scenario
(ξ=0.084, b=5.85, d=0.00873, G=0.15, μ=0.02 — per-day units, volumes mm³):
p̄ = ((b-μ)/d)^{3/2} ≈ 17346 is the uncontrolled equilibrium; we start at
p0 = p̄/2, q0 = p̄/4 with u_max = 75, a fixed 5-day treatment window, and
dose budget A = 150 (chosen so the singular arc spans ~90% of the horizon
and the budget binds near eps -> 0). The reference library has no
counterpart for this problem class. :func:`make_problem_regularized`
under :func:`auto_options` is the first rung of the automatic workflow
(:func:`solve_auto`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.lgr import uniform_fractions
from ..core.problem import Phase, Problem
from ..core.solve import SolveOptions, solve as _solve  # noqa: F401  (module API, as in the JAX module)

XI = 0.084
B = 5.85
D_C = 0.00873
G = 0.15
MU = 0.02
U_MAX = 75.0
A_DOSE = 150.0

P_BAR = ((B - MU) / D_C) ** 1.5          # uncontrolled fixed point ~17346
P0 = P_BAR / 2.0
Q0 = P_BAR / 4.0

# volumes are O(1e4): scale states by 1/SCALE so the NLP sees O(1) numbers
SCALE = 1e4


def _dynamics_q(x, u, t, q):
    """States (scaled): p̂ = p/SCALE, q̂ = q/SCALE, ŷ = y/A_DOSE; control
    normalized û = u/U_MAX ∈ [0, 1] (an O(1) control keeps the eps·û²
    regularizer's curvature O(eps) in the variables the NLP actually sees —
    with raw u ∈ [0, 75] the curvature is 2eps/75², i.e. no regularization,
    and the near-singular K lets the iterate wander; measured stall at
    kkt ~2e-5)."""
    ph, qh, yh = x
    p = ph * SCALE
    qq = qh * SCALE
    u_raw = u[0] * U_MAX
    dp = -XI * p * torch.log(p / qq)
    dq = qq * (B - MU - D_C * p ** (2.0 / 3.0) - G * u_raw)
    return torch.stack([dp / SCALE, dq / SCALE, u_raw / A_DOSE])


def _lagrange_eps_q(x, u, t, q):
    return q[0] * u[0] ** 2


def _mayer(x0, t0, xf, tf, q):
    return xf[0]          # minimize final (scaled) tumor volume


def make_problem_regularized(eps: float, degrees=(6,) * 6) -> Problem:
    """Single-phase regularized formulation with eps as a pinned parameter
    (the same function objects for the whole continuation ladder — same
    design as ``goddard.make_problem_regularized``)."""
    x_lo = np.array([0.05, 0.01, 0.0])
    x_hi = np.array([2.0, 2.0, 1.0])
    phase = Phase(
        nx=3, nu=1, nq=1,
        dynamics=_dynamics_q,
        mayer=_mayer,
        lagrange=_lagrange_eps_q,
        x0_bounds=(np.array([P0 / SCALE, Q0 / SCALE, 0.0]),
                   np.array([P0 / SCALE, Q0 / SCALE, 0.0])),
        xf_bounds=(np.array([x_lo[0], x_lo[1], 0.0]),
                   np.array([x_hi[0], x_hi[1], 1.0])),   # y(tf) <= A
        x_bounds=(x_lo, x_hi),
        u_bounds=(0.0, 1.0),
        q_bounds=(np.array([eps]), np.array([eps])),
        t0_bounds=(0.0, 0.0),
        tf_bounds=(5.0, 5.0),   # fixed 5-day treatment window
        guess_t=np.array([0.0, 2.5, 5.0]),
        guess_x=np.array([
            [P0 / SCALE, Q0 / SCALE, 0.0],
            [0.8 * P0 / SCALE, 0.4 * Q0 / SCALE, 0.5],
            [0.5 * P0 / SCALE, 0.2 * Q0 / SCALE, 1.0],
        ]),
        guess_u=np.array([[1.0], [0.5], [0.0]]),
        guess_q=np.array([eps]),
        mesh_degrees=tuple(degrees),
        mesh_fractions=uniform_fractions(len(degrees)),
        name="tumor-reg",
    )
    return Problem(phases=(phase,), name="tumor-reg")


def make_problem(degrees=(6,) * 6) -> Problem:
    """Unregularized formulation (for affinity checks / direct solves)."""
    p = make_problem_regularized(0.0, degrees)
    import dataclasses

    ph = dataclasses.replace(
        p.phases[0], nq=0, q_bounds=None, guess_q=None, lagrange=None,
        name="tumor",
    )
    return dataclasses.replace(p, phases=(ph,), name="tumor")


def auto_options(**kw) -> SolveOptions:
    from ..core.ipm import IPMOptions

    ipm = IPMOptions(tol=1e-8, max_iter=200, mu_strategy="adaptive")
    kw.setdefault("mesh_method", "none")
    return SolveOptions(ipm=ipm, **kw)


def solve_auto(
    eps_schedule=(1e-2, 1e-3, 1e-4, 1e-5),
    degrees=(6,) * 6,
    options: SolveOptions = None,
    method: str = "continuation",
    verbose: bool = False,
    *,
    device=None,
    dtype=torch.float64,
):
    """Automatic bang–singular solve via the generic detection workflow
    (:func:`lpopc_tpu_torch.core.decompose.auto_singular_solve`; identical to
    Goddard's, different physics — nothing here is problem-specific).
    Default method is continuation: the tumor horizon is FIXED and the
    singular arc spans ~90% of it, so freeing the switch times buys little;
    ``method="decompose"`` is available and golden-tested too. Every solve
    runs on ``device`` (``None`` means ``"cuda"``) in ``dtype``."""
    from ..core.decompose import auto_singular_solve

    return auto_singular_solve(
        make_regularized=lambda eps: make_problem_regularized(eps, degrees),
        make_unregularized=make_problem,
        u_bounds=(0.0, 1.0),
        options=options or auto_options(),
        eps_schedule=eps_schedule,
        method=method,
        verbose=verbose,
        device=device,
        dtype=dtype,
    )
