"""Goddard rocket: maximum-altitude ascent (COPS benchmark normalization).

``max h(tf)`` with ``ḣ = v``, ``v̇ = (T - D(h, v))/m - g(h)``, ``ṁ = -T/c``,
thrust ``0 <= T <= 3.5``, fuel limit ``m(tf) >= 0.6``, free final time.
Normalized data (COPS 3.0 "Goddard Rocket"): h0 = m0 = g0 = 1,
``D = Dc v² exp(-hc (h - h0))`` with Dc = 310, hc = 500, ``g = g0 (h0/h)²``,
``c = 0.5 sqrt(g0 h0)``. Published optimum: h* ≈ 1.01283.

The optimal control is bang-singular-bang — the canonical singular-arc stress
test. The single-phase formulation (:func:`make_problem`) has zero reduced
curvature along the singular arc, so a Newton-type NLP may stop on the
bang-bang local solution (h ≈ 1.0040) or crawl along the arc; on
``degrees=(6,) * 4`` this port and the JAX package both reach h = 1.012833
in 18 iterations. The 3-phase decomposition with the derived singular
surface ``m g = D (1 + v/c)`` (:func:`make_problem_three_phase`) recovers
the published optimum in 6 iterations. The automatic workflow
(:func:`solve_auto`: arc detection, then decomposition or continuation)
needs neither the surface nor the split.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.lgr import uniform_fractions
from ..core.problem import Phase, Problem
from ..core.solve import SolveOptions, solve as _solve

H0, M0, G0 = 1.0, 1.0, 1.0
T_MAX = 3.5
M_FINAL = 0.6
DC = 310.0
HC = 500.0
C_EX = 0.5 * np.sqrt(G0 * H0)
PUBLISHED_HF = 1.01283


def make_problem(degrees=(8,) * 6, fractions=None, regularization: float = 1e-6) -> Problem:
    """``regularization`` adds ``eps ∫ T² dt`` to the cost — the standard
    singular-arc regularization (the unregularized bang-singular-bang problem
    has a singular reduced Hessian along the arc, which stalls Newton-type
    NLP methods; eps = 1e-6 shifts h* by O(eps)). Set 0 for the raw problem.
    """
    if fractions is None:
        fractions = uniform_fractions(len(degrees))

    def dynamics(x, u, t, q):
        h, v, m = x
        T = u[0]
        drag = DC * v * v * torch.exp(-HC * (h - H0))
        g = G0 * (H0 / h) ** 2
        return torch.stack([v, (T - drag) / m - g, -T / C_EX])

    phase = Phase(
        nx=3, nu=1,
        dynamics=dynamics,
        mayer=lambda x0, t0, xf, tf, q: -xf[0],
        lagrange=(
            (lambda x, u, t, q: regularization * u[0] ** 2)
            if regularization else None
        ),
        x0_bounds=(np.array([H0, 0.0, M0]), np.array([H0, 0.0, M0])),
        xf_bounds=(np.array([H0, 0.0, M_FINAL]), np.array([2.0, 0.5, M_FINAL])),
        x_bounds=(np.array([H0, -0.5, M_FINAL]), np.array([2.0, 0.5, M0])),
        u_bounds=(0.0, T_MAX),
        t0_bounds=(0.0, 0.0),
        tf_bounds=(0.05, 0.4),
        guess_t=np.array([0.0, 0.1, 0.2]),
        guess_x=np.array([[1.0, 0.0, 1.0], [1.005, 0.1, 0.8], [1.01, 0.0, 0.6]]),
        guess_u=np.array([[T_MAX], [1.0], [0.0]]),
        mesh_degrees=tuple(degrees),
        mesh_fractions=tuple(fractions),
        name="goddard",
    )
    return Problem(phases=(phase,), name="goddard")


def _drag_g(h, v):
    drag = DC * v * v * torch.exp(-HC * (h - H0))
    g = G0 * (H0 / h) ** 2
    return drag, g


# ----- module-level callables for the continuation path: every rung of the
# eps ladder uses the same function objects, and the regularization weight
# eps rides in as a PINNED static parameter q[0] (a runtime bound, not a
# baked constant) -----

def _dynamics_q(x, u, t, q):
    h, v, m = x
    T = u[0]
    drag, g = _drag_g(h, v)
    return torch.stack([v, (T - drag) / m - g, -T / C_EX])


def _lagrange_eps_q(x, u, t, q):
    return q[0] * u[0] ** 2


def _mayer_alt(x0, t0, xf, tf, q):
    return -xf[0]


# loose envelope boxes (see make_problem_three_phase docstring: boxes the
# trajectory RIDES without multiplier support poison the barrier)
_X_LO = np.array([0.995, -0.05, 0.55])
_X_HI = np.array([1.2, 0.5, 1.0])


def make_problem_regularized(eps: float, degrees=(6,) * 6) -> Problem:
    """Single-phase Goddard with ``eps ∫T² dt`` regularization carried as a
    pinned static parameter and flight-envelope boxes. Built for the
    automatic continuation of :func:`solve_auto`: every ``eps`` produces the
    same function objects and shapes."""
    phase = Phase(
        nx=3, nu=1, nq=1,
        dynamics=_dynamics_q,
        mayer=_mayer_alt,
        lagrange=_lagrange_eps_q,
        x0_bounds=(np.array([H0, 0.0, M0]), np.array([H0, 0.0, M0])),
        xf_bounds=(np.array([_X_LO[0], 0.0, M_FINAL]),
                   np.array([_X_HI[0], _X_HI[1], M_FINAL])),
        x_bounds=(_X_LO, _X_HI),
        u_bounds=(0.0, T_MAX),
        q_bounds=(np.array([eps]), np.array([eps])),
        t0_bounds=(0.0, 0.0),
        tf_bounds=(0.05, 0.4),
        guess_t=np.array([0.0, 0.1, 0.2]),
        guess_x=np.array([[1.0, 0.0, 1.0], [1.005, 0.1, 0.8], [1.01, 0.0, 0.6]]),
        guess_u=np.array([[T_MAX], [1.0], [0.0]]),
        guess_q=np.array([eps]),
        mesh_degrees=tuple(degrees),
        mesh_fractions=uniform_fractions(len(degrees)),
        name="goddard-reg",
    )
    return Problem(phases=(phase,), name="goddard-reg")


def auto_options(**kw) -> SolveOptions:
    """IPM settings for the single-phase envelope formulation (same three
    levers as :func:`three_phase_options`, diagnosed there)."""
    from ..core.ipm import IPMOptions

    ipm = IPMOptions(tol=1e-8, max_iter=200, delta_c=1e-8, kappa_1=1e-6,
                     mu_strategy="adaptive")
    kw.setdefault("mesh_method", "none")
    return SolveOptions(ipm=ipm, **kw)


def solve_auto(
    eps_schedule=(1e-2, 1e-3, 1e-4, 1e-5),
    degrees=(6,) * 6,
    options: SolveOptions = None,
    method: str = "decompose",
    verbose: bool = False,
    *,
    decomposed_options: SolveOptions = None,
    device=None,
    dtype=torch.float64,
):
    """Fully automatic singular-arc solve — no user-chosen phase split.

    Generic workflow (:func:`lpopc_tpu_torch.core.decompose.auto_singular_solve`):
    regularized solve → arc detection → either the automatic per-arc
    multi-phase decomposition with free switch times (default; it falls
    back to the eps ladder when the decomposed solve does not converge, as
    at the default degrees, in the JAX package too) or eps-continuation
    (``method="continuation"``; every rung has the same functions, since
    eps is a pinned parameter). ``decomposed_options``
    (default :func:`three_phase_options`) solves the decomposed problem.
    Every solve runs on ``device`` (``None`` means ``"cuda"``) in ``dtype``.
    """
    from ..core.decompose import auto_singular_solve

    return auto_singular_solve(
        make_regularized=lambda eps: make_problem_regularized(eps, degrees),
        make_unregularized=lambda: make_problem(regularization=0.0),
        u_bounds=(0.0, T_MAX),
        options=options or auto_options(),
        eps_schedule=eps_schedule,
        method=method,
        decomposed_options=decomposed_options or three_phase_options(),
        verbose=verbose,
        device=device,
        dtype=dtype,
    )


def singular_surface(x):
    """Switching/singular surface ``S = m g - (1 + v/c) D`` (zero along the
    singular arc; derived from the vanishing switching function and its first
    time derivative)."""
    h, v, m = x
    drag, g = _drag_g(h, v)
    return m * g - (1.0 + v / C_EX) * drag


def singular_thrust(x):
    """The singular thrust from ``dS/dt = 0`` solved for T.

    With ``D_h = -hc D``, ``D_v = 2D/v``, ``g_h = -2g/h``:

        Ṡ = a·T + b,   a = -g/c - (D/c + (1+v/c) D_v)/m,
        b = m g_h v - (1+v/c) D_h v + (D/c + (1+v/c) D_v)(D/m + g)

    so ``T_sing = -b/a``. On the optimal arc T_sing ∈ (0, T_MAX); the clip
    only guards the line search off the arc.
    """
    h, v, m = x
    drag, g = _drag_g(h, v)
    v_safe = torch.where(torch.abs(v) > 1e-12, v, 1e-12)
    d_h = -HC * drag
    d_v = 2.0 * drag / v_safe
    g_h = -2.0 * g / h
    k = drag / C_EX + (1.0 + v / C_EX) * d_v
    a = -g / C_EX - k / m
    b = m * g_h * v - (1.0 + v / C_EX) * d_h * v + k * (drag / m + g)
    return torch.clamp(-b / a, 0.0, T_MAX)


def _shoot_guess(dt: float = 2e-4):
    """RK4-integrate the bang/singular/coast law (switch at S = 0, end the
    arc at the fuel limit, coast to apex) for a dynamics-consistent guess.
    Returns per-phase (t, x) tables. Host numpy; runs in milliseconds."""
    def f(x, T):
        h, v, m = x
        drag = DC * v * v * np.exp(-HC * (h - H0))
        g = G0 * (H0 / h) ** 2
        return np.array([v, (T - drag) / m - g, -T / C_EX])

    def rk4(x, T):
        k1 = f(x, T); k2 = f(x + dt / 2 * k1, T)
        k3 = f(x + dt / 2 * k2, T); k4 = f(x + dt * k3, T)
        return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

    def S(x):
        return float(singular_surface(torch.as_tensor(x)))

    def Ts(x):
        return float(singular_thrust(torch.as_tensor(x)))

    x = np.array([H0, 0.0, M0]); t = 0.0
    tables = []
    tr = [(t, *x)]
    while S(x) > 0:
        x = rk4(x, T_MAX); t += dt; tr.append((t, *x))
    tables.append(np.asarray(tr))
    tr = [(t, *x)]
    while x[2] > M_FINAL:
        x = rk4(x, Ts(x)); t += dt; tr.append((t, *x))
    tables.append(np.asarray(tr))
    tr = [(t, *x)]
    while x[1] > 0:
        x = rk4(x, 0.0); t += dt; tr.append((t, *x))
    tables.append(np.asarray(tr))
    return tables


def make_problem_three_phase(degrees=((6, 6), (6, 6), (6, 6))) -> Problem:
    """Bang–singular–bang decomposition (the methodology GPOPS-class tools
    use for this problem): phase 1 full thrust until the state reaches the
    singular surface ``S = m g - (1 + v/c) D = 0`` (imposed ONCE, as a
    terminal event of phase 1), phase 2 flies the analytic singular thrust
    ``T_sing(x)`` from ``dS/dt = 0`` (control eliminated — imposing S = 0 as
    an equality path row at every node is rank-deficient against the defects,
    since the surface is flow-invariant under T_sing), phase 3 coasts (T = 0)
    to the apex ``v(tf) = 0``. Interior switch times are free through the
    automatic time linkage; phase 2 ends at the fuel limit ``m = 0.6``.
    Recovers the published h* ≈ 1.01283 that the single-phase bang-bang local
    optimum (h ≈ 1.0040) misses.

    Three things make this converge in <10 IPM iterations where it
    otherwise stalls; use :func:`solve_three_phase` (or
    :func:`three_phase_options`) to get the matching solver settings:

    * **no state bounds the trajectory rides**: with ``h >= 1`` / ``m >= 0.6``
      box bounds the whole flight sits within ~1e-6 of a bound without
      multiplier support, and the log barrier both distorts the problem and
      blows up the bound duals. The boxes here (h in [0.995, 1.2], v in
      [-0.05, 0.5], m in [0.55, 1]) enclose the flight envelope loosely; the
      physical limits are enforced where they bind (terminally).
    * **tiny interior push** (``kappa_1 = 1e-6``): IPOPT's default 1e-2
      relative push-off-the-bounds would move the guess by 1e-2 in states
      whose whole dynamic range is ~1e-3, through a drag term exp(-500(h-1)).
    * **small condensation penalty** (``delta_c = 1e-8``): the analytic
      singular thrust carries O(hc²)=O(2.5e5) curvature, so the O(delta_c
      lam) equality-step perturbation at 1e-6 stalls the dual iteration.
    """
    from ..core.problem import Linkage

    def dyn_T(T_of):
        def dynamics(x, u, t, q):
            h, v, m = x
            T = T_of(x)
            drag, g = _drag_g(h, v)
            return torch.stack([v, (T - drag) / m - g, -T / C_EX])

        return dynamics

    # loose boxes around the flight envelope (see docstring)
    x_lo = np.array([0.995, -0.05, 0.55])
    x_hi = np.array([1.2, 0.5, 1.0])
    guesses = _shoot_guess()
    # constant thrusts as tensors of the state's device and dtype
    dynamics_by_phase = (
        dyn_T(lambda x: torch.full_like(x[0], T_MAX)),
        dyn_T(singular_thrust),
        dyn_T(lambda x: torch.zeros_like(x[0])),
    )
    phases = []
    for i in range(3):
        kw = dict(nx=3, nu=0, dynamics=dynamics_by_phase[i], x_bounds=(x_lo, x_hi))
        t0b = (0.0, 0.0) if i == 0 else (0.005, 0.3)
        tfb = (0.005, 0.3) if i < 2 else (0.05, 0.4)
        if i == 0:
            kw.update(
                x0_bounds=(np.array([H0, 0.0, M0]), np.array([H0, 0.0, M0])),
                # phase 1 ends ON the singular surface
                nevent=1,
                event=lambda x0, t0, xf, tf, q: torch.stack([singular_surface(xf)]),
                event_bounds=(0.0, 0.0),
            )
        if i == 1:
            # fuel limit reached exactly at the end of the singular arc
            kw.update(xf_bounds=(np.array([x_lo[0], x_lo[1], M_FINAL]),
                                 np.array([x_hi[0], x_hi[1], M_FINAL])))
        if i == 2:
            kw.update(xf_bounds=(np.array([x_lo[0], 0.0, x_lo[2]]),
                                 np.array([x_hi[0], 0.0, x_hi[2]])),
                      mayer=lambda x0, t0, xf, tf, q: -xf[0])
        g = guesses[i]
        idx = np.linspace(0, g.shape[0] - 1, 12).astype(int)
        phases.append(Phase(
            t0_bounds=t0b, tf_bounds=tfb,
            duration_bounds=(0.005, 0.4),
            guess_t=g[idx, 0], guess_x=g[idx, 1:4],
            mesh_degrees=tuple(degrees[i]),
            mesh_fractions=uniform_fractions(len(degrees[i])),
            name=f"goddard-phase-{i + 1}",
            **kw,
        ))
    links = tuple(
        Linkage(left=i, right=i + 1, nlink=3,
                fn=lambda xfl, ql, x0r, qr: x0r - xfl)
        for i in range(2)
    )
    return Problem(phases=tuple(phases), linkages=links, name="goddard-3phase")


def three_phase_options(**kw) -> SolveOptions:
    """Solver settings matched to the 3-phase formulation (see
    :func:`make_problem_three_phase` docstring for why each knob moves)."""
    from ..core.ipm import IPMOptions

    ipm = IPMOptions(tol=1e-8, max_iter=200, delta_c=1e-8, kappa_1=1e-6,
                     mu_strategy="adaptive")
    return SolveOptions(ipm=ipm, mesh_method="none", **kw)


def solve_three_phase(*, device=None, dtype=torch.float64, **kw):
    return _solve(make_problem_three_phase(), three_phase_options(**kw),
                  device=device, dtype=dtype)


def solve(options: SolveOptions = None, *, device=None, dtype=torch.float64, **kw):
    return _solve(make_problem(**kw), options or SolveOptions(mesh_method="hp-liu"),
                  device=device, dtype=dtype)
