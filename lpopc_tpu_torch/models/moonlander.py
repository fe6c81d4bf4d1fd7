"""Moon lander: minimum-fuel soft landing (BASELINE.json config #3).

``min ∫ u dt`` with ``ḣ = v, v̇ = -g + u``, ``0 <= u <= u_max``, from
(h0, v0) to (0, 0) with free final time. The optimum is bang-bang
(free fall, then full thrust), making this the framework's control-bound /
non-smooth stress test. The analytic switch structure gives a closed-form
oracle (see :func:`analytic_solution`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.problem import Phase, Problem
from ..core.solve import SolveOptions, solve as _solve
from ..ops.lgr import uniform_fractions

G = 1.5
U_MAX = 3.0


def make_problem(h0: float = 10.0, v0: float = -2.0, degrees=(6,) * 6, fractions=None) -> Problem:
    if fractions is None:
        fractions = uniform_fractions(len(degrees))
    tf_guess = analytic_solution(h0, v0)[0]

    phase = Phase(
        nx=2, nu=1,
        dynamics=lambda x, u, t, q: torch.stack([x[1], -G + u[0]]),
        lagrange=lambda x, u, t, q: u[0],
        x0_bounds=(np.array([h0, v0]), np.array([h0, v0])),
        xf_bounds=(np.zeros(2), np.zeros(2)),
        x_bounds=(np.array([-1.0, -50.0]), np.array([50.0, 50.0])),
        u_bounds=(0.0, U_MAX),
        t0_bounds=(0.0, 0.0),
        tf_bounds=(0.1, 30.0),
        guess_t=np.array([0.0, tf_guess]),
        guess_x=np.array([[h0, v0], [0.0, 0.0]]),
        guess_u=np.array([[0.0], [U_MAX]]),
        mesh_degrees=tuple(degrees),
        mesh_fractions=tuple(fractions),
        name="moon-lander",
    )
    return Problem(phases=(phase,), name="moon-lander")


def analytic_solution(h0: float = 10.0, v0: float = -2.0):
    """(tf, t_switch, fuel) for the free-fall-then-full-thrust optimum.

    Arc 1 (u=0) on [0, ts]: v = v0 - g t, h = h0 + v0 t - g t²/2.
    Arc 2 (u=u_max) lands with v(tf) = 0, h(tf) = 0. Matching gives a
    quadratic in ts.
    """
    g, um = G, U_MAX
    # Continuity at the switch: v(ts) = v0 - g ts = -(um - g) T2 with
    # T2 = tf - ts; the landing condition h(tf) = 0 reduces to
    # h_s - v_s^2 / (2 (um - g)) = 0, a quadratic in ts.
    A = -g / 2.0 - g * g / (2.0 * (um - g))
    B = v0 + v0 * g / (um - g)
    Cc = h0 - v0 * v0 / (2.0 * (um - g))
    roots = np.roots([A, B, Cc])
    candidates = [
        float(r.real) for r in roots
        if abs(r.imag) < 1e-12 and r.real >= 0.0 and (v0 - g * r.real) <= 0.0
    ]
    ts = min(candidates)
    v_s = v0 - g * ts
    T2 = -v_s / (um - g)
    tf = ts + T2
    fuel = um * T2
    return tf, ts, fuel


def solve(options: SolveOptions = None, *, device=None, dtype=torch.float64, **kw):
    return _solve(make_problem(**kw), options or SolveOptions(), device=device, dtype=dtype)
