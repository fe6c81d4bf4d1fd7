"""Bryson–Denham state-constrained double integrator (reference example #2).

``min x3(tf)`` with ``ẋ1 = x2, ẋ2 = u, ẋ3 = u²/2``, boundary conditions
``x1(0) = x1(1) = 0``, ``x2(0) = 1 = -x2(1)``, and the state path bound
``x1 <= l`` imposed through the 3-point state-bound convention exactly like
the reference (``Lpopc/example/bryson-denham/BrysonDenham.cpp:25-66``).
Analytic optimum for ``l <= 1/6``: J = 4/(9l); l = 1/9 gives J* = 4.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.problem import INF, Phase, Problem
from ..core.solve import SolveOptions, solve as _solve
from ..ops.lgr import uniform_fractions


def make_problem(l: float = 1.0 / 9.0, degrees=(8, 8, 8, 8), fractions=None) -> Problem:
    if fractions is None:
        fractions = uniform_fractions(len(degrees))

    phase = Phase(
        nx=3, nu=1,
        dynamics=lambda x, u, t, q: torch.stack([x[1], u[0], 0.5 * u[0] ** 2]),
        mayer=lambda x0, t0, xf, tf, q: xf[2],
        x0_bounds=(np.array([0.0, 1.0, 0.0]), np.array([0.0, 1.0, 0.0])),
        xf_bounds=(np.array([0.0, -1.0, 0.0]), np.array([0.0, -1.0, INF])),
        x_bounds=(np.array([0.0, -10.0, 0.0]), np.array([l, 10.0, INF])),
        u_bounds=(-INF, INF),
        t0_bounds=(0.0, 0.0),
        tf_bounds=(1.0, 1.0),
        guess_t=np.array([0.0, 0.5, 1.0]),
        guess_x=np.array([[0.0, 1.0, 0.0], [l, 0.0, 2.0], [0.0, -1.0, 4.0]]),
        guess_u=np.array([[-6.0], [0.0], [6.0]]),
        mesh_degrees=tuple(degrees),
        mesh_fractions=tuple(fractions),
        name="bryson-denham",
    )
    return Problem(phases=(phase,), name="bryson-denham")


def solve(options: SolveOptions = None, *, device=None, dtype=torch.float64, **kw):
    return _solve(make_problem(**kw), options or SolveOptions(), device=device, dtype=dtype)
