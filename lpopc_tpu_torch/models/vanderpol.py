"""Van der Pol oscillator control — a standard NLP-solver regression problem.

``min ∫ (x1² + x2² + u²) dt`` over t ∈ [0, 5] with
``ẋ1 = x2, ẋ2 = (1 - x1²) x2 - x1 + u``, x(0) = (1, 0). The unconstrained
variant's published optimal cost is ≈ 2.87 (widely reproduced, e.g. in the
CasADi/GPOPS test suites); ``bounded=True`` adds the classic state bound
``x2 >= -0.3``, which activates along an arc and raises the cost.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.problem import INF, Phase, Problem
from ..core.solve import SolveOptions, solve as _solve
from ..ops.lgr import uniform_fractions


def make_problem(bounded: bool = True, degrees=(6,) * 5, fractions=None) -> Problem:
    if fractions is None:
        fractions = uniform_fractions(len(degrees))
    x2_min = -0.3 if bounded else -INF
    phase = Phase(
        nx=2, nu=1,
        dynamics=lambda x, u, t, q: torch.stack(
            [x[1], (1.0 - x[0] ** 2) * x[1] - x[0] + u[0]]
        ),
        lagrange=lambda x, u, t, q: x[0] ** 2 + x[1] ** 2 + u[0] ** 2,
        x0_bounds=(np.array([1.0, 0.0]), np.array([1.0, 0.0])),
        x_bounds=(np.array([-10.0, x2_min]), np.array([10.0, 10.0])),
        xf_bounds=(np.array([-10.0, x2_min]), np.array([10.0, 10.0])),
        u_bounds=(-20.0, 20.0),
        t0_bounds=(0.0, 0.0), tf_bounds=(5.0, 5.0),
        guess_t=np.array([0.0, 5.0]),
        guess_x=np.array([[1.0, 0.0], [0.0, 0.0]]),
        guess_u=np.array([[0.0], [0.0]]),
        mesh_degrees=tuple(degrees), mesh_fractions=tuple(fractions),
        name="van-der-pol",
    )
    return Problem(phases=(phase,), name="van-der-pol")


def solve(options: SolveOptions = None, *, device=None, dtype=torch.float64, **kw):
    return _solve(make_problem(**kw), options or SolveOptions(), device=device, dtype=dtype)
