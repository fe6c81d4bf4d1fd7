"""Brachistochrone: minimum-time bead-on-a-wire (the flagship sweep model).

States (x, y, v) with y measured downward, control θ (wire angle from the
vertical): ẋ = v sinθ, ẏ = v cosθ, v̇ = g cosθ; start at rest at the origin,
reach (xf, yf) in minimum time. The analytic optimum is a cycloid, which makes
this the framework's primary golden test.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.problem import Phase, Problem
from ..core.solve import SolveOptions, solve as _solve
from ..ops.lgr import uniform_fractions

G = 10.0


def make_problem(xf: float = 2.0, yf: float = 2.0, degrees=(8, 8, 8), fractions=None) -> Problem:
    if fractions is None:
        fractions = uniform_fractions(len(degrees))

    def dynamics(x, u, t, q):
        v = x[2]
        th = u[0]
        return torch.stack([v * torch.sin(th), v * torch.cos(th), G * torch.cos(th)])

    phase = Phase(
        nx=3, nu=1,
        dynamics=dynamics,
        mayer=lambda x0, t0, xfv, tf, q: tf,
        x0_bounds=(np.zeros(3), np.zeros(3)),
        xf_bounds=(np.array([xf, yf, 0.0]), np.array([xf, yf, 50.0])),
        x_bounds=(np.array([-0.5, -0.5, 0.0]), np.array([10.0, 10.0, 50.0])),
        u_bounds=(0.0, np.pi),
        t0_bounds=(0.0, 0.0),
        tf_bounds=(0.05, 10.0),
        guess_t=np.array([0.0, 1.0]),
        guess_x=np.array([[0.0, 0.0, 0.0], [xf, yf, np.sqrt(2 * G * yf)]]),
        guess_u=np.array([[np.pi / 4], [np.pi / 4]]),
        mesh_degrees=tuple(degrees),
        mesh_fractions=fractions,
        name="brachistochrone",
    )
    return Problem(phases=(phase,), name="brachistochrone")


def analytic_tf(xf: float = 2.0, yf: float = 2.0) -> float:
    """Minimum time from the cycloid solution (Newton on the endpoint ratio)."""
    ratio = xf / yf
    phi = np.pi / 2
    for _ in range(60):
        f = (phi - np.sin(phi)) / (1 - np.cos(phi)) - ratio
        df = ((1 - np.cos(phi)) ** 2 - (phi - np.sin(phi)) * np.sin(phi)) / (
            1 - np.cos(phi)
        ) ** 2
        phi -= f / df
    a = yf / (1 - np.cos(phi))
    return phi * np.sqrt(a / G)


def solve(options: SolveOptions = None, *, device=None, dtype=torch.float64, **kw):
    return _solve(make_problem(**kw), options or SolveOptions(), device=device, dtype=dtype)
