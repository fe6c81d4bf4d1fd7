"""Low-thrust orbit raising, long horizon (BASELINE.json config #4).

The classic continuous-thrust orbit-raising problem (Bryson & Ho 1975 /
Moyer–Pinkham): maximize the final orbit radius of a constant-thrust,
mass-depleting spacecraft over a fixed long horizon, ending in a circular
orbit. Canonical data (nondimensional): mu = 1, r(0) = 1 circular,
T = 0.1405, m0 = 1, |mdot| = 0.0749, tf = 3.32; published optimum
r(tf) ≈ 1.525.

States (r, vr, vt) in polar coordinates (the cyclic angle is dropped);
control is the thrust-direction unit vector (u_r, u_t) with the |u|² = 1
path constraint — high-degree Radau segments over the multi-revolution spiral
make this the large-dense-block stress case.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.problem import Phase, Problem
from ..core.solve import SolveOptions, solve as _solve
from ..ops.lgr import uniform_fractions

MU = 1.0
THRUST = 0.1405
M0 = 1.0
MDOT = 0.0749
TF = 3.32


def make_problem(tf: float = TF, degrees=(10,) * 4, fractions=None) -> Problem:
    if fractions is None:
        fractions = uniform_fractions(len(degrees))

    def dynamics(x, u, t, q):
        r, vr, vt = x[0], x[1], x[2]
        m = M0 - MDOT * t
        acc = THRUST / m
        return torch.stack([
            vr,
            vt * vt / r - MU / (r * r) + acc * u[0],
            -vr * vt / r + acc * u[1],
        ])

    phase = Phase(
        nx=3, nu=2, npath=1, nevent=1,
        dynamics=dynamics,
        mayer=lambda x0, t0, xf, tf_, q: -xf[0],
        path=lambda x, u, t, q: torch.stack([u[0] ** 2 + u[1] ** 2]),
        path_bounds=(1.0, 1.0),
        # terminal circular-orbit condition vt = sqrt(mu / r)
        event=lambda x0, t0, xf, tf_, q: torch.stack([xf[2] - torch.sqrt(MU / xf[0])]),
        event_bounds=(0.0, 0.0),
        x0_bounds=(np.array([1.0, 0.0, 1.0]), np.array([1.0, 0.0, 1.0])),
        xf_bounds=(np.array([1.0, 0.0, 0.1]), np.array([3.0, 0.0, 2.0])),
        x_bounds=(np.array([0.5, -1.0, 0.1]), np.array([3.0, 1.0, 2.0])),
        u_bounds=(-1.1, 1.1),
        t0_bounds=(0.0, 0.0),
        tf_bounds=(tf, tf),
        guess_t=np.array([0.0, tf / 2, tf]),
        guess_x=np.array([[1.0, 0.0, 1.0], [1.25, 0.1, 0.9], [1.525, 0.0, 0.81]]),
        guess_u=np.array([[0.0, 1.0], [0.5, 0.85], [0.0, 1.0]]),
        mesh_degrees=tuple(degrees),
        mesh_fractions=tuple(fractions),
        name="low-thrust-orbit-raising",
    )
    return Problem(phases=(phase,), name="low-thrust")


PUBLISHED_RF = 1.525


def solve(options: SolveOptions = None, *, device=None, dtype=torch.float64, **kw):
    return _solve(make_problem(**kw), options or SolveOptions(), device=device, dtype=dtype)
