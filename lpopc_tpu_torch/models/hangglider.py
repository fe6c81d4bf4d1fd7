"""Hang-glider range maximization in a thermal (Bulirsch et al. 1993;
Betts 2010 ch. 6.3) — the classic mesh-sensitivity benchmark beyond the
reference's shipped trio (``Lpopc/example/``).

A glider crossing a rising thermal: maximize final range x(tf) while
descending from 1000 m to 900 m with matched airspeed at both ends. The
thermal updraft u_a(x) = u_M (1-X) e^{-X}, X = (x/R - 2.5)^2, makes the
optimal lift-coefficient profile strongly non-smooth in the thermal core —
the mesh must concentrate there, which is exactly what hp refinement is
for. Published optimum: x(tf) = 1248.03 m (tf ~ 98.4 s).

States (x, y, vx, vy) scaled by (1000 m, 1000 m, 10 m/s, 10 m/s), time by
100 s; control is the lift coefficient c_L in [0, 1.4].
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.lgr import uniform_fractions
from ..core.problem import Phase, Problem
from ..core.solve import SolveOptions, solve as _solve

UM = 2.5          # m/s thermal strength
R = 100.0         # m thermal radius
C0 = 0.034        # parasitic drag
K_IND = 0.069662  # induced-drag factor
MASS = 100.0      # kg
S_W = 14.0        # m^2
RHO = 1.13        # kg/m^3
G = 9.80665

L_S = 1000.0      # m
V_S = 10.0        # m/s
T_S = 100.0       # s

PUBLISHED_RANGE_M = 1248.031


def make_problem(degrees=(6,) * 8, fractions=None) -> Problem:
    if fractions is None:
        fractions = uniform_fractions(len(degrees))
    scale = np.array([L_S, L_S, V_S, V_S])

    def dynamics(xs, u, t, q):
        sc = xs.new_tensor(scale)
        x, y, vx, vy = xs * sc
        cl = u[0]
        X = (x / R - 2.5) ** 2
        ua = UM * (1.0 - X) * torch.exp(-X)
        wy = vy - ua
        vr = torch.sqrt(vx * vx + wy * wy)
        cd = C0 + K_IND * cl * cl
        half_rho_s = 0.5 * RHO * S_W
        lift = half_rho_s * cl * vr * vr
        drag = half_rho_s * cd * vr * vr
        sin_e = wy / vr
        cos_e = vx / vr
        d = torch.stack([
            vx,
            vy,
            (-lift * sin_e - drag * cos_e) / MASS,
            (lift * cos_e - drag * sin_e) / MASS - G,
        ])
        return d * T_S / sc

    x0 = np.array([0.0, 1.0, 1.323, -0.1288])
    xf_lo = np.array([0.0, 0.9, 1.323, -0.1288])
    xf_hi = np.array([3.0, 0.9, 1.323, -0.1288])
    xg = np.array([1.25, 0.9, 1.323, -0.1288])

    phase = Phase(
        nx=4, nu=1,
        dynamics=dynamics,
        mayer=lambda x0_, t0, xf, tf, q: -xf[0],   # maximize range
        x0_bounds=(x0, x0),
        xf_bounds=(xf_lo, xf_hi),
        x_bounds=(np.array([0.0, 0.0, 0.1, -0.4]),
                  np.array([3.0, 1.1, 1.5, 0.4])),
        u_bounds=(0.0, 1.4),
        t0_bounds=(0.0, 0.0),
        tf_bounds=(0.1, 2.0),
        guess_t=np.array([0.0, 0.5, 1.0]),
        guess_x=np.stack([x0, 0.5 * (x0 + xg), xg]),
        guess_u=np.array([[1.0], [1.0], [1.0]]),
        mesh_degrees=tuple(degrees),
        mesh_fractions=tuple(fractions),
        name="hang-glider",
    )
    return Problem(phases=(phase,), name="hang-glider")


def range_m(solution) -> float:
    return float(-solution.objective) * L_S


def solve(options: SolveOptions = None, *, device=None, dtype=torch.float64, **kw):
    return _solve(make_problem(**kw), options or SolveOptions(), device=device, dtype=dtype)
