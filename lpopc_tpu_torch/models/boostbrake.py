"""Boost–brake propulsion sizing: phases, a shared static parameter and
tabulated data in one benchmark.

A vehicle accelerates (phase 1, thrust q·u) then brakes (phase 2, decel B·u)
over a fixed distance L against quadratic drag, with the ENGINE SIZE q a
static parameter shared across both phases (equated by a parameter linkage)
and a mass-like penalty α·q in the objective:

    min  tf(2) + α q
    s.t. ṡ = v,  v̇ = q u − c_d(v)          (phase 1, u ∈ [0,1])
         ṡ = v,  v̇ = −B u − c_d(v)         (phase 2, u ∈ [0,1])
         s(0)=v(0)=0,  s(T)=L, v(T)=0,  state/q continuity at the interface

The time-optimal control is full throttle then full brake (drag is monotone;
the control enters affinely with no interior singular interval), so the phase
interface IS the switch point and the optimum trades trip time against
engine size through the single scalar q, which a shooting oracle verifies
independently (``tests/test_boostbrake.py``).

The ``tabulated=True`` variant replaces the closed-form drag with a C2
natural-spline table sampled from it (:class:`..ops.tables.Spline1D`),
pinning the table machinery inside a multi-phase, parameter-linked KKT
system.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.problem import Linkage, Phase, Problem
from ..core.solve import SolveOptions, solve as _solve
from ..ops.tables import Spline1D

C0 = 0.05      # parasitic drag
C1 = 0.12      # quadratic drag
BRAKE = 1.2    # max braking deceleration
ALPHA = 0.3    # engine-size penalty weight
L_TARGET = 6.0
V_MAX = 5.0


def drag(v):
    return C0 + C1 * v * v


def drag_table(n=33) -> Spline1D:
    vs = np.linspace(0.0, V_MAX, n)
    return Spline1D.fit(vs, drag(vs))


def make_problem(tabulated=False, degrees=(8,), fractions=None) -> Problem:
    if fractions is None:
        fractions = tuple(np.linspace(-1.0, 1.0, len(degrees) + 1))
    cd = drag_table() if tabulated else None

    def _drag(v):
        return cd(v) if tabulated else drag(v)

    def dyn_boost(x, u, t, q):
        return torch.stack([x[1], q[0] * u[0] - _drag(x[1])])

    def dyn_brake(x, u, t, q):
        return torch.stack([x[1], -BRAKE * u[0] - _drag(x[1])])

    guess_t1 = np.array([0.0, 3.0])
    guess_t2 = np.array([3.0, 6.0])
    common = dict(
        nx=2, nu=1, nq=1,
        x_bounds=(np.array([0.0, 0.0]), np.array([L_TARGET, V_MAX])),
        u_bounds=(0.0, 1.0),
        q_bounds=(0.5, 5.0),
        guess_q=np.array([2.0]),
        mesh_degrees=tuple(degrees),
        mesh_fractions=tuple(fractions),
    )
    boost = Phase(
        dynamics=dyn_boost,
        x0_bounds=(np.zeros(2), np.zeros(2)),
        t0_bounds=(0.0, 0.0), tf_bounds=(0.5, 10.0),
        guess_t=guess_t1,
        guess_x=np.array([[0.0, 0.0], [3.0, 2.0]]),
        guess_u=np.array([[1.0], [1.0]]),
        name="boost", **common,
    )
    brake = Phase(
        dynamics=dyn_brake,
        xf_bounds=(np.array([L_TARGET, 0.0]), np.array([L_TARGET, 0.0])),
        # objective: trip time + engine-size penalty
        mayer=lambda x0, t0, xf, tf, q: tf + ALPHA * q[0],
        t0_bounds=(0.5, 10.0), tf_bounds=(1.0, 20.0),
        guess_t=guess_t2,
        guess_x=np.array([[3.0, 2.0], [L_TARGET, 0.0]]),
        guess_u=np.array([[1.0], [1.0]]),
        name="brake", **common,
    )
    links = (
        Linkage(  # state continuity AND the shared engine parameter q
            left=0, right=1, nlink=3,
            fn=lambda xf, ql, x0, qr: torch.cat([xf - x0, ql - qr]),
        ),
    )
    return Problem(phases=(boost, brake), linkages=links,
                   name="boost-brake-sizing")


def solve(options: SolveOptions = None, *, device=None, dtype=torch.float64, **kw):
    return _solve(make_problem(**kw), options or SolveOptions(), device=device, dtype=dtype)
