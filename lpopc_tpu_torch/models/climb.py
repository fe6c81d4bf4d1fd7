"""Minimum-time climb with TABULATED atmosphere + thrust deck.

The Bryson minimum-time-to-climb class (the classic GPOPS-style benchmark):
a point-mass aircraft climbs from low/slow to high/fast in minimum time,
with the air density and the thrust deck supplied as TABLES in the dynamics
— the capability real trajectory shops need (flight-test decks are tables,
not formulas) and the one the reference library never exercised (its three
examples are closed-form).

    min tf
    ḣ = v sin γ
    v̇ = (T(h, M) − D)/m − g sin γ,   M = v/a₀
    γ̇ = L/(m v) − (g/v) cos γ
    L = ½ ρ(h) v² S C_L,  D = ½ ρ(h) v² S (C_D0 + k C_L²)

Control: lift coefficient C_L. ρ(h) is a 1-D table (:class:`..ops.tables.
Spline1D`), T(h, M) a 2-D deck (:class:`..ops.tables.Spline2D`).

Validation strategy (honest by construction): the tables are SAMPLED from
smooth closed-form models, and the same problem is solved with the
closed-form functions directly — the tabulated solve must agree with the
analytic solve to interpolation accuracy (``tests/test_climb.py``). This
pins the table machinery end-to-end (values, AD gradients, AD Hessians
through the spline inside the IPM) without fabricating a third-party data
deck.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.problem import Phase, Problem
from ..core.solve import SolveOptions, solve as _solve
from ..ops.lgr import uniform_fractions
from ..ops.tables import Spline1D, Spline2D

# point-mass aircraft (fighter-class thrust/weight ~ 1.3)
G0 = 9.80665          # m/s^2
MASS = 15000.0        # kg
SREF = 50.0           # m^2
CD0 = 0.02
K_IND = 0.05          # induced-drag factor
T0 = 2.0e5            # N, sea-level static reference
A0 = 320.0            # m/s, speed of sound (constant for the deck's M axis)
RHO0 = 1.225          # kg/m^3
H_SCALE = 8500.0      # m, density scale height

H_MAX = 12000.0
V_MIN, V_MAX = 110.0, 400.0

H0, V0 = 0.0, 150.0
HF, VF = 10000.0, 250.0


def rho_analytic(h):
    return RHO0 * torch.exp(-h / H_SCALE)


def thrust_analytic(h, mach):
    """Smooth thrust deck: altitude lapse ~ rho^0.7, mild transonic shaping."""
    lapse = (rho_analytic(h) / RHO0) ** 0.7
    return T0 * lapse * (1.0 - 0.25 * (mach - 0.6) ** 2)


def make_tables(n_h: int = 25, n_m: int = 15):
    """Sample the closed-form models onto spline tables (the 'data deck')."""
    hk = np.linspace(0.0, H_MAX, n_h)
    rho_t = Spline1D.fit(hk, rho_analytic(torch.as_tensor(hk)).numpy())
    hk2 = np.linspace(0.0, H_MAX, n_h)
    mk = np.linspace(0.05, 1.4, n_m)
    deck = thrust_analytic(torch.as_tensor(hk2)[:, None], torch.as_tensor(mk)[None, :]).numpy()
    thrust_t = Spline2D.fit(hk2, mk, deck)
    return rho_t, thrust_t


def make_problem(
    tabulated: bool = True,
    degrees=(7, 7, 7, 7),
    fractions=None,
    n_h: int = 25,
    n_m: int = 15,
) -> Problem:
    if fractions is None:
        fractions = uniform_fractions(len(degrees))
    if tabulated:
        rho_t, thrust_t = make_tables(n_h=n_h, n_m=n_m)
        rho = lambda h: rho_t(h)
        thrust = lambda h, mach: thrust_t(h, mach)
    else:
        rho, thrust = rho_analytic, thrust_analytic

    def dynamics(x, u, t, q):
        h, v, gam = x[0], x[1], x[2]
        cl = u[0]
        r = rho(h)
        qd = 0.5 * r * v * v * SREF
        lift = qd * cl
        drag = qd * (CD0 + K_IND * cl * cl)
        T = thrust(h, v / A0)
        sg, cg = torch.sin(gam), torch.cos(gam)
        return torch.stack([
            v * sg,
            (T - drag) / MASS - G0 * sg,
            lift / (MASS * v) - (G0 / v) * cg,
        ])

    # energy-climb-flavoured guess: accelerate, pull up, climb, push over
    gt = np.linspace(0.0, 80.0, 9)
    gx = np.stack([
        np.linspace(H0, HF, 9),
        np.interp(gt, [0, 20, 60, 80], [V0, 260.0, 280.0, VF]),
        np.interp(gt, [0, 10, 60, 80], [0.0, 0.35, 0.3, 0.0]),
    ], axis=1)
    gu = np.full((9, 1), 0.25)

    phase = Phase(
        nx=3, nu=1,
        dynamics=dynamics,
        mayer=lambda x0, t0, xf, tf, q: tf,
        x0_bounds=(np.array([H0, V0, 0.0]), np.array([H0, V0, 0.0])),
        xf_bounds=(np.array([HF, VF, 0.0]), np.array([HF, VF, 0.0])),
        x_bounds=(np.array([0.0, V_MIN, -0.6]), np.array([H_MAX, V_MAX, 1.2])),
        u_bounds=(0.0, 1.4),
        t0_bounds=(0.0, 0.0),
        tf_bounds=(20.0, 300.0),
        guess_t=gt, guess_x=gx, guess_u=gu,
        mesh_degrees=tuple(degrees),
        mesh_fractions=tuple(fractions),
        name="min-time-climb" + ("-tab" if tabulated else "-analytic"),
    )
    return Problem(phases=(phase,), name=phase.name)


def solve(options: SolveOptions = None, *, device=None, dtype=torch.float64, **kw):
    return _solve(make_problem(**kw), options or SolveOptions(), device=device, dtype=dtype)
