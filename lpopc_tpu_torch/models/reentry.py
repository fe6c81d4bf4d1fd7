"""Space-shuttle reentry: maximum-crossrange atmospheric entry (Betts 2010,
ch. 6.1; the classic hard pseudospectral benchmark beyond the reference's
shipped trio, ``Lpopc/example/``).

Six states — altitude h, longitude phi, latitude theta, speed v, flight-path
angle gamma, azimuth psi — and two controls (angle of attack alpha, bank
angle beta) over a free-time gliding entry from orbital speed to the TAEM
interface, maximizing final latitude (crossrange). Published optimum:
theta(tf) = 34.1412 deg (tf ~ 2008.6 s); with the 70 BTU/ft^2/s leading-edge
heating-rate path constraint active, theta(tf) = 30.63 deg.

Dynamics over a non-rotating spherical Earth, exponential atmosphere, and
the shuttle's alpha-quadratic aero polynomials (English units). States are
nondimensionalized by (1e5 ft, 1e4 ft/s, 100 s) so the NLP sees O(1)
variables — the same manual-scaling discipline as the reference's launch
example (`Launch.cpp:23-48`) rather than a reliance on autoscale.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.lgr import uniform_fractions
from ..core.problem import Phase, Problem
from ..core.solve import SolveOptions, solve as _solve

# physical data (English units, Betts 2010 table 6.1)
MU_E = 0.14076539e17     # ft^3/s^2
RE = 20902900.0          # ft
S_REF = 2690.0           # ft^2
RHO0 = 0.002378          # slug/ft^3
H_DENS = 23800.0         # ft density scale height
MASS = 203000.0 / 32.174  # slug
A0, A1 = -0.20704, 0.029244          # cL = a0 + a1*alpha_deg
B0, B1, B2 = 0.07854, -0.61592e-2, 0.621408e-3  # cD(alpha_deg)
C0, C1, C2, C3 = 1.0672181, -0.19213774e-1, 0.21286289e-3, -0.10117249e-5

# nondimensionalization
H_S = 1e5      # ft
V_S = 1e4      # ft/s
T_S = 100.0    # s
DEG = np.pi / 180.0

PUBLISHED_CROSSRANGE_DEG = 34.1412        # unconstrained
PUBLISHED_CROSSRANGE_HEAT_DEG = 30.63     # q_U = 70 BTU/ft^2/s


def _aero(h, v, alpha):
    """(lift_acc, drag_acc, heat_rate) at physical h [ft], v [ft/s]."""
    ad = alpha / DEG
    rho = RHO0 * torch.exp(-h / H_DENS)
    qbar_s = 0.5 * rho * v * v * S_REF / MASS
    lift = qbar_s * (A0 + A1 * ad)
    drag = qbar_s * (B0 + B1 * ad + B2 * ad * ad)
    q_r = 17700.0 * torch.sqrt(rho) * (1e-4 * v) ** 3.07
    q_a = C0 + C1 * ad + C2 * ad * ad + C3 * ad * ad * ad
    return lift, drag, q_a * q_r


def make_problem(heat_limit: float | None = None, degrees=(6,) * 8,
                 fractions=None) -> Problem:
    """``heat_limit`` (BTU/ft^2/s) switches on the leading-edge heating-rate
    path constraint (Betts uses 70)."""
    if fractions is None:
        fractions = uniform_fractions(len(degrees))
    scale = np.array([H_S, 1.0, 1.0, V_S, 1.0, 1.0])

    def rates(x, u):
        sc = x.new_tensor(scale)
        h, phi, theta, v, gam, psi = x * sc
        alpha, beta = u[0], u[1]
        r = RE + h
        g = MU_E / (r * r)
        lift, drag, heat = _aero(h, v, alpha)
        cg, sg = torch.cos(gam), torch.sin(gam)
        cp, sp = torch.cos(psi), torch.sin(psi)
        d = torch.stack([
            v * sg,
            v * cg * sp / (r * torch.cos(theta)),
            v * cg * cp / r,
            -drag - g * sg,
            lift * torch.cos(beta) / v + cg * (v / r - g / v),
            lift * torch.sin(beta) / (v * cg) + v * cg * sp * torch.tan(theta) / r,
        ])
        return d * T_S / sc, heat

    def dynamics(x, u, t, q):
        return rates(x, u)[0]

    kw = {}
    if heat_limit is not None:
        kw = dict(
            npath=1,
            path=lambda x, u, t, q: torch.stack([rates(x, u)[1]]),
            path_bounds=(0.0, float(heat_limit)),
        )

    x0 = np.array([2.6, 0.0, 0.0, 2.56, -1.0 * DEG, 90.0 * DEG])
    xf_lo = np.array([0.8, -np.pi, -70 * DEG, 0.25, -5.0 * DEG, -np.pi])
    xf_hi = np.array([0.8, np.pi, 70 * DEG, 0.25, -5.0 * DEG, np.pi])
    lo = np.array([0.0, -np.pi, -70 * DEG, 1e-2, -80 * DEG, -np.pi])
    hi = np.array([3.0, np.pi, 70 * DEG, 4.5, 80 * DEG, np.pi])
    # crude linear guess; the final latitude/azimuth reflect a northward turn
    xf_g = np.array([0.8, 0.3, 0.5, 0.25, -5.0 * DEG, 20.0 * DEG])

    phase = Phase(
        nx=6, nu=2,
        dynamics=dynamics,
        mayer=lambda x0_, t0, xf, tf, q: -xf[2],   # maximize latitude
        x0_bounds=(x0, x0),
        xf_bounds=(xf_lo, xf_hi),
        x_bounds=(lo, hi),
        u_bounds=(np.array([-90 * DEG, -90 * DEG]),
                  np.array([90 * DEG, 1 * DEG])),
        t0_bounds=(0.0, 0.0),
        tf_bounds=(5.0, 40.0),                     # 500-4000 s
        guess_t=np.array([0.0, 10.0, 20.0]),
        guess_x=np.stack([x0, 0.5 * (x0 + xf_g), xf_g]),
        guess_u=np.array([[17 * DEG, -10 * DEG],
                          [17 * DEG, -45 * DEG],
                          [17 * DEG, -60 * DEG]]),
        mesh_degrees=tuple(degrees),
        mesh_fractions=tuple(fractions),
        name="shuttle-reentry",
        **kw,
    )
    return Problem(phases=(phase,), name="shuttle-reentry")


def crossrange_deg(solution) -> float:
    """Final latitude in degrees (the maximized crossrange)."""
    return float(-solution.objective) / DEG


def solve(options: SolveOptions = None, *, device=None, dtype=torch.float64, **kw):
    return _solve(make_problem(**kw), options or SolveOptions(), device=device, dtype=dtype)
