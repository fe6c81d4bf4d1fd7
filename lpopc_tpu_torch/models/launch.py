"""Multi-phase launch-vehicle ascent to GTO (reference example #3).

Delta III ascent, 4 phases with phase-linkage constraints (capability match
for the reference's ``Lpopc/example/launch/Launch.cpp``; problem physics in
``doc/LpopcDoc.tex:1334-1420``; originally Benson's 2005 GPOPS thesis):
7 states (ECI position r, velocity v, mass m), 3 controls (thrust direction),
path constraint |u|² = 1 per phase, terminal orbit constraints, and 3
linkage constraints with jettisoned-mass offsets.

Design decisions (vs the reference):

* The terminal orbit (a, e, i, Ω, ω with ν free) is imposed through the
  **angular-momentum and eccentricity vectors** — 5 full-rank polynomial
  equations in (r, v) — instead of the reference's ``rv2oe`` angle
  extraction (``Launch.cpp:549-630``), whose acos/quadrant corrections have
  branch cuts that break AD. Mathematically equivalent: (h⃗, e⃗) ↔ the five
  elements with true anomaly free.
* Nondimensionalization (length Re, velocity sqrt(mu/Re), mass m0) is built
  into the model, like the reference's hand-scaling (``Launch.cpp:23-48``).
* The constant vectors of the terminal event and of the linkages are made
  from the argument (``new_tensor``), so one problem runs on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.lgr import uniform_fractions
from ..core.problem import Linkage, Phase, Problem
from ..core.solve import SolveOptions, solve as _solve

# ----- physical data (SI) -----
MU = 3.986012e14
RE = 6378145.0
G0 = 9.80665
OMEGA_E = 7.29211585e-5
RHO0 = 1.225
H_SCALE = 7200.0
CD = 0.5
S_AREA = 4.0 * np.pi

# Delta III stages
SRB_TOTAL, SRB_PROP, SRB_THRUST, SRB_BURN = 19290.0, 17010.0, 628500.0, 75.2
S1_TOTAL, S1_PROP, S1_THRUST, S1_BURN = 104380.0, 95550.0, 1083100.0, 261.0
S2_TOTAL, S2_PROP, S2_THRUST, S2_BURN = 19300.0, 16820.0, 110094.0, 700.0
PAYLOAD = 4164.0

# target GTO
A_T = 24361140.0
E_T = 0.7308
INC_T = np.deg2rad(28.5)
RAAN_T = np.deg2rad(269.8)
AOP_T = np.deg2rad(130.5)

LAT0 = np.deg2rad(28.5)

# nondimensional units
LU = RE
VU = np.sqrt(MU / RE)
TU = LU / VU
MUN = 1.0  # mu in nondimensional units


def _rot_z(c):
    return np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])


def _rot_x(c):
    return np.array([[1, 0, 0], [0, np.cos(c), -np.sin(c)], [0, np.sin(c), np.cos(c)]])


def target_vectors():
    """Nondimensional target angular-momentum and eccentricity vectors."""
    R = _rot_z(RAAN_T) @ _rot_x(INC_T) @ _rot_z(AOP_T)
    p_hat, q_hat, h_hat = R[:, 0], R[:, 1], R[:, 2]
    p_orb = A_T * (1 - E_T**2)
    h_mag = np.sqrt(MU * p_orb) / (LU * VU)
    return h_mag * h_hat, E_T * p_hat, p_hat, q_hat, h_hat


def _phase_data():
    """Per-phase (duration, thrust, mdot, mass_start, mass_end, drop_after)."""
    srb_mdot = SRB_PROP / SRB_BURN
    s1_mdot = S1_PROP / S1_BURN
    s2_mdot = S2_PROP / S2_BURN
    m0 = 9 * SRB_TOTAL + S1_TOTAL + S2_TOTAL + PAYLOAD
    ph = []
    t_knots = [0.0, 75.2, 150.4, 261.0, 961.0]
    thrust = [6 * SRB_THRUST + S1_THRUST, 3 * SRB_THRUST + S1_THRUST, S1_THRUST, S2_THRUST]
    mdot = [6 * srb_mdot + s1_mdot, 3 * srb_mdot + s1_mdot, s1_mdot, s2_mdot]
    drops = [6 * (SRB_TOTAL - SRB_PROP), 3 * (SRB_TOTAL - SRB_PROP),
             S1_TOTAL - S1_PROP, 0.0]
    m = m0
    for i in range(4):
        dur = t_knots[i + 1] - t_knots[i]
        m_end = m - mdot[i] * dur
        ph.append(dict(t0=t_knots[i], tf=t_knots[i + 1], thrust=thrust[i],
                       mdot=mdot[i], m_start=m, m_end=m_end, drop=drops[i]))
        m = m_end - drops[i]
    return ph, m0


def _make_dynamics(thrust_nd, mdot_nd, m0):
    omega_nd = OMEGA_E * TU

    def dynamics(x, u, t, q):
        r = x[0:3]
        v = x[3:6]
        m = x[6]  # in units of m0
        rnorm = torch.sqrt(torch.sum(r**2) + 1e-12)
        grav = -MUN * r / rnorm**3
        # clamp below the surface so infeasible iterates cannot overflow the
        # exponential atmosphere (rho is exact for h >= 0, the feasible region)
        h = torch.clamp_min((rnorm - 1.0) * LU, 0.0)
        rho = RHO0 * torch.exp(-h / H_SCALE)
        omega_cross_r = torch.stack([-omega_nd * r[1], omega_nd * r[0], torch.zeros_like(r[0])])
        v_rel = v - omega_cross_r
        vrel_mag = torch.sqrt(torch.sum(v_rel**2) + 1e-12)
        # a_SI = -(rho/2)(CD S/m_kg)|v_rel|v_rel with v in VU units; converting
        # by TU^2/LU folds to a factor LU (VU^2 TU^2 = LU^2)
        a_drag = -(0.5 * rho * CD * S_AREA / (m * m0)) * vrel_mag * v_rel * LU
        a_thrust = thrust_nd * u / m
        return torch.cat([v, grav + a_thrust + a_drag, torch.full_like(v[:1], -mdot_nd)])

    return dynamics


def _np_dynamics(x, u, thrust_nd, mdot_nd, m0):
    """Numpy copy of the nondimensional dynamics for guess propagation."""
    r, v, m = x[0:3], x[3:6], x[6]
    omega_nd = OMEGA_E * TU
    rnorm = np.linalg.norm(r)
    grav = -MUN * r / rnorm**3
    v_rel = v - np.array([-omega_nd * r[1], omega_nd * r[0], 0.0])
    rho = RHO0 * np.exp(-max((rnorm - 1.0) * LU, 0.0) / H_SCALE)
    a_drag = -(0.5 * rho * CD * S_AREA / (m * m0)) * np.linalg.norm(v_rel) * v_rel * LU
    return np.concatenate([v, grav + thrust_nd * u / m + a_drag, [-mdot_nd]])


def _propagated_guess(ph_data, m0, tf4=924.0, knots=16):
    """Forward-propagate a gravity-turn control profile through all phases.

    A dynamically consistent guess (unlike straight-line interpolation, which
    drags the trajectory through the atmosphere at orbital speed and wrecks
    the first NLP iterations). Control: radial for the first seconds, blending
    into the inertial-velocity direction (gravity turn), biased eastward.
    """
    r0 = np.array([np.cos(LAT0), 0.0, np.sin(LAT0)])
    v0 = np.cross([0.0, 0.0, OMEGA_E * TU], r0)
    east = np.cross([0.0, 0.0, 1.0], r0)
    east /= np.linalg.norm(east)
    x = np.concatenate([r0, v0, [1.0]])
    guesses = []
    t_abs = 0.0
    for i, pd in enumerate(ph_data):
        thrust_nd = pd["thrust"] / m0 * TU**2 / LU
        mdot_nd = pd["mdot"] / m0 * TU
        t_end = (pd["tf"] if i < 3 else tf4)
        dur_nd = (t_end - pd["t0"]) / TU
        nstep = 300
        dt = dur_nd / nstep
        ts, xs, us = [], [], []
        for s in range(nstep + 1):
            t_now = t_abs + s * dt * TU  # seconds
            r, v = x[0:3], x[3:6]
            rhat = r / np.linalg.norm(r)
            blend = min(1.0, max(0.0, (t_now - 5.0) / 120.0))
            vdir = v / max(np.linalg.norm(v), 1e-6)
            u = (1 - blend) * rhat + blend * (0.15 * rhat + 0.85 * vdir + 0.2 * east)
            u /= np.linalg.norm(u)
            if s % (nstep // (knots - 1)) == 0 or s == nstep:
                ts.append(pd["t0"] / TU + s * dt)
                xs.append(x.copy())
                us.append(u.copy())
            if s < nstep:
                # RK4
                f = lambda y: _np_dynamics(y, u, thrust_nd, mdot_nd, m0)
                k1 = f(x); k2 = f(x + dt / 2 * k1)
                k3 = f(x + dt / 2 * k2); k4 = f(x + dt * k3)
                x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        t_abs = t_end
        guesses.append((np.array(ts), np.array(xs), np.array(us)))
        x = x.copy()
        x[6] -= pd["drop"] / m0  # jettison
    return guesses


def make_problem(degrees_per_phase=(5, 5, 5, 7), segs_per_phase=(2, 2, 2, 3)) -> Problem:
    ph_data, m0 = _phase_data()
    h_t, e_t, p_hat, q_hat, h_hat = target_vectors()
    prop_guess = _propagated_guess(ph_data, m0)

    # initial state (nondimensional): launch site at rest in ECEF
    r0 = np.array([np.cos(LAT0), 0.0, np.sin(LAT0)])
    v0 = np.cross([0.0, 0.0, OMEGA_E * TU], r0)

    # terminal guess: perigee of the target orbit
    rp = A_T * (1 - E_T) / LU
    r_f = rp * p_hat
    vp = np.sqrt(MUN * (2 / rp - LU / A_T))
    v_f = vp * np.cross(h_hat, p_hat)

    phases = []
    linkages = []
    for i, pd in enumerate(ph_data):
        thrust_nd = pd["thrust"] / m0 * TU**2 / LU  # accel thrust/m in nd units when m in M0 units
        mdot_nd = pd["mdot"] / m0 * TU
        dyn = _make_dynamics(thrust_nd, mdot_nd, m0)
        nseg = segs_per_phase[i]
        deg = degrees_per_phase[i]
        fr = uniform_fractions(nseg)
        dg = (deg,) * nseg
        m_lo = 0.01
        m_hi = 1.05
        # time bounds (nondimensional)
        t0b = (pd["t0"] / TU, pd["t0"] / TU)
        tfb = (pd["tf"] / TU, pd["tf"] / TU) if i < 3 else (500.0 / TU, 961.0 / TU)

        # dynamically consistent guess from the gravity-turn propagation
        g_t, g_x, g_u = prop_guess[i]

        event = None
        nevent = 0
        event_bounds = None
        if i == 3:
            def event(x0, t0, xf, tf, q, h_t=h_t, p_hat=p_hat, q_hat=q_hat, e_t_mag=E_T):
                r = xf[0:3]
                v = xf[3:6]
                hv = torch.linalg.cross(r, v)
                rnorm = torch.sqrt(torch.sum(r**2))
                ev = torch.linalg.cross(v, hv) / MUN - r / rnorm
                return torch.cat([
                    hv - xf.new_tensor(h_t),
                    torch.stack([torch.dot(ev, xf.new_tensor(p_hat)) - e_t_mag,
                                 torch.dot(ev, xf.new_tensor(q_hat))]),
                ])

            nevent = 5
            event_bounds = (np.zeros(5), np.zeros(5))

        phases.append(Phase(
            nx=7, nu=3, npath=1, nevent=nevent,
            dynamics=dyn,
            path=lambda x, u, t, q: torch.stack([torch.sum(u**2)]),
            path_bounds=(1.0, 1.0),
            event=event, event_bounds=event_bounds,
            mayer=(lambda x0, t0, xf, tf, q: -xf[6]) if i == 3 else None,
            x0_bounds=(np.concatenate([r0, v0, [1.0]]),
                       np.concatenate([r0, v0, [1.0]])) if i == 0 else None,
            x_bounds=(np.array([-2, -2, -2, -3, -3, -3, m_lo]),
                      np.array([2, 2, 2, 3, 3, 3, m_hi])),
            u_bounds=(-1.1, 1.1),
            t0_bounds=t0b, tf_bounds=tfb,
            guess_t=g_t, guess_x=g_x, guess_u=g_u,
            mesh_degrees=dg, mesh_fractions=fr,
            name=f"launch-phase-{i + 1}",
        ))
        if i < 3:
            drop_nd = pd["drop"] / m0

            offs = np.concatenate([np.zeros(6), [drop_nd]])

            def link_fn(xfl, ql, x0r, qr, offs=offs):
                return x0r - (xfl - xfl.new_tensor(offs))

            linkages.append(Linkage(left=i, right=i + 1, nlink=7, fn=link_fn))
    return Problem(phases=tuple(phases), linkages=tuple(linkages), name="launch")


def solve(options: SolveOptions = None, *, device=None, dtype=torch.float64, **kw):
    return _solve(make_problem(**kw), options or SolveOptions(mesh_method="ph", max_grid_num=6),
                  device=device, dtype=dtype)


def final_mass_kg(sol) -> float:
    _, m0 = _phase_data()
    return float(sol.phases[3].x[-1, 6] * m0)
