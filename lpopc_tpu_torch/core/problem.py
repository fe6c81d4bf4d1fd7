"""Problem-definition API: phases, linkages, bounds, guesses, meshes.

Functional counterpart of the reference's ``Phase`` / ``Linkage`` /
``OptimalProblem`` / ``FunctionWrapper``
(``Lpopc/src/Core/LpOptimalProblem.hpp:17-326``,
``LpFunctionWrapper.h:50-69``): the same capability set — per-phase states,
controls, static parameters, 3-point state bounds (x0 / interior / xf),
control & parameter bounds, free/bounded initial and terminal times, optional
duration bounds, path and event (boundary) constraints, phase-linkage
constraints, user guesses, and the initial mesh — expressed as frozen
dataclasses of numpy bounds plus **pure per-node torch callables**.

Where the reference asks users to subclass ``FunctionWrapper`` with
N-nodes-at-a-time Armadillo matrices (and optionally hand-coded derivatives),
here users supply scalar-signature pure functions::

    dynamics(x, u, t, q) -> dx/dt          # shape (nx,)
    path(x, u, t, q)     -> path values    # shape (npath,)
    lagrange(x, u, t, q) -> running cost   # scalar
    mayer(x0, t0, xf, tf, q)  -> scalar
    event(x0, t0, xf, tf, q)  -> (nevent,)
    link(xf_left, q_left, x0_right, q_right) -> (nlink,)

The framework vmaps them over collocation nodes and differentiates them with
exact AD — replacing the reference's entire finite-difference / analytic /
derivative-checker triad (``LpFiniteDifferenceDerive``, ``LpAnalyticDerive``,
``LpANDeriveChecker``) with machine-accurate Jacobians and Hessians.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

INF = 1e20  # same "numerical infinity" convention as the reference solver stack


def _pair(name, lo, hi, n, allow_none=False):
    """Validate and broadcast a (lo, hi) bound pair to shape (n,)."""
    if lo is None and hi is None and allow_none:
        lo, hi = -INF, INF
    lo = np.broadcast_to(np.asarray(lo, dtype=np.float64), (n,)).copy()
    hi = np.broadcast_to(np.asarray(hi, dtype=np.float64), (n,)).copy()
    lo = np.where(np.isneginf(lo), -INF, lo)
    hi = np.where(np.isposinf(hi), INF, hi)
    if np.any(lo > hi):
        raise ValueError(f"{name}: lower bound exceeds upper bound")
    return lo, hi


@dataclass(frozen=True)
class Phase:
    """One phase of a multiple-phase optimal control problem.

    Bounds follow the reference's 3-point convention
    (``LpOptimalProblem.hpp:17-29``): separate bounds for the initial state,
    the interior ("during") states, and the final state.
    """

    nx: int
    nu: int = 0
    nq: int = 0
    npath: int = 0
    nevent: int = 0

    dynamics: Callable = None
    path: Optional[Callable] = None
    lagrange: Optional[Callable] = None
    mayer: Optional[Callable] = None
    event: Optional[Callable] = None

    # --- bounds ---
    x0_bounds: tuple = None
    x_bounds: tuple = None
    xf_bounds: tuple = None
    u_bounds: tuple = None
    q_bounds: tuple = None
    path_bounds: tuple = None
    event_bounds: tuple = None
    t0_bounds: tuple = (0.0, 0.0)
    tf_bounds: tuple = None
    duration_bounds: Optional[tuple] = None

    # --- guess (times in physical units; states/controls at guess times) ---
    guess_t: np.ndarray = None
    guess_x: np.ndarray = None
    guess_u: np.ndarray = None
    guess_q: np.ndarray = None

    # --- initial mesh (defaults mirror MeshRefiner::SetAndCheckMesh,
    #     LpMeshRefiner.cpp:47-52: single interval, moderate degree) ---
    mesh_fractions: tuple = (-1.0, 1.0)
    mesh_degrees: tuple = (10,)

    name: str = ""

    def __post_init__(self):
        if self.dynamics is None:
            raise ValueError("Phase.dynamics is required")
        n = self.nx
        object.__setattr__(self, "x_bounds", _pair("x_bounds", *self._b(self.x_bounds), n, True))
        xb = self.x_bounds
        x0 = self.x0_bounds if self.x0_bounds is not None else xb
        xf = self.xf_bounds if self.xf_bounds is not None else xb
        object.__setattr__(self, "x0_bounds", _pair("x0_bounds", *self._b(x0), n, True))
        object.__setattr__(self, "xf_bounds", _pair("xf_bounds", *self._b(xf), n, True))
        object.__setattr__(self, "u_bounds", _pair("u_bounds", *self._b(self.u_bounds), self.nu, True))
        object.__setattr__(self, "q_bounds", _pair("q_bounds", *self._b(self.q_bounds), self.nq, True))
        object.__setattr__(
            self, "path_bounds", _pair("path_bounds", *self._b(self.path_bounds), self.npath, True)
        )
        object.__setattr__(
            self, "event_bounds", _pair("event_bounds", *self._b(self.event_bounds), self.nevent, True)
        )
        t0 = _pair("t0_bounds", *self._b(self.t0_bounds), 1, True)
        tf = _pair("tf_bounds", *self._b(self.tf_bounds), 1, True)
        object.__setattr__(self, "t0_bounds", (float(t0[0][0]), float(t0[1][0])))
        object.__setattr__(self, "tf_bounds", (float(tf[0][0]), float(tf[1][0])))
        if self.duration_bounds is not None:
            d = _pair("duration_bounds", *self._b(self.duration_bounds), 1, False)
            object.__setattr__(self, "duration_bounds", (float(d[0][0]), float(d[1][0])))
        if self.npath > 0 and self.path is None:
            raise ValueError("npath > 0 requires a path function")
        if self.nevent > 0 and self.event is None:
            raise ValueError("nevent > 0 requires an event function")
        if len(self.mesh_fractions) != len(self.mesh_degrees) + 1:
            raise ValueError("len(mesh_fractions) must be len(mesh_degrees) + 1")
        # normalize / validate guess
        if self.guess_t is not None:
            gt = np.atleast_1d(np.asarray(self.guess_t, dtype=np.float64))
            gx = np.asarray(self.guess_x, dtype=np.float64).reshape(len(gt), self.nx)
            object.__setattr__(self, "guess_t", gt)
            object.__setattr__(self, "guess_x", gx)
            if self.nu > 0:
                if self.guess_u is None:
                    raise ValueError("guess_u required when nu > 0 and a guess is given")
                gu = np.asarray(self.guess_u, dtype=np.float64).reshape(len(gt), self.nu)
                object.__setattr__(self, "guess_u", gu)
        if self.nq > 0 and self.guess_q is not None:
            gq = np.asarray(self.guess_q, dtype=np.float64).reshape(self.nq)
            object.__setattr__(self, "guess_q", gq)

    @staticmethod
    def _b(b):
        if b is None:
            return None, None
        lo, hi = b
        return lo, hi

    def with_mesh(self, degrees: Sequence[int], fractions: Sequence[float]) -> "Phase":
        return dataclasses.replace(
            self, mesh_degrees=tuple(int(d) for d in degrees),
            mesh_fractions=tuple(float(f) for f in fractions),
        )

    def with_guess(self, t, x, u=None, q=None) -> "Phase":
        return dataclasses.replace(self, guess_t=t, guess_x=x, guess_u=u, guess_q=q)


@dataclass(frozen=True)
class Linkage:
    """Phase-linkage constraint between the end of ``left`` and start of ``right``.

    ``fn(xf_left, q_left, x0_right, q_right) -> (nlink,)`` with bounds
    ``(lo, hi)``; the transcription also adds the automatic time link
    ``t0_right - tf_left = 0``, matching the reference's linear
    constraint matrix (``LpBoundsChecker.cpp:265-346``,
    ``doc/LpopcDoc.tex:438``).
    """

    left: int
    right: int
    nlink: int
    fn: Callable = None
    bounds: tuple = None

    def __post_init__(self):
        if self.nlink > 0 and self.fn is None:
            raise ValueError("nlink > 0 requires a link function")
        b = self.bounds if self.bounds is not None else (0.0, 0.0)
        lo, hi = _pair("link bounds", b[0], b[1], self.nlink, True)
        object.__setattr__(self, "bounds", (lo, hi))


@dataclass(frozen=True)
class Problem:
    """A multiple-phase optimal control problem (reference: ``OptimalProblem``)."""

    phases: tuple
    linkages: tuple = ()
    name: str = "ocp"

    def __post_init__(self):
        object.__setattr__(self, "phases", tuple(self.phases))
        object.__setattr__(self, "linkages", tuple(self.linkages))
        for l in self.linkages:
            if not (0 <= l.left < len(self.phases)) or not (0 <= l.right < len(self.phases)):
                raise ValueError(f"linkage references unknown phase: {l.left}->{l.right}")

    @property
    def num_phases(self) -> int:
        return len(self.phases)

    def with_meshes(self, meshes) -> "Problem":
        """Return a copy with new per-phase (degrees, fractions) meshes."""
        new_phases = tuple(
            ph.with_mesh(d, f) for ph, (d, f) in zip(self.phases, meshes)
        )
        return dataclasses.replace(self, phases=new_phases)
