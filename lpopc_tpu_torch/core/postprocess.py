"""Solution post-processing: NLP vector -> OCP trajectories + costates.

Counterpart of the reference's ``Nlp2OpConverter``
(``Lpopc/src/Core/Nlp2OPConverter.cpp:13-223``): unpack the
converged NLP solution into per-phase time/state/control trajectories,
estimate costates from the Radau multiplier transformation, compute path
multipliers and the Hamiltonian, and evaluate the total cost.

Costate mapping (Radau pseudospectral transformation, re-derived; reference
``Nlp2OPConverter.cpp:79-87``): with defect rows ``D X - (tf-t0)/2 F`` and the
solver's Lagrangian convention ``L = f + λᵀc``, the continuous costates are

    λ(τ_k)  = -Λ_k / w_k            (collocation points)
    λ(τ_f)  = -D[:, -1]ᵀ Λ          (the non-collocated endpoint)

where ``Λ`` is the (N, nx) matrix of defect multipliers and ``w`` the LGR
weights. Path multipliers scale as ``-2 λ_path / ((tf - t0) w)``.

Everything here is host numpy except the user's dynamics and Lagrange
functions, which are torch functions evaluated with ``torch.func.vmap`` on
the solve's device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch.func import vmap

from ..utils.device import resolve_device
from .problem import Problem
from .transcribe import Layout, _scalar, _vector, unpack_phase


@dataclass
class PhaseSolution:
    """One phase's solution on its mesh.

    ``t_state``/``x`` live on the N+1 discretization points; ``t_col``/``u``/
    ``costate``/``hamiltonian`` on the N collocation points, plus ``costate_f``
    at the endpoint. All arrays are host numpy.
    """

    t_state: np.ndarray        # (N+1,)
    x: np.ndarray              # (N+1, nx)
    t_col: np.ndarray          # (N,)
    u: np.ndarray              # (N, nu)
    t0: float
    tf: float
    q: np.ndarray              # (nq,)
    costate: np.ndarray        # (N, nx)
    costate_f: np.ndarray      # (nx,)
    path_multipliers: np.ndarray  # (N, npath)
    hamiltonian: np.ndarray    # (N,)
    mesh_degrees: tuple = ()
    mesh_fractions: tuple = ()

    @property
    def u_full(self) -> np.ndarray:
        """Control extended to the endpoint by barycentric extrapolation of the
        FINAL segment's interpolant only (reference extrapolates by cubic
        spline, ``Nlp2OPConverter.cpp:61-72``). A global interpolant through
        all segments' collocation points would be a catastrophically
        ill-conditioned high-degree polynomial."""
        from ..ops.interp import barycentric_interpolate

        if self.u.shape[0] == 0 or self.u.shape[1] == 0:
            return np.zeros((self.t_state.shape[0], self.u.shape[1]))
        n_last = self.mesh_degrees[-1] if self.mesh_degrees else self.u.shape[0]
        uf = barycentric_interpolate(
            self.t_col[-n_last:], self.u[-n_last:], self.t_state[-1:]
        )
        return np.vstack([self.u, uf])


@dataclass
class Solution:
    """Full multi-phase solution + solver diagnostics."""

    phases: list
    objective: float
    status: int
    kkt_error: float
    iterations: int
    z: np.ndarray
    lam: np.ndarray
    mesh_history: list = field(default_factory=list)
    error_history: list = field(default_factory=list)
    grids: int = 1
    max_relative_error: float = np.nan
    # bound duals on [z; s] in ORIGINAL (unscaled) problem space, for
    # IPOPT-style warm starts across hp grids (None when not captured)
    zl_dual: Optional[np.ndarray] = None
    zu_dual: Optional[np.ndarray] = None
    # grid_tol_schedule="adaptive" only: the final full-tolerance polish
    # re-solve failed and this solution still carries the loose-tolerance
    # kkt_error (a warning is logged when this is set)
    polish_failed: bool = False
    # per-NLP-solve diagnostics (filled by solve_on_mesh)
    wall_s: float = float("nan")
    nlp_n: int = 0
    nlp_m: int = 0
    host_syncs: int = 0        # the IPM's host synchronizations (port only)
    # max INTER-NODE path/state-bound violation at the fine check points
    # (refine.estimate_path_violations — observability the reference lacks:
    # it never measures constraint excursions between collocation nodes)
    path_violation: float = float("nan")
    # per-grid rows (filled by the hp loop), one per NLP solve
    grid_stats: list = field(default_factory=list)

    @property
    def solved(self) -> bool:
        """NLP converged. Status 5 (mesh grid cap reached) is only ever set on
        top of a converged NLP, so it counts as solved; use
        :attr:`mesh_converged` to distinguish."""
        return self.status in (1, 5)

    @property
    def mesh_converged(self) -> bool:
        return self.status == 1


def _node_values(fn, k: int, X, U, t, q, *, device, dtype=torch.float64) -> np.ndarray:
    """A user node function ``fn(x, u, t, q)`` evaluated at every row of the
    host arrays ``X`` (N, nx), ``U`` (N, nu), ``t`` (N,), with ``vmap`` on
    ``device``; returns (N, k) numpy, or (N,) when ``k`` is None (scalar)."""
    T = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=device, dtype=dtype)
    x_, u_, t_, q_ = T(X), T(U), T(t), T(q)
    if k is None:
        one = lambda x, u, tt, qq: _scalar(fn(x, u, tt, qq), x)
    else:
        one = lambda x, u, tt, qq: _vector(fn(x, u, tt, qq), x, k)
    out = vmap(one, in_dims=(0, 0, 0, None))(x_, u_, t_, q_)
    return out.detach().cpu().numpy()


def extract_solution(
    problem: Problem,
    layout: Layout,
    ops: tuple,
    z: np.ndarray,
    lam: np.ndarray,
    objective: float,
    status: int,
    kkt_error: float,
    iterations: int,
    zl_dual: np.ndarray = None,
    zu_dual: np.ndarray = None,
    *,
    device=None,
    dtype=torch.float64,
) -> Solution:
    """Build a :class:`Solution` from converged NLP primal/dual vectors
    (host numpy). The dynamics and Lagrange terms of the Hamiltonian are
    evaluated on ``device`` (``None`` means ``"cuda"``)."""
    device = resolve_device(device)
    z = np.asarray(z)
    lam = np.asarray(lam)
    phases = []
    for ph, pl, op in zip(problem.phases, layout.phases, ops):
        X, U, t0, tf, q = unpack_phase(pl, z)
        X = np.array(X)
        U = np.array(U)
        t0 = float(t0)
        tf = float(tf)
        q = np.array(q)
        half = (tf - t0) / 2.0
        t_col = (np.asarray(op.tau) + 1.0) * half + t0
        t_state = (np.asarray(op.tau_state) + 1.0) * half + t0
        N, nx = pl.N, pl.nx
        Lam = lam[pl.con_offset : pl.con_offset + N * nx].reshape(N, nx)
        w = np.asarray(op.w)
        costate = -Lam / w[:, None]
        costate_f = -np.asarray(op.D)[:, -1] @ Lam
        if ph.npath > 0:
            lam_path = lam[
                pl.con_offset + N * nx : pl.con_offset + N * nx + N * ph.npath
            ].reshape(N, ph.npath)
            path_mult = -2.0 * lam_path / ((tf - t0) * w[:, None])
        else:
            path_mult = np.zeros((N, 0))
        # Hamiltonian H = L + lambda^T f at collocation points
        f_vals = _node_values(ph.dynamics, nx, X[:-1], U, t_col, q,
                              device=device, dtype=dtype).reshape(N, nx)
        if ph.lagrange is not None:
            L_vals = _node_values(ph.lagrange, None, X[:-1], U, t_col, q,
                                  device=device, dtype=dtype).reshape(N)
        else:
            L_vals = np.zeros(N)
        H = L_vals + np.sum(costate * f_vals, axis=1)
        phases.append(
            PhaseSolution(
                t_state=t_state, x=X, t_col=t_col, u=U, t0=t0, tf=tf, q=q,
                costate=costate, costate_f=costate_f,
                path_multipliers=path_mult, hamiltonian=H,
                mesh_degrees=tuple(ph.mesh_degrees),
                mesh_fractions=tuple(ph.mesh_fractions),
            )
        )
    return Solution(
        phases=phases, objective=float(objective), status=int(status),
        kkt_error=float(kkt_error), iterations=int(iterations),
        z=z, lam=lam, zl_dual=zl_dual, zu_dual=zu_dual,
    )


def warm_start_problem(problem: Problem, sol: Solution) -> Problem:
    """Write the solution back into the phase guesses (the reference's
    warm-start-across-meshes mechanism, ``Nlp2OPConverter.cpp:160-193``)."""
    new_phases = []
    for ph, psol in zip(problem.phases, sol.phases):
        uf = psol.u_full if ph.nu > 0 else None
        new_phases.append(
            ph.with_guess(psol.t_state, psol.x, uf, psol.q if ph.nq else None)
        )
    return dataclasses.replace(problem, phases=tuple(new_phases))
