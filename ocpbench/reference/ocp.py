"""The plain reference: a one-phase optimal-control problem transcribed by
Radau collocation in plain PyTorch (float64, on the CPU), and the numbers
that judge an answer against it.

A problem is a module of its own beside this file (``<config>.py``): ``NX``,
``NU``, ``dynamics(x, u)``, ``lagrange(x, u)`` or ``None``,
``mayer(x0, xf, t0, tf)`` or ``None``, and ``BOUNDS``. The decision vector
is ``[X (N+1, nx) row-major, U (N, nu), t0, tf]``; the constraints are the
defects ``D X - (tf - t0)/2 F(X, U)`` at the N collocation points, row-major,
then the duration row ``tf - t0``. That is the layout of the answers the
program hands back, which is all this module reads of it.

A problem this one phase cannot state (several phases, path rows, events,
parameters) brings its own in its file, found by name, and the harness
takes them in place of the ones here:

- ``Transcription(problem, mesh)``: an object with ``n``, ``bounds(deltas,
  batch)`` and ``numbers(z, lam, objective, zl, zu, cl, cu)`` as below, for
  the traffic's ``mesh`` (or an hp answer's final ``{"phases": [...]}``);
- ``pinned(point, phase, states)``: the nominal values of pinned states;
- ``mesh_error(answer)``: the largest relative error of an hp answer.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import lgr

F64 = torch.float64
BIG = 1e19          # a bound beyond this is no bound


def uniform_fractions(segments: int) -> np.ndarray:
    return np.linspace(-1.0, 1.0, segments + 1)


def transcription(problem, mesh: dict):
    """The problem file's own ``Transcription`` of ``mesh``, else the one here."""
    return getattr(problem, "Transcription", Transcription)(problem, mesh)


def pinned(problem, point: str, phase: int, states) -> np.ndarray:
    """The nominal values of ``states``, pinned at ``point`` ("x0" or "xf")
    of ``phase``: the problem file's own ``pinned``, else its ``BOUNDS``."""
    if hasattr(problem, "pinned"):
        return np.asarray(problem.pinned(point, phase, states), float)
    if phase != 0:
        raise ValueError(f"a one-phase problem has no phase {phase}")
    lo, hi = (np.asarray(b, float).reshape(-1)[list(states)] for b in problem.BOUNDS[point])
    if not np.array_equal(lo, hi):
        raise ValueError(f"{point}{list(states)} is not pinned in the reference")
    return lo


def one_phase(mesh: dict) -> dict:
    """``mesh``, or the one phase of an hp answer's ``{"phases": [...]}``."""
    if "phases" not in mesh:
        return mesh
    if len(mesh["phases"]) != 1:
        raise ValueError("a problem of several phases brings its own Transcription")
    return mesh["phases"][0]


class Transcription:
    """The NLP of ``problem`` on ``mesh``: ``{"degrees": [...],
    "fractions": [...] or None}`` (phase tau on [-1, 1]; None: equal)."""

    def __init__(self, problem, mesh: dict):
        mesh = one_phase(mesh)
        self.p = problem
        self.degrees = tuple(int(d) for d in mesh["degrees"])
        fractions = mesh.get("fractions")
        f = uniform_fractions(len(self.degrees)) if fractions is None else fractions
        self.fractions = np.asarray(f, float)
        nx, nu = problem.NX, problem.NU
        N = sum(self.degrees)
        D = np.zeros((N, N + 1))
        w = np.zeros(N)
        off = 0
        for k, nk in enumerate(self.degrees):
            a, b = self.fractions[k], self.fractions[k + 1]
            _, wk, _, Dk = lgr.segment(nk)
            D[off:off + nk, off:off + nk + 1] = Dk * (2.0 / (b - a))
            w[off:off + nk] = wk * ((b - a) / 2.0)
            off += nk
        self.N, self.nx, self.nu = N, nx, nu
        self.n = (N + 1) * nx + N * nu + 2
        self.m = N * nx + 1
        self.D = torch.as_tensor(D, dtype=F64)
        self.w = torch.as_tensor(w, dtype=F64)
        # largest |D| in each row away from its own column (the diagonal)
        off_diag = np.abs(D)
        off_diag[np.arange(N), np.arange(N)] = 0.0
        self.D_off = torch.as_tensor(off_diag.max(axis=1), dtype=F64)
        self.D_diag = torch.as_tensor(D[np.arange(N), np.arange(N)].copy(), dtype=F64)

    # -- layout -------------------------------------------------------------
    def split(self, Z):
        N, nx, nu = self.N, self.nx, self.nu
        X = Z[:, : (N + 1) * nx].reshape(-1, N + 1, nx)
        o = (N + 1) * nx
        U = Z[:, o : o + N * nu].reshape(-1, N, nu)
        return X, U, Z[:, o + N * nu], Z[:, o + N * nu + 1]

    def row(self, point: str, state: int) -> int:
        """Index in z of the state ``state`` at ``point`` ("x0" or "xf")."""
        return (0 if point == "x0" else self.N * self.nx) + state

    def bounds(self, deltas, batch: int):
        """(zl, zu) of shape (batch, n) and (cl, cu) of shape (m,), with each
        perturbation ``(point, states, delta (batch, k))`` added to the pinned
        bounds of that point."""
        B, N, nx, nu = self.p.BOUNDS, self.N, self.nx, self.nu
        lo = np.empty(self.n)
        hi = np.empty(self.n)
        Xl = np.tile(np.asarray(B["x"][0], float), (N + 1, 1))
        Xh = np.tile(np.asarray(B["x"][1], float), (N + 1, 1))
        Xl[0], Xh[0] = B["x0"]
        Xl[-1], Xh[-1] = B["xf"]
        o = (N + 1) * nx
        lo[:o], hi[:o] = Xl.ravel(), Xh.ravel()
        lo[o : o + N * nu] = np.tile(np.asarray(B["u"][0], float), N)
        hi[o : o + N * nu] = np.tile(np.asarray(B["u"][1], float), N)
        lo[o + N * nu], hi[o + N * nu] = B["t0"]
        lo[o + N * nu + 1], hi[o + N * nu + 1] = B["tf"]
        zl = np.tile(lo, (batch, 1))
        zu = np.tile(hi, (batch, 1))
        for point, states, delta in deltas:
            for j, s in enumerate(states):
                r = self.row(point, s)
                if zl[0, r] != zu[0, r]:
                    raise ValueError(f"{point}[{s}] is not pinned: it cannot be moved")
                zl[:, r] += delta[:, j]
                zu[:, r] += delta[:, j]
        cl = np.zeros(self.m)
        cu = np.zeros(self.m)
        cl[-1], cu[-1] = B["duration"]
        return zl, zu, cl, cu

    # -- functions ----------------------------------------------------------
    def objective(self, Z):
        X, U, t0, tf = self.split(Z)
        J = torch.zeros(Z.shape[0], dtype=F64)
        if self.p.mayer is not None:
            J = J + self.p.mayer(X[:, 0], X[:, -1], t0, tf)
        if self.p.lagrange is not None:
            L = self.p.lagrange(X[:, :-1], U)
            J = J + (tf - t0) / 2.0 * (L * self.w).sum(-1)
        return J

    def constraints(self, Z):
        X, U, t0, tf = self.split(Z)
        F = self.p.dynamics(X[:, :-1], U)
        defects = torch.einsum("kl,blj->bkj", self.D, X) - ((tf - t0) / 2.0)[:, None, None] * F
        return torch.cat([defects.reshape(Z.shape[0], -1), (tf - t0)[:, None]], dim=1)

    def row_norms(self, Z):
        """(B, m): the largest |entry| of each constraint row's gradient."""
        X, U, t0, tf = self.split(Z)
        Bn = Z.shape[0]
        x = X[:, :-1].reshape(-1, self.nx)
        u = U.reshape(-1, self.nu)
        jx, ju = torch.func.vmap(torch.func.jacrev(self.p.dynamics, argnums=(0, 1)))(x, u)
        F = self.p.dynamics(x, u)
        h = ((tf - t0) / 2.0).repeat_interleave(self.N)[:, None, None]
        jx, ju = h * jx, h * ju                                   # (B*N, nx, nx|nu)
        eye = torch.eye(self.nx, dtype=torch.bool)
        diag = (self.D_diag.repeat(Bn)[:, None] - torch.diagonal(jx, dim1=1, dim2=2)).abs()
        cross = jx.abs().masked_fill(eye, 0.0).amax(-1)
        rows = torch.stack([
            self.D_off.repeat(Bn)[:, None].expand(-1, self.nx), diag, cross,
            ju.abs().amax(-1), F.abs() / 2.0,
        ]).amax(0).reshape(Bn, -1)
        return torch.cat([rows, torch.ones(Bn, 1, dtype=F64)], dim=1)

    # -- judging ------------------------------------------------------------
    def numbers(self, z, lam, objective, zl, zu, cl, cu, chunk: int = 2048):
        """Per instance, for answers (z, lam, objective) in the problem's own
        units: ``primal`` (the worst bound or constraint violation, each row
        over its gradient's largest entry), ``dual`` (the worst part of the
        Lagrangian's gradient that no bound multiplier of the right sign can
        take up, times the distance to that bound where it is under 1, over
        the objective gradient's largest entry; the same for the duration
        row's multiplier) and ``objective`` (the gap between the objective
        reported and the reference's, relative). NaN reads as infinite."""
        out = {k: [] for k in ("primal", "dual", "objective")}
        for s in range(0, z.shape[0], chunk):
            sl = slice(s, s + chunk)
            part = self._numbers(*(torch.as_tensor(np.asarray(a[sl]), dtype=F64)
                                   for a in (z, lam, objective, zl, zu)),
                                 torch.as_tensor(cl, dtype=F64), torch.as_tensor(cu, dtype=F64))
            for k in out:
                out[k].append(part[k])
        return {k: np.nan_to_num(np.concatenate(v), nan=np.inf) for k, v in out.items()}

    def _numbers(self, Z, Lam, obj, zl, zu, cl, cu):
        Zr = Z.clone().requires_grad_(True)
        J = self.objective(Zr)
        C = self.constraints(Zr)
        g, = torch.autograd.grad(J.sum(), Zr, retain_graph=True)
        jtl, = torch.autograd.grad((Lam * C).sum(), Zr)
        J, C = J.detach(), C.detach()
        r = g + jtl
        norm = torch.clamp(g.abs().amax(-1), min=1.0)
        # primal: bounds, then rows
        mag = torch.maximum(torch.where(zl > -BIG, zl.abs(), 0.0),
                            torch.where(zu < BIG, zu.abs(), 0.0))
        scale = torch.clamp(mag, min=1.0)
        vb = torch.clamp(torch.maximum(zl - Z, Z - zu), min=0.0) / scale
        vr = torch.clamp(torch.maximum(cl - C, C - cu), min=0.0) / self.row_norms(Z)
        primal = torch.maximum(vb.amax(-1), vr.amax(-1))
        # dual: r > 0 is taken up by a lower-bound multiplier, r < 0 by an upper one
        finite = torch.isfinite(zl) & torch.isfinite(zu)
        free = ~finite | ((zu - zl) > 1e-12 * torch.clamp(zl.abs(), min=1.0))
        gap = torch.where(r > 0, torch.where(zl > -BIG, Z - zl, math.inf),
                          torch.where(zu < BIG, zu - Z, math.inf))
        dz = torch.where(free, r.abs() * torch.clamp(gap, min=0.0, max=1.0), 0.0)
        # rows: lam < 0 holds the row at its lower bound, lam > 0 at its upper
        ineq = (cu - cl) > 0
        rgap = torch.where(Lam < 0, torch.where(cl > -BIG, C - cl, math.inf),
                           torch.where(cu < BIG, cu - C, math.inf))
        dc = torch.where(ineq, Lam.abs() * torch.clamp(rgap, min=0.0, max=1.0), 0.0)
        dual = torch.maximum(dz.amax(-1), dc.amax(-1)) / norm
        objective = (obj - J).abs() / torch.clamp(J.abs(), min=1.0)
        return {"primal": primal.numpy(), "dual": dual.numpy(), "objective": objective.numpy()}


def mesh_error(problem, answer: dict) -> float:
    """The largest relative discretization error of an hp ``answer``: the
    problem file's own ``mesh_error``, else that of its one phase."""
    if hasattr(problem, "mesh_error"):
        return float(problem.mesh_error(answer))
    ph = one_phase(answer)
    return phase_mesh_error(problem, ph["degrees"], ph["fractions"], ph["x"], ph["u"],
                            ph["t0"], ph["tf"])


def phase_mesh_error(problem, degrees, fractions, x, u, t0, tf) -> float:
    """The largest relative discretization error of one phase's answer (its
    state ``x`` (N+1, nx) and control ``u`` (N, nu) on the mesh): per
    segment of n points, the state and control interpolated to n + 1 LGR
    points, the dynamics there integrated from the segment's first state,
    against the state's own polynomial, over 1 + max |x| of each state."""
    x, u = np.asarray(x, float), np.asarray(u, float)
    x_scale = 1.0 + np.abs(x).max(axis=0)
    worst, off = 0.0, 0
    for k, nk in enumerate(degrees):
        a, b = fractions[k], fractions[k + 1]
        phase = lambda tau: a + (np.asarray(tau) + 1.0) * (b - a) / 2.0
        pts, _, sup, _ = lgr.segment(nk)
        fine = lgr.points_weights(nk + 1)[0]
        xs, us = x[off : off + nk + 1], u[off : off + nk]
        Xf = lgr.interp_matrix(phase(sup), phase(fine)) @ xs
        Uf = lgr.interp_matrix(phase(pts), phase(fine)) @ us
        F = problem.dynamics(torch.as_tensor(Xf), torch.as_tensor(Uf)).numpy()
        h = (tf - t0) / 2.0 * (b - a) / 2.0
        X_int = xs[0][None, :] + h * (lgr.integration_matrix(nk + 1) @ F)
        X_ref = lgr.interp_matrix(phase(sup), phase(np.append(fine[1:], 1.0))) @ xs
        worst = max(worst, float(np.max(np.abs(X_int - X_ref) / x_scale[None, :])))
        off += nk
    return worst
