"""NLP transcription: OCP -> pure torch objective/constraint functions.

Replacement for the reference's ~5 kLoC of hand-built sparse machinery
(``LpBoundsChecker`` NLP layout, ``LpNLPWrapper`` constraint / objective /
Jacobian assembly, ``LpHessian`` FD Hessians — see
``Lpopc/src/Core/LpNLPWrapper.cpp:55-939`` and ``LpBoundsChecker.cpp:51-346``):
everything the reference computes is a pure function of the decision vector
``z``, so all derivatives come from exact AD (``torch.func.grad`` / ``jacfwd``
/ ``hessian``) instead of finite differences + hand-coded sparsity patterns.

The returned callables are SINGLE-INSTANCE functions on 1-D tensors; the
batched solver lifts them over the instance axis with ``torch.func.vmap``.

Variable layout (per phase, matching the reference's ordering of
states-then-controls-then-times-then-parameters, ``LpBoundsChecker.cpp:51-138``):

    z_phase = [ X.ravel()  (N+1, nx) row-major,
                U.ravel()  (N,  nu),
                t0, tf,
                q          (nq,) ]

Constraint layout:

    per phase : defects (N*nx), path (N*npath), events (nevent)
    global    : per-linkage link rows,
                per-phase duration rows  (tf - t0 in duration bounds),
                per-linkage time rows    (t0_right - tf_left = 0)

The last two groups reproduce the reference's automatic linear constraint
matrix (``LpBoundsChecker.cpp:265-346``). Defects use the composite LGR
differentiation matrix as a single dense matmul:
``D @ X - (tf-t0)/2 * f(X, U, t, q)`` (reference: ``LpNLPWrapper.cpp:111-122``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch
from torch.func import vmap

from ..ops.interp import cubic_spline_interpolate
from ..ops.lgr import SegmentOps, make_segment_ops
from ..utils.device import resolve_device
from .problem import INF, Phase, Problem


@dataclass(frozen=True)
class PhaseLayout:
    nx: int
    nu: int
    nq: int
    N: int          # collocation points
    npts: int       # state discretization points = N + 1
    npath: int
    nevent: int
    var_offset: int
    nvar: int
    con_offset: int
    ncon: int

    @property
    def x_slice(self):
        return slice(self.var_offset, self.var_offset + self.npts * self.nx)

    @property
    def u_slice(self):
        o = self.var_offset + self.npts * self.nx
        return slice(o, o + self.N * self.nu)

    @property
    def t0_index(self):
        return self.var_offset + self.npts * self.nx + self.N * self.nu

    @property
    def tf_index(self):
        return self.t0_index + 1

    @property
    def q_slice(self):
        return slice(self.tf_index + 1, self.tf_index + 1 + self.nq)


@dataclass(frozen=True)
class Layout:
    phases: tuple
    nvar: int
    ncon: int            # total rows incl. linkage + linear rows
    ncon_nl: int         # nonlinear rows (defects/path/events/links)
    link_offsets: tuple  # constraint offset of each linkage block
    linear_offset: int   # first linear row (durations then time links)


def make_layout(problem: Problem) -> Layout:
    phases = []
    var_off = 0
    con_off = 0
    for ph in problem.phases:
        N = int(sum(ph.mesh_degrees))
        npts = N + 1
        nvar = npts * ph.nx + N * ph.nu + 2 + ph.nq
        ncon = N * ph.nx + N * ph.npath + ph.nevent
        phases.append(
            PhaseLayout(
                nx=ph.nx, nu=ph.nu, nq=ph.nq, N=N, npts=npts,
                npath=ph.npath, nevent=ph.nevent,
                var_offset=var_off, nvar=nvar, con_offset=con_off, ncon=ncon,
            )
        )
        var_off += nvar
        con_off += ncon
    link_offsets = []
    for link in problem.linkages:
        link_offsets.append(con_off)
        con_off += link.nlink
    ncon_nl = con_off
    linear_offset = con_off
    con_off += len(problem.phases) + len(problem.linkages)  # durations + time links
    return Layout(
        phases=tuple(phases), nvar=var_off, ncon=con_off, ncon_nl=ncon_nl,
        link_offsets=tuple(link_offsets), linear_offset=linear_offset,
    )


def make_phase_ops(problem: Problem) -> tuple:
    return tuple(
        make_segment_ops(tuple(ph.mesh_degrees), tuple(ph.mesh_fractions))
        for ph in problem.phases
    )


def unpack_phase(pl: PhaseLayout, z):
    """Slice one phase's (X, U, t0, tf, q) out of the decision vector."""
    X = z[pl.x_slice].reshape(pl.npts, pl.nx)
    U = z[pl.u_slice].reshape(pl.N, pl.nu)
    t0 = z[pl.t0_index]
    tf = z[pl.tf_index]
    q = z[pl.q_slice]
    return X, U, t0, tf, q


def pack(layout: Layout, parts, *, device="cpu", dtype=torch.float64) -> torch.Tensor:
    """Inverse of unpack: parts is a list of (X, U, t0, tf, q) per phase."""
    t = lambda a: torch.as_tensor(a, device=device, dtype=dtype)
    segs = []
    for pl, (X, U, t0, tf, q) in zip(layout.phases, parts):
        segs += [
            t(X).reshape(-1),
            t(U).reshape(-1),
            t(t0).reshape(1),
            t(tf).reshape(1),
            t(q).reshape(-1),
        ]
    return torch.cat(segs) if segs else torch.zeros((0,), device=device, dtype=dtype)


def phase_times(ops: SegmentOps, t0, tf):
    """Physical times at collocation points and at state points (``t0``/``tf``
    are 0-d tensors; the result lives on their device)."""
    tau = torch.as_tensor(np.array(ops.tau), device=t0.device, dtype=t0.dtype)
    tau_s = torch.as_tensor(np.array(ops.tau_state), device=t0.device, dtype=t0.dtype)
    half = (tf - t0) / 2.0
    return (tau + 1.0) * half + t0, (tau_s + 1.0) * half + t0


def const_mesh(ops: Sequence[SegmentOps], *, device=None, dtype=torch.float64) -> tuple:
    """Per-phase (tau, tau_state, w, D) tuples as constant tensors on ``device``."""
    device = resolve_device(device)
    # np.array copies: the memoized operators are read-only numpy
    t = lambda a: torch.as_tensor(np.array(a), device=device, dtype=dtype)
    return tuple((t(op.tau), t(op.tau_state), t(op.w), t(op.D)) for op in ops)


def _scalar(val, like):
    """User-function output as a 0-d tensor of ``like``'s dtype/device."""
    return torch.as_tensor(val, dtype=like.dtype, device=like.device).reshape(())


def _vector(val, like, k):
    return torch.as_tensor(val, dtype=like.dtype, device=like.device).reshape(k)


def make_objective_mesh(problem: Problem, layout: Layout) -> Callable:
    """Mesh-parametric objective ``obj(z, mesh)``; ``mesh`` is a tuple of
    per-phase ``(tau, tau_state, w, D)`` tensors (see :func:`const_mesh`).

    Reference: ``LpNLPWrapper::GetObjFun`` (``LpNLPWrapper.cpp:863-939``) —
    the quadrature ``wᵀ L (tf-t0)/2`` done as one dot product per phase.
    """

    def objective(z, mesh):
        total = torch.zeros((), dtype=z.dtype, device=z.device)
        for ph, pl, (tau, _, w, _) in zip(problem.phases, layout.phases, mesh):
            X, U, t0, tf, q = unpack_phase(pl, z)
            if ph.mayer is not None:
                total = total + _scalar(ph.mayer(X[0], t0, X[-1], tf, q), z)
            if ph.lagrange is not None:
                t_c = (tau + 1.0) * (tf - t0) / 2.0 + t0
                L = vmap(
                    lambda x, u, t, q_: _scalar(ph.lagrange(x, u, t, q_), z),
                    in_dims=(0, 0, 0, None),
                )(X[:-1], U, t_c, q)
                total = total + (tf - t0) / 2.0 * torch.dot(w, L)
        return total

    return objective


def make_constraints_mesh(problem: Problem, layout: Layout) -> Callable:
    """Mesh-parametric constraint vector ``con(z, mesh)`` (defects, paths,
    events, links, linear rows); see :func:`make_objective_mesh`."""

    def constraints(z, mesh):
        rows = []
        ends = []  # (xf, tf, q) per phase for linkage rows
        starts = []
        for ph, pl, (tau, _, _, D) in zip(problem.phases, layout.phases, mesh):
            X, U, t0, tf, q = unpack_phase(pl, z)
            t_c = (tau + 1.0) * (tf - t0) / 2.0 + t0
            F = vmap(
                lambda x, u, t, q_: _vector(ph.dynamics(x, u, t, q_), z, pl.nx),
                in_dims=(0, 0, 0, None),
            )(X[:-1], U, t_c, q)
            defects = D @ X - (tf - t0) / 2.0 * F
            rows.append(defects.reshape(-1))
            if ph.npath > 0:
                P = vmap(
                    lambda x, u, t, q_: _vector(ph.path(x, u, t, q_), z, pl.npath),
                    in_dims=(0, 0, 0, None),
                )(X[:-1], U, t_c, q)
                rows.append(P.reshape(-1))
            if ph.nevent > 0:
                E = ph.event(X[0], t0, X[-1], tf, q)
                rows.append(_vector(E, z, pl.nevent))
            starts.append((X[0], t0, q))
            ends.append((X[-1], tf, q))
        for link in problem.linkages:
            xfl, tfl, ql = ends[link.left]
            x0r, t0r, qr = starts[link.right]
            if link.nlink > 0:
                rows.append(_vector(link.fn(xfl, ql, x0r, qr), z, link.nlink))
        # linear rows: durations, then automatic time links
        for pl in layout.phases:
            rows.append((z[pl.tf_index] - z[pl.t0_index]).reshape(1))
        for link in problem.linkages:
            t0r = z[layout.phases[link.right].t0_index]
            tfl = z[layout.phases[link.left].tf_index]
            rows.append((t0r - tfl).reshape(1))
        if not rows:
            return torch.zeros((0,), dtype=z.dtype, device=z.device)
        return torch.cat(rows)

    return constraints


def make_objective(
    problem: Problem, layout: Layout, ops: Sequence[SegmentOps],
    *, device=None, dtype=torch.float64,
) -> Callable:
    """Pure scalar objective on a fixed mesh (operators baked as constants)."""
    obj_m = make_objective_mesh(problem, layout)
    mesh = const_mesh(ops, device=device, dtype=dtype)
    return lambda z: obj_m(z, mesh)


def make_constraints(
    problem: Problem, layout: Layout, ops: Sequence[SegmentOps],
    *, device=None, dtype=torch.float64,
) -> Callable:
    """Pure constraint vector on a fixed mesh (operators baked as constants)."""
    con_m = make_constraints_mesh(problem, layout)
    mesh = const_mesh(ops, device=device, dtype=dtype)
    return lambda z: con_m(z, mesh)


def variable_bounds(problem: Problem, layout: Layout) -> tuple[np.ndarray, np.ndarray]:
    """(zl, zu) with the 3-point state convention (``LpBoundsChecker.cpp:51-138``)."""
    lo = np.empty(layout.nvar)
    hi = np.empty(layout.nvar)
    for ph, pl in zip(problem.phases, layout.phases):
        Xlo = np.tile(ph.x_bounds[0], (pl.npts, 1))
        Xhi = np.tile(ph.x_bounds[1], (pl.npts, 1))
        Xlo[0], Xhi[0] = ph.x0_bounds
        Xlo[-1], Xhi[-1] = ph.xf_bounds
        lo[pl.x_slice] = Xlo.reshape(-1)
        hi[pl.x_slice] = Xhi.reshape(-1)
        lo[pl.u_slice] = np.tile(ph.u_bounds[0], pl.N)
        hi[pl.u_slice] = np.tile(ph.u_bounds[1], pl.N)
        lo[pl.t0_index], hi[pl.t0_index] = ph.t0_bounds
        lo[pl.tf_index], hi[pl.tf_index] = ph.tf_bounds
        lo[pl.q_slice], hi[pl.q_slice] = ph.q_bounds
    return lo, hi


def constraint_bounds(problem: Problem, layout: Layout) -> tuple[np.ndarray, np.ndarray]:
    lo = np.zeros(layout.ncon)
    hi = np.zeros(layout.ncon)
    for ph, pl in zip(problem.phases, layout.phases):
        off = pl.con_offset + pl.N * pl.nx  # defects stay [0, 0]
        if ph.npath > 0:
            lo[off : off + pl.N * ph.npath] = np.tile(ph.path_bounds[0], pl.N)
            hi[off : off + pl.N * ph.npath] = np.tile(ph.path_bounds[1], pl.N)
            off += pl.N * ph.npath
        if ph.nevent > 0:
            lo[off : off + ph.nevent] = ph.event_bounds[0]
            hi[off : off + ph.nevent] = ph.event_bounds[1]
    for link, loff in zip(problem.linkages, layout.link_offsets):
        lo[loff : loff + link.nlink] = link.bounds[0]
        hi[loff : loff + link.nlink] = link.bounds[1]
    off = layout.linear_offset
    for ph in problem.phases:
        if ph.duration_bounds is not None:
            lo[off], hi[off] = ph.duration_bounds
        else:
            lo[off], hi[off] = 0.0, INF  # tf >= t0, reference's default row
        off += 1
    for _ in problem.linkages:
        lo[off], hi[off] = 0.0, 0.0  # t0_right == tf_left
        off += 1
    return lo, hi


def _finite_mid(lo, hi):
    import warnings

    lo = np.where(lo <= -INF, np.nan, lo)
    hi = np.where(hi >= INF, np.nan, hi)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-infinite bounds
        mid = np.nanmean(np.stack([lo, hi]), axis=0)
    return np.where(np.isnan(mid), 0.0, mid)


def initial_guess(problem: Problem, layout: Layout, ops: Sequence[SegmentOps]) -> np.ndarray:
    """Build z0: interpolate user guesses onto the LGR grid with cubic splines
    (reference: ``LpGuessChecker.cpp:161-294``), or synthesize a linear
    state / constant control guess from the bounds when none is given.
    """
    z0 = np.zeros(layout.nvar)
    for ph, pl, op in zip(problem.phases, layout.phases, ops):
        if ph.guess_t is not None:
            t0g, tfg = float(ph.guess_t[0]), float(ph.guess_t[-1])
        else:
            t0g = float(_finite_mid(np.array([ph.t0_bounds[0]]), np.array([ph.t0_bounds[1]]))[0])
            tfg = float(_finite_mid(np.array([ph.tf_bounds[0]]), np.array([ph.tf_bounds[1]]))[0])
            if tfg <= t0g:
                tfg = t0g + 1.0
        t_state = (np.asarray(op.tau_state) + 1.0) * (tfg - t0g) / 2.0 + t0g
        t_col = t_state[:-1]
        if ph.guess_t is not None:
            # Clamp spline values to the componentwise range of the source
            # data: cubic overshoot through sharp layers would otherwise hand
            # stiff dynamics (e.g. the hypersensitive -x^3) a poisoned warm
            # start after mesh refinement.
            X = cubic_spline_interpolate(ph.guess_t, ph.guess_x, t_state)
            X = np.clip(X, ph.guess_x.min(axis=0), ph.guess_x.max(axis=0))
            if ph.nu > 0:
                U = cubic_spline_interpolate(ph.guess_t, ph.guess_u, t_col)
                U = np.clip(U, ph.guess_u.min(axis=0), ph.guess_u.max(axis=0))
            else:
                U = np.zeros((pl.N, 0))
        else:
            x_start = _finite_mid(*ph.x0_bounds)
            x_end = _finite_mid(*ph.xf_bounds)
            frac = (t_state - t0g) / max(tfg - t0g, 1e-12)
            X = x_start[None, :] + frac[:, None] * (x_end - x_start)[None, :]
            U = np.tile(_finite_mid(*ph.u_bounds), (pl.N, 1))
        z0[pl.x_slice] = X.reshape(-1)
        z0[pl.u_slice] = U.reshape(-1)
        z0[pl.t0_index] = t0g
        z0[pl.tf_index] = tfg
        if ph.nq > 0:
            z0[pl.q_slice] = (
                ph.guess_q if ph.guess_q is not None else _finite_mid(*ph.q_bounds)
            )
    return z0


@dataclass(frozen=True)
class NLP:
    """A transcribed NLP: pure functions + bounds + guess.

    ``objective(z) -> scalar`` and ``constraints(z) -> (ncon,)`` are pure
    single-instance torch functions (``torch.func`` vmap/grad-able) whose
    mesh constants live on ``device``. Bounds are host numpy (they become
    runtime inputs of the IPM so that instance sweeps can batch over them).
    """

    objective: Callable
    constraints: Callable
    zl: np.ndarray
    zu: np.ndarray
    cl: np.ndarray
    cu: np.ndarray
    z0: np.ndarray
    layout: Layout
    ops: tuple
    problem: Problem
    device: object = None
    dtype: object = torch.float64

    @property
    def n(self) -> int:
        return self.layout.nvar

    @property
    def m(self) -> int:
        return self.layout.ncon


def transcribe(problem: Problem, *, device=None, dtype=torch.float64) -> NLP:
    """Full transcription of ``problem`` on its current per-phase meshes.

    ``device=None`` means ``"cuda"`` (and raises without one); the mesh
    constants of the returned callables live there."""
    device = resolve_device(device)
    layout = make_layout(problem)
    ops = make_phase_ops(problem)
    zl, zu = variable_bounds(problem, layout)
    cl, cu = constraint_bounds(problem, layout)
    z0 = initial_guess(problem, layout, ops)
    return NLP(
        objective=make_objective(problem, layout, ops, device=device, dtype=dtype),
        constraints=make_constraints(problem, layout, ops, device=device, dtype=dtype),
        zl=zl, zu=zu, cl=cl, cu=cu, z0=z0,
        layout=layout, ops=ops, problem=problem, device=device, dtype=dtype,
    )
