"""Differentiating THROUGH a converged solve (implicit function theorem).

The reference cannot do this at all: IPOPT returns a point, and the only
sensitivity story in reference-class tooling is a separate package
(sIPOPT). Here the missing piece is the implicit-function-theorem VJP at the
solution — with it, an entire batched solve becomes a differentiable
building block: design optimization (∂traj*/∂design-bound), bilevel problems
(outer optimizer over inner OCPs), learning terminal costs, MPC policy
gradients.

Math. At a converged primal-dual point ``v* = (z, s, λ)`` the smoothed KKT
residual (bound duals eliminated on the central path at the FINAL barrier
value μ — the same O(μ)-accurate generalized derivative used by
sIPOPT/OptNet/diffcp) is

    R(v; zl, zu, cl, cu) = [ ∇f + Jᵀλ − μ/(z−zl) + μ/(zu−z)
                             −λ − μ/(s−cl) + μ/(cu−s)
                             c(z) − s ]                          = 0,

with fixed rows (equal bounds — the pin mechanism every instance sweep
uses) replaced by the exact pin equation ``w_i − (lo_i+hi_i)/2 = 0``.
Then ``dv*/db = −(∂R/∂v)⁻¹ ∂R/∂b`` and the VJP needs ONE adjoint solve
with ``(∂R/∂v)ᵀ`` plus one vjp of R in the bounds — both by
``torch.func`` (``jacfwd``, ``vjp``), batched over the instances with
``vmap``; the system is (n+2m)² once per solve, not per iteration, and is
solved densely with ``torch.linalg.solve``.

:class:`DifferentiableSolver` wraps a :class:`..parallel.batch.BatchSolver`
as a ``torch.autograd.Function``: the forward pass is the batched IPM run
(under ``torch.no_grad``: no graph goes through the IPM's host loop), the
backward pass the adjoint solve above.

Everything here operates in the solver's SCALED space (the space of
``BatchSolver.run`` inputs/outputs and ``perturb_x0``); unscale with
``bs.scaled`` as usual.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.func import grad, jacfwd, vjp, vmap

from .ipm import _INF_CUT

_FIXED_TOL = 1e-14


def make_kkt_residual(objective: Callable, constraints: Callable, n: int, m: int):
    """Smoothed-KKT residual ``R(v, zl, zu, cl, cu, mu) -> (n+2m,)`` for the
    scaled NLP (v = [z; s; lam]), one instance (``mu`` 0-d)."""
    grad_f = grad(objective)

    def residual(v, zl, zu, cl, cu, mu):
        z, s, lam = v[:n], v[n : n + m], v[n + m :]
        w = torch.cat([z, s])
        wl = torch.cat([zl, cl])
        wu = torch.cat([zu, cu])
        fixed = (wu - wl) <= _FIXED_TOL
        has_lo = (wl > -_INF_CUT) & ~fixed
        has_up = (wu < _INF_CUT) & ~fixed
        one, zero = torch.ones_like(w), torch.zeros_like(w)
        gl = torch.where(has_lo, w - wl, one)
        gu = torch.where(has_up, wu - w, one)
        mu_term = -torch.where(has_lo, mu / gl, zero) + torch.where(has_up, mu / gu, zero)
        c_val, vjp_c = vjp(constraints, z)
        r_z = grad_f(z) + vjp_c(lam)[0] + mu_term[:n]
        r_s = -lam + mu_term[n:]
        r_w = torch.where(fixed, w - 0.5 * (wl + wu), torch.cat([r_z, r_s]))
        r_c = c_val - s
        return torch.cat([r_w, r_c])

    return residual


def solution_vjp(
    objective: Callable,
    constraints: Callable,
    n: int,
    m: int,
):
    """Build ``vjp(v_star, bounds, mu, ybar) -> (zl_bar, zu_bar, cl_bar,
    cu_bar)`` — the IFT adjoint for ONE instance (``vmap`` for sweeps).

    ``ybar`` is the cotangent on ``v_star = [z; s; lam]`` (pad with zeros
    for outputs you don't differentiate).
    """
    residual = make_kkt_residual(objective, constraints, n, m)

    def inst_vjp(v_star, zl, zu, cl, cu, mu, ybar):
        M = jacfwd(residual)(v_star, zl, zu, cl, cu, mu)
        w = torch.linalg.solve(M.T, ybar)
        _, pull = vjp(
            lambda zl_, zu_, cl_, cu_: residual(v_star, zl_, zu_, cl_, cu_, mu),
            zl, zu, cl, cu,
        )
        return pull(-w)

    return inst_vjp


class _Solve(torch.autograd.Function):
    """``(z0, zl, zu, cl, cu) -> (z, s, lam, objective)`` through one batched
    IPM run, differentiable in the bounds by the IFT adjoint."""

    @staticmethod
    def forward(ctx, dsolver, z0, zl, zu, cl, cu):
        with torch.no_grad():
            res = dsolver.bs.run(z0, zl, zu, cl, cu)
        ctx.dsolver = dsolver
        ctx.save_for_backward(res.z, res.s, res.lam, zl, zu, cl, cu, res.mu)
        return res.z, res.s, res.lam, res.objective

    @staticmethod
    def backward(ctx, zbar, sbar, lambar, objbar):
        z, s, lam, zl, zu, cl, cu, mu = ctx.saved_tensors
        d = ctx.dsolver
        grad_obj = vmap(grad(d.objective))(z)
        # dJ/d(bounds) rides the z cotangent through ∇f(z*):
        # J(b) = f(z*(b)) ⇒ J̄ contributes objbar * ∇f(z*) to z̄.
        zbar = zbar + objbar[:, None] * grad_obj
        v_star = torch.cat([z, s, lam], dim=1)
        ybar = torch.cat([zbar, sbar, lambar], dim=1)
        zl_b, zu_b, cl_b, cu_b = vmap(d.inst_vjp)(v_star, zl, zu, cl, cu, mu, ybar)
        # the converged solution does not depend on the warm start
        return None, torch.zeros_like(z), zl_b, zu_b, cl_b, cu_b


class DifferentiableSolver:
    """A :class:`..parallel.batch.BatchSolver` wrapped as a differentiable
    function of its bound inputs.

    ``ds(z0, zl, zu, cl, cu) -> (z, s, lam, objective)`` supports
    ``torch.autograd.grad`` / ``.backward()`` with respect to ``zl, zu, cl,
    cu`` (the sweep parameters: pinned initial states, terminal targets,
    path-bound levels, pinned design parameters) for any functional of the
    four outputs. The forward pass is the batched IPM run; the backward pass
    is one batched KKT-adjoint solve at the solution (see module
    docstring). ``z0`` (the warm start) correctly receives a zero gradient —
    the converged solution does not depend on it. Arrays that are not
    tensors are moved to the solver's device and dtype.
    """

    def __init__(self, batch_solver):
        self.bs = bs = batch_solver
        self.objective = bs.scaled.objective
        self.inst_vjp = solution_vjp(bs.scaled.objective, bs.scaled.constraints, bs.n, bs.m)

    def _tensor(self, a):
        if isinstance(a, torch.Tensor):
            return a
        return torch.as_tensor(np.asarray(a), device=self.bs.device, dtype=self.bs.dtype)

    def __call__(self, z0, zl, zu, cl, cu):
        return _Solve.apply(self, *(self._tensor(a) for a in (z0, zl, zu, cl, cu)))


def make_differentiable_solver(problem, options=None, *, device=None, dtype=torch.float64,
                               **kw) -> DifferentiableSolver:
    """Convenience: transcribe + build + wrap (see
    :class:`DifferentiableSolver`); ``device=None`` means ``"cuda"``."""
    from ..parallel.batch import make_batch_solver
    from .solve import SolveOptions

    bs = make_batch_solver(problem, options or SolveOptions(), device=device, dtype=dtype, **kw)
    return DifferentiableSolver(bs)
