"""Batched primal-dual interior-point NLP solver (the IPOPT replacement).

The reference C++ library hands its transcribed NLP to IPOPT + MUMPS
(``Lpopc/src/Core/LpLpopcIpopt.cpp``, ``LpNLPSolver.cpp``) — a single-threaded
CPU interior-point method with sparse LDLᵀ factorization. This module is the
PyTorch counterpart of the JAX package's ``core/ipm.py`` and keeps its
algorithm, options and status codes:

* The KKT system is **condensed to a symmetric positive-definite matrix**
  ``K = H + Σ + δI + Jᵀ D J`` (slacks and bound duals eliminated
  analytically), factorized by dense Cholesky. The dual regularization
  ``δc`` makes the condensation exact for equality rows.
* Inertia correction is **factorization-driven**: a failed factorization or a
  DIVERGING iterative refinement triggers a primal regularization ``δw``
  increase.
* Formulation follows the standard primal-dual method with slacks on every
  constraint row, logarithmic barriers on finite bounds only, a
  fraction-to-boundary rule, a filter line search, the monotone / adaptive /
  probing / mehrotra / auto barrier strategies, and IPOPT-style dual
  safeguards.

**How the batch is carried.** The JAX package writes a single-instance solve
and batches it with ``vmap`` over ``lax.while_loop``. ``torch.func.vmap``
cannot trace data-dependent loops, so here ``solve`` is written with an
EXPLICIT LEADING BATCH DIMENSION: per-instance scalars are ``(B,)`` tensors,
vectors ``(B, k)``, matrices ``(B, r, c)``. The problem functions (objective,
constraints, gradient, Jacobian, Hessian) stay single-instance and are
lifted with ``torch.func.vmap``. The three data-dependent loops (outer
iteration, regularization, backtracking) are host loops that run while ANY
instance's own condition holds; an instance whose condition is false keeps
its whole carry through ``torch.where`` — exactly what ``vmap`` of a
``while_loop`` does — so every instance computes what it would compute
alone. Converged/failed instances freeze while the rest keep iterating, and
their (possibly NaN) values are selected away, never reduced into a live
instance: every reduction is along an instance's own axes. Each ``any()``
that steers a host loop is a host synchronization; ``solve.host_syncs``
counts them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
from torch.func import grad, hessian, jacfwd, vmap

from .problem import INF  # noqa: F401  (re-exported for callers' bounds)

# status codes
RUNNING = 0
SOLVED = 1
MAX_ITER = 2
FAILED = 3

_BIG = 1e20          # "infinite" Σ entry pinning fixed variables
_INF_CUT = 1e19      # bounds beyond this are treated as absent


@dataclass(frozen=True)
class IPMOptions:
    tol: float = 1e-8            # reference default Ipopt-tol is 1e-6
    max_iter: int = 200
    mu_init: float = 1e-1
    kappa_mu: float = 0.2        # linear mu decrease factor
    theta_mu: float = 1.5        # superlinear mu decrease exponent
    kappa_eps: float = 10.0      # barrier-problem tolerance = kappa_eps * mu
    tau_min: float = 0.99        # fraction-to-boundary
    kappa_1: float = 1e-2        # initial-point push-in
    s_max: float = 100.0         # residual scaling threshold
    kappa_sigma: float = 1e10    # dual safeguard
    delta_w0: float = 1e-4       # first nonzero primal regularization
    delta_w_max: float = 1e8     # cap on the boosted regularization start
    delta_w_stuck: float = 1e6   # boosted-delta level that triggers soft restoration
    mu_restore: float = 1e-2     # mu floor applied by the soft restoration
    # Dual (constraint) regularization. This is also the condensation penalty
    # for equality rows (d = 1/delta_c): kept moderate so cond(K) stays within
    # f64 range on stiff meshes; the full-KKT iterative refinement below
    # removes the O(delta_c) step perturbation (HyKKT / Golub-Greif gamma
    # strategy: gamma = 1/delta_c only needs to exceed ||S||).
    delta_c: float = 1e-6
    eta_phi: float = 1e-4        # Armijo constant
    gamma_theta: float = 1e-5    # filter margin on constraint violation
    gamma_phi: float = 1e-8     # filter margin on barrier objective
    s_theta: float = 1.1         # switching-condition exponents (IPOPT defaults)
    s_phi: float = 2.3
    delta_sw: float = 1.0        # switching-condition scale
    max_ls: int = 20             # max line-search halvings
    # Line-search evaluation: "parallel" evaluates ALL max_ls trial alphas
    # and takes the first acceptable one — identical semantics to the
    # sequential halving loop, but with no data-dependent loop (the batched
    # backtracking loop is LOCKSTEP: the whole batch waits for the instance
    # needing the most halvings). The filter accepts the first trial almost
    # always on well-centred sweeps, so the default stays sequential. Use
    # "parallel" for ragged sweeps where backtracking depth varies.
    ls_mode: str = "sequential"
    max_reg: int = 30            # max regularization increases per iteration
    max_refine: int = 1          # iterative-refinement rounds on the KKT step
    record_history: bool = False # per-iteration (kkt, mu, alpha, delta) trace
    lane_kkt: bool = False       # factor/solve with the hand-written batched CUDA kernels
    # Apply-mode factorization: for small condensed systems (n below this
    # threshold) the Cholesky factor's INVERSE is formed once per
    # factorization so that each KKT solve of the IPM iteration becomes one
    # or two batched matvecs instead of a sequential triangular solve.
    inverse_threshold: int = 600
    # Factorization precision: "f64" | "f32". f32 runs the Cholesky +
    # triangular math in single precision; the f64 iterative refinement
    # against the TRUE KKT system (below) restores full accuracy as long as
    # the equilibrated K's condition number stays below ~1/eps_f32, which
    # the symmetric Jacobi equilibration enforces in practice.
    factor_dtype: str = "f64"
    # Barrier strategy: "monotone" (Fiacco-McCormick, mu shrinks only when
    # the barrier subproblem is solved), "adaptive" (LOQO/Vanderbei
    # centrality rule: mu tracks sigma * mean complementarity each iteration —
    # reference parity with IPOPT's mu_strategy=adaptive, LpNLPSolver.cpp:28),
    # or "probing" (Mehrotra affine-scaling probe: per iteration, solve the
    # mu=0 predictor system WITH THE SAME factorization — one extra condensed
    # solve — measure how much complementarity
    # the pure Newton step could remove, and set mu = (mu_aff/mu)^3 * mu.
    # This is IPOPT's other adaptive oracle; it front-loads large mu cuts on
    # well-centred problems where the monotone schedule spends iterations
    # walking mu down one kappa_mu factor at a time), or "mehrotra"
    # (probing plus the second-order corrector: per-bound complementarity
    # targets mu - dg_aff*dz_aff, Gondzio-clipped to [0.1, 10] mu), or
    # "auto" (default): the mehrotra oracle behind a CENTRALITY GUARD — the
    # probe's aggressive mu is committed only while the filter line search
    # is accepting (near-)first trials; one deep backtrack and the next
    # iteration falls back to the monotone Fiacco-McCormick update, re-
    # entering mehrotra once the search is clean again. This keeps the
    # iteration-count win on well-centred problems without the line-search
    # tax mehrotra pays on hard geometry.
    mu_strategy: str = "auto"
    # Feasibility restoration (IPOPT-style, invoked on filter deadlock at an
    # infeasible iterate): Gauss-Newton minimize-||c|| iterations reusing the
    # same condensed-KKT factorization. False falls back to round-1's soft
    # re-centering only.
    restoration: bool = True
    resto_max_iter: int = 15
    # Second-order correction (IPOPT globalization, inherited by the
    # reference through OptimizeTNLP, LpNLPSolver.cpp:45): when the full
    # trial step is rejected WITH increased infeasibility, re-solve the same
    # Newton system (same factorization, same complementarity targets) with
    # the primal rhs replaced by c_soc = alpha * c_k + c(w + alpha dw) — a
    # curvature correction that rescues Maratos-type rejections without a
    # restoration episode. One correction round; sequential ls_mode only.
    # None = surface default: ON for single-problem solves (full IPOPT-
    # parity globalization), OFF in lockstep batch sweeps, where every
    # instance-iteration pays the SOC cost while the filter accepts first
    # trials essentially always; parallel.batch resolves None to False, everything
    # else to True. Set True/False to force. Sequential ls_mode only
    # (build_solver rejects an EXPLICIT soc=True with ls_mode="parallel").
    soc: "bool | None" = None
    # Watchdog (IPOPT's non-monotone heuristic, watchdog_shortened_iter_
    # trigger): after `watchdog_trigger` consecutive shortened/rejected
    # steps, save the iterate and FORCE full steps for up to
    # `watchdog_trial_iter` iterations; if none of them produces a
    # normally-acceptable first trial, restore the saved iterate and boost
    # the regularization. Complements restoration (which handles REJECTED-
    # step deadlocks): the watchdog attacks the accepted-but-crawling case.
    # Off by default — the filter + SOC + restoration trio covers the model
    # suite; this is the escape hatch for slow-crawl geometry.
    watchdog: bool = False
    watchdog_trigger: int = 10
    watchdog_trial_iter: int = 3


class IPMResult(NamedTuple):
    """Batched result: every field has a leading instance axis."""

    z: torch.Tensor
    s: torch.Tensor
    lam: torch.Tensor            # equality multipliers (constraint rows)
    zl_dual: torch.Tensor        # bound duals on [z; s], lower
    zu_dual: torch.Tensor
    status: torch.Tensor         # (B,) int32
    iterations: torch.Tensor     # (B,) int32
    objective: torch.Tensor
    kkt_error: torch.Tensor
    mu: torch.Tensor
    delta_w: torch.Tensor
    history: dict | None = None  # populated when options.record_history


def _masked_min(vals, mask):
    """Per-instance min over the last axis of the entries where ``mask``."""
    return torch.where(mask, vals, torch.full_like(vals, float("inf"))).amin(-1)


def _u(s):
    """(B,) per-instance scalar -> (B, 1), to broadcast against vectors."""
    return s[:, None]


def _mv(M, v):
    """Batched matvec: (B, r, c) @ (B, c) -> (B, r)."""
    return torch.bmm(M, v.unsqueeze(-1)).squeeze(-1)


def _mtv(M, u):
    """Batched transposed matvec: (B, r, c)ᵀ @ (B, r) -> (B, c)."""
    return torch.bmm(M.transpose(1, 2), u.unsqueeze(-1)).squeeze(-1)


def _sel(mask, new, old):
    """Per-instance select over a tree (tensor / tuple / named tuple / dict)
    of batched leaves: ``mask`` is (B,) and broadcasts over each leaf's
    trailing axes."""
    if isinstance(new, dict):
        return {k: _sel(mask, new[k], old[k]) for k in new}
    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*(_sel(mask, a, b) for a, b in zip(new, old)))
    if isinstance(new, (tuple, list)):
        return tuple(_sel(mask, a, b) for a, b in zip(new, old))
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


def _zeros_like_tree(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zeros_like_tree(t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return tuple(_zeros_like_tree(t) for t in tree)
    return torch.zeros_like(tree)


def _set_slot(arr, slot, val):
    """Per-row ``arr[b, slot[b]] = val[b]`` (out of place)."""
    return arr.scatter(1, slot[:, None], val[:, None].to(arr.dtype))


def build_solver(
    objective: Callable,
    constraints: Callable,
    n: int,
    m: int,
    options: IPMOptions = IPMOptions(),
    jac_fn: Callable | None = None,
    hess_fn: Callable | None = None,
    kkt_factorizer: tuple | None = None,
    takes_aux: bool = False,
    structured_kkt=None,
) -> Callable:
    """Return the batched ``solve(z0, zl, zu, cl, cu) -> IPMResult``.

    ``objective(z) -> scalar`` and ``constraints(z) -> (m,)`` are
    SINGLE-INSTANCE torch functions on 1-D tensors; ``solve`` takes arrays
    with a leading instance axis ``(B, ·)`` and lifts the problem functions
    with ``torch.func.vmap``. Bounds are runtime arguments so an instance
    sweep (perturbed initial conditions, terminal sets, pinned parameters)
    is just a batch of them. ``jac_fn(z) -> (m, n)`` and
    ``hess_fn(z, lam) -> (n, n)`` override the global-AD derivatives with
    structure-exploiting assembly (see :mod:`.structured`).

    The tensors decide where the solve runs: it follows ``z0.device``, and
    with ``lane_kkt=True`` on a CUDA device every factorization and KKT
    solve goes through the hand-written kernels of
    :mod:`..ops.batched_linalg` (also at B = 1).

    With ``takes_aux=True`` the problem callables take a trailing argument —
    ``objective(z, aux)``, ``constraints(z, aux)``, ``jac_fn(z, aux)``,
    ``hess_fn(z, lam, aux)`` — and ``solve`` takes ``aux``: one dict per call
    (the runtime-mesh hp solve passes the mesh fractions and scale vectors,
    ``core/solve.py``), shared by the whole batch and passed to the lifted
    functions un-batched. So one solver serves every mesh with the same
    degree signature.

    ``structured_kkt`` — a :class:`.kkt_blocks.BoundKKT` (or, with
    ``takes_aux``, a factory ``aux -> BoundKKT``) — goes fully matrix-free:
    J/H matvecs from per-node blocks and DIRECT per-segment assembly of the
    condensed KKT into (A, B, C) block form, no dense (m, n)/(n, n)
    intermediates (O(S·b²) memory); it overrides jac_fn/hess_fn/
    kkt_factorizer/lane_kkt. ``kkt_factorizer`` is an optional
    ``(factorize, solve, factor_ok)`` triple replacing the dense Cholesky on
    the (equilibrated) condensed K — e.g. the segment-block + border-Schur
    factorization of :mod:`.block_kkt`; it takes precedence over
    ``lane_kkt``.
    """
    opt = options
    if opt.ls_mode == "parallel" and (opt.soc is True or opt.watchdog):
        # both mechanisms live in the sequential search; failing loudly
        # beats a silently inert flag (soc=None resolving to on is fine to
        # drop — it is a surface default, not a user request)
        raise ValueError(
            "soc=True / watchdog=True require ls_mode='sequential' "
            "(the parallel trial evaluation has no first-rejection hook)")

    def _diag_ok(L):
        dL = torch.diagonal(L, dim1=-2, dim2=-1)
        return torch.isfinite(dL).all(-1) & (dL.amin(-1) > 0.0)

    if kkt_factorizer is not None:
        _factorize, _fsolve, _factor_ok = kkt_factorizer
    elif opt.lane_kkt:
        from ..ops.batched_linalg import lane_cho_solve, lane_cholesky

        _factorize = lane_cholesky
        _fsolve = lane_cho_solve
        _factor_ok = _diag_ok
    elif n <= opt.inverse_threshold:
        # apply mode: form L^{-1} and — in f64 — K^{-1} = L^{-T} L^{-1} (one
        # matmul) once per factorization, so every KKT solve of the IPM
        # iteration is a SINGLE batched matvec. In f32 the explicit inverse
        # is less reliable on the ill-conditioned endgame K's, so the f32
        # factorization keeps the two-triangular-matvec form.
        _one_matvec = opt.factor_dtype != "f32"

        def _factorize(K):
            from ..ops.blocked_chol import chol_and_inverse

            L, Linv = chol_and_inverse(K)
            return L, (Linv.transpose(1, 2) @ Linv if _one_matvec else Linv)

        def _fsolve(F, b):
            if _one_matvec:
                return _mv(F[1], b)
            return _mtv(F[1], _mv(F[1], b))

        def _factor_ok(F):
            return _diag_ok(F[0]) & torch.isfinite(F[1]).all(-1).all(-1)
    else:
        def _factorize(K):
            # the library factorization reports a non-PD matrix through
            # `info` where the reference's returns NaN: restore the NaN
            # contract so _factor_ok sees what it sees there (this is not
            # the inertia test — that stays the refinement-divergence probe)
            L, info = torch.linalg.cholesky_ex(K, check_errors=False)
            nan = torch.full((), float("nan"), dtype=L.dtype, device=L.device)
            return torch.where((info != 0)[:, None, None], nan, L)

        def _fsolve(L, b):
            return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)

        _factor_ok = _diag_ok

    # equilibrated, dtype-cast wrappers around the raw factorizer: solves are
    # against the ORIGINAL K (the Jacobi scaling E K E is internal), so all
    # call sites and the refinement logic are unchanged. Only Keq and the
    # right-hand side are cast; every other quantity stays in the working
    # dtype.
    _fdt = torch.float32 if opt.factor_dtype == "f32" else None

    def _eq_factorize(K):
        e = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(K, dim1=-2, dim2=-1).abs(), min=1e-12))
        Keq = K * (e[:, :, None] * e[:, None, :])
        if _fdt is not None:
            Keq = Keq.to(_fdt)
        return _factorize(Keq), e

    def _eq_solve(Fe, b):
        F, e = Fe
        rhs = e * b
        if _fdt is not None:
            x = _fsolve(F, rhs.to(_fdt)).to(b.dtype)
        else:
            x = _fsolve(F, rhs)
        return e * x

    def _eq_ok(Fe):
        return _factor_ok(Fe[0])

    def lift(objective, constraints, jac_fn, hess_fn):
        """The single-instance problem functions lifted over the batch axis:
        (grad, objective, constraints, Lagrangian Hessian, Jacobian)."""
        def lagrangian(z, lam):
            return objective(z) + torch.dot(lam, constraints(z))

        return (
            vmap(grad(objective)), vmap(objective), vmap(constraints),
            vmap(hess_fn if hess_fn is not None else hessian(lagrangian, argnums=0)),
            vmap(jac_fn if jac_fn is not None else jacfwd(constraints)),
        )

    if not takes_aux:
        lifted = lift(objective, constraints, jac_fn, hess_fn)

    def _any(t) -> bool:
        """``t.any()`` read on the host: one synchronization, counted."""
        solve.host_syncs += 1
        return bool(t.any())

    def solve(z0, zl, zu, cl, cu, lam0=None, aux=None, zl_d_init=None,
              zu_d_init=None, tol=None):
        # `tol` (optional, a float or a per-instance (B,) tensor) overrides
        # opt.tol for the CONVERGENCE TEST only — everything else keyed off
        # opt.tol (mu floor, theta_min) stays fixed.
        if takes_aux:
            grad_f, obj_b, con_b, hess_l, jac_c = lift(
                lambda z: objective(z, aux), lambda z: constraints(z, aux),
                None if jac_fn is None else (lambda z: jac_fn(z, aux)),
                None if hess_fn is None else (lambda z, lam: hess_fn(z, lam, aux)),
            )
        else:
            grad_f, obj_b, con_b, hess_l, jac_c = lifted
        sk = (
            structured_kkt(aux)
            if (structured_kkt is not None and takes_aux)
            else structured_kkt
        )
        use_sk = sk is not None
        dtype, dev = z0.dtype, z0.device
        B = z0.shape[0]
        sc = lambda v: torch.full((B,), float(v), dtype=dtype, device=dev)
        tol_eff = sc(opt.tol) if tol is None else (
            torch.as_tensor(tol, dtype=dtype, device=dev).expand(B)
        )
        wl = torch.cat([zl, cl], dim=1).to(dtype)
        wu = torch.cat([zu, cu], dim=1).to(dtype)
        fixed = (wu - wl) <= 1e-14
        has_lo = (wl > -_INF_CUT) & ~fixed
        has_up = (wu < _INF_CUT) & ~fixed
        fixed_z, fixed_s = fixed[:, :n], fixed[:, n:]
        one = torch.ones((), dtype=dtype, device=dev)
        zero = torch.zeros((), dtype=dtype, device=dev)

        def gaps(w):
            gl = torch.where(has_lo, w - wl, one)
            gu = torch.where(has_up, wu - w, one)
            return gl, gu

        def push_inside(v, lo, hi):
            # IPOPT-style strict interior push (kappa_1 = kappa_2 = 1e-2).
            span = hi - lo
            pl = torch.minimum(opt.kappa_1 * torch.clamp(lo.abs(), min=1.0), opt.kappa_1 * span)
            pu = torch.minimum(opt.kappa_1 * torch.clamp(hi.abs(), min=1.0), opt.kappa_1 * span)
            lo_eff = torch.where(lo > -_INF_CUT, lo + pl, lo)
            hi_eff = torch.where(hi < _INF_CUT, hi - pu, hi)
            return torch.minimum(
                torch.maximum(v, torch.minimum(lo_eff, hi_eff)),
                torch.maximum(lo_eff, hi_eff),
            )

        # ----- initialization -----
        z_init = torch.where(fixed_z, wl[:, :n], push_inside(z0.to(dtype), wl[:, :n], wu[:, :n]))
        c0 = con_b(z_init)
        s_init = torch.where(fixed_s, wl[:, n:], push_inside(c0, wl[:, n:], wu[:, n:]))
        w0 = torch.cat([z_init, s_init], dim=1)
        gl0, gu0 = gaps(w0)
        nb = (has_lo.sum(-1) + has_up.sum(-1)).to(dtype)        # (B,)
        nb1 = torch.clamp(nb, min=1.0)
        mu_min = sc(max(1e-13, opt.tol / 100.0))
        mu_init_t = sc(opt.mu_init)
        if zl_d_init is None:
            mu0 = mu_init_t
            zl_d0 = torch.where(has_lo, _u(mu0) / gl0, zero)
            zu_d0 = torch.where(has_up, _u(mu0) / gu0, zero)
        else:
            # Warm-started bound duals (IPOPT-style warm start across
            # solves): mu starts at the carried average complementarity
            # rather than mu_init, and the duals are kept up to the
            # kappa_sigma safeguard corridor around the new central path.
            zl_w = torch.where(has_lo, torch.clamp(zl_d_init.to(dtype), min=0.0), zero)
            zu_w = torch.where(has_up, torch.clamp(zu_d_init.to(dtype), min=0.0), zero)
            comp = (
                torch.where(has_lo, zl_w * gl0, zero).sum(-1)
                + torch.where(has_up, zu_w * gu0, zero).sum(-1)
            ) / nb1
            mu0 = torch.minimum(torch.maximum(comp, 10.0 * mu_min), mu_init_t)
            zl_d0 = torch.where(
                has_lo,
                torch.clamp(zl_w, min=_u(mu0) / (opt.kappa_sigma * gl0),
                            max=opt.kappa_sigma * _u(mu0) / gl0),
                zero,
            )
            zu_d0 = torch.where(
                has_up,
                torch.clamp(zu_w, min=_u(mu0) / (opt.kappa_sigma * gu0),
                            max=opt.kappa_sigma * _u(mu0) / gu0),
                zero,
            )
        lam0 = (
            torch.zeros((B, m), dtype=dtype, device=dev) if lam0 is None
            else lam0.to(dtype)
        )
        zeros_bm = torch.zeros((B, m), dtype=dtype, device=dev)

        def kkt_error_parts(w, lam, zl_d, zu_d):
            """Shared pieces of IPOPT's scaled optimality error E_mu (eq. 5).
            One gradient + Jacobian + constraint evaluation serves the barrier
            (E_mu) and outer (E_0) tests AND is carried into the next
            iteration's step (which needs exactly g/J/c at this point).
            The carried Jacobian is the dense (B, m, n) one, or the per-node
            block tree in structured-KKT mode."""
            z = w[:, :n]
            g_z = grad_f(z)
            if use_sk:
                J = sk.jac_blocks(z)
                jt = sk.jtv(J, lam)
            else:
                J = jac_c(z)
                jt = _mtv(J, lam)
            c_val = con_b(z)
            g = torch.cat([g_z, zeros_bm], dim=1)
            jt_lam = torch.cat([jt, -lam], dim=1)
            r_d = g + jt_lam - torch.where(has_lo, zl_d, zero) + torch.where(has_up, zu_d, zero)
            r_d = torch.where(fixed, zero, r_d)
            r_p = c_val - w[:, n:]
            gl, gu = gaps(w)
            comp_l = torch.where(has_lo, zl_d * gl, zero)
            comp_u = torch.where(has_up, zu_d * gu, zero)
            zsum = zl_d.abs().sum(-1) + zu_d.abs().sum(-1)
            dual_norm = lam.abs().sum(-1) + zsum
            denom = torch.clamp(m + nb, min=1.0)
            s_d = torch.clamp(dual_norm / denom, min=opt.s_max) / opt.s_max
            s_c = torch.clamp(zsum / nb1, min=opt.s_max) / opt.s_max
            e_d = r_d.abs().amax(-1) / s_d
            e_p = r_p.abs().amax(-1) if m > 0 else sc(0.0)
            return (e_d, e_p, comp_l, comp_u, s_c), (g_z, J, c_val)

        def error_from_parts(parts, mu):
            e_d, e_p, comp_l, comp_u, s_c = parts
            e_c = torch.maximum(
                torch.where(has_lo, comp_l - _u(mu), zero).abs().amax(-1),
                torch.where(has_up, comp_u - _u(mu), zero).abs().amax(-1),
            ) / s_c
            return torch.maximum(torch.maximum(e_d, e_p), e_c)

        def barrier_only(w_, mu):
            gl_, gu_ = gaps(w_)
            return -mu * (
                torch.where(has_lo, torch.log(gl_), zero).sum(-1)
                + torch.where(has_up, torch.log(gu_), zero).sum(-1)
            )

        def barrier_phi(w, mu):
            gl, gu = gaps(w)
            return (
                obj_b(w[:, :n])
                - mu * torch.where(has_lo, torch.log(gl), zero).sum(-1)
                - mu * torch.where(has_up, torch.log(gu), zero).sum(-1)
            )

        def theta(w):
            return (con_b(w[:, :n]) - w[:, n:]).abs().sum(-1)

        theta0_init = theta(w0)
        theta_min = 1e-4 * torch.clamp(theta0_init, min=1.0)
        theta_max = 1e4 * torch.clamp(theta0_init, min=1.0)
        n_filter = opt.max_iter + 1
        filter_slots = torch.arange(n_filter, device=dev)

        auto = opt.mu_strategy == "auto"
        corrector = auto or opt.mu_strategy == "mehrotra"
        probing = corrector or opt.mu_strategy == "probing"
        # watchdog is statically gated: default-off runs zero extra ops
        wd_on = opt.watchdog and opt.ls_mode != "parallel"
        use_soc = (
            (opt.soc if opt.soc is not None else True)
            and opt.ls_mode != "parallel" and m > 0
        )
        delta_c = opt.delta_c
        false_b = torch.zeros((B,), dtype=torch.bool, device=dev)
        izero = torch.zeros((B,), dtype=torch.int64, device=dev)

        # ----- one interior-point iteration (all instances in lockstep) -----
        def step(state, running):
            (w, lam, zl_d, zu_d, mu, delta_last, it, status, hist,
             f_theta, f_phi, f_count, delta_start, gjc, _e0_prev,
             ls_fails, resto_left, theta_entry, resto_strikes,
             mu_trust, wd_streak, wd_left, wd_bak) = state
            wd_active = (wd_left > 0) if wd_on else false_b
            in_resto = resto_left > 0
            z = w[:, :n]
            gl, gu = gaps(w)
            g_z, J, c_val = gjc  # carried from the previous convergence check
            if use_sk:
                Hop = sk.hess_blocks(z, lam)
                jv_ = lambda v: sk.jv(J, v)
                jtv_ = lambda u: sk.jtv(J, u)
                hv_ = lambda v: sk.hv(Hop, v)
            else:
                H = hess_l(z, lam)
                jv_ = lambda v: _mv(J, v)
                jtv_ = lambda u: _mtv(J, u)
                hv_ = lambda v: _mv(H, v)
            r_p = c_val - w[:, n:]

            sigma = torch.where(has_lo, zl_d / gl, zero) + torch.where(has_up, zu_d / gu, zero)
            sigma = torch.where(fixed, torch.full_like(sigma, _BIG), sigma)
            sigma_z, sigma_s = sigma[:, :n], sigma[:, n:]
            # Slack rows with no finite bound (a vacuous constraint row) have
            # sigma_s = 0, which would make the condensation divide by zero at
            # delta_w = 0 and force spurious regularization every iteration;
            # a tiny floor keeps the row inert (d ~ 1e-8 drops it from K)
            # while all divisions stay finite.
            free_s = (~has_lo[:, n:]) & (~has_up[:, n:]) & (~fixed_s)
            sigma_s = torch.where(free_s, torch.clamp(sigma_s, min=1e-8), sigma_s)

            # mu-perturbed dual residuals (a: z rows, b: s rows).
            # Feasibility-restoration mode: entered when the filter deadlocks
            # at an infeasible iterate (see the `stuck` logic below): the
            # objective gradient and Jᵀλ drop out of the dual residual, so
            # the Newton system below produces the barrier-safeguarded
            # generalized Gauss-Newton step for min ½‖c(z) − s‖² in the
            # W̃ = H + Σ + δI metric — a true minimize-‖c‖ subproblem REUSING
            # the same condensed KKT factorization (no second solver). The
            # line search then demands plain sufficient decrease of θ
            # instead of the filter test.
            jtv_lam = jtv_(lam)
            resto_z = _u(in_resto) & ~fixed_z
            resto_s = _u(in_resto) & ~fixed_s

            def dual_rhs(tl, tu):
                """(a, b) for per-bound complementarity targets tl/tu, given
                as (B, 1) (one mu per instance) or (B, n+m) (the Mehrotra
                corrector's per-bound targets)."""
                mt = -torch.where(has_lo, tl / gl, zero) + torch.where(has_up, tu / gu, zero)
                a_ = torch.where(fixed_z, zero, g_z + jtv_lam + mt[:, :n])
                b_ = torch.where(fixed_s, zero, -lam + mt[:, n:])
                a_ = torch.where(resto_z, mt[:, :n], a_)
                b_ = torch.where(resto_s, mt[:, n:], b_)
                return a_, b_, mt

            ones_b = torch.ones((B, n + m), dtype=dtype, device=dev)
            if not probing:
                a, b, mu_term = dual_rhs(_u(mu), _u(mu))

            def factor_at(delta_w):
                """Condensed-KKT factorization at this regularization level
                (a tree of tensors — carried through the reg loop so the
                accepted level's factorization survives for the SOC solve
                after the loop)."""
                sig_s = sigma_s + _u(delta_w)
                d = sig_s / (1.0 + delta_c * sig_s)
                wdiag = sigma_z + _u(delta_w)
                if use_sk:
                    return sk.factorize(J, Hop, d, wdiag)
                K = H + torch.diag_embed(wdiag) + (J.transpose(1, 2) * d[:, None, :]) @ J
                return (_eq_factorize(K), K)

            def solve_with(F, r):
                return sk.fsolve(F, r) if use_sk else _eq_solve(F[0], r)

            def make_step(delta_w):
                sig_s = sigma_s + _u(delta_w)                    # Ŝ
                d = sig_s / (1.0 + delta_c * sig_s)
                wdiag = sigma_z + _u(delta_w)
                F = factor_at(delta_w)
                solveK = lambda r: solve_with(F, r)
                if use_sk:
                    okF = sk.factor_ok(F)
                    kv = lambda v: hv_(v) + wdiag * v + jtv_(d * jv_(v))
                else:
                    okF = _eq_ok(F[0])
                    kv = lambda v: _mv(F[1], v)

                def finish(dz_, rb, rc):
                    """Back out (ds, dlam) from a condensed solution dz_."""
                    dlam_ = d * (jv_(dz_) - rc - rb / sig_s)
                    ds_ = (dlam_ + rb) / sig_s
                    return dz_, ds_, dlam_

                if probing:
                    # Mehrotra affine-scaling probe (IPOPT's mu-oracle
                    # "probing"): solve the mu=0 predictor system with the
                    # factorization just built (one extra condensed solve),
                    # take the fraction-to-boundary affine step lengths, and
                    # set sigma = (mu_aff/mu)^3. Centred iterates where the
                    # pure Newton step keeps the gaps open get sigma ~ 1
                    # (stay); iterates where it would slash complementarity
                    # get sigma ~ 0 (cut mu hard).
                    zero_mu = torch.zeros((B, 1), dtype=dtype, device=dev)
                    a0, b0, _ = dual_rhs(zero_mu, zero_mu)
                    rhs_a = -a0 - jtv_(d * (r_p + b0 / sig_s))
                    # f64: unrefined solve — the probe only steers mu, so
                    # the backward error of a single solve is plenty. f32
                    # factors need ONE refinement round: the unrefined f32
                    # probe direction is noise-dominated near the endgame.
                    dza0 = solveK(rhs_a)
                    if _fdt is not None:
                        dza0 = dza0 + solveK(rhs_a - kv(dza0))
                    dza, dsa, _dla = finish(dza0, -b0, -r_p)
                    dwa = torch.cat([dza, dsa], dim=1)
                    dzl_a = torch.where(has_lo, -zl_d - zl_d * dwa / gl, zero)
                    dzu_a = torch.where(has_up, -zu_d + zu_d * dwa / gu, zero)
                    tau_a = 0.995
                    ap = torch.clamp(torch.minimum(
                        _masked_min(-tau_a * gl / torch.clamp(dwa, max=-1e-300),
                                    has_lo & (dwa < 0)),
                        _masked_min(tau_a * gu / torch.clamp(dwa, min=1e-300),
                                    has_up & (dwa > 0)),
                    ), 0.0, 1.0)
                    ad = torch.clamp(torch.minimum(
                        _masked_min(-tau_a * zl_d / torch.clamp(dzl_a, max=-1e-300),
                                    has_lo & (dzl_a < 0)),
                        _masked_min(-tau_a * zu_d / torch.clamp(dzu_a, max=-1e-300),
                                    has_up & (dzu_a < 0)),
                    ), 0.0, 1.0)
                    comp0 = (
                        torch.where(has_lo, zl_d * gl, zero).sum(-1)
                        + torch.where(has_up, zu_d * gu, zero).sum(-1)
                    ) / nb1
                    comp_a = (
                        torch.where(
                            has_lo, (gl + _u(ap) * dwa) * (zl_d + _u(ad) * dzl_a), zero).sum(-1)
                        + torch.where(
                            has_up, (gu - _u(ap) * dwa) * (zu_d + _u(ad) * dzu_a), zero).sum(-1)
                    ) / nb1
                    sig_m = torch.clamp(
                        (torch.clamp(comp_a, min=0.0)
                         / torch.clamp(comp0, min=1e-300)) ** 3,
                        1e-4, 1.0,
                    )
                    mu_t = torch.minimum(torch.maximum(sig_m * comp0, mu_min), mu_init_t)
                    # a failed probe (non-finite affine step: factorization is
                    # being rejected this reg round anyway) or restoration
                    # mode (mu frozen) keeps the incoming mu
                    dwa_finite = torch.isfinite(dwa).all(-1)
                    mu_t = torch.where(in_resto | (nb == 0) | ~dwa_finite, mu, mu_t)
                    if auto:
                        # centrality guard: the probe's mu is committed only
                        # while the line search has been clean (mu_trust,
                        # updated each iteration from backtracking depth);
                        # otherwise this iteration targets the incoming mu
                        # and the monotone rule updates it afterwards.
                        mu_t = torch.where(mu_trust, mu_t, mu)
                    if corrector:
                        # Mehrotra second-order corrector: per-bound targets
                        # mu_t - dg_aff * dz_aff (the complementarity the
                        # affine step would leave behind), Gondzio-clipped to
                        # [0.1, 10] mu_t so outliers cannot hijack the step.
                        # Disabled while the probe is untrusted (same guard
                        # as mu_t above: non-finite affine direction, plus
                        # the auto strategy's centrality guard).
                        guard = in_resto | ~dwa_finite
                        if auto:
                            guard = guard | ~mu_trust
                        pl = torch.where(has_lo & ~_u(guard), dwa * dzl_a, zero)
                        pu = torch.where(has_up & ~_u(guard), -dwa * dzu_a, zero)
                        mt_ = _u(mu_t)
                        tl = torch.minimum(torch.maximum(mt_ - pl, 0.1 * mt_), 10.0 * mt_)
                        tu = torch.minimum(torch.maximum(mt_ - pu, 0.1 * mt_), 10.0 * mt_)
                    else:
                        tl = _u(mu_t) * ones_b
                        tu = _u(mu_t) * ones_b
                    aa, bb, _ = dual_rhs(tl, tu)
                else:
                    mu_t = mu
                    tl = _u(mu) * ones_b
                    tu = _u(mu) * ones_b
                    aa, bb = a, b

                def csolve(ra, rb, rc):
                    """Solve the delta_c-regularized Newton system
                    [W̃ Jᵀ; J -(Ŝ⁻¹+δc)]-style for a general rhs (ra, rb, rc):
                    W̃dz + Jᵀdλ = ra;  Ŝds - dλ = rb;  Jdz - ds - δc dλ = rc.
                    Used only for the CORRECTION step of the full-KKT
                    refinement, where the rhs is already a small residual:
                    in f64 one unrefined solve suffices; f32 factors keep one
                    inner refinement round to hold the step quality."""
                    rhs = ra + jtv_(d * (rc + rb / sig_s))
                    dz_ = solveK(rhs)
                    if _fdt is not None:
                        dz_ = dz_ + solveK(rhs - kv(dz_))
                    return finish(dz_, rb, rc)

                # Indefiniteness detection. A Cholesky can complete WITHOUT
                # NaNs on an indefinite matrix in floating point, silently
                # producing the factor of a different (PSD) matrix — so NaN
                # checks alone are not a valid inertia test. Instead exploit
                # iterative refinement: with M = LLᵀ the iteration contracts
                # iff ρ(I - M⁻¹K) < 1, which fails whenever K has meaningful
                # negative curvature (M PSD ⇒ some eigenvalue of M⁻¹K ≤ 0 ⇒
                # divergence). A growing refinement residual flags indefinite
                # K and triggers the δw regularization search. The SAME solve
                # chain is the main Newton step: its rhs0 is exactly the
                # csolve(-a, -b, -r_p) condensed rhs, so the twice-refined dz1
                # is both the inertia probe and the step (one shared chain —
                # 3 solves + 3 K-applies).
                rhs0 = -aa - jtv_(d * (r_p + bb / sig_s))
                dz0 = solveK(rhs0)
                kdz0 = kv(dz0)
                r0 = (rhs0 - kdz0).abs().amax(-1)
                dz1 = dz0 + solveK(rhs0 - kdz0)
                kdz1 = kv(dz1)
                r1 = (rhs0 - kdz1).abs().amax(-1)
                dz1 = dz1 + solveK(rhs0 - kdz1)
                # f64: the once-refined residual r1 is the divergence probe
                # (margins below are tuned for it). f32: its floor/growth
                # margins are tuned for the residual AFTER the second
                # refinement round, so f32 spends one extra K-apply to
                # measure post-round-2.
                r_end = r1 if _fdt is None else (rhs0 - kv(dz1)).abs().amax(-1)
                # Absolute floor: a backward-stable solve leaves a residual of
                # order eps * ||K|| ||dz|| (NOT eps * ||rhs||: the two differ by
                # the cancellation factor ||K|| ||dz|| / ||rhs||), and iterative
                # refinement stagnates there rather than contracting further.
                # Below that level the r_end/r0 ratio compares two noise
                # quantities and "growth" is meaningless — so the floor must
                # scale with max(||rhs||, ||K dz||). With f32 factors the noise
                # level is 2^-24-based and the contraction per round is coarser
                # (~cond(EKE) * 2^-24), so both margins widen.
                res_scale = 1.0 + torch.maximum(
                    rhs0.abs().amax(-1), kdz1.abs().amax(-1)
                )
                if _fdt is None:
                    floor = 1e-9 * res_scale
                    growth = 1.2
                else:
                    floor = 3e-5 * res_scale
                    growth = 3.0
                ok = (
                    okF
                    & torch.isfinite(dz1).all(-1)
                    & ((r_end <= growth * r0 + 1e-300) | (r_end <= floor))
                )

                dz, ds, dlam = finish(dz1, -bb, -r_p)
                # Full-KKT iterative refinement: correct the step against the
                # TRUE Newton system (no delta_c on the constraint row), using
                # the condensed factorization as the solver. Removes both the
                # penalty perturbation on equality rows and rounding error.
                # f32 factors need TWO rounds (one leaves the step at the f32
                # noise plateau and the barrier endgame stalls; a third
                # re-injects f32 noise).
                n_refine = (
                    max(1, opt.max_refine) if _fdt is None
                    else max(2, opt.max_refine)
                )
                for _ in range(n_refine):
                    e1 = -aa - (hv_(dz) + wdiag * dz + jtv_(dlam))
                    e1 = torch.where(fixed_z, zero, e1)
                    e2 = torch.where(fixed_s, zero, -bb - (sig_s * ds - dlam))
                    e3 = -r_p - (jv_(dz) - ds)
                    cz, cs, clam = csolve(e1, e2, e3)
                    dz = dz + cz
                    ds = ds + cs
                    dlam = dlam + clam
                ds = torch.where(fixed_s, zero, ds)
                dz = torch.where(fixed_z, zero, dz)
                return dz, ds, dlam, ok, (r0, r_end), mu_t, tl, tu, F

            # regularization loop: grow delta_w until the factorization
            # succeeds. Host loop over "any instance still searching"; an
            # instance whose own condition (~ok & k < max_reg) is false keeps
            # its whole carry. Frozen instances (not RUNNING) are left out of
            # the loop condition: their step is discarded anyway.
            k = izero
            delta_w = delta_start
            carry = None   # (dz, ds, dlam, ok, diag, mu_t, tl, tu, F)
            ok = false_b
            while True:
                active = (~ok) & (k < opt.max_reg) & running
                if carry is None:
                    if opt.max_reg <= 0:
                        break
                elif not _any(active):
                    break
                new = make_step(delta_w)
                next_delta = torch.where(
                    delta_w == 0.0,
                    torch.clamp(delta_last / 3.0, min=opt.delta_w0),
                    delta_w * 10.0,
                )
                if carry is None:
                    # first round: every instance's condition holds (k = 0,
                    # ok = False), so the body's output is the carry
                    carry = new
                    k = k + 1
                    delta_w = next_delta
                else:
                    carry = _sel(active, new, carry)
                    k = torch.where(active, k + 1, k)
                    delta_w = torch.where(active, next_delta, delta_w)
                ok = carry[3]
            if carry is None:   # max_reg = 0: the loop body never ran
                carry = (
                    torch.zeros((B, n), dtype=dtype, device=dev), zeros_bm, zeros_bm,
                    false_b, (sc(0.0), sc(0.0)), mu, _u(mu) * ones_b, _u(mu) * ones_b,
                    _zeros_like_tree(factor_at(delta_start)),
                )
            dz, ds, dlam, ok, reg_diag, mu_u, tl_u, tu_u, F_u = carry
            delta_next = delta_w
            # mu actually used in this iteration's step: the probe's choice
            # under "probing", the incoming mu otherwise (mu_t == mu there).
            # Every downstream mu-consistent quantity (dual directions,
            # fraction-to-boundary tau, barrier merit, safeguards) uses mu_u.
            if probing:
                mu_term = (
                    -torch.where(has_lo, _u(mu_u) / gl, zero)
                    + torch.where(has_up, _u(mu_u) / gu, zero)
                )
            delta_used = torch.where(k > 1, delta_next / 10.0, delta_start)

            dw = torch.cat([dz, ds], dim=1)

            # fraction-to-boundary (primal; the dual step lengths are
            # computed after the line search, once the final direction —
            # original or second-order-corrected — is known)
            tau = torch.clamp(1.0 - mu_u, min=opt.tau_min)

            def primal_alpha_max(dw_):
                al = _masked_min(-_u(tau) * gl / torch.clamp(dw_, max=-1e-300),
                                 has_lo & (dw_ < 0))
                au = _masked_min(_u(tau) * gu / torch.clamp(dw_, min=1e-300),
                                 has_up & (dw_ > 0))
                return torch.clamp(torch.minimum(al, au), 0.0, 1.0)

            alpha_max = primal_alpha_max(dw)

            # ----- filter line search (IPOPT-style, Waechter-Biegler) -----
            # Accept a trial if it improves feasibility theta or barrier phi
            # relative to the current point AND is not dominated by a filter
            # entry; near feasibility (switching condition) demand Armijo
            # decrease of phi. This is what lets steps through when an l1
            # merit function would reject everything (Maratos-type stalls).
            phi0 = barrier_phi(w, mu_u)
            # theta(w) = sum|c(z) - s| with c carried in gjc — no fresh
            # constraints evaluation (r_p above is exactly c_val - s)
            th0 = r_p.abs().sum(-1)

            # Restoration merit phi_R = 1/2||c - s||^2_D + barrier, with D the
            # condensation weights actually used in the step (d ~ 1/delta_c on
            # equality rows): this is the objective whose Gauss-Newton step
            # the restoration direction IS, so its Armijo test must use the
            # same weights — an unweighted theta test can be opposed by the
            # barrier pull-in near bounds and rejects legitimate steps.
            sig_used = sigma_s + _u(delta_used)
            d_used = sig_used / (1.0 + delta_c * sig_used)
            phi_r0 = 0.5 * (d_used * r_p * r_p).sum(-1) + barrier_only(w, mu_u)
            dphi_r = (d_used * r_p * (jv_(dz) - ds)).sum(-1) + (
                torch.where(fixed, zero, mu_term) * dw
            ).sum(-1)
            gl_safe = torch.where(has_lo, gl, one)
            gu_safe = torch.where(has_up, gu, one)
            grad_phi = (
                torch.cat([g_z, zeros_bm], dim=1)
                - torch.where(has_lo, _u(mu_u) / gl_safe, zero)
                + torch.where(has_up, _u(mu_u) / gu_safe, zero)
            )
            dphi = (torch.where(fixed, zero, grad_phi) * dw).sum(-1)
            filter_active = filter_slots[None, :] < f_count[:, None]

            def trial_eval(w_t, alpha_arm, dphi_arm):
                """Filter acceptance test at trial point ``w_t``. The Armijo
                and switching tests measure progress along slope ``dphi_arm``
                with step size ``alpha_arm`` — for normal trials that is the
                trial's own (alpha, dphi); a second-order-corrected trial
                keeps the ORIGINAL step's (alpha_max, dphi), per IPOPT."""
                rp_t = con_b(w_t[:, :n]) - w_t[:, n:]   # one eval serves
                th_t = rp_t.abs().sum(-1)               # theta AND phi_R
                phi_t = barrier_phi(w_t, mu_u)
                finite = torch.isfinite(th_t) & torch.isfinite(phi_t)
                dominated = (
                    filter_active & (_u(th_t) >= f_theta) & (_u(phi_t) >= f_phi)
                ).any(-1)
                switching = (dphi_arm < 0.0) & (
                    alpha_arm * (-dphi_arm) ** opt.s_phi
                    > opt.delta_sw * th0 ** opt.s_theta
                )
                armijo = phi_t <= phi0 + opt.eta_phi * alpha_arm * dphi_arm
                progress = (th_t <= (1.0 - opt.gamma_theta) * th0) | (
                    phi_t <= phi0 - opt.gamma_phi * th0
                )
                use_armijo = (th0 <= theta_min) & switching
                acceptable = torch.where(use_armijo, armijo, progress)
                # restoration mode: Armijo on the restoration merit phi_R
                phi_r_t = 0.5 * (d_used * rp_t * rp_t).sum(-1) + barrier_only(w_t, mu_u)
                resto_ok = (
                    torch.isfinite(phi_r_t)
                    & (dphi_r < 0.0)   # non-descent direction: force reg bump
                    & (phi_r_t <= phi_r0 + opt.eta_phi * alpha_arm * dphi_r)
                )
                acc = torch.where(
                    in_resto,
                    resto_ok,
                    finite & (th_t <= theta_max) & ~dominated & acceptable,
                )
                return acc, (~in_resto) & use_armijo & armijo, th_t, rp_t

            def trial_ok(alpha):
                acc, arm, _, _ = trial_eval(w + _u(alpha) * dw, alpha, dphi)
                return acc, arm

            # If the search fails, the final (tiny) alpha is taken anyway and
            # the next iteration starts its regularization search from a
            # boosted delta; FAILED is flagged only on non-finite steps.
            if opt.ls_mode == "parallel":
                # every trial alpha is evaluated (a static count, no
                # data-dependent loop) and the first acceptable one taken
                pows = 0.5 ** torch.arange(opt.max_ls, dtype=dtype, device=dev)
                alphas = _u(alpha_max) * pows[None, :]             # (B, max_ls)
                trials = [trial_ok(alphas[:, t]) for t in range(opt.max_ls)]
                ok_all = torch.stack([t[0] for t in trials], dim=1)
                armijo_all = torch.stack([t[1] for t in trials], dim=1)
                first = torch.argmax(ok_all.to(torch.int64), dim=1)  # first acceptable
                accepted = ok_all.any(-1)
                pick = torch.where(accepted, first, torch.full_like(first, opt.max_ls - 1))
                # the sequential loop's failure alpha is alpha_max * 0.5^max_ls
                alpha = torch.where(
                    accepted, alphas.gather(1, pick[:, None])[:, 0], alphas[:, -1] * 0.5)
                armijo_case = armijo_all.gather(1, pick[:, None])[:, 0] & accepted
                jj = pick + 1
                soc_taken = false_b
                wd_forced = false_b
                acc1 = false_b
            else:
                # first trial at the full fraction-to-boundary step,
                # evaluated once OUTSIDE the backtracking loop (same total
                # trial count) so its rejection can trigger the SOC below
                acc1, armijo1, th_t1, rp_t1 = trial_eval(
                    w + _u(alpha_max) * dw, alpha_max, dphi
                )
                if use_soc:
                    # ----- second-order correction (IPOPT 3.2, step A-5.1+)
                    # Trigger: full step rejected AND it increased
                    # infeasibility (constraint curvature, not a bad
                    # direction). Re-solve the SAME Newton system — the
                    # factorization carried out of the reg loop, the same
                    # complementarity targets tl_u/tu_u — with the primal
                    # residual replaced by c_soc = alpha c_k + c(trial):
                    # one condensed solve.
                    do_soc = (~acc1) & (th_t1 >= th0) & (~in_resto)
                    if wd_on:   # watchdog trials force full steps, no SOC
                        do_soc = do_soc & ~wd_active
                    sig_u = sigma_s + _u(delta_used)
                    d_u = sig_u / (1.0 + delta_c * sig_u)
                    a_u, b_u, _ = dual_rhs(tl_u, tu_u)
                    c_soc = _u(alpha_max) * r_p + rp_t1
                    rhs_s = -a_u + jtv_(d_u * (-c_soc - b_u / sig_u))
                    dz_s = solve_with(F_u, rhs_s)
                    dlam_s = d_u * (jv_(dz_s) + c_soc + b_u / sig_u)
                    ds_s = (dlam_s - b_u) / sig_u
                    dz_s = torch.where(fixed_z, zero, dz_s)
                    ds_s = torch.where(fixed_s, zero, ds_s)
                    dw_s = torch.cat([dz_s, ds_s], dim=1)
                    alpha_soc = primal_alpha_max(dw_s)
                    # acceptance: the filter test at the corrected point,
                    # with the ORIGINAL step's Armijo reference (alpha_max,
                    # dphi), and the corrected point must beat the rejected
                    # trial's infeasibility (IPOPT's kappa_soc = 0.99)
                    accs, arms, th_ts, _ = trial_eval(
                        w + _u(alpha_soc) * dw_s, alpha_max, dphi
                    )
                    soc_taken = (
                        do_soc & torch.isfinite(dw_s).all(-1) & accs
                        & (th_ts <= 0.99 * th_t1)
                    )
                else:
                    soc_taken = false_b
                    alpha_soc = alpha_max
                    arms = false_b

                # the loop continues the ORIGINAL direction's backtracking
                # from the second trial; skipped entirely when the first
                # trial or its second-order correction was accepted. Host
                # loop over "any instance still backtracking"; an instance
                # whose own condition is false keeps its carry.
                wd_forced = (wd_active & ~acc1) if wd_on else false_b
                jj_bt = izero + 1
                alpha_bt = alpha_max * 0.5
                accepted = acc1 | soc_taken | wd_forced
                armijo_bt = false_b
                while True:
                    active = (~accepted) & (jj_bt < opt.max_ls) & running
                    if not _any(active):
                        break
                    ok_t, arm_t = trial_ok(alpha_bt)
                    jj_bt = torch.where(active, jj_bt + 1, jj_bt)
                    alpha_bt = torch.where(active & ~ok_t, alpha_bt * 0.5, alpha_bt)
                    accepted = torch.where(active, ok_t, accepted)
                    armijo_bt = torch.where(active, arm_t, armijo_bt)
                alpha = torch.where(
                    acc1 | wd_forced, alpha_max,
                    torch.where(soc_taken, alpha_soc, alpha_bt))
                armijo_case = torch.where(
                    acc1, armijo1,
                    torch.where(soc_taken, arms, armijo_bt)) & ~wd_forced
                jj = torch.where(acc1 | soc_taken | wd_forced, izero + 1, jj_bt)

            if use_soc:
                # commit the corrected direction when SOC was taken
                dz = torch.where(_u(soc_taken), dz_s, dz)
                ds = torch.where(_u(soc_taken), ds_s, ds)
                dlam = torch.where(_u(soc_taken), dlam_s, dlam)
                dw = torch.where(_u(soc_taken), dw_s, dw)

            # bound-dual directions recovered from the SAME per-bound targets
            # the condensed solve eliminated them with (tl_u/tu_u == mu_u for
            # every strategy except the mehrotra corrector), for the FINAL
            # direction (original or second-order-corrected)
            dzl_d = torch.where(has_lo, tl_u / gl - zl_d - zl_d * dw / gl, zero)
            dzu_d = torch.where(has_up, tu_u / gu - zu_d + zu_d * dw / gu, zero)
            a_zl = _masked_min(-_u(tau) * zl_d / torch.clamp(dzl_d, max=-1e-300),
                               has_lo & (dzl_d < 0))
            a_zu = _masked_min(-_u(tau) * zu_d / torch.clamp(dzu_d, max=-1e-300),
                               has_up & (dzu_d < 0))
            alpha_dual = torch.clamp(torch.minimum(a_zl, a_zu), 0.0, 1.0)

            # filter augmentation: whenever acceptance did not come from the
            # Armijo case, block this (theta, phi) region from future returns
            augment = accepted & ~armijo_case & ~in_resto & ~wd_forced
            slot_f = torch.clamp(f_count, max=n_filter - 1)
            f_theta = torch.where(
                _u(augment),
                _set_slot(f_theta, slot_f, (1.0 - opt.gamma_theta) * th0),
                f_theta,
            )
            f_phi = torch.where(
                _u(augment),
                _set_slot(f_phi, slot_f, phi0 - opt.gamma_phi * th0),
                f_phi,
            )
            f_count = torch.where(augment, f_count + 1, f_count)

            w_new = w + _u(alpha) * dw
            # restoration leaves the original problem's equality duals alone
            # (its dlam solves the feasibility system, not the KKT system)
            lam_new = torch.where(_u(in_resto), lam, lam + _u(alpha) * dlam)
            zl_new = zl_d + _u(alpha_dual) * dzl_d
            zu_new = zu_d + _u(alpha_dual) * dzu_d

            # dual safeguard (IPOPT eq. 16)
            gl_n, gu_n = gaps(w_new)
            mu_c = _u(mu_u)
            zl_new = torch.where(
                has_lo,
                torch.clamp(zl_new, min=mu_c / (opt.kappa_sigma * gl_n),
                            max=opt.kappa_sigma * mu_c / gl_n),
                zero,
            )
            zu_new = torch.where(
                has_up,
                torch.clamp(zu_new, min=mu_c / (opt.kappa_sigma * gu_n),
                            max=opt.kappa_sigma * mu_c / gu_n),
                zero,
            )

            bad = ~(torch.isfinite(w_new).all(-1) & torch.isfinite(lam_new).all(-1) & ok)
            w_new = torch.where(_u(bad), w, w_new)
            lam_new = torch.where(_u(bad), lam, lam_new)
            zl_new = torch.where(_u(bad), zl_d, zl_new)
            zu_new = torch.where(_u(bad), zu_d, zu_new)

            # barrier update
            err_parts, gjc_new = kkt_error_parts(w_new, lam_new, zl_new, zu_new)
            e_mu = error_from_parts(err_parts, mu_u)

            def fiacco_mccormick(mu_):
                return torch.maximum(
                    mu_min, torch.minimum(opt.kappa_mu * mu_, mu_ ** opt.theta_mu))

            def big_move(mu_next_):
                return (mu_next_ < 0.2 * mu) | (mu_next_ > 5.0 * mu)

            if auto:
                # trusted: carry the probe's choice (as "probing" below);
                # untrusted: mu_u == mu, apply the monotone Fiacco-McCormick
                # update to it — full monotone semantics incl. filter reset.
                fm_mu = torch.where(
                    e_mu <= opt.kappa_eps * mu_u, fiacco_mccormick(mu_u), mu_u)
                mu_next = torch.where(mu_trust, mu_u, fm_mu)
                mu_next = torch.where((nb > 0) & ~bad, mu_next, mu)
                flush = torch.where(mu_trust, big_move(mu_next), mu_next != mu)
                f_count = torch.where(flush, izero, f_count)
            elif probing:
                # the probe already chose this iteration's mu; carry it —
                # unless the step was rejected as bad (factorization failed
                # through all reg rounds: w/lam reverted, so must mu) — and
                # flush the filter on big moves (entries store phi at old mu)
                mu_next = torch.where((nb > 0) & ~bad, mu_u, mu)
                f_count = torch.where(big_move(mu_next), izero, f_count)
            elif opt.mu_strategy == "adaptive":
                # Adaptive barrier (reference parity: IPOPT runs
                # mu_strategy=adaptive, LpNLPSolver.cpp:28). LOQO/Vanderbei
                # centrality rule: mu tracks the average complementarity,
                # scaled down by how centered the iterate already is —
                # sigma = 0.1 * min(0.05 (1-xi)/xi, 2)^3, xi = min comp / avg.
                gl_a, gu_a = gaps(w_new)
                comp_l_a = torch.where(has_lo, zl_new * gl_a, zero)
                comp_u_a = torch.where(has_up, zu_new * gu_a, zero)
                avg_c = (comp_l_a.sum(-1) + comp_u_a.sum(-1)) / nb1
                cmin = torch.minimum(
                    _masked_min(comp_l_a, has_lo), _masked_min(comp_u_a, has_up)
                )
                xi = cmin / torch.clamp(avg_c, min=1e-300)
                sigma_c = 0.1 * torch.clamp(
                    0.05 * (1.0 - xi) / torch.clamp(xi, min=1e-6), max=2.0) ** 3
                mu_ad = torch.minimum(torch.maximum(sigma_c * avg_c, mu_min), mu_init_t)
                mu_next = torch.where(nb > 0, mu_ad, mu)
                # filter entries store phi at the old mu: flush on big moves
                f_count = torch.where(big_move(mu_next), izero, f_count)
            else:
                # monotone Fiacco-McCormick: tighten once the barrier
                # subproblem is solved to kappa_eps * mu
                mu_next = torch.where(
                    e_mu <= opt.kappa_eps * mu, fiacco_mccormick(mu), mu)
                # the filter is tied to phi_mu: reset on barrier updates (IPOPT does)
                f_count = torch.where(mu_next != mu, izero, f_count)

            e_0 = error_from_parts(err_parts, sc(0.0))
            # theta at the accepted point from the carried constraint values
            # (gjc_new[2] is c(w_new) — no fresh transcription evaluation)
            th_new = (gjc_new[2] - w_new[:, n:]).abs().sum(-1)
            status_new = torch.where(e_0 <= tol_eff, izero + SOLVED, status)
            status_new = torch.where(bad & (it > 2), izero + FAILED, status_new)
            status_new = torch.where(
                (it + 1 >= opt.max_iter) & (status_new == RUNNING),
                izero + MAX_ITER, status_new,
            )
            if opt.record_history:
                slot = torch.clamp(it, max=hist["kkt"].shape[1] - 1)
                lin_err = (jv_(dz) - ds + r_p).abs().amax(-1) if m > 0 else sc(0.0)
                entries = {
                    "kkt": e_0, "mu": mu_u, "alpha": alpha, "alpha_max": alpha_max,
                    "delta_w": delta_used, "theta": th_new, "ls_iters": jj,
                    "lin_err": lin_err, "dphi": dphi,
                    "step_inf": dw.abs().amax(-1), "reg_k": k,
                    "r0": reg_diag[0], "r_end": reg_diag[1],
                }
                hist_new = {
                    key: _set_slot(hist[key], slot, val) for key, val in entries.items()
                }
            else:
                hist_new = hist
            # boost the next regularization start after a failed line search:
            # the step direction was sound by the factorization's account but
            # useless in practice — damp the near-null directions next time
            delta_start_next = torch.where(
                accepted, sc(0.0), torch.clamp(10.0 * delta_used, min=opt.delta_w0))
            # Deadlock handling. Repeated line-search failures (high boosted
            # regularization OR a streak of rejected searches) mean the filter
            # has deadlocked. IPOPT enters its restoration phase here; so do
            # we, when the iterate is meaningfully INFEASIBLE: switch to
            # restoration mode (pure feasibility Gauss-Newton steps, see the
            # `in_resto` branches above) for up to `resto_max` iterations,
            # exiting early once theta has dropped by 10x. When the deadlock
            # happens while already (near-)feasible, restoration has nothing
            # to minimize — fall back to the soft re-centering (clear the
            # filter, reset the bound duals onto the central path, raise mu,
            # drop the regularization).
            # a "real" step moves: micro-alpha acceptances count as failures
            resto_max = opt.resto_max_iter if opt.restoration else 0
            real_step = accepted & (alpha >= 1e-3 * alpha_max)
            ls_fails = torch.where(real_step, izero, ls_fails + 1)
            stuck = (~real_step) & (
                ((~accepted) & (delta_start >= opt.delta_w_stuck))
                | (ls_fails >= 8)
            )
            ls_fails = torch.where(stuck, izero, ls_fails)
            # restoration exit: target met, iteration cap, or stuck inside it
            resto_target = torch.maximum(0.1 * theta_entry, 0.01 * theta_min)
            exit_resto = in_resto & (
                (th_new <= resto_target) | (resto_left <= 1) | stuck
            )
            resto_next = torch.where(
                exit_resto, izero, torch.clamp(resto_left - 1, min=0))
            # Two consecutive unproductive restoration episodes (< 2x theta
            # reduction each) mean the iterate sits at an infeasible local
            # minimizer of ||c|| — IPOPT's "restoration phase failed" outcome.
            # Flag the instance FAILED instead of wandering.
            episode_failed = exit_resto & (th_new > 0.5 * theta_entry)
            resto_strikes = torch.where(
                episode_failed, resto_strikes + 1,
                torch.where(exit_resto, izero, resto_strikes),
            )
            status_new = torch.where(
                (resto_strikes >= 2) & (status_new == RUNNING)
                & (th_new > 10.0 * theta_min),
                izero + FAILED, status_new,
            )
            # restoration entry (only from normal mode, only if infeasible)
            enter_resto = stuck & (~in_resto) & (th_new > 10.0 * theta_min)
            if not opt.restoration:
                enter_resto = false_b
            resto_next = torch.where(enter_resto, izero + resto_max, resto_next)
            theta_entry = torch.where(enter_resto, th_new, theta_entry)
            soft_restore = stuck & (~enter_resto) & (~in_resto)
            # during restoration mu is frozen (e_mu measures the original
            # problem and must not drive the barrier schedule)
            mu_next = torch.where(in_resto & ~exit_resto, mu, mu_next)
            gl_n, gu_n = gaps(w_new)
            mu_next = torch.where(
                soft_restore, torch.clamp(mu, min=opt.mu_restore), mu_next)
            # the filter is cleared when entering restoration / soft-restoring
            # but NOT on restoration exit: the pre-entry filter still stands,
            # so the post-restoration iterate must be acceptable to it
            # (IPOPT's re-entry condition) — clearing it on exit lets a
            # freshly-unfiltered step undo the feasibility gain at once.
            f_count = torch.where(soft_restore | enter_resto, izero, f_count)
            zl_new = torch.where(_u(soft_restore) & has_lo, _u(mu_next) / gl_n, zl_new)
            zu_new = torch.where(_u(soft_restore) & has_up, _u(mu_next) / gu_n, zu_new)
            delta_start_next = torch.where(
                stuck, sc(0.0), torch.clamp(delta_start_next, max=opt.delta_w_max))
            if wd_on:
                # ---- watchdog bookkeeping (statically gated) ----
                # success: a watchdog trial produced a normally-acceptable
                # first trial; failure: trials exhausted without one -> the
                # saved iterate (incl. its g/J/c and E_0) is restored and the
                # next factorization starts regularized. A forced point that
                # genuinely satisfies E_0 <= tol is a legitimate optimum and
                # is NOT rolled back.
                wd_fail = (
                    wd_active & (wd_left <= 1) & ~acc1
                    & (status_new != SOLVED)
                )
                cur = (w_new, lam_new, zl_new, zu_new, mu_next, gjc_new, e_0)
                (w_new, lam_new, zl_new, zu_new, mu_next, gjc_new, e_0) = _sel(
                    wd_fail, wd_bak, cur)
                f_count = torch.where(wd_fail, izero, f_count)
                delta_start_next = torch.where(
                    wd_fail, torch.clamp(10.0 * delta_used, min=opt.delta_w0),
                    delta_start_next,
                )
                shortened = (~accepted) | (alpha < 0.999 * alpha_max)
                wd_streak_next = torch.where(
                    shortened & ~wd_active & ~in_resto, wd_streak + 1, izero)
                wd_success = wd_active & acc1
                wd_left_next = torch.where(
                    wd_success, izero, torch.clamp(wd_left - 1, min=0))
                arm = (
                    (wd_streak_next >= opt.watchdog_trigger)
                    & (wd_left_next == 0) & ~in_resto & ~wd_fail
                    & (status_new == RUNNING)
                )
                wd_left_next = torch.where(
                    arm, izero + opt.watchdog_trial_iter, wd_left_next)
                wd_streak_next = torch.where(arm, izero, wd_streak_next)
                cur = (w_new, lam_new, zl_new, zu_new, mu_next, gjc_new, e_0)
                wd_bak_next = _sel(arm, cur, wd_bak)
            else:
                wd_streak_next, wd_left_next, wd_bak_next = (
                    wd_streak, wd_left, wd_bak
                )

            # centrality-guard update for the auto mu oracle: the Mehrotra
            # probe is trusted next iteration only when this line search was
            # clean (accepted within one halving, step not reverted, not in
            # or entering restoration or a watchdog episode). The threshold
            # jj <= 2 is the JAX package's measured choice, kept as is.
            mu_trust_next = (
                accepted & (jj <= 2) & ~bad & ~in_resto & ~stuck
                & ~wd_active
            )
            return (w_new, lam_new, zl_new, zu_new, mu_next, delta_used, it + 1,
                    status_new, hist_new, f_theta, f_phi, f_count, delta_start_next,
                    gjc_new, e_0, ls_fails, resto_next, theta_entry, resto_strikes,
                    mu_trust_next, wd_streak_next, wd_left_next, wd_bak_next)

        slots = opt.max_iter if opt.record_history else 1
        hist0 = {
            key: torch.zeros((B, slots), dtype=dtype, device=dev)
            for key in ("kkt", "mu", "alpha", "alpha_max", "delta_w", "theta",
                        "lin_err", "dphi", "step_inf", "r0", "r_end")
        }
        hist0["ls_iters"] = torch.zeros((B, slots), dtype=torch.int64, device=dev)
        hist0["reg_k"] = torch.zeros((B, slots), dtype=torch.int64, device=dev)
        parts0, gjc0 = kkt_error_parts(w0, lam0, zl_d0, zu_d0)
        e0_init = error_from_parts(parts0, sc(0.0))
        state = (
            w0, lam0, zl_d0, zu_d0, mu0,
            sc(0.0),                                        # delta_last
            izero,                                          # iteration count
            izero + RUNNING,                                # status
            hist0,
            torch.zeros((B, n_filter), dtype=dtype, device=dev),            # filter theta
            torch.full((B, n_filter), float("-inf"), dtype=dtype, device=dev),  # filter phi
            izero,                                          # filter count
            sc(0.0),                                        # delta_start
            gjc0,                                           # carried g/J/c
            e0_init,                                        # carried E_0
            izero,                                          # ls failure streak
            izero,                                          # restoration budget
            sc(0.0),                                        # theta at resto entry
            izero,                                          # failed-episode strikes
            ~false_b,                                       # auto-mu centrality trust
            izero,                                          # watchdog short-step streak
            izero,                                          # watchdog trials left
            (w0, lam0, zl_d0, zu_d0, mu0, gjc0, e0_init),   # watchdog backup
        )
        # outer loop: iterate while any instance is RUNNING; every leaf of
        # the state of a frozen instance is kept (its step is selected away)
        while True:
            running = state[7] == RUNNING
            if not _any(running):
                break
            state = _sel(running, step(state, running), state)
            solve.outer_iterations += 1
        (w, lam, zl_d, zu_d, mu, delta_last, it, status, hist) = state[:9]
        e_final = state[14]
        return IPMResult(
            z=w[:, :n], s=w[:, n:], lam=lam, zl_dual=zl_d, zu_dual=zu_d,
            status=status.to(torch.int32), iterations=it.to(torch.int32),
            objective=obj_b(w[:, :n]), kkt_error=e_final,
            mu=mu, delta_w=delta_last,
            history=hist if opt.record_history else None,
        )

    solve.host_syncs = 0          # any()-reads that steered a host loop
    solve.outer_iterations = 0    # lockstep IPM iterations run so far
    return solve
