"""Port parity: differentiating through a converged solve (core/diff.py) and
the pin sensitivities of ``BatchSolver`` (parallel/batch.py).

* ``make_kkt_residual`` and ``solution_vjp`` of both packages on the same
  ``(v*, bounds, μ, ȳ)`` (made from a seed inside the bounds; no solve), for
  the brachistochrone at degrees (6, 6) and Bryson–Denham at (8,) * 4, to
  1e-10 relative. The JAX side runs live (module-scoped fixture).
* ``x0_sensitivities`` / ``q_sensitivities`` of both packages on the same
  ``(z, λ)`` to 1e-10; the port's ``q_sensitivities`` on Goddard's
  regularized problem (ε pinned as ``q``) against finite differences.
* ``DifferentiableSolver`` on the port through the checks of
  ``tests/test_diff.py`` with their tolerances (central finite differences
  of the solver, the dual envelope sensitivities, Bryson–Denham's analytic
  dJ*/dl = −36, a trajectory cotangent) and against the JAX package's
  gradient pinned by ``scripts/jax_singular_pins.py`` (case ``diff_brach``)
  to 1e-6 relative. Finite-difference solves of several perturbations run as
  one batch: instances are independent, so each is the solve it would be
  alone.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpopc_tpu.core import diff as ref_diff
from lpopc_tpu.core.ipm import IPMOptions as RefIPMOptions
from lpopc_tpu.core.solve import SolveOptions as RefSolveOptions
from lpopc_tpu.models import brachistochrone as ref_brach
from lpopc_tpu.models import brysondenham as ref_bd
from lpopc_tpu.models import goddard as ref_goddard
from lpopc_tpu.parallel.batch import make_batch_solver as ref_make
from lpopc_tpu_torch.core import diff as port_diff
from lpopc_tpu_torch.core.ipm import SOLVED, IPMOptions
from lpopc_tpu_torch.core.solve import SolveOptions
from lpopc_tpu_torch.models import brachistochrone, brysondenham, goddard
from lpopc_tpu_torch.parallel.batch import make_batch_solver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "scripts", "jax_singular_pins.json"), encoding="utf-8") as _f:
    PINS = json.load(_f)
REL_TOL = 1e-10
INF_CUT = 1e19

MODELS = {
    # name -> (JAX problem, port problem)
    "brachistochrone": (lambda: ref_brach.make_problem(degrees=(6, 6)),
                        lambda: brachistochrone.make_problem(degrees=(6, 6))),
    "brysondenham": (lambda: ref_bd.make_problem(l=1.0 / 9.0, degrees=(8,) * 4),
                     lambda: brysondenham.make_problem(l=1.0 / 9.0, degrees=(8,) * 4)),
    "goddard_regularized": (lambda: ref_goddard.make_problem_regularized(1e-2, (4,) * 2),
                            lambda: goddard.make_problem_regularized(1e-2, (4,) * 2)),
}


def _options():
    return SolveOptions(ipm=IPMOptions(tol=1e-10, max_iter=80))


@pytest.fixture(scope="module")
def solvers():
    """(JAX batch solver, port batch solver) per model; nothing is solved."""
    opts = RefSolveOptions(ipm=RefIPMOptions(tol=1e-10, max_iter=80))
    return {name: (ref_make(r(), opts), make_batch_solver(p(), _options(), device="cpu"))
            for name, (r, p) in MODELS.items()}


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    scale = np.max(np.abs(want))
    return float(np.max(np.abs(got - want)) / (scale if scale > 0 else 1.0))


def _inside(w, lo, hi, rng):
    """``w`` moved strictly inside [lo, hi] where a bound is finite; equal
    bounds pin it."""
    span = np.where((lo > -INF_CUT) & (hi < INF_CUT), hi - lo, 1.0)
    lo_in = np.where(lo > -INF_CUT, lo + 0.05 * span, -np.inf)
    hi_in = np.where(hi < INF_CUT, hi - 0.05 * span, np.inf)
    w = np.clip(w + 0.01 * rng.uniform(-1, 1, w.shape), lo_in, hi_in)
    return np.where(hi - lo <= 1e-14, lo, w)


def _point(bs, batch, seed):
    """(v*, zl, zu, cl, cu, mu, ybar) from a seed: z and s strictly inside
    their bounds, λ and ȳ standard normal, μ 1e-3 per instance."""
    rng = np.random.default_rng(seed)
    z0, zl, zu, cl, cu = bs.nominal_inputs(batch)
    z = _inside(z0, zl, zu, rng)
    c = torch.func.vmap(bs.scaled.constraints)(torch.as_tensor(z)).numpy()
    s = _inside(c, cl, cu, rng)
    lam = rng.standard_normal((batch, bs.m))
    ybar = rng.standard_normal((batch, bs.n + 2 * bs.m))
    return np.concatenate([z, s, lam], 1), zl, zu, cl, cu, np.full(batch, 1e-3), ybar


@pytest.mark.parametrize("name", ["brachistochrone", "brysondenham"])
def test_kkt_residual_and_vjp_match_reference(solvers, name):
    ref_bs, bs = solvers[name]
    assert (ref_bs.n, ref_bs.m) == (bs.n, bs.m)
    v, zl, zu, cl, cu, mu, ybar = _point(bs, 2, seed=5)
    ref_res = ref_diff.make_kkt_residual(ref_bs.scaled.objective, ref_bs.scaled.constraints,
                                        bs.n, bs.m)
    port_res = port_diff.make_kkt_residual(bs.scaled.objective, bs.scaled.constraints,
                                           bs.n, bs.m)
    ref_vjp = ref_diff.solution_vjp(ref_bs.scaled.objective, ref_bs.scaled.constraints,
                                    bs.n, bs.m)
    port_vjp = port_diff.solution_vjp(bs.scaled.objective, bs.scaled.constraints, bs.n, bs.m)
    T = lambda a: torch.as_tensor(a)
    inputs = (v, zl, zu, cl, cu, mu)
    want = np.asarray(jax.jit(jax.vmap(ref_res))(*map(jnp.asarray, inputs)))
    want_b = jax.jit(jax.vmap(ref_vjp))(*map(jnp.asarray, inputs + (ybar,)))
    assert np.all(np.isfinite(want))
    # batched over the instances, as DifferentiableSolver runs it, and alone
    got_all = torch.func.vmap(port_vjp)(*map(T, inputs + (ybar,)))
    for b in range(v.shape[0]):
        args = [T(a[b]) for a in inputs]
        assert _rel(port_res(*args).numpy(), want[b]) <= REL_TOL
        got_b = port_vjp(*args, T(ybar[b]))
        for g_all, g, w in zip(got_all, got_b, want_b):
            assert _rel(g.numpy(), np.asarray(w[b])) <= REL_TOL
            assert _rel(g_all[b].numpy(), np.asarray(w[b])) <= REL_TOL


@pytest.mark.parametrize("kind", ["x0", "q"])
def test_pin_sensitivities_match_reference(solvers, kind):
    name = "brachistochrone" if kind == "x0" else "goddard_regularized"
    ref_bs, bs = solvers[name]
    rng = np.random.default_rng(7)
    z0 = bs.nominal_inputs(3)[0]
    res = types.SimpleNamespace(z=z0 * (1.0 + 0.01 * rng.uniform(-1, 1, z0.shape)),
                                lam=rng.standard_normal((3, bs.m)))
    want = getattr(ref_bs, f"{kind}_sensitivities")(res)
    got = getattr(bs, f"{kind}_sensitivities")(res)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want)) and np.isfinite(got).any()
    fin = np.isfinite(want)
    assert _rel(got[fin], want[fin]) <= REL_TOL
    # tensors on the solver's device give the same
    res_t = types.SimpleNamespace(z=torch.as_tensor(res.z), lam=torch.as_tensor(res.lam))
    np.testing.assert_array_equal(getattr(bs, f"{kind}_sensitivities")(res_t), got)


def test_q_sensitivities_match_finite_differences():
    """dJ*/dε of Goddard's regularized problem (ε pinned as q) from the duals
    against central differences of the solver: ε ± h in one batch."""
    bs = make_batch_solver(goddard.make_problem_regularized(1e-2, (4,) * 2),
                           goddard.auto_options(), device="cpu")
    pl = bs.nlp.layout.phases[0]
    qrow = pl.q_slice.start
    h = 1e-5 * bs.scaled.var_scale[qrow]
    z0, zl, zu, cl, cu = bs.nominal_inputs(3)
    for b, d in ((1, h), (2, -h)):
        zl[b, qrow] += d
        zu[b, qrow] += d
        z0[b, qrow] += d
    res = bs.run(z0, zl, zu, cl, cu)
    assert res.status.tolist() == [SOLVED] * 3
    sens = bs.q_sensitivities(res)
    obj = res.objective.numpy() / bs.scaled.obj_scale
    fd = (obj[1] - obj[2]) / (2e-5)
    assert abs(sens[0, 0] - fd) < 5e-3 * max(1.0, abs(fd))


@pytest.fixture(scope="module")
def brach():
    dsol = port_diff.make_differentiable_solver(brachistochrone.make_problem(degrees=(6, 6)),
                                                _options(), device="cpu")
    return dsol.bs, dsol


def _xf_rows(bs):
    pl = bs.nlp.layout.phases[0]
    off = pl.var_offset + (pl.npts - 1) * pl.nx
    return slice(off, off + 2)


def _grad_of(dsol, args, loss_of, wrt=(1, 2)):
    """Gradient of ``loss_of(outputs)`` with respect to the inputs ``wrt``."""
    T = [torch.as_tensor(a).clone().requires_grad_(i in wrt) for i, a in enumerate(args)]
    loss = loss_of(dsol(*T))
    return torch.autograd.grad(loss, [T[i] for i in wrt])


def _fd_batch(bs, args, rows, eps):
    """Central differences over ``rows``: every (instance, row, sign) as one
    instance of one batch, pinned rows moved in zl and zu (and z0)."""
    z0, zl, zu, cl, cu = (np.array(a) for a in args)
    B, k = z0.shape[0], rows.stop - rows.start
    rep = [np.repeat(a, 2 * k, axis=0) for a in (z0, zl, zu, cl, cu)]
    for b in range(B):
        for j in range(k):
            for s, sign in enumerate((1.0, -1.0)):
                i = (b * k + j) * 2 + s
                for a in rep[:3]:
                    a[i, rows.start + j] += sign * eps
    res = bs.run(*rep)
    assert res.status.tolist() == [SOLVED] * len(res.status)
    return res, B, k


def test_gradient_matches_finite_differences(brach):
    """d(objective)/d(terminal-target pins) against central FD of the solver,
    and against the JAX package's gradient (pinned)."""
    bs, dsol = brach
    z0, zl, zu, cl, cu = bs.nominal_inputs(2)
    rows = _xf_rows(bs)
    pin = PINS["diff_brach"]
    assert [rows.start, rows.stop] == pin["rows"]
    d = np.array([[0.07, -0.04], [-0.05, 0.06]]) * bs.scaled.var_scale[rows][None, :]
    zl[:, rows] += d
    zu[:, rows] += d
    z0[:, rows] += d
    args = (z0, zl, zu, cl, cu)
    g_zl, g_zu = _grad_of(dsol, args, lambda out: out[3].sum())
    # a pinned row moves BOTH zl and zu together: total derivative = sum
    g = (g_zl + g_zu).numpy()[:, rows]
    assert _rel(g, pin["grad"]) <= 1e-6

    eps = 1e-6
    res, B, k = _fd_batch(bs, args, rows, eps)
    obj = res.objective.numpy().reshape(B, k, 2)
    fd = (obj[..., 0] - obj[..., 1]) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=2e-4, atol=1e-8)


def test_matches_dual_envelope_sensitivities(brach):
    """dJ*/dx0 via the KKT adjoint == the dual-based x0_sensitivities."""
    bs, dsol = brach
    rng = np.random.default_rng(3)
    args = bs.perturb_x0(2, 0, 0.05 * rng.uniform(-1, 1, (2, 3)))
    res = bs.run(*args)
    assert res.status.tolist() == [SOLVED] * 2
    dual_sens = bs.x0_sensitivities(res)  # (batch, nx), unscaled, NaN if free
    g_zl, g_zu = _grad_of(dsol, args, lambda out: out[3].sum())
    pl = bs.nlp.layout.phases[0]
    sl = slice(pl.var_offset, pl.var_offset + pl.nx)
    g_scaled = (g_zl + g_zu).numpy()[:, sl]
    # scaled-space chain rule: J_s = obj_scale*J, z_s = var_scale*z
    g_unscaled = g_scaled * bs.scaled.var_scale[sl][None, :] / float(bs.scaled.obj_scale)
    mask = np.isfinite(dual_sens)
    assert mask.any()
    np.testing.assert_allclose(g_unscaled[mask], dual_sens[mask], rtol=1e-5, atol=1e-7)


def test_bryson_denham_bound_sensitivity(solvers):
    """dJ*/dl for the x1 <= l path bound: analytic J*(l) = 4/(9l) gives
    dJ*/dl = -4/(9 l^2) = -36 at l = 1/9; and central FD of the solver in l
    (the rows bounded by l moved by ±eps in one batch)."""
    l = 1.0 / 9.0
    _, bs = solvers["brysondenham"]
    dsol = port_diff.DifferentiableSolver(bs)
    args = bs.nominal_inputs(1)
    res = bs.run(*args)
    assert res.status.tolist() == [SOLVED]
    obj_scale = float(bs.scaled.obj_scale)
    J = float(res.objective[0]) / obj_scale
    assert abs(J - 4.0) < 2e-3

    (g_zu,) = _grad_of(dsol, args, lambda out: out[3].sum(), wrt=(2,))
    g_zu = g_zu.numpy()[0]
    pl = bs.nlp.layout.phases[0]
    vs = bs.scaled.var_scale
    raw_zu = bs.nlp.zu
    rows = [pl.var_offset + k * pl.nx for k in range(1, pl.npts - 1)
            if abs(raw_zu[pl.var_offset + k * pl.nx] - l) < 1e-12]
    assert rows
    dj_dl = sum(g_zu[r] * vs[r] for r in rows) / obj_scale
    assert abs(dj_dl - (-36.0)) < 0.2, dj_dl

    eps = 1e-6
    z0, zl, zu, cl, cu = (np.repeat(a, 2, axis=0) for a in args)
    for b, sign in enumerate((1.0, -1.0)):
        zu[b, rows] += sign * eps * vs[rows]
    r2 = bs.run(z0, zl, zu, cl, cu)
    assert r2.status.tolist() == [SOLVED] * 2
    vals = r2.objective.numpy() / obj_scale
    fd = (vals[0] - vals[1]) / (2 * eps)
    np.testing.assert_allclose(dj_dl, fd, rtol=5e-3)


def test_trajectory_cotangent(brach):
    """Gradients flow through a TRAJECTORY functional (not just the
    objective): L = final speed^2 read from z*; z0 gets a zero gradient."""
    bs, dsol = brach
    args = bs.nominal_inputs(1)
    rows = _xf_rows(bs)
    pl = bs.nlp.layout.phases[0]
    vrow = pl.var_offset + (pl.npts - 1) * pl.nx + 2  # terminal speed v(tf)
    g_z0, g_zl, g_zu = _grad_of(dsol, args, lambda out: (out[0][:, vrow] ** 2).sum(),
                                wrt=(0, 1, 2))
    assert float(g_z0.abs().max()) == 0.0
    g = (g_zl + g_zu).numpy()[:, rows]
    assert np.all(np.isfinite(g))

    eps = 1e-6
    res, B, k = _fd_batch(bs, args, rows, eps)
    v2 = (res.z.numpy()[:, vrow] ** 2).reshape(B, k, 2)
    fd = (v2[..., 0] - v2[..., 1]) / (2 * eps)
    # atol covers central-FD noise (~1e-8/eps) on near-zero components
    np.testing.assert_allclose(g, fd, rtol=1e-3, atol=1e-6)
