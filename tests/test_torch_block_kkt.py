"""Port parity: the block-structured KKT factorization (core/block_kkt.py)
against the JAX package's, on the same seeded inputs.

Held on the two-phase problem of ``tests/test_block_kkt.py`` (path rows, an
event, a parameter, a linkage, degrees (4, 1, 6) and (5, 5)), defined again
with the port's ``Problem``, and on hypersensitive at degrees (5, 4, 6, 5):

* the spec's index arrays are equal exactly;
* ``factor_from_blocks`` (through ``make_block_factorizer``) and the block
  solve agree to 1e-12 relative on the same K, apart from the explicit
  Schur inverse and the solve on hypersensitive, held to 3e-12: there the
  Schur complement ``C - Σ B W`` cancels most of ``C``, and the JAX
  package's own compiled and eager runs of the same function differ by
  2.6e-12 (ROADMAP Queue 3, entry 3);
* ``factor_ok`` flags the same indefinite K, per instance;
* the batched solver built with the block factorizer as its
  ``kkt_factorizer`` (``block_kkt="on"``, ``block_assembly="dense"``,
  B = 3) takes the JAX package's iterations, z to 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpopc_tpu.core import block_kkt as ref_bk
from lpopc_tpu.core.ipm import IPMOptions as RefIPMOptions
from lpopc_tpu.core.solve import SolveOptions as RefSolveOptions
from lpopc_tpu.core.structured import make_structured_hessian, make_structured_jacobian
from lpopc_tpu.core.transcribe import transcribe as ref_transcribe
from lpopc_tpu.models import hypersensitive as ref_hyper
from lpopc_tpu.parallel.batch import make_batch_solver as ref_make
from lpopc_tpu_torch.core import block_kkt as port_bk
from lpopc_tpu_torch.core.ipm import SOLVED, IPMOptions
from lpopc_tpu_torch.core.problem import Linkage, Phase, Problem
from lpopc_tpu_torch.core.solve import SolveOptions
from lpopc_tpu_torch.core.transcribe import transcribe as port_transcribe
from lpopc_tpu_torch.models import hypersensitive as port_hyper
from lpopc_tpu_torch.ops import batched_linalg as bl
from lpopc_tpu_torch.parallel.batch import make_batch_solver
from test_block_kkt import _two_phase_problem as ref_two_phase_problem

REL_TOL = 1e-12
# (problem, BlockFactor field or "x") -> its limit where it is not REL_TOL
FACTOR_TOL = {("hypersensitive", "Sinv"): 3e-12, ("hypersensitive", "x"): 3e-12}
Z_TOL = 1e-8
DELTAS = np.array([[0.0], [0.05], [-0.05]])   # x0 shifts of the B = 3 solves


def port_two_phase_problem():
    """The twin of ``tests/test_block_kkt.py::_two_phase_problem``."""
    dyn = lambda x, u, t, q: torch.stack([x[1], u[0] - q[0] * x[1]])
    path = lambda x, u, t, q: torch.stack([x[0] ** 2 + u[0] ** 2])
    p1 = Phase(
        nx=2, nu=1, nq=1, npath=1, nevent=1,
        dynamics=dyn, path=path,
        lagrange=lambda x, u, t, q: 0.5 * u[0] ** 2,
        event=lambda x0, t0, xf, tf, q: torch.stack([xf[0] + q[0]]),
        x0_bounds=(np.array([0.0, 0.0]), np.array([0.0, 0.0])),
        x_bounds=(-10.0, 10.0), u_bounds=(-5.0, 5.0),
        q_bounds=(0.1, 2.0), path_bounds=(-100.0, 100.0),
        event_bounds=(-1.0, 1.0),
        t0_bounds=(0.0, 0.0), tf_bounds=(1.0, 1.0),
        mesh_degrees=(4, 1, 6), mesh_fractions=(-1.0, -0.2, 0.3, 1.0),
    )
    p2 = Phase(
        nx=2, nu=1,
        dynamics=lambda x, u, t, q: torch.stack([x[1], u[0]]),
        mayer=lambda x0, t0, xf, tf, q: xf[0] ** 2 + xf[1] ** 2,
        x_bounds=(-10.0, 10.0), u_bounds=(-5.0, 5.0),
        t0_bounds=(1.0, 1.0), tf_bounds=(2.0, 2.0),
        mesh_degrees=(5, 5), mesh_fractions=(-1.0, 0.0, 1.0),
    )
    link = Linkage(
        left=0, right=1, nlink=2,
        fn=lambda xfl, ql, x0r, qr: x0r - xfl + x0r.new_tensor([0.0, 0.1]) * ql[0],
    )
    return Problem(phases=(p1, p2), linkages=(link,), name="blocktest")


# name -> (JAX problem, port problem) factories
PROBLEMS = {
    "two_phase": (ref_two_phase_problem, port_two_phase_problem),
    "hypersensitive": (lambda: ref_hyper.make_problem(tf=40.0, degrees=(5, 4, 6, 5)),
                       lambda: port_hyper.make_problem(tf=40.0, degrees=(5, 4, 6, 5))),
}


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def specs(name):
    ref_nlp = ref_transcribe(PROBLEMS[name][0]())
    port_nlp = port_transcribe(PROBLEMS[name][1](), device="cpu")
    return (ref_nlp, ref_bk.make_block_spec(ref_nlp.layout, ref_nlp.ops),
            port_nlp, port_bk.make_block_spec(port_nlp.layout, port_nlp.ops))


def spd_kkts(name, count, seed=3):
    """``count`` condensed K's of the problem at seeded points near its guess
    (the construction of tests/test_block_kkt.py), shifted to be SPD, and
    a right-hand side for each."""
    problem = PROBLEMS[name][0]()
    nlp = ref_transcribe(problem)
    jac = jax.jit(make_structured_jacobian(problem, nlp.layout, nlp.ops))
    hess = jax.jit(make_structured_hessian(problem, nlp.layout, nlp.ops))
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        z = jnp.asarray(nlp.z0 + 0.01 * rng.standard_normal(nlp.n))
        lam = jnp.asarray(rng.standard_normal(nlp.m))
        J, H = np.asarray(jac(z)), np.asarray(hess(z, lam))
        d = rng.uniform(0.5, 2.0, nlp.m)
        K = H + (J.T * d) @ J
        out.append(K + (abs(min(np.linalg.eigvalsh(K).min(), 0.0)) + 1.0) * np.eye(nlp.n))
    return np.stack(out), rng.standard_normal((count, nlp.n))


@pytest.fixture(scope="module")
def blocks():
    """Per problem: both specs, two SPD K's with right-hand sides, and the
    JAX package's compiled factorizer triple."""
    out = {}
    for name in PROBLEMS:
        _, ref_spec, _, spec = specs(name)
        Ks, rs = spd_kkts(name, 2)
        out[name] = (ref_spec, spec, Ks, rs,
                     tuple(jax.jit(f) for f in ref_bk.make_block_factorizer(ref_spec)))
    return out


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_spec_matches_reference(name):
    _, ref_spec, _, spec = specs(name)
    for field in ("interior_idx", "interior_mask", "border_idx"):
        got, want = getattr(spec, field), getattr(ref_spec, field)
        assert got.dtype == want.dtype and np.array_equal(got, want), field
    assert (spec.n, spec.num_blocks, spec.block_size, spec.border_size) == (
        ref_spec.n, ref_spec.num_blocks, ref_spec.block_size, ref_spec.border_size)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_factor_and_solve_match_reference(blocks, name):
    ref_spec, spec, Ks, rs, (ref_fact, ref_solve, ref_ok) = blocks[name]
    factorize, solve, factor_ok = port_bk.make_block_factorizer(spec)
    F = factorize(torch.as_tensor(Ks))
    x = solve(F, torch.as_tensor(rs))
    assert factor_ok(F).tolist() == [True, True]
    for i in range(2):
        K_i, r_i = jnp.asarray(Ks[i]), jnp.asarray(rs[i])
        Fr = ref_fact(K_i)
        assert bool(ref_ok(Fr))
        x_ref = np.asarray(ref_solve(Fr, r_i))
        np.testing.assert_allclose(x[i].numpy(), np.linalg.solve(Ks[i], rs[i]),
                                   rtol=0, atol=1e-9 * np.abs(x_ref).max())
        errs = {f: rel_err(getattr(F, f)[i], getattr(Fr, f)) for f in F._fields}
        errs["x"] = rel_err(x[i], x_ref)
        for key, err in errs.items():
            assert err <= FACTOR_TOL.get((name, key), REL_TOL), (key, i, err)


def test_factor_ok_flags_indefinite_per_instance(blocks):
    ref_spec, spec, Ks, _, (ref_fact, _, ref_ok) = blocks["two_phase"]
    neg = -np.eye(spec.n)
    factorize, _, factor_ok = port_bk.make_block_factorizer(spec)
    got = factor_ok(factorize(torch.as_tensor(np.stack([Ks[0], neg, Ks[1]]))))
    assert got.shape == (3,) and got.tolist() == [True, False, True]
    assert [bool(ref_ok(ref_fact(jnp.asarray(K)))) for K in (Ks[0], neg, Ks[1])] == [
        True, False, True]


def test_spec_is_none_without_interior():
    """Degree-1 segments of a control-free phase have nothing to condense."""
    problem = Problem(phases=(Phase(
        nx=1, dynamics=lambda x, u, t, q: torch.stack([-x[0]]),
        mayer=lambda x0, t0, xf, tf, q: xf[0] ** 2,
        x0_bounds=(1.0, 1.0), x_bounds=(-5.0, 5.0),
        t0_bounds=(0.0, 0.0), tf_bounds=(1.0, 1.0),
        mesh_degrees=(1, 1), mesh_fractions=(-1.0, 0.0, 1.0)),))
    nlp = port_transcribe(problem, device="cpu")
    assert port_bk.make_block_spec(nlp.layout, nlp.ops) is None


def batch_options(assembly, lane_kkt=False):
    kw = dict(block_kkt="on", block_assembly=assembly, mesh_method="none")
    return (RefSolveOptions(ipm=RefIPMOptions(tol=1e-8, max_iter=100), **kw),
            SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=100, lane_kkt=lane_kkt), **kw))


def assert_batch_matches_reference(assembly, lane_kkt=False):
    """The B = 3 sweep over x0 shifts through ``make_batch_solver`` with the
    block path engaged: the port's solver against the JAX package's."""
    ref_opts, port_opts = batch_options(assembly, lane_kkt)
    ref_bs = ref_make(PROBLEMS["hypersensitive"][0](), ref_opts)
    ref_args = ref_bs.perturb_x0(3, 0, DELTAS)
    ref = ref_bs.run(*ref_args)
    bs = make_batch_solver(PROBLEMS["hypersensitive"][1](), port_opts, device="cpu")
    args = bs.perturb_x0(3, 0, DELTAS)
    for a, b in zip(args, ref_args):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    bl.reset_launches()
    res = bs.run(*args)
    assert res.status.tolist() == np.asarray(ref.status).tolist() == [SOLVED] * 3
    assert res.iterations.tolist() == np.asarray(ref.iterations).tolist()
    np.testing.assert_allclose(res.z.numpy(), np.asarray(ref.z), rtol=0, atol=Z_TOL)
    np.testing.assert_allclose(res.objective.numpy(), np.asarray(ref.objective),
                               rtol=0, atol=Z_TOL)
    return bs


def test_kkt_factorizer_solve_matches_reference():
    assert_batch_matches_reference("dense")
