"""Port parity: the batched interior-point solver on HS071 (B = 3), against
the JAX solver under vmap — same status and iteration count per instance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpopc_tpu.core import ipm as ref_ipm
from lpopc_tpu.core import solve as ref_solve
from lpopc_tpu_torch.core import ipm as port_ipm
from lpopc_tpu_torch.core import options as port_options
from lpopc_tpu_torch.core import solve as port_solve

B = 3
Z_TOL = 1e-6      # as tests/test_lane_kkt.py
BOUNDS = (
    np.ones((B, 4)), np.full((B, 4), 5.0),
    np.tile([25.0, 40.0], (B, 1)), np.tile([ref_ipm.INF, 40.0], (B, 1)),
)
STARTS = {
    # the batch of tests/test_lane_kkt.py: three copies of the standard start
    "same": np.tile([1.0, 5.0, 5.0, 1.0], (B, 1)),
    # three different starts: the instances converge at different iterations,
    # so the early ones freeze while the others go on
    "ragged": np.array([[1.0, 5.0, 5.0, 1.0], [2.0, 4.0, 3.0, 2.0], [4.5, 1.2, 4.9, 1.1]]),
}
VARIANTS = {
    "apply": dict(),
    "lane": dict(lane_kkt=True),
    "library_monotone_soc_watchdog": dict(
        mu_strategy="monotone", soc=True, watchdog=True, record_history=True,
        inverse_threshold=1),
    "adaptive_parallel_ls": dict(mu_strategy="adaptive", ls_mode="parallel"),
}


def _ref_solver(**kw):
    obj = lambda z: z[0] * z[3] * (z[0] + z[1] + z[2]) + z[2]
    con = lambda z: jnp.array([z[0] * z[1] * z[2] * z[3], jnp.sum(z ** 2)])
    return ref_ipm.build_solver(
        obj, con, 4, 2, ref_ipm.IPMOptions(tol=1e-8, max_iter=60, **kw))


def _port_solver(**kw):
    obj = lambda z: z[0] * z[3] * (z[0] + z[1] + z[2]) + z[2]
    con = lambda z: torch.stack([z[0] * z[1] * z[2] * z[3], (z ** 2).sum()])
    return port_ipm.build_solver(
        obj, con, 4, 2, port_ipm.IPMOptions(tol=1e-8, max_iter=60, **kw))


@pytest.fixture(scope="module")
def reference():
    """JAX results, one compile per variant, both start sets through it."""
    out = {}
    for name, kw in VARIANTS.items():
        run = jax.jit(jax.vmap(_ref_solver(**kw)))
        for sname, z0 in STARTS.items():
            res = run(jnp.asarray(z0), *(jnp.asarray(a) for a in BOUNDS))
            out[(name, sname)] = jax.tree_util.tree_map(np.asarray, res)
    return out


@pytest.mark.parametrize("starts", sorted(STARTS))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_hs071_matches_reference(reference, variant, starts):
    ref = reference[(variant, starts)]
    solve = _port_solver(**VARIANTS[variant])
    res = solve(torch.as_tensor(STARTS[starts]), *(torch.as_tensor(a) for a in BOUNDS))
    assert res.status.tolist() == ref.status.tolist() == [port_ipm.SOLVED] * B
    assert res.iterations.tolist() == ref.iterations.tolist()
    np.testing.assert_allclose(res.z.numpy(), ref.z, rtol=0, atol=Z_TOL)
    np.testing.assert_allclose(res.objective.numpy(), 17.0140173, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.lam.numpy(), ref.lam, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.kkt_error.numpy(), ref.kkt_error, rtol=0, atol=1e-8)
    if VARIANTS[variant].get("record_history"):
        for key in ("mu", "alpha", "ls_iters", "reg_k"):
            np.testing.assert_allclose(
                res.history[key].numpy(), ref.history[key], rtol=1e-6, atol=1e-9)
    assert solve.host_syncs > 0 and solve.outer_iterations == int(ref.iterations.max())


def test_warm_duals_and_runtime_tol_match_reference(reference):
    ref = reference[("apply", "same")]
    run = jax.vmap(
        lambda z0, zl, zu, cl, cu, lam0, zld, zud, tol: _ref_solver()(
            z0, zl, zu, cl, cu, lam0, zl_d_init=zld, zu_d_init=zud, tol=tol))
    tol = np.array([1e-8, 1e-6, 1e-4])
    warm_ref = run(jnp.asarray(ref.z), *(jnp.asarray(a) for a in BOUNDS),
                   jnp.asarray(ref.lam), jnp.asarray(ref.zl_dual),
                   jnp.asarray(ref.zu_dual), jnp.asarray(tol))
    t = torch.as_tensor
    warm = _port_solver()(
        t(ref.z), *(t(a) for a in BOUNDS), lam0=t(ref.lam),
        zl_d_init=t(ref.zl_dual), zu_d_init=t(ref.zu_dual), tol=t(tol))
    assert warm.status.tolist() == np.asarray(warm_ref.status).tolist()
    assert warm.iterations.tolist() == np.asarray(warm_ref.iterations).tolist()
    assert int(warm.iterations.max()) < int(ref.iterations.max())
    np.testing.assert_allclose(warm.z.numpy(), np.asarray(warm_ref.z), rtol=0, atol=Z_TOL)


def test_f32_factorization_solves():
    """f32 factors + f64 refinement reach the f64 optimum. (Iteration counts
    are not compared: the inertia test then rides on f32 rounding noise,
    which differs between the two libraries' factorizations.)"""
    for lane in (False, True):
        res = _port_solver(factor_dtype="f32", lane_kkt=lane)(
            torch.as_tensor(STARTS["same"]), *(torch.as_tensor(a) for a in BOUNDS))
        assert res.status.tolist() == [port_ipm.SOLVED] * B
        assert res.z.dtype == torch.float64
        np.testing.assert_allclose(res.objective.numpy(), 17.0140173, rtol=0, atol=1e-5)


def test_explicit_soc_or_watchdog_with_parallel_line_search_raises():
    for kw in (dict(soc=True), dict(watchdog=True)):
        with pytest.raises(ValueError, match="sequential"):
            _port_solver(ls_mode="parallel", **kw)
    _port_solver(ls_mode="parallel")   # soc=None is a surface default: fine


# a block spec for HS071's four variables: its K is dense, so one interior
# block {0, 1, 2} (with a padded fourth slot) and the border {3}
HS071_SPEC = dict(interior_idx=np.array([[0, 1, 2, 0]], np.int32),
                  interior_mask=np.array([[True, True, True, False]]),
                  border_idx=np.array([3], np.int32), n=4)


def _ref_hooks(hook):
    from lpopc_tpu.core.block_kkt import BlockKKTSpec, make_block_factorizer
    from lpopc_tpu.core.kkt_blocks import BoundKKT

    fact = make_block_factorizer(BlockKKTSpec(**HS071_SPEC))
    if hook == "kkt_factorizer":
        return dict(kkt_factorizer=fact)
    obj = lambda z: z[0] * z[3] * (z[0] + z[1] + z[2]) + z[2]
    con = lambda z: jnp.array([z[0] * z[1] * z[2] * z[3], jnp.sum(z ** 2)])
    return dict(structured_kkt=BoundKKT(
        jac_blocks=jax.jacfwd(con),
        hess_blocks=jax.hessian(lambda z, lam: obj(z) + jnp.dot(lam, con(z))),
        jv=lambda J, v: J @ v, jtv=lambda J, u: J.T @ u, hv=lambda H, v: H @ v,
        factorize=lambda J, H, d, w: fact[0](H + jnp.diag(w) + (J.T * d) @ J),
        fsolve=fact[1], factor_ok=fact[2]))


def _port_hooks(hook, calls):
    from torch.func import hessian, jacfwd, vmap

    from lpopc_tpu_torch.core.block_kkt import BlockKKTSpec, make_block_factorizer
    from lpopc_tpu_torch.core.kkt_blocks import BoundKKT

    factorize, fsolve, factor_ok = make_block_factorizer(BlockKKTSpec(**HS071_SPEC))

    def counted(K):
        calls.append(K.shape)
        return factorize(K)

    if hook == "kkt_factorizer":
        return dict(kkt_factorizer=(counted, fsolve, factor_ok))
    obj = lambda z: z[0] * z[3] * (z[0] + z[1] + z[2]) + z[2]
    con = lambda z: torch.stack([z[0] * z[1] * z[2] * z[3], (z ** 2).sum()])
    mv = lambda M, v: torch.bmm(M, v.unsqueeze(-1)).squeeze(-1)
    return dict(structured_kkt=BoundKKT(
        jac_blocks=vmap(jacfwd(con)),
        hess_blocks=vmap(hessian(lambda z, lam: obj(z) + torch.dot(lam, con(z)))),
        jv=mv, jtv=lambda J, u: mv(J.transpose(1, 2), u), hv=mv,
        factorize=lambda J, H, d, w: counted(
            H + torch.diag_embed(w) + (J.transpose(1, 2) * d[:, None, :]) @ J),
        fsolve=fsolve, factor_ok=factor_ok))


# (hook, start) -> (the JAX package's count, the port's) where rounding
# decides the count (ROADMAP Queue 3, entry 3): under structured_kkt the
# JAX package takes 23–37 iterations from the third start scaled by
# 1 + 1e-15·U(-1, 1), and 21 from the start alone (`scripts/jax_block_pins.py
# hs071_jitter`), so the known difference is pinned on both sides.
ROUNDING_DECIDED = {("structured_kkt", 2): (24, 22)}


@pytest.mark.parametrize("hook", ["kkt_factorizer", "structured_kkt"])
def test_block_hooks_take_the_block_path(hook):
    """``kkt_factorizer`` (a block factorizer of the equilibrated K) and
    ``structured_kkt`` (matrix-free closures, here around HS071's dense
    J and H) are taken in place of the dense route, with lane_kkt=True too:
    the solves factor through the block factorization and take the JAX
    package's iterations under the same hooks (``vmap``), exactly, apart
    from the pinned pair in ``ROUNDING_DECIDED``."""
    ref_solve = ref_ipm.build_solver(
        lambda z: z[0] * z[3] * (z[0] + z[1] + z[2]) + z[2],
        lambda z: jnp.array([z[0] * z[1] * z[2] * z[3], jnp.sum(z ** 2)]),
        4, 2, ref_ipm.IPMOptions(tol=1e-8, max_iter=60), **_ref_hooks(hook))
    inputs = (STARTS["ragged"], *BOUNDS)
    ref = jax.jit(jax.vmap(ref_solve))(*(jnp.asarray(a) for a in inputs))
    calls = []
    solve = port_ipm.build_solver(
        lambda z: z[0] * z[3] * (z[0] + z[1] + z[2]) + z[2],
        lambda z: torch.stack([z[0] * z[1] * z[2] * z[3], (z ** 2).sum()]),
        4, 2, port_ipm.IPMOptions(tol=1e-8, max_iter=60, lane_kkt=True),
        **_port_hooks(hook, calls))
    res = solve(torch.as_tensor(STARTS["ragged"]), *(torch.as_tensor(a) for a in BOUNDS))
    assert calls and all(shape == (B, 4, 4) for shape in calls)
    assert res.status.tolist() == np.asarray(ref.status).tolist() == [port_ipm.SOLVED] * B
    for i, (want, got) in enumerate(zip(np.asarray(ref.iterations).tolist(),
                                        res.iterations.tolist())):
        assert (want, got) == ROUNDING_DECIDED.get((hook, i), (want, want)), i
    np.testing.assert_allclose(res.z.numpy(), np.asarray(ref.z), rtol=0, atol=Z_TOL)
    # takes_aux: structured_kkt is then a factory aux -> BoundKKT
    if hook == "structured_kkt":
        hooks = _port_hooks(hook, calls)
        aux_solve = port_ipm.build_solver(
            lambda z, aux: z[0] * z[3] * (z[0] + z[1] + z[2]) + z[2],
            lambda z, aux: torch.stack([z[0] * z[1] * z[2] * z[3], (z ** 2).sum()]),
            4, 2, port_ipm.IPMOptions(tol=1e-8, max_iter=60), takes_aux=True,
            structured_kkt=lambda aux: hooks["structured_kkt"])
        res_aux = aux_solve(torch.as_tensor(STARTS["ragged"]),
                            *(torch.as_tensor(a) for a in BOUNDS), aux={})
        assert res_aux.iterations.tolist() == res.iterations.tolist()


def test_option_defaults_are_the_reference_defaults():
    for port_cls, ref_cls in ((port_ipm.IPMOptions, ref_ipm.IPMOptions),
                              (port_solve.SolveOptions, ref_solve.SolveOptions)):
        pf = {f.name: f.default for f in dataclasses.fields(port_cls)}
        rf = {f.name: f.default for f in dataclasses.fields(ref_cls)}
        assert pf == rf
    assert (port_ipm.RUNNING, port_ipm.SOLVED, port_ipm.MAX_ITER, port_ipm.FAILED) == (
        ref_ipm.RUNNING, ref_ipm.SOLVED, ref_ipm.MAX_ITER, ref_ipm.FAILED)
    o = port_solve.SolveOptions(tol=1e-6, max_iterations=50, iteration_log_dir="x")
    r = ref_solve.SolveOptions(tol=1e-6, max_iterations=50, iteration_log_dir="x")
    assert dataclasses.asdict(o.ipm_options()) == dataclasses.asdict(r.ipm_options())


def test_option_registry_validates():
    from lpopc_tpu.core import options as ref_options

    assert [s.name for s in port_options.REGISTRY] == [s.name for s in ref_options.REGISTRY]
    assert [s.default for s in port_options.REGISTRY] == [s.default for s in ref_options.REGISTRY]
    port_options.validate(port_solve.SolveOptions())
    with pytest.raises(port_options.OptionError):
        port_options.validate(port_solve.SolveOptions(mu_strategy="nope"))
    with pytest.raises(port_options.OptionError):
        port_options.validate(port_solve.SolveOptions(n_min=9, n_max=5))
    got = port_options.from_reference_strings({"Ipopt-tol": 1e-6, "max-grid-num": 20})
    assert (got.tol, got.max_grid_num) == (1e-6, 20)
