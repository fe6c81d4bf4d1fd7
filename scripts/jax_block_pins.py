#!/usr/bin/env python3
"""Print the JAX package's results that the port's block-KKT checks pin.

Runs the JAX package (``lpopc_tpu``) on the CPU in float64 and prints one
JSON line per case:

* ``hp_auto``: hypersensitive at tf = 5000, ph refinement, under the default
  ``block_kkt="auto"`` (``chip_smoke.py`` ``HP_BLOCK_REFERENCE``);
* ``sweep_direct`` / ``sweep_dense``: the 64-instance brachistochrone sweep
  at degrees (16,) * 11 under both block assemblies (``chip_smoke.py``
  ``REFERENCE_ITERATIONS_BLOCK*``, ``REFERENCE_OBJECTIVES_BLOCK``);
* ``sweep_trace``: the same sweep with ``record_history=True`` under both
  assemblies, and instances 2, 41 and 45 each as a batch of one, with their
  per-iteration histories (the twin of ``scripts/torch_block_trace.py``);
* ``sweep_jitter``: the same sweep with every instance run 8 times in one
  batch, copy 0 as it is and copies 1..7 with the starting point scaled by
  1 + 1e-15·U(-1, 1) (seed 1; the perturbation of
  ``scripts/torch_block_trace.py --jitter 8``), under both assemblies: the
  counts the JAX package itself takes at a rounding-level change of each
  instance (``chip_smoke.py`` ``ROUNDING_SPREAD_BLOCK``);
* ``hs071_jitter``: HS071 from the three starts of
  ``tests/test_torch_ipm.py``, through the ``structured_kkt`` hook of
  ``test_block_hooks_take_the_block_path`` (its one-block spec), under
  ``vmap`` as they stand, each start alone, and each start 16 times with
  copies 1..15 scaled by 1 + 1e-15·U(-1, 1) (seed 1)
  (``ROUNDING_DECIDED`` there);
* ``bryson_direct`` / ``bryson_dense``: brysondenham (4, 4) with
  ``block_kkt="on"``, and ``auto_large``: hypersensitive at tf = 40 on
  degrees (16,) * 22 (``tests/test_torch_solve.py`` ``BLOCK_REFERENCE``).

Usage (from the repository root; several minutes, mostly XLA compiles):

    JAX_PLATFORMS=cpu python3 scripts/jax_block_pins.py [case ...]
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from lpopc_tpu.core.ipm import IPMOptions  # noqa: E402
from lpopc_tpu.core.solve import SolveOptions, solve  # noqa: E402
from lpopc_tpu.models import brachistochrone, brysondenham, hypersensitive  # noqa: E402
from lpopc_tpu.parallel.batch import make_batch_solver  # noqa: E402


def summary(sol):
    return {"status": int(sol.status), "grids": sol.grids, "objective": float(sol.objective),
            "max_relative_error": sol.max_relative_error,
            "per_grid": [(g["n"], g["m"], g["iterations"]) for g in sol.grid_stats],
            "mesh_history": [[list(d), list(f)] for ((d, f),) in sol.mesh_history]}


def hp_auto():
    return summary(solve(hypersensitive.make_problem(tf=5000.0), SolveOptions(
        mesh_method="ph", tol=1e-8, max_grid_num=20, desired_relative_error=1e-6, n_max=16,
        ipm=IPMOptions(tol=1e-8, max_iter=300))))


def sweep_setup(assembly, record_history=False):
    """The bench perturbation (terminal target, 0.2·U(-1,1)·var_scale, seed 0)."""
    batch = 64
    bs = make_batch_solver(brachistochrone.make_problem(degrees=(16,) * 11), SolveOptions(
        ipm=IPMOptions(tol=1e-8, max_iter=60, record_history=record_history),
        block_assembly=assembly))
    rng = np.random.default_rng(0)
    z0, zl, zu, cl, cu = bs.nominal_inputs(batch)
    pl = bs.nlp.layout.phases[0]
    first = pl.var_offset + (pl.npts - 1) * pl.nx
    rows = slice(first, first + 2)
    pert = 0.2 * rng.uniform(-1, 1, (batch, 2)) * bs.scaled.var_scale[rows][None, :]
    zl[:, rows] += pert
    zu[:, rows] += pert
    return bs, (z0, zl, zu, cl, cu)


def sweep(assembly):
    bs, inputs = sweep_setup(assembly)
    res = bs.run(*inputs)
    return {"n": bs.n, "m": bs.m, "status": np.asarray(res.status).tolist(),
            "iterations": np.asarray(res.iterations).tolist(),
            "objective": np.asarray(res.objective).tolist()}


TRACE_KEYS = ("kkt", "mu", "theta", "alpha", "alpha_max", "delta_w", "reg_k", "ls_iters",
              "lin_err", "dphi", "step_inf", "r0", "r_end")


def sweep_trace(instances=(2, 41, 45)):
    def traced(res, rows, names):
        it = np.asarray(res.iterations).tolist()
        hist = {k: np.asarray(v) for k, v in res.history.items()}
        return {"iterations": it, "history": {
            str(i): {k: hist[k][r, : it[r]].tolist() for k in TRACE_KEYS if k in hist}
            for i, r in zip(names, rows)}}

    out = {"instances": list(instances)}
    for assembly in ("direct", "dense"):
        bs, inputs = sweep_setup(assembly, record_history=True)
        out[assembly] = traced(bs.run(*inputs), instances, instances)
        out[assembly + "_alone"] = {
            str(i): traced(bs.run(*(a[i : i + 1] for a in inputs)), [0], [i])
            for i in instances}
    return out


def sweep_jitter(k=8):
    out = {}
    for assembly in ("direct", "dense"):
        bs, inputs = sweep_setup(assembly)
        rep = [np.repeat(a, k, axis=0) for a in inputs]
        eps = np.random.default_rng(1).uniform(-1e-15, 1e-15, rep[0].shape)
        eps[::k] = 0.0
        rep[0] = rep[0] * (1.0 + eps)
        out[assembly] = np.asarray(bs.run(*rep).iterations).reshape(-1, k).tolist()
    return out


def hs071_jitter(k=16):
    import jax.numpy as jnp

    from lpopc_tpu.core import ipm
    from lpopc_tpu.core.block_kkt import BlockKKTSpec, make_block_factorizer
    from lpopc_tpu.core.kkt_blocks import BoundKKT

    obj = lambda z: z[0] * z[3] * (z[0] + z[1] + z[2]) + z[2]
    con = lambda z: jnp.array([z[0] * z[1] * z[2] * z[3], jnp.sum(z ** 2)])
    fact = make_block_factorizer(BlockKKTSpec(
        interior_idx=np.array([[0, 1, 2, 0]], np.int32),
        interior_mask=np.array([[True, True, True, False]]),
        border_idx=np.array([3], np.int32), n=4))
    sk = BoundKKT(
        jac_blocks=jax.jacfwd(con),
        hess_blocks=jax.hessian(lambda z, lam: obj(z) + jnp.dot(lam, con(z))),
        jv=lambda J, v: J @ v, jtv=lambda J, u: J.T @ u, hv=lambda H, v: H @ v,
        factorize=lambda J, H, d, w: fact[0](H + jnp.diag(w) + (J.T * d) @ J),
        fsolve=fact[1], factor_ok=fact[2])
    solver = ipm.build_solver(obj, con, 4, 2, ipm.IPMOptions(tol=1e-8, max_iter=60),
                              structured_kkt=sk)
    starts = np.array([[1.0, 5.0, 5.0, 1.0], [2.0, 4.0, 3.0, 2.0], [4.5, 1.2, 4.9, 1.1]])
    b = len(starts)
    bounds = [np.ones((b, 4)), np.full((b, 4), 5.0),
              np.tile([25.0, 40.0], (b, 1)), np.tile([ipm.INF, 40.0], (b, 1))]
    batched = jax.jit(jax.vmap(solver))
    rep = [np.repeat(a, k, axis=0) for a in (starts, *bounds)]
    eps = np.random.default_rng(1).uniform(-1e-15, 1e-15, rep[0].shape)
    eps[::k] = 0.0
    rep[0] = rep[0] * (1.0 + eps)
    alone = jax.jit(solver)
    return {
        "vmap": np.asarray(batched(*(jnp.asarray(a) for a in (starts, *bounds))).iterations).tolist(),
        "alone": [int(alone(*(jnp.asarray(a[i]) for a in (starts, *bounds))).iterations)
                  for i in range(b)],
        "jitter": np.asarray(batched(*(jnp.asarray(a) for a in rep)).iterations).reshape(
            b, k).tolist()}


def bryson(assembly):
    return summary(solve(brysondenham.make_problem(degrees=(4, 4)), SolveOptions(
        mesh_method="none", block_kkt="on", block_assembly=assembly,
        ipm=IPMOptions(tol=1e-8, max_iter=300))))


CASES = {
    "hp_auto": hp_auto,
    "sweep_direct": lambda: sweep("direct"),
    "sweep_dense": lambda: sweep("dense"),
    "sweep_trace": sweep_trace,
    "sweep_jitter": sweep_jitter,
    "hs071_jitter": hs071_jitter,
    "bryson_direct": lambda: bryson("direct"),
    "bryson_dense": lambda: bryson("dense"),
    "auto_large": lambda: summary(solve(
        hypersensitive.make_problem(tf=40.0, degrees=(16,) * 22),
        SolveOptions(mesh_method="none", ipm=IPMOptions(tol=1e-8, max_iter=300)))),
}


def main():
    for name in sys.argv[1:] or [c for c in CASES if not c.endswith(("_trace", "_jitter"))]:
        print(json.dumps({"case": name, **CASES[name]()}), flush=True)


if __name__ == "__main__":
    main()
