#!/usr/bin/env python3
"""Print the JAX package's results that the port's singular-arc,
sensitivity, two-stage and MPC checks pin.

Runs the JAX package (``lpopc_tpu``) on the CPU in float64 and prints one
JSON line per case; with ``--write FILE`` it also merges the cases into the
JSON file FILE (``scripts/jax_singular_pins.json``, which
``tests/test_torch_arcs.py``, ``tests/test_torch_diff.py``,
``tests/test_torch_mpc.py`` and ``chip_smoke.py`` read):

* ``goddard_auto``, ``tumor_auto``, ``tumor_auto_decompose``: the
  automatic singular-arc solves at their defaults, ``goddard.solve_auto()``
  (``"decompose"``, degrees (6,) * 6), ``tumor.solve_auto()``
  (``"continuation"``, four rungs) and ``tumor.solve_auto(method=
  "decompose")``: the detected arcs, every ``solve`` of the workflow in
  order (phases, status, grids, per-grid (n, m, iterations), objective), and
  the final solve's status, objective and the model's golden quantity;
* ``goddard_auto_reduced``, ``tumor_auto_reduced``,
  ``tumor_auto_decompose_reduced``: the same at degrees (4,) * 4 with the
  two-rung ladder (1e-2, 1e-3), which the CPU tests run by default;
* ``goddard_decomposed_jitter``: the decomposed solve of
  ``goddard_auto_reduced`` (the rung-0 solve, arc detection and
  ``decompose_by_arcs`` as ``auto_singular_solve`` runs them, then
  ``goddard.three_phase_options()``) 12 times, copy 0 as it is and the
  others with every phase's ``guess_x`` and ``guess_u`` scaled by
  1 + 1e-15·U(-1, 1) (seed 1): the statuses, counts and objectives the JAX
  package itself takes at a rounding-level change of the start
  (``tests/test_torch_arcs.py`` ``ROUNDING_SPREAD_AUTO``);
* ``tumor_rung0_jitter``: the first rung of ``tumor_auto``
  (``tumor.make_problem_regularized(1e-2)`` under ``tumor.auto_options()``)
  12 times, copy 0 as it is and the others with the guess scaled by
  1 + 1e-15·U(-1, 1) (seed 1) (``chip_smoke.py``
  ``ROUNDING_SPREAD_SINGULAR``);
* ``diff_brach``: ``tests/test_diff.py``'s finite-difference case
  (brachistochrone (6, 6), batch 2, the terminal pins moved off-nominal,
  ``IPMOptions(tol=1e-10, max_iter=80)``): the objectives and the gradient
  of their sum with respect to ``zl + zu`` at the terminal pins, through
  ``DifferentiableSolver``;
* ``two_stage_b16``: ``tests/test_two_stage.py``'s batch of 16 (terminal
  targets perturbed by 0.2·U(-1, 1)·var_scale, seed 0; ``IPMOptions(
  tol=1e-8, max_iter=60)``): objectives and iterations of the single-stage
  and of the two-stage solver; ``two_stage_b512``: the same at batch 512
  (``chip_smoke.py``'s sweep); ``two_stage_jitter``: the two-stage sweep's
  instances ``TWO_STAGE_ROWS`` of the 512, 32 copies each, copy 0 as it is
  and the others with the start scaled by 1 + 1e-15·U(-1, 1) (seed 1): the
  JAX package's own spread there (``chip_smoke.py``
  ``ROUNDING_SPREAD_TWO_STAGE``); ``two_stage_jitter_focus``: instance 282,
  256 copies, perturbed the same way;
* ``mpc_round3``: ``tests/test_round3.py``'s controllers of the double
  integrator over 6 steps (cold: ``warm_bound_duals=False``; warm; shift:
  ``shift_dt=0.02``; RTI: ``rti_iters=2, shift_dt=0.02``), per step status,
  iterations and u0; and ``test_mpc_value_gradient``'s first step at
  ``SolveOptions(tol=1e-8)``: objective and ``value_gradient()``, and the
  objective of a fresh controller's first step at x0 = (1 + 1e-5, 0);
* ``mpc_bench``: ``bench.py::bench_mpc`` as written there (30 steps,
  ``SolveOptions(tol=1e-6)``, ``shift_dt=0.02``, B = 1): per step status,
  iterations and u0;
* ``mpc_batch``: 64 plants in one controller, initial states
  (1, 0) + 0.1·U(-1, 1) (seed 0), ``SolveOptions(tol=1e-6, ipm=IPMOptions(
  tol=1e-6, max_iter=SolveOptions().max_iterations, mu_init=1e-2))``,
  ``shift_dt=0.02``, 30 steps: per step the statuses, iterations and u0 of
  all 64 (``chip_smoke.py`` phase ``mpc``, which runs the port with
  ``lane_kkt=True``; the f64 counts do not depend on the route).

Usage (from the repository root; the automatic solves take minutes each,
nearly all of it XLA compiles):

    JAX_PLATFORMS=cpu python3 scripts/jax_singular_pins.py [--write FILE] [case ...]
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from lpopc_tpu.core import solve as solve_mod  # noqa: E402
from lpopc_tpu.core.diff import DifferentiableSolver  # noqa: E402
from lpopc_tpu.core.ipm import IPMOptions  # noqa: E402
from lpopc_tpu.core.problem import Phase, Problem  # noqa: E402
from lpopc_tpu.core.solve import SolveOptions  # noqa: E402
from lpopc_tpu.models import brachistochrone, goddard, tumor  # noqa: E402
from lpopc_tpu.parallel.batch import make_batch_solver  # noqa: E402
from lpopc_tpu.parallel.mpc import MPCController  # noqa: E402

REDUCED = dict(degrees=(4,) * 4, eps_schedule=(1e-2, 1e-3))
MPC_STEPS, MPC_BATCH, MPC_DT = 30, 64, 0.02
# the two-stage sweep's instances where the JAX package or the port ends
# unsolved (two_stage_b512 and chip_smoke.py's sweep_two_stage)
TWO_STAGE_ROWS = (65, 282, 381)


def arcs_summary(arcs):
    return [{"kind": a.kind, "k_start": int(a.k_start), "k_end": int(a.k_end),
             "t_start": float(a.t_start), "t_end": float(a.t_end),
             "oscillations": int(a.oscillations), "mean_abs_hu": float(a.mean_abs_hu)}
            for a in arcs]


def auto_case(model, golden, **kw):
    """``model.solve_auto(**kw)`` with every ``solve`` of the workflow recorded."""
    solves, real = [], solve_mod.solve

    def recorded(problem, options=SolveOptions()):
        sol = real(problem, options)
        solves.append({"phases": len(problem.phases), "status": int(sol.status),
                       "grids": sol.grids, "objective": float(sol.objective),
                       "per_grid": [(g["n"], g["m"], g["iterations"])
                                    for g in sol.grid_stats]})
        return sol

    solve_mod.solve = recorded
    try:
        sol = model.solve_auto(**kw)
    finally:
        solve_mod.solve = real
    return {"arcs": arcs_summary(sol.arcs), "solves": solves, "status": int(sol.status),
            "objective": float(sol.objective), "phases": len(sol.phases),
            "golden": golden(sol)}


def goddard_golden(sol):
    return -float(sol.objective)                  # h(tf)


def tumor_golden(sol):
    return float(sol.objective) * tumor.SCALE     # p(tf)


def goddard_decomposed_jitter(k=12):
    import dataclasses

    from lpopc_tpu.core import arcs as arcs_mod
    from lpopc_tpu.core.decompose import decompose_by_arcs

    sol = solve_mod.solve(goddard.make_problem_regularized(1e-2, REDUCED["degrees"]),
                          goddard.auto_options())
    psol = sol.phases[0]
    ph0 = goddard.make_problem(regularization=0.0).phases[0]
    arcs = arcs_mod.detect_control_arcs(psol.t_col, psol.u[:, 0], 0.0, goddard.T_MAX,
                                        hu=arcs_mod.switching_function(ph0, psol))
    arcs_mod.promote_interior_if_affine(arcs, arcs_mod.control_affinity(ph0, psol))
    dp = decompose_by_arcs(goddard.make_problem(regularization=0.0), psol, arcs)
    rng = np.random.default_rng(1)
    out = {"k": k, "status": [], "iterations": [], "objective": []}
    for copy in range(k):
        phases = []
        for ph in dp.phases:
            ex = rng.uniform(-1e-15, 1e-15, ph.guess_x.shape) if copy else 0.0
            eu = rng.uniform(-1e-15, 1e-15, ph.guess_u.shape) if copy else 0.0
            phases.append(dataclasses.replace(ph, guess_x=ph.guess_x * (1 + ex),
                                              guess_u=ph.guess_u * (1 + eu)))
        s = solve_mod.solve(dataclasses.replace(dp, phases=tuple(phases)),
                            goddard.three_phase_options())
        out["status"].append(int(s.status))
        out["iterations"].append(int(s.iterations))
        out["objective"].append(float(s.objective))
    return out


def jitter_solves(problem, options, k=12, seed=1):
    """``problem`` solved k times, copy 0 as it is and the others with every
    phase's guess (``guess_x``, ``guess_u``, ``guess_q``) scaled by
    1 + 1e-15·U(-1, 1): the statuses, counts and objectives."""
    import dataclasses

    rng = np.random.default_rng(seed)
    out = {"k": k, "status": [], "iterations": [], "objective": []}
    for copy in range(k):
        phases = []
        for ph in problem.phases:
            kw = {}
            for name in ("guess_x", "guess_u", "guess_q"):
                g = getattr(ph, name)
                if g is not None:
                    kw[name] = g * (1 + (rng.uniform(-1e-15, 1e-15, g.shape) if copy else 0.0))
            phases.append(dataclasses.replace(ph, **kw))
        s = solve_mod.solve(dataclasses.replace(problem, phases=tuple(phases)), options)
        out["status"].append(int(s.status))
        out["iterations"].append(int(s.iterations))
        out["objective"].append(float(s.objective))
    return out


def diff_brach():
    bs = make_batch_solver(brachistochrone.make_problem(degrees=(6, 6)),
                           SolveOptions(ipm=IPMOptions(tol=1e-10, max_iter=80)))
    dsol = DifferentiableSolver(bs)
    z0, zl, zu, cl, cu = bs.nominal_inputs(2)
    pl = bs.nlp.layout.phases[0]
    off = pl.var_offset + (pl.npts - 1) * pl.nx
    rows = slice(off, off + 2)
    d = np.array([[0.07, -0.04], [-0.05, 0.06]]) * bs.scaled.var_scale[rows][None, :]
    zl[:, rows] += d
    zu[:, rows] += d
    z0[:, rows] += d
    args = tuple(jnp.asarray(a) for a in (z0, zl, zu, cl, cu))

    def loss(zl_, zu_):
        return jnp.sum(dsol(args[0], zl_, zu_, args[3], args[4])[3])

    g_zl, g_zu = jax.grad(loss, argnums=(0, 1))(args[1], args[2])
    obj = np.asarray(dsol(*args)[3])
    return {"rows": [rows.start, rows.stop], "objective": obj.tolist(),
            "grad": np.asarray(g_zl + g_zu)[:, rows].tolist()}


def two_stage_setup(batch):
    """The single- and two-stage solvers and tests/test_two_stage.py's inputs."""
    problem = brachistochrone.make_problem(degrees=(6, 6))
    opts = SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60))
    bs1 = make_batch_solver(problem, opts)
    bs2 = make_batch_solver(problem, opts, two_stage=True)
    rng = np.random.default_rng(0)
    z0, zl, zu, cl, cu = bs1.nominal_inputs(batch)
    pl = bs1.nlp.layout.phases[0]
    first = pl.var_offset + (pl.npts - 1) * pl.nx
    xf = slice(first, first + 2)
    pert = 0.2 * rng.uniform(-1, 1, (batch, 2)) * bs1.scaled.var_scale[xf][None, :]
    zl[:, xf] += pert
    zu[:, xf] += pert
    return bs1, bs2, [z0, zl, zu, cl, cu]


def fields(res):
    return {"status": np.asarray(res.status).tolist(),
            "iterations": np.asarray(res.iterations).tolist(),
            "objective": np.asarray(res.objective).tolist()}


def two_stage_b16(batch=16):
    bs1, bs2, args = two_stage_setup(batch)
    args = tuple(jnp.asarray(a) for a in args)
    return {"single": fields(bs1.run(*args)), "two_stage": fields(bs2.run(*args))}


def two_stage_jitter(rows=TWO_STAGE_ROWS, k=32):
    """The two-stage sweep's ``rows`` of the 512, k copies each, copy 0 as it
    is and the others with the start z0 scaled by 1 + 1e-15·U(-1, 1) (seed 1)."""
    _, bs2, args = two_stage_setup(512)
    rep = [np.repeat(a[list(rows)], k, axis=0) for a in args]
    eps = np.random.default_rng(1).uniform(-1e-15, 1e-15, rep[0].shape)
    eps[::k] = 0.0
    rep[0] = rep[0] * (1.0 + eps)
    out = fields(bs2.run(*(jnp.asarray(a) for a in rep)))
    return {"k": k, "rows": list(rows),
            **{key: np.asarray(v).reshape(len(rows), k).tolist() for key, v in out.items()}}


def double_integrator():
    """``tests/test_round3.py::_double_integrator`` and ``bench.py::bench_mpc``'s plant."""
    return Problem(phases=(Phase(
        nx=2, nu=1,
        dynamics=lambda x, u, t, q: jnp.array([x[1], u[0]]),
        lagrange=lambda x, u, t, q: 0.5 * u[0] ** 2 + x[0] ** 2,
        x0_bounds=(np.array([1.0, 0.0]), np.array([1.0, 0.0])),
        xf_bounds=(np.zeros(2), np.zeros(2)),
        x_bounds=(np.full(2, -10.0), np.full(2, 10.0)),
        u_bounds=(-50.0, 50.0), t0_bounds=(0.0, 0.0), tf_bounds=(1.0, 1.0),
        mesh_degrees=(8,), mesh_fractions=(-1.0, 1.0),
    ),))


def closed_loop(ctrl, x, steps):
    """Run ``ctrl`` for ``steps`` steps from x (nx,) or (B, nx), the plant
    advanced by x += dt·(x1, u0); per step status, iterations, u0."""
    out = {"status": [], "iterations": [], "u0": []}
    x = np.array(x, dtype=np.float64)
    for _ in range(steps):
        u0, info = ctrl.step(x)
        u0 = np.asarray(u0, dtype=np.float64)
        out["status"].append(np.asarray(info["status"]).tolist())
        out["iterations"].append(np.asarray(info["iterations"]).tolist())
        out["u0"].append(u0.reshape(-1).tolist())
        if x.ndim == 1:
            x = x + MPC_DT * np.array([x[1], float(u0[0])])
        else:
            x = x + MPC_DT * np.stack([x[:, 1], u0[:, 0]], axis=1)
    return out


def mpc_round3():
    out = {}
    for name, kw in (("cold", dict(warm_bound_duals=False)), ("warm", {}),
                     ("shift", dict(shift_dt=MPC_DT)),
                     ("rti", dict(rti_iters=2, shift_dt=MPC_DT))):
        ctrl = MPCController(double_integrator(), SolveOptions(tol=1e-6), **kw)
        out[name] = closed_loop(ctrl, [1.0, 0.0], 6)
    ctrl = MPCController(double_integrator(), SolveOptions(tol=1e-8))
    _, info = ctrl.step(np.array([1.0, 0.0]))
    _, info_h = MPCController(double_integrator(), SolveOptions(tol=1e-8)).step(
        np.array([1.0 + 1e-5, 0.0]))
    out["value_gradient"] = {"objective": float(info["objective"][0]),
                             "iterations": int(info["iterations"][0]),
                             "gradient": np.asarray(ctrl.value_gradient()).tolist(),
                             "objective_h": float(info_h["objective"][0]), "h": 1e-5}
    return out


def mpc_bench():
    ctrl = MPCController(double_integrator(), SolveOptions(tol=1e-6), shift_dt=MPC_DT)
    return closed_loop(ctrl, [1.0, 0.0], MPC_STEPS)


def mpc_batch():
    x0 = np.array([1.0, 0.0]) + 0.1 * np.random.default_rng(0).uniform(-1, 1, (MPC_BATCH, 2))
    opts = SolveOptions(tol=1e-6, ipm=IPMOptions(
        tol=1e-6, max_iter=SolveOptions().max_iterations, mu_init=1e-2))
    ctrl = MPCController(double_integrator(), opts, batch=MPC_BATCH, shift_dt=MPC_DT)
    out = closed_loop(ctrl, x0, MPC_STEPS)
    out["value_gradient"] = np.asarray(ctrl.value_gradient()).tolist()
    return out


CASES = {
    "goddard_auto": lambda: auto_case(goddard, goddard_golden),
    "tumor_auto": lambda: auto_case(tumor, tumor_golden),
    "tumor_auto_decompose": lambda: auto_case(tumor, tumor_golden, method="decompose"),
    "goddard_auto_reduced": lambda: auto_case(goddard, goddard_golden, **REDUCED),
    "tumor_auto_reduced": lambda: auto_case(tumor, tumor_golden, **REDUCED),
    "tumor_auto_decompose_reduced": lambda: auto_case(tumor, tumor_golden,
                                                      method="decompose", **REDUCED),
    "goddard_decomposed_jitter": goddard_decomposed_jitter,
    "tumor_rung0_jitter": lambda: jitter_solves(tumor.make_problem_regularized(1e-2),
                                                tumor.auto_options()),
    "diff_brach": diff_brach,
    "two_stage_b16": two_stage_b16,
    "two_stage_b512": lambda: two_stage_b16(512),
    "two_stage_jitter": two_stage_jitter,
    "two_stage_jitter_focus": lambda: two_stage_jitter(rows=(282,), k=256),
    "mpc_round3": mpc_round3,
    "mpc_bench": mpc_bench,
    "mpc_batch": mpc_batch,
}


def main():
    args = sys.argv[1:]
    path = None
    if args[:1] == ["--write"]:
        path, args = args[1], args[2:]
    for name in args or list(CASES):
        line = {"case": name, **CASES[name]()}
        print(json.dumps(line), flush=True)
        if path is not None:
            pins = {}
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    pins = json.load(f)
            pins[name] = {k: v for k, v in line.items() if k != "case"}
            with open(path, "w", encoding="utf-8") as f:
                f.write("{\n" + ",\n".join(f"{json.dumps(k)}: {json.dumps(pins[k])}"
                                            for k in sorted(pins)) + "\n}\n")


if __name__ == "__main__":
    main()
