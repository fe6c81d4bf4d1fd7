#!/usr/bin/env python3
"""Print the JAX package's results that the port's multi-phase checks pin.

Runs the JAX package (``lpopc_tpu``) on the CPU in float64 and prints one
JSON line per case:

* ``launch_sweep``: ``bench.py::bench_launch(batch=32)`` as written there —
  ``launch.make_problem()`` at its default mesh, ``IPMOptions(tol=1e-8,
  max_iter=60)``, the pinned initial mass perturbed by
  0.01·U(-1, 1)·var_scale (seed 0): per-instance status, iterations and
  objectives (``chip_smoke.py`` ``LAUNCH_SWEEP_REFERENCE``);
* ``boostbrake_sweep``: ``bench.py::bench_boostbrake(batch=256)`` as written
  there — ``boostbrake.make_problem(degrees=(8,))``, ``IPMOptions(tol=1e-8,
  max_iter=80)``, phase 2's pinned terminal distance lowered by
  0.1·U(0, 1)·zl (seed 0) (``BOOSTBRAKE_SWEEP_REFERENCE``);
* ``launch_jitter`` / ``boostbrake_jitter``: the same sweeps with every
  instance run k times in one batch (k = 8 for the launch, 32 for the
  boost–brake sweep, whose instances are cheap), copy 0 as it is and the
  other copies with the starting point scaled by 1 + 1e-15·U(-1, 1) (seed
  1): the statuses, counts and objectives the JAX package itself takes at a
  rounding-level change of each instance (``ROUNDING_SPREAD_MULTIPHASE``);
* ``boostbrake_jitter_focus``: the boost–brake instances whose count moves
  there (``BOOSTBRAKE_MOVING``), 256 copies each, perturbed the same way: a
  larger sample of the JAX package's own spread where rounding decides;
* ``launch_reduced``: the reduced launch mesh (degrees (4, 4, 4, 5),
  segments (1, 1, 1, 2); n = 256) under the sweep's options and
  perturbation at batch 4 (``tests/test_torch_multiphase.py``
  ``LAUNCH_REDUCED_REFERENCE``);
* ``boostbrake_hp``: ``boostbrake.solve`` with ``SolveOptions(ipm=
  IPMOptions(tol=1e-9, max_iter=300), max_grid_num=6)`` (the options of
  ``tests/test_boostbrake.py``): grids, meshes, per-grid (n, m,
  iterations), objective and q in both phases (``BOOSTBRAKE_HP_REFERENCE``
  in the test and in ``chip_smoke.py``);
* ``launch_solve``: ``launch.make_problem()`` with ``SolveOptions(
  mesh_method="none", max_iterations=400)`` (``tests/test_examples.py``);
* ``climb_tab``: ``climb.make_problem(tabulated=True)`` with
  ``SolveOptions(mesh_method="none")`` (``tests/test_climb.py``);
* ``goddard_three_phase``, ``goddard_single``, ``reentry``, ``tumor_reg``:
  ``goddard.solve_three_phase()``; ``goddard.make_problem(degrees=(6,) * 4)``
  with ``SolveOptions(mesh_method="none", max_iterations=150)``;
  ``reentry.solve`` with ``SolveOptions(mesh_method="none",
  ipm=IPMOptions(tol=1e-6, max_iter=300))`` (the JAX package's tests);
  ``tumor.make_problem_regularized(1e-3)`` under ``tumor.auto_options()``
  (``tests/test_torch_multiphase.py`` ``SOLVE_REFERENCE``).

Usage (from the repository root; the launch cases take many minutes each,
nearly all of it XLA compiles):

    JAX_PLATFORMS=cpu python3 scripts/jax_multiphase_pins.py [case ...]
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
from lpopc_tpu.models import boostbrake, climb, goddard, launch, reentry, tumor  # noqa: E402
from lpopc_tpu.parallel.batch import make_batch_solver  # noqa: E402

REDUCED = dict(degrees_per_phase=(4, 4, 4, 5), segs_per_phase=(1, 1, 1, 2))
# the boost-brake instances whose count moves in ``boostbrake_jitter``
BOOSTBRAKE_MOVING = (4, 7, 10, 71, 72, 89, 90, 112, 178, 180, 188, 223, 231, 242, 245)


def summary(sol):
    return {"status": int(sol.status), "grids": sol.grids, "objective": float(sol.objective),
            "max_relative_error": sol.max_relative_error,
            "per_grid": [(g["n"], g["m"], g["iterations"]) for g in sol.grid_stats],
            "mesh_history": [[[list(d), list(f)] for d, f in grid]
                             for grid in sol.mesh_history]}


def launch_setup(batch, reduced=False):
    """bench.py::bench_launch's perturbation: the pinned initial mass."""
    problem = launch.make_problem(**REDUCED) if reduced else launch.make_problem()
    bs = make_batch_solver(problem, SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60)))
    rng = np.random.default_rng(0)
    z0, zl, zu, cl, cu = bs.nominal_inputs(batch)
    mrow = bs.nlp.layout.phases[0].var_offset + 6
    d = 0.01 * rng.uniform(-1, 1, batch) * bs.scaled.var_scale[mrow]
    zl[:, mrow] += d
    zu[:, mrow] += d
    return bs, [z0, zl, zu, cl, cu]


def boostbrake_setup(batch):
    """bench.py::bench_boostbrake's perturbation: phase 2's terminal distance."""
    bs = make_batch_solver(boostbrake.make_problem(degrees=(8,)),
                           SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=80)))
    rng = np.random.default_rng(0)
    z0, zl, zu, cl, cu = bs.nominal_inputs(batch)
    pl = bs.nlp.layout.phases[1]
    srow = pl.var_offset + (pl.npts - 1) * pl.nx
    d = -0.1 * rng.uniform(0.0, 1.0, batch) * bs.scaled.zl[srow]
    zl[:, srow] += d
    zu[:, srow] += d
    return bs, [z0, zl, zu, cl, cu]


def sweep(setup):
    bs, inputs = setup
    res = bs.run(*inputs)
    return {"n": bs.n, "m": bs.m, "status": np.asarray(res.status).tolist(),
            "iterations": np.asarray(res.iterations).tolist(),
            "objective": np.asarray(res.objective).tolist()}


def jitter(setup, k=8, rows=None):
    bs, inputs = setup
    if rows is not None:
        inputs = [a[list(rows)] for a in inputs]
    rep = [np.repeat(a, k, axis=0) for a in inputs]
    eps = np.random.default_rng(1).uniform(-1e-15, 1e-15, rep[0].shape)
    eps[::k] = 0.0
    rep[0] = rep[0] * (1.0 + eps)
    res = bs.run(*rep)
    return {"k": k, "rows": list(rows) if rows is not None else None,
            "iterations": np.asarray(res.iterations).reshape(-1, k).tolist(),
            "status": np.asarray(res.status).reshape(-1, k).tolist(),
            "objective": np.asarray(res.objective).reshape(-1, k).tolist()}


def boostbrake_hp():
    sol = boostbrake.solve(options=SolveOptions(
        ipm=IPMOptions(tol=1e-9, max_iter=300), max_grid_num=6))
    return {**summary(sol), "q": [float(p.q[0]) for p in sol.phases]}


def launch_solve():
    sol = solve(launch.make_problem(), SolveOptions(mesh_method="none", max_iterations=400))
    return {**summary(sol), "final_mass_kg": launch.final_mass_kg(sol),
            "tf_s": float(sol.phases[3].tf * launch.TU)}


CASES = {
    "launch_sweep": lambda: sweep(launch_setup(32)),
    "boostbrake_sweep": lambda: sweep(boostbrake_setup(256)),
    "launch_jitter": lambda: jitter(launch_setup(32)),
    "boostbrake_jitter": lambda: jitter(boostbrake_setup(256), k=32),
    "boostbrake_jitter_focus": lambda: jitter(boostbrake_setup(256), k=256,
                                              rows=BOOSTBRAKE_MOVING),
    "launch_reduced": lambda: sweep(launch_setup(4, reduced=True)),
    "boostbrake_hp": boostbrake_hp,
    "launch_solve": launch_solve,
    "climb_tab": lambda: summary(solve(climb.make_problem(tabulated=True),
                                       SolveOptions(mesh_method="none"))),
    "goddard_three_phase": lambda: summary(goddard.solve_three_phase()),
    "goddard_single": lambda: summary(solve(goddard.make_problem(degrees=(6,) * 4),
                                            SolveOptions(mesh_method="none",
                                                         max_iterations=150))),
    "reentry": lambda: summary(reentry.solve(options=SolveOptions(
        mesh_method="none", ipm=IPMOptions(tol=1e-6, max_iter=300)))),
    "tumor_reg": lambda: summary(solve(tumor.make_problem_regularized(1e-3),
                                       tumor.auto_options())),
}


def main():
    for name in sys.argv[1:] or [c for c in CASES if not c.endswith("_jitter")]:
        print(json.dumps({"case": name, **CASES[name]()}), flush=True)


if __name__ == "__main__":
    main()
