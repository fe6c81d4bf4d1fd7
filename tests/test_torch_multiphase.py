"""Port parity: the multi-phase models and the paths they open.

* Every model of the multi-phase slice (launch, boost–brake, climb, reentry,
  hang glider, Goddard, tumor), in the variant that exercises the most of
  the transcription (tables, linkages that drop mass or carry a shared
  parameter, time links between free switch times, a path constraint, a
  pinned parameter), transcribed by both packages on a small mesh and
  compared at the guess: layout, bounds, guess, scale vectors, objective,
  constraints, the structured Jacobian and the structured Hessian, to
  1e-12 relative. No solve is involved.
* The boost–brake hp solve (two linked phases, per-phase refinement) and a
  4-instance batch sweep of the reduced launch mesh, against the JAX
  package's results pinned below. The JAX package compiles each grid of
  these (the hp solve about 7 minutes and the reduced batch about 4 on a
  busy 8-core CPU), so they are pinned with
  ``scripts/jax_multiphase_pins.py`` (cases ``boostbrake_hp`` and
  ``launch_reduced``) instead of being compiled here.
* Goddard's single-phase and three-phase solves against the JAX package's
  per-grid iterations and objective (pinned by the same script).
* The goldens of the larger solves (``slow``): the full-mesh launch, reentry,
  the hang glider and the three-phase Goddard rocket, each as the JAX
  package's own tests hold it (and, but for the hang glider's eight grids,
  against the JAX package's pinned run). The full-width launch is checked
  against the JAX package's run on the GPU by ``chip_smoke.py``
  (``solve_multiphase``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpopc_tpu.core import structured as ref_st
from lpopc_tpu.core.scaling import scale_nlp as ref_scale
from lpopc_tpu.core.transcribe import transcribe as ref_transcribe
from lpopc_tpu_torch.core import structured as port_st
from lpopc_tpu_torch.core.ipm import SOLVED, IPMOptions
from lpopc_tpu_torch.core.scaling import scale_nlp as port_scale
from lpopc_tpu_torch.core.solve import SolveOptions, solve
from lpopc_tpu_torch.core.transcribe import transcribe as port_transcribe
from lpopc_tpu_torch.models import boostbrake, goddard, hangglider, launch, reentry
from lpopc_tpu_torch.parallel.batch import make_batch_solver

REL_TOL = 1e-12

# name -> (module, factory, keyword arguments): the same call on both sides
MODELS = {
    "launch": ("launch", "make_problem",
               dict(degrees_per_phase=(3, 3, 3, 4), segs_per_phase=(1, 1, 1, 1))),
    "boostbrake": ("boostbrake", "make_problem", dict(tabulated=True, degrees=(4, 3))),
    "climb": ("climb", "make_problem", dict(tabulated=True, degrees=(4, 4))),
    "reentry": ("reentry", "make_problem", dict(heat_limit=70.0, degrees=(4, 4))),
    "hangglider": ("hangglider", "make_problem", dict(degrees=(4, 4))),
    "goddard": ("goddard", "make_problem_three_phase", dict(degrees=((3,), (2, 2), (3,)))),
    "tumor": ("tumor", "make_problem_regularized", dict(eps=1e-3, degrees=(4, 4))),
}


def rel_err(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if want.size == 0:
        return 0.0
    scale = np.max(np.abs(want))
    return float(np.max(np.abs(got - want)) / (scale if scale > 0 else 1.0))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_transcription_matches_reference_at_the_guess(name):
    mod, factory, kw = MODELS[name]
    ref = ref_transcribe(getattr(importlib.import_module(f"lpopc_tpu.models.{mod}"), factory)(**kw))
    port = port_transcribe(
        getattr(importlib.import_module(f"lpopc_tpu_torch.models.{mod}"), factory)(**kw),
        device="cpu")
    # layout: per-phase offsets (what the bench perturbations index), links
    assert (port.n, port.m) == (ref.n, ref.m)
    for pp, rp in zip(port.layout.phases, ref.layout.phases):
        assert (pp.var_offset, pp.con_offset, pp.npts, pp.nx, pp.nu, pp.nq, pp.ncon) == (
            rp.var_offset, rp.con_offset, rp.npts, rp.nx, rp.nu, rp.nq, rp.ncon)
    assert port.layout.link_offsets == ref.layout.link_offsets
    assert port.layout.linear_offset == ref.layout.linear_offset
    for field in ("zl", "zu", "cl", "cu", "z0"):
        assert rel_err(getattr(port, field), getattr(ref, field)) <= REL_TOL, field
    sr = ref_scale(ref.objective, ref.constraints, ref.zl, ref.zu, ref.cl, ref.cu, ref.z0)
    sp = port_scale(port.objective, port.constraints, port.zl, port.zu, port.cl, port.cu,
                    port.z0, device="cpu")
    assert rel_err(sp.obj_scale, sr.obj_scale) <= REL_TOL
    for field in ("var_scale", "con_scale"):
        assert rel_err(getattr(sp, field), getattr(sr, field)) <= REL_TOL, field

    z = ref.z0
    lam = np.random.default_rng(3).standard_normal(ref.m)
    jac_r = ref_st.make_structured_jacobian(ref.problem, ref.layout, ref.ops)
    hess_r = ref_st.make_structured_hessian(ref.problem, ref.layout, ref.ops)
    want = jax.jit(lambda z_, l_: (ref.objective(z_), ref.constraints(z_), jac_r(z_),
                                   hess_r(z_, l_, 0.7)))(jnp.asarray(z), jnp.asarray(lam))
    zt, lt = torch.as_tensor(z), torch.as_tensor(lam)
    got = (port.objective(zt), port.constraints(zt),
           port_st.make_structured_jacobian(port.problem, port.layout, port.ops,
                                            device="cpu")(zt),
           port_st.make_structured_hessian(port.problem, port.layout, port.ops,
                                           device="cpu")(zt, lt, 0.7))
    for what, g, w in zip(("objective", "constraints", "jacobian", "hessian"), got, want):
        assert np.all(np.isfinite(g.numpy())), what
        assert rel_err(g.numpy(), w) <= REL_TOL, what


# ---- the boost–brake hp solve -------------------------------------------

BB_FRACTIONS = (-1.0, -0.8, -0.6, -0.4, -0.2, 0.2, 0.4, 0.6, 1.0)
# the JAX package's run (scripts/jax_multiphase_pins.py boostbrake_hp; CPU,
# x64): per grid (n, m, iterations) and each phase's mesh (degrees, fractions)
BOOSTBRAKE_HP_REFERENCE = {
    "status": 1,
    "grids": 5,
    "objective": 4.46860665426804,
    "per_grid": [(58, 38, 18), (82, 54, 21), (130, 86, 5), (226, 150, 8), (418, 278, 9)],
    "mesh_history": [
        (((8,), (-1.0, 1.0)), ((8,), (-1.0, 1.0))),
        (((16,), (-1.0, 1.0)), ((8,), (-1.0, 1.0))),
        (((4,) * 8, BB_FRACTIONS), ((8,), (-1.0, 1.0))),
        (((8,) * 8, BB_FRACTIONS), ((8,), (-1.0, 1.0))),
        (((16,) * 8, BB_FRACTIONS), ((8,), (-1.0, 1.0))),
    ],
}
# tests/test_boostbrake.py's shooting oracle
BB_Q_STAR, BB_J_STAR = 2.6933582834, 4.4686058955
OBJECTIVE_RTOL = 1e-10
FRACTION_TOL = 1e-12


def test_boostbrake_hp_solve_matches_reference():
    ref = BOOSTBRAKE_HP_REFERENCE
    sol = boostbrake.solve(options=SolveOptions(
        ipm=IPMOptions(tol=1e-9, max_iter=300), max_grid_num=6), device="cpu")
    assert sol.status == ref["status"] == SOLVED
    assert sol.grids == ref["grids"] == len(sol.grid_stats)
    assert [(g["n"], g["m"], g["iterations"]) for g in sol.grid_stats] == ref["per_grid"]
    assert len(sol.mesh_history) == len(ref["mesh_history"])
    for grid, want in zip(sol.mesh_history, ref["mesh_history"]):
        for (deg, fr), (rdeg, rfr) in zip(grid, want):
            assert tuple(deg) == rdeg
            assert len(fr) == len(rfr)
            assert max(abs(a - b) for a, b in zip(fr, rfr)) <= FRACTION_TOL
    assert abs(sol.objective - ref["objective"]) / ref["objective"] <= OBJECTIVE_RTOL
    # the golden and the shared parameter, as tests/test_boostbrake.py holds them
    assert abs(sol.objective - BB_J_STAR) < 1e-5
    q0, q1 = float(sol.phases[0].q[0]), float(sol.phases[1].q[0])
    assert abs(q0 - BB_Q_STAR) < 1e-4
    assert abs(q0 - q1) < 1e-9


# ---- the reduced launch sweep ---------------------------------------------

LAUNCH_REDUCED = dict(degrees_per_phase=(4, 4, 4, 5), segs_per_phase=(1, 1, 1, 2))
# the JAX package's batch solver (scripts/jax_multiphase_pins.py
# launch_reduced; CPU, x64, lane_kkt=False)
LAUNCH_REDUCED_REFERENCE = {
    "n": 256, "m": 209,
    "status": [1, 1, 1, 1],
    "iterations": [8, 10, 16, 15],
    "objective": [-0.025325244011931414, -0.024243665284058087,
                  -0.023340443462011896, -0.023234121591659277],
}


def launch_inputs(bs, batch):
    """bench.py::bench_launch's perturbation: the pinned initial mass of
    phase 1 by 0.01·U(-1, 1)·var_scale, seed 0."""
    rng = np.random.default_rng(0)
    z0, zl, zu, cl, cu = bs.nominal_inputs(batch)
    mrow = bs.nlp.layout.phases[0].var_offset + 6
    d = 0.01 * rng.uniform(-1, 1, batch) * bs.scaled.var_scale[mrow]
    zl[:, mrow] += d
    zu[:, mrow] += d
    return z0, zl, zu, cl, cu


def test_launch_reduced_batch_matches_reference():
    ref = LAUNCH_REDUCED_REFERENCE
    bs = make_batch_solver(launch.make_problem(**LAUNCH_REDUCED),
                           SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60)), device="cpu")
    assert (bs.n, bs.m) == (ref["n"], ref["m"])
    res = bs.run(*launch_inputs(bs, len(ref["status"])))
    assert res.status.tolist() == ref["status"]
    assert res.iterations.tolist() == ref["iterations"]
    assert rel_err(res.objective.numpy(), ref["objective"]) <= OBJECTIVE_RTOL


# ---- single solves of the other models ---------------------------------------

# the JAX package's runs (scripts/jax_multiphase_pins.py; CPU, x64): per grid
# (n, m, iterations) and the objective
SOLVE_REFERENCE = {
    "goddard_single": {"per_grid": [(133, 97, 18)], "objective": -1.0128329576282102},
    "goddard_three_phase": {"per_grid": [(159, 156, 6)], "objective": -1.0128369182364592},
    "launch": {"per_grid": [(836, 673, 13)], "objective": -0.02497798103570176},
    "reentry": {"per_grid": [(520, 385, 28)], "objective": -0.5958761024029089},
}


def assert_matches_reference(name, sol):
    ref = SOLVE_REFERENCE[name]
    assert sol.status == SOLVED
    assert [(g["n"], g["m"], g["iterations"]) for g in sol.grid_stats] == ref["per_grid"]
    assert abs(sol.objective - ref["objective"]) / abs(ref["objective"]) <= OBJECTIVE_RTOL
SOLVES = {
    "goddard_single": lambda: solve(goddard.make_problem(degrees=(6,) * 4), SolveOptions(
        mesh_method="none", max_iterations=150), device="cpu"),
    "goddard_three_phase": lambda: goddard.solve_three_phase(device="cpu"),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_single_solve_matches_reference(name):
    """Goddard's single phase (a Lagrange term, the bang-bang problem) and
    its three-phase split (no control, free switch times through the time
    links, a terminal event on the singular surface)."""
    assert_matches_reference(name, SOLVES[name]())


# ---- goldens of the larger solves (slow on the CPU) -------------------------

@pytest.mark.slow
def test_launch_full_mesh_golden():
    sol = solve(launch.make_problem(), SolveOptions(mesh_method="none", max_iterations=400),
                device="cpu")
    assert_matches_reference("launch", sol)
    assert abs(launch.final_mass_kg(sol) - 7529.71) < 1.0
    assert 900.0 < sol.phases[3].tf * launch.TU < 950.0
    for i in range(3):     # the jettisoned mass drops at every linkage
        assert sol.phases[i + 1].x[0, 6] < sol.phases[i].x[-1, 6] + 1e-9


@pytest.mark.slow
def test_reentry_crossrange_golden():
    sol = reentry.solve(options=SolveOptions(
        mesh_method="none", ipm=IPMOptions(tol=1e-6, max_iter=300)), device="cpu")
    assert_matches_reference("reentry", sol)
    assert abs(reentry.crossrange_deg(sol) - reentry.PUBLISHED_CROSSRANGE_DEG) < 5e-3
    assert abs(sol.phases[0].tf * reentry.T_S - 2008.6) < 1.0


@pytest.mark.slow
def test_hangglider_golden_ph():
    sol = hangglider.solve(options=SolveOptions(
        ipm=IPMOptions(tol=1e-8, max_iter=300), max_grid_num=8), device="cpu")
    assert sol.status == SOLVED
    assert abs(hangglider.range_m(sol) - hangglider.PUBLISHED_RANGE_M) < 0.05
    assert abs(sol.phases[0].tf * hangglider.T_S - 98.4) < 0.5
    assert sol.max_relative_error < 1e-6


@pytest.mark.slow
def test_goddard_three_phase_golden():
    sol = goddard.solve_three_phase(device="cpu")
    assert_matches_reference("goddard_three_phase", sol)
    assert abs(-sol.objective - goddard.PUBLISHED_HF) < 1e-4
    assert sol.kkt_error < 1e-7
    t1, t2, t3 = (sol.phases[i].tf for i in range(3))
    assert 0.0 < t1 < t2 < t3
    assert abs(sol.phases[1].x[-1, 2] - goddard.M_FINAL) < 1e-8
    assert abs(sol.phases[2].x[-1, 1]) < 1e-8
