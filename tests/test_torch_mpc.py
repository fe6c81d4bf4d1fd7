"""Port parity: the receding-horizon controller (parallel/mpc.py) and the
two-stage f32 → f64 cascade of ``make_batch_solver`` (parallel/batch.py).

* ``MPCController`` over 6 steps of ``tests/test_round3.py``'s double
  integrator — cold (no carried bound duals), warm, with the horizon shift,
  and in RTI mode — against the JAX package's runs pinned by
  ``scripts/jax_singular_pins.py`` (case ``mpc_round3``): per step status
  and iterations exactly, u0 to 1e-9; ``value_gradient`` against JAX's and
  against a finite difference of a fresh controller's first step.
* ``two_stage=True`` on ``tests/test_two_stage.py``'s batch of 16: every
  instance solved, objectives within 1e-7 of the JAX package's single-stage
  ones (case ``two_stage_b16``), and a warm endgame. The f32 stage's
  iteration counts are not the JAX package's (ROADMAP Queue 3 entry 1), so
  they are not compared.
"""

import json
import os

import numpy as np
import pytest
import torch

from lpopc_tpu_torch.core.ipm import SOLVED, IPMOptions
from lpopc_tpu_torch.core.problem import Phase, Problem
from lpopc_tpu_torch.core.solve import SolveOptions
from lpopc_tpu_torch.models import brachistochrone
from lpopc_tpu_torch.ops import batched_linalg as bl
from lpopc_tpu_torch.parallel.batch import make_batch_solver
from lpopc_tpu_torch.parallel.mpc import MPCController

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "scripts", "jax_singular_pins.json"), encoding="utf-8") as _f:
    PINS = json.load(_f)
U0_TOL = 1e-9
DT = 0.02


def _double_integrator():
    return Problem(phases=(Phase(
        nx=2, nu=1,
        dynamics=lambda x, u, t, q: torch.stack([x[1], u[0]]),
        lagrange=lambda x, u, t, q: 0.5 * u[0] ** 2 + x[0] ** 2,
        x0_bounds=(np.array([1.0, 0.0]), np.array([1.0, 0.0])),
        xf_bounds=(np.zeros(2), np.zeros(2)),
        x_bounds=(np.full(2, -10.0), np.full(2, 10.0)),
        u_bounds=(-50.0, 50.0), t0_bounds=(0.0, 0.0), tf_bounds=(1.0, 1.0),
        mesh_degrees=(8,), mesh_fractions=(-1.0, 1.0),
    ),))


def _closed_loop(ctrl, x, steps):
    out = {"status": [], "iterations": [], "u0": []}
    x = np.array(x, dtype=np.float64)
    for _ in range(steps):
        u0, info = ctrl.step(x)
        out["status"].append(info["status"].tolist())
        out["iterations"].append(info["iterations"].tolist())
        out["u0"].append(np.asarray(u0, dtype=np.float64).reshape(-1).tolist())
        x = x + DT * np.array([x[1], float(u0[0])])
    return out


MPC_RUNS = {
    "cold": dict(warm_bound_duals=False),
    "warm": {},
    "shift": dict(shift_dt=DT),
    "rti": dict(rti_iters=2, shift_dt=DT),
}


@pytest.mark.parametrize("run", sorted(MPC_RUNS))
def test_mpc_matches_reference(run):
    ctrl = MPCController(_double_integrator(), SolveOptions(tol=1e-6), device="cpu",
                         **MPC_RUNS[run])
    got = _closed_loop(ctrl, [1.0, 0.0], 6)
    want = PINS["mpc_round3"][run]
    assert got["status"] == want["status"]
    assert got["iterations"] == want["iterations"]
    np.testing.assert_allclose(got["u0"], want["u0"], rtol=0, atol=U0_TOL)
    if run == "rti":
        assert max(it[0] for it in got["iterations"]) <= 2     # hard per-step budget
    else:
        assert got["status"] == [[SOLVED]] * 6
    assert len(ctrl.solve_times) == 6 and np.isfinite(ctrl.percentile_ms(50))


def test_mpc_value_gradient():
    want = PINS["mpc_round3"]["value_gradient"]
    ctrl = MPCController(_double_integrator(), SolveOptions(tol=1e-8), device="cpu")
    with pytest.raises(RuntimeError, match="no step"):
        ctrl.value_gradient()
    _, info = ctrl.step(np.array([1.0, 0.0]))
    g = ctrl.value_gradient()
    assert g.shape == (1, 2) and np.all(np.isfinite(g))
    assert int(info["iterations"][0]) == want["iterations"]
    assert abs(float(info["objective"][0]) - want["objective"]) <= 1e-12 * abs(want["objective"])
    np.testing.assert_allclose(g, want["gradient"], rtol=1e-10, atol=0)
    # FD check on the first state component
    h = want["h"]
    _, info_h = MPCController(_double_integrator(), SolveOptions(tol=1e-8),
                              device="cpu").step(np.array([1.0 + h, 0.0]))
    assert abs(float(info_h["objective"][0]) - want["objective_h"]) <= 1e-12 * abs(
        want["objective_h"])
    fd = (float(info_h["objective"][0]) - float(info["objective"][0])) / h
    assert abs(g[0, 0] - fd) < 5e-3 * max(1.0, abs(fd))


def test_mpc_batch_of_plants_on_the_kernel_route():
    """Four plants in one controller on the lane route (the kernels' plain
    versions here): each plant's first steps are what the same controller
    gives it alone."""
    opts = SolveOptions(tol=1e-6, ipm=IPMOptions(
        tol=1e-6, max_iter=SolveOptions().max_iterations, mu_init=1e-2, lane_kkt=True))
    x0 = np.array([1.0, 0.0]) + 0.1 * np.random.default_rng(0).uniform(-1, 1, (4, 2))
    ctrl = MPCController(_double_integrator(), opts, batch=4, shift_dt=DT, device="cpu")
    bl.reset_launches()
    u_batch, info = ctrl.step(x0)
    assert u_batch.shape == (4, 1) and info["status"].tolist() == [SOLVED] * 4
    g = ctrl.value_gradient()
    for b in (0, 3):
        one = MPCController(_double_integrator(), opts, shift_dt=DT, device="cpu")
        u1, info1 = one.step(x0[b])
        assert int(info1["iterations"][0]) == int(info["iterations"][b])
        assert abs(float(u1[0]) - float(u_batch[b, 0])) <= 1e-12
        np.testing.assert_allclose(one.value_gradient()[0], g[b], rtol=1e-10, atol=1e-12)


def _perturbed(bs, batch):
    """``tests/test_two_stage.py``'s inputs: terminal targets moved by
    0.2·U(-1, 1)·var_scale, seed 0."""
    rng = np.random.default_rng(0)
    z0, zl, zu, cl, cu = bs.nominal_inputs(batch)
    pl = bs.nlp.layout.phases[0]
    first = pl.var_offset + (pl.npts - 1) * pl.nx
    xf = slice(first, first + 2)
    pert = 0.2 * rng.uniform(-1, 1, (batch, 2)) * bs.scaled.var_scale[xf][None, :]
    zl[:, xf] += pert
    zu[:, xf] += pert
    return z0, zl, zu, cl, cu


@pytest.fixture(scope="module")
def two_stage():
    problem = brachistochrone.make_problem(degrees=(6, 6))
    opts = SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60))
    bs1 = make_batch_solver(problem, opts, device="cpu")
    bs2 = make_batch_solver(problem, opts, two_stage=True, device="cpu")
    args = _perturbed(bs1, 16)
    return bs1, bs2, args, bs1.run(*args), bs2.run(*args)


def test_two_stage_matches_single_stage(two_stage):
    bs1, bs2, _, r1, r2 = two_stage
    want = PINS["two_stage_b16"]["single"]
    assert r1.status.tolist() == want["status"] == [SOLVED] * 16
    assert r2.status.tolist() == [SOLVED] * 16
    assert r2.z.dtype == torch.float64 and r2.objective.dtype == torch.float64
    np.testing.assert_allclose(r2.objective.numpy(), want["objective"], rtol=1e-7)
    np.testing.assert_allclose(r2.objective.numpy(), r1.objective.numpy(), rtol=1e-7)
    # both stages share one scaling: the f32 stage's functions are the same
    # transcription in float32 under the f64 scale vectors
    assert bs2.stage1_solver is not None and bs1.stage1_solver is None
    np.testing.assert_array_equal(bs2.scaled.var_scale, bs1.scaled.var_scale)
    np.testing.assert_array_equal(bs2.scaled.con_scale, bs1.scaled.con_scale)


def test_two_stage_endgame_is_warm(two_stage):
    """Stage 2 from the f32 point takes far fewer iterations than a cold f64
    solve (the warm start carries z, lambda, bound duals and mu)."""
    bs1, bs2, args, r1, r2 = two_stage
    cold_iters = np.median(r1.iterations.numpy())
    total_iters = np.median(r2.iterations.numpy())
    assert total_iters < 4.0 * cold_iters
    with pytest.raises(ValueError, match="two_stage"):
        bs2.run(*args, zl_d=r2.zl_dual, zu_d=r2.zu_dual)
