"""Port parity, the slice as a whole: the batched brachistochrone sweep
(transcribe -> scale -> structured derivatives -> batched IPM) against the JAX
package, per instance: status, iteration count, objective, z."""

import dataclasses

import numpy as np
import pytest
import torch

from lpopc_tpu.core.ipm import IPMOptions as RefIPMOptions
from lpopc_tpu.core.solve import SolveOptions as RefSolveOptions
from lpopc_tpu.models import brachistochrone as ref_model
from lpopc_tpu.parallel.batch import make_batch_solver as ref_make
from lpopc_tpu_torch.core.ipm import SOLVED, IPMOptions
from lpopc_tpu_torch.core.solve import SolveOptions
from lpopc_tpu_torch.models import brachistochrone as port_model
from lpopc_tpu_torch.parallel.batch import make_batch_solver
from lpopc_tpu_torch.utils import convert

OBJ_TOL = 1e-8   # both sides converge to tol 1e-8 on the same iterates
Z_TOL = 1e-6
# (degrees, batch, lane_kkt)
CASES = {
    "3x3_b4_lane": ((3, 3), 4, True),
    "3x3_b4_apply": ((3, 3), 4, False),
    "6x6_b8_lane": ((6, 6), 8, True),
}


def _perturbed(bs, batch):
    """The sweep of bench.py: terminal target shifted by 0.2*U(-1,1)*scale, seed 0."""
    rng = np.random.default_rng(0)
    z0, zl, zu, cl, cu = bs.nominal_inputs(batch)
    pl = bs.nlp.layout.phases[0]
    first = pl.var_offset + (pl.npts - 1) * pl.nx
    rows = slice(first, first + 2)
    pert = 0.2 * rng.uniform(-1, 1, (batch, 2)) * bs.scaled.var_scale[rows][None, :]
    zl[:, rows] += pert
    zu[:, rows] += pert
    return z0, zl, zu, cl, cu


def _fields(res):
    return {k: np.asarray(getattr(res, k)) for k in convert._FIELDS}


@pytest.fixture(scope="module")
def reference():
    out = {}
    for name, (degrees, batch, lane) in CASES.items():
        bs = ref_make(
            ref_model.make_problem(degrees=degrees),
            RefSolveOptions(ipm=RefIPMOptions(tol=1e-8, max_iter=60, lane_kkt=lane)))
        args = _perturbed(bs, batch)
        out[name] = (bs, args, _fields(bs.run(*args)))
    return out


@pytest.fixture(scope="module")
def port_solvers():
    return {
        name: make_batch_solver(
            port_model.make_problem(degrees=degrees),
            SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60, lane_kkt=lane)),
            device="cpu")
        for name, (degrees, batch, lane) in CASES.items()
    }


@pytest.mark.parametrize("case", sorted(CASES))
def test_sweep_matches_reference(reference, port_solvers, case):
    ref_bs, ref_args, ref = reference[case]
    bs = port_solvers[case]
    assert (bs.n, bs.m) == (ref_bs.n, ref_bs.m)
    assert dataclasses.asdict(bs.ipm_options) == dataclasses.asdict(ref_bs.ipm_options)
    assert bs.ipm_options.soc is False      # soc=None resolves to off on this surface
    args = _perturbed(bs, CASES[case][1])
    for a, b in zip(args, ref_args):        # same scaling, so the same inputs
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    res = bs.run(*convert.inputs_from_reference(*ref_args, device="cpu"))
    assert res.status.tolist() == ref["status"].tolist() == [SOLVED] * CASES[case][1]
    assert res.iterations.tolist() == ref["iterations"].tolist()
    np.testing.assert_allclose(res.objective.numpy(), ref["objective"], rtol=0, atol=OBJ_TOL)
    np.testing.assert_allclose(res.z.numpy(), ref["z"], rtol=0, atol=Z_TOL)
    np.testing.assert_allclose(res.kkt_error.numpy(), ref["kkt_error"], rtol=0, atol=1e-8)


def test_warm_dual_run_from_the_reference_result(reference, port_solvers):
    """Carry the JAX result across (utils/convert.py) and warm-start the port
    from it; the JAX package warm-started from its own result is the oracle."""
    ref_bs, ref_args, ref = reference["3x3_b4_lane"]
    bs = port_solvers["3x3_b4_lane"]
    prev = convert.result_from_reference(ref, device="cpu")
    assert prev.status.dtype == torch.int32 and prev.z.dtype == torch.float64
    _, zl, zu, cl, cu = convert.inputs_from_reference(*ref_args, device="cpu")
    warm = bs.run(prev.z, zl, zu, cl, cu, lam0=prev.lam,
                  zl_d=prev.zl_dual, zu_d=prev.zu_dual)
    warm_ref = _fields(ref_bs.run(
        ref["z"], *ref_args[1:], lam0=ref["lam"], zl_d=ref["zl_dual"], zu_d=ref["zu_dual"]))
    assert warm.status.tolist() == warm_ref["status"].tolist()
    assert warm.iterations.tolist() == warm_ref["iterations"].tolist()
    assert int(warm.iterations.max()) < int(ref["iterations"].min())
    np.testing.assert_allclose(warm.objective.numpy(), ref["objective"], rtol=0, atol=OBJ_TOL)
    back = convert.result_to_numpy(warm)
    np.testing.assert_allclose(back["z"], warm_ref["z"], rtol=0, atol=Z_TOL)


def test_nominal_solve_matches_the_cycloid(port_solvers):
    bs = port_solvers["6x6_b8_lane"]
    res = bs.run(*bs.nominal_inputs(1))      # numpy in: moved to the solver's device
    assert int(res.status[0]) == SOLVED
    tf = float(res.objective[0]) / bs.scaled.obj_scale
    assert abs(tf - port_model.analytic_tf()) < 1e-7   # as tests/test_examples.py


def test_perturb_x0_matches_reference(reference, port_solvers):
    ref_bs = reference["3x3_b4_lane"][0]
    bs = port_solvers["3x3_b4_lane"]
    deltas = 0.1 * np.random.default_rng(4).standard_normal((4, 3))
    for a, b in zip(bs.perturb_x0(4, 0, deltas), ref_bs.perturb_x0(4, 0, deltas)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_unported_surfaces_raise(reference, port_solvers):
    """Ported: ``mesh=`` and ``donate`` work; here at world size 1 on the CPU
    (a one-process gloo group), each against the JAX package's sweep
    (multi-rank runs: tests/test_torch_scaleout.py)."""
    import torch.distributed as tdist

    from lpopc_tpu_torch.parallel import distributed
    from lpopc_tpu_torch.parallel.batch import default_mesh

    _, args, want = reference["3x3_b4_lane"]
    problem = port_model.make_problem(degrees=(3, 3))
    options = SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60, lane_kkt=True))
    distributed.initialize(device="cpu")
    try:
        for kw in (dict(mesh=default_mesh(device="cpu")), dict(donate=True)):
            bs = make_batch_solver(problem, options, device="cpu", **kw)
            z0 = torch.as_tensor(args[0])
            got = _fields(bs.run(z0, *args[1:]))
            assert np.array_equal(got["status"], want["status"])
            assert np.array_equal(got["iterations"], want["iterations"])
            np.testing.assert_allclose(got["objective"], want["objective"], rtol=OBJ_TOL)
            if "donate" in kw:
                np.testing.assert_array_equal(z0.numpy(), got["z"])   # z0 holds the result
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("assembly", ["direct", "dense"])
def test_block_kkt_on_takes_the_block_path(port_solvers, monkeypatch, assembly):
    """``block_kkt="on"`` builds the sweep on the block factorization (the
    structured KKT for "direct", the block factorizer of the dense K for
    "dense"), never calls K1/K2 (their plain versions here) although the
    options ask for the lane route, and reaches the dense route's optima."""
    from lpopc_tpu_torch.core import block_kkt, kkt_blocks
    from lpopc_tpu_torch.ops import batched_linalg as bl

    degrees, batch, _ = CASES["3x3_b4_lane"]
    dense_res = port_solvers["3x3_b4_lane"].run(
        *_perturbed(port_solvers["3x3_b4_lane"], batch))
    calls = {"blocks": 0, "dense": 0}
    real = block_kkt.factor_from_blocks

    def counted(*a):
        calls["blocks"] += 1
        return real(*a)

    def dense(*a):
        calls["dense"] += 1
        raise AssertionError("K1/K2 ran on the block path")

    monkeypatch.setattr(block_kkt, "factor_from_blocks", counted)
    monkeypatch.setattr(kkt_blocks, "factor_from_blocks", counted)
    monkeypatch.setattr(bl, "lane_cholesky_plain", dense)
    monkeypatch.setattr(bl, "lane_cho_solve_plain", dense)
    bs = make_batch_solver(
        port_model.make_problem(degrees=degrees),
        SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60, lane_kkt=True),
                     block_kkt="on", block_assembly=assembly), device="cpu")
    res = bs.run(*_perturbed(bs, batch))
    assert res.status.tolist() == [SOLVED] * batch
    np.testing.assert_allclose(res.objective.numpy(), dense_res.objective.numpy(),
                               rtol=0, atol=OBJ_TOL)
    assert calls["blocks"] > 0 and calls["dense"] == 0
