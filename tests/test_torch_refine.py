"""Port parity: error estimation and hp mesh refinement (ph and hp-Liu)
against the JAX package.

Both sides get the same solution: a JAX package ``Solution`` extracted at a
seeded point, carried to the port with ``convert.solution_from_reference``.
Tolerances: per-segment errors and path violations 1e-10 relative; every
mesh decision (bucketing, ph, knot insertion, hp-Liu) exactly equal.
"""

import dataclasses
import importlib

import numpy as np
import pytest

from lpopc_tpu.core import refine as ref_refine
from lpopc_tpu.core import refine_liu as ref_liu
from lpopc_tpu.core.postprocess import PhaseSolution as RefPhaseSolution
from lpopc_tpu.core.postprocess import extract_solution as ref_extract
from lpopc_tpu.core.transcribe import transcribe as ref_transcribe
from lpopc_tpu.ops.lgr import lgr_nodes_weights
from lpopc_tpu_torch.core import refine as port_refine
from lpopc_tpu_torch.core import refine_liu as port_liu
from lpopc_tpu_torch.core.postprocess import PhaseSolution
from lpopc_tpu_torch.utils import convert

MODELS = {
    "hypersensitive": dict(tf=40.0, degrees=(6, 6)),
    "lowthrust": dict(degrees=(4, 5)),
    "brysondenham": dict(degrees=(4, 4, 4)),
    "vanderpol": dict(degrees=(4, 6)),
    "moonlander": dict(degrees=(5, 5)),
}


def shared_solution(name, seed=0):
    """(JAX problem, port problem, JAX Solution, the same Solution for the port)."""
    kw = MODELS[name]
    ref_problem = importlib.import_module(f"lpopc_tpu.models.{name}").make_problem(**kw)
    port_problem = importlib.import_module(f"lpopc_tpu_torch.models.{name}").make_problem(**kw)
    nlp = ref_transcribe(ref_problem)
    rng = np.random.default_rng(seed)
    z = nlp.z0 + 0.05 * rng.standard_normal(nlp.z0.shape[0])
    lam = rng.standard_normal(nlp.layout.ncon)
    sol = ref_extract(ref_problem, nlp.layout, nlp.ops, z, lam, 0.0, 1, 0.0, 1)
    return ref_problem, port_problem, sol, convert.solution_from_reference(sol)


def assert_rel(got, want, tol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want), 1e-300)
    assert np.all(np.abs(got - want) <= tol * scale), (got, want)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_estimate_errors(model):
    ref_problem, port_problem, ref_sol, port_sol = shared_solution(model)
    got = port_refine.estimate_errors(port_problem, port_sol, device="cpu")
    want = ref_refine.estimate_errors(ref_problem, ref_sol)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_rel(g, w)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_estimate_path_violations(model):
    ref_problem, port_problem, ref_sol, port_sol = shared_solution(model, seed=1)
    got = port_refine.estimate_path_violations(
        port_problem, port_sol, with_peaks=True, device="cpu")
    want = ref_refine.estimate_path_violations(ref_problem, ref_sol, with_peaks=True)
    for (gv, gp), (wv, wp) in zip(got, want):
        assert_rel(gv, wv)
        np.testing.assert_array_equal(gp, wp)
    plain = port_refine.estimate_path_violations(port_problem, port_sol, device="cpu")
    for g, (gv, _) in zip(plain, got):
        np.testing.assert_array_equal(g, gv)


@pytest.mark.parametrize("d", list(range(1, 70, 3)) + [64, 65])
def test_bucket_degree(d):
    for n_max in (8, 16, 64):
        assert port_refine.bucket_degree(d, n_max) == ref_refine.bucket_degree(d, n_max)


def test_pad_count():
    for s in range(1, 300):
        assert port_refine.pad_count(s) == ref_refine.pad_count(s)


BUCKET_CASES = {
    "three": ((4, 7, 5), (-1.0, -0.5, 0.5, 1.0), 16),
    "one_high": ((20,), (-1.0, 1.0), 16),
    "five_ragged": ((3, 9, 4, 4, 17), (-1.0, -0.9, -0.2, 0.1, 0.7, 1.0), 64),
    "already": ((8,) * 4, (-1.0, -0.5, 0.0, 0.5, 1.0), 16),
}


@pytest.mark.parametrize("case", sorted(BUCKET_CASES))
def test_bucket_mesh(case):
    d, f, n_max = BUCKET_CASES[case]
    assert port_refine.bucket_mesh(d, f, n_max) == ref_refine.bucket_mesh(d, f, n_max)


PH_CASES = {
    "all_ok": ((6, 6), (-1.0, 0.0, 1.0), [1e-8, 1e-7]),
    "raise_degree": ((6, 6), (-1.0, 0.0, 1.0), [1e-4, 1e-8]),
    "split": ((14, 6), (-1.0, 0.3, 1.0), [3e-1, 2e-3]),
    "huge_error": ((4,), (-1.0, 1.0), [50.0]),
    "at_tol": ((8, 8, 8), (-1.0, -0.2, 0.4, 1.0), [1e-6, 1.0000001e-6, 0.0]),
}


@pytest.mark.parametrize("case", sorted(PH_CASES))
def test_ph_refine_phase(case):
    d, f, errs = PH_CASES[case]
    for n_min, n_max in ((4, 16), (3, 10)):
        got = port_refine.ph_refine_phase(d, f, np.asarray(errs), 1e-6, n_min, n_max)
        want = ref_refine.ph_refine_phase(d, f, np.asarray(errs), 1e-6, n_min, n_max)
        assert got == want


KNOT_CASES = {
    "interior": ((6, 6), (-1.0, 0.0, 1.0), [-0.4, 0.55]),
    "on_point": ((6, 6), (-1.0, 0.0, 1.0), [0.0, 0.999]),
    "none": ((6,), (-1.0, 1.0), []),
    "tiny_segment": ((4, 4), (-1.0, -1.0 + 1e-12, 1.0), [-1.0 + 5e-13]),
}


@pytest.mark.parametrize("case", sorted(KNOT_CASES))
def test_insert_knots(case):
    d, f, knots = KNOT_CASES[case]
    assert port_refine.insert_knots(d, f, knots) == ref_refine.insert_knots(d, f, knots)


def test_violation_knots():
    errs = np.array([1e-8, 1e-3, 1e-9, 1e-9])
    viols = np.array([1e-2, 1e-2, 1e-9, 5e-3])
    peaks = np.array([-0.5, 0.1, 0.3, np.nan])
    for viol_tol in (1e-4, 1e-1):
        assert (port_refine.violation_knots(errs, viols, peaks, 1e-6, viol_tol)
                == ref_refine.violation_knots(errs, viols, peaks, 1e-6, viol_tol))


# ----- hp-Liu: the inputs of tests/test_refine_liu.py, fed to both sides -----

def flat_psol(cls, degrees, fractions, x_fn=None):
    """A synthetic PhaseSolution (of either package) over the given mesh."""
    taus = []
    for k, nk in enumerate(degrees):
        a, b = fractions[k], fractions[k + 1]
        tau_loc, _ = lgr_nodes_weights(nk)
        taus.append(a + (tau_loc + 1.0) * (b - a) / 2.0)
    t_col = np.concatenate(taus)
    t_state = np.concatenate([t_col, [fractions[-1]]])
    ts01 = (t_state + 1.0) / 2.0
    x_fn = x_fn or (lambda t: np.stack([1.0 - t, 0.1 * t], axis=1))
    N = t_col.shape[0]
    return cls(
        t_state=ts01, x=x_fn(ts01), t_col=(t_col + 1.0) / 2.0,
        u=np.zeros((N, 1)), t0=0.0, tf=1.0, q=np.zeros(0),
        costate=np.zeros((N, 2)), costate_f=np.zeros(2),
        path_multipliers=np.zeros((N, 0)), hamiltonian=np.zeros(N),
        mesh_degrees=tuple(degrees), mesh_fractions=tuple(fractions),
    )


def tanh_x(sharp, centre=0.5):
    return lambda t: np.stack([np.tanh(sharp * (t - centre)), t], axis=1)


# each case: a list of passes (degrees, fractions, x_fn, errs, kw) run in
# order through ONE LiuState per side
LIU_CASES = {
    "reduce_linear_12": [((12,), (-1.0, 1.0), None, [1e-12], {})],
    "divide_on_nonsmooth_history": [
        ((8,), (-1.0, 1.0), tanh_x(3.0), [1e-2], {}),
        ((8,), (-1.0, 1.0), tanh_x(30.0), [1e-2], {}),
    ],
    "reduce_two_plain": [((8, 8), (-1.0, 0.0, 1.0), None, [1e-12, 1e-12], {})],
    "reduce_two_bucket_aware": [
        ((8, 8), (-1.0, 0.0, 1.0), None, [1e-12, 1e-12], {"bucket_aware": True})],
    "veto_reduction_next_to_divide": [
        ((8, 8), (-1.0, 0.0, 1.0), tanh_x(3, 0.75), [1e-12, 1e2], {"bucket_aware": True}),
        ((8, 8), (-1.0, 0.0, 1.0), tanh_x(60, 0.75), [1e-12, 1e2], {"bucket_aware": True}),
    ],
    "merge_plain": [((6,) * 4, (-1.0, -0.5, 0.0, 0.5, 1.0), None, [1e-12] * 4,
                     {"n_min": 6})],
    "merge_bucket_aware": [((6,) * 4, (-1.0, -0.5, 0.0, 0.5, 1.0), None, [1e-12] * 4,
                            {"n_min": 6, "bucket_aware": True})],
    "bucket_jump_against_divide": [
        ((8,), (-1.0, 1.0), lambda t: np.stack([np.sin(6 * t), t], axis=1), [3e-3],
         {"bucket_aware": True})],
    "increase_smooth": [
        ((6, 6), (-1.0, 0.0, 1.0), lambda t: np.stack([np.sin(3 * t), t], axis=1),
         [2e-5, 1e-9], {})],
    "three_pass_history": [
        ((6, 6), (-1.0, 0.0, 1.0), tanh_x(4.0), [1e-3, 1e-4], {}),
        ((8, 6, 6), (-1.0, 0.0, 0.5, 1.0), tanh_x(4.0), [1e-5, 1e-7, 1e-4], {}),
        ((8, 8, 6, 6), (-1.0, -0.5, 0.0, 0.5, 1.0), tanh_x(4.0),
         [1e-9, 1e-7, 1e-8, 1e-3], {"bucket_aware": True}),
    ],
}


@pytest.mark.parametrize("case", sorted(LIU_CASES))
def test_liu_refine_phase(case):
    from lpopc_tpu.models.moonlander import make_problem as ref_make
    from lpopc_tpu_torch.models.moonlander import make_problem as port_make

    ref_state, port_state = ref_liu.LiuState(), port_liu.LiuState()
    for degrees, fractions, x_fn, errs, kw in LIU_CASES[case]:
        kw = {"tol": 1e-6, "n_min": 4, "n_max": 16, **kw}
        got = port_liu.liu_refine_phase(
            port_make(degrees=degrees).phases[0],
            flat_psol(PhaseSolution, degrees, fractions, x_fn), np.asarray(errs),
            port_state, **kw)
        want = ref_liu.liu_refine_phase(
            ref_make(degrees=degrees).phases[0],
            flat_psol(RefPhaseSolution, degrees, fractions, x_fn), np.asarray(errs),
            ref_state, **kw)
        assert got == want
        for f in dataclasses.fields(ref_liu.LiuState):
            g, w = getattr(port_state, f.name), getattr(ref_state, f.name)
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w


@pytest.mark.parametrize("x", ["smooth", "kinked"])
def test_merge_ok(x):
    taus = np.linspace(-1, 1, 2001)
    first = taus ** 2 if x == "smooth" else np.abs(taus)
    vals = np.stack([first, np.ones_like(taus)], axis=1)
    for n in (4, 6, 9):
        assert (port_liu._merge_ok(taus, vals, -0.5, 0.5, n, 1e-6)
                == ref_liu._merge_ok(taus, vals, -0.5, 0.5, n, 1e-6))
