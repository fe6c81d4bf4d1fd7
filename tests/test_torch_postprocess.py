"""Port parity: interpolation operators, runtime-mesh LGR operators and
solution post-processing, against the JAX package on the same numpy inputs.

Tolerances: interpolation 1e-13; runtime-mesh operators 1e-14 (the same
arithmetic on both sides, so they agree to rounding); costates, path
multipliers and the Hamiltonian on the same z and λ 1e-12.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpopc_tpu.core import postprocess as ref_post
from lpopc_tpu.core.transcribe import transcribe as ref_transcribe
from lpopc_tpu.ops import interp as ref_interp
from lpopc_tpu.ops import lgr as ref_lgr
from lpopc_tpu_torch.core import postprocess as port_post
from lpopc_tpu_torch.core.transcribe import transcribe as port_transcribe
from lpopc_tpu_torch.ops import interp as port_interp
from lpopc_tpu_torch.ops import lgr as port_lgr
from lpopc_tpu_torch.utils import convert

MODELS = {
    "hypersensitive": dict(tf=40.0, degrees=(6, 6)),
    "brachistochrone": dict(degrees=(5, 4)),
    "lowthrust": dict(degrees=(4, 5)),
    "moonlander": dict(degrees=(5, 5)),
    "brysondenham": dict(degrees=(4, 4, 4)),
    "vanderpol": dict(degrees=(4, 6)),
}


def models(name):
    kw = MODELS[name]
    ref = importlib.import_module(f"lpopc_tpu.models.{name}").make_problem(**kw)
    port = importlib.import_module(f"lpopc_tpu_torch.models.{name}").make_problem(**kw)
    return ref, port


def seeded_point(nlp, seed):
    """The NLP's own initial guess plus seeded noise, and seeded multipliers."""
    rng = np.random.default_rng(seed)
    z = nlp.z0 + 0.05 * rng.standard_normal(nlp.z0.shape[0])
    lam = rng.standard_normal(nlp.layout.ncon)
    return z, lam


def ref_solution(ref_problem, seed=0):
    """A JAX package Solution at a seeded point, with its NLP."""
    nlp = ref_transcribe(ref_problem)
    z, lam = seeded_point(nlp, seed)
    return nlp, ref_post.extract_solution(
        ref_problem, nlp.layout, nlp.ops, z, lam, 1.25, 1, 1e-9, 7)


INTERP_CASES = {
    "lgr_to_fine": (np.concatenate([ref_lgr.lgr_nodes_weights(6)[0], [1.0]]),
                    ref_lgr.lgr_nodes_weights(7)[0]),
    "exact_hits": (np.linspace(-1.0, 1.0, 5), np.array([-1.0, -0.3, 0.0, 0.5, 1.0])),
    "extrapolate": (np.array([0.0, 0.4, 1.1, 2.0]), np.array([2.5, -0.5, 0.7])),
    "seeded": (np.sort(np.random.default_rng(3).uniform(-1, 1, 9)),
               np.random.default_rng(4).uniform(-1.2, 1.2, 13)),
}


@pytest.mark.parametrize("case", sorted(INTERP_CASES))
def test_interpolation_matrix(case):
    support, targets = INTERP_CASES[case]
    np.testing.assert_allclose(
        port_interp.interpolation_matrix(support, targets),
        ref_interp.interpolation_matrix(support, targets), rtol=0, atol=1e-13)


@pytest.mark.parametrize("k", [None, 3])
def test_barycentric_interpolate(k):
    support, targets = INTERP_CASES["seeded"]
    rng = np.random.default_rng(5)
    vals = rng.standard_normal(support.shape if k is None else (support.shape[0], k))
    got = port_interp.barycentric_interpolate(support, vals, targets)
    want = ref_interp.barycentric_interpolate(support, vals, targets)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


MESHES = {
    "three": ((4, 7, 3), (-1.0, -0.35, 0.4, 1.0)),
    "one": ((20,), (-1.0, 1.0)),
    "bucketed": ((8,) * 4, (-1.0, -0.75, -0.5, 0.0, 1.0)),
}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_materialize_phase_ops(mesh):
    degrees, fractions = MESHES[mesh]
    got = port_lgr.materialize_phase_ops(
        degrees, torch.tensor(fractions, dtype=torch.float64))
    want = ref_lgr.materialize_phase_ops(degrees, jnp.asarray(np.asarray(fractions)))
    op = port_lgr.make_segment_ops(degrees, fractions)
    for g, w, c in zip(got, want, (op.tau, op.tau_state, op.w, op.D)):
        assert g.dtype == torch.float64 and g.device.type == "cpu"
        g = g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-14, atol=1e-14)
        np.testing.assert_allclose(g, c, rtol=1e-14, atol=1e-14)
    for g, w in zip(port_lgr.runtime_mesh_patterns(degrees),
                    ref_lgr.runtime_mesh_patterns(degrees)):
        np.testing.assert_array_equal(g, w)


def test_materialize_phase_ops_follows_fractions_dtype():
    tau, tau_state, w, D = port_lgr.materialize_phase_ops(
        (3, 3), torch.tensor((-1.0, 0.2, 1.0), dtype=torch.float32))
    assert all(t.dtype == torch.float32 for t in (tau, tau_state, w, D))
    assert tau_state[-1].item() == 1.0 and tuple(D.shape) == (6, 7)


PHASE_FIELDS = [f.name for f in dataclasses.fields(ref_post.PhaseSolution)]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_extract_solution(model):
    ref_problem, port_problem = models(model)
    nlp, want = ref_solution(ref_problem)
    pnlp = port_transcribe(port_problem, device="cpu")
    z, lam = seeded_point(nlp, 0)
    got = port_post.extract_solution(
        port_problem, pnlp.layout, pnlp.ops, z, lam, 1.25, 1, 1e-9, 7, device="cpu")
    assert (got.objective, got.status, got.kkt_error, got.iterations) == (1.25, 1, 1e-9, 7)
    for gp, wp in zip(got.phases, want.phases):
        for name in PHASE_FIELDS:
            g, w = getattr(gp, name), getattr(wp, name)
            if isinstance(w, tuple):
                assert g == w, name
            else:
                np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12, atol=1e-12,
                                           err_msg=name)
        np.testing.assert_allclose(gp.u_full, wp.u_full, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("model", ["lowthrust", "moonlander"])
def test_warm_start_problem(model):
    ref_problem, port_problem = models(model)
    _, ref_sol = ref_solution(ref_problem, seed=1)
    got = port_post.warm_start_problem(port_problem, convert.solution_from_reference(ref_sol))
    want = ref_post.warm_start_problem(ref_problem, ref_sol)
    for gp, wp in zip(got.phases, want.phases):
        for name in ("guess_t", "guess_x", "guess_u", "guess_q"):
            g, w = getattr(gp, name), getattr(wp, name)
            assert (g is None) == (w is None), name
            if w is not None:
                np.testing.assert_allclose(g, np.asarray(w), rtol=1e-13, atol=1e-13)
        assert (gp.mesh_degrees, gp.mesh_fractions) == (wp.mesh_degrees, wp.mesh_fractions)


def test_solution_from_reference_copies_every_field():
    ref_problem, _ = models("lowthrust")
    _, ref_sol = ref_solution(ref_problem, seed=2)
    ref_sol.error_history = [[np.arange(3.0)]]
    ref_sol.grid_stats = [{"grid": 1, "n": 10}]
    ref_sol.mesh_history = [(((4, 5), (-1.0, 0.0, 1.0)),)]
    got = convert.solution_from_reference(ref_sol)
    assert isinstance(got, port_post.Solution)
    for f in dataclasses.fields(ref_post.Solution):
        if f.name == "phases":
            continue
        g, w = getattr(got, f.name), getattr(ref_sol, f.name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
            assert g is not w
        elif isinstance(w, float) and np.isnan(w):
            assert np.isnan(g)
        elif f.name == "error_history":
            np.testing.assert_array_equal(g[0][0], w[0][0])
        else:
            assert g == w, f.name
    assert got.solved and got.mesh_converged
