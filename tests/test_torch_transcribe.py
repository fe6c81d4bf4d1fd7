"""Port parity: NLP transcription (layout, bounds, guess, objective, constraints)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpopc_tpu.core import transcribe as ref_tr
from lpopc_tpu.models import brachistochrone as ref_model
from lpopc_tpu_torch.core import transcribe as port_tr
from lpopc_tpu_torch.models import brachistochrone as port_model

TOL = 1e-12  # same formulas in f64; only summation order differs


@pytest.fixture(scope="module")
def pair():
    r = ref_tr.transcribe(ref_model.make_problem(degrees=(6, 6)))
    p = port_tr.transcribe(port_model.make_problem(degrees=(6, 6)), device="cpu")
    return r, p


def test_sizes_bounds_and_guess_equal(pair):
    r, p = pair
    assert (p.n, p.m) == (r.n, r.m) == (53, 37)
    for name in ("zl", "zu", "cl", "cu", "z0"):
        np.testing.assert_array_equal(getattr(p, name), getattr(r, name))
    assert p.layout.phases[0].t0_index == r.layout.phases[0].t0_index


@pytest.mark.parametrize("where", ["z0", "random"])
def test_objective_and_constraints_match(pair, where):
    r, p = pair
    z = r.z0.copy()
    if where == "random":
        z = z + 0.1 * np.random.default_rng(3).standard_normal(r.n)
    zt = torch.as_tensor(z)
    np.testing.assert_allclose(
        float(p.objective(zt)), float(r.objective(jnp.asarray(z))), rtol=0, atol=TOL)
    np.testing.assert_allclose(
        p.constraints(zt).numpy(), np.asarray(r.constraints(jnp.asarray(z))),
        rtol=0, atol=TOL)


def test_pack_unpack_roundtrip(pair):
    _, p = pair
    z = torch.as_tensor(p.z0)
    parts = [port_tr.unpack_phase(pl, z) for pl in p.layout.phases]
    assert torch.equal(port_tr.pack(p.layout, parts, device="cpu"), z)


def test_analytic_tf_and_phase_times_match(pair):
    r, p = pair
    assert port_model.analytic_tf() == ref_model.analytic_tf()
    tc_p, ts_p = port_tr.phase_times(p.ops[0], torch.tensor(0.5, dtype=torch.float64),
                                     torch.tensor(2.0, dtype=torch.float64))
    tc_r, ts_r = ref_tr.phase_times(r.ops[0], 0.5, 2.0)
    np.testing.assert_allclose(tc_p.numpy(), np.asarray(tc_r), atol=1e-14)
    np.testing.assert_allclose(ts_p.numpy(), np.asarray(ts_r), atol=1e-14)
