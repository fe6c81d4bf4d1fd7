"""Port parity: automatic problem scaling (scale vectors and scaled values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpopc_tpu.core.scaling import scale_nlp as ref_scale
from lpopc_tpu.core.transcribe import transcribe as ref_transcribe
from lpopc_tpu.models import brachistochrone as ref_model
from lpopc_tpu_torch.core.scaling import scale_nlp as port_scale
from lpopc_tpu_torch.core.transcribe import transcribe as port_transcribe
from lpopc_tpu_torch.models import brachistochrone as port_model

TOL = 1e-12  # gradients by exact AD on both sides; rounding only

CASES = {
    "default": {},
    "variable_scaling": {"variable_scaling": True},
    # the sample cloud comes from np.random.default_rng(seed) on both sides
    "samples": {"samples": 3, "seed": 5},
    "disabled": {"enabled": False},
}


@pytest.fixture(scope="module")
def nlps():
    r = ref_transcribe(ref_model.make_problem(degrees=(4, 4)))
    p = port_transcribe(port_model.make_problem(degrees=(4, 4)), device="cpu")
    return r, p


@pytest.mark.parametrize("case", sorted(CASES))
def test_scaling_matches(nlps, case):
    r, p = nlps
    kw = CASES[case]
    sr = ref_scale(r.objective, r.constraints, r.zl, r.zu, r.cl, r.cu, r.z0, **kw)
    sp = port_scale(p.objective, p.constraints, p.zl, p.zu, p.cl, p.cu, p.z0,
                    device="cpu", **kw)
    assert abs(sp.obj_scale - sr.obj_scale) <= TOL
    for name in ("con_scale", "var_scale", "zl", "zu", "cl", "cu", "z0"):
        np.testing.assert_allclose(getattr(sp, name), getattr(sr, name), rtol=0, atol=TOL)
    z = sr.z0 + 0.05 * np.random.default_rng(1).standard_normal(r.n)
    np.testing.assert_allclose(
        float(sp.objective(torch.as_tensor(z))), float(sr.objective(jnp.asarray(z))),
        rtol=0, atol=TOL)
    np.testing.assert_allclose(
        sp.constraints(torch.as_tensor(z)).numpy(),
        np.asarray(sr.constraints(jnp.asarray(z))), rtol=0, atol=TOL)
    lam = np.linspace(-1, 1, r.m)
    np.testing.assert_allclose(sp.unscale_lam(lam), sr.unscale_lam(lam), atol=TOL)
    np.testing.assert_allclose(sp.bound_dual_scale(), sr.bound_dual_scale(), atol=TOL)
