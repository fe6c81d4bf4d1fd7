"""Port parity: structured Jacobian/Hessian assembly, against the JAX
structured assembly and against global torch.func AD."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import hessian, jacfwd, vmap

from lpopc_tpu.core import structured as ref_st
from lpopc_tpu.core.transcribe import transcribe as ref_transcribe
from lpopc_tpu.models import brachistochrone as ref_model
from lpopc_tpu_torch.core import structured as port_st
from lpopc_tpu_torch.core.transcribe import transcribe as port_transcribe
from lpopc_tpu_torch.models import brachistochrone as port_model

TOL = 1e-10  # exact AD on both sides; duplicate entries sum in another order


@pytest.fixture(scope="module")
def setup():
    r = ref_transcribe(ref_model.make_problem(degrees=(4, 3)))
    p = port_transcribe(port_model.make_problem(degrees=(4, 3)), device="cpu")
    rng = np.random.default_rng(11)
    z = r.z0 + 0.05 * rng.standard_normal(r.n)
    lam = rng.standard_normal(r.m)
    return r, p, z, lam


def test_jacobian_matches_reference_and_global_ad(setup):
    r, p, z, lam = setup
    Jp = port_st.make_structured_jacobian(p.problem, p.layout, p.ops, device="cpu")(
        torch.as_tensor(z))
    Jr = ref_st.make_structured_jacobian(r.problem, r.layout, r.ops)(jnp.asarray(z))
    np.testing.assert_allclose(Jp.numpy(), np.asarray(Jr), rtol=0, atol=TOL)
    Jg = jacfwd(p.constraints)(torch.as_tensor(z))
    np.testing.assert_allclose(Jp.numpy(), Jg.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("gauss_newton", [False, True])
def test_hessian_matches_reference(setup, gauss_newton):
    r, p, z, lam = setup
    Hp = port_st.make_structured_hessian(
        p.problem, p.layout, p.ops, gauss_newton=gauss_newton, device="cpu")(
        torch.as_tensor(z), torch.as_tensor(lam), 0.7)
    Hr = ref_st.make_structured_hessian(
        r.problem, r.layout, r.ops, gauss_newton=gauss_newton)(
        jnp.asarray(z), jnp.asarray(lam), 0.7)
    np.testing.assert_allclose(Hp.numpy(), np.asarray(Hr), rtol=0, atol=TOL)


def test_hessian_matches_global_ad(setup):
    _, p, z, lam = setup
    zt, lt = torch.as_tensor(z), torch.as_tensor(lam)
    Hp = port_st.make_structured_hessian(p.problem, p.layout, p.ops, device="cpu")(zt, lt)
    Hg = hessian(lambda z_: p.objective(z_) + torch.dot(lt, p.constraints(z_)))(zt)
    np.testing.assert_allclose(Hp.numpy(), Hg.numpy(), rtol=0, atol=TOL)


def test_assembly_lifts_over_the_instance_axis_bitwise(setup):
    """The solver lifts the single-instance assembly with vmap; the gather
    assembly has a fixed summation order, so rows are bitwise reproducible."""
    _, p, z, lam = setup
    jac = port_st.make_structured_jacobian(p.problem, p.layout, p.ops, device="cpu")
    hess = port_st.make_structured_hessian(p.problem, p.layout, p.ops, device="cpu")
    Z = torch.as_tensor(np.stack([z, z + 0.01, z]))
    Lm = torch.as_tensor(np.stack([lam, lam, lam]))
    Jb, Hb = vmap(jac)(Z), vmap(hess)(Z, Lm)
    assert torch.equal(Jb[0], Jb[2]) and torch.equal(Hb[0], Hb[2])
    np.testing.assert_allclose(Jb[0].numpy(), jac(Z[0]).numpy(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(Hb[1].numpy(), hess(Z[1], Lm[1]).numpy(), rtol=0, atol=1e-14)


def test_gather_assembly_sums_duplicates():
    asm = port_st._GatherAssembly(np.array([2, 0, 2, 2, 5]), 6)
    out = asm(torch.tensor([1.0, 10.0, 2.0, 4.0, 7.0], dtype=torch.float64))
    assert out.tolist() == [10.0, 0.0, 7.0, 0.0, 0.0, 7.0]


def test_gather_assembly_tables_stay_small():
    """One dense entry taking a source from every node (a phase's tf column)
    must not pad every other entry's table to that count."""
    rng = np.random.default_rng(0)
    dest = np.concatenate([np.full(4096, 7), rng.permutation(50_000)[:20_000],
                           rng.integers(0, 50_000, 3000)])
    src = rng.standard_normal(dest.shape[0])
    asm = port_st._GatherAssembly(dest, 50_000)
    assert sum(t.size for t in asm._tables_np) <= 2 * dest.shape[0]
    want = np.zeros(50_000)
    np.add.at(want, dest, src)
    np.testing.assert_allclose(asm(torch.as_tensor(src)).numpy(), want, rtol=1e-14, atol=1e-12)
