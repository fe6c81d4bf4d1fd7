"""Port parity: the matrix-free structured KKT (core/kkt_blocks.py) against
the JAX package's, on the same seeded inputs.

On the two-phase problem of ``tests/test_block_kkt.py`` (its port twin in
``tests/test_torch_block_kkt.py``) and on hypersensitive at degrees
(5, 4, 6, 5), with random scalings: ``jv``, ``jtv``, ``hv`` and the
directly assembled (A, B, C) agree to 1e-12 relative, batch of two against
two single-instance JAX calls. The batched solver built with the bound
structured KKT (``block_kkt="on"``, ``block_assembly="direct"``, B = 3)
takes the JAX package's iterations, z to 1e-8, and never calls the dense
kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpopc_tpu.core.block_kkt import make_block_spec as ref_spec_of
from lpopc_tpu.core.kkt_blocks import bind_structured_kkt as ref_bind
from lpopc_tpu.core.kkt_blocks import make_structured_kkt as ref_make_sk
from lpopc_tpu.core.transcribe import const_mesh as ref_const_mesh
from lpopc_tpu.core.transcribe import transcribe as ref_transcribe
from lpopc_tpu_torch.core import kkt_blocks
from lpopc_tpu_torch.core.block_kkt import make_block_spec
from lpopc_tpu_torch.core.kkt_blocks import bind_structured_kkt, make_structured_kkt
from lpopc_tpu_torch.core.transcribe import const_mesh, transcribe
from lpopc_tpu_torch.ops import batched_linalg as bl
from test_torch_block_kkt import PROBLEMS, assert_batch_matches_reference, rel_err

REL_TOL = 1e-12
B = 2


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def setup(request):
    """Both packages' bound structured KKT of one problem under the same
    random scaling, B seeded evaluation points, and the JAX package's
    jac/hess blocks at each."""
    ref_problem, port_problem = (f() for f in PROBLEMS[request.param])
    ref_nlp = ref_transcribe(ref_problem)
    nlp = transcribe(port_problem, device="cpu")
    n, m = nlp.n, nlp.m
    rng = np.random.default_rng(0)
    sf = 0.7
    sc = np.exp(0.2 * rng.standard_normal(m))
    v = np.exp(0.1 * rng.standard_normal(n))
    ref_sk = ref_make_sk(ref_problem, ref_nlp.layout, ref_spec_of(ref_nlp.layout, ref_nlp.ops))
    ref = ref_bind(ref_sk, ref_const_mesh(ref_nlp.ops), sf, jnp.asarray(sc), jnp.asarray(1.0 / v))
    sk = make_structured_kkt(port_problem, nlp.layout, make_block_spec(nlp.layout, nlp.ops))
    port = bind_structured_kkt(sk, const_mesh(nlp.ops, device="cpu"), sf, sc, 1.0 / v)
    z_s = nlp.z0 * v + 0.01 * rng.standard_normal((B, n))
    lam = rng.standard_normal((B, m))
    jb_ref = [jax.jit(ref.jac_blocks)(jnp.asarray(z)) for z in z_s]
    hb_ref = [jax.jit(ref.hess_blocks)(jnp.asarray(z), jnp.asarray(l)) for z, l in zip(z_s, lam)]
    t = torch.as_tensor
    jb, hb = port.jac_blocks(t(z_s)), port.hess_blocks(t(z_s), t(lam))
    return dict(n=n, m=m, rng=rng, z_s=z_s, ref=ref, ref_sk=ref_sk, port=port,
                jb_ref=jb_ref, hb_ref=hb_ref, jb=jb, hb=hb)


def test_matvecs_match_reference(setup):
    s = setup
    rng, ref, port = s["rng"], s["ref"], s["port"]
    v = rng.standard_normal((B, s["n"]))
    u = rng.standard_normal((B, s["m"]))
    t = torch.as_tensor
    got = {"jv": port.jv(s["jb"], t(v)), "jtv": port.jtv(s["jb"], t(u)),
           "hv": port.hv(s["hb"], t(v))}
    assert got["jv"].shape == (B, s["m"]) and got["hv"].shape == (B, s["n"])
    for i in range(B):
        want = {"jv": jax.jit(ref.jv)(s["jb_ref"][i], jnp.asarray(v[i])),
                "jtv": jax.jit(ref.jtv)(s["jb_ref"][i], jnp.asarray(u[i])),
                "hv": jax.jit(ref.hv)(s["hb_ref"][i], jnp.asarray(v[i]))}
        for key in want:
            assert rel_err(got[key][i], want[key]) <= REL_TOL, (key, i)


def test_assembly_matches_reference(setup):
    s = setup
    rng = s["rng"]
    d = np.abs(rng.standard_normal((B, s["m"]))) + 0.1
    wdiag = np.abs(rng.standard_normal((B, s["n"]))) + 0.1
    A, Bm, C = s["port"].assemble(s["jb"], s["hb"], torch.as_tensor(d),
                                  torch.as_tensor(wdiag))
    assemble = jax.jit(s["ref_sk"].assemble)
    for i in range(B):
        want = assemble(s["jb_ref"][i], s["hb_ref"][i], jnp.asarray(d[i]), jnp.asarray(wdiag[i]))
        for got, w, name in zip((A, Bm, C), want, "ABC"):
            assert got[i].shape == w.shape, name
            assert rel_err(got[i], w) <= REL_TOL, (name, i)


def test_block_solve_inverts_the_matvecs(setup):
    """fsolve of the directly assembled factorization inverts
    K = H + diag(w) + Jᵀ D J applied through the matvecs, per instance."""
    s = setup
    rng, port = s["rng"], s["port"]
    t = torch.as_tensor
    hb = port.hess_blocks(t(s["z_s"]), t(np.zeros((B, s["m"]))))
    d = t(np.abs(rng.standard_normal((B, s["m"]))) + 0.5)
    wdiag = t(np.full((B, s["n"]), 50.0))
    F = port.factorize(s["jb"], hb, d, wdiag)
    assert port.factor_ok(F).tolist() == [True] * B
    r = t(rng.standard_normal((B, s["n"])))
    x = port.fsolve(F, r)
    Kx = port.hv(hb, x) + wdiag * x + port.jtv(s["jb"], d * port.jv(s["jb"], x))
    np.testing.assert_allclose(Kx.numpy(), r.numpy(), rtol=1e-8, atol=1e-8)


def test_structured_kkt_solve_matches_reference(monkeypatch):
    """The B = 3 solve through ``structured_kkt``: JAX's iterations, and the
    block factorization is what runs (never the dense kernels)."""
    calls = {"blocks": 0, "k1": 0, "k2": 0}
    real = kkt_blocks.factor_from_blocks

    def counted_blocks(*a):
        calls["blocks"] += 1
        return real(*a)

    def refuse(name):
        def f(*a):
            calls[name] += 1
            raise AssertionError(f"{name} ran on the block path")
        return f

    monkeypatch.setattr(kkt_blocks, "factor_from_blocks", counted_blocks)
    monkeypatch.setattr(bl, "lane_cholesky_plain", refuse("k1"))
    monkeypatch.setattr(bl, "lane_cho_solve_plain", refuse("k2"))
    assert_batch_matches_reference("direct", lane_kkt=True)
    assert calls["blocks"] > 0 and calls["k1"] == calls["k2"] == 0
