"""Port parity: recursive blocked Cholesky / triangular inverse (plain tensor ops)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpopc_tpu.ops import blocked_chol as ref
from lpopc_tpu_torch.ops import blocked_chol as port

TOL = 1e-10  # same recursion and leaf size; matmul summation order differs


def _spd(B, n, seed):
    A = np.random.default_rng(seed).standard_normal((B, n, n))
    return A @ A.transpose(0, 2, 1) + n * np.eye(n)


@pytest.mark.parametrize("B,n", [(3, 5), (4, 8), (2, 29), (5, 53)])
def test_chol_and_inverse_match(B, n):
    K = _spd(B, n, seed=n)
    Lr, Lir = ref.chol_and_inverse(jnp.asarray(K))
    Lp, Lip = port.chol_and_inverse(torch.as_tensor(K))
    np.testing.assert_allclose(Lp.numpy(), np.asarray(Lr), rtol=0, atol=TOL)
    np.testing.assert_allclose(Lip.numpy(), np.asarray(Lir), rtol=0, atol=TOL)
    np.testing.assert_allclose(Lp.numpy(), np.linalg.cholesky(K), rtol=0, atol=TOL)
    assert port.LEAF == ref.LEAF


def test_non_pd_gives_nan_like_the_reference():
    K = _spd(3, 20, seed=1)
    K[1] = -K[1]
    Lr, _ = ref.chol_and_inverse(jnp.asarray(K))
    Lp, Lip = port.chol_and_inverse(torch.as_tensor(K))
    nan_r = np.isnan(np.diagonal(np.asarray(Lr), axis1=1, axis2=2)).any(-1)
    nan_p = torch.isnan(torch.diagonal(Lp, dim1=1, dim2=2)).any(-1).numpy()
    assert nan_p.tolist() == nan_r.tolist() == [False, True, False]
    assert torch.isfinite(Lip[0]).all() and torch.isfinite(Lip[2]).all()
