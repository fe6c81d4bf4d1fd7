"""Port parity: the plain versions of the batched Cholesky / Cholesky-solve
kernels against the JAX package's Pallas kernels run in interpret mode, and
at a size past the kernels' shared-memory variants against the unbatched
rule of the JAX package's ``smart_cholesky_and_solve``.

On the CPU the port's wrappers take the plain PyTorch versions (the CUDA
kernels are held against the same plain versions on the card by
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpopc_tpu.ops import batched_linalg as ref
from lpopc_tpu_torch.ops import batched_linalg as port

# f64: same recurrence, other summation order. f32: as tests/test_batched_linalg.py
TOL = {np.float64: 1e-9, np.float32: 5e-3}
# (4, 33): a ragged second panel of K1's 32-column panels
SHAPES = [(4, 8, np.float64), (130, 16, np.float64), (64, 24, np.float32), (4, 33, np.float64)]


def _spd(B, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    return ((A @ A.transpose(0, 2, 1) + n * np.eye(n)).astype(dtype),
            rng.standard_normal((B, n)).astype(dtype))


@pytest.fixture(scope="module")
def reference():
    out = {}
    for B, n, dt in SHAPES:
        K, b = _spd(B, n, dt)
        L = ref.lane_cholesky(jnp.asarray(K), interpret=True)
        x = ref.lane_cho_solve(L, jnp.asarray(b), interpret=True)
        out[(B, n, dt)] = (K, b, np.asarray(L), np.asarray(x))
    return out


@pytest.mark.parametrize("B,n,dt", SHAPES)
def test_lane_cholesky_matches_interpret_kernel(reference, B, n, dt):
    K, _, L_ref, _ = reference[(B, n, dt)]
    L = port.lane_cholesky(torch.as_tensor(K))
    assert L.dtype == torch.as_tensor(K).dtype and L.shape == (B, n, n)
    np.testing.assert_allclose(L.numpy(), L_ref, rtol=0, atol=TOL[dt] * np.abs(L_ref).max())
    assert float(torch.triu(L, diagonal=1).abs().max()) == 0.0


@pytest.mark.parametrize("B,n,dt", SHAPES)
def test_lane_cho_solve_matches_interpret_kernel(reference, B, n, dt):
    _, b, L_ref, x_ref = reference[(B, n, dt)]
    x = port.lane_cho_solve(torch.as_tensor(L_ref), torch.as_tensor(b))
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=0, atol=TOL[dt] * np.abs(x_ref).max())


@pytest.mark.parametrize("B,n", [(2, 197), (1, 300)])
def test_large_n_matches_unbatched_reference(B, n):
    """n = 197 (brachistochrone degrees (24, 24)): seven of K1's 32-column
    panels, the last one ragged; n = 300 at B = 1: past both kernels' split
    into their global variants, whose tiles of 32 end ragged too. The
    reference is smart_cholesky_and_solve's unbatched rule
    (jnp.linalg.cholesky, jax.scipy.linalg.cho_solve), one system at a time;
    interpret mode would cost seconds at this size."""
    K, b = _spd(B, n, np.float64, seed=3)
    chol, solve = ref.smart_cholesky_and_solve()
    L_ref = np.stack([np.asarray(chol(jnp.asarray(K[i]))) for i in range(B)])
    x_ref = np.stack([np.asarray(solve(jnp.asarray(L_ref[i]), jnp.asarray(b[i])))
                      for i in range(B)])
    # The plain recurrence is n small tensor ops; on a loaded CPU the
    # intra-op thread pool's wake-ups cost 100x the arithmetic.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        L = port.lane_cholesky(torch.as_tensor(K))
        x = port.lane_cho_solve(torch.as_tensor(L_ref), torch.as_tensor(b))
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_allclose(L.numpy(), L_ref, rtol=0, atol=1e-9 * np.abs(L_ref).max())
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=0, atol=1e-9 * np.abs(x_ref).max())


# (n, dtype) -> (K1 variant, K2 variant), by the byte counts: K1's shared
# variant holds the packed lower triangle n(n+1)/2 and a 32-entry column
# buffer for each of its ceil((n-32)/32) + 1 warps, K2's the packed triangle
# per system with ceil(n/32) <= 8 right-hand-side rows per lane, and a block
# may use 232448 bytes. So K1 is shared up to n = 239 (f64) and 339 (f32),
# K2 up to 240 (f64) and 256 (f32); each split is pinned on both sides.
# (169/170 were K1's f64 split while it held the full n x (n|1) square.)
VARIANTS = {
    (53, np.float64): ("shared", "shared"), (53, np.float32): ("shared", "shared"),
    (169, np.float64): ("shared", "shared"), (169, np.float32): ("shared", "shared"),
    (170, np.float64): ("shared", "shared"), (170, np.float32): ("shared", "shared"),
    (197, np.float64): ("shared", "shared"), (197, np.float32): ("shared", "shared"),
    (239, np.float64): ("shared", "shared"),
    (240, np.float64): ("global", "shared"), (240, np.float32): ("shared", "shared"),
    (241, np.float64): ("global", "global"), (241, np.float32): ("shared", "shared"),
    (256, np.float32): ("shared", "shared"), (257, np.float32): ("shared", "global"),
    (339, np.float32): ("shared", "global"), (340, np.float32): ("global", "global"),
    (700, np.float64): ("global", "global"), (700, np.float32): ("global", "global"),
}


@pytest.mark.parametrize("n,dt", list(VARIANTS))
def test_variant_split_follows_the_byte_count(n, dt):
    esz = np.dtype(dt).itemsize
    k1, k2 = port.variant("lane_cholesky", n, esz), port.variant("lane_cho_solve", n, esz)
    assert (k1, k2) == VARIANTS[(n, dt)]
    with pytest.raises(ValueError):
        port.variant("lane_lu", n, esz)


# K2's global variant takes a scratch of a 32-bit ticket and two 32-bit
# progress counters per system, whatever n.
@pytest.mark.parametrize("n", [241, 700, 4099])
@pytest.mark.parametrize("B", [1, 8, 512])
def test_global_solve_scratch_follows_the_rule(B, n):
    assert port.global_scratch_bytes(B) == 4 * (1 + 2 * B)
    scratch = port._global_scratch(B, torch.device("cpu"))
    assert scratch.numel() * scratch.element_size() == port.global_scratch_bytes(B)
    assert port.variant("lane_cho_solve", n, 8) == "global"


def test_non_pd_gives_nan_diagonal_without_raising():
    K, _ = _spd(4, 8, np.float64)
    K[2] = -K[2]
    d_ref = np.diagonal(np.asarray(ref.lane_cholesky(jnp.asarray(K), interpret=True)),
                        axis1=1, axis2=2)
    d = torch.diagonal(port.lane_cholesky(torch.as_tensor(K)), dim1=1, dim2=2).numpy()
    assert np.isnan(d[2]).all() and np.isnan(d_ref[2]).all()
    assert np.isfinite(d[[0, 1, 3]]).all()


def test_broadcast_factor_and_rhs():
    K, b = _spd(5, 8, np.float64, seed=2)
    L = port.lane_cholesky(torch.as_tensor(K))
    bt = torch.as_tensor(b)
    full = port.lane_cho_solve(L[:1].expand(5, -1, -1).contiguous(), bt)
    assert torch.equal(port.lane_cho_solve(L[0], bt), full)
    one_rhs = port.lane_cho_solve(L, bt[0])
    assert torch.equal(one_rhs, port.lane_cho_solve(L, bt[:1].expand(5, -1).contiguous()))
    np.testing.assert_allclose(
        one_rhs.numpy(), np.linalg.solve(K, np.broadcast_to(b[0], (5, 8))[..., None])[..., 0],
        atol=1e-12)


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        port.lane_cholesky(torch.zeros(3, 4, 5, dtype=torch.float64))
    with pytest.raises(TypeError):
        port.lane_cholesky(torch.zeros(3, 4, 4, dtype=torch.float16))
    with pytest.raises(TypeError):
        port.lane_cho_solve(torch.zeros(3, 4, 4, dtype=torch.float64),
                            torch.zeros(3, 4, dtype=torch.float32))
    with pytest.raises(ValueError):
        port.lane_cho_solve(torch.zeros(3, 4, 4, dtype=torch.float64),
                            torch.zeros(3, 5, dtype=torch.float64))


def test_cpu_tensors_count_no_kernel_launch():
    def counts():
        return [getattr(w, a) for w in (port.lane_cholesky, port.lane_cho_solve)
                for a in ("launches", "launches_shared", "launches_global")]

    before = counts()
    K, b = _spd(2, 4, np.float64)
    port.lane_cho_solve(port.lane_cholesky(torch.as_tensor(K)), torch.as_tensor(b))
    assert counts() == before
    port.reset_launches()
    assert counts() == [0] * 6
