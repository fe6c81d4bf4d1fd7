"""Recursive blocked batched Cholesky / triangular inverse (plain tensor ops).

The apply-mode factorization of the interior-point solver: the condensed KKT
matrix is factored once per regularization round into ``L`` and ``L⁻¹``, so
every KKT solve in the iteration is a matvec. Both are **statically-unrolled
recursive blocked algorithms** whose primitive is the batched matmul:

  chol([[A11, .], [A21, A22]]) = [[L11, 0], [A21 L11^-T, chol(A22 - ...)]]
  inv([[L11, 0], [L21, L22]])  = [[L11^-1, 0], [-L22^-1 L21 L11^-1, L22^-1]]

Recursion depth is log2(n / LEAF); the leaf factorization is an unrolled
LEAF-step update on tiny (..., LEAF, LEAF) panels. Total full-matrix-scale
ops: O(log n) library matmuls, no data-dependent control flow. This module
is the counterpart of the JAX package's ``ops/blocked_chol.py`` — which is
plain array code there too, not a hand-written kernel — and keeps its
recursion and leaf size so the two agree to rounding.

Accuracy: standard blocked Cholesky is backward-stable; equals
``torch.linalg.cholesky`` to ~eps * cond. Non-PD pivots produce NaN (sqrt of
a negative) and never raise, which the IPM's factorization-divergence
inertia test relies on.
"""

from __future__ import annotations

import torch

LEAF = 8


def _chol_leaf(A):
    """Unrolled Cholesky of a (..., k, k) block, k <= LEAF (static)."""
    k = A.shape[-1]
    mask = torch.arange(k, device=A.device)
    cols = []
    for j in range(k):
        d = torch.sqrt(A[..., j, j])
        col = A[..., :, j] / d[..., None]
        col = torch.where(mask >= j, col, torch.zeros_like(col))
        cols.append(col)
        A = A - col[..., :, None] * col[..., None, :]
    return torch.stack(cols, dim=-1)


def _tri_inv_leaf(L):
    """Unrolled inverse of a lower-triangular (..., k, k) block."""
    k = L.shape[-1]
    zero = L.new_zeros(L.shape[:-2])
    one = L.new_ones(L.shape[:-2])
    # forward substitution, column-of-identity at a time (k static, tiny)
    out_cols = []
    for j in range(k):
        x = []  # entries of column j of the inverse, row by row
        for i in range(k):
            if i < j:
                x.append(zero)
                continue
            b_i = one if i == j else zero
            if i:
                xs = torch.stack(x, dim=-1)
                s = b_i - (L[..., i, :i] * xs).sum(-1)
            else:
                s = b_i
            x.append(s / L[..., i, i])
        out_cols.append(torch.stack(x, dim=-1))
    return torch.stack(out_cols, dim=-1)


def blocked_cholesky(A):
    """Batched lower Cholesky of (..., n, n); static recursion, matmul-based."""
    n = A.shape[-1]
    if n <= LEAF:
        return _chol_leaf(A)
    h = n // 2
    A11 = A[..., :h, :h]
    A21 = A[..., h:, :h]
    A22 = A[..., h:, h:]
    L11 = blocked_cholesky(A11)
    L11inv = blocked_tri_inv(L11)
    L21 = A21 @ L11inv.transpose(-1, -2)
    S22 = A22 - L21 @ L21.transpose(-1, -2)
    L22 = blocked_cholesky(S22)
    z = A.new_zeros(A.shape[:-2] + (h, n - h))
    top = torch.cat([L11, z], dim=-1)
    bot = torch.cat([L21, L22], dim=-1)
    return torch.cat([top, bot], dim=-2)


def blocked_tri_inv(L):
    """Batched inverse of lower-triangular (..., n, n); static recursion."""
    n = L.shape[-1]
    if n <= LEAF:
        return _tri_inv_leaf(L)
    h = n // 2
    L11 = L[..., :h, :h]
    L21 = L[..., h:, :h]
    L22 = L[..., h:, h:]
    X11 = blocked_tri_inv(L11)
    X22 = blocked_tri_inv(L22)
    X21 = -(X22 @ (L21 @ X11))
    z = L.new_zeros(L.shape[:-2] + (h, n - h))
    top = torch.cat([X11, z], dim=-1)
    bot = torch.cat([X21, X22], dim=-1)
    return torch.cat([top, bot], dim=-2)


def chol_and_inverse(K):
    """(L, L^-1) of a batched SPD K — the IPM apply-mode factorization pair."""
    L = blocked_cholesky(K)
    return L, blocked_tri_inv(L)
